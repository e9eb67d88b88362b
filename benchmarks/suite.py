"""Benchmark suite: the solver's problem classes as runnable problems
with per-problem timing, iterations, and accuracy.

Classes:
  * basic QP (dense P, inequality rows) — the reference golden QP;
  * LP/QP batch: synthetic Maros-Meszaros-style QPs (random sparse
    convex QPs with equalities + box rows; the true MM archive is not
    vendored — these match its structure class);
  * SOCP: portfolio optimization, batched scenarios;
  * exp/pow: logistic-regression-style and geometric-programming-style
    cones;
  * SDP with chordal decomposition: sparse arrow/banded PSD problems.

Usage:  python benchmarks/suite.py [--json out.json]
"""

import argparse
import json
import sys
import time
from typing import NamedTuple, Optional

import numpy as np

sys.path.insert(0, ".")
import cuclarabel_tpu as cc  # noqa: E402


class SuiteProblem(NamedTuple):
    """One suite row: problem data, its golden objective (None when the
    row carries none), Solver keyword settings, and whether it goes
    through SparseSolver."""

    name: str
    P: object
    q: np.ndarray
    A: object
    b: np.ndarray
    cones: list
    expect_obj: Optional[float] = None
    kw: dict = {}
    sparse: bool = False


def _solve(p: SuiteProblem):
    if p.sparse:
        from cuclarabel_tpu.sparse_solver import SparseSolver

        solver = SparseSolver(p.P, p.q, p.A, p.b, p.cones, **p.kw)
    else:
        solver = cc.Solver(p.P, p.q, p.A, p.b, p.cones, **p.kw)
    t0 = time.perf_counter()
    sol = solver.solve()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = solver.solve()  # warm: compiled program cached
    warm = time.perf_counter() - t0
    ok = sol.status in (cc.SolverStatus.SOLVED, cc.SolverStatus.ALMOST_SOLVED)
    obj_err = (
        abs(sol.obj_val - p.expect_obj) if p.expect_obj is not None
        else float("nan")
    )
    return {
        "name": p.name,
        "status": sol.status.name,
        "ok": bool(ok),
        "iters": sol.iterations,
        "warm_ms": warm * 1e3,
        "cold_s": cold,
        "r_prim": sol.r_prim,
        "r_dual": sol.r_dual,
        "obj": sol.obj_val,
        "obj_err": obj_err,
    }


def qp_golden():
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.array([[1.0, 1.0]]), np.eye(2), -np.eye(2)])
    b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(2), cc.NonnegativeConeT(2)]
    return SuiteProblem("qp-golden", P, q, A, b, cones, 1.8800000298)


def mm_style_qp(n, meq, seed):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, max(2, n // 4)))
    P = F @ F.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    Aeq = rng.standard_normal((meq, n))
    beq = Aeq @ rng.standard_normal(n)
    A = np.vstack([Aeq, -np.eye(n), np.eye(n)])
    b = np.concatenate([beq, np.zeros(n) + 5.0, np.zeros(n) + 5.0])
    cones = [cc.ZeroConeT(meq), cc.NonnegativeConeT(2 * n)]
    return SuiteProblem(f"mm-qp-n{n}", P, q, A, b, cones)


def portfolio_socp(nass, seed):
    rng = np.random.default_rng(seed)
    n = nass + 1
    nfac = max(2, nass // 4)
    F = rng.standard_normal((nass, nfac))
    A_eq = np.zeros((1, n))
    A_eq[0, :nass] = 1.0
    A_nn = np.zeros((nass + 1, n))
    A_nn[:nass, :nass] = -np.eye(nass)
    A_nn[nass, nass] = -1.0
    A_soc = np.zeros((nfac + 1, n))
    A_soc[0, nass] = -1.0
    A_soc[1:, :nass] = -F.T
    A = np.vstack([A_eq, A_nn, A_soc])
    q = np.concatenate([-rng.standard_normal(nass) * 0.1, [1.0]])
    b = np.zeros(A.shape[0])
    b[0] = 1.0
    cones = [
        cc.ZeroConeT(1),
        cc.NonnegativeConeT(nass + 1),
        cc.SecondOrderConeT(nfac + 1),
    ]
    return SuiteProblem(f"socp-portfolio-n{nass}", None, q, A, b, cones)


def exp_logistic(nfeat, nobs, seed):
    """Logistic-loss epigraph via exponential cones:
    min sum t_i, with softplus(-y_i w'x_i) <= t_i expressed through
    two exp-cone epigraphs per observation (standard GP modeling)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((nobs, nfeat))
    y = np.sign(rng.standard_normal(nobs))
    # variables: w (nfeat), t (nobs), u (nobs), v (nobs)
    # constraints: u + v <= 1 handled as NN slack; exp cones:
    # (  -y x'w - t, 1, u ) and ( -t, 1, v ) in Kexp
    nv = nfeat + 3 * nobs
    rows = []
    bs = []
    cones = []
    # u + v <= 1
    for i in range(nobs):
        r = np.zeros(nv)
        r[nfeat + nobs + i] = 1.0
        r[nfeat + 2 * nobs + i] = 1.0
        rows.append(r)
        bs.append(1.0)
    cones.append(cc.NonnegativeConeT(nobs))
    # exp cones
    for i in range(nobs):
        r1 = np.zeros(nv)
        r1[:nfeat] = y[i] * X[i]
        r1[nfeat + i] = 1.0  # -(-yx'w - t) = yx'w + t
        r2 = np.zeros(nv)
        r3 = np.zeros(nv)
        r3[nfeat + nobs + i] = -1.0
        rows += [-r1, r2, r3]
        bs += [0.0, 1.0, 0.0]
        cones.append(cc.ExponentialConeT())
        r1 = np.zeros(nv)
        r1[nfeat + i] = -1.0
        r3 = np.zeros(nv)
        r3[nfeat + 2 * nobs + i] = -1.0
        rows += [r1, r2, r3]
        bs += [0.0, 1.0, 0.0]
        cones.append(cc.ExponentialConeT())
    A = -np.vstack([r[None, :] for r in rows])
    A[: nobs] = -A[:nobs]  # NN rows: s = b - row
    b = np.asarray(bs)
    q = np.zeros(nv)
    q[nfeat : nfeat + nobs] = 1.0
    P = 1e-4 * np.eye(nv)
    return SuiteProblem(f"exp-logistic-{nobs}x{nfeat}", P, q, A, b, cones)


def genpow_family(ncones, seed):
    """Generalized-power-cone family with an exact analytic optimum:
    per cone i, maximize z_i subject to (w_i1, w_i2, z_i) in
    GenPow(alpha_i) with the budget w_i1 + w_i2 = 1.  The optimum
    allocates w proportionally to alpha (weighted AM-GM), so
    z_i* = prod_j alpha_ij^alpha_ij and the objective is
    -sum_i z_i* exactly.  Exercises the rank-3 expansion KKT columns
    (coneops_genpowcone.jl semantics) at more than fixture size."""
    rng = np.random.default_rng(seed)
    # draw alpha from a small grid (cone params are baked into the
    # layout — a compile per distinct alpha; the grid keeps that small)
    grid = np.array([0.2, 0.35, 0.5, 0.65, 0.8])
    alphas = [float(rng.choice(grid)) for _ in range(ncones)]
    n = 3 * ncones
    q = np.zeros(n)
    rows, bs = [], []
    # budget equalities first (zero cone)
    for i in range(ncones):
        r = np.zeros(n)
        r[3 * i] = 1.0
        r[3 * i + 1] = 1.0
        rows.append(r)
        bs.append(1.0)
    cones = [cc.ZeroConeT(ncones)]
    # genpow memberships: s = (w1, w2, z) in GenPow([a, 1-a], 1)
    for i in range(ncones):
        for j in range(3):
            r = np.zeros(n)
            r[3 * i + j] = -1.0
            rows.append(r)
            bs.append(0.0)
        cones.append(cc.GenPowerConeT([alphas[i], 1.0 - alphas[i]], 1))
        q[3 * i + 2] = -1.0
    A = np.vstack(rows)
    b = np.asarray(bs)
    expect = -sum(
        a ** a * (1.0 - a) ** (1.0 - a) for a in alphas
    )
    return SuiteProblem(f"genpow-{ncones}cones", None, q, A, b, cones,
                        expect)


def sdp_chordal_banded(nv, bw, seed):
    """min tr(C X) s.t. X_ij = M_ij on the off-diagonal band, X psd-
    completable — the cone rows touch ONLY the band's svec entries
    (variables = band entries), so the aggregate sparsity is banded and
    chordal decomposition splits the cone into a clique chain.  (An
    earlier version added a row per svec entry, which makes the
    aggregate dense and silently skips decomposition.)"""
    rng = np.random.default_rng(seed)
    sd = nv * (nv + 1) // 2
    band_idx, diag_flag = [], []
    a = 0
    for j in range(nv):
        for i in range(j + 1):
            if j - i <= bw:
                band_idx.append(a)
                diag_flag.append(i == j)
            a += 1
    ny = len(band_idx)
    q = np.zeros(ny)
    rows, bs = [], []
    for t in range(ny):
        if diag_flag[t]:
            q[t] = rng.random() + 0.5       # tr(C X) on the diagonal
        else:
            r = np.zeros(ny)
            r[t] = 1.0
            rows.append(r)
            bs.append(0.3 * np.sqrt(2.0) * (0.5 + 0.1 * (t % 5)))
    meq = len(rows)
    Apsd = np.zeros((sd, ny))
    for t, bi in enumerate(band_idx):
        Apsd[bi, t] = -1.0
    A = np.vstack([np.vstack(rows), Apsd])
    b = np.concatenate([np.asarray(bs), np.zeros(sd)])
    cones = [cc.ZeroConeT(meq), cc.PSDTriangleConeT(nv)]
    return SuiteProblem(
        f"sdp-banded-n{nv}", None, q, A, b, cones,
        kw={"chordal_decomposition_enable": True},
    )


def sparse_grid_qp(k, seed):
    """Grid-Laplacian sparse QP through the device multifrontal path
    (SparseSolver) — the Maros-Meszaros structural class at sizes the
    dense path shouldn't touch."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n = k * k
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (k, k))
    P = (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k)) + sp.eye(n)).tocsc()
    q = rng.standard_normal(n)
    A = sp.vstack([sp.csr_matrix(np.ones((1, n))), -sp.eye(n)]).tocsc()
    b = np.concatenate([[1.0], 1.0 + rng.random(n)])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(n)]
    return SuiteProblem(f"sparse_grid_qp_n{n}", P, q, A, b, cones,
                        sparse=True)


def banded_sparse_qp(n, bw, seed):
    """Banded-P sparse QP with box rows (another MM structure class)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    diags = [2.0 + rng.random(n)] + [
        -rng.random(n - d) * 0.5 for d in range(1, bw + 1)
    ]
    P = sp.diags(
        diags, [0] + [-d for d in range(1, bw + 1)], (n, n)
    )
    P = (P + P.T).tocsc()
    q = rng.standard_normal(n)
    A = sp.vstack([-sp.eye(n), sp.eye(n)]).tocsc()
    b = np.concatenate([np.ones(n), np.ones(n)])  # -1 <= x <= 1
    cones = [cc.NonnegativeConeT(2 * n)]
    return SuiteProblem(f"banded_sparse_qp_n{n}", P, q, A, b, cones,
                        sparse=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument(
        "--medium", action="store_true",
        help="include medium grid-QP instances (N_kkt 2k-4k; minutes of "
             "compile, cached afterwards)",
    )
    ap.add_argument(
        "--maros", default=None, metavar="DIR",
        help="solve every .qps file in DIR (the Maros-Meszaros archive "
             "layout) through the QPS reader and print one JSON line "
             "per member, then exit",
    )
    args = ap.parse_args()

    if args.maros:
        import json as _json

        from benchmarks.qps_corpus import run_qps_dir

        for rec in run_qps_dir(args.maros):
            print(_json.dumps(rec))
        return

    from benchmarks.maros import run as run_maros

    results = []
    for r in run_maros():
        # adapt the named-MM record to this table's schema
        results.append({
            "name": f"mm-{r['name']}", "status": r["status"],
            "ok": r["status"] in ("SOLVED", "ALMOST_SOLVED"),
            "iters": r["iters"], "warm_ms": r["warm_ms"],
            "cold_s": r["cold_s"], "r_prim": r["r_prim"],
            "r_dual": r["r_dual"], "obj": r["obj"],
            "obj_err": r["obj_err"], "obj_tol": r["obj_tol"],
        })
    results += [_solve(p) for p in (
        qp_golden(),
        mm_style_qp(50, 10, 1),
        mm_style_qp(200, 40, 2),
        portfolio_socp(32, 3),
        portfolio_socp(128, 4),
        exp_logistic(4, 10, 5),
        genpow_family(8, 9),
        sdp_chordal_banded(12, 2, 6),
        sparse_grid_qp(16, 7),
        banded_sparse_qp(300, 3, 8),
    )]
    # genuine mid-size MM members (analytic CVXQP reconstruction,
    # validated against the published optima — benchmarks/cvxqp.py)
    # through the full QPS pipeline
    from benchmarks.cvxqp import run as run_cvxqp

    cvx_members = ("CVXQP1_S", "CVXQP2_S", "CVXQP3_S")
    if args.medium:
        cvx_members += ("CVXQP1_M",)
    for rec in run_cvxqp(cvx_members):
        results.append({
            "name": f"mm-{rec['name']}", "status": rec["status"],
            "ok": rec["status"] in ("SOLVED", "ALMOST_SOLVED")
            and rec["obj_err"] <= rec["obj_tol"],
            "iters": rec["iterations"], "warm_ms": rec["solve_s"] * 1e3,
            "cold_s": rec["solve_s"], "r_prim": rec["r_prim"],
            "r_dual": rec["r_dual"], "obj": rec["obj"],
            "obj_err": rec["obj_err"], "obj_tol": rec["obj_tol"],
            "n": rec["n"], "m": rec["m"], "path": rec["path"],
        })
    if args.medium:
        # medium grid-QP instances (AUG2D structural class) through the
        # device multifrontal; N_kkt = 2k^2 + 1
        results += [
            _solve(sparse_grid_qp(32, 11)),   # N = 2049
            _solve(sparse_grid_qp(45, 12)),   # N = 4051
        ]

    hdr = f"{'problem':<22s} {'status':<14s} {'iters':>5s} {'warm ms':>9s} {'rprim':>9s} {'rdual':>9s}"
    print(hdr)
    print("-" * len(hdr))
    for r in results:
        print(
            f"{r['name']:<22s} {r['status']:<14s} {r['iters']:>5d} "
            f"{r['warm_ms']:>9.2f} {r['r_prim']:>9.1e} {r['r_dual']:>9.1e}"
        )
    nfail = sum(not r["ok"] for r in results)
    print(f"\n{len(results) - nfail}/{len(results)} solved")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 1 if nfail else 0


if __name__ == "__main__":
    sys.exit(main())
