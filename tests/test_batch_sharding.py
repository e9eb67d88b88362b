"""Batched + sharded solve tests on the 8-virtual-device CPU mesh
(conftest.py sets xla_force_host_platform_device_count=8)."""

import numpy as np
import jax

import cuclarabel_tpu as cc
from cuclarabel_tpu.parallel import BatchSolver


def portfolio_batch(B=16, nass=8, seed=0):
    rng = np.random.default_rng(seed)
    n = nass + 1
    nfac = 3
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
    qs = np.zeros((B, n))
    bs = np.zeros((B, A.shape[0]))
    for i in range(B):
        qs[i] = np.concatenate([-rng.standard_normal(nass) * 0.1, [1.0]])
        bs[i, 0] = 1.0
    cones = [
        cc.ZeroConeT(1),
        cc.NonnegativeConeT(nass + 1),
        cc.SecondOrderConeT(nfac + 1),
    ]
    return A, qs, bs, cones


def test_batch_matches_single():
    A, qs, bs, cones = portfolio_batch(B=4)
    sols = BatchSolver(None, qs, A, bs, cones).solve()
    assert all(s.status == cc.SolverStatus.SOLVED for s in sols)
    for i in (0, 3):
        ref = cc.Solver(
            None, qs[i], A, bs[i], cones, presolve_enable=False
        ).solve()
        assert abs(ref.obj_val - sols[i].obj_val) < 1e-8
        assert np.linalg.norm(ref.x - sols[i].x) < 1e-6


def test_batch_sharded_8dev():
    assert len(jax.devices()) >= 8
    A, qs, bs, cones = portfolio_batch(B=16)
    sols = BatchSolver(None, qs, A, bs, cones, n_devices=8).solve()
    assert all(s.status == cc.SolverStatus.SOLVED for s in sols)
    # budget constraint holds for every scenario
    for s in sols:
        assert abs(s.x[:-1].sum() - 1.0) < 1e-6


def test_batched_varying_P_and_A():
    """Per-problem P and A values (same sparsity structure)."""
    rng = np.random.default_rng(1)
    B, nvar = 6, 5
    Ps, As, qs, bs = [], [], [], []
    for i in range(B):
        F = rng.standard_normal((nvar, nvar))
        Ps.append(F @ F.T + np.eye(nvar))
        As.append(np.vstack([np.ones((1, nvar)), -np.eye(nvar)]))
        qs.append(rng.standard_normal(nvar))
        bs.append(np.concatenate([[1.0], np.zeros(nvar)]))
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(nvar)]
    sols = BatchSolver(
        np.stack(Ps), np.stack(qs), np.stack(As), np.stack(bs), cones
    ).solve()
    for i, s in enumerate(sols):
        assert s.status == cc.SolverStatus.SOLVED
        ref = cc.Solver(
            Ps[i], qs[i], As[i], bs[i], cones, presolve_enable=False
        ).solve()
        assert abs(ref.obj_val - s.obj_val) < 1e-7


def test_batch_mixed_feasibility():
    """A batch mixing solvable and primal-infeasible problems must
    report per-problem statuses correctly (the vmapped while_loop keeps
    executing finished elements until the whole batch terminates, so
    terminal statuses must be stable under extra passes)."""
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.array([[1.0, 1.0]]), np.eye(2), -np.eye(2)])
    b_ok = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    b_inf = np.array([-1.0, 0.7, 0.7, -0.5, -0.5])  # infeasible bounds
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(2), cc.NonnegativeConeT(2)]
    sols = BatchSolver(
        P, np.stack([q, q, q]), A, np.stack([b_ok, b_inf, b_ok]), cones
    ).solve()
    assert sols[0].status == cc.SolverStatus.SOLVED
    assert sols[1].status == cc.SolverStatus.PRIMAL_INFEASIBLE
    assert sols[2].status == cc.SolverStatus.SOLVED
    assert abs(sols[0].obj_val - 1.88) < 1e-2
    assert np.isnan(sols[1].obj_val)


def test_batch_update_data_resolves():
    """BatchSolver.update_data swaps runtime arguments; the compiled
    batched program is reused for parametric scenario re-solves."""
    rng = np.random.default_rng(5)
    B, n = 6, 10
    F = rng.standard_normal((n, 4))
    P = F @ F.T + 0.5 * np.eye(n)
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    bs = np.tile(np.concatenate([[1.0], np.zeros(n)]), (B, 1))
    qs = rng.standard_normal((B, n))
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(n)]

    solver = BatchSolver(P, qs, A, bs, cones)
    solver.solve()

    qs2 = qs + 0.2 * rng.standard_normal((B, n))
    solver.update_data(q=qs2)
    sols = solver.solve()
    for i in range(B):
        ref = cc.Solver(P, qs2[i], A, bs[i], cones,
                        presolve_enable=False).solve()
        assert sols[i].status == cc.SolverStatus.SOLVED
        assert abs(sols[i].obj_val - ref.obj_val) < 1e-6

    import pytest
    with pytest.raises(ValueError, match="P is zero"):
        solver.update_data(P=np.zeros((n, n)))


def _svec(M):
    d = M.shape[0]
    out = []
    for j in range(d):
        for i in range(j + 1):
            out.append(M[i, j] * (1.0 if i == j else np.sqrt(2.0)))
    return np.array(out)


def test_batch_exp_matches_single():
    """Exponential-cone problems through BatchSolver: the riskiest loop
    machinery (BFGS dual scaling, backtracking line searches, the
    PrimalDual->Dual strategy ladder) under vmap, asserted against
    single-problem solves (reference behavior solver.jl:453-514).

    NB: iterate paths are NOT bitwise identical between the batch and
    single pipelines (device f32-shadow Ruiz vs host equilibration;
    XLA autovectorization changes rounding per lane), so knife-edge
    instances may legitimately finish ALMOST_SOLVED in one pipeline
    and SOLVED in the other — the assertions are on solution quality,
    not the iterate path."""
    B = 4
    c = np.array([-1.0, 0.0, 0.5])
    A = np.vstack([np.array([[0.0, 1.0, 0.0]]),
                   np.array([[0.0, 0.0, 1.0]]), -np.eye(3)])
    bs = np.stack([
        np.concatenate([[1.0], [1.5 + 0.8 * i], np.zeros(3)])
        for i in range(B)
    ])
    qs = np.tile(c, (B, 1))
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(1),
             cc.ExponentialConeT()]
    sols = BatchSolver(None, qs, A, bs, cones).solve()
    for i, s in enumerate(sols):
        ref = cc.Solver(None, qs[i], A, bs[i], cones,
                        presolve_enable=False).solve()
        assert ref.status == cc.SolverStatus.SOLVED
        assert s.status in (cc.SolverStatus.SOLVED,
                            cc.SolverStatus.ALMOST_SOLVED), (i, s.status)
        assert abs(s.obj_val - ref.obj_val) < 1e-6, (i, s.obj_val,
                                                     ref.obj_val)
        # weakly-determined components (cap-boundary u3) agree to
        # ~sqrt(tol) only — objective agreement is the sharp criterion
        assert np.linalg.norm(s.x - ref.x) < 1e-3


def test_batch_pow_genpow_matches_single():
    """Power / generalized-power cones through BatchSolver (cone
    parameters are layout-static, so alpha is shared across the batch;
    q/b vary per problem)."""
    B = 4
    # pow
    c = np.array([0.1, 0.1, -1.0])
    A = np.vstack([np.array([[1.0, 1.0, 0.0]]), -np.eye(3)])
    bs = np.stack([
        np.concatenate([[1.6 + 0.4 * i], np.zeros(3)]) for i in range(B)
    ])
    qs = np.tile(c, (B, 1))
    cones = [cc.NonnegativeConeT(1), cc.PowerConeT(0.6)]
    sols = BatchSolver(None, qs, A, bs, cones).solve()
    for i, s in enumerate(sols):
        ref = cc.Solver(None, qs[i], A, bs[i], cones,
                        presolve_enable=False).solve()
        assert s.status == cc.SolverStatus.SOLVED
        assert abs(s.obj_val - ref.obj_val) < 1e-6

    # genpow (rank-3 expansion through the batched KKT)
    a = [0.3, 0.7]
    c2 = np.array([0.0, 0.0, -1.0])
    A2 = np.vstack([np.array([[1.0, 1.0, 0.0]]), -np.eye(3)])
    bs2 = np.stack([
        np.concatenate([[1.8 + 0.25 * i], np.zeros(3)]) for i in range(B)
    ])
    qs2 = np.tile(c2, (B, 1))
    cones2 = [cc.NonnegativeConeT(1), cc.GenPowerConeT(a, 1)]
    sols2 = BatchSolver(None, qs2, A2, bs2, cones2).solve()
    for i, s in enumerate(sols2):
        ref = cc.Solver(None, qs2[i], A2, bs2[i], cones2,
                        presolve_enable=False).solve()
        assert s.status == cc.SolverStatus.SOLVED
        assert abs(s.obj_val - ref.obj_val) < 1e-6


def test_batch_psd_matches_single():
    """PSD-triangle cones through BatchSolver (batched eigh/cholesky NT
    scaling inside the vmapped loop), incl. an 8-virtual-device shard."""
    rng = np.random.default_rng(3)
    B, d = 8, 3
    nsv = d * (d + 1) // 2
    qs = np.stack([
        _svec((lambda M: (M + M.T) / 2)(rng.standard_normal((d, d))))
        for _ in range(B)
    ])
    A = np.vstack([_svec(np.eye(d))[None, :], -np.eye(nsv)])
    bs = np.tile(np.concatenate([[1.0], np.zeros(nsv)]), (B, 1))
    cones = [cc.ZeroConeT(1), cc.PSDTriangleConeT(d)]
    for ndev in (1, 8):
        sols = BatchSolver(None, qs, A, bs, cones,
                           n_devices=ndev).solve()
        for i, s in enumerate(sols):
            ref = cc.Solver(None, qs[i], A, bs[i], cones,
                            presolve_enable=False).solve()
            assert s.status == cc.SolverStatus.SOLVED, (ndev, i)
            assert abs(s.obj_val - ref.obj_val) < 1e-7
            # optimal value of min tr(CX), tr X = 1, X >= 0 is lam_min(C)
            Cm = np.zeros((d, d))
            k = 0
            for j in range(d):
                for r in range(j + 1):
                    v = qs[i][k] / (1.0 if r == j else np.sqrt(2.0))
                    Cm[r, j] = Cm[j, r] = v
                    k += 1
            assert abs(s.obj_val - np.linalg.eigvalsh(Cm)[0]) < 1e-7


def test_batch_strategy_divergence():
    """A batch whose problems DIVERGE in scaling strategy: the middle
    lane (a badly scaled exp instance) downgrades PrimalDual -> Dual
    via the strategy ladder while its neighbors keep PrimalDual — the
    per-problem ladder (solver.jl:453-514) must act independently
    under vmap, and every lane must still solve.  The terminal
    strategy is surfaced per problem as raw['scaling'] (0 = PrimalDual,
    1 = Dual)."""
    A = np.vstack([np.array([[0.0, 1.0, 0.0]]),
                   np.array([[0.0, 0.0, 1.0]]), -np.eye(3)])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(1),
             cc.ExponentialConeT()]
    easy_q = np.array([-1.0, 0.0, 0.5])
    easy_b = np.array([1.0, 2.0, 0.0, 0.0, 0.0])
    # found by scripted search (the downgrade is knife-edge, so the
    # data must be kept to full f64 precision): this lane downgrades
    # to Dual in the batched pipeline and still reaches SOLVED
    hard_q = np.array([-213308.78098860086, 0.0, 0.003037962766862291])
    hard_b = np.array([0.002042543869636034, 0.4080186873038148,
                       0.0, 0.0, 0.0])
    qs = np.stack([easy_q, hard_q, easy_q])
    bs = np.stack([easy_b, hard_b, easy_b])
    solver = BatchSolver(None, qs, A, bs, cones)
    sols = solver.solve()
    strat = np.asarray(solver.raw["scaling"]).ravel()
    assert strat.shape == (3,)
    assert strat[0] == 0 and strat[2] == 0  # neighbors keep PrimalDual
    assert strat[1] == 1  # the hard lane downgraded to Dual
    for i, s in enumerate(sols):
        ref = cc.Solver(None, qs[i], A, bs[i], cones,
                        presolve_enable=False).solve()
        assert s.status == cc.SolverStatus.SOLVED, (i, s.status)
        rel = abs(s.obj_val - ref.obj_val) / max(1.0, abs(ref.obj_val))
        assert rel < 1e-6, (i, s.obj_val, ref.obj_val)


def test_batch_exp_lane_uniformity_xla_cpu_canary():
    """CANARY for an XLA:CPU optimization-pass miscompile (round 5):
    at EXACTLY B=4, lane 2 of a vmapped exp-cone solve computes
    materially different iterates than its bitwise-identical siblings
    (observed: identical problems -> iterations [6,6,15,6], and with
    harder data lane 2 alone hits INSUFFICIENT_PROGRESS).  The effect
    follows the LANE, not the problem; disabling XLA optimizations
    (JAX_DISABLE_MOST_OPTIMIZATIONS=1) removes it; B=2,3,5..16 are
    uniform; pow/LP batches are uniform.

    This test asserts the CURRENT situation so a backend change in
    either direction is noticed: B=5 identical lanes must be uniform
    (a real correctness property we rely on), while B=4 uniformity is
    merely reported."""
    import warnings

    c = np.array([-1.0, 0.0, 0.5])
    A = np.vstack([np.array([[0.0, 1.0, 0.0]]),
                   np.array([[0.0, 0.0, 1.0]]), -np.eye(3)])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(1),
             cc.ExponentialConeT()]
    b = np.concatenate([[1.0], [3.0], np.zeros(3)])

    def iters(B):
        sols = BatchSolver(None, np.tile(c, (B, 1)), A,
                           np.tile(b, (B, 1)), cones).solve()
        return [s.iterations for s in sols]

    it5 = iters(5)
    assert len(set(it5)) == 1, f"identical lanes must match at B=5: {it5}"
    it4 = iters(4)
    if len(set(it4)) != 1:
        warnings.warn(
            "XLA:CPU B=4 lane nonuniformity still present "
            f"(iterations {it4}) — known backend miscompile",
            stacklevel=1,
        )


def test_batch_dp_has_no_data_collectives():
    """The dp axis is embarrassingly parallel: the compiled 8-device
    batched program moves NO problem data between devices.  The only
    permitted collective is the scalar loop-termination consensus (the
    vmapped while_loop's OR-reduce over 'all problems done').  This is
    what makes batch scaling to more devices near-linear (no
    communication to lose)."""
    import re

    import jax

    if len(jax.devices()) < 8:
        import pytest
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(11)
    B, n = 8, 6
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    bs = np.tile(np.concatenate([[1.0], np.zeros(n)]), (B, 1))
    qs = rng.standard_normal((B, n))
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(n)]
    solver = BatchSolver(None, qs, A, bs, cones, n_devices=8)
    import time as _time
    import jax.numpy as jnp
    txt = solver._fn.lower(
        *solver._args, jnp.asarray(_time.time())
    ).compile().as_text()
    for op in ("all-gather", "collective-permute", "reduce-scatter",
               "all-to-all"):
        assert op not in txt, f"unexpected {op} in dp program"
    # all-reduce only on tiny predicate/scalar tuples (loop consensus)
    for line in txt.splitlines():
        if "all-reduce" not in line:
            continue
        for dtype, dims in re.findall(
            r"(pred|f32|f64|s32|u32|s8|u8)\[([0-9,]*)\]", line
        ):
            nelem = 1
            for d in dims.split(","):
                if d:
                    nelem *= int(d)
            assert nelem <= 8, f"data-sized all-reduce: {line[:160]}"
    sols = solver.solve()
    assert all(s.status == cc.SolverStatus.SOLVED for s in sols)
