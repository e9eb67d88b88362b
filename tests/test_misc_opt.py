"""Remaining golden optimization tests: unconstrained, presolve row
elimination, lasso SOCP stress, and the linear-solver (factor precision)
sweep (parity with reference test/OptTests/{basic_unconstrained.jl,
presolve.jl, socp-lasso.jl, linear_solvers.jl})."""

import numpy as np
import pytest

import cuclarabel_tpu as cc


# -- unconstrained (basic_unconstrained.jl) --------------------------------


def test_unconstrained_feasible():
    P = np.eye(3)
    q = np.array([1.0, 2.0, -3.0])
    A = np.zeros((0, 3))
    b = np.zeros(0)
    sol = cc.Solver(P, q, A, b, []).solve()
    assert sol.status == cc.SolverStatus.SOLVED
    assert np.linalg.norm(sol.x + q) < 1e-3


def test_unconstrained_dual_infeasible():
    P = np.eye(3)
    P[0, 0] = 0.0
    q = np.array([1.0, 0.0, 0.0])
    sol = cc.Solver(P, q, np.zeros((0, 3)), np.zeros(0), []).solve()
    assert sol.status == cc.SolverStatus.DUAL_INFEASIBLE


# -- presolve (presolve.jl) -------------------------------------------------


def presolver_test_data():
    P = np.eye(3)
    q = np.array([3.0, -2.0, 1.0])
    A = np.vstack([np.eye(3), -np.eye(3)]) * 2.0
    b = np.ones(6)
    cones = [cc.NonnegativeConeT(3), cc.NonnegativeConeT(3)]
    return P, q, A, b, cones


def test_presolve_single_unbounded():
    P, q, A, b, cones = presolver_test_data()
    b[3] = 1e30
    solver = cc.Solver(P, q, A, b, cones)
    assert solver.m == 5  # one row eliminated internally
    sol = solver.solve()
    assert sol.status == cc.SolverStatus.SOLVED
    assert sol.z[3] == 0.0
    assert sol.s[3] == cc.get_infinity()


def test_presolve_redundant_cone():
    P, q, A, b, cones = presolver_test_data()
    b[0:3] = 1e30
    solver = cc.Solver(P, q, A, b, cones)
    assert solver.m == 3
    sol = solver.solve()
    assert sol.status == cc.SolverStatus.SOLVED
    assert np.all(sol.z[0:3] == 0.0)
    assert np.all(sol.s[0:3] == cc.get_infinity())
    assert np.linalg.norm(sol.x - np.array([-0.5, 2.0, -0.5])) < 1e-3


def test_presolve_all_redundant():
    P, q, A, b, cones = presolver_test_data()
    b[:] = 1e30
    solver = cc.Solver(P, q, A, b, cones)
    assert solver.m == 0
    sol = solver.solve()
    assert sol.status == cc.SolverStatus.SOLVED
    assert np.linalg.norm(sol.x + q) < 1e-3


def test_settable_infinity():
    bound = cc.get_infinity()
    cc.set_infinity(1e21)
    assert cc.get_infinity() == 1e21
    cc.set_infinity(bound)
    assert cc.get_infinity() == bound


# -- lasso SOCP stress (socp-lasso.jl, scaled to n=8, m=400) ---------------


def lasso_data():
    rng = np.random.default_rng(12345)
    n = 8
    m = 50 * n
    F = rng.random((m, n))
    vtrue = np.zeros(n)
    vtrue[rng.random(n) < 0.2] = rng.random()
    bvec = F @ vtrue + 0.1 * rng.random(m)
    mu = 0.1 * np.abs(F.T @ bvec).max()

    nv = 2 * n + 3 + m  # [t; x; u; w1; w2; r]
    A1 = -np.zeros((m + 2, nv))
    A1[0, 0] = 1.0
    A1[0, 2 * n + 2] = 1.0
    A1[1, 0] = -1.0
    A1[1, 2 * n + 1] = 1.0
    A1[2:, 1 : 1 + n] = -2.0 * F
    A1[2:, 2 * n + 3 :] = np.eye(m)
    A1 = -A1
    b1 = np.concatenate([[1.0, 1.0], -2.0 * bvec])

    A2 = np.zeros((2 * n, nv))
    A2[:n, 1 : 1 + n] = np.eye(n)
    A2[:n, 1 + n : 1 + 2 * n] = -np.eye(n)
    A2[n:, 1 : 1 + n] = -np.eye(n)
    A2[n:, 1 + n : 1 + 2 * n] = -np.eye(n)
    A2 = -A2
    b2 = np.zeros(2 * n)

    A3 = np.zeros((m + 2, nv))
    A3[0, 2 * n + 1] = -1.0
    A3[1, 2 * n + 2] = -1.0
    A3[2:, 2 * n + 3 :] = -np.eye(m)
    A3 = -A3
    b3 = np.zeros(m + 2)

    q = np.concatenate([[1.0], np.zeros(n), mu * np.ones(n), np.zeros(m + 2)])
    P = np.eye(nv)
    A = np.vstack([A1, A2, A3])
    b = np.concatenate([b1, b2, b3])
    cones = [
        cc.NonnegativeConeT(len(b1)),
        cc.NonnegativeConeT(len(b2)),
        cc.SecondOrderConeT(len(b3)),
    ]
    return P, q, A, b, cones


def test_socp_lasso():
    P, q, A, b, cones = lasso_data()
    sol = cc.Solver(P, q, A, b, cones).solve()
    assert sol.status == cc.SolverStatus.SOLVED
    assert sol.r_prim < 1e-8 and sol.r_dual < 1e-8


# -- factor-precision sweep (analog of linear_solvers.jl backend sweep) ----


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_factor_precision_sweep(precision):
    """The QP/SOCP fixtures must solve to full accuracy under both the
    f32-factor + f64-refinement path (kkt_factor_precision) and the
    all-f64 path."""
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.array([[1.0, 1.0]]), np.eye(2), -np.eye(2)])
    b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(2), cc.NonnegativeConeT(2)]
    sol = cc.Solver(P, q, A, b, cones, kkt_factor_precision=precision).solve()
    assert sol.status == cc.SolverStatus.SOLVED
    assert abs(sol.obj_val - 1.8800000298) < 1e-3
    assert sol.r_prim < 1e-8 and sol.r_dual < 1e-8


def test_profile_phases_device_breakdown():
    """profile_phases returns per-phase device timings (the reference's
    solve! timer sections, types.jl:362-372) and print_timers includes
    them."""
    import cuclarabel_tpu as cc

    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.array([[1.0, 1.0]]), np.eye(2), -np.eye(2)])
    b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(2),
             cc.NonnegativeConeT(2)]
    s = cc.Solver(P, q, A, b, cones)
    s.solve()
    ph = s.profile_phases(reps=1)
    for key in ("scale_cones", "hs_assembly", "kkt_factor", "kkt_solve",
                "residuals", "step_length"):
        assert key in ph and ph[key] > 0.0
    assert s.timers["device"] == ph


def test_info_surface_parity():
    """get_info carries the reference DefaultInfo surface: partial
    infeasibility residuals, solve time, and the linear-solver block
    (types.jl:209-251)."""
    import cuclarabel_tpu as cc

    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.array([[1.0, 1.0]]), np.eye(2), -np.eye(2)])
    b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    s = cc.Solver(P, q, A, b, [cc.ZeroConeT(1), cc.NonnegativeConeT(4)])
    s.solve()
    info = s.get_info()
    for key in ("res_primal_inf", "res_dual_inf", "solve_time",
                "linear_solver", "mu", "sigma", "step_length", "ktratio"):
        assert key in info, key
    ls = info["linear_solver"]
    assert ls["kkt_dim"] == 7 and ls["nnzA"] == 6
