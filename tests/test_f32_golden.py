"""Dtype-parametric golden tier: the OptTest-analog golden problems
solved end-to-end with float32 KKT factors.

The reference runs every OptTest in Float64 AND BigFloat
(test/run_solver_tests.jl:4) to prove dtype genericity.  The
device-relevant precision axis points the other way — REDUCED precision:
`kkt_factor_precision="float32"` factors in f32 and recovers accuracy
through f64 iterative refinement (the throughput knob, settings.py).  This tier asserts the golden optima are still reached
under relaxed tolerances, documenting what f32 factors achieve on each
cone family."""

import numpy as np
import pytest

import cuclarabel_tpu as cc
from tests.test_basic_lp import basic_lp_data
from tests.test_basic_qp import basic_qp_data
from tests.test_basic_socp import basic_socp_data
from tests.test_basic_exp import basic_exp_data
from tests.test_basic_sdp import basic_sdp_data

# f32 factors + f64 refinement reach ~1e-6..1e-8 depending on cond(K);
# run at reduced target tolerances (the documented achievable band)
F32 = dict(
    kkt_factor_precision="float32",
    tol_gap_abs=1e-7, tol_gap_rel=1e-7, tol_feas=1e-7,
)
ATOL = 1e-3  # golden-value assertion, same as the f64 tier


def _solve(P, q, A, b, cones):
    return cc.Solver(P, q, A, b, cones, **F32).solve()


def test_f32_lp():
    P, q, A, b, cones = basic_lp_data()
    sol = _solve(P, q, A, b, cones)
    assert sol.status == cc.SolverStatus.SOLVED
    assert np.linalg.norm(sol.x - np.array([-0.5, 0.5, -0.5])) < ATOL


def test_f32_qp():
    P, q, A, b, cones = basic_qp_data()
    sol = _solve(P, q, A, b, cones)
    assert sol.status == cc.SolverStatus.SOLVED
    assert np.linalg.norm(sol.x - np.array([0.3, 0.7])) < ATOL
    assert abs(sol.obj_val - 1.8800000298331538) < ATOL


def test_f32_socp():
    P, q, A, b, cones = basic_socp_data()
    sol = _solve(P, q, A, b, cones)
    assert sol.status == cc.SolverStatus.SOLVED
    assert np.linalg.norm(
        sol.x - np.array([-0.5, 0.435603, -0.245459])) < ATOL
    assert abs(sol.obj_val - (-0.84590)) < ATOL


def test_f32_exp():
    out = basic_exp_data()
    P, q, A, b, cones = out[:5]
    sol = _solve(P, q, A, b, cones)
    assert sol.status in (cc.SolverStatus.SOLVED,
                          cc.SolverStatus.ALMOST_SOLVED)


def test_f32_sdp():
    P, q, A, b, cones = basic_sdp_data()
    sol = _solve(P, q, A, b, cones)
    assert sol.status in (cc.SolverStatus.SOLVED,
                          cc.SolverStatus.ALMOST_SOLVED)
    assert abs(sol.obj_val - 4.840076866013861) < 1e-2


def test_f32_maros_members():
    """Transcribed MM members under f32 factors (tolerances relaxed to
    the f32 band)."""
    from benchmarks.maros import hs21, hs35, hs76, tame

    for make in (hs21, hs35, hs76, tame):
        p = make()
        sol = cc.Solver(p.P, p.q, p.A, p.b, p.cones, **F32).solve()
        assert sol.status in (cc.SolverStatus.SOLVED,
                              cc.SolverStatus.ALMOST_SOLVED), p.name
        obj = sol.obj_val + p.obj_const
        assert obj == pytest.approx(p.obj_golden, abs=1e-3), p.name


def test_f32_reports_precision():
    P, q, A, b, cones = basic_qp_data()
    s = cc.Solver(P, q, A, b, cones, **F32)
    s.solve()
    assert s.get_info()["linear_solver"]["factor_precision"] == "float32"
