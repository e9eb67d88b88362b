"""SparseSolver end-to-end: sparse LP/QP through the device
multifrontal KKT backend, against the dense Solver."""

import numpy as np
import pytest
import scipy.sparse as sp

from cuclarabel_tpu.cones import api
from cuclarabel_tpu.solver import Solver
from cuclarabel_tpu.sparse_solver import SparseSolver
from cuclarabel_tpu.statuscodes import SolverStatus


def _grid_qp(k, seed=0):
    """Grid-Laplacian QP: min 0.5 x'Px + q'x s.t. sum x = 1, x >= lb."""
    rng = np.random.default_rng(seed)
    n = k * k
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (k, k))
    P = (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k))
         + sp.eye(n)).tocsc()
    q = rng.standard_normal(n)
    A = sp.vstack([
        sp.csr_matrix(np.ones((1, n))),
        -sp.eye(n),
    ]).tocsc()
    lb = -1.0 - rng.random(n)
    b = np.concatenate([[1.0], -lb])
    cones = [api.ZeroConeT(1), api.NonnegativeConeT(n)]
    return P, q, A, b, cones


def test_sparse_qp_matches_dense():
    P, q, A, b, cones = _grid_qp(5)
    s_sp = SparseSolver(P, q, A, b, cones).solve()
    s_dn = Solver(P.toarray(), q, A.toarray(), b, cones,
                  presolve_enable=False).solve()
    assert s_sp.status == SolverStatus.SOLVED
    np.testing.assert_allclose(s_sp.x, s_dn.x, atol=1e-6)
    assert np.isclose(s_sp.obj_val, s_dn.obj_val, atol=1e-7)
    assert s_sp.r_prim < 1e-8 and s_sp.r_dual < 1e-8


def test_sparse_lp():
    rng = np.random.default_rng(1)
    n = 60
    A0 = sp.random(25, n, density=0.2,
                   random_state=np.random.RandomState(2), format="csc")
    x0 = np.abs(rng.standard_normal(n)) + 0.1
    brow = np.asarray(A0 @ x0).ravel() + 1.0
    A = sp.vstack([A0, -sp.eye(n)]).tocsc()
    b = np.concatenate([brow, np.zeros(n)])
    q = rng.random(n)
    cones = [api.NonnegativeConeT(25), api.NonnegativeConeT(n)]
    s_sp = SparseSolver(None, q, A, b, cones).solve()
    s_dn = Solver(None, q, A.toarray(), b, cones,
                  presolve_enable=False).solve()
    assert s_sp.status == SolverStatus.SOLVED
    assert np.isclose(s_sp.obj_val, s_dn.obj_val, atol=1e-7)


def test_sparse_infeasible():
    n = 10
    A = sp.vstack([sp.eye(n), -sp.eye(n)]).tocsc()
    b = np.concatenate([-np.ones(n), -np.ones(n)])  # x <= -1, x >= 1
    q = np.zeros(n)
    cones = [api.NonnegativeConeT(2 * n)]
    s = SparseSolver(None, q, A, b, cones).solve()
    assert s.status in (SolverStatus.PRIMAL_INFEASIBLE,
                        SolverStatus.ALMOST_PRIMAL_INFEASIBLE)


def test_sparse_medium_scale():
    """Larger instance (N ~ 800) solves and stays accurate.  (Kept
    moderate: late-suite XLA:CPU compiles of very deep level schedules
    have segfaulted under accumulated heap pressure.)"""
    P, q, A, b, cones = _grid_qp(14, seed=3)
    s_sp = SparseSolver(P, q, A, b, cones).solve()
    assert s_sp.status == SolverStatus.SOLVED
    assert s_sp.r_prim < 1e-8 and s_sp.r_dual < 1e-8


def test_sparse_socp_small_blocks():
    """SOC dim <= 4: dense blocks inside the sparse pattern."""
    rng = np.random.default_rng(5)
    n = 8
    G = rng.standard_normal((3, n)) / 3.0
    A = sp.vstack([
        sp.csr_matrix(np.ones((1, n))),
        -sp.eye(n),
        sp.csr_matrix(np.zeros((1, n))),
        sp.csr_matrix(-G),
    ]).tocsc()
    b = np.concatenate([[1.0], np.zeros(n), [0.25], np.zeros(3)])
    q = -rng.random(n)
    cones = [api.ZeroConeT(1), api.NonnegativeConeT(n),
             api.SecondOrderConeT(4)]
    s_sp = SparseSolver(None, q, A, b, cones).solve()
    s_dn = Solver(None, q, A.toarray(), b, cones,
                  presolve_enable=False).solve()
    assert s_sp.status == SolverStatus.SOLVED
    np.testing.assert_allclose(s_sp.x, s_dn.x, atol=1e-6)
    assert np.isclose(s_sp.obj_val, s_dn.obj_val, atol=1e-7)


def test_sparse_socp_rank2_expansion():
    """SOC dim > 4 goes through the rank-2 expansion columns
    (directldl_datamaps.jl:8-79 semantics)."""
    rng = np.random.default_rng(6)
    n = 10
    G = rng.standard_normal((7, n)) / 4.0
    A = sp.vstack([
        sp.csr_matrix(np.ones((1, n))),
        -sp.eye(n),
        sp.csr_matrix(np.zeros((1, n))),
        sp.csr_matrix(-G),
    ]).tocsc()
    b = np.concatenate([[1.0], np.zeros(n), [0.4], np.zeros(7)])
    q = -rng.random(n)
    cones = [api.ZeroConeT(1), api.NonnegativeConeT(n),
             api.SecondOrderConeT(8)]
    s_sp = SparseSolver(None, q, A, b, cones).solve()
    s_dn = Solver(None, q, A.toarray(), b, cones,
                  presolve_enable=False).solve()
    assert s_sp.status == SolverStatus.SOLVED
    np.testing.assert_allclose(s_sp.x, s_dn.x, atol=1e-6)
    assert np.isclose(s_sp.obj_val, s_dn.obj_val, atol=1e-7)
    assert s_sp.r_prim < 1e-8 and s_sp.r_dual < 1e-8


def test_sparse_exp_cone():
    """Exponential cone 3x3 block in the sparse pattern: max x s.t.
    (x, 1, e) in ExpCone."""
    n = 3
    A = sp.csc_matrix(-np.eye(3))
    b = np.zeros(3)
    q = np.array([-1.0, 0.0, 0.0])
    Aeq = sp.vstack([
        A,
        sp.csr_matrix(np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])),
    ]).tocsc()
    beq = np.concatenate([b, [1.0, float(np.e)]])
    cones = [api.ExponentialConeT(), api.ZeroConeT(2)]
    s_sp = SparseSolver(None, q, Aeq, beq, cones).solve()
    assert s_sp.status == SolverStatus.SOLVED
    assert np.isclose(s_sp.x[0], 1.0, atol=1e-6)


def test_sparse_genpow_rank3_expansion():
    """GenPow cones go through the rank-3 (q, r, p) expansion columns
    (directldl_datamaps.jl:81-167); golden value from basic_genpow."""
    from tests.test_basic_pow import basic_genpow_data

    P, q, A, b, cones = basic_genpow_data()
    s_sp = SparseSolver(sp.csc_matrix(P) if P is not None else None, q,
                        sp.csc_matrix(A), b, cones).solve()
    assert s_sp.status == SolverStatus.SOLVED
    assert abs(s_sp.obj_val - (-1.8458)) < 1e-3
    s_dn = Solver(P, q, A, b, cones, presolve_enable=False).solve()
    np.testing.assert_allclose(s_sp.x, s_dn.x, atol=1e-6)


def test_sparse_sdp_blocks():
    """Small PSD cones ride the sparse path as dense svec Hs blocks
    (the chordal-clique shape).  Block-diagonal SDP: two independent
    2x2 trace-minimization blocks + a coupling simplex on the
    diagonals."""
    rng = np.random.default_rng(11)
    sd = 3  # svec dim of a 2x2 block
    n = 2 * sd
    # min <C, X1> + <C, X2>  s.t.  diag sums fixed, X1, X2 PSD
    C1 = np.array([1.0, 0.3, 1.5])   # svec coords of symmetric C
    C2 = np.array([2.0, -0.2, 0.7])
    q = np.concatenate([C1, C2])
    # equality: tr(X1) = 1, tr(X2) = 1  (svec diag entries at 0, 2)
    tr_row = np.array([1.0, 0.0, 1.0])
    Aeq = np.zeros((2, n))
    Aeq[0, :sd] = tr_row
    Aeq[1, sd:] = tr_row
    beq = np.array([1.0, 1.0])
    A = sp.csc_matrix(np.vstack([Aeq, -np.eye(n)]))
    b = np.concatenate([beq, np.zeros(n)])
    cones = [api.ZeroConeT(2), api.PSDTriangleConeT(2),
             api.PSDTriangleConeT(2)]

    s_sp = SparseSolver(None, q, A, b, cones).solve()
    s_dn = Solver(None, q, A.toarray(), b, cones,
                  presolve_enable=False).solve()
    assert s_sp.status == SolverStatus.SOLVED
    assert s_dn.status == SolverStatus.SOLVED
    np.testing.assert_allclose(s_sp.x, s_dn.x, atol=1e-6)
    assert np.isclose(s_sp.obj_val, s_dn.obj_val, atol=1e-7)
    assert s_sp.r_prim < 1e-8 and s_sp.r_dual < 1e-8


def test_sparse_sdp_chordal():
    """A chordally-sparse SDP decomposes into clique-sized PSD blocks
    and solves through the multifrontal path, matching the dense
    Solver (reference fixture: test/OptTests/sdp_chordal.jl)."""
    from test_sdp_chordal import sdp_chordal_data

    P, q, A, b, cones = sdp_chordal_data()
    kw = dict(
        chordal_decomposition_enable=True,
        chordal_decomposition_compact=True,
        chordal_decomposition_complete_dual=True,
        chordal_decomposition_merge_method="none",
    )
    s_sp = SparseSolver(sp.csc_matrix(P), q, sp.csc_matrix(A), b,
                        cones, **kw)
    assert s_sp.chordal_info is not None  # decomposition fired
    sol_sp = s_sp.solve()
    sol_dn = Solver(P, q, A, b, cones, **kw).solve()
    assert sol_sp.status == SolverStatus.SOLVED
    np.testing.assert_allclose(sol_sp.x, sol_dn.x, atol=1e-6)
    assert np.isclose(sol_sp.obj_val, sol_dn.obj_val, atol=1e-7)
    # solution vectors are in the ORIGINAL (pre-decomposition) space
    assert sol_sp.s.shape[0] == b.shape[0]
    assert sol_sp.z.shape[0] == b.shape[0]
    # data updates are forbidden after decomposition
    with pytest.raises(ValueError, match="chordal"):
        s_sp.update_b(b)


def test_sparse_update_data_resolve():
    """Parametric re-solve: same sparsity pattern, new values; reuses
    the symbolic factorization and the compiled program
    (data_updating.jl semantics on the sparse path)."""
    P, q, A, b, cones = _grid_qp(5, seed=9)
    solver = SparseSolver(P, q, A, b, cones)
    s1 = solver.solve()
    assert s1.status == SolverStatus.SOLVED

    q2 = q * 2.0 + 0.1
    b2 = b + 0.05
    P2 = P * 1.5
    solver.update_data(P=P2, q=q2, b=b2)
    s2 = solver.solve()
    ref = SparseSolver(P2, q2, A, b2, cones).solve()
    assert s2.status == SolverStatus.SOLVED
    np.testing.assert_allclose(s2.x, ref.x, atol=1e-7)
    assert np.isclose(s2.obj_val, ref.obj_val, atol=1e-8)

    with pytest.raises(ValueError, match="pattern"):
        bad = P.tolil(copy=True)
        bad[0, 3] = 5.0  # new structural entry off the grid stencil
        solver.update_P(bad.tocsc())


def test_sparse_dropzeros_setting():
    """input_sparse_dropzeros=True prunes explicit zeros from the
    stored pattern (problemdata.jl:64-70 analog)."""
    P, q, A, b, cones = _grid_qp(4, seed=11)
    # P from scipy.kron carries explicit zeros (BSR blocks)
    nnz_with = SparseSolver(P, q, A, b, cones)._sp.P_rows.shape[0]
    nnz_drop = SparseSolver(P, q, A, b, cones,
                            input_sparse_dropzeros=True)._sp.P_rows.shape[0]
    assert nnz_drop <= nnz_with
    s = SparseSolver(P, q, A, b, cones, input_sparse_dropzeros=True).solve()
    assert s.status == SolverStatus.SOLVED


def test_sparse_presolve_roundtrip():
    """Infinite-bound rows drop before pattern analysis and the slacks
    come back as s=infbound, z=0 (presolver.jl:85-107)."""
    from cuclarabel_tpu.infinity import get_infinity

    P, q, A, b, cones = _grid_qp(5, seed=13)
    b2 = b.copy()
    b2[3] = 1e21  # above INFINITY -> dropped
    solver = SparseSolver(P, q, A, b2, cones)
    assert solver.presolver is not None
    sol = solver.solve()
    assert sol.status == SolverStatus.SOLVED
    assert sol.s.shape[0] == b.shape[0]
    assert sol.s[3] == get_infinity()
    assert sol.z[3] == 0.0
    with pytest.raises(ValueError, match="presolver"):
        solver.update_q(q)


def test_sparse_f32_factor_precision():
    """kkt_factor_precision='float32' factors the fronts in f32 with f64
    refinement against the f64 K; solutions
    still hit the default 1e-8 tolerances on well-conditioned data."""
    P, q, A, b, cones = _grid_qp(5)
    s32 = SparseSolver(P, q, A, b, cones,
                       kkt_factor_precision="float32").solve()
    s64 = SparseSolver(P, q, A, b, cones).solve()
    assert s32.status == SolverStatus.SOLVED
    assert s32.r_prim < 1e-8 and s32.r_dual < 1e-8
    np.testing.assert_allclose(s32.x, s64.x, atol=1e-6)
    assert np.isclose(s32.obj_val, s64.obj_val, atol=1e-7)
