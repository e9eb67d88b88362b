"""QPS reader/writer: round-trip of every transcribed Maros-Meszaros
member, parser feature coverage (RANGES, bound quirks, OBJSENSE,
QMATRIX), and a large MM-style grid member through SparseSolver.

The reference has no QPS reader (problems arrive as Julia structures);
this is the Maros-Meszaros suite's entry point."""

import sys

import numpy as np
import pytest

sys.path.insert(0, ".")

import cuclarabel_tpu as cc
from cuclarabel_tpu.qps import parse_qps, to_clarabel, qps_objective
from benchmarks.maros import PROBLEMS, obj_tol
from benchmarks.qps_corpus import (
    grid_qp_reference, make_grid_qp_qps, maros_to_qps, solve_qps_text,
)


@pytest.mark.parametrize("make", PROBLEMS, ids=lambda f: f.__name__)
def test_qps_roundtrip_maros(make, tmp_path):
    """MarosProblem -> QPS text -> parse -> solve == published optimum."""
    from cuclarabel_tpu.qps import load_qps, write_qps

    p = make()
    path = str(tmp_path / f"{p.name}.qps")
    write_qps(maros_to_qps(p), path)
    qp = load_qps(path)
    P, q, A, b, cones, sgn_c0 = to_clarabel(qp)
    sol = cc.Solver(
        np.asarray(P.todense()), q, np.asarray(A.todense()), b, cones
    ).solve()
    assert sol.status == cc.SolverStatus.SOLVED, p.name
    obj = qps_objective(sgn_c0, sol.obj_val)
    assert obj == pytest.approx(p.obj_golden, abs=obj_tol(p),
                                rel=1e-8), p.name


def test_grid_qp_through_sparse_solver():
    """MM-style AUG2D-class member (n=112) through the QPS path routed
    to the device multifrontal, against the exact KKT reference."""
    rec = solve_qps_text(make_grid_qp_qps(8))
    assert rec["path"] == "sparse"
    assert rec["status"] == "SOLVED"
    assert rec["obj"] == pytest.approx(grid_qp_reference(8), abs=1e-6)


def test_parser_features():
    text = """\
* comment line
NAME          FEATQP
ROWS
 N  COST
 L  CAP
 G  MINP
 E  BAL
 N  FREEROW
COLUMNS
    X1  COST  1.0  CAP  2.0
    X1  MINP  1.0  BAL  1.0
    X1  FREEROW  9.0
    X2  COST  -1.0  CAP  1.0
    X2  BAL  1.0
RHS
    RHS  CAP  10.0  MINP  1.0
    RHS  BAL  4.0  COST  -2.5
RANGES
    RNG  CAP  3.0
BOUNDS
 UP BND  X1  8.0
 MI BND  X2
QUADOBJ
    X1  X1  2.0
    X1  X2  0.5
    X2  X2  4.0
ENDATA
"""
    p = parse_qps(text)
    assert p.name == "FEATQP"
    assert p.c0 == 2.5                     # RHS on objective row = -c0
    assert p.col_names == ["X1", "X2"]
    # CAP: L row 10 with range 3 -> [7, 10]
    i_cap = p.row_names.index("CAP")
    assert (p.rl[i_cap], p.ru[i_cap]) == (7.0, 10.0)
    i_minp = p.row_names.index("MINP")
    assert (p.rl[i_minp], p.ru[i_minp]) == (1.0, np.inf)
    i_bal = p.row_names.index("BAL")
    assert (p.rl[i_bal], p.ru[i_bal]) == (4.0, 4.0)
    i_fr = p.row_names.index("FREEROW")
    assert p.rl[i_fr] == -np.inf and p.ru[i_fr] == np.inf
    # bounds: X1 in [0, 8] (MPS default lower 0), X2 in (-inf, inf)
    assert (p.lb[0], p.ub[0]) == (0.0, 8.0)
    assert p.lb[1] == -np.inf and p.ub[1] == np.inf
    # QUADOBJ is one triangle, symmetrized
    Q = np.asarray(p.Q.todense())
    np.testing.assert_allclose(Q, [[2.0, 0.5], [0.5, 4.0]])

    # the free row contributes nothing to the conic form
    P, q, A, b, cones, sgn_c0 = to_clarabel(p)
    sol = cc.Solver(
        np.asarray(P.todense()), q, np.asarray(A.todense()), b, cones
    ).solve()
    assert sol.status == cc.SolverStatus.SOLVED

    # cross-check with scipy on the same boxed QP
    from scipy.optimize import LinearConstraint, minimize

    Ad = np.asarray(p.A.todense())
    r = minimize(
        lambda x: p.c0 + p.c @ x + 0.5 * x @ Q @ x,
        [1.0, 1.0],
        jac=lambda x: p.c + Q @ x,
        bounds=[(0.0, 8.0), (None, None)],
        constraints=[LinearConstraint(Ad[:3], p.rl[:3], p.ru[:3])],
        method="SLSQP",
        options={"ftol": 1e-14},
    )
    assert qps_objective(sgn_c0, sol.obj_val) == pytest.approx(r.fun, abs=1e-7)


def test_parser_nameless_rhs_ranges():
    """Common MPS dialect that omits the RHS/RANGES set name: 2- and
    4-token lines must parse as (row, value) pairs, not be silently
    dropped (a dropped RHS zeroes every bound and 'solves' the wrong
    problem)."""
    text = """\
NAME NAMELESS
ROWS
 N  COST
 L  CAP
 G  MINP
COLUMNS
    X1  COST  1.0  CAP  1.0
    X1  MINP  1.0
RHS
    CAP  10.0  MINP  1.0
RANGES
    CAP  3.0
BOUNDS
ENDATA
"""
    p = parse_qps(text)
    i_cap = p.row_names.index("CAP")
    assert (p.rl[i_cap], p.ru[i_cap]) == (7.0, 10.0)
    i_minp = p.row_names.index("MINP")
    assert (p.rl[i_minp], p.ru[i_minp]) == (1.0, np.inf)


def test_parser_objsense_max():
    text = """\
NAME MAXLP
OBJSENSE
    MAX
ROWS
 N  OBJ
 L  C1
COLUMNS
    X  OBJ  1.0  C1  1.0
RHS
    RHS  C1  3.0
ENDATA
"""
    p = parse_qps(text)
    assert p.maximize
    P, q, A, b, cones, sgn_c0 = to_clarabel(p)
    sol = cc.Solver(
        np.asarray(P.todense()) if P.shape[0] else np.zeros((1, 1)),
        q, np.asarray(A.todense()), b, cones
    ).solve()
    # max x s.t. x <= 3, x >= 0 -> 3
    assert qps_objective(sgn_c0, sol.obj_val) == pytest.approx(3.0, abs=1e-7)


def test_parser_negative_up_bound_quirk():
    text = """\
NAME Q
ROWS
 N  OBJ
 G  C1
COLUMNS
    X  OBJ  1.0  C1  1.0
RHS
    RHS  C1  -5.0
BOUNDS
 UP BND  X  -1.0
ENDATA
"""
    p = parse_qps(text)
    # negative UP with no LO -> lower bound becomes -inf (classic MPS)
    assert p.lb[0] == -np.inf and p.ub[0] == -1.0


def test_parser_rejects_integer_markers():
    text = """\
NAME MIP
ROWS
 N  OBJ
COLUMNS
    M1  'MARKER'  'INTORG'
    X  OBJ  1.0
ENDATA
"""
    with pytest.raises(ValueError, match="integer"):
        parse_qps(text)


def test_qmatrix_full_not_doubled():
    text = """\
NAME QM
ROWS
 N  OBJ
 G  C1
COLUMNS
    X1  OBJ  0.0  C1  1.0
    X2  C1  1.0
RHS
    RHS  C1  2.0
QMATRIX
    X1  X1  2.0
    X1  X2  1.0
    X2  X1  1.0
    X2  X2  2.0
ENDATA
"""
    p = parse_qps(text)
    Q = np.asarray(p.Q.todense())
    np.testing.assert_allclose(Q, [[2.0, 1.0], [1.0, 2.0]])


def test_cvxqp_s_through_qps_pipeline():
    """Genuine mid-size MM member: CVXQP1_S (n=100, m=50 + bounds),
    reconstructed from its analytic SIF generator (benchmarks/cvxqp.py
    — reconstruction validated against the published optimum
    1.1590718e4 at 8 significant digits), written as QPS text, parsed
    back, and solved.  The published value is asserted at the rounding
    granularity of the repository's 8-digit figure."""
    import numpy as np

    from benchmarks.cvxqp import PUBLISHED, cvxqp_qps
    from cuclarabel_tpu.qps import parse_qps, to_clarabel, write_qps
    import cuclarabel_tpu as cc
    import os
    import tempfile

    p = cvxqp_qps("CVXQP1_S")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "CVXQP1_S.qps")
        write_qps(p, path)
        with open(path) as f:
            p2 = parse_qps(f.read(), name_hint="CVXQP1_S")
    P, q, A, b, cones, sgn_c0 = to_clarabel(p2)
    sol = cc.Solver(np.asarray(P.todense()), q, np.asarray(A.todense()),
                    b, cones).solve()
    assert sol.status == cc.SolverStatus.SOLVED
    from cuclarabel_tpu.qps import qps_objective

    obj = qps_objective(sgn_c0, sol.obj_val)
    assert abs(obj - PUBLISHED["CVXQP1_S"]) < 1e-3
    assert sol.r_prim < 1e-8 and sol.r_dual < 1e-8
