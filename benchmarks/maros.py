"""Named Maros-Meszaros problems (real corpus members, transcribed).

The Maros-Meszaros convex-QP test set is the standard benchmark class
for this solver family.  The archive
itself (QPS files) cannot be vendored here, but several of its members
are small Hock-Schittkowski problems with fully published definitions
and exact optimal values; those are transcribed below from the H-S
collection (Lecture Notes in Econ. & Math. Systems 187) — actual
corpus members, not synthetic stand-ins.

Each entry returns the problem in this solver's native form

    minimize   (1/2) x'Px + q'x          (+ obj_const, tracked here)
    subject to Ax + s = b,  s in K

with K built from zero (equality) and nonnegative (inequality) cones,
plus the exact optimal objective value for assertion.

MM reference values (objective including the constant term):
  HS3    0                    HS3MOD  0
  HS21   -99.96               HS28    0
  HS35   0.111111 (1/9)       HS35MOD 0.25
  HS48   0                    HS51    0
  HS52   5.32664756 (1859/349)
  HS53   4.09302326 (176/43)  HS76   -4.68181818
  HS118  664.82045            HS268   0
  GENHS28 0.927173567
  QPTEST 4.371875             TAME    0

Every transcription is numerically cross-checked against an
independent reference (scipy SLSQP, or the exact KKT solve for
equality-constrained members) in tests/test_maros.py; agreement with
the published optimum to >= 7 digits validates the transcription.
"""

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

import cuclarabel_tpu as cc


@dataclass
class MarosProblem:
    name: str
    P: np.ndarray
    q: np.ndarray
    A: np.ndarray
    b: np.ndarray
    cones: list
    obj_const: float      # constant term of the published objective
    obj_golden: float     # published optimal value (incl. constant)


def _rows(eq: List[Tuple[np.ndarray, float]],
          le: List[Tuple[np.ndarray, float]]):
    """Stack equality rows (zero cone) then <= rows (nonnegative cone)."""
    A = np.array([r for r, _ in eq] + [r for r, _ in le], dtype=float)
    b = np.array([v for _, v in eq] + [v for _, v in le], dtype=float)
    cones = []
    if eq:
        cones.append(cc.ZeroConeT(len(eq)))
    if le:
        cones.append(cc.NonnegativeConeT(len(le)))
    return A, b, cones


def hs21() -> MarosProblem:
    """min 0.01 x1^2 + x2^2 - 100, s.t. 10 x1 - x2 >= 10,
    2 <= x1 <= 50, -50 <= x2 <= 50.  Optimum -99.96 at (2, 0)."""
    P = np.diag([0.02, 2.0])
    q = np.zeros(2)
    e1, e2 = np.eye(2)
    A, b, cones = _rows(
        eq=[],
        le=[(-10 * e1 + e2, -10.0),      # 10 x1 - x2 >= 10
            (e1, 50.0), (-e1, -2.0),
            (e2, 50.0), (-e2, 50.0)],
    )
    return MarosProblem("HS21", P, q, A, b, cones, -100.0, -99.96)


def hs35() -> MarosProblem:
    """min 9 - 8x1 - 6x2 - 4x3 + 2x1^2 + 2x2^2 + x3^2 + 2x1x2 + 2x1x3
    s.t. x1 + x2 + 2x3 <= 3, x >= 0.  Optimum 1/9."""
    P = np.array([[4.0, 2.0, 2.0], [2.0, 4.0, 0.0], [2.0, 0.0, 2.0]])
    q = np.array([-8.0, -6.0, -4.0])
    e = np.eye(3)
    A, b, cones = _rows(
        eq=[],
        le=[(np.array([1.0, 1.0, 2.0]), 3.0),
            (-e[0], 0.0), (-e[1], 0.0), (-e[2], 0.0)],
    )
    return MarosProblem("HS35", P, q, A, b, cones, 9.0, 1.0 / 9.0)


def _hs51_objective():
    """(x1-x2)^2 + (x2+x3-2)^2 + (x4-1)^2 + (x5-1)^2 as (P, q, const)."""
    P = np.array([
        [2.0, -2.0, 0.0, 0.0, 0.0],
        [-2.0, 4.0, 2.0, 0.0, 0.0],
        [0.0, 2.0, 2.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 2.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 2.0],
    ])
    q = np.array([0.0, -4.0, -4.0, -2.0, -2.0])
    return P, q, 6.0


_HS5X_EQ = [
    (np.array([1.0, 3.0, 0.0, 0.0, 0.0]), None),   # x1 + 3 x2
    (np.array([0.0, 0.0, 1.0, 1.0, -2.0]), 0.0),   # x3 + x4 - 2 x5
    (np.array([0.0, 1.0, 0.0, 0.0, -1.0]), 0.0),   # x2 - x5
]


def hs51() -> MarosProblem:
    """HS51: the HS5x quadratic with x1+3x2 = 4.  Optimum 0 at e."""
    P, q, const = _hs51_objective()
    eq = [(_HS5X_EQ[0][0], 4.0), _HS5X_EQ[1], _HS5X_EQ[2]]
    A, b, cones = _rows(eq=eq, le=[])
    return MarosProblem("HS51", P, q, A, b, cones, const, 0.0)


def hs52() -> MarosProblem:
    """HS52: first objective term is (4x1 - x2)^2; x1+3x2 = 0.
    Optimum 1859/349."""
    P, q, const = _hs51_objective()
    P = P.copy()
    P[0, 0] = 32.0
    P[0, 1] = P[1, 0] = -8.0
    eq = [(_HS5X_EQ[0][0], 0.0), _HS5X_EQ[1], _HS5X_EQ[2]]
    A, b, cones = _rows(eq=eq, le=[])
    return MarosProblem("HS52", P, q, A, b, cones, const, 1859.0 / 349.0)


def hs53() -> MarosProblem:
    """HS53: HS51 objective, x1+3x2 = 0, and -10 <= x <= 10.
    Optimum 176/43."""
    P, q, const = _hs51_objective()
    eq = [(_HS5X_EQ[0][0], 0.0), _HS5X_EQ[1], _HS5X_EQ[2]]
    e = np.eye(5)
    le = [(e[i], 10.0) for i in range(5)] + [(-e[i], 10.0) for i in range(5)]
    A, b, cones = _rows(eq=eq, le=le)
    return MarosProblem("HS53", P, q, A, b, cones, const, 176.0 / 43.0)


def hs76() -> MarosProblem:
    """min x1^2 + .5x2^2 + x3^2 + .5x4^2 - x1x3 + x3x4 - x1 - 3x2 + x3 - x4
    s.t. x1+2x2+x3+x4 <= 5; 3x1+x2+2x3-x4 <= 4; x2+4x3 >= 1.5; x >= 0.
    Optimum -4.681818..."""
    P = np.array([
        [2.0, 0.0, -1.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [-1.0, 0.0, 2.0, 1.0],
        [0.0, 0.0, 1.0, 1.0],
    ])
    q = np.array([-1.0, -3.0, 1.0, -1.0])
    e = np.eye(4)
    A, b, cones = _rows(
        eq=[],
        le=[(np.array([1.0, 2.0, 1.0, 1.0]), 5.0),
            (np.array([3.0, 1.0, 2.0, -1.0]), 4.0),
            (np.array([0.0, -1.0, -4.0, 0.0]), -1.5),
            (-e[0], 0.0), (-e[1], 0.0), (-e[2], 0.0), (-e[3], 0.0)],
    )
    return MarosProblem("HS76", P, q, A, b, cones, 0.0,
                        -4.6818181818181817)


def hs35mod() -> MarosProblem:
    """HS35 with x2 fixed at 0.5 (the MM modification).  Optimum 0.25
    (verified: fixing x2 = 0.5 in the HS35 quadratic gives exactly
    1/4)."""
    base = hs35()
    e2 = np.eye(3)[1]
    A = np.vstack([e2, base.A])
    b = np.concatenate([[0.5], base.b])
    cones = [cc.ZeroConeT(1)] + base.cones
    return MarosProblem("HS35MOD", base.P, base.q, A, b, cones, 9.0, 0.25)


def hs118() -> MarosProblem:
    """HS118 (n=15): separable convex quadratic cost over 5 periods of
    3 activities with ramp (difference) constraints and period-sum
    lower bounds.  Optimum 664.82045 (H-S #118; scipy-verified to
    1e-10)."""
    n = 15
    c1 = np.zeros(n)
    c2 = np.zeros(n)
    for k in range(5):
        c1[3 * k + 0], c2[3 * k + 0] = 2.3, 0.0001
        c1[3 * k + 1], c2[3 * k + 1] = 1.7, 0.0001
        c1[3 * k + 2], c2[3 * k + 2] = 2.2, 0.00015
    P = np.diag(2.0 * c2)
    q = c1
    le = []
    # ramp constraints: lo <= x_{3k+j} - x_{3(k-1)+j} + 7 <= hi
    for k in range(1, 5):
        for j, hi in ((0, 13.0), (1, 14.0), (2, 13.0)):
            r = np.zeros(n)
            r[3 * k + j] = 1.0
            r[3 * (k - 1) + j] = -1.0
            le.append((r, hi - 7.0))       # diff <= hi - 7
            le.append((-r, 7.0))           # diff >= -7
    sums = [60.0, 50.0, 70.0, 85.0, 100.0]
    for k in range(5):
        r = np.zeros(n)
        r[3 * k : 3 * k + 3] = 1.0
        le.append((-r, -sums[k]))          # period sum >= s_k
    bounds = [(8.0, 21.0), (43.0, 57.0), (3.0, 16.0)] + [
        (0.0, 90.0), (0.0, 120.0), (0.0, 60.0)
    ] * 4
    e = np.eye(n)
    for j, (lo, hi) in enumerate(bounds):
        le.append((e[j], hi))
        le.append((-e[j], -lo))
    A, b, cones = _rows(eq=[], le=le)
    return MarosProblem("HS118", P, q, A, b, cones, 0.0, 664.82045)


def genhs28() -> MarosProblem:
    """GENHS28 (n=10): min sum_{i=1..9} (x_i + x_{i+1})^2 subject to
    x_i + 2 x_{i+1} + 3 x_{i+2} = 1 (i = 1..8).  Optimum 0.927173567
    (exact KKT reference 0.9271736937...)."""
    n = 10
    P = np.zeros((n, n))
    for i in range(n - 1):
        P[i, i] += 2.0
        P[i + 1, i + 1] += 2.0
        P[i, i + 1] += 2.0
        P[i + 1, i] += 2.0
    q = np.zeros(n)
    eq = []
    for i in range(8):
        r = np.zeros(n)
        r[i], r[i + 1], r[i + 2] = 1.0, 2.0, 3.0
        eq.append((r, 1.0))
    A, b, cones = _rows(eq=eq, le=[])
    return MarosProblem("GENHS28", P, q, A, b, cones, 0.0,
                        0.9271736937663911)


def qptest() -> MarosProblem:
    """QPTEST (n=2): min 1.5 x1 - 2 x2 + (1/2)(8 x1^2 + 4 x1 x2
    + 10 x2^2) s.t. 2 x1 + x2 >= 2, -x1 + 2 x2 <= 6, 0 <= x1 <= 20,
    x2 >= 0.  Optimum 4.371875 (scipy-verified)."""
    P = np.array([[8.0, 2.0], [2.0, 10.0]])
    q = np.array([1.5, -2.0])
    e = np.eye(2)
    A, b, cones = _rows(
        eq=[],
        le=[(np.array([-2.0, -1.0]), -2.0),
            (np.array([-1.0, 2.0]), 6.0),
            (e[0], 20.0), (-e[0], 0.0), (-e[1], 0.0)],
    )
    return MarosProblem("QPTEST", P, q, A, b, cones, 0.0, 4.371875)


def tame() -> MarosProblem:
    """min (x1 - x2)^2 s.t. x1 + x2 = 1, x >= 0.  Optimum 0."""
    P = np.array([[2.0, -2.0], [-2.0, 2.0]])
    q = np.zeros(2)
    e = np.eye(2)
    A, b, cones = _rows(
        eq=[(np.array([1.0, 1.0]), 1.0)],
        le=[(-e[0], 0.0), (-e[1], 0.0)],
    )
    return MarosProblem("TAME", P, q, A, b, cones, 0.0, 0.0)


def hs3() -> MarosProblem:
    """HS3: min x2 + 1e-5 (x2 - x1)^2 s.t. x2 >= 0.  Optimum 0 at
    (0, 0).  Near-singular P (scale 2e-5) — an equilibration stress
    member of the MM set."""
    P = 2e-5 * np.array([[1.0, -1.0], [-1.0, 1.0]])
    q = np.array([0.0, 1.0])
    A, b, cones = _rows(eq=[], le=[(np.array([0.0, -1.0]), 0.0)])
    return MarosProblem("HS3", P, q, A, b, cones, 0.0, 0.0)


def hs3mod() -> MarosProblem:
    """HS3MOD (MM modification of HS3): the (x2 - x1)^2 term at unit
    weight — min x2 + (x2 - x1)^2 s.t. x2 >= 0.  Optimum 0 at (0, 0)."""
    P = 2.0 * np.array([[1.0, -1.0], [-1.0, 1.0]])
    q = np.array([0.0, 1.0])
    A, b, cones = _rows(eq=[], le=[(np.array([0.0, -1.0]), 0.0)])
    return MarosProblem("HS3MOD", P, q, A, b, cones, 0.0, 0.0)


def hs28() -> MarosProblem:
    """HS28: min (x1 + x2)^2 + (x2 + x3)^2 s.t. x1 + 2 x2 + 3 x3 = 1.
    Optimum 0 at (0.5, -0.5, 0.5) (feasible: 0.5 - 1 + 1.5 = 1; both
    squared terms vanish)."""
    P = np.array([[2.0, 2.0, 0.0], [2.0, 4.0, 2.0], [0.0, 2.0, 2.0]])
    q = np.zeros(3)
    A, b, cones = _rows(eq=[(np.array([1.0, 2.0, 3.0]), 1.0)], le=[])
    return MarosProblem("HS28", P, q, A, b, cones, 0.0, 0.0)


def hs48() -> MarosProblem:
    """HS48: min (x1-1)^2 + (x2-x3)^2 + (x4-x5)^2 s.t.
    x1+x2+x3+x4+x5 = 5, x3 - 2(x4+x5) = -3.  Optimum 0 at the all-ones
    point (feasible: 5 = 5, 1 - 4 = -3; every squared term vanishes)."""
    P = np.zeros((5, 5))
    P[0, 0] = 2.0
    P[1, 1] = P[2, 2] = 2.0
    P[1, 2] = P[2, 1] = -2.0
    P[3, 3] = P[4, 4] = 2.0
    P[3, 4] = P[4, 3] = -2.0
    q = np.array([-2.0, 0.0, 0.0, 0.0, 0.0])
    A, b, cones = _rows(
        eq=[(np.ones(5), 5.0),
            (np.array([0.0, 0.0, 1.0, -2.0, -2.0]), -3.0)],
        le=[],
    )
    return MarosProblem("HS48", P, q, A, b, cones, 1.0, 0.0)


_HS268_D = np.array([
    [-74.0, 80.0, 18.0, -11.0, -4.0],
    [14.0, -69.0, 21.0, 28.0, 0.0],
    [66.0, -72.0, -5.0, 7.0, 1.0],
    [-12.0, 66.0, -30.0, -23.0, 3.0],
    [3.0, 8.0, -7.0, -4.0, 1.0],
])
_HS268_d = np.array([51.0, -61.0, -56.0, 69.0, 10.0])


def hs268() -> MarosProblem:
    """HS268 (= MM S268): min x'D'Dx - 2 d'Dx + d'd over 5 linear
    inequalities.  Optimum 0 at x* = (1, 2, -1, 3, -4): the data are
    self-consistency-checked in tests (D x* == d exactly, so the
    unconstrained minimum is attained; g5 is active with value 0).
    Large integer coefficients make P badly scaled (|P| up to ~2.6e4)
    — an equilibration/accuracy stress member."""
    D, d = _HS268_D, _HS268_d
    P = 2.0 * (D.T @ D)
    q = -2.0 * (D.T @ d)
    const = float(d @ d)
    # g >= 0 rows, written as (-g_row) x <= g_const
    ge = [
        (np.array([-1.0, -1.0, -1.0, -1.0, -1.0]), 5.0),
        (np.array([10.0, 10.0, -3.0, 5.0, 4.0]), -20.0),
        (np.array([-8.0, 1.0, -2.0, -5.0, 3.0]), 40.0),
        (np.array([8.0, -1.0, 2.0, 5.0, -3.0]), -11.0),
        (np.array([-4.0, -2.0, 3.0, -5.0, 1.0]), 30.0),
    ]
    le = [(-r, c) for r, c in ge]
    A, b, cones = _rows(eq=[], le=le)
    return MarosProblem("HS268", P, q, A, b, cones, const, 0.0)


PROBLEMS = [hs3, hs3mod, hs21, hs28, hs35, hs35mod, hs48, hs51, hs52,
            hs53, hs76, hs118, hs268, genhs28, qptest, tame]


def obj_tol(p) -> float:
    """Scale-aware absolute objective tolerance for asserting the
    published optimum: a 1e-8-KKT solve's objective error floor grows
    with the data scale (HS268's squared-distance objective carries a
    1.4e4 constant — 2.5e-5 absolute there is ~2e-9 relative)."""
    return max(2e-6, 2e-8 * (1.0 + abs(p.obj_const) + abs(p.obj_golden)))


def run(verbose: bool = False):
    import time

    results = []
    for make in PROBLEMS:
        p = make()
        solver = cc.Solver(p.P, p.q, p.A, p.b, p.cones)
        t0 = time.perf_counter()
        sol = solver.solve()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        sol = solver.solve()
        warm = time.perf_counter() - t0
        obj = sol.obj_val + p.obj_const
        results.append({
            "name": p.name,
            "status": sol.status.name,
            "obj": obj,
            "obj_golden": p.obj_golden,
            "obj_err": abs(obj - p.obj_golden),
            # the tolerance this member is actually asserted at
            # (scale-aware; see obj_tol) — artifacts must show what
            # "matches the published optimum" meant per row
            "obj_tol": obj_tol(p),
            "r_prim": float(sol.r_prim),
            "r_dual": float(sol.r_dual),
            "iters": sol.iterations,
            "warm_ms": warm * 1e3,
            "cold_s": cold,
        })
        if verbose:
            print(results[-1])
    return results


if __name__ == "__main__":
    import json

    for r in run(verbose=False):
        print(json.dumps(r))
