"""Parametric re-solves: update_data + warm_start.

A portfolio QP re-solved as expected returns drift a little each
period (the MPC / scenario-sweep pattern).  The compiled program,
symbolic analysis, and equilibration are all reused via update_data;
warm starting from the previous solution cuts iteration counts by
~2-3x when the data change is small.

Run:  python examples/mpc_warm_start.py
"""

import os
import sys

# runnable from anywhere without installation; runs on the default JAX
# backend (the GPU when there is one; JAX_PLATFORMS=cpu forces the CPU)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

import cuclarabel_tpu as cc


def main():
    rng = np.random.default_rng(0)
    n = 50
    F = rng.standard_normal((n, 10)) / np.sqrt(10)
    P = 2 * (F @ F.T + 0.05 * np.eye(n))        # risk model
    mu = 0.1 * rng.random(n)                    # expected returns
    # budget + long-only + position caps
    A = np.vstack([np.ones((1, n)), -np.eye(n), np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n), np.full(n, 0.1)])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(2 * n)]

    solver = cc.Solver(P, -mu, A, b, cones, presolve_enable=False)
    prev = solver.solve()
    print(f"initial solve: {prev.status.name} in {prev.iterations} iters")

    cold_iters = warm_iters = 0
    for period in range(20):
        mu = mu * (1.0 + 0.01 * rng.standard_normal(n))   # small drift
        solver.update_q(-mu)                              # reuses program
        cold = solver.solve()
        warm = solver.solve(warm_start=(prev.x, prev.s, prev.z))
        assert abs(cold.obj_val - warm.obj_val) < 1e-7
        cold_iters += cold.iterations
        warm_iters += warm.iterations
        prev = warm

    print(f"20 re-solves: cold {cold_iters} iters, warm {warm_iters} iters "
          f"({cold_iters / warm_iters:.1f}x fewer)")


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"wall: {time.perf_counter() - t0:.1f}s (incl. one-time compile)")
