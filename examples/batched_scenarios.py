"""Batched scenario solving: B problems as ONE device program.

Monte-Carlo portfolio scenarios (shared structure, different returns)
solve as a single vmapped program sharded over the available devices —
the framework's data-parallel axis, every problem at the full 1e-8
tolerance (bench.py measures its throughput).

Run:  python examples/batched_scenarios.py
"""

import os
import sys

# runnable from anywhere without installation; runs on the default JAX
# backend (the GPU when there is one; JAX_PLATFORMS=cpu forces the CPU)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

import cuclarabel_tpu as cc
from cuclarabel_tpu.parallel import BatchSolver


def main():
    rng = np.random.default_rng(1)
    n, B = 30, 64
    G = rng.standard_normal((12, n)) / np.sqrt(12)   # factor loadings
    mus = 0.1 * rng.random((B, n))                   # per-scenario returns
    gamma = 0.3

    # min -mu'w  s.t.  sum w = 1,  w >= 0,  ||G w|| <= gamma
    A = np.vstack([np.ones((1, n)), -np.eye(n), np.zeros((1, n)), -G])
    b = np.concatenate([[1.0], np.zeros(n), [gamma], np.zeros(12)])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(n),
             cc.SecondOrderConeT(13)]

    qs = -mus
    bs = np.broadcast_to(b, (B, len(b)))

    import jax
    ndev = min(len(jax.devices()), B)
    while B % ndev:
        ndev -= 1
    solver = BatchSolver(None, qs, A, bs, cones, n_devices=ndev)

    t0 = time.perf_counter()
    sols = solver.solve()                      # compiles once
    compile_and_first = time.perf_counter() - t0

    t0 = time.perf_counter()
    solver.update_data(q=qs * 1.01)            # new scenario set
    sols = solver.solve()
    warm_batch = time.perf_counter() - t0

    n_solved = sum(s.status == cc.SolverStatus.SOLVED for s in sols)
    iters = [s.iterations for s in sols]
    print(f"devices: {ndev}; solved {n_solved}/{B}; "
          f"iters mean {np.mean(iters):.1f} max {max(iters)}")
    print(f"first call (incl. compile): {compile_and_first:.1f}s; "
          f"re-solve batch: {warm_batch*1e3:.0f} ms "
          f"({B/warm_batch:.0f} problems/s)")


if __name__ == "__main__":
    main()
