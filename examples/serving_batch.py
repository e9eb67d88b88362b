"""Serving-style batched solving: wide scenario batches with auto
chunking, warm re-solves, and the latency path for lone solves.

Run:   python examples/serving_batch.py  (default JAX backend: the
GPU when there is one).  With host_solve="on", lone solves run on the
in-process CPU backend instead of paying the accelerator's
per-dispatch latency for one 80-dim problem.

Demonstrates:
  * BatchSolver over B scenarios of one portfolio structure
    (batch_chunk_size auto splits B > 4096 into chunk-wide programs
    and bounds live memory by the chunk width);
  * update_data + warm_start re-solves for drifted data (the compiled
    program is reused; warm starts cut iterations ~3x at 1% drift);
  * a lone Solver solve for the latency-critical path.
"""
import time

import numpy as np

import cuclarabel_tpu as cc
from cuclarabel_tpu.parallel import BatchSolver


def portfolio(nass=32, B=512, seed=0):
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
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(nass + 1),
             cc.SecondOrderConeT(nfac + 1)]
    return A, qs, bs, cones


def main():
    B = 512
    A, qs, bs, cones = portfolio(B=B)

    # --- batch of scenarios (chunking engages automatically past 4096)
    solver = BatchSolver(None, qs, A, bs, cones)
    t0 = time.perf_counter()
    sols = solver.solve()
    dt = time.perf_counter() - t0
    n_ok = sum(1 for s in sols if s.status == cc.SolverStatus.SOLVED)
    print(f"batch: {n_ok}/{B} SOLVED, first solve (incl. compile) "
          f"{dt:.1f}s")

    # --- drifted re-solve, warm-started from the previous solutions
    qs2 = qs * (1.0 + 0.01 * np.random.default_rng(1).standard_normal(
        qs.shape))
    solver.update_data(q=qs2)
    ws = (np.stack([s.x for s in sols]), np.stack([s.s for s in sols]),
          np.stack([s.z for s in sols]))
    t0 = time.perf_counter()
    sols2 = solver.solve(warm_start=ws)
    dt2 = time.perf_counter() - t0
    it_cold = np.mean([s.iterations for s in sols])
    it_warm = np.mean([s.iterations for s in sols2])
    print(f"warm re-solve: {dt2*1e3:.0f} ms, mean iterations "
          f"{it_cold:.1f} -> {it_warm:.1f}")

    # --- the latency path: one problem
    one = cc.Solver(None, qs[0], A, bs[0], cones, presolve_enable=False)
    sol = one.solve()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        one.solve()
        ts.append(time.perf_counter() - t0)
    info = one.get_info()["linear_solver"]
    print(f"lone solve: {np.median(ts)*1e3:.1f} ms warm "
          f"(host_solve={info['host_solve']}, method={info['method']}), "
          f"status {sol.status.name}")


if __name__ == "__main__":
    main()
