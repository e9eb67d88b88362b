"""Benchmark: batched portfolio-SOCP solve throughput on one GPU.

The portfolio SOCP (nass=32 assets, N_kkt=76) in same-structure
scenario batches, every problem solved to the default 1e-8 tolerance:

  * headline: B=256 as one vmapped program, pipelined (5 dispatches
    enqueued, one fence), median of 3 rounds; `vs_baseline` is its
    throughput over that of the same problems solved one at a time
    through the same program (also pipelined), interleaved in this
    process;
  * b4096: B=4096 through `BatchSolver` (auto compaction), warm,
    median of 3;
  * single_solve_ms: one lone solve with a fence, warm, median.

The KKT method is the default (`auto`, pivoted LU).  Roofline shares
are "not measured" until a peak table keyed by device kind sits beside
this benchmark.  A first device that is not a GPU is an error.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "problems/s", "vs_baseline": N, ...}
"""

import json
import sys
import time

import numpy as np

NASS = 32
BATCH = 256
B_WIDE = 4096


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: first device is {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 2
    import jax.numpy as jnp

    from __graft_entry__ import _portfolio_socp
    from cuclarabel_tpu.cones.api import cones_collapsed
    from cuclarabel_tpu.cones.layout import build_layout
    from cuclarabel_tpu.device import gpu_name_and_power
    from cuclarabel_tpu.infinity import get_infinity
    from cuclarabel_tpu.kkt.dense import resolve_kkt_method
    from cuclarabel_tpu.ipm.loop import make_solve_fn
    from cuclarabel_tpu.parallel.batch import BatchSolver, device_equilibrate
    from cuclarabel_tpu.settings import Settings
    from cuclarabel_tpu.statuscodes import SolverStatus

    A, qs, bs, cones = _portfolio_socp(nass=NASS, batch=BATCH, seed=7)
    n, m = qs.shape[1], bs.shape[1]
    layout = build_layout(tuple(cones_collapsed(cones)))
    settings = Settings()
    base = make_solve_fn(layout, settings, n, m, False, jnp.float64,
                         raw=True)

    def solve_one(P, A_, q, b):
        b = jnp.minimum(b, get_infinity())
        return base(device_equilibrate(P, A_, q, b, layout, settings,
                                       has_P=False))

    Pz = jnp.zeros((n, n))
    Ad, qd, bd = jnp.asarray(A), jnp.asarray(qs), jnp.asarray(bs)
    batched = jax.jit(jax.vmap(solve_one, in_axes=(None, None, 0, 0)))
    single = jax.jit(solve_one)

    t0 = time.perf_counter()
    out = jax.block_until_ready(batched(Pz, Ad, qd, bd))
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(single(Pz, Ad, qd[0], bd[0]))
    statuses = np.asarray(out["status"])
    iters = np.asarray(out["iterations"])
    solved = int((statuses == int(SolverStatus.SOLVED)).sum())

    # interleaved, pipelined: enqueue every dispatch, fence once
    reps, seq_block = 5, 8
    pipe_b, pipe_s, single_ms = [], [], []
    for r in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready([
            batched(Pz, Ad, qd * (1.0 + 1e-9 * (r * reps + k + 1)), bd)
            for k in range(reps)])
        pipe_b.append((time.perf_counter() - t0) / reps)
        t0 = time.perf_counter()
        jax.block_until_ready([
            single(Pz, Ad, qd[k], bd[k]) for k in range(seq_block)])
        pipe_s.append((time.perf_counter() - t0) / seq_block)
        for k in range(seq_block):
            t0 = time.perf_counter()
            jax.block_until_ready(single(Pz, Ad, qd[k], bd[k]))
            single_ms.append((time.perf_counter() - t0) * 1e3)
    throughput = BATCH / float(np.median(pipe_b))
    seq_throughput = 1.0 / float(np.median(pipe_s))

    A2, qs2, bs2, cones2 = _portfolio_socp(nass=NASS, batch=B_WIDE, seed=11)
    wide = BatchSolver(None, qs2, A2, bs2, cones2)
    t0 = time.perf_counter()
    wide.solve()
    wide_compile_s = time.perf_counter() - t0
    rep2 = []
    for r in range(3):
        wide.update_data(q=qs2 * (1.0 + 1e-9 * (r + 1)))
        t0 = time.perf_counter()
        sols2 = wide.solve()
        rep2.append(time.perf_counter() - t0)
    it2 = [s.iterations for s in sols2]

    print(json.dumps({
        "metric": f"portfolio SOCP batch={BATCH} nass={NASS} pipelined "
                  "solve throughput",
        "value": round(throughput, 3),
        "unit": "problems/s",
        "vs_baseline": round(throughput / seq_throughput, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "gpu": gpu_name_and_power(),
        "kkt_method": resolve_kkt_method(settings),
        "iters_mean": round(float(iters.mean()), 3),
        "solved": f"{solved}/{BATCH}",
        "compile_s": round(compile_s, 2),
        "seq_problems_per_s": round(seq_throughput, 2),
        "single_solve_ms": round(float(np.median(single_ms)), 3),
        "rep_throughputs": [round(BATCH / s, 1) for s in pipe_b],
        "b4096": {
            "value": round(B_WIDE / float(np.median(rep2)), 1),
            "iters_mean": round(float(np.mean(it2)), 3),
            "not_solved": sum(s.status.name != "SOLVED" for s in sols2),
            "compaction": getattr(wide, "last_compaction", None),
            "compile_s": round(wide_compile_s, 2),
        },
        "roofline_pct": "not measured",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
