"""Continuous-load solving: pipeline batched dispatches, fence once.

A serving process that round-trips to the accelerator between
independent solves pays the full dispatch+completion latency per batch.
JAX dispatch is asynchronous: enqueue every pending batch, then
synchronize once — the device executes back-to-back and throughput
approaches the device-busy bound.

Run: python examples/pipelined_serving.py  (runs on the default JAX
backend: the GPU when there is one)
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _portfolio_socp  # noqa: E402
from cuclarabel_tpu.cones.api import cones_collapsed  # noqa: E402
from cuclarabel_tpu.cones.layout import build_layout  # noqa: E402
from cuclarabel_tpu.infinity import get_infinity  # noqa: E402
from cuclarabel_tpu.ipm.loop import make_solve_fn  # noqa: E402
from cuclarabel_tpu.parallel.batch import device_equilibrate  # noqa: E402
from cuclarabel_tpu.settings import Settings  # noqa: E402

jax.config.update("jax_enable_x64", True)

B = 64
A, qs, bs, cones = _portfolio_socp(nass=16, batch=B, seed=3)
n, m = qs.shape[1], bs.shape[1]
layout = build_layout(tuple(cones_collapsed(cones)))
settings = Settings()
base = make_solve_fn(layout, settings, n, m, False, jnp.float64, raw=True)


def solve_one(P, A_, q, b):
    b = jnp.minimum(b, get_infinity())
    return base(device_equilibrate(P, A_, q, b, layout, settings,
                                   has_P=False))


batched = jax.jit(jax.vmap(solve_one, in_axes=(None, None, 0, 0)))
Pz = jnp.zeros((n, n))
Ad = jnp.asarray(A)
qd = jnp.asarray(qs)
bd = jnp.asarray(bs)

# compile + warm
jax.block_until_ready(batched(Pz, Ad, qd, bd))

ROUNDS = 6

# fence-per-batch (what a naive serving loop does)
t0 = time.perf_counter()
for r in range(ROUNDS):
    out = batched(Pz, Ad, qd * (1.0 + 1e-9 * (r + 1)), bd)
    jax.block_until_ready(out)
sync_s = (time.perf_counter() - t0) / ROUNDS

# pipelined: enqueue every pending batch, fence once
t0 = time.perf_counter()
outs = [
    batched(Pz, Ad, qd * (1.0 + 1e-9 * (ROUNDS + r + 1)), bd)
    for r in range(ROUNDS)
]
jax.block_until_ready(outs)
pipe_s = (time.perf_counter() - t0) / ROUNDS

statuses = np.asarray(outs[-1]["status"])
print(f"all solved: {bool((statuses == 1).all())}")
print(f"fence-per-batch: {B / sync_s:8.1f} problems/s")
print(f"pipelined:       {B / pipe_s:8.1f} problems/s "
      f"({sync_s / pipe_s:.2f}x)")
