"""Per-phase device timing of the IPM at a solver's exact shapes.

The reference reports hierarchical timer sections inside solve! —
"scale cones", "kkt update", "kkt solve" (TimerOutputs sections created
in src/types.jl:362-372 and annotated through src/solver.jl:189-370).
This solver fuses the whole iteration into one device program, so an
equivalent breakdown cannot be carved out of the production dispatch;
instead each phase is re-jitted standalone at matching shapes and timed
on device, using cone-interior iterates so the kernels see realistic
control flow.  Each standalone dispatch carries the runtime's fixed
per-launch overhead, which the fused production program pays once per
solve, so phase times are upper bounds.
"""

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .cones import ops as cone_ops
from .kkt.dense import make_dense_kkt


def _timeit(fn, *args, reps):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def phase_breakdown(solver, reps: int = 3) -> Dict[str, float]:
    """Time each IPM phase of `solver`'s compiled problem on device.

    Returns {phase: seconds}; also stored on solver.timers["device"]
    so print_timers() reports it.  Phases mirror the reference's timer
    sections: scale_cones (update_scaling + Hs assembly), kkt_factor
    (numeric refactorization), kkt_solve (one refined solve; plus the
    paired constant+affine solve where the backend fuses them),
    residuals (rx/rz matvecs), step_length (one cone search)."""
    layout, st = solver.layout, solver.settings
    n, m = solver.n, solver.m
    dev = solver._dev
    P, A = dev["P"], dev["A"]

    from .solver import _resolve_factor_dtype

    factor_dtype = (
        jnp.float32
        if _resolve_factor_dtype(st, layout) == "float32"
        else jnp.float64
    )
    factorize, kkt_solve = make_dense_kkt(n, m, st, factor_dtype, layout)

    # cone-interior iterates at this problem's layout (values only set
    # scale, not shape; unit init is interior for every cone family)
    z0, s0 = cone_ops.unit_initialization(layout)
    mu = jnp.asarray(1.0)
    res: Dict[str, float] = {}

    # device operands (P, A, iterates) are passed as jit ARGUMENTS,
    # never closed over, so they are not embedded as program constants
    with jax.default_matmul_precision("highest"):
        scal_fn = jax.jit(
            lambda s_, z_: cone_ops.update_scaling(layout, s_, z_, mu, 0)
        )
        res["scale_cones"] = _timeit(scal_fn, s0, z0, reps=reps)
        scal, _ = scal_fn(s0, z0)

        hs_fn = jax.jit(lambda sc: cone_ops.assemble_Hs_dense(layout, sc))
        res["hs_assembly"] = _timeit(hs_fn, scal, reps=reps)
        Hs = hs_fn(scal)

        fac_fn = jax.jit(lambda P_, A_, Hs_: factorize(P_, A_, Hs_)[0])
        res["kkt_factor"] = _timeit(fac_fn, P, A, Hs, reps=reps)
        fac = fac_fn(P, A, Hs)

        rx = -dev["q"]
        rz = dev["b"]
        solve_fn = jax.jit(lambda f, a, c: kkt_solve(f, a, c)[:2])
        res["kkt_solve"] = _timeit(solve_fn, fac, rx, rz, reps=reps)

        pair = getattr(kkt_solve, "pair", None)
        if pair is not None:
            pair_fn = jax.jit(lambda f, a, c: pair(f, a, c, 2 * a, 2 * c)[:4])
            res["kkt_solve_pair"] = _timeit(pair_fn, fac, rx, rz, reps=reps)

        def resid_fn(P_, A_, x_, z_):
            return A_.T @ z_ + (P_ @ x_ if solver._has_P else 0.0), A_ @ x_

        res["residuals"] = _timeit(
            jax.jit(resid_fn), P, A, rx, rz, reps=reps
        )

        sl_fn = jax.jit(
            lambda sc, dz, ds, z_, s_: cone_ops.step_length(
                layout, sc, dz, ds, z_, s_, jnp.asarray(1.0), st
            )
        )
        res["step_length"] = _timeit(sl_fn, scal, -z0, -s0, z0, s0,
                                     reps=reps)

    solver.timers["device"] = res
    return res
