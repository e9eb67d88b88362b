"""Precompile / warm-up workloads (the reference's precompile.jl analog).

The reference solves a small problem over every cone type at package
load so first user solves hit warm code paths (`src/precompile.jl:50-57`
builds the cone list; `src/Clarabel.jl:93-102` wires it).  The JAX
analog of "precompiled method instances" is the persistent XLA
compilation cache (installed by the package `__init__`): every
(layout, settings, shapes) signature that has been traced + compiled
once on a machine loads from the cache in subsequent processes instead
of paying the multi-second (dense) to multi-minute (large sparse)
compile.

Two ways to use it:

  * `precompile()` — solves one tiny problem per cone family through
    the public `Solver` API, populating the cache with the standard
    cone-kernel program set (the reference's default workload list).
  * `precompile(signatures=[...])` — additionally warms
    production-shape programs: each signature is either a prebuilt
    solver object (anything with `.solve()`: Solver, SparseSolver,
    BatchSolver, ...) or a zero-argument callable returning one.

Shipping caches: the cache directory (JAX_COMPILATION_CACHE_DIR when
set, else `.jax_cache/host-<fingerprint>` at the root of the checkout)
is a plain directory of compiled-executable files keyed by (program
fingerprint, compiler version, platform).  It can be copied between
machines that run the same accelerator platform, jaxlib version and
host CPU; foreign entries are ignored (fingerprint miss), so shipping a
superset is safe.  NB: the cache stores COMPILED programs —
Python tracing still runs per process, so first-solve latency drops to
trace time + cache load, not to zero.
"""

import time
from typing import Callable, Iterable, Sequence, Union

import numpy as np

__all__ = ["precompile"]


def _lp():
    import cuclarabel_tpu as cc

    # min q'x  s.t.  sum x = 1, x >= 0  (basic_lp.jl class)
    n = 4
    q = np.linspace(-1.0, 1.0, n)
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n)])
    return None, q, A, b, [cc.ZeroConeT(1), cc.NonnegativeConeT(n)]


def _qp():
    import cuclarabel_tpu as cc

    # the reference QP golden problem class (basic_qp.jl:35-80)
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.ones((1, 2)), -np.eye(2), np.eye(2)])
    b = np.array([1.0, 0.0, 0.0, 1.0, 1.0])
    return P, q, A, b, [cc.ZeroConeT(1), cc.NonnegativeConeT(4)]


def _socp():
    import cuclarabel_tpu as cc

    # min x1  s.t. ||(x2, x3)|| <= x1, x1 + x2 = 1
    A = np.vstack([np.array([[1.0, 1.0, 0.0]]), -np.eye(3)])
    b = np.array([1.0, 0.0, 0.0, 0.0])
    q = np.array([1.0, 0.0, 0.1])
    return None, q, A, b, [cc.ZeroConeT(1), cc.SecondOrderConeT(3)]


def _expcone():
    import cuclarabel_tpu as cc

    # basic_exp.jl feasible fixture (tests/test_basic_exp.py)
    n = 7
    A1 = np.hstack([np.ones((1, 3)), np.zeros((1, 4))])
    A2 = np.hstack([np.zeros((3, 2)), -np.eye(3), np.zeros((3, 2))])
    A3 = np.zeros((3, n))
    A3[0, 0] = -1.0
    A3[1, 2] = -1.0
    A3[2, 4] = -1.0
    q = np.array([1.0, 0.5, -2.0, -0.1, 1.0, 3.0, 0.0])
    P = np.eye(n) * 1e-1
    A = np.vstack([A1, A2, A3])
    b = np.concatenate([[10.0], np.zeros(6)])
    return P, q, A, b, [
        cc.ZeroConeT(1), cc.NonnegativeConeT(3), cc.ExponentialConeT()
    ]


def _powcone():
    import cuclarabel_tpu as cc

    # basic_pow.jl fixture (tests/test_basic_pow.py)
    n = 6
    q = np.zeros(n)
    q[2] = q[5] = -1.0
    A1 = np.eye(6)
    A2 = np.array([[1.0, 2.0, 0.0, 3.0, 0.0, 0.0]])
    A3 = np.array([[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]])
    A = -np.vstack([A1, A2, A3])
    b = np.concatenate([np.zeros(6), [-3.0], [-1.0]])
    return None, q, A, b, [
        cc.PowerConeT(0.6), cc.PowerConeT(0.1),
        cc.ZeroConeT(1), cc.ZeroConeT(1),
    ]


def _genpow():
    import cuclarabel_tpu as cc

    # basic_genpow.jl fixture (tests/test_basic_pow.py)
    n = 6
    q = np.zeros(n)
    q[2] = q[5] = -1.0
    A = np.vstack([-np.eye(6),
                   [[1.0, 2.0, 0.0, 3.0, 0.0, 0.0]],
                   [[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]]])
    b = np.concatenate([np.zeros(6), [3.0], [1.0]])
    return None, q, A, b, [
        cc.GenPowerConeT([0.6, 0.4], 1),
        cc.GenPowerConeT([0.1, 0.9], 1),
        cc.ZeroConeT(2),
    ]


def _sdp():
    import cuclarabel_tpu as cc

    # basic_sdp.jl class: project an indefinite matrix onto the PSD cone
    P = np.eye(6)
    q = np.zeros(6)
    A = np.eye(6)
    b = np.array([-3.0, 1.0, 4.0, 1.0, 2.0, 5.0])
    return P, q, A, b, [cc.PSDTriangleConeT(3)]


_FAMILIES = {
    "lp": _lp,
    "qp": _qp,
    "socp": _socp,
    "exp": _expcone,
    "pow": _powcone,
    "genpow": _genpow,
    "sdp": _sdp,
}


def precompile(
    settings=None,
    families: Sequence[str] = tuple(_FAMILIES),
    signatures: Iterable[Union[Callable, object]] = (),
    verbose: bool = False,
) -> dict:
    """Trace + compile the standard solver programs into the persistent
    compilation cache (precompile.jl analog; the cone list mirrors
    `src/precompile.jl:50-57`).

    settings:   Settings for the family workloads (None = defaults).
                Programs are jit-keyed by Settings, so precompile with
                the same settings you will solve with.
    families:   subset of {"lp","qp","socp","exp","pow","genpow","sdp"}.
    signatures: production-shape warmers — prebuilt solver objects
                (anything with .solve()) or zero-arg callables
                returning one; each is solved once.
    Returns {name: seconds} (first-solve wall time per workload, i.e.
    the compile+solve cost this call just paid so later processes
    won't)."""
    from .solver import Solver

    out = {}
    for name in families:
        make = _FAMILIES[name]
        P, q, A, b, cones = make()
        t0 = time.perf_counter()
        s = (
            Solver(P, q, A, b, cones, settings)
            if settings is not None
            else Solver(P, q, A, b, cones)
        )
        s.solve()
        out[name] = round(time.perf_counter() - t0, 3)
        if verbose:
            print(f"precompile[{name}]: {out[name]:.2f}s", flush=True)

    for i, sig in enumerate(signatures):
        obj = sig() if callable(sig) else sig
        t0 = time.perf_counter()
        obj.solve()
        out[f"signature_{i}"] = round(time.perf_counter() - t0, 3)
        if verbose:
            print(f"precompile[signature_{i}]: {out[f'signature_{i}']:.2f}s",
                  flush=True)
    return out
