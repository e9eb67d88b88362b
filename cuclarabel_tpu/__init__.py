"""cuclarabel_tpu — an interior-point conic solver in JAX.

A JAX/XLA implementation of a primal-dual interior-point method for
conic programs of the form

    minimize    (1/2) x'Px + q'x
    subject to  Ax + s = b,  s in K

where K is a Cartesian product of zero, nonnegative, second-order,
PSD-triangle, exponential, power and generalized power cones.

Capability target: Clarabel.jl v0.11.0 (the upstream of CuClarabel),
designed for an accelerator:
  * all numeric state lives in flat device arrays (no cone object tree);
  * cone operations are grouped, vectorized kernels per cone *type*
    (segment-reductions for heterogeneous sizes, batched linalg for PSD);
  * the entire IPM iteration runs as a single jitted `lax.while_loop`;
  * KKT systems are factorized with batched dense linear algebra (or a
    level-scheduled multifrontal for large sparse problems), with
    iterative refinement against the f64 operator;
  * batches of problems solve in parallel via `vmap` and shard over a
    `jax.sharding.Mesh`.

Reference behavior citations throughout point at the Clarabel.jl tree
(e.g. `src/solver.jl:189-380`) for parity checking; the implementation
here is an independent design, not a translation.
"""

import os as _os

import jax as _jax

# The IPM requires ~1e-8 duality-gap accuracy; f64 iterates are mandatory.
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  JAX_COMPILATION_CACHE_DIR, when set, is
# the only cache directory (JAX reads it itself; set it to "" to turn
# the cache off).  Unset, the cache lives at one fixed path per host
# inside the checkout, <repo>/.jax_cache/<host fingerprint>, so that a
# moved or copied checkout never reads another path's entries.
#
# The fingerprint is there because XLA:CPU caches AOT-compiled machine
# code for the *compiling* host's CPU features, and loading another
# host's CPU executable can crash (SIGILL/SIGSEGV).  Every process may
# compile XLA:CPU programs (host_solve="on", CPU-device references), so
# the subdirectory applies whatever the default backend is.


def _host_fingerprint():
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            flags = [ln for ln in f if ln.startswith(("flags", "model name"))]
        key = "".join(sorted(set(flags))) or "unknown"
    except OSError:
        import platform

        key = platform.processor() or "unknown"
    return hashlib.sha256(key.encode()).hexdigest()[:12]


_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)

if (
    _jax.config.jax_compilation_cache_dir is None
    and "JAX_COMPILATION_CACHE_DIR" not in _os.environ
):
    _cache = _os.path.join(_CACHE_DIR, "host-" + _host_fingerprint())
    try:
        _os.makedirs(_cache, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", _cache)
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except OSError:
        pass

from .settings import Settings
from .statuscodes import SolverStatus
from .cones.api import (
    ZeroConeT,
    NonnegativeConeT,
    SecondOrderConeT,
    ExponentialConeT,
    PowerConeT,
    GenPowerConeT,
    PSDTriangleConeT,
    SupportedCone,
)
from .solver import Solver, DefaultSolution
from .infinity import get_infinity, set_infinity, default_infinity
from .sparse_solver import SparseSolver
from .modeling import (
    Model,
    Variable,
    vstack,
    sum_entries,
    norm2,
    quad_form,
    sumsq,
)
from .precompile import precompile

__version__ = "0.1.0"


def solver_name() -> str:
    """Solver name string (reference: src/version.jl solver_name())."""
    return "cuclarabel_tpu"


def version() -> str:
    """Package version string (reference: src/version.jl version())."""
    return __version__

__all__ = [
    "Solver",
    "DefaultSolution",
    "Settings",
    "SolverStatus",
    "SupportedCone",
    "ZeroConeT",
    "NonnegativeConeT",
    "SecondOrderConeT",
    "ExponentialConeT",
    "PowerConeT",
    "GenPowerConeT",
    "PSDTriangleConeT",
    "get_infinity",
    "set_infinity",
    "default_infinity",
    "SparseSolver",
    "Model",
    "Variable",
    "vstack",
    "sum_entries",
    "norm2",
    "quad_form",
    "sumsq",
]
