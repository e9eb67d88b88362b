"""Host-side Solver driver: setup (symbolic/host phase) + solve (device).

API parity with the reference native interface (`src/solver.jl:75-380`):

    solver = Solver(P, q, A, b, cones, settings=..., **overrides)
    sol    = solver.solve()

Two-phase architecture mirroring jit: everything through problem
ingestion (cone collapsing, presolve, Ruiz equilibration, cone layout,
jit-function construction) is host-side setup; `solve()` launches one
fused device program (the jitted `lax.while_loop` IPM of ipm/loop.py).
"""

import dataclasses
import functools
import time
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import presolve as presolve_mod
from .cones import api
from .cones.api import SupportedCone, cones_collapsed
from .cones.layout import build_layout
from .device import accelerator
from .equilibration import ruiz_equilibrate
from .infinity import get_infinity
from .ipm.loop import make_solve_fn
from .settings import Settings
from .statuscodes import SolverStatus, status_is_infeasible, status_to_string


@dataclasses.dataclass
class DefaultSolution:
    """User-facing results (types.jl:279-311)."""

    x: np.ndarray
    z: np.ndarray
    s: np.ndarray
    status: SolverStatus
    obj_val: float
    obj_val_dual: float
    solve_time: float
    iterations: int
    r_prim: float
    r_dual: float

    def __repr__(self):
        return (
            f">>> cuclarabel_tpu - Results\n"
            f"Status: {status_to_string(self.status)}\n"
            f"Iterations: {self.iterations}\n"
            f"Objective: {self.obj_val:#.4g}\n"
            f"Solve time: {self.solve_time:.3e}s"
        )


def _to_dense(M, shape) -> np.ndarray:
    """Accept scipy.sparse or array-like, return dense f64 ndarray.

    Densification of large sparse inputs is an O(rows*cols) memory
    cliff; refuse past ~1 GB and point at SparseSolver instead of
    silently allocating tens of GB."""
    if M is None:
        return np.zeros(shape, dtype=np.float64)
    if hasattr(M, "toarray"):
        cells = int(shape[0]) * int(shape[1])
        if cells * 8 > 1 << 30:
            raise ValueError(
                f"refusing to densify a sparse {shape} matrix "
                f"({cells * 8 / 1e9:.1f} GB dense); use "
                "cuclarabel_tpu.SparseSolver for large sparse problems"
            )
        out = np.asarray(M.toarray(), dtype=np.float64)
    else:
        out = np.asarray(M, dtype=np.float64)
    if out.shape != shape:
        raise ValueError(f"expected shape {shape}, got {out.shape}")
    return out


@functools.lru_cache(maxsize=128)
def _cached_solve_fn(layout, settings, n, m, has_P, factor_dtype_name,
                     warm=False):
    factor_dtype = jnp.float32 if factor_dtype_name == "float32" else jnp.float64
    # single-problem path: verbose solves stream a live status line per
    # iteration (the batch paths build their own fns without streaming)
    return make_solve_fn(layout, settings, n, m, has_P, factor_dtype,
                         warm=warm, stream=settings.verbose)


def _host_solve_device(settings):
    """Resolve the settings.host_solve policy: the CPU jax device the
    single-problem program should run on, or None for the process
    default.  Only "on" routes, and only when the default backend is
    an accelerator; "auto" routes nothing until a measurement of lone
    solves on the accelerator says it should."""
    if settings.host_solve != "on" or accelerator() is None:
        return None
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:  # CPU platform not exposed in this process
        return None


def _put_on(device, x):
    if device is not None:
        # device_put straight from host memory: jnp.asarray first
        # would commit the array to the default device and copy it back
        return jax.device_put(np.asarray(x), device)
    return jnp.asarray(x)


def _resolve_factor_dtype(settings, layout=None) -> str:
    if settings.kkt_factor_precision == "auto":
        # accuracy parity with the reference by default: f64 factors.
        # f32 factors + f64 iterative refinement reach the full 1e-8
        # tolerance on most problems but can end at ALMOST_SOLVED when
        # cond(K) crosses ~1e7 near convergence — opt in with
        # kkt_factor_precision="float32".
        return "float64"
    return settings.kkt_factor_precision


class Solver:
    """min (1/2)x'Px + q'x  s.t.  Ax + s = b, s in K."""

    def __init__(
        self,
        P,
        q,
        A,
        b,
        cones: Sequence[SupportedCone],
        settings: Optional[Settings] = None,
        **kwargs,
    ):
        if settings is None:
            settings = Settings()
        if kwargs:
            settings = settings.replace(**kwargs)
        settings.validate()
        self.settings = settings
        self.setup(P, q, A, b, cones)

    # ------------------------------------------------------------------
    def _put(self, x):
        """Array placement honoring the host_solve routing decision."""
        return _put_on(getattr(self, "_solve_device", None), x)

    def setup(self, P, q, A, b, cones: Sequence[SupportedCone]):
        q = np.asarray(q, dtype=np.float64).ravel()
        b = np.asarray(b, dtype=np.float64).ravel()
        n = q.shape[0]
        m = b.shape[0]

        # dimension checks (solver.jl:157-169)
        cones = list(cones)
        p = sum(api.nvars(c) for c in cones)
        A_shape = A.shape if A is not None else (m, n)
        if A_shape[0] != m:
            raise ValueError("A and b have incompatible dimensions")
        if p != m:
            raise ValueError("constraint dimensions inconsistent with cones")
        if A_shape[1] != n:
            raise ValueError("A and q have incompatible dimensions")

        Pd = _to_dense(P, (n, n))
        Ad = _to_dense(A, (m, n))

        # only the upper triangle of P is used; symmetrize
        # (problemdata.jl:23-26 enforces triu, Symmetric views elsewhere)
        Pd = np.triu(Pd) + np.triu(Pd, 1).T
        self._has_P = bool(np.any(Pd != 0.0))

        # cone collapsing (cone_api.jl:96-153)
        cones = cones_collapsed(cones)

        # presolve (presolver.jl)
        self.timers = {"setup": {}, "solve": {}}
        t_ps = time.perf_counter()
        infbound = get_infinity()
        self.presolver = presolve_mod.try_presolve(cones, b, self.settings, infbound)
        if self.presolver is not None:
            Ad, b, cones = presolve_mod.apply_presolve(self.presolver, Ad, b, cones)
            m = b.shape[0]
        self.timers["setup"]["presolve"] = time.perf_counter() - t_ps

        # chordal decomposition of PSD cones (problemdata.jl:40-45)
        self.chordal_info = None
        if self.settings.chordal_decomposition_enable and any(
            isinstance(c, api.PSDTriangleConeT) for c in cones
        ):
            from .chordal import ChordalInfo, decomp_augment

            t_ch = time.perf_counter()
            info = ChordalInfo(Ad, b, cones, self.settings)
            if info.is_decomposed():
                Pd, q, Ad, b, cones = decomp_augment(
                    info, Pd, q, Ad, b, self.settings
                )
                n = q.shape[0]
                m = b.shape[0]
                self.chordal_info = info
            self.timers["setup"]["chordal"] = time.perf_counter() - t_ch

        # cap b at INFINITY (problemdata.jl:58-62)
        b = np.minimum(b, infbound)

        self.layout = build_layout(tuple(cones))
        if self.layout.m != m:
            raise ValueError("cone dimensions inconsistent after presolve")

        # unscaled norms for relative termination criteria
        # (problemdata.jl:80-81, info.jl:14-16)
        normq = float(np.abs(q).max()) if n > 0 else 0.0
        normb = float(np.abs(b).max()) if m > 0 else 0.0

        # Ruiz equilibration, once at setup (solver.jl:131-136)
        t_eq = time.perf_counter()
        Pd, Ad, qs, bs, d, e, c = ruiz_equilibrate(
            Pd, Ad, q, b, self.layout, self.settings
        )
        self.timers["setup"]["equilibration"] = time.perf_counter() - t_eq

        self.n, self.m = n, m
        # scaled host copies kept for update_data!/save_to_file
        self._cones = list(cones)
        self._Ps, self._As = Pd, Ad
        self._qs, self._bs = qs, bs
        self._d, self._e, self._c = d, e, c
        # host_solve routing: committed-CPU inputs make the jitted
        # program compile and execute on the host backend
        self._solve_device = _host_solve_device(self.settings)
        self._dev = {
            "P": self._put(Pd),
            "q": self._put(qs),
            "A": self._put(Ad),
            "b": self._put(bs),
            "d": self._put(d),
            "dinv": self._put(1.0 / d),
            "e": self._put(e),
            "einv": self._put(1.0 / e),
            "cscale": self._put(c),
            "normq": self._put(normq),
            "normb": self._put(normb),
        }

        factor_dtype_name = _resolve_factor_dtype(self.settings, self.layout)
        self._solve_fn = _cached_solve_fn(
            self.layout, self.settings, n, m, self._has_P,
            factor_dtype_name
        )
        self.solution: Optional[DefaultSolution] = None
        self.info: Optional[dict] = None
        return self

    # ------------------------------------------------------------------
    def solve(self, profile_dir: Optional[str] = None,
              warm_start=None) -> DefaultSolution:
        """Run the IPM.  With profile_dir set, wraps the device program
        in a jax.profiler trace (viewable in TensorBoard/XProf) — the
        device-side counterpart of the reference's hierarchical timers
        (TimerOutputs, src/types.jl:362-372) for on-device detail.

        warm_start=(x, s, z) seeds the iterates (original problem
        space, e.g. a previous DefaultSolution's fields after an
        update_data) instead of the cold start — a capability the
        reference does not offer (its iterates always restart,
        data_updating.jl).  The iterates are scaled into the
        equilibrated space and pushed to the cone interior; only exact
        cone membership of shapes is required, not feasibility.
        Supported for symmetric-cone problems (zero/NN/SOC/PSD) without
        presolve reductions or chordal decomposition."""
        if warm_start is not None:
            from .warmstart import scale_warm_start, validate_warm_start

            self._check_update_allowed()  # same presolve/chordal guards
            wx, ws, wz = validate_warm_start(
                self.layout, warm_start, self.n, self.m
            )
            wsx, wss, wsz = scale_warm_start(
                wx, ws, wz,
                np.asarray(self._dev["d"]), np.asarray(self._dev["e"]),
                float(np.asarray(self._dev["cscale"])),
            )
            self._dev["ws_x"] = self._put(wsx)
            self._dev["ws_s"] = self._put(wss)
            self._dev["ws_z"] = self._put(wsz)
            solve_fn = _cached_solve_fn(
                self.layout, self.settings, self.n, self.m, self._has_P,
                _resolve_factor_dtype(self.settings, self.layout),
                warm=True,
            )
        else:
            for k in ("ws_x", "ws_s", "ws_z"):
                self._dev.pop(k, None)  # keep the cold fn's pytree stable
            solve_fn = self._solve_fn
        if self.settings.verbose:
            from . import info_print

            info_print.print_banner(self.settings)
            info_print.print_configuration(
                self.settings, self.n, self.m, self._cones, self._has_P,
                self.settings.direct_solve_method,
            )
            info_print.print_iteration_header()
        import contextlib

        trace_ctx = (
            jax.profiler.trace(profile_dir)
            if profile_dir is not None
            else contextlib.nullcontext()
        )
        import math

        if math.isfinite(self.settings.time_limit):
            # host-clock origin for the in-loop MAX_TIME check
            # (settings.jl:73, info.jl:110-115); includes trace/compile
            # time of this dispatch, matching the reference's
            # wall-clock-of-solve! semantics
            self._dev["t_start"] = self._put(time.time())
        t0 = time.perf_counter()
        with trace_ctx:
            out = solve_fn(self._dev)
            jax.block_until_ready(out)
        out = jax.tree_util.tree_map(np.asarray, jax.device_get(out))
        solve_time = time.perf_counter() - t0

        self.timers["solve"]["solve"] = solve_time
        status = SolverStatus(int(out["status"]))
        x = np.asarray(out["x"])
        s = np.asarray(out["s"])
        z = np.asarray(out["z"])

        # reverse chordal decomposition (solution.jl:30-34), then
        # reverse presolve (solution.jl:36-42)
        if self.chordal_info is not None:
            from .chordal import decomp_reverse

            x, s, z = decomp_reverse(self.chordal_info, x, s, z, self.settings)
        if self.presolver is not None:
            s, z = presolve_mod.reverse_presolve(self.presolver, s, z)

        self.info = {k: out[k] for k in out}
        self.info["solve_time"] = solve_time
        # linear-solver block of the reference's DefaultInfo
        # (types.jl:209-251: name / threads / nnzA / nnzL analog)
        from .kkt.dense import resolve_kkt_method

        N = self.n + self.m
        method = resolve_kkt_method(self.settings)
        self.info["linear_solver"] = {
            "method": method,
            "factor_precision": _resolve_factor_dtype(
                self.settings, self.layout
            ),
            "kkt_dim": N,
            "nnzA": int(np.count_nonzero(self._As)),
            # every dense method holds a full N x N factor: packed L and
            # U ("lu"), the explicit K^{-1} ("inverse"), or Q ("qr")
            "nnzL": N * N,
            # True when the host_solve policy routed this single solve
            # to the in-process CPU backend (see Settings.host_solve)
            "host_solve": self._solve_device is not None,
        }
        self.solution = DefaultSolution(
            x=x,
            z=z,
            s=s,
            status=status,
            obj_val=float(out["obj_val"]),
            obj_val_dual=float(out["obj_val_dual"]),
            solve_time=solve_time,
            iterations=int(out["iterations"]),
            r_prim=float(out["r_prim"]),
            r_dual=float(out["r_dual"]),
        )
        if self.settings.verbose:
            from . import info_print

            # iteration lines already streamed live (stream=verbose in
            # _cached_solve_fn); just close the table
            info_print.print_footer(self.solution)
        return self.solution

    # ------------------------------------------------------------------
    def get_solution(self) -> Optional[DefaultSolution]:
        return self.solution

    def get_info(self) -> Optional[dict]:
        return self.info

    def profile_phases(self, reps: int = 3) -> dict:
        """Per-phase device timing of this problem's IPM building blocks
        (scale cones / Hs assembly / KKT factor / refined KKT solve /
        residual matvecs / step length) — the device-level counterpart
        of the reference's solve! timer sections (types.jl:362-372,
        solver.jl:189-370).  Results land in timers["device"] and are
        included by print_timers()."""
        from .profiling import phase_breakdown

        return phase_breakdown(self, reps=reps)

    def print_timers(self) -> None:
        """Hierarchical wall-clock report (print_timers(solver),
        solver.jl:534; TimerOutputs equivalent).  Includes the
        per-phase device breakdown if profile_phases() was run."""
        for section, entries in self.timers.items():
            total = sum(entries.values())
            print(f"{section:<16s} {total*1e3:10.3f} ms")
            for name, t in entries.items():
                print(f"  {name:<14s} {t*1e3:10.3f} ms")

    # -- parametric data updating (src/data_updating.jl) ----------------
    def _check_update_allowed(self):
        """Updates are forbidden once presolve has reduced rows
        (check_data_update_allowed, data_updating.jl:149-158)."""
        if self.presolver is not None:
            raise ValueError("Data updates not allowed if presolver is active.")
        if getattr(self, "chordal_info", None) is not None:
            raise ValueError(
                "Data updates not allowed if chordal decomposition is active."
            )

    def is_data_update_allowed(self) -> bool:
        try:
            self._check_update_allowed()
            return True
        except ValueError:
            return False

    @staticmethod
    def _as_update(values, target_shape, what):
        """Accept a full dense/sparse matrix, a flat row-major value
        vector, or an (indices, values) pair over flat row-major
        positions (the dense analog of the reference's nzval /
        SparseMatrixCSC / zip input forms, data_updating.jl:1-14)."""
        if isinstance(values, tuple) and len(values) == 2:
            return ("indexed", np.asarray(values[0], dtype=np.int64),
                    np.asarray(values[1], dtype=np.float64))
        if hasattr(values, "toarray"):
            values = values.toarray()
        arr = np.asarray(values, dtype=np.float64)
        if arr.ndim == 1 and len(target_shape) == 2:
            if arr.size == 0:
                return None
            if arr.size != target_shape[0] * target_shape[1]:
                raise ValueError(f"{what}: flat values must have length "
                                 f"{target_shape[0] * target_shape[1]}")
            arr = arr.reshape(target_shape)
        if arr.shape != target_shape:
            raise ValueError(f"{what}: expected shape {target_shape}")
        return ("full", arr, None)

    def update_P(self, P) -> None:
        """Overwrite P, re-applying the stored equilibration
        (update_P!, data_updating.jl:56-71): P_int = c * D P D."""
        if P is None:
            return
        self._check_update_allowed()
        upd = self._as_update(P, (self.n, self.n), "P")
        if upd is None:
            return
        kind, a1, a2 = upd
        d, c = self._d, self._c
        if kind == "full":
            Pd = np.triu(a1) + np.triu(a1, 1).T
            self._Ps = c * (d[:, None] * Pd * d[None, :])
        else:
            rows, cols = np.divmod(a1, self.n)
            vals = c * d[rows] * d[cols] * a2
            P_full = np.asarray(self._Ps).copy()
            P_full[rows, cols] = vals
            P_full[cols, rows] = vals
            self._Ps = P_full
        self._has_P = bool(np.any(self._Ps != 0.0))
        self._dev["P"] = self._put(self._Ps)
        self._refresh_solve_fn()

    def update_A(self, A) -> None:
        """A_int = E A D (update_A!, data_updating.jl:85-100)."""
        if A is None:
            return
        self._check_update_allowed()
        upd = self._as_update(A, (self.m, self.n), "A")
        if upd is None:
            return
        kind, a1, a2 = upd
        d, e = self._d, self._e
        if kind == "full":
            self._As = e[:, None] * a1 * d[None, :]
        else:
            rows, cols = np.divmod(a1, self.n)
            A_full = np.asarray(self._As).copy()
            A_full[rows, cols] = e[rows] * d[cols] * a2
            self._As = A_full
        self._dev["A"] = self._put(self._As)

    def update_q(self, q) -> None:
        """q_int = c * D q; refreshes the unscaled norm used by the
        relative termination criteria (update_q!,
        data_updating.jl:107-124)."""
        if q is None:
            return
        self._check_update_allowed()
        q = np.asarray(q, dtype=np.float64).ravel()
        if q.size == 0:
            return
        if q.shape[0] != self.n:
            raise ValueError("q: wrong length")
        self._qs = self._c * self._d * q
        self._dev["q"] = self._put(self._qs)
        self._dev["normq"] = self._put(
            float(np.abs(q).max()) if self.n else 0.0
        )

    def update_b(self, b) -> None:
        """b_int = E b (update_b!, data_updating.jl:133-147)."""
        if b is None:
            return
        self._check_update_allowed()
        b = np.asarray(b, dtype=np.float64).ravel()
        if b.size == 0:
            return
        if b.shape[0] != self.m:
            raise ValueError("b: wrong length")
        b = np.minimum(b, get_infinity())
        self._bs = self._e * b
        self._dev["b"] = self._put(self._bs)
        self._dev["normb"] = self._put(
            float(np.abs(b).max()) if self.m else 0.0
        )

    def update_data(self, P=None, q=None, A=None, b=None) -> None:
        """update_data! (data_updating.jl:26-39)."""
        self.update_P(P)
        self.update_q(q)
        self.update_A(A)
        self.update_b(b)

    def _refresh_solve_fn(self):
        factor_dtype_name = _resolve_factor_dtype(self.settings, self.layout)
        self._solve_fn = _cached_solve_fn(
            self.layout, self.settings, self.n, self.m, self._has_P,
            factor_dtype_name,
        )

    # -- JSON I/O (src/json.jl) ------------------------------------------
    def save_to_file(self, path: str) -> None:
        """Write the (unscaled) internal problem data as JSON
        (save_to_file, json.jl:25-56)."""
        from . import json_io

        dinv = 1.0 / self._d
        einv = 1.0 / self._e
        cinv = 1.0 / self._c
        P = cinv * (dinv[:, None] * np.asarray(self._Ps) * dinv[None, :])
        q = cinv * dinv * np.asarray(self._qs)
        A = einv[:, None] * np.asarray(self._As) * dinv[None, :]
        b = einv * np.asarray(self._bs)
        json_io.save_problem(self.settings, P, q, A, b, self._cones, path)

    @classmethod
    def load_from_file(cls, path: str, settings: Optional[Settings] = None):
        """Create a Solver from a JSON problem file (load_from_file,
        json.jl:58-87)."""
        from . import json_io

        P, q, A, b, cones, s = json_io.load_problem(path, settings)
        return cls(P, q, A, b, cones, settings=s)
