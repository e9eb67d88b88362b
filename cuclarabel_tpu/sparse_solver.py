"""SparseSolver: large sparse conic programs with the device
multifrontal KKT backend.

Same semantics as Solver (src/solver.jl:75-380 parity) for the LP/QP
cone class (Zero/Nonnegative — diagonal Hs), but the problem data stays
sparse end-to-end: host-side sparse Ruiz equilibration, nz-value device
arrays, segment-sum SpMV residuals inside the fused loop, and the
level-scheduled multifrontal factorization of kkt/sparse_device.py.
Use it when the dense path's O(N^2) memory is the binding constraint
(N = n + m beyond a few thousand).

Cones: Zero/NN (diagonal Hs), SOC (dense blocks to dim 4, rank-2
sparse expansion above), exp/pow (3x3 blocks), GenPow (rank-3
expansion), PSD (dense svec blocks — pair big cones with chordal
decomposition so blocks stay clique-sized).  Presolve and chordal
decomposition run before pattern analysis, so both compose with the
sparse path."""

import time
from typing import Optional, Sequence

import numpy as np

from . import presolve as presolve_mod
from .cones import api, ops as cone_ops
from .cones.api import cones_collapsed
from .cones.layout import build_layout
from .infinity import get_infinity
from .ipm.loop import make_solve_fn
from .kkt.sparse_kkt import SparseProblem
from .settings import Settings
from .solver import DefaultSolution
from .statuscodes import SolverStatus


def sparse_ruiz_equilibrate(P, A, q, b, layout, settings):
    """Sparse mirror of equilibration.ruiz_equilibrate
    (data_equilibrate!, problemdata.jl:133-221).  P upper-symmetric
    scipy matrix or None, A scipy sparse.  Returns scaled copies +
    (d, e, c)."""
    import scipy.sparse as sp

    n = A.shape[1]
    m = A.shape[0]
    A = sp.csc_matrix(A, copy=True).astype(np.float64)
    P = (
        sp.csc_matrix((n, n))
        if P is None
        else sp.csc_matrix(P, copy=True).astype(np.float64)
    )
    P = sp.triu(P) + sp.triu(P, 1).T
    q = np.asarray(q, dtype=np.float64).copy()
    b = np.asarray(b, dtype=np.float64).copy()

    d = np.ones(n)
    e = np.ones(m)
    c = 1.0

    if settings.equilibrate_enable:
        smin = settings.equilibrate_min_scaling
        smax = settings.equilibrate_max_scaling

        def colmax(M):
            M = sp.csc_matrix(abs(M))
            out = np.zeros(M.shape[1])
            if M.nnz:
                nonempty = np.diff(M.indptr) > 0
                starts = M.indptr[:-1][nonempty]
                out[nonempty] = np.maximum.reduceat(M.data, starts)
            return out

        for _ in range(settings.equilibrate_max_iter):
            cP = colmax(P)
            cA = colmax(A)
            rA = colmax(A.T)
            dwork = np.maximum(cP, cA)
            dwork = 1.0 / np.sqrt(np.where(dwork == 0.0, 1.0, dwork))
            ework = 1.0 / np.sqrt(np.where(rA == 0.0, 1.0, rA))
            dwork = np.clip(dwork, smin / d, smax / d)
            ework = np.clip(ework, smin / e, smax / e)

            Dw = sp.diags(dwork)
            Ew = sp.diags(ework)
            P = Dw @ P @ Dw
            A = Ew @ A @ Dw
            q *= dwork
            b *= ework
            d *= dwork
            e *= ework

            mean_col_P = colmax(P).mean() if P.nnz else 0.0
            inf_q = np.abs(q).max() if n else 0.0
            if mean_col_P != 0.0 and inf_q != 0.0:
                ctmp = 1.0 / max(max(inf_q, mean_col_P), 1e-300)
                ctmp = np.clip(ctmp, smin / c, smax / c)
                P = P * ctmp
                q *= ctmp
                c *= ctmp

        # cone rectification: non-elementwise cones get their rows'
        # scalings replaced by the block mean (rectify_equilibration!,
        # coneops_defaults.jl:32-44)
        rect = layout.rectification_ranges()
        if rect:
            delta = np.ones(m)
            for lo, hi in rect:
                delta[lo:hi] = e[lo:hi].mean() / e[lo:hi]
            A = sp.diags(delta) @ A
            b *= delta
            e *= delta
    return P, A, q, b, d, e, c


class SparseSolver:
    """min (1/2)x'Px + q'x  s.t.  Ax + s = b, s in K, with P, A scipy
    sparse (every cone class)."""

    def __init__(self, P, q, A, b, cones: Sequence[api.SupportedCone],
                 settings: Optional[Settings] = None, **kwargs):
        import jax
        import jax.numpy as jnp

        settings = settings or Settings()
        if kwargs:
            settings = settings.replace(**kwargs)
        settings.validate()
        self.settings = settings

        q = np.asarray(q, dtype=np.float64).ravel()
        b = np.asarray(b, dtype=np.float64).ravel()
        n, m = q.shape[0], b.shape[0]
        if A.shape != (m, n):
            raise ValueError("A shape inconsistent with q/b")

        import scipy.sparse as sp

        cones = cones_collapsed(list(cones))
        # presolve (presolver.jl): runs BEFORE pattern analysis, so the
        # sparse path supports it like the dense one; data updates are
        # then forbidden (check_data_update_allowed semantics)
        infbound = get_infinity()
        self.presolver = presolve_mod.try_presolve(
            cones, b, settings, infbound
        )
        if self.presolver is not None:
            A = sp.csr_matrix(A)[self.presolver.keep]
            b = b[self.presolver.keep]
            _, _, cones = presolve_mod.apply_presolve(
                self.presolver, np.zeros((self.presolver.mfull, 0)), 
                np.zeros(self.presolver.mfull), cones
            )
            m = b.shape[0]

        # chordal decomposition of PSD cones (problemdata.jl:40-45):
        # big chordally-sparse PSD blocks become many clique-sized PSD
        # cones, which enter the multifrontal KKT as small dense Hs
        # blocks.  The graph analysis and augmentation run host-side on
        # a temporarily densified copy (setup-only cost).
        self.chordal_info = None
        if settings.chordal_decomposition_enable and any(
            isinstance(c, api.PSDTriangleConeT) for c in cones
        ):
            from .chordal import ChordalInfo, decomp_augment

            Ad = sp.csc_matrix(A).toarray()
            info = ChordalInfo(Ad, b, cones, settings)
            if info.is_decomposed():
                Pd = (
                    sp.csc_matrix(P).toarray()
                    if P is not None else np.zeros((n, n))
                )
                Pd, q, Ad, b, cones = decomp_augment(
                    info, Pd, q, Ad, b, settings
                )
                n = q.shape[0]
                m = b.shape[0]
                P = sp.csc_matrix(Pd) if np.any(Pd) else None
                A = sp.csc_matrix(Ad)
                self.chordal_info = info

        self.layout = build_layout(tuple(cones))
        self._cones = list(cones)
        if self.layout.m != m:
            raise ValueError("cone dimensions inconsistent with b")

        b = np.minimum(b, get_infinity())
        normq = float(np.abs(q).max()) if n else 0.0
        normb = float(np.abs(b).max()) if m else 0.0

        Ps, As, qs, bs, d, e, c = sparse_ruiz_equilibrate(
            P, A, q, b, self.layout, settings
        )
        if settings.input_sparse_dropzeros:
            # drop explicit zeros from the stored pattern
            # (input_sparse_dropzeros, problemdata.jl:64-70); data
            # updates then require the reduced pattern
            Ps.eliminate_zeros()
            As.eliminate_zeros()
        self._has_P = bool(Ps.nnz)
        self.n, self.m = n, m
        self._d, self._e, self._c = d, e, c
        self._sp = SparseProblem.from_scipy(
            Ps if self._has_P else None, As
        )
        self._dev = {
            "Pv": jnp.asarray(self._sp.P_vals(Ps if self._has_P else None)),
            "Av": jnp.asarray(self._sp.A_vals(As)),
            "q": jnp.asarray(qs),
            "b": jnp.asarray(bs),
            "d": jnp.asarray(d),
            "dinv": jnp.asarray(1.0 / d),
            "e": jnp.asarray(e),
            "einv": jnp.asarray(1.0 / e),
            "cscale": jnp.asarray(c),
            "normq": jnp.asarray(normq),
            "normb": jnp.asarray(normb),
        }
        self._solve_fn = make_solve_fn(
            self.layout, settings, n, m, self._has_P, jnp.float64,
            sparse=self._sp, stream=settings.verbose,
        )
        # index maps as runtime inputs (not baked constants)
        from .kkt.sparse_kkt import make_sparse_kkt as _mk

        _, _, host_bufs = _mk(n, m, settings, self.layout, self._sp)
        self._dev["spbufs"] = {
            k2: jnp.asarray(v2) for k2, v2 in host_bufs.items()
        }
        self.solution: Optional[DefaultSolution] = None
        self.info: Optional[dict] = None

    # -- parametric data updating (src/data_updating.jl semantics; the
    # sparse path reuses the symbolic factorization and the compiled
    # program, so re-solves skip both analysis and compilation) --------
    def _check_update_allowed(self):
        if self.presolver is not None:
            raise ValueError(
                "Data updates not allowed if presolver is active."
            )
        if self.chordal_info is not None:
            raise ValueError(
                "Data updates not allowed after chordal decomposition."
            )

    def _vals_for_pattern(self, M, rows, cols, what):
        import scipy.sparse as sp

        C = sp.coo_matrix(M)
        got = {(int(r), int(c)): float(v)
               for r, c, v in zip(C.row, C.col, C.data)}
        want = set(zip(rows.tolist(), cols.tolist()))
        # explicit zeros outside the stored pattern are structurally
        # irrelevant (scipy products routinely carry them)
        extra = {k for k in (set(got) - want) if got[k] != 0.0}
        if extra:
            raise ValueError(
                f"{what}: sparsity pattern must match the original "
                f"(unexpected entries, e.g. {sorted(extra)[:3]})"
            )
        return np.asarray(
            [got.get((int(r), int(c)), 0.0) for r, c in zip(rows, cols)]
        )

    def update_P(self, P) -> None:
        """P_int = c * D P D on the stored upper pattern
        (update_P!, data_updating.jl:56-71)."""
        import jax.numpy as jnp
        import scipy.sparse as sp

        if P is None:
            return
        self._check_update_allowed()
        if not self._has_P:
            raise ValueError("cannot update P: problem was built without P")
        Pu = sp.triu(sp.csc_matrix(P))
        vals = self._vals_for_pattern(
            Pu, self._sp.P_rows, self._sp.P_cols, "P"
        )
        d, c = self._d, self._c
        self._dev["Pv"] = jnp.asarray(
            c * d[self._sp.P_rows] * d[self._sp.P_cols] * vals
        )

    def update_A(self, A) -> None:
        """A_int = E A D (update_A!, data_updating.jl:85-100)."""
        import jax.numpy as jnp

        if A is None:
            return
        self._check_update_allowed()
        vals = self._vals_for_pattern(
            A, self._sp.A_rows, self._sp.A_cols, "A"
        )
        self._dev["Av"] = jnp.asarray(
            self._e[self._sp.A_rows] * self._d[self._sp.A_cols] * vals
        )

    def update_q(self, q) -> None:
        import jax.numpy as jnp

        if q is None:
            return
        self._check_update_allowed()
        q = np.asarray(q, dtype=np.float64).ravel()
        if q.shape[0] != self.n:
            raise ValueError("q: wrong length")
        self._dev["q"] = jnp.asarray(self._c * self._d * q)
        self._dev["normq"] = jnp.asarray(
            float(np.abs(q).max()) if self.n else 0.0
        )

    def update_b(self, b) -> None:
        import jax.numpy as jnp

        if b is None:
            return
        self._check_update_allowed()
        b = np.asarray(b, dtype=np.float64).ravel()
        if b.shape[0] != self.m:
            raise ValueError("b: wrong length")
        b = np.minimum(b, get_infinity())
        self._dev["b"] = jnp.asarray(self._e * b)
        self._dev["normb"] = jnp.asarray(
            float(np.abs(b).max()) if self.m else 0.0
        )

    def update_data(self, P=None, q=None, A=None, b=None) -> None:
        self.update_P(P)
        self.update_q(q)
        self.update_A(A)
        self.update_b(b)

    def solve(self, warm_start=None) -> DefaultSolution:
        """warm_start=(x, s, z): seed the IPM from a prior solution
        (original problem space; symmetric-cone layouts without
        presolve/chordal reductions) — see Solver.solve."""
        import jax
        import math

        import jax.numpy as jnp

        if warm_start is not None:
            from .warmstart import scale_warm_start, validate_warm_start

            self._check_update_allowed()
            wx, ws, wz = validate_warm_start(
                self.layout, warm_start, self.n, self.m
            )
            wsx, wss, wsz = scale_warm_start(
                wx, ws, wz, self._d, self._e, self._c
            )
            self._dev["ws_x"] = jnp.asarray(wsx)
            self._dev["ws_s"] = jnp.asarray(wss)
            self._dev["ws_z"] = jnp.asarray(wsz)
            if not hasattr(self, "_warm_fn"):
                self._warm_fn = make_solve_fn(
                    self.layout, self.settings, self.n, self.m,
                    self._has_P, jnp.float64, sparse=self._sp, warm=True,
                    stream=self.settings.verbose,
                )
            solve_fn = self._warm_fn
        else:
            for k in ("ws_x", "ws_s", "ws_z"):
                self._dev.pop(k, None)
            solve_fn = self._solve_fn

        if self.settings.verbose:
            from . import info_print

            info_print.print_banner(self.settings)
            info_print.print_configuration(
                self.settings, self.n, self.m, self._cones, self._has_P,
                "sparse multifrontal",
            )
            info_print.print_iteration_header()
        if math.isfinite(self.settings.time_limit):
            self._dev["t_start"] = jnp.asarray(time.time())
        t0 = time.perf_counter()
        out = solve_fn(self._dev)
        out = jax.tree_util.tree_map(np.asarray, jax.device_get(out))
        solve_time = time.perf_counter() - t0

        self.info = {k: out[k] for k in out}
        self.info["solve_time"] = solve_time
        # linear-solver block (reference DefaultInfo linear_solver,
        # types.jl:209-251): the multifrontal backend attaches its true
        # symbolic factor stats to the factorize fn (sparse_kkt.py)
        from .kkt.sparse_kkt import make_sparse_kkt as _mk2

        _fac, _, _ = _mk2(
            self.n, self.m, self.settings, self.layout, self._sp
        )
        ls = dict(getattr(_fac, "linear_solver_info", {}))
        ls["nnzA"] = int(self._sp.A_rows.shape[0])
        self.info["linear_solver"] = ls
        x_out = np.asarray(out["x"])
        s_out = np.asarray(out["s"])
        z_out = np.asarray(out["z"])
        # reverse chordal decomposition (solution.jl:30-34), then
        # reverse presolve — same order as the dense Solver
        if self.chordal_info is not None:
            from .chordal import decomp_reverse

            x_out, s_out, z_out = decomp_reverse(
                self.chordal_info, x_out, s_out, z_out, self.settings
            )
        if self.presolver is not None:
            s_out, z_out = presolve_mod.reverse_presolve(
                self.presolver, s_out, z_out
            )
        # iteration lines streamed live (stream=verbose above)
        self.solution = DefaultSolution(
            x=x_out,
            z=z_out,
            s=s_out,
            status=SolverStatus(int(out["status"])),
            obj_val=float(out["obj_val"]),
            obj_val_dual=float(out["obj_val_dual"]),
            solve_time=solve_time,
            iterations=int(out["iterations"]),
            r_prim=float(out["r_prim"]),
            r_dual=float(out["r_dual"]),
        )
        if self.settings.verbose:
            from . import info_print

            info_print.print_footer(self.solution)
        return self.solution
