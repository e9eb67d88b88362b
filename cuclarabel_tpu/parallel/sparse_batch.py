"""Batched sparse scenario solving: many sparse conic programs that
share ONE sparsity pattern solve as a single vmapped device program.

This is the answer to the multifrontal's single-problem latency: the
level-scheduled factorization is a chain of ~10^3 small sequential
steps, so one N=3201 solve is latency-bound — but every index map, level schedule and scatter plan depends
only on the PATTERN, so B scenario instances (different values of P/A
over the same nonzeros, different q/b) batch across the whole numeric
phase with `jax.vmap` at near-zero marginal latency.  Scenario sweeps,
MPC re-solves and Monte-Carlo problem families are exactly this shape.

Mirrors parallel/batch.py (the dense batched path) for the sparse
pipeline: device-side sparse Ruiz equilibration over nz values
(data_equilibrate!, problemdata.jl:133-221 semantics), then
`vmap(solve_one)` of the sparse-KKT IPM loop, optionally sharded over
a device mesh along the batch axis.  No host presolve (batch shapes
must stay uniform) — mirroring BatchSolver.
"""

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..cones import api
from ..cones.api import cones_collapsed
from ..cones.layout import build_layout
from ..infinity import get_infinity
from ..ipm.loop import make_solve_fn
from ..kkt.sparse_kkt import SparseProblem, make_sparse_kkt
from ..settings import Settings
from ..solver import DefaultSolution
from ..statuscodes import SolverStatus


def _seg_max(vals, idx, num):
    """segment max of magnitudes with empty segments -> 0 (matching the
    host colmax in sparse_solver.sparse_ruiz_equilibrate)."""
    if vals.shape[0] == 0:
        return jnp.zeros(num, dtype=jnp.float64)
    return jnp.maximum(
        jax.ops.segment_max(vals, idx, num_segments=num), 0.0
    )


def device_sparse_equilibrate(Pv, Av, q, b, bufs, n, m, layout,
                              settings):
    """Device mirror of sparse_solver.sparse_ruiz_equilibrate over nz
    values (data_equilibrate!, problemdata.jl:133-221): Ruiz iterations
    with min/max scaling clips, cost scaling c, and cone rectification.
    bufs carries the COO index maps (runtime inputs): pe_rows/pe_cols
    (P upper), pf_cols/pf_src (P full-pattern column triplets),
    a_rows/a_cols (A)."""
    normq = jnp.max(jnp.abs(q)) if q.shape[0] else jnp.asarray(0.0)
    normb = jnp.max(jnp.abs(b)) if b.shape[0] else jnp.asarray(0.0)

    d = jnp.ones(n)
    e = jnp.ones(m)
    c = jnp.asarray(1.0)
    if not settings.equilibrate_enable:
        return {
            "Pv": Pv, "Av": Av, "q": q, "b": b,
            "d": d, "dinv": d, "e": e, "einv": e, "cscale": c,
            "normq": normq, "normb": normb,
        }

    smin = settings.equilibrate_min_scaling
    smax = settings.equilibrate_max_scaling
    pe_r, pe_c = bufs["pe_rows"], bufs["pe_cols"]
    pf_c, pf_s = bufs["pf_cols"], bufs["pf_src"]
    a_r, a_c = bufs["a_rows"], bufs["a_cols"]

    def colmax_P(Pv):
        return _seg_max(jnp.abs(Pv[pf_s]) if Pv.shape[0]
                        else jnp.zeros(0), pf_c, n)

    def body(_, carry):
        Pv, Av, q, b, d, e, c = carry
        cP = colmax_P(Pv)
        aA = jnp.abs(Av)
        cA = _seg_max(aA, a_c, n)
        rA = _seg_max(aA, a_r, m)
        dwork = jnp.maximum(cP, cA)
        dwork = 1.0 / jnp.sqrt(jnp.where(dwork == 0.0, 1.0, dwork))
        ework = 1.0 / jnp.sqrt(jnp.where(rA == 0.0, 1.0, rA))
        dwork = jnp.clip(dwork, smin / d, smax / d)
        ework = jnp.clip(ework, smin / e, smax / e)

        if Pv.shape[0]:
            Pv = Pv * dwork[pe_r] * dwork[pe_c]
        Av = Av * ework[a_r] * dwork[a_c]
        q = q * dwork
        b = b * ework
        d = d * dwork
        e = e * ework

        mean_col_P = jnp.mean(colmax_P(Pv)) if Pv.shape[0] \
            else jnp.asarray(0.0)
        inf_q = jnp.max(jnp.abs(q)) if q.shape[0] else jnp.asarray(0.0)
        ctmp = 1.0 / jnp.maximum(jnp.maximum(inf_q, mean_col_P), 1e-300)
        ctmp = jnp.clip(ctmp, smin / c, smax / c)
        ctmp = jnp.where((mean_col_P != 0.0) & (inf_q != 0.0), ctmp, 1.0)
        if Pv.shape[0]:
            Pv = Pv * ctmp
        q = q * ctmp
        c = c * ctmp
        return Pv, Av, q, b, d, e, c

    Pv, Av, q, b, d, e, c = jax.lax.fori_loop(
        0, settings.equilibrate_max_iter, body,
        (Pv, Av, q, b, d, e, c),
    )

    # cone rectification: non-elementwise cones get their rows'
    # scalings replaced by the block mean (rectify_equilibration!,
    # coneops_defaults.jl:32-44); ranges are static
    rect = layout.rectification_ranges()
    if rect:
        delta = jnp.ones(m)
        for lo, hi in rect:
            blk = e[lo:hi]
            delta = delta.at[lo:hi].set(jnp.mean(blk) / blk)
        Av = Av * delta[a_r]
        b = b * delta
        e = e * delta

    return {
        "Pv": Pv, "Av": Av, "q": q, "b": b,
        "d": d, "dinv": 1.0 / d, "e": e, "einv": 1.0 / e, "cscale": c,
        "normq": normq, "normb": normb,
    }


class BatchSparseSolver:
    """Solve a batch of sparse conic programs sharing one pattern.

    P: scipy sparse (n,n) or None; A: scipy sparse (m,n) — these fix
    the PATTERN and the default values.  q: (B,n); b: (B,m).
    P_vals/A_vals: optional (B, nnz) per-problem nz values over the
    same pattern (nnz of triu(P) in CSC-COO order as produced by
    SparseProblem.P_vals / A_vals).  With n_devices > 1 the batch
    shards across the first n_devices of `jax.devices()`.

    Cone coverage matches SparseSolver (everything except PSD)."""

    def __init__(self, P, q, A, b, cones: Sequence[api.SupportedCone],
                 settings: Optional[Settings] = None,
                 P_vals=None, A_vals=None, n_devices: int = 1,
                 **kwargs):
        import math

        settings = settings or Settings()
        if kwargs:
            settings = settings.replace(**kwargs)
        settings = settings.replace(presolve_enable=False)
        settings.validate()
        self.settings = settings

        q = np.asarray(q, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if q.ndim != 2 or b.ndim != 2 or q.shape[0] != b.shape[0]:
            raise ValueError("q must be (B,n) and b (B,m) with equal B")
        B, n = q.shape
        m = b.shape[1]
        if A.shape != (m, n):
            raise ValueError("A shape inconsistent with q/b")

        import scipy.sparse as sp

        cones = cones_collapsed(list(cones))
        self.layout = build_layout(tuple(cones))
        if self.layout.m != m:
            raise ValueError("cone dimensions inconsistent with b")
        has_P = P is not None and sp.csc_matrix(P).nnz > 0
        self._sp = SparseProblem.from_scipy(P if has_P else None, A)
        self._has_P = has_P
        self.B, self.n, self.m = B, n, m

        Pv0 = self._sp.P_vals(P if has_P else None)
        Av0 = self._sp.A_vals(A)

        def batch_vals(V, V0, what):
            if V is None:
                return np.broadcast_to(V0, (B,) + V0.shape)
            V = np.asarray(V, dtype=np.float64)
            if V.shape != (B,) + V0.shape:
                raise ValueError(
                    f"{what} must be (B, {V0.shape[0]}), got {V.shape}"
                )
            return V

        Pvb = batch_vals(P_vals, Pv0, "P_vals")
        Avb = batch_vals(A_vals, Av0, "A_vals")

        base = make_solve_fn(self.layout, settings, n, m, has_P,
                             jnp.float64, raw=True, sparse=self._sp)
        _, _, host_bufs = make_sparse_kkt(
            n, m, settings, self.layout, self._sp
        )
        host_bufs = dict(host_bufs)
        # upper-COO maps for the device equilibration's value scaling
        host_bufs["pe_rows"] = self._sp.P_rows
        host_bufs["pe_cols"] = self._sp.P_cols
        layout = self.layout
        has_time_limit = math.isfinite(settings.time_limit)

        if n_devices > 1 and B % n_devices != 0:
            raise ValueError("batch size must divide evenly across devices")

        def build_fn(warm: bool):
            base_fn = base if not warm else make_solve_fn(
                self.layout, settings, n, m, has_P, jnp.float64,
                raw=True, sparse=self._sp, warm=True,
            )

            def solve_one(Pv, Av, q1, b1, spbufs, t_start, *ws):
                b1 = jnp.minimum(b1, get_infinity())
                dev = device_sparse_equilibrate(
                    Pv, Av, q1, b1, spbufs, n, m, layout, settings
                )
                dev["spbufs"] = spbufs
                if has_time_limit:
                    dev["t_start"] = t_start
                if warm:
                    from ..warmstart import scale_warm_start

                    wx, wsv, wz = ws
                    dev["ws_x"], dev["ws_s"], dev["ws_z"] = (
                        scale_warm_start(wx, wsv, wz, dev["d"], dev["e"],
                                         dev["cscale"])
                    )
                return base_fn(dev)

            extra = (0, 0, 0) if warm else ()
            batched = jax.vmap(
                solve_one, in_axes=(0, 0, 0, 0, None, None) + extra
            )
            if n_devices > 1:
                devices = np.asarray(jax.devices()[:n_devices])
                mesh = Mesh(devices, axis_names=("batch",))
                shard = NamedSharding(mesh, PartitionSpec("batch"))
                repl = NamedSharding(mesh, PartitionSpec())
                return jax.jit(
                    batched,
                    in_shardings=(shard, shard, shard, shard, repl, repl)
                    + ((shard,) * 3 if warm else ()),
                    out_shardings=shard,
                )
            return jax.jit(batched)

        self._build_fn = build_fn
        self._fn = build_fn(False)

        self._args = (
            jnp.asarray(Pvb), jnp.asarray(Avb),
            jnp.asarray(q), jnp.asarray(b),
        )
        # index maps stay host-side numpy until dispatch: passing them
        # as call ARGUMENTS (not jitted-closure constants) keeps them
        # out of the program text — baked maps OOM the compiler
        self._spbufs = {k: jnp.asarray(v) for k, v in host_bufs.items()}
        self.raw = None

    def update_data(self, q=None, b=None, P_vals=None, A_vals=None):
        """Parametric re-solve path (data_updating.jl semantics for the
        batched-values case): replace per-problem q/b/nz values without
        re-analysis or re-compilation.  Shapes must match the original
        batch."""
        Pvb, Avb, qb, bb = self._args

        def repl(new, old, what):
            if new is None:
                return old
            new = np.asarray(new, dtype=np.float64)
            if new.shape != old.shape:
                raise ValueError(
                    f"{what} must have shape {old.shape}, got {new.shape}"
                )
            return jnp.asarray(new)

        self._args = (
            repl(P_vals, Pvb, "P_vals"), repl(A_vals, Avb, "A_vals"),
            repl(q, qb, "q"), repl(b, bb, "b"),
        )

    def solve(self, warm_start=None):
        """warm_start=(X, S, Z), shapes (B, n)/(B, m)/(B, m) in the
        original problem space — seeds every problem's iterates (see
        Solver.solve); symmetric-cone layouts only."""
        import time as _time

        if warm_start is not None:
            from ..warmstart import validate_warm_start

            n, m = self._args[2].shape[1], self._args[3].shape[1]
            wx, ws, wz = validate_warm_start(
                self.layout, warm_start, n, m, batch=self.B
            )
            if not hasattr(self, "_warm_fn"):
                self._warm_fn = self._build_fn(True)
            out = jax.device_get(self._warm_fn(
                *self._args, self._spbufs, jnp.asarray(_time.time()),
                jnp.asarray(wx), jnp.asarray(ws), jnp.asarray(wz),
            ))
        else:
            out = jax.device_get(
                self._fn(*self._args, self._spbufs,
                         jnp.asarray(_time.time()))
            )
        sols = []
        for i in range(self.B):
            sols.append(
                DefaultSolution(
                    x=np.asarray(out["x"][i]),
                    z=np.asarray(out["z"][i]),
                    s=np.asarray(out["s"][i]),
                    status=SolverStatus(int(out["status"][i])),
                    obj_val=float(out["obj_val"][i]),
                    obj_val_dual=float(out["obj_val_dual"][i]),
                    solve_time=0.0,
                    iterations=int(out["iterations"][i]),
                    r_prim=float(out["r_prim"][i]),
                    r_dual=float(out["r_dual"][i]),
                )
            )
        self.raw = out
        return sols
