"""Batched & sharded problem solving — the solver's data-parallel axis.

The reference is a single-process, single-problem solver (SURVEY.md
§2.9); its only structural parallelism is per-cone independence.  The
scale-out axis here is *problem batching*: many conic programs with the
same structure (same cone layout, same dimensions, different numeric
data) solve as one `vmap`-ed device program, sharded over a
`jax.sharding.Mesh` so each device carries a slab of the batch.
Batched problems need no cross-problem communication at all — scaling
over devices is embarrassingly parallel.

Because the whole IPM loop (ipm/loop.py) is functional and jit-shaped,
batching is literally `vmap(solve_one)`: every cone kernel, the dense
KKT factorization, and the iterative-refinement `while_loop` batch
transparently.  Ruiz equilibration moves on-device here (a `fori_loop`
mirror of the host path in equilibration.py) so that per-problem
scalings stay inside the one compiled program.

Note: the batched path skips presolve (host-side row elimination would
give ragged per-problem shapes; the batch shares one static shape).
"""

from functools import lru_cache
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
from ..settings import Settings
from ..solver import DefaultSolution, _resolve_factor_dtype
from ..statuscodes import SolverStatus


def _rect_plan(layout):
    """Static segment plan for cone rectification: seg id per row of
    the m-vector for cones that need scalar equilibration, -1 elsewhere
    (rectify_equilibration!, coneops_defaults.jl:32-44)."""
    seg = np.full(layout.m, -1, dtype=np.int32)
    ranges = layout.rectification_ranges()
    for i, (lo, hi) in enumerate(ranges):
        seg[lo:hi] = i
    return seg, len(ranges)


def device_equilibrate(P, A, q, b, layout, settings, has_P=True):
    """On-device Ruiz equilibration; jnp mirror of
    equilibration.ruiz_equilibrate (data_equilibrate!,
    src/problemdata.jl:133-221).  Returns the device dict consumed by
    the IPM solve function.

    has_P=False (statically no quadratic term) skips every P-side
    computation: with P == 0 the column maxima are zero and the cost
    scaling c stays exactly 1, so the results are identical — the
    zero-matrix reductions and rescales were ~40% of each Ruiz pass."""
    n = q.shape[0]
    m = b.shape[0]
    normq = jnp.max(jnp.abs(q)) if n else jnp.asarray(0.0)
    normb = jnp.max(jnp.abs(b)) if m else jnp.asarray(0.0)

    d = jnp.ones(n)
    e = jnp.ones(m)
    c = jnp.asarray(1.0)

    if settings.equilibrate_enable:
        smin = settings.equilibrate_min_scaling
        smax = settings.equilibrate_max_scaling

        # The Ruiz iteration runs on an f32 SHADOW of the data: the
        # scalings are clipped to [1e-4, 1e4] heuristics, far inside
        # f32 range, and f32 passes over (B, m, n) move half the bytes
        # of f64 ones (whether that still pays on native f64 is
        # ROADMAP A5).  The final scaling application to the real data
        # happens ONCE in f64 below, so the solved problem is scaled
        # exactly by the (f32-chosen) d, e, c.
        f32 = jnp.float32
        Pf = P.astype(f32) if has_P else P
        Af = A.astype(f32)
        qf = q.astype(f32)
        df = jnp.ones(n, f32)
        ef = jnp.ones(m, f32)
        cf = jnp.asarray(1.0, f32)

        def body(_, carry):
            Pf, Af, qf, d, e, c = carry
            colA = jnp.max(jnp.abs(Af), axis=0)
            if has_P:
                colP = jnp.max(jnp.abs(Pf), axis=0)
                dwork = jnp.maximum(colP, colA)
            else:
                dwork = colA
            ework = jnp.max(jnp.abs(Af), axis=1)
            dwork = 1.0 / jnp.sqrt(jnp.where(dwork == 0.0, 1.0, dwork))
            ework = 1.0 / jnp.sqrt(jnp.where(ework == 0.0, 1.0, ework))
            dwork = jnp.clip(dwork, f32(smin) / d, f32(smax) / d)
            ework = jnp.clip(ework, f32(smin) / e, f32(smax) / e)

            if has_P:
                Pf = Pf * dwork[None, :] * dwork[:, None]
            Af = Af * dwork[None, :] * ework[:, None]
            qf = qf * dwork
            d = d * dwork
            e = e * ework

            if has_P:
                mean_col_P = jnp.mean(jnp.max(jnp.abs(Pf), axis=0))
                inf_q = jnp.max(jnp.abs(qf))
                ctmp = 1.0 / jnp.maximum(
                    jnp.maximum(inf_q, mean_col_P), f32(1e-30))
                ctmp = jnp.clip(ctmp, f32(smin) / c, f32(smax) / c)
                ctmp = jnp.where(
                    (mean_col_P != 0.0) & (inf_q != 0.0), ctmp,
                    f32(1.0))
            else:
                ctmp = f32(1.0)  # mean_col_P == 0 forces c = 1 exactly
            return (Pf * ctmp if has_P else Pf, Af, qf * ctmp,
                    d, e, c * ctmp)

        Pf, Af, qf, df, ef, cf = jax.lax.fori_loop(
            0, settings.equilibrate_max_iter,
            body, (Pf, Af, qf, df, ef, cf),
        )
        d = df.astype(jnp.float64)
        e = ef.astype(jnp.float64)
        c = cf.astype(jnp.float64)
        # one exact f64 application of the accumulated scalings
        if has_P:
            P = P * (c * d[None, :] * d[:, None])
        A = A * d[None, :] * e[:, None]
        q = q * (c * d)
        b = b * e

        seg, nrect = _rect_plan(layout)
        if nrect:
            segj = jnp.asarray(seg)
            valid = segj >= 0
            segc = jnp.where(valid, segj, 0)
            sums = jax.ops.segment_sum(jnp.where(valid, e, 0.0), segc, nrect)
            cnts = jax.ops.segment_sum(jnp.where(valid, 1.0, 0.0), segc, nrect)
            mean_e = sums / jnp.maximum(cnts, 1.0)
            delta = jnp.where(valid, mean_e[segc] / e, 1.0)
            A = A * delta[:, None]
            b = b * delta
            e = e * delta

    return {
        "P": P,
        "q": q,
        "A": A,
        "b": b,
        "d": d,
        "dinv": 1.0 / d,
        "e": e,
        "einv": 1.0 / e,
        "cscale": c,
        "normq": normq,
        "normb": normb,
    }


@lru_cache(maxsize=64)
def make_batch_solve_fn(
    layout,
    settings: Settings,
    n: int,
    m: int,
    has_P: bool,
    factor_dtype_name: str,
    mesh_shape: Optional[tuple] = None,
    warm: bool = False,
):
    """Jitted batched solve: (P, A, q, b) with leading batch axis ->
    batched solution dict.  With mesh_shape=(k,) the batch axis shards
    over a k-device mesh ('batch' axis — the dp axis of this workload).
    With warm=True the function takes three extra (B, n)/(B, m)/(B, m)
    arrays of warm-start iterates in the original problem space.
    """
    import math

    factor_dtype = jnp.float32 if factor_dtype_name == "float32" else jnp.float64
    base = make_solve_fn(layout, settings, n, m, has_P, factor_dtype, raw=True,
                         warm=warm)
    has_time_limit = math.isfinite(settings.time_limit)

    def solve_one(P, A, q, b, t_start, *ws):
        b = jnp.minimum(b, get_infinity())  # problemdata.jl:58-62
        dev = device_equilibrate(P, A, q, b, layout, settings,
                                 has_P=has_P)
        if has_time_limit:
            dev["t_start"] = t_start
        if warm:
            from ..warmstart import scale_warm_start

            wx, wsv, wz = ws
            # equilibration runs on device here, so the scaling is only
            # known inside the traced fn
            dev["ws_x"], dev["ws_s"], dev["ws_z"] = scale_warm_start(
                wx, wsv, wz, dev["d"], dev["e"], dev["cscale"]
            )
        return base(dev)

    extra = (0, 0, 0) if warm else ()
    batched = jax.vmap(solve_one, in_axes=(0, 0, 0, 0, None) + extra)

    if mesh_shape is None:
        return jax.jit(batched)

    devices = np.asarray(jax.devices()[: int(np.prod(mesh_shape))]).reshape(
        mesh_shape
    )
    mesh = Mesh(devices, axis_names=("batch",))
    # shard_map (not sharded-jit) so each device runs an INDEPENDENT
    # while_loop over its shard: a global vmapped loop's termination
    # test reduces over the whole batch axis, which the partitioner
    # turns into one scalar all-reduce PER IPM ITERATION (and couples
    # every device to the globally slowest problem).  With shard_map
    # the solve path carries ZERO collectives — each device stops at
    # its own shard's max iteration count (counted in the compiled HLO
    # by chip_smoke.py --four and __graft_entry__.dryrun_multichip).
    from jax import shard_map

    spec = PartitionSpec("batch")
    repl = PartitionSpec()
    in_specs = (spec, spec, spec, spec, repl) + ((spec,) * 3 if warm else ())
    return jax.jit(
        shard_map(
            batched, mesh=mesh, in_specs=in_specs, out_specs=spec,
            check_vma=False,
        )
    )


@lru_cache(maxsize=64)
def make_batch_stage_fns(
    layout,
    settings: Settings,
    n: int,
    m: int,
    has_P: bool,
    factor_dtype_name: str,
    warm: bool = False,
):
    """Batch-compaction path (settings.batch_compaction in (0,1)): the
    batched IPM as TWO dispatches instead of one.

    The plain batched program (`make_batch_solve_fn`) is a vmapped
    `while_loop`, so every problem runs until the LAST one converges —
    at large B the batch pays max-iterations while the mean is lower
    (measured on the portfolio-SOCP bench: max 12 vs mean 8.6 at
    B=4096).  Here stage 1 drives the loop manually over the batched
    state and exits once a quorum of problems is finished; the host
    gathers the straggler indices, and stage 2 resumes ONLY those
    problems — from their exact mid-loop state — in a program a
    fraction of the width.  No reference counterpart (the reference
    solves one problem per process, SURVEY.md §2.9).

    Stage 2 re-runs device equilibration on the gathered data instead
    of shipping the equilibrated matrices between stages: Ruiz is a
    deterministic function of the data, so the scaled space matches to
    roundoff and the mid-loop iterates remain valid there.
    """
    factor_dtype = jnp.float32 if factor_dtype_name == "float32" else jnp.float64
    build = make_solve_fn(layout, settings, n, m, has_P, factor_dtype,
                          parts=True, warm=warm)
    import math

    from ..statuscodes import SolverStatus as _S

    has_time_limit = math.isfinite(settings.time_limit)
    quorum = float(settings.batch_compaction)
    unsolved_code = int(_S.UNSOLVED)

    def dev_of(P, A, q, b, t_start, *ws):
        b = jnp.minimum(b, get_infinity())
        dev = device_equilibrate(P, A, q, b, layout, settings,
                                 has_P=has_P)
        if has_time_limit:
            dev["t_start"] = t_start
        if warm:
            from ..warmstart import scale_warm_start

            wx, wsv, wz = ws
            dev["ws_x"], dev["ws_s"], dev["ws_z"] = scale_warm_start(
                wx, wsv, wz, dev["d"], dev["e"], dev["cscale"]
            )
        return dev

    extra = (0, 0, 0) if warm else ()
    vdev = jax.vmap(dev_of, in_axes=(0, 0, 0, 0, None) + extra)

    def stage1(P, A, q, b, t_start, *ws):
        with jax.default_matmul_precision("highest"):
            devs = vdev(P, A, q, b, t_start, *ws)
            state0 = jax.vmap(lambda dv: build(dv)[0]())(devs)
            vbody = jax.vmap(lambda dv, s: build(dv)[2](s))

            def cond(bs):
                rem = jnp.mean(
                    (bs["status"] == unsolved_code).astype(jnp.float64)
                )
                return rem > (1.0 - quorum)

            final = jax.lax.while_loop(
                cond, lambda bs: vbody(devs, bs), state0
            )
            outs = jax.vmap(lambda dv, s: build(dv)[3](s))(devs, final)
            return outs, final

    def stage2(P, A, q, b, t_start, idx, state, *ws):
        with jax.default_matmul_precision("highest"):
            def take(a):
                return jnp.take(a, idx, axis=0)

            devs = vdev(take(P), take(A), take(q), take(b), t_start,
                        *tuple(take(w) for w in ws))
            st2 = jax.tree_util.tree_map(take, state)

            def run_one(dv, s):
                _, loop_cond, loop_body, post = build(dv)
                return post(jax.lax.while_loop(loop_cond, loop_body, s))

            return jax.vmap(run_one)(devs, st2)

    return jax.jit(stage1), jax.jit(stage2)


class BatchSolver:
    """Solve a batch of structurally identical conic programs.

    P: (n,n) or (B,n,n); A: (m,n) or (B,m,n); q: (B,n); b: (B,m).
    All problems share the cone layout; numeric data varies freely.
    With n_devices > 1 the batch shards across the first n_devices of
    `jax.devices()`.
    """

    def __init__(
        self,
        P,
        q,
        A,
        b,
        cones: Sequence[api.SupportedCone],
        settings: Optional[Settings] = None,
        n_devices: int = 1,
        **kwargs,
    ):
        settings = settings or Settings()
        if kwargs:
            settings = settings.replace(**kwargs)
        # batched path: no host presolve (shapes must stay uniform)
        settings = settings.replace(presolve_enable=False)
        settings.validate()
        self.settings = settings

        q = np.asarray(q, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if q.ndim != 2 or b.ndim != 2 or q.shape[0] != b.shape[0]:
            raise ValueError("q must be (B,n) and b (B,m) with equal B")
        B, n = q.shape
        m = b.shape[1]

        def batchify(M, shape):
            M = np.zeros(shape) if M is None else np.asarray(
                M.toarray() if hasattr(M, "toarray") else M, dtype=np.float64
            )
            if M.ndim == 2:
                M = np.broadcast_to(M, (B,) + M.shape)
            if M.shape != (B,) + shape:
                raise ValueError(f"expected {(B,) + shape}, got {M.shape}")
            return M

        self._batchify = batchify
        Pd = batchify(P, (n, n))
        Pd = np.triu(Pd) + np.transpose(np.triu(Pd, 1), (0, 2, 1))
        Ad = batchify(A, (m, n))

        cones = cones_collapsed(list(cones))
        self.layout = build_layout(tuple(cones))
        if self.layout.m != m:
            raise ValueError("cone dimensions inconsistent with b")
        self._has_P = bool(np.any(Pd != 0.0))
        self.B, self.n, self.m = B, n, m

        mesh_shape = (n_devices,) if n_devices > 1 else None
        if n_devices > 1 and B % n_devices != 0:
            raise ValueError("batch size must divide evenly across devices")
        self._mesh_shape = mesh_shape
        # resolve the -1.0 auto sentinel against the concrete batch
        # width (measured crossover: compaction wins at large B only);
        # auto never turns it on for a sharded batch, where staged
        # resume is unsupported
        if settings.batch_compaction < 0.0:
            q_res = (
                0.0 if mesh_shape is not None
                else settings.resolved_batch_compaction(B)
            )
            settings = settings.replace(batch_compaction=q_res)
            self.settings = settings
        self._staged = settings.batch_compaction > 0.0
        # chunked wide batches (see _solve_chunked): single-device
        # only — a sharded batch already splits across devices
        self._chunk = (
            0 if mesh_shape is not None
            else settings.resolved_batch_chunk(B)
        )
        if self._staged and mesh_shape is not None:
            raise ValueError(
                "batch_compaction resumes stragglers in a narrower "
                "single-device program and cannot combine with "
                "n_devices > 1; shard the batch OR compact it"
            )
        if self._staged:
            self._stage_fns = make_batch_stage_fns(
                self.layout, settings, n, m, self._has_P,
                _resolve_factor_dtype(settings, self.layout),
            )
            self._fn = None
        else:
            self._fn = make_batch_solve_fn(
                self.layout,
                settings,
                n,
                m,
                self._has_P,
                _resolve_factor_dtype(settings, self.layout),
                mesh_shape,
            )
        self._args = (
            jnp.asarray(Pd),
            jnp.asarray(Ad),
            jnp.asarray(q),
            jnp.asarray(b),
        )

    def update_data(self, P=None, q=None, A=None, b=None) -> None:
        """Parametric re-solves (update_data!, data_updating.jl
        semantics): equilibration runs on device per solve, so new
        data is just new runtime arguments — the compiled program is
        reused, nothing is re-analyzed."""
        Pd, Ad, qd, bd = self._args
        if P is not None:
            Pn = self._batchify(P, (self.n, self.n))
            Pn = np.triu(Pn) + np.transpose(np.triu(Pn, 1), (0, 2, 1))
            if bool(np.any(Pn != 0.0)) != self._has_P:
                raise ValueError(
                    "update_data cannot change whether P is zero "
                    "(the compiled program is specialized on it)"
                )
            Pd = jnp.asarray(Pn)
        if A is not None:
            Ad = jnp.asarray(self._batchify(A, (self.m, self.n)))
        if q is not None:
            q = np.asarray(q, dtype=np.float64)
            if q.shape != (self.B, self.n):
                raise ValueError("q must be (B, n)")
            qd = jnp.asarray(q)
        if b is not None:
            b = np.asarray(b, dtype=np.float64)
            if b.shape != (self.B, self.m):
                raise ValueError("b must be (B, m)")
            bd = jnp.asarray(b)
        self._args = (Pd, Ad, qd, bd)

    def _stage_fns_for(self, warm):
        if warm:
            return make_batch_stage_fns(
                self.layout, self.settings, self.n, self.m, self._has_P,
                _resolve_factor_dtype(self.settings, self.layout),
                warm=True,
            )
        return self._stage_fns

    def _staged_resolve(self, s2, t, args, B, outs, state, ws_args):
        """Host half of the compaction solve: fetch ONLY the status
        vector first (16 KB — the straggler list needs nothing else),
        dispatch stage 2 asynchronously, then pull the full stage-1
        results while stage 2 executes, so that the bulk fetch (~4.4 MB
        at B=4096) no longer serializes ahead of the stage-2
        dispatch."""
        status_h = np.asarray(outs["status"])
        rem = np.flatnonzero(status_h == int(SolverStatus.UNSOLVED))
        outs2 = None
        if rem.size:
            # pad the straggler list to a power of two (bounded set of
            # stage-2 program shapes -> warm jit cache on re-solves);
            # padding repeats real indices, duplicates are discarded
            B2 = min(B, max(8, 1 << int(rem.size - 1).bit_length()))
            idx = np.resize(rem, B2).astype(np.int32)
            outs2 = s2(*args, t, jnp.asarray(idx), state, *ws_args)
        # device_get may hand back read-only buffer views; stage 2
        # results are scattered into these in place
        out = {k: np.array(v) for k, v in jax.device_get(outs).items()}
        comp = {
            "remainder": int(rem.size),
            "stage1_iterations": int(np.max(out["iterations"])),
        }
        if outs2 is not None:
            out2 = jax.device_get(outs2)
            k = rem.size
            for key in out:
                out[key][rem] = out2[key][:k]
        return out, comp

    def _solve_staged(self, ws_args):
        """Two-dispatch compaction solve (see make_batch_stage_fns):
        stage 1 to quorum, host gather of straggler indices, stage 2
        resumes them from mid-loop state in a power-of-two-wide
        program.  Records self.last_compaction for observability."""
        import time as _time

        s1, s2 = self._stage_fns_for(bool(ws_args))
        t = jnp.asarray(_time.time())
        outs, state = s1(*self._args, t, *ws_args)
        out, comp = self._staged_resolve(
            s2, t, self._args, self.B, outs, state, ws_args)
        self.last_compaction = comp
        return out

    def _solve_chunked(self, ws_args, fn=None):
        """Chunked wide-batch solve (settings.batch_chunk_size): the
        batch splits into chunk-wide programs that are ALL enqueued
        before any result is awaited — XLA executes them back-to-back
        on the chip (pipelining the host round-trips away) while peak
        live intermediates stay bounded by the chunk width.  Round-4
        measured a monolithic B=8192 program at 9.1k problems/s vs
        10.2k at B=4096 (batch_scaling artifact); chunking holds the
        per-chunk width at the measured sweet spot.

        Composition with compaction: every chunk's stage-1 program is
        dispatched first (async); the per-chunk straggler gathers then
        resolve in order, each stage-2 dispatch overlapping the later
        chunks' stage-1 execution.  The tail chunk pads to a power of
        two by repeating problems (duplicates discarded on merge),
        bounding the set of compiled program widths."""
        import time as _time

        C = self._chunk
        B = self.B
        staged = self._staged
        fn = fn if fn is not None else self._fn
        s1 = s2 = None
        if staged:
            s1, s2 = self._stage_fns_for(bool(ws_args))
        t = jnp.asarray(_time.time())
        pending = []
        i = 0
        while i < B:
            w = min(C, B - i)
            if w == C:
                args = tuple(a[i : i + C] for a in self._args)
                ws = tuple(a[i : i + C] for a in ws_args)
                wpad = C
            else:
                # tail chunk: pad to a power of two by repeating rows,
                # bounded by the chunk width (the floor of 256 bounds
                # the set of compiled shapes; a chunk narrower than
                # that caps the pad — the documented HBM bound is the
                # chunk width)
                wpad = min(C, max(256, 1 << int(w - 1).bit_length()))
                idx = jnp.asarray(np.resize(np.arange(i, i + w), wpad))
                args = tuple(a[idx] for a in self._args)
                ws = tuple(a[idx] for a in ws_args)
            if staged:
                outs, state = s1(*args, t, *ws)
                pending.append((i, w, wpad, args, ws, outs, state))
            else:
                outs = fn(*args, t, *ws)
                pending.append((i, w, wpad, args, ws, outs, None))
            i += w

        merged = None
        comp = {"chunks": len(pending), "remainder": 0,
                "stage1_iterations": 0}
        for (i, w, wpad, args, ws, outs, state) in pending:
            if staged:
                out, c = self._staged_resolve(
                    s2, t, args, wpad, outs, state, ws)
                comp["remainder"] += c["remainder"]
                comp["stage1_iterations"] = max(
                    comp["stage1_iterations"], c["stage1_iterations"])
            else:
                out = {k: np.array(v)
                       for k, v in jax.device_get(outs).items()}
            if merged is None:
                merged = {
                    k: np.empty((B,) + v.shape[1:], v.dtype)
                    for k, v in out.items()
                }
            for k, v in out.items():
                merged[k][i : i + w] = v[:w]
        self.last_compaction = comp if staged else {"chunks": len(pending)}
        return merged

    def solve(self, warm_start=None):
        """warm_start=(X, S, Z) with shapes (B, n), (B, m), (B, m) in
        the original problem space (e.g. stacked fields of the previous
        batch's solutions) seeds every problem's iterates — see
        Solver.solve(warm_start=...); symmetric-cone layouts only."""
        import time as _time

        ws_args = ()
        if warm_start is not None:
            from ..warmstart import validate_warm_start

            wx, ws, wz = validate_warm_start(
                self.layout, warm_start, self.n, self.m, batch=self.B
            )
            ws_args = (jnp.asarray(wx), jnp.asarray(ws), jnp.asarray(wz))

        if self._chunk:
            fn = self._fn
            if warm_start is not None and not self._staged:
                fn = make_batch_solve_fn(
                    self.layout, self.settings, self.n, self.m,
                    self._has_P,
                    _resolve_factor_dtype(self.settings, self.layout),
                    self._mesh_shape, warm=True,
                )
            out = self._solve_chunked(ws_args, fn)
        elif self._staged:
            out = self._solve_staged(ws_args)
        elif warm_start is not None:
            fn = make_batch_solve_fn(
                self.layout, self.settings, self.n, self.m, self._has_P,
                _resolve_factor_dtype(self.settings, self.layout),
                self._mesh_shape, warm=True,
            )
            out = jax.device_get(
                fn(*self._args, jnp.asarray(_time.time()), *ws_args)
            )
        else:
            out = jax.device_get(
                self._fn(*self._args, jnp.asarray(_time.time()))
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
