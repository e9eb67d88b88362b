"""Sparse KKT backend on device: assembly datamaps + multifrontal LDL^T.

The sparse analog of kkt/dense.py, mirroring the reference's sparse
pipeline: two-pass CSC assembly with structural diagonal
(`directldl_kkt_assembly.jl:15-175`), O(nnz) in-place value updates via
precomputed index maps (`directldl_datamaps.jl:170-213`), QDLDL-style
factorization with static + dynamic signed regularization
(`kktsolver_directldl.jl:247-310`, `directldl_qdldl.jl:18-25`) and
iterative refinement against the unregularized operator
(`kktsolver_directldl.jl:389-449`) — with the numeric factorization
running ON DEVICE as the level-scheduled batched multifrontal of
kkt/sparse_device.py.

Cone coverage: Zero/Nonnegative (diagonal Hs), SOC — dense blocks up
to dim 4, the rank-2 sparse expansion above (SOC_NO_EXPANSION_MAX_SIZE,
`cone_types.jl:65-119`; u/v columns + (-1,+1) extension diagonal per
`directldl_datamaps.jl:8-79`) — and exp/pow 3x3 blocks.  PSD and
GenPow (rank-3 expansion) remain dense-path-only for now.
"""

import dataclasses
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .sparse_device import (
    SparseDeviceLDL,
    _split_wide_supernodes,
    _value_permutation,
    build_numeric_plan,
    factor as mf_factor,
    solve as mf_solve,
)
from .sparse_symbolic import analyze, nested_dissection


def _inf_norm(v):
    return jnp.max(jnp.abs(v))


@dataclasses.dataclass
class SparseProblem:
    """Static sparsity metadata of one problem (host numpy only).

    P: upper-triangle COO of the objective (rows <= cols);
    A: COO of the constraint matrix."""

    n: int
    m: int
    P_rows: np.ndarray
    P_cols: np.ndarray
    A_rows: np.ndarray
    A_cols: np.ndarray
    # memo for make_sparse_kkt (symbolic analysis is the expensive
    # host step; the solver needs the result twice: once inside the
    # traced solve fn, once to stage the device buffers)
    _kkt_memo: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @classmethod
    def from_scipy(cls, P, A):
        import scipy.sparse as sp

        n = A.shape[1]
        m = A.shape[0]
        if P is not None:
            Pu = sp.triu(sp.csc_matrix(P)).tocoo()
            pr, pc = Pu.row.astype(np.int64), Pu.col.astype(np.int64)
        else:
            pr = pc = np.zeros(0, dtype=np.int64)
        Ac = sp.coo_matrix(A)
        return cls(n=n, m=m, P_rows=pr, P_cols=pc,
                   A_rows=Ac.row.astype(np.int64),
                   A_cols=Ac.col.astype(np.int64))

    def P_vals(self, P):
        import scipy.sparse as sp

        if P is None:
            return np.zeros(0)
        Pu = sp.triu(sp.csc_matrix(P)).tocoo()
        return np.asarray(Pu.data, dtype=np.float64)

    def A_vals(self, A):
        import scipy.sparse as sp

        return np.asarray(sp.coo_matrix(A).data, dtype=np.float64)


# Budget for a device that reports no memory statistics: the XLA:CPU
# backend (where the "device" is host RAM) and any other platform whose
# `memory_stats()` returns None or lacks "bytes_limit".
HOST_MEMORY_BUDGET = 8e9


def memory_budget_bytes(device=None) -> int:
    """Largest sparse plan estimate (SparseDeviceLDL.memory_estimate_bytes)
    allowed on `device` (default: the first device).

    CUCLARABEL_SPARSE_HBM_BUDGET (bytes) overrides it.  Otherwise it is a
    quarter of the device's allocator limit: XLA keeps about four live
    copies of a plan's buffers at peak, which the estimate cannot see.
    Devices without memory statistics get HOST_MEMORY_BUDGET."""
    env = os.environ.get("CUCLARABEL_SPARSE_HBM_BUDGET")
    if env is not None:
        return int(float(env))
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"]) // 4
    return int(HOST_MEMORY_BUDGET)


def make_sparse_kkt(n: int, m: int, settings, layout,
                    sp_prob: SparseProblem, max_width: int = 32):
    """(factorize, solve, host_bufs) over sparse values:

    factorize(Pv, Av, hs_diag, bufs) -> (fac, ok)
    solve(fac, rx, rz) -> (x, z, ok, nir)

    host_bufs: dict of numpy index arrays that the caller must place on
    device and pass through the jit boundary (baking them as constants
    OOMs the compiler at large N)."""
    memo_key = (settings, max_width)
    if memo_key in sp_prob._kkt_memo:
        return sp_prob._kkt_memo[memo_key]
    from ..cones import ops as cone_ops

    hs_plan = cone_ops.sparse_hs_plan(layout)
    nx = len(hs_plan["socx_rows"])       # expanded SOC count
    ngx = len(hs_plan["gpx_cone"])       # GenPow count (always expanded)
    N = n + m
    Next = N + 2 * nx + 3 * ngx
    eps_const = settings.static_regularization_constant
    eps_prop = settings.static_regularization_proportional
    reg_enable = settings.static_regularization_enable
    dyn_enable = settings.dynamic_regularization_enable
    dyn_eps = settings.dynamic_regularization_eps
    dyn_delta = settings.dynamic_regularization_delta
    ir_enable = settings.iterative_refinement_enable
    ir_reltol = settings.iterative_refinement_reltol
    ir_abstol = settings.iterative_refinement_abstol
    ir_maxiter = settings.iterative_refinement_max_iter
    ir_stopratio = settings.iterative_refinement_stop_ratio
    # sparse "auto" stays f64 (reference-accuracy parity);
    # "float32" is the explicit throughput knob, like the dense path
    factor_dtype = (
        jnp.float32
        if settings.kkt_factor_precision == "float32"
        else jnp.float64
    )

    # ---- K upper pattern + datamaps (host) --------------------------
    # entries: P upper at (i, j); A at (c, n + r); structural diagonal
    coords = {}

    def slot(i, j):
        key = (int(i), int(j))
        if key not in coords:
            coords[key] = len(coords)
        return coords[key]

    p_map = np.asarray(
        [slot(i, j) for i, j in zip(sp_prob.P_rows, sp_prob.P_cols)],
        dtype=np.int64,
    )
    a_map = np.asarray(
        [slot(c, n + r) for r, c in zip(sp_prob.A_rows, sp_prob.A_cols)],
        dtype=np.int64,
    )
    # Hs dense-block entries (small SOC + exp/pow 3x3)
    blk_map = np.asarray(
        [slot(n + i, n + j)
         for i, j in zip(hs_plan["blk_rows"], hs_plan["blk_cols"])],
        dtype=np.int64,
    )
    # SOC rank-2 expansion columns: v first, then u (datamaps order)
    xv_map, xu_map = [], []
    for t, rows in enumerate(hs_plan["socx_rows"]):
        vcol = N + 2 * t
        ucol = N + 2 * t + 1
        xv_map.extend(slot(n + int(r), vcol) for r in rows)
        xu_map.extend(slot(n + int(r), ucol) for r in rows)
    xv_map = np.asarray(xv_map, dtype=np.int64)
    xu_map = np.asarray(xu_map, dtype=np.int64)
    # GenPow rank-3 expansion: q (dim1 rows), r (dim2 rows), p (all)
    gq_map, gr_map, gp_map_ = [], [], []
    for t in range(ngx):
        qcol = N + 2 * nx + 3 * t
        rcol = qcol + 1
        pcol = qcol + 2
        r1 = hs_plan["gpx_rows1"][t]
        r2 = hs_plan["gpx_rows2"][t]
        gq_map.extend(slot(n + int(rr), qcol) for rr in r1)
        gr_map.extend(slot(n + int(rr), rcol) for rr in r2)
        gp_map_.extend(slot(n + int(rr), pcol) for rr in r1)
        gp_map_.extend(slot(n + int(rr), pcol) for rr in r2)
    gq_map = np.asarray(gq_map, dtype=np.int64)
    gr_map = np.asarray(gr_map, dtype=np.int64)
    gp_map_ = np.asarray(gp_map_, dtype=np.int64)
    diag_map = np.asarray(
        [slot(i, i) for i in range(Next)], dtype=np.int64
    )
    nnzK = len(coords)

    # CSC-ordered pattern + permutation of the temp slots
    items = sorted(coords.items(), key=lambda kv: (kv[0][1], kv[0][0]))
    reorder = np.zeros(nnzK, dtype=np.int64)
    for new, ((i, j), old) in enumerate(items):
        reorder[old] = new
    p_map = reorder[p_map] if p_map.size else p_map
    a_map = reorder[a_map]
    diag_map = reorder[diag_map]
    blk_map = reorder[blk_map] if blk_map.size else blk_map
    xv_map = reorder[xv_map] if xv_map.size else xv_map
    xu_map = reorder[xu_map] if xu_map.size else xu_map
    gq_map = reorder[gq_map] if gq_map.size else gq_map
    gr_map = reorder[gr_map] if gr_map.size else gr_map
    gp_map_ = reorder[gp_map_] if gp_map_.size else gp_map_
    rows_u = np.asarray([ij[0] for ij, _ in items], dtype=np.int64)
    cols_u = np.asarray([ij[1] for ij, _ in items], dtype=np.int64)
    Ap = np.zeros(Next + 1, dtype=np.int64)
    np.add.at(Ap, cols_u + 1, 1)
    Ap = np.cumsum(Ap)
    Ai = rows_u

    dsigns = np.concatenate([
        np.ones(n), -np.ones(m),
        np.tile([-1.0, 1.0], nx),        # SOC (v, u) extension signs
        np.tile([-1.0, -1.0, 1.0], ngx),  # GenPow (q, r, p) signs
    ])

    # symbolic plan with panel cap; nested-dissection ordering keeps
    # the elimination-tree chains (= level count = compile time and
    # sequential depth) short, at modestly higher fill than min-degree
    nd = nested_dissection(Next, Ap, Ai)
    sym = analyze(Next, Ap, Ai, order=nd)
    sym = _split_wide_supernodes(sym, max_width)
    plan = build_numeric_plan(sym, dsigns)
    kmap = _value_permutation(Next, Ap, Ai, sym)

    # device-memory guard: an oversized multifrontal plan is refused
    # here, before XLA tries (and fails) to allocate it
    fbytes = 4 if factor_dtype == jnp.float32 else 8
    est = plan.memory_estimate_bytes(len(coords), factor_bytes=fbytes)
    budget = memory_budget_bytes()
    if est > budget:
        raise MemoryError(
            f"sparse KKT plan needs ~{est/1e9:.2f} GB of device memory "
            f"(maps + value buffer + stacked fronts) > budget "
            f"{budget/1e9:.2f} GB; refusing the dispatch. Reduce the "
            "problem, improve the ordering, or raise "
            "CUCLARABEL_SPARSE_HBM_BUDGET if the device has headroom."
        )

    # full-pattern triplets for the refinement matvec (both triangles)
    off = rows_u != cols_u
    full_rows = np.concatenate([rows_u, cols_u[off]])
    full_cols = np.concatenate([cols_u, rows_u[off]])
    full_src = np.concatenate(
        [np.arange(nnzK, dtype=np.int64), np.nonzero(off)[0]]
    )

    host_bufs = plan.device_arrays()
    host_bufs.update({
        "blk_map": blk_map, "xv_map": xv_map, "xu_map": xu_map,
        "gq_map": gq_map, "gr_map": gr_map, "gp_map": gp_map_,
        "p_map": p_map, "a_map": a_map, "diag_map": diag_map,
        "kmap": kmap, "f_rows": full_rows, "f_cols": full_cols,
        "f_src": full_src, "dsigns": dsigns,
        # SpMV triplets for the loop's residual matvecs
        "pf_rows": np.concatenate(
            [sp_prob.P_rows,
             sp_prob.P_cols[sp_prob.P_rows != sp_prob.P_cols]]),
        "pf_cols": np.concatenate(
            [sp_prob.P_cols,
             sp_prob.P_rows[sp_prob.P_rows != sp_prob.P_cols]]),
        "pf_src": np.concatenate(
            [np.arange(sp_prob.P_rows.shape[0], dtype=np.int64),
             np.nonzero(sp_prob.P_rows != sp_prob.P_cols)[0]]),
        "a_rows": sp_prob.A_rows,
        "a_cols": sp_prob.A_cols,
    })

    def _kmv(fac, x):
        bufs = fac["bufs"]
        return jax.ops.segment_sum(
            fac["Kv"][bufs["f_src"]] * x[bufs["f_cols"]],
            bufs["f_rows"], num_segments=Next,
        )

    def factorize(Pv, Av, hs_parts, bufs):
        hs_diag, blk_vals, socx, gpx = hs_parts
        Kv = jnp.zeros(nnzK, dtype=jnp.float64)
        if p_map.size:
            Kv = Kv.at[bufs["p_map"]].add(Pv)
        Kv = Kv.at[bufs["a_map"]].add(Av)
        ext_parts = [t[2] for t in socx] + [t[3] for t in gpx]
        ext_diag = (
            jnp.concatenate(ext_parts) if ext_parts else jnp.zeros(0)
        )
        Kv = Kv.at[bufs["diag_map"]].add(
            jnp.concatenate([jnp.zeros(n), -hs_diag, ext_diag])
        )
        if blk_map.size:
            Kv = Kv.at[bufs["blk_map"]].add(-blk_vals)
        if socx:
            Kv = Kv.at[bufs["xu_map"]].add(
                jnp.concatenate([t[0] for t in socx])
            )
            Kv = Kv.at[bufs["xv_map"]].add(
                jnp.concatenate([t[1] for t in socx])
            )
        if gpx:
            Kv = Kv.at[bufs["gq_map"]].add(
                jnp.concatenate([t[0] for t in gpx])
            )
            Kv = Kv.at[bufs["gr_map"]].add(
                jnp.concatenate([t[1] for t in gpx])
            )
            Kv = Kv.at[bufs["gp_map"]].add(
                jnp.concatenate([t[2] for t in gpx])
            )
        if reg_enable:
            eps = eps_const + eps_prop * _inf_norm(Kv[bufs["diag_map"]])
            Kv_f = Kv.at[bufs["diag_map"]].add(bufs["dsigns"] * eps)
        else:
            Kv_f = Kv
        # kkt_factor_precision="float32" runs the fronts in f32;
        # residuals/refinement stay f64 against the f64 Kv
        # (mixed-precision architecture of the dense backend)
        fac_mf, ok = mf_factor(
            plan, Kv_f[bufs["kmap"]].astype(factor_dtype), bufs,
            reg_enable=dyn_enable, eps=dyn_eps, delta=dyn_delta,
        )
        return {"mf": fac_mf, "Kv": Kv, "bufs": bufs}, ok

    # nested jit: the level-walking solve chain is emitted ONCE and
    # shared by every call site (init, affine/combined steps, constant
    # rhs, refinement) — without it each site re-traces ~#levels * ops
    # and compile time explodes (measured 292 s at N=3201).  All sites
    # use identical shapes, so the one cached lowering serves them all.
    #
    # The chain is emitted 2-RHS wide (vmap over a trailing RHS axis):
    # the level schedule's sequential latency — the binding cost at
    # solve time — is paid once for both columns, so the constant-RHS
    # and affine systems of each IPM iteration solve in one walk
    # (solve.pair, mirroring the dense backend's kkt_solve.pair), and
    # single-RHS call sites ride column 0 with a zero pad at ~no extra
    # latency.  One lowered chain serves every site either way, so
    # compile cost stays flat.
    @jax.jit
    def _raw2(fac, bcols):
        # bcols (Next, 2) f64 -> (Next, 2)
        x = jax.vmap(
            lambda bv: mf_solve(plan, fac["mf"],
                                bv.astype(factor_dtype), fac["bufs"]),
            in_axes=1, out_axes=1,
        )(bcols)
        return x.astype(jnp.float64)

    def _raw(fac, bvec):
        return _raw2(fac, jnp.stack(
            [bvec, jnp.zeros_like(bvec)], axis=1))[:, 0]

    def _kmv2(fac, xcols):
        return jax.vmap(lambda xc: _kmv(fac, xc), in_axes=1,
                        out_axes=1)(xcols)

    def solve(fac, rx, rz) -> Tuple[jnp.ndarray, ...]:
        # extension rows carry zero RHS (kktsolver_directldl.jl:313-343)
        b = jnp.concatenate([rx, rz, jnp.zeros(2 * nx + 3 * ngx)])
        if not ir_enable:
            x = _raw(fac, b)
            return (x[:n], x[n: n + m], jnp.all(jnp.isfinite(x)),
                    jnp.asarray(0))

        normb = _inf_norm(b)
        tol = ir_abstol + ir_reltol * normb

        # The seed solve IS iteration 0 of the refinement loop
        # (x=0, e=b => dx = K^-1 b), forced accepted.  Emitting the
        # level-walking chain only inside the while body halves the
        # chain instances of the whole IPM program (each solve site
        # previously inlined it twice: seed + refinement body) — the
        # sparse path's compile-time driver (~76 -> ~40 while ops in
        # the N=3201 StableHLO).  Semantics identical to the
        # reference's seed-then-refine (kktsolver_directldl.jl:389-449):
        # same chain executions at runtime, same acceptance tests.
        x0 = jnp.zeros_like(b)

        def cond(c):
            _, _, norme, i, stop, ok = c
            return (i == 0) | (
                (~stop) & ok & (i < ir_maxiter + 1) & (norme > tol)
            )

        def body(c):
            xc, e, norme, i, _, _ = c
            first = i == 0
            dx = _raw(fac, e)
            xn = xc + dx
            en = b - _kmv(fac, xn)
            normen = _inf_norm(en)
            okn = jnp.isfinite(normen)
            ratio = norme / jnp.where(normen > 0, normen, 1e-300)
            accept = first | (ratio > 1.0)
            keep = first | (ratio > min(ir_stopratio, 1.2))
            return (
                jnp.where(accept, xn, xc),
                jnp.where(accept, en, e),
                jnp.where(accept, normen, norme),
                i + 1, ~keep, okn,
            )

        x, _, norme, nir, _, okr = jax.lax.while_loop(
            cond, body, (x0, b, normb, 0, False, jnp.asarray(True))
        )
        return x[:n], x[n: n + m], okr & jnp.isfinite(norme), nir - 1

    def solve_pair(fac, rx1, rz1, rx2, rz2):
        """Two refined solves against one factor in one level walk
        (see the dense backend's kkt_solve.pair; same per-RHS
        tolerance/acceptance semantics)."""
        zext = jnp.zeros(2 * nx + 3 * ngx)
        b1 = jnp.concatenate([rx1, rz1, zext])
        b2 = jnp.concatenate([rx2, rz2, zext])
        bs = jnp.stack([b1, b2], axis=1)  # (Next, 2)
        if not ir_enable:
            x = _raw2(fac, bs)
            ok = jnp.all(jnp.isfinite(x))
            return (x[:n, 0], x[n: n + m, 0], x[:n, 1], x[n: n + m, 1],
                    ok, jnp.asarray(0))

        normb = jnp.max(jnp.abs(bs), axis=0)  # (2,)
        tol = ir_abstol + ir_reltol * normb

        # seed solve folded into iteration 0 (see solve() above): both
        # columns are "live" and force-accepted on the first trip
        x0 = jnp.zeros_like(bs)

        def cond(c):
            _, _, norme, i, stop, ok = c
            live = (~stop) & ok & (norme > tol)
            return (i == 0) | ((i < ir_maxiter + 1) & jnp.any(live))

        def body(c):
            xc, e, norme, i, stop, okc = c
            first = i == 0
            live = first | ((~stop) & okc & (norme > tol))
            dx = _raw2(fac, e)
            xn = xc + dx
            en = bs - _kmv2(fac, xn)
            normen = jnp.max(jnp.abs(en), axis=0)
            okn = jnp.isfinite(normen)
            ratio = norme / jnp.where(normen > 0, normen, 1e-300)
            accept = live & (first | (ratio > 1.0))
            keep_going = live & (first | (ratio > min(ir_stopratio, 1.2)))
            am = accept[None, :]
            return (
                jnp.where(am, xn, xc),
                jnp.where(am, en, e),
                jnp.where(accept, normen, norme),
                i + 1,
                stop | ~keep_going,
                jnp.where(live, okn, okc),
            )

        stop0 = jnp.zeros(2, dtype=bool)
        x, _, norme, nir, _, okr = jax.lax.while_loop(
            cond, body,
            (x0, bs, normb, 0, stop0, jnp.ones(2, dtype=bool)),
        )
        ok = jnp.all(okr & jnp.isfinite(norme))
        return (x[:n, 0], x[n: n + m, 0], x[:n, 1], x[n: n + m, 1],
                ok, nir - 1)

    solve.pair = solve_pair
    # true structural factor size for the info surface (the reference
    # reports nnzL via linear_solver_info, directldl_defaults.jl:66-73)
    factorize.linear_solver_info = {
        "method": "multifrontal",
        "kkt_dim": int(Next),
        "nnzL": int(sum(
            w * (w + 1) // 2 + w * len(sym.sn_rows[s])
            for s in range(sym.ns)
            for w in (sym.front_width(s),)
        )),
        "supernodes": int(sym.ns),
        # scheduled (width-bucketed) level count — what the compiled
        # program walks; etree_levels is the raw etree depth
        "levels": int(plan.n_sched_levels),
        "etree_levels": len(sym.levels),
    }
    sp_prob._kkt_memo[memo_key] = (factorize, solve, host_bufs)
    return factorize, solve, host_bufs
