"""Block-arrow Schur-complement KKT backend: tensor-parallel by
construction (SURVEY.md §2.9(d)).

The reduced KKT system

    [ P   A' ] [x]   [rx]
    [ A  -Hs ] [z] = [rz]

is solved by eliminating every constraint row whose Hs contribution is
DIAGONAL, in parallel across a 'row' device mesh sharding the
constraint dimension m.  Non-diagonal structure is carried exactly,
never densified into the Schur complement:

* Nonnegative rows (Hs = w^2), the diagonal part of expanded
  second-order cones (Hs = eta^2(D + uu' - vv'), rank-2 expansion of
  coneops_socone.jl:125-151 / directldl_datamaps.jl:8-79), and the
  diagonal part of GenPow cones (Hs = mu(D + pp' - qq' - rr'),
  directldl_datamaps.jl:81-167) are ELIMINABLE: each device owns a row
  slab of A and the matching slice of the Hs diagonal, so forming
  A_el' D^{-1} A_el partitions across devices and combines with one
  psum into the replicated (n, n) Schur block S.

* The low-rank expansion vectors (u, v per big SOC; q, r, p per
  GenPow) become EXPLICIT saddle unknowns t with the same column
  values and extension-diagonal signs the sparse KKT assembly uses
  (kkt/sparse_kkt.py; reference Dsigns: SOC (v,u) -> (-1,+1), GenPow
  (q,r,p) -> (-1,-1,+1), directldl_kkt_assembly.jl:112-126 semantics).

* Zero-cone rows (Hs = 0: eliminating them through (eps I)^{-1} puts a
  1/eps A_eq'A_eq term into S that defeats fixed-order elimination)
  and rows of cones with small dense Hs blocks (SOC dim <= 4, exp/pow
  3x3) stay EXPLICIT with their -Hs blocks in the replicated saddle.

Eliminating the diagonal rows from the augmented quasidefinite system

    [ P    A_el'  A_ex'  0 ] [x   ]   [rx   ]
    [ A_el  -D     0     V ] [z_el ] = [rz_el]
    [ A_ex   0   -Hex    0 ] [z_ex]   [rz_ex]
    [ 0     V'    0      E ] [t   ]   [0    ]

leaves the replicated reduced saddle

    M = [ S    B    A_ex' ]      S = P + eps I + A_el' D^{-1} A_el
        [ B'   C     0    ]      B = A_el' D^{-1} V
        [ A_ex 0   -Hex   ]      C = E + V' D^{-1} V

which is a Schur complement of a quasidefinite matrix and therefore
factors pivot-free in any symmetric order (Vanderbei 1995); the SPD
block S leads for stability.  PSD cones ride the same explicit-row
path (their svec Hs blocks enter Hex like the exp/pow blocks); this
is exact but replicates O(svec dim) saddle rows per cone, so it pays
off for chordally-decomposed SDPs with small cliques.

Residual refinement against the full distributed augmented operator
restores reference accuracy (static-reg + refinement architecture,
kktsolver_directldl.jl:247-310, 389-449).
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .dense import pivotfree_inv


def _inf_norm(v):
    if v.size == 0:
        return jnp.asarray(0.0)
    return jnp.max(jnp.abs(v))


def make_arrow_kkt(n: int, m: int, settings, layout, mesh: Mesh,
                   axis: str = "row"):
    """(factorize, solve) with the structured-Hs interface, partitioned
    over `mesh` along `axis` (which shards the m constraint rows).

    `factorize(P, A, hs_parts)` takes the same (diag, blk_vals, socx,
    gpx) tuple as the sparse backends (cones/ops.py sparse_hs_values);
    the returned factorize carries `structured_hs = True` so the IPM
    loop selects that assembly."""
    ndev = mesh.shape[axis]
    if m % ndev != 0:
        raise ValueError(f"m={m} must divide the {ndev}-device mesh")
    m_loc = m // ndev

    from ..cones import ops as cone_ops

    plan = cone_ops.sparse_hs_plan(layout)
    nx = len(plan["socx_rows"])      # expanded SOC count
    ngx = len(plan["gpx_cone"])      # GenPow count (always expanded)
    nw = 2 * nx + 3 * ngx            # explicit low-rank saddle unknowns

    eps_const = settings.static_regularization_constant
    eps_prop = settings.static_regularization_proportional
    reg_enable = settings.static_regularization_enable
    ir_enable = settings.iterative_refinement_enable
    ir_reltol = settings.iterative_refinement_reltol
    ir_abstol = settings.iterative_refinement_abstol
    ir_maxiter = settings.iterative_refinement_max_iter
    ir_stopratio = settings.iterative_refinement_stop_ratio

    smap = partial(shard_map, mesh=mesh)
    rowmat = P(axis, None)
    rowvec = P(axis)
    repl = P()

    # ---- host row classification -----------------------------------
    # explicit rows: zero cones + rows of small dense Hs blocks
    ex_mask_np = np.asarray(layout.zero_mask, dtype=bool).copy()
    blk_rows = plan["blk_rows"]
    blk_cols = plan["blk_cols"]
    ex_mask_np[blk_rows] = True
    ex_mask_np[blk_cols] = True
    ex_idx_np = np.nonzero(ex_mask_np)[0]
    mex = int(ex_idx_np.shape[0])
    el_mask_np = (~ex_mask_np).astype(np.float64)
    # position of each explicit row inside the saddle's z_ex block
    ex_pos_np = np.zeros(m, dtype=np.int64)
    ex_pos_np[ex_idx_np] = np.arange(mex)

    # Hex scatter plan: blk entries have row <= col within each cone
    hex_i_np = ex_pos_np[blk_rows]
    hex_j_np = ex_pos_np[blk_cols]
    hex_off_np = np.nonzero(blk_rows != blk_cols)[0]

    # V scatter plan: per-SOC (v -> col 2t, u -> col 2t+1), per-GenPow
    # (q, r, p -> cols 2nx+3t+{0,1,2}); value order matches the
    # concatenation order used in _assemble_V below.
    v_r, v_c = [], []
    for t, rows in enumerate(plan["socx_rows"]):
        v_r.extend(int(r) for r in rows)   # v column
        v_c.extend([2 * t] * len(rows))
    for t, rows in enumerate(plan["socx_rows"]):
        v_r.extend(int(r) for r in rows)   # u column
        v_c.extend([2 * t + 1] * len(rows))
    for t in range(ngx):
        r1 = plan["gpx_rows1"][t]
        r2 = plan["gpx_rows2"][t]
        base = 2 * nx + 3 * t
        v_r.extend(int(r) for r in r1)     # q column (dim1 rows)
        v_c.extend([base] * len(r1))
        v_r.extend(int(r) for r in r2)     # r column (dim2 rows)
        v_c.extend([base + 1] * len(r2))
        v_r.extend(int(r) for r in r1)     # p column (all rows)
        v_c.extend([base + 2] * len(r1))
        v_r.extend(int(r) for r in r2)
        v_c.extend([base + 2] * len(r2))
    v_r_np = np.asarray(v_r, dtype=np.int64)
    v_c_np = np.asarray(v_c, dtype=np.int64)

    dsigns_ext_np = np.concatenate([
        np.tile([-1.0, 1.0], nx),          # SOC (v, u)
        np.tile([-1.0, -1.0, 1.0], ngx),   # GenPow (q, r, p)
    ]) if nw else np.zeros(0)

    def _assemble_V(socx, gpx):
        """(m, nw) expansion-column matrix from the per-cone scaled
        vectors (already carrying the -eta^2 / -sqrt(mu) K scaling)."""
        vals = []
        for t in socx:
            vals.append(t[1])              # v columns
        for t in socx:
            vals.append(t[0])              # u columns
        for t in gpx:
            vals.extend((t[0], t[1], t[2]))  # q, r, p
        V = jnp.zeros((m, nw))
        if vals:
            V = V.at[v_r_np, v_c_np].set(jnp.concatenate(vals))
        return V

    def _assemble_E(socx, gpx):
        parts = [t[2] for t in socx] + [t[3] for t in gpx]
        return jnp.concatenate(parts) if parts else jnp.zeros(0)

    def _assemble_Hex(blk_vals):
        Hex = jnp.zeros((mex, mex))
        if blk_vals.size:
            Hex = Hex.at[hex_i_np, hex_j_np].add(blk_vals)
            Hex = Hex.at[
                hex_j_np[hex_off_np], hex_i_np[hex_off_np]
            ].add(blk_vals[hex_off_np])
        return Hex

    def factorize(Pm, A, hs_parts):
        """Pm (n,n) replicated, A (m,n) row-sharded, hs_parts the
        structured (diag, blk_vals, socx, gpx) Hs tuple."""
        hs_diag, blk_vals, socx, gpx = hs_parts
        V = _assemble_V(socx, gpx)
        E = _assemble_E(socx, gpx)
        Hex = _assemble_Hex(blk_vals)

        if reg_enable:
            dmax = jnp.max(jnp.stack([
                _inf_norm(jnp.diagonal(Pm)),
                _inf_norm(hs_diag),
                _inf_norm(E),
                _inf_norm(jnp.diagonal(Hex)),
            ]))
            eps = eps_const + eps_prop * dmax
        else:
            # the elimination needs D invertible
            eps = jnp.asarray(eps_const)

        el_mask = jnp.asarray(el_mask_np)
        # masked reciprocal: explicit rows contribute nothing.  The
        # row-sharding constraint pins the eliminated-diagonal factor
        # to the mesh (tests assert it) instead of leaving the layout
        # to GSPMD inference.
        dinv = jax.lax.with_sharding_constraint(
            el_mask / (hs_diag + eps), NamedSharding(mesh, rowvec)
        )

        def local(A_d, V_d, dinv_d):
            AtD = A_d.T * dinv_d          # (n, m_loc)
            Spart = AtD @ A_d
            Bpart = AtD @ V_d
            Cpart = (V_d.T * dinv_d) @ V_d
            return (
                jax.lax.psum(Spart, axis),
                jax.lax.psum(Bpart, axis),
                jax.lax.psum(Cpart, axis),
            )

        S0, B, C0 = smap(
            local,
            in_specs=(rowmat, rowmat, rowvec),
            out_specs=(repl, repl, repl),
        )(A, V, dinv)

        S = Pm + eps * jnp.eye(n) + S0
        C = C0 + jnp.diag(E + jnp.asarray(dsigns_ext_np) * eps) \
            if nw else jnp.zeros((0, 0))

        if mex:
            Aex = A[jnp.asarray(ex_idx_np)]   # (mex, n) replicated gather
            Hex_reg = Hex + eps * jnp.eye(mex)
        else:
            Aex = jnp.zeros((0, n))
            Hex_reg = jnp.zeros((0, 0))

        # replicated reduced saddle, SPD block leading
        M = jnp.block([
            [S, B, Aex.T],
            [B.T, C, jnp.zeros((nw, mex))],
            [Aex, jnp.zeros((mex, nw)), -Hex_reg],
        ]) if (nw or mex) else S
        Kinv = pivotfree_inv(M)
        ok = jnp.all(jnp.isfinite(Kinv)) & jnp.all(jnp.isfinite(dinv))
        return {
            "Kinv": Kinv, "A": A, "dinv": dinv, "hs_diag": hs_diag,
            "V": V, "E": E, "Hex": Hex, "Pm": Pm,
        }, ok

    factorize.structured_hs = True

    def _raw_solve(fac, rx, rz, rt=None):
        """One augmented-saddle solve; returns (x, z, t).  `rt` is the
        extension-row RHS (zero on primary solves, the ext residual on
        refinement corrections)."""
        def local_fwd(A_d, V_d, dinv_d, rz_d):
            w_d = dinv_d * rz_d
            return (
                jax.lax.psum(A_d.T @ w_d, axis),
                jax.lax.psum(V_d.T @ w_d, axis) if nw
                else jnp.zeros(nw),
            )

        atw, vtw = smap(
            local_fwd,
            in_specs=(rowmat, rowmat, rowvec, rowvec),
            out_specs=(repl, repl),
        )(fac["A"], fac["V"], fac["dinv"], rz)

        if rt is not None:
            vtw = vtw + rt
        rhs = jnp.concatenate([rx + atw, vtw, rz[jnp.asarray(ex_idx_np)]]) \
            if (nw or mex) else rx + atw
        sol = fac["Kinv"] @ rhs
        x = sol[:n]
        t = sol[n:n + nw]
        z_ex = sol[n + nw:]

        # scatter explicit duals back into z-vector positions
        zex_full = (
            jnp.pad(z_ex, (0, 1))[jnp.asarray(ex_pos_np)]
            if mex else jnp.zeros(m)
        )
        el_mask = jnp.asarray(el_mask_np)

        def local_bwd(A_d, V_d, dinv_d, rz_d, zexf_d, elm_d, x, t):
            z_el = dinv_d * (A_d @ x + (V_d @ t if nw else 0.0) - rz_d)
            return z_el * elm_d + zexf_d * (1.0 - elm_d)

        z = smap(
            lambda A_d, V_d, dinv_d, rz_d, zexf_d, elm_d: local_bwd(
                A_d, V_d, dinv_d, rz_d, zexf_d, elm_d, x, t
            ),
            in_specs=(rowmat, rowmat, rowvec, rowvec, rowvec, rowvec),
            out_specs=rowvec,
        )(fac["A"], fac["V"], fac["dinv"], rz, zex_full, el_mask)
        return x, z, t

    def _kkt_matvec(fac, x, z, t):
        """Distributed UNregularized augmented operator applied to
        (x, z, t): returns (top, bot, ext) residue components."""
        el_mask = jnp.asarray(el_mask_np)
        if mex:
            hz_ex = fac["Hex"] @ z[jnp.asarray(ex_idx_np)]
            hz_full = jnp.pad(hz_ex, (0, 1))[jnp.asarray(ex_pos_np)]
        else:
            hz_full = jnp.zeros(m)

        def local(A_d, V_d, hsd_d, z_d, hzf_d, elm_d, x, t):
            top_p = jax.lax.psum(A_d.T @ z_d, axis)
            hz_d = elm_d * hsd_d * z_d + (1.0 - elm_d) * hzf_d
            bot_d = A_d @ x - hz_d + (V_d @ t if nw else 0.0)
            ext_p = (
                jax.lax.psum(V_d.T @ (z_d * elm_d), axis) if nw
                else jnp.zeros(nw)
            )
            return top_p, bot_d, ext_p

        top0, bot, ext0 = smap(
            lambda A_d, V_d, hsd_d, z_d, hzf_d, elm_d: local(
                A_d, V_d, hsd_d, z_d, hzf_d, elm_d, x, t
            ),
            in_specs=(rowmat, rowmat, rowvec, rowvec, rowvec, rowvec),
            out_specs=(repl, rowvec, repl),
        )(fac["A"], fac["V"], fac["hs_diag"], z, hz_full, el_mask)
        top = fac["Pm"] @ x + top0
        ext = ext0 + fac["E"] * t if nw else jnp.zeros(0)
        return top, bot, ext

    def solve(fac, rx, rz) -> Tuple[jnp.ndarray, ...]:
        x, z, t = _raw_solve(fac, rx, rz)
        if not ir_enable:
            ok = jnp.all(jnp.isfinite(x)) & jnp.all(jnp.isfinite(z))
            return x, z, ok, jnp.asarray(0)

        normb = jnp.maximum(_inf_norm(rx), _inf_norm(rz))
        tol = ir_abstol + ir_reltol * normb

        def residual(x, z, t):
            tx, tz, tt = _kkt_matvec(fac, x, z, t)
            return rx - tx, rz - tz, -tt

        def errnorm(ex, ez, et):
            return jnp.max(jnp.stack([
                _inf_norm(ex), _inf_norm(ez), _inf_norm(et),
            ]))

        ex0, ez0, et0 = residual(x, z, t)
        norme0 = errnorm(ex0, ez0, et0)
        ok0 = jnp.isfinite(norme0)

        def cond(c):
            _, _, _, _, _, _, norme, i, stop, ok = c
            return (~stop) & ok & (i < ir_maxiter) & (norme > tol)

        def body(c):
            x, z, t, ex, ez, et, norme, i, _, _ = c
            dx, dz, dt = _raw_solve(fac, ex, ez, et)
            xn, zn, tn = x + dx, z + dz, t + dt
            exn, ezn, etn = residual(xn, zn, tn)
            normen = errnorm(exn, ezn, etn)
            okn = jnp.isfinite(normen)
            ratio = norme / jnp.where(normen > 0, normen, 1e-300)
            accept = ratio > 1.0
            keep = ratio > min(ir_stopratio, 1.2)
            pick = lambda a, b_: jnp.where(accept, a, b_)
            return (
                pick(xn, x), pick(zn, z), pick(tn, t),
                pick(exn, ex), pick(ezn, ez), pick(etn, et),
                pick(normen, norme), i + 1, ~keep, okn,
            )

        x, z, t, _, _, _, norme, nir, _, ok = jax.lax.while_loop(
            cond, body,
            (x, z, t, ex0, ez0, et0, norme0, 0, False, ok0),
        )
        return x, z, ok & jnp.isfinite(norme), nir

    return factorize, solve
