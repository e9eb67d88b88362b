"""Vectorized cone operations on flat device arrays.

This is the vectorized equivalent of the reference's cone-ops trait and
its per-cone loop dispatch (`src/cones/coneops_defaults.jl`,
`coneops_compositecone.jl`).  Instead of looping over cone objects, each
cone *type group* runs as one fused kernel:

  * zero / nonnegative cones: masked elementwise ops on the (m,) vector
    (behavioral parity with coneops_zerocone.jl / coneops_nncone.jl);
  * second-order cones: segment-sum reductions over a gathered subvector
    (parity with coneops_socone.jl, incl. the ECOS-style fast W products
    and the Goldberg-safe step-length quadratic);
  * exponential / power / genpower / PSD: see exp.py / pow.py /
    genpow.py / psd.py — dispatched from the composite entry points here.

Scaling state is a flat dict-of-arrays pytree (`ScalingState`), carried
through the jitted IPM loop.

All functions are pure; `pd` (primal/dual) and the layout are static.
"""

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .layout import ConeLayout

FMAX = float(np.finfo(np.float64).max)
EPS = float(np.finfo(np.float64).eps)

PRIMAL = 0
DUAL = 1

ScalingState = Dict[str, jnp.ndarray]


def _safe(x):
    """Guard a strictly-positive denominator (result is discarded via
    `where` whenever the guard fails)."""
    return jnp.where(x > 0, x, 1.0)


def _safe_nonzero(x):
    return jnp.where(x != 0, x, 1.0)


def _logsafe(v):
    """log with -inf-ish for nonpositive args (mathutils.jl:12-18)."""
    return jnp.where(v > 0, jnp.log(jnp.where(v > 0, v, 1.0)), -FMAX)


# ---------------------------------------------------------------------------
# SOC segment helpers.  All take the *gathered* (msoc,) arrays.
# ---------------------------------------------------------------------------


def _seg_sum(layout: ConeLayout, vals):
    return jax.ops.segment_sum(
        vals, layout.soc_seg, num_segments=layout.nsoc, indices_are_sorted=True
    )


def _soc_tail_sumsq(layout, vg):
    return _seg_sum(layout, jnp.where(layout.soc_is_head, 0.0, vg * vg))


def _soc_tail_dot(layout, ug, vg):
    return _seg_sum(layout, jnp.where(layout.soc_is_head, 0.0, ug * vg))


def _soc_full_dot(layout, ug, vg):
    return _seg_sum(layout, ug * vg)


def _soc_residual(layout, vg):
    """Per-cone v0^2 - ||v_tail||^2, computed as (v0-t)(v0+t) for
    cancellation safety (coneops_socone.jl:415-419). Returns
    (res, v0, tailnorm)."""
    v0 = vg[layout.soc_headpos]
    t = jnp.sqrt(_soc_tail_sumsq(layout, vg))
    return (v0 - t) * (v0 + t), v0, t


def _soc_mul_W(layout, eta, wg, xg):
    """y = W x via the ECOS fast product (coneops_socone.jl:313-333)."""
    w0 = wg[layout.soc_headpos]
    x0 = xg[layout.soc_headpos]
    zeta = _soc_tail_dot(layout, wg, xg)
    c = x0 + zeta / (1.0 + w0)
    seg = layout.soc_seg
    yg = eta[seg] * (xg + c[seg] * wg)
    y0 = eta * (w0 * x0 + zeta)
    return yg.at[layout.soc_headpos].set(y0)


def _soc_mul_Winv(layout, eta, wg, xg):
    """y = W^{-1} x (coneops_socone.jl:336-357)."""
    w0 = wg[layout.soc_headpos]
    x0 = xg[layout.soc_headpos]
    zeta = _soc_tail_dot(layout, wg, xg)
    c = -x0 + zeta / (1.0 + w0)
    etainv = 1.0 / eta
    seg = layout.soc_seg
    yg = etainv[seg] * (xg + c[seg] * wg)
    y0 = etainv * (w0 * x0 - zeta)
    return yg.at[layout.soc_headpos].set(y0)


def _soc_circ(layout, ug, vg):
    """Jordan product x = u o v (coneops_socone.jl:376-391)."""
    u0 = ug[layout.soc_headpos]
    v0 = vg[layout.soc_headpos]
    full = _soc_full_dot(layout, ug, vg)
    seg = layout.soc_seg
    xg = u0[seg] * vg + v0[seg] * ug
    return xg.at[layout.soc_headpos].set(full)


# ---------------------------------------------------------------------------
# initialization / margins / shifts
# ---------------------------------------------------------------------------


def unit_initialization(layout: ConeLayout):
    """Unit (central-ray) initialization of (z, s) for nonsymmetric
    problems.  zero: 0; NN: 1; SOC: e1 (coneops_*:unit_initialization!);
    exp/pow/genpow: cone-specific interior points."""
    z = jnp.zeros(layout.m)
    s = jnp.zeros(layout.m)
    if layout.has_nn:
        z = jnp.where(layout.nn_mask, 1.0, z)
        s = jnp.where(layout.nn_mask, 1.0, s)
    if layout.has_soc:
        z = z.at[layout.soc_head_full].set(1.0)
        s = s.at[layout.soc_head_full].set(1.0)
    if layout.has_exp:
        from . import exp as expcone

        z = z.at[layout.exp_idx].set(expcone.UNIT_DUAL)
        s = s.at[layout.exp_idx].set(expcone.UNIT_PRIMAL)
    if layout.has_pow:
        from . import pow as powcone

        zp, sp = powcone.unit_init(layout)
        z = z.at[layout.pow_idx].set(zp)
        s = s.at[layout.pow_idx].set(sp)
    if layout.has_genpow:
        from . import genpow as gpcone

        z, s = gpcone.unit_init(layout, z, s)
    if layout.has_psd:
        # svec identity: 1.0 on the diagonal entries
        from . import psd as psdcone

        z, s = psdcone.unit_init(layout, z, s)
    return z, s


def margins(layout: ConeLayout, z, pd: int):
    """(min_margin, total_positive_margin) across all cones
    (coneops_compositecone.jl:49-63).  Only called for symmetric
    problems."""
    alpha = jnp.asarray(FMAX)
    beta = jnp.asarray(0.0)
    if layout.has_nn:
        zn = jnp.where(layout.nn_mask, z, FMAX)
        alpha = jnp.minimum(alpha, jnp.min(zn))
        beta = beta + jnp.sum(jnp.where(layout.nn_mask & (z > 0), z, 0.0))
    if layout.has_soc:
        zg = z[layout.soc_idx]
        _, z0, t = _soc_residual(layout, zg)
        am = z0 - t
        alpha = jnp.minimum(alpha, jnp.min(am))
        beta = beta + jnp.sum(jnp.maximum(am, 0.0))
    if layout.has_psd:
        from . import psd as psdcone

        a_p, b_p = psdcone.margins(layout, z)
        alpha = jnp.minimum(alpha, a_p)
        beta = beta + b_p
    # zero cone contributes (FMAX, 0) (coneops_zerocone.jl:27-39)
    return alpha, beta


def scaled_unit_shift(layout: ConeLayout, z, alpha, pd: int):
    """z += alpha * e per cone; the zero cone is *zeroed* when shifting
    primal vectors (coneops_zerocone.jl:42-55)."""
    if layout.has_nn:
        z = jnp.where(layout.nn_mask, z + alpha, z)
    if layout.has_soc:
        z = z.at[layout.soc_head_full].add(alpha)
    if layout.has_psd:
        from . import psd as psdcone

        z = psdcone.scaled_unit_shift(layout, z, alpha)
    if layout.has_zero and pd == PRIMAL:
        z = jnp.where(layout.zero_mask, 0.0, z)
    return z


def shift_to_cone_interior(layout: ConeLayout, z, pd: int):
    """Two-stage interior shift used by symmetric initialization
    (variables.jl:180-208)."""
    min_margin, pos_margin = margins(layout, z, pd)
    deg = max(layout.degree, 1)
    target = jnp.maximum(1.0, 0.1 * pos_margin / deg)

    # branchless composition of the three cases
    z_neg = scaled_unit_shift(layout, z, -min_margin, pd)
    z_neg = scaled_unit_shift(layout, z_neg, target, pd)
    z_small = scaled_unit_shift(layout, z, target - min_margin, pd)
    z_ok = scaled_unit_shift(layout, z, 0.0, pd)

    cond_neg = min_margin <= 0
    cond_small = (~cond_neg) & (min_margin < target)
    out = jnp.where(cond_neg, z_neg, jnp.where(cond_small, z_small, z_ok))
    return out


# ---------------------------------------------------------------------------
# scaling updates
# ---------------------------------------------------------------------------


def set_identity_scaling(layout: ConeLayout) -> ScalingState:
    """W = I scaling used to produce the symmetric initial point
    (solver.jl:388-396)."""
    state: ScalingState = {}
    if layout.has_nn:
        state["nn_w"] = jnp.where(layout.nn_mask, 1.0, 0.0)
        state["nn_lam"] = jnp.where(layout.nn_mask, 1.0, 0.0)
    if layout.has_soc:
        e1 = jnp.where(layout.soc_is_head, 1.0, 0.0)
        state["soc_w"] = e1
        state["soc_lam"] = e1
        state["soc_eta"] = jnp.ones(layout.nsoc)
    if layout.has_psd:
        from . import psd as psdcone

        state.update(psdcone.identity_scaling(layout))
    # nonsymmetric cones never use identity scaling (asym init path)
    if layout.has_exp:
        from . import exp as expcone

        state.update(expcone.zero_scaling(layout))
    if layout.has_pow:
        from . import pow as powcone

        state.update(powcone.zero_scaling(layout))
    if layout.has_genpow:
        from . import genpow as gpcone

        state.update(gpcone.zero_scaling(layout))
    return state


def update_scaling(
    layout: ConeLayout, s, z, mu, scaling_flag
) -> Tuple[ScalingState, jnp.ndarray]:
    """Update all cone scalings at the current iterate.  Returns
    (state, ok) where ok is a scalar bool; parity with
    update_scaling! (coneops_compositecone.jl:103-120)."""
    state: ScalingState = {}
    ok = jnp.asarray(True)

    if layout.has_nn:
        sv = jnp.where(layout.nn_mask, s, 1.0)
        zv = jnp.where(layout.nn_mask, z, 1.0)
        # interior check: NN scaling fails only through nonfinite sqrt;
        # the reference relies on sqrt(neg)=NaN surfacing in the KKT solve.
        # We fail fast instead when s,z leave the cone.
        ok = ok & jnp.all((sv > 0) & (zv > 0))
        sz = jnp.maximum(sv * zv, 0.0)
        ratio = jnp.maximum(sv / zv, 0.0)
        state["nn_lam"] = jnp.where(layout.nn_mask, jnp.sqrt(sz), 0.0)
        state["nn_w"] = jnp.where(layout.nn_mask, jnp.sqrt(ratio), 0.0)

    if layout.has_soc:
        sg = s[layout.soc_idx]
        zg = z[layout.soc_idx]
        zres, z0, _ = _soc_residual(layout, zg)
        sres, s0, _ = _soc_residual(layout, sg)
        ok_soc = (zres > 0) & (sres > 0)
        zscale = jnp.sqrt(jnp.maximum(zres, 0.0))
        sscale = jnp.sqrt(jnp.maximum(sres, 0.0))
        zs = _safe(zscale)
        ss = _safe(sscale)
        eta = jnp.sqrt(ss / zs)

        seg = layout.soc_seg
        w = sg / ss[seg] + layout.soc_sign * zg / zs[seg]
        wres, _, _ = _soc_residual(layout, w)
        ok_soc = ok_soc & (wres > 0)
        wscale = jnp.sqrt(jnp.maximum(wres, 0.0))
        w = w / _safe(wscale)[seg]
        # force normalization of the head (coneops_socone.jl:111-113)
        w1sq = _soc_tail_sumsq(layout, w)
        w = w.at[layout.soc_headpos].set(jnp.sqrt(1.0 + w1sq))

        # scaling point lambda (coneops_socone.jl:115-123)
        gamma = 0.5 * wscale
        s0n = s0 / ss
        z0n = z0 / zs
        coef_s = (gamma + z0n) / ss
        coef_z = (gamma + s0n) / zs
        denom = _safe(s0n + z0n + 2.0 * gamma)
        lam = (coef_s[seg] * sg + coef_z[seg] * zg) / denom[seg]
        lam = lam.at[layout.soc_headpos].set(gamma)
        lam = lam * jnp.sqrt(ss * zs)[seg]

        state["soc_w"] = w
        state["soc_lam"] = lam
        state["soc_eta"] = eta
        ok = ok & jnp.all(ok_soc)

    if layout.has_psd:
        from . import psd as psdcone

        st, okp = psdcone.update_scaling(layout, s, z)
        state.update(st)
        ok = ok & okp

    if layout.has_exp:
        from . import exp as expcone

        st, oke = expcone.update_scaling(layout, s, z, mu, scaling_flag)
        state.update(st)
        ok = ok & oke

    if layout.has_pow:
        from . import pow as powcone

        st, okp = powcone.update_scaling(layout, s, z, mu, scaling_flag)
        state.update(st)
        ok = ok & okp

    if layout.has_genpow:
        from . import genpow as gpcone

        st, okg = gpcone.update_scaling(layout, s, z, mu)
        state.update(st)
        ok = ok & okg

    return state, ok


# ---------------------------------------------------------------------------
# Hs assembly / products
# ---------------------------------------------------------------------------


def hs_is_diagonal(layout: ConeLayout) -> bool:
    """True when every cone's Hs block is diagonal (Zero/Nonnegative
    only) — the sparse KKT path's v1 requirement (Hs_is_diagonal,
    coneops_defaults.jl semantics)."""
    return not (
        layout.has_soc or layout.has_psd or layout.has_exp
        or layout.has_pow or layout.has_genpow
    )


def assemble_Hs_diag(layout: ConeLayout, state: ScalingState):
    """Diagonal of Hs for diagonal-only layouts (sparse KKT backend).
    NN: w^2 (coneops_nncone.jl get_Hs!); Zero: 0."""
    if not hs_is_diagonal(layout):
        raise ValueError("assemble_Hs_diag needs a Zero/NN-only layout")
    diag = jnp.zeros(layout.m)
    if layout.has_nn:
        diag = jnp.where(layout.nn_mask, state["nn_w"] ** 2, diag)
    return diag


SOC_NO_EXPANSION_MAX_SIZE = 4  # cone_types.jl:65-119


def sparse_hs_plan(layout: ConeLayout):
    """Host-side static plan for sparse-KKT Hs assembly
    (kkt/sparse_kkt.py): coordinates of every Hs entry in the z block
    plus the gather indices needed to compute its value each iteration.

    Returns numpy dict:
      blk_rows/blk_cols: (r,) z-block coordinates (row <= col) of the
        dense-block entries — small SOC blocks, exp/pow 3x3 blocks and
        PSD svec blocks — ordered [small SOCs (cone, col-major upper)]
        ++ [exp] ++ [pow] ++ [PSD groups by side length];
      soc_small_*: gather plans for the SOC entries;
      socx_*: per EXPANDED SOC (dim > 4): member rows, flat w range;
    Value convention: values are the raw Hs entries; the assembly
    negates them (K z-block is -Hs), mirroring the diagonal path."""
    import numpy as np_

    blk_rows, blk_cols = [], []
    s_gi, s_gj, s_cone, s_sign = [], [], [], []
    socx_rows, socx_wpos, socx_cone = [], [], []
    if layout.has_soc:
        pos = 0
        for c in range(layout.nsoc):
            d = int(layout.soc_dims[c])
            rows = layout.soc_idx[pos: pos + d]
            if d <= SOC_NO_EXPANSION_MAX_SIZE:
                for j in range(d):
                    for i in range(j + 1):
                        blk_rows.append(int(rows[i]))
                        blk_cols.append(int(rows[j]))
                        s_gi.append(pos + i)
                        s_gj.append(pos + j)
                        s_cone.append(c)
                        s_sign.append(
                            0.0 if i != j else (1.0 if i == 0 else -1.0)
                        )
            else:
                socx_rows.append(np_.asarray(rows, dtype=np_.int64))
                socx_wpos.append((pos, pos + d))
                socx_cone.append(c)
            pos += d
    n_small = len(blk_rows)

    e_cone, e_a, e_b = [], [], []
    if layout.has_exp:
        for c in range(layout.nexp):
            rows = layout.exp_idx[c]
            for j in range(3):
                for i in range(j + 1):
                    blk_rows.append(int(rows[i]))
                    blk_cols.append(int(rows[j]))
                    e_cone.append(c)
                    e_a.append(i)
                    e_b.append(j)
    n_exp = len(blk_rows) - n_small
    p_cone, p_a, p_b = [], [], []
    if layout.has_pow:
        for c in range(layout.npow):
            rows = layout.pow_idx[c]
            for j in range(3):
                for i in range(j + 1):
                    blk_rows.append(int(rows[i]))
                    blk_cols.append(int(rows[j]))
                    p_cone.append(c)
                    p_a.append(i)
                    p_b.append(j)

    # PSD svec blocks (Hs = skron(RR'), dense (sd, sd) per cone): the
    # sparse path carries them exactly like the exp/pow blocks, which
    # is what makes chordally-decomposed SDPs (many small cliques)
    # sparse-KKT-able (reference: any Hs block enters the triu
    # assembly, directldl_kkt_assembly.jl:15-175)
    psd_groups_plan = []
    if layout.has_psd:
        for r in sorted(layout.psd_groups):
            idx = layout.psd_groups[r]
            k, sd = idx.shape
            a_ut, b_ut = [], []
            for jj in range(sd):
                for ii in range(jj + 1):
                    a_ut.append(ii)
                    b_ut.append(jj)
            a_ut = np_.asarray(a_ut, dtype=np_.int64)
            b_ut = np_.asarray(b_ut, dtype=np_.int64)
            for c in range(k):
                rows = idx[c]
                blk_rows.extend(int(rows[i]) for i in a_ut)
                blk_cols.extend(int(rows[j]) for j in b_ut)
            psd_groups_plan.append((
                r,
                np_.repeat(np_.arange(k), a_ut.shape[0]),
                np_.tile(a_ut, k),
                np_.tile(b_ut, k),
            ))

    gpx_rows1, gpx_rows2, gpx_cone = [], [], []
    if layout.has_genpow:
        for c in range(layout.ngp):
            d1 = int(layout.gp_dim1[c])
            rows1 = layout.gp_idx1[c, :d1].astype(np_.int64)
            mask2 = layout.gp_mask2[c]
            rows2 = layout.gp_idx2[c][mask2].astype(np_.int64)
            gpx_rows1.append(rows1)
            gpx_rows2.append(rows2)
            gpx_cone.append(c)

    ii = np_.asarray
    return {
        "blk_rows": ii(blk_rows, dtype=np_.int64),
        "blk_cols": ii(blk_cols, dtype=np_.int64),
        "soc_gi": ii(s_gi, dtype=np_.int64),
        "soc_gj": ii(s_gj, dtype=np_.int64),
        "soc_cone": ii(s_cone, dtype=np_.int64),
        "soc_sign": ii(s_sign, dtype=np_.float64),
        "exp_cone": ii(e_cone, dtype=np_.int64),
        "exp_a": ii(e_a, dtype=np_.int64),
        "exp_b": ii(e_b, dtype=np_.int64),
        "pow_cone": ii(p_cone, dtype=np_.int64),
        "pow_a": ii(p_a, dtype=np_.int64),
        "pow_b": ii(p_b, dtype=np_.int64),
        "psd_groups": psd_groups_plan,
        "socx_rows": socx_rows,
        "socx_wpos": socx_wpos,
        "socx_cone": ii(socx_cone, dtype=np_.int64),
        "gpx_rows1": gpx_rows1,
        "gpx_rows2": gpx_rows2,
        "gpx_cone": ii(gpx_cone, dtype=np_.int64),
    }


def sparse_hs_values(layout: ConeLayout, state: ScalingState, plan):
    """Per-iteration Hs values matching sparse_hs_plan's ordering.

    Returns (diag, blk_vals, socx) where:
      diag (m,): elementwise Hs diagonal — NN w^2 plus, on EXPANDED SOC
        rows, eta^2 * Dtilde (rank-2 form WtW = eta^2(Dt + uu' - vv'),
        coneops_socone.jl:125-151);
      blk_vals: raw Hs entries at (blk_rows, blk_cols);
      socx: per expanded cone (u_scaled, v_scaled, ext_diag(2,)) with
        the -eta^2 scaling of directldl_datamaps.jl:61-79 applied;
      gpx: per GenPow cone (q, r, p, ext_diag(3,)) scaled by -sqrt(mu)
        with ext diag (-1,-1,+1) (directldl_datamaps.jl:81-167)."""
    diag = jnp.zeros(layout.m)
    if layout.has_nn:
        diag = jnp.where(layout.nn_mask, state["nn_w"] ** 2, diag)

    vals = []
    if plan["soc_gi"].size:
        eta2 = state["soc_eta"] ** 2
        w = state["soc_w"]
        v = (
            2.0 * eta2[plan["soc_cone"]] * w[plan["soc_gi"]]
            * w[plan["soc_gj"]]
            - eta2[plan["soc_cone"]] * plan["soc_sign"]
        )
        vals.append(v)
    if plan["exp_cone"].size:
        vals.append(
            state["exp_Hs"][plan["exp_cone"], plan["exp_a"], plan["exp_b"]]
        )
    if plan["pow_cone"].size:
        vals.append(
            state["pow_Hs"][plan["pow_cone"], plan["pow_a"], plan["pow_b"]]
        )
    if plan["psd_groups"]:
        from . import psd as psdcone

        for r, cone_rep, a_t, b_t in plan["psd_groups"]:
            R = state[f"psd{r}_R"]
            RRt = R @ jnp.swapaxes(R, 1, 2)
            Hs_g = psdcone._skron(RRt, r)
            vals.append(Hs_g[cone_rep, a_t, b_t])
    blk_vals = (
        jnp.concatenate(vals) if vals else jnp.zeros(0)
    )

    if layout.has_genpow:
        mu = state["gp_mu"]
        d1v = mu * state["gp_d1"]
        d2v = mu * state["gp_d2"]
        for t, c in enumerate(plan["gpx_cone"]):
            r1 = plan["gpx_rows1"][t]
            r2 = plan["gpx_rows2"][t]
            diag = diag.at[r1].add(d1v[c, : r1.shape[0]])
            diag = diag.at[r2].add(
                jnp.full(r2.shape[0], d2v[c])
            )

    gpx = []
    if layout.has_genpow:
        smu = jnp.sqrt(state["gp_mu"])
        for t, c in enumerate(plan["gpx_cone"]):
            nd1 = plan["gpx_rows1"][t].shape[0]
            nd2 = plan["gpx_rows2"][t].shape[0]
            qv = -smu * state["gp_q"][c, :nd1]
            rv = -smu * state["gp_r"][c, :nd2]
            pv = -smu * jnp.concatenate(
                [state["gp_p1"][c, :nd1], state["gp_p2"][c, :nd2]]
            )
            gpx.append((qv, rv, pv,
                        jnp.asarray([-1.0, -1.0, 1.0])))

    socx = []
    for rows, (lo, hi), c in zip(
        plan["socx_rows"], plan["socx_wpos"], plan["socx_cone"]
    ):
        eta2 = state["soc_eta"][c] ** 2
        wbar = state["soc_w"][lo:hi]
        wsq = jnp.sum(wbar * wbar)
        dsc = 0.5 / wsq
        u0 = jnp.sqrt(wsq - dsc)
        u1 = 2.0 * wbar[0] / u0
        v1 = jnp.sqrt(2.0 * (2.0 + 1.0 / wsq) / (2.0 * wsq - 1.0 / wsq))
        u = jnp.concatenate([u0[None], u1 * wbar[1:]])
        vv = jnp.concatenate([jnp.zeros(1), v1 * wbar[1:]])
        dt = jnp.concatenate([dsc[None], jnp.ones(rows.shape[0] - 1)])
        diag = diag.at[rows].add(eta2 * dt)
        socx.append((
            -eta2 * u, -eta2 * vv,
            jnp.stack([-eta2, eta2]),
        ))
    return diag, blk_vals, socx, gpx


def assemble_Hs_dense(layout: ConeLayout, state: ScalingState):
    """Materialize the block-diagonal Hs as a dense (m, m) matrix for the
    dense KKT backend.  Hs = W'W for symmetric cones, mu*H / BFGS Hs for
    nonsymmetric cones (get_Hs! per-cone semantics)."""
    m = layout.m
    diag = jnp.zeros(m)
    if layout.has_nn:
        diag = jnp.where(layout.nn_mask, state["nn_w"] ** 2, diag)
    H = jnp.diag(diag)

    if layout.has_soc:
        seg = layout.soc_seg
        eta = state["soc_eta"]
        we = eta[seg] * state["soc_w"]
        wfull = jnp.zeros(m).at[layout.soc_idx].set(we)
        segfull = jnp.asarray(layout.soc_segfull)
        same = (segfull[:, None] == segfull[None, :]) & (segfull >= 0)[:, None]
        H = H + 2.0 * jnp.outer(wfull, wfull) * same
        jdiag = (
            jnp.zeros(m).at[layout.soc_idx].set((eta**2)[seg] * layout.soc_sign)
        )
        H = H - jnp.diag(jdiag)

    if layout.has_psd:
        from . import psd as psdcone

        H = psdcone.add_Hs_dense(layout, state, H)
    if layout.has_exp:
        from . import exp as expcone

        H = expcone.add_Hs_dense(layout, state, H)
    if layout.has_pow:
        from . import pow as powcone

        H = powcone.add_Hs_dense(layout, state, H)
    if layout.has_genpow:
        from . import genpow as gpcone

        H = gpcone.add_Hs_dense(layout, state, H)
    return H


def mul_Hs(layout: ConeLayout, state: ScalingState, x):
    """y = Hs x without materializing Hs (mul_Hs! semantics)."""
    y = jnp.zeros(layout.m)
    if layout.has_nn:
        y = jnp.where(layout.nn_mask, state["nn_w"] ** 2 * x, y)
    if layout.has_soc:
        seg = layout.soc_seg
        wg = state["soc_w"]
        xg = x[layout.soc_idx]
        eta2 = state["soc_eta"] ** 2
        wx = _soc_full_dot(layout, wg, xg)
        yg = eta2[seg] * (2.0 * wx[seg] * wg - layout.soc_sign * xg)
        y = y.at[layout.soc_idx].set(yg)
    if layout.has_psd:
        from . import psd as psdcone

        y = psdcone.mul_Hs(layout, state, x, y)
    if layout.has_exp:
        from . import exp as expcone

        y = expcone.mul_Hs(layout, state, x, y)
    if layout.has_pow:
        from . import pow as powcone

        y = powcone.mul_Hs(layout, state, x, y)
    if layout.has_genpow:
        from . import genpow as gpcone

        y = gpcone.mul_Hs(layout, state, x, y)
    return y


# ---------------------------------------------------------------------------
# step RHS pieces
# ---------------------------------------------------------------------------


def affine_ds(layout: ConeLayout, state: ScalingState, s):
    """ds = lambda o lambda for symmetric cones, ds = s for nonsymmetric
    cones, 0 for the zero cone (affine_ds! per-cone semantics)."""
    ds = jnp.zeros(layout.m)
    if layout.has_nn:
        ds = jnp.where(layout.nn_mask, state["nn_lam"] ** 2, ds)
    if layout.has_soc:
        lam = state["soc_lam"]
        vals = _soc_circ(layout, lam, lam)
        ds = ds.at[layout.soc_idx].set(vals)
    if layout.has_psd:
        from . import psd as psdcone

        ds = psdcone.affine_ds(layout, state, ds)
    if layout.has_exp:
        ds = ds.at[layout.exp_idx].set(s[layout.exp_idx])
    if layout.has_pow:
        ds = ds.at[layout.pow_idx].set(s[layout.pow_idx])
    if layout.has_genpow:
        from . import genpow as gpcone

        ds = gpcone.copy_s(layout, s, ds)
    return ds


def combined_ds_shift(
    layout: ConeLayout, state: ScalingState, step_z, step_s, sigma_mu, z
):
    """Mehrotra shift term for the combined step RHS.

    Symmetric cones: shift = W^{-1} ds_aff o W dz_aff - sigma*mu*e
    (coneops_symmetric_common.jl:2-35); for NN this collapses to
    dz .* ds - sigma*mu.  Nonsymmetric cones: sigma*mu*grad f*(z) plus
    3rd-order correction (handled in exp/pow modules)."""
    shift = jnp.zeros(layout.m)
    if layout.has_nn:
        shift = jnp.where(layout.nn_mask, step_z * step_s - sigma_mu, shift)
    if layout.has_soc:
        zg = step_z[layout.soc_idx]
        sg = step_s[layout.soc_idx]
        eta = state["soc_eta"]
        wg = state["soc_w"]
        Wz = _soc_mul_W(layout, eta, wg, zg)
        Wis = _soc_mul_Winv(layout, eta, wg, sg)
        vals = _soc_circ(layout, Wis, Wz)
        vals = vals.at[layout.soc_headpos].add(-sigma_mu)
        shift = shift.at[layout.soc_idx].set(vals)
    if layout.has_psd:
        from . import psd as psdcone

        shift = psdcone.combined_ds_shift(layout, state, step_z, step_s, sigma_mu, shift)
    if layout.has_exp:
        from . import exp as expcone

        shift = expcone.combined_ds_shift(
            layout, state, step_z, step_s, sigma_mu, z, shift
        )
    if layout.has_pow:
        from . import pow as powcone

        shift = powcone.combined_ds_shift(
            layout, state, step_z, step_s, sigma_mu, z, shift
        )
    if layout.has_genpow:
        from . import genpow as gpcone

        shift = gpcone.combined_ds_shift(
            layout, state, step_z, step_s, sigma_mu, z, shift
        )
    return shift


def centrality_correction(layout: ConeLayout, state: ScalingState,
                          z_t, s_t, lo, hi):
    """Gondzio-corrector outlier term: v - clip(v, lo, hi) where
    v = (W^{-T} s_t) o (W z_t) is the scaled complementarity of a TRIAL
    point, with the clip applied spectrally (elementwise for NN; Jordan
    eigenvalues for SOC; matrix eigenvalues for PSD).  Zero on zero-cone
    and nonsymmetric-cone rows.  No reference counterpart — Clarabel.jl
    (solver.jl:295-311) implements Mehrotra + one reduced correction
    only; this op backs the optional `centrality_correctors` setting.

    Adding the returned term to the combined-step `rhs.s` retargets the
    linearized complementarity lambda o (W dz + W^{-T} ds) = -rhs.s of
    outlier components from sigma*mu to their clipped projection."""
    corr = jnp.zeros(layout.m)
    if layout.has_nn:
        vvals = s_t * z_t  # W^{-1}s o Wz = (s/w)(wz) elementwise
        corr = jnp.where(
            layout.nn_mask, vvals - jnp.clip(vvals, lo, hi), corr
        )
    if layout.has_soc:
        zg = z_t[layout.soc_idx]
        sg = s_t[layout.soc_idx]
        eta = state["soc_eta"]
        wg = state["soc_w"]
        u = _soc_circ(
            layout,
            _soc_mul_Winv(layout, eta, wg, sg),
            _soc_mul_W(layout, eta, wg, zg),
        )
        # Jordan spectral decomposition u = lam+ c+ + lam- c-,
        # lam± = u0 ± ||u1||, c± = (1, ±u1/||u1||)/2
        u0 = u[layout.soc_headpos]
        n1 = jnp.sqrt(_soc_tail_sumsq(layout, u))
        lam_p = u0 + n1
        lam_m = u0 - n1
        dp = lam_p - jnp.clip(lam_p, lo, hi)
        dm = lam_m - jnp.clip(lam_m, lo, hi)
        seg = layout.soc_seg
        tail_coef = 0.5 * (dp - dm) / _safe_nonzero(n1)
        vals = tail_coef[seg] * jnp.where(layout.soc_is_head, 0.0, u)
        vals = vals.at[layout.soc_headpos].set(0.5 * (dp + dm))
        corr = corr.at[layout.soc_idx].set(vals)
    if layout.has_psd:
        from . import psd as psdcone

        corr = psdcone.centrality_correction(layout, state, z_t, s_t,
                                             lo, hi, corr)
    return corr


def ds_from_dz_offset(layout: ConeLayout, state: ScalingState, ds, z):
    """out = W'(lambda \\ ds) for symmetric cones, out = ds for
    nonsymmetric cones, 0 for the zero cone (Delta_s_from_Delta_z_offset!
    semantics; SOC uses the numerically stable direct form,
    coneops_socone.jl:241-268)."""
    out = jnp.zeros(layout.m)
    if layout.has_nn:
        zv = _safe_nonzero(jnp.where(layout.nn_mask, z, 1.0))
        out = jnp.where(layout.nn_mask, ds / zv, out)
    if layout.has_soc:
        idx = layout.soc_idx
        seg = layout.soc_seg
        zg = z[idx]
        dsg = ds[idx]
        lam = state["soc_lam"]
        wg = state["soc_w"]
        eta = state["soc_eta"]
        resz, z0, _ = _soc_residual(layout, zg)
        lam0 = lam[layout.soc_headpos]
        w0 = wg[layout.soc_headpos]
        ds0 = dsg[layout.soc_headpos]
        lam1ds1 = _soc_tail_dot(layout, lam, dsg)
        w1ds1 = _soc_tail_dot(layout, wg, dsg)
        c = (lam0 * ds0 - lam1ds1) / _safe_nonzero(resz)
        val = -zg * c[seg]
        val = val.at[layout.soc_headpos].set(z0 * c)
        # tail: + eta*(ds_tail + w1ds1/(1+w0) * w_tail); head: + eta*w1ds1
        addt = eta[seg] * (dsg + (w1ds1 / (1.0 + w0))[seg] * wg)
        addh = eta * w1ds1
        add = jnp.where(layout.soc_is_head, 0.0, addt)
        add = add.at[layout.soc_headpos].add(addh)
        val = (val + add) / _safe_nonzero(lam0)[seg]
        out = out.at[idx].set(val)
    if layout.has_psd:
        from . import psd as psdcone

        out = psdcone.ds_from_dz_offset(layout, state, ds, out)
    if layout.has_exp:
        out = out.at[layout.exp_idx].set(ds[layout.exp_idx])
    if layout.has_pow:
        out = out.at[layout.pow_idx].set(ds[layout.pow_idx])
    if layout.has_genpow:
        from . import genpow as gpcone

        out = gpcone.copy_s(layout, ds, out)
    return out


# ---------------------------------------------------------------------------
# step length & barrier
# ---------------------------------------------------------------------------


def _nn_step_limit(layout, v, dv, amax):
    neg = layout.nn_mask & (dv < 0)
    ratio = -v / jnp.where(dv < 0, dv, -1.0)
    return jnp.min(jnp.where(neg, ratio, amax), initial=FMAX)


def _soc_step_limit(layout, x, dx, amax):
    """Minimum positive root of ||x1+a y1||^2 = (x0+a y0)^2 per cone,
    with the cancellation-safe root formula
    (coneops_socone.jl:443-511)."""
    xg = x[layout.soc_idx]
    yg = dx[layout.soc_idx]
    a, y0, _ = _soc_residual(layout, yg)
    resx, x0, _ = _soc_residual(layout, xg)
    c = jnp.maximum(0.0, resx)
    b = 2.0 * (x0 * y0 - _soc_tail_dot(layout, xg, yg))
    d = b * b - 4.0 * a * c

    # scalar-part bound
    a0 = jnp.where((x0 >= 0) & (y0 < 0), -x0 / jnp.where(y0 < 0, y0, -1.0), FMAX)

    sqrt_d = jnp.sqrt(jnp.maximum(d, 0.0))
    t = jnp.where(b >= 0, -b - sqrt_d, -b + sqrt_d)
    r1 = 2.0 * c / _safe_nonzero(t)
    r2 = t / _safe_nonzero(2.0 * a)
    r1 = jnp.where(r1 < 0, FMAX, r1)
    r2 = jnp.where(r2 < 0, FMAX, r2)
    root = jnp.minimum(r1, r2)

    cand = jnp.where(
        ((a > 0) & (b > 0)) | (d < 0),
        FMAX,
        jnp.where(
            a == 0,
            FMAX,
            jnp.where(c == 0, jnp.where(a >= 0, FMAX, 0.0), root),
        ),
    )
    return jnp.minimum(jnp.min(jnp.minimum(cand, a0), initial=FMAX), amax)


def step_length(layout: ConeLayout, state: ScalingState, dz, ds, z, s,
                alpha_max, settings):
    """Max feasible step in all cones.  Symmetric cones first; if
    nonsymmetric cones are present, back off to 1-sqrt(eps) before
    running their backtracking searches
    (coneops_compositecone.jl:205-243)."""
    alpha = alpha_max
    if layout.has_nn:
        alpha = jnp.minimum(alpha, _nn_step_limit(layout, z, dz, alpha_max))
        alpha = jnp.minimum(alpha, _nn_step_limit(layout, s, ds, alpha_max))
    if layout.has_soc:
        alpha = jnp.minimum(alpha, _soc_step_limit(layout, z, dz, alpha_max))
        alpha = jnp.minimum(alpha, _soc_step_limit(layout, s, ds, alpha_max))
    if layout.has_psd:
        from . import psd as psdcone

        alpha = jnp.minimum(
            alpha, psdcone.step_length(layout, state, dz, ds, z, s, alpha_max)
        )

    if layout.has_nonsymmetric:
        alpha = jnp.minimum(alpha, 1.0 - np.sqrt(EPS))
        if layout.has_exp:
            from . import exp as expcone

            alpha = expcone.step_length(layout, dz, ds, z, s, alpha, settings)
        if layout.has_pow:
            from . import pow as powcone

            alpha = powcone.step_length(layout, dz, ds, z, s, alpha, settings)
        if layout.has_genpow:
            from . import genpow as gpcone

            alpha = gpcone.step_length(layout, dz, ds, z, s, alpha, settings)
    return alpha


def compute_barrier(layout: ConeLayout, z, s, dz, ds, alpha):
    """Total barrier at (z + a dz, s + a ds)
    (coneops_compositecone.jl:246-265)."""
    barrier = jnp.asarray(0.0)
    if layout.has_nn:
        si = s + alpha * ds
        zi = z + alpha * dz
        barrier = barrier - jnp.sum(
            jnp.where(layout.nn_mask, _logsafe(si * zi), 0.0)
        )
    if layout.has_soc:
        si = (s + alpha * ds)[layout.soc_idx]
        zi = (z + alpha * dz)[layout.soc_idx]
        res_s, _, _ = _soc_residual(layout, si)
        res_z, _, _ = _soc_residual(layout, zi)
        good = (res_s > 0) & (res_z > 0)
        terms = jnp.where(good, -0.5 * _logsafe(res_s * res_z), jnp.inf)
        barrier = barrier + jnp.sum(terms)
    if layout.has_psd:
        from . import psd as psdcone

        barrier = barrier + psdcone.compute_barrier(layout, z, s, dz, ds, alpha)
    if layout.has_exp:
        from . import exp as expcone

        barrier = barrier + expcone.compute_barrier(layout, z, s, dz, ds, alpha)
    if layout.has_pow:
        from . import pow as powcone

        barrier = barrier + powcone.compute_barrier(layout, z, s, dz, ds, alpha)
    if layout.has_genpow:
        from . import genpow as gpcone

        barrier = barrier + gpcone.compute_barrier(layout, z, s, dz, ds, alpha)
    return barrier
