"""Shared numerics for the nonsymmetric (exp/pow/genpow) cone kernels.

Vectorized counterparts of the reference's shared nonsymmetric helpers
(`src/cones/coneops_nonsymmetric_common.jl`):

  * `newton_raphson_onesided` — batched one-sided NR iteration
    (`coneops_nonsymmetric_common.jl:170-193`) as a bounded
    `lax.while_loop` with a per-cone active mask;
  * `primal_dual_scaling_3x3` — the BFGS-style primal-dual scaling for
    3-d exp/pow cones (`use_primal_dual_scaling`,
    `coneops_nonsymmetric_common.jl:82-164`), batched over all cones of
    one type with a per-cone fallback to the dual scaling mu*H;
  * `backtrack_alpha` — a global backtracking feasibility search
    replacing the per-cone `backtrack_search`
    (`coneops_nonsymmetric_common.jl:5-34`): instead of each cone
    backtracking independently and the composite taking the min, one
    shared alpha backtracks until *all* cones are feasible.  The result
    is a feasible alpha <= the reference's min over cones.
"""

import jax
import jax.numpy as jnp
import numpy as np

F64EPS = float(np.finfo(np.float64).eps)
SQRT_EPS = float(np.sqrt(np.finfo(np.float64).eps))
BIG = 1e30


def logsafe(x):
    """log with a large negative (finite) value for nonpositive args
    (mathutils.jl:12-18); finite so downstream arithmetic stays NaN-free."""
    return jnp.where(x > 0, jnp.log(jnp.where(x > 0, x, 1.0)), -BIG)


def solve_3x3_sym(H, b):
    """Batched explicit 3x3 Cholesky solve of SPD systems H x = b
    (parity with cholesky_3x3_explicit_factor!/solve!, used by the
    reference for the same reason: a generic batched LU is slow on
    3x3 systems).  Returns
    NaNs for non-SPD inputs; callers mask on finiteness (the reference
    zeroes the correction on factor failure)."""
    a, bb, c = H[:, 0, 0], H[:, 0, 1], H[:, 0, 2]
    d, e, f = H[:, 1, 1], H[:, 1, 2], H[:, 2, 2]
    l11 = jnp.sqrt(a)
    l21 = bb / l11
    l31 = c / l11
    l22 = jnp.sqrt(d - l21 * l21)
    l32 = (e - l21 * l31) / l22
    l33 = jnp.sqrt(f - l31 * l31 - l32 * l32)
    # forward: L y = b
    y1 = b[:, 0] / l11
    y2 = (b[:, 1] - l21 * y1) / l22
    y3 = (b[:, 2] - l31 * y1 - l32 * y2) / l33
    # backward: L' x = y
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    return jnp.stack([x1, x2, x3], axis=1)


def newton_raphson_onesided(x0, f0, f1, max_iter: int = 100):
    """Batched one-sided Newton-Raphson: x0 (k,) starting left of the
    root with f0(x0) > 0.  f0/f1 map (k,) -> (k,).  Stops per cone when
    dx < eps, |dx/x| < sqrt(eps), or |f'| < eps."""

    def cond(c):
        _, active, i = c
        return jnp.any(active) & (i < max_iter)

    def body(c):
        x, active, i = c
        dfdx = f1(x)
        safe_dfdx = jnp.where(jnp.abs(dfdx) > 0, dfdx, 1.0)
        dx = -f0(x) / safe_dfdx
        stop = (
            (dx < F64EPS)
            | (jnp.abs(dx / jnp.where(x != 0, x, 1.0)) < SQRT_EPS)
            | (jnp.abs(dfdx) < F64EPS)
        )
        x = jnp.where(active & ~stop, x + dx, x)
        return (x, active & ~stop, i + 1)

    x, _, _ = jax.lax.while_loop(cond, body, (x0, jnp.ones_like(x0, bool), 0))
    return x


def primal_dual_scaling_3x3(s, z, st, zt, H):
    """BFGS primal-dual scaling Hs for a batch of 3-d cones.

    s, z: (k,3) current primal/dual points; st = grad f*(z) (k,3);
    zt = grad f(s) (k,3); H = dual Hessian (k,3,3).  Returns (k,3,3):
    per-cone the primal-dual Hs when the central-path guards pass, else
    the dual scaling mu*H (coneops_nonsymmetric_common.jl:107-164)."""
    dot_sz = jnp.sum(s * z, axis=1)
    mu = dot_sz / 3.0
    mut = jnp.sum(zt * st, axis=1) / 3.0

    ds = s + mu[:, None] * st
    dz = z + mu[:, None] * zt
    dot_dsz = jnp.sum(ds * dz, axis=1)

    de1 = mu * mut - 1.0
    Hzt = jnp.einsum("kij,kj->ki", H, zt)
    de2 = jnp.sum(zt * Hzt, axis=1) - 3.0 * mut * mut

    guard = (
        (jnp.abs(de1) > SQRT_EPS)
        & (jnp.abs(de2) > F64EPS)
        & (dot_sz > 0)
        & (dot_dsz > 0)
    )

    safe_de2 = jnp.where(jnp.abs(de2) > 0, de2, 1.0)
    tmp = mut[:, None] * st - Hzt
    M = (
        H
        - st[:, :, None] * st[:, None, :] / 3.0
        - tmp[:, :, None] * tmp[:, None, :] / safe_de2[:, None, None]
    )
    t = mu * jnp.sqrt(jnp.sum(M * M, axis=(1, 2)))

    axis = jnp.cross(z, zt)
    axis_norm = jnp.linalg.norm(axis, axis=1)
    axis = axis / jnp.where(axis_norm > 0, axis_norm, 1.0)[:, None]

    safe_sz = jnp.where(dot_sz > 0, dot_sz, 1.0)
    safe_dsz = jnp.where(dot_dsz > 0, dot_dsz, 1.0)
    Hs_pd = (
        s[:, :, None] * s[:, None, :] / safe_sz[:, None, None]
        + ds[:, :, None] * ds[:, None, :] / safe_dsz[:, None, None]
        + t[:, None, None] * axis[:, :, None] * axis[:, None, :]
    )

    guard = guard & (t > 0) & jnp.all(jnp.isfinite(Hs_pd), axis=(1, 2))
    Hs_dual = mu[:, None, None] * H
    return jnp.where(guard[:, None, None], Hs_pd, Hs_dual)


def backtrack_alpha(alpha0, all_feasible_fn, settings, max_iter: int = 64):
    """Backtrack a single shared alpha until all cones are feasible
    (composite of backtrack_search, coneops_nonsymmetric_common.jl:5-34):
    alpha *= step until feasible; returns 0 once alpha < min_terminate."""
    step = settings.linesearch_backtrack_step
    amin = settings.min_terminate_step_length

    def cond(c):
        _, done, i = c
        return (~done) & (i < max_iter)

    def body(c):
        a, _, i = c
        feas = all_feasible_fn(a)
        a_next = jnp.where(feas, a, a * step)
        dead = (~feas) & (a_next < amin)
        a_next = jnp.where(dead, 0.0, a_next)
        return (a_next, feas | dead, i + 1)

    a, _, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(alpha0, jnp.float64), jnp.asarray(False), 0)
    )
    return a
