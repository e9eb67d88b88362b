"""Dense quasidefinite KKT backend.

The reduced KKT system (after eliminating Delta_s and the tau column,
`src/kktsystem.jl:5-232`):

    K = [ P   A' ]
        [ A  -Hs ]

is symmetric quasidefinite once statically regularized with signed
epsilon (+eps on the x block, -eps on the z block — Dsigns semantics of
`src/kktsolvers/kktsolver_directldl.jl:112-126,247-310`).

Design decisions:
  * the factorization runs DENSE: batched dense factorizations of
    moderate KKT systems map onto the device's batched linear-algebra
    libraries; large sparse problems go to the multifrontal backend
    (sparse_kkt.py).
  * factorization precision is configurable: a float32 factor plus
    float64 iterative refinement can recover ~1e-8 accuracy (the
    reference's static-reg + IR architecture,
    `kktsolver_directldl.jl:389-449`, is exactly what makes this work).
  * iterative refinement runs as a `lax.while_loop` against the
    *unregularized* f64 KKT operator.
"""

import jax
import jax.numpy as jnp
import numpy as np


def _inf_norm(v):
    return jnp.max(jnp.abs(v))


def _gj_inv_small(M):
    """Unrolled no-pivot Gauss-Jordan inverse for tiny blocks.

    Valid because every diagonal block reached by the recursive Schur
    split of a statically regularized quasidefinite matrix is itself
    quasidefinite (nonzero pivots); f64 refinement absorbs the loss of
    pivoting accuracy."""
    N = M.shape[-1]
    X = jnp.concatenate([M, jnp.eye(N, dtype=M.dtype)], axis=-1)
    for i in range(N):
        piv = X[i, :] / X[i, i]
        X = X - X[:, i : i + 1] * piv[None, :]
        X = X.at[i, :].set(piv)
    return X[:, N:]


def pivotfree_inv(M):
    """Pivot-free inverse of a (regularized) quasidefinite matrix by
    recursive 2x2 block Schur complementation:

        inv([A B; C D]) = [Ai + AiB Si CAi,  -AiB Si]
                          [      -Si CAi,        Si ]

    with Ai = inv(A), S = D - C Ai B, Si = inv(S).  All work is batched
    matmuls — no sequential pivot search / row swaps.  Leading
    principal submatrices of a quasidefinite matrix are quasidefinite,
    so every recursive block is invertible without pivoting (Vanderbei
    1995)."""
    N = M.shape[-1]
    if N <= 8:
        return _gj_inv_small(M)
    k = N // 2
    A = M[:k, :k]
    B = M[:k, k:]
    C = M[k:, :k]
    D = M[k:, k:]
    Ai = pivotfree_inv(A)
    AiB = Ai @ B
    S = D - C @ AiB
    Si = pivotfree_inv(S)
    CAi = C @ Ai
    SiCAi = Si @ CAi
    top = jnp.concatenate([Ai + AiB @ SiCAi, -(AiB @ Si)], axis=1)
    bot = jnp.concatenate([-SiCAi, Si], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def resolve_kkt_method(settings) -> str:
    """Resolve kkt_solve_method='auto' to the backend actually used.

    "auto" is pivoted LU (batched `lu_factor`/`lu_solve`) on every
    backend and at every size; "inverse" and "qr" stay selectable."""
    method = settings.kkt_solve_method
    return "lu" if method == "auto" else method


def make_dense_kkt(n: int, m: int, settings, factor_dtype, layout=None):
    """Returns (factorize, solve):

    factorize(P, A, Hs) -> (fac, ok)
        fac carries the LU factor of the regularized K (factor dtype)
        and the unregularized K in f64 for refinement residuals.

    solve(fac, rx, rz) -> (x, z, ok)
        one KKT solve with iterative refinement.
    """
    N = n + m
    eps_const = settings.static_regularization_constant
    eps_prop = settings.static_regularization_proportional
    reg_enable = settings.static_regularization_enable
    ir_enable = settings.iterative_refinement_enable
    ir_reltol = settings.iterative_refinement_reltol
    ir_abstol = settings.iterative_refinement_abstol
    ir_maxiter = settings.iterative_refinement_max_iter
    ir_stopratio = settings.iterative_refinement_stop_ratio

    dsigns = np.concatenate([np.ones(n), -np.ones(m)])

    method = resolve_kkt_method(settings)

    def _assemble(P, A, Hs):
        top = jnp.concatenate([P, A.T], axis=1)
        bot = jnp.concatenate([A, -Hs], axis=1)
        K = jnp.concatenate([top, bot], axis=0)  # f64, unregularized

        if reg_enable:
            # eps = const + proportional * max |diag K|
            # (kktsolver_directldl.jl:297-310)
            diag = jnp.diagonal(K)
            eps = eps_const + eps_prop * _inf_norm(diag)
            Kreg = K + jnp.diag(dsigns * eps)
        else:
            eps = jnp.asarray(0.0)
            Kreg = K

        # symmetric row-norm (one-shot Ruiz) pre-scaling of the matrix
        # handed to the reduced-precision factorization: the Hs block
        # spans many orders of magnitude late in the IPM, and rescaling
        # keeps the factor's condition number within f32 range.  Row
        # inf-norms (not the diagonal, which is ~0 on the x block of an
        # LP) so zero-diagonal rows scale sanely.  The f64 refinement
        # still runs against the raw operator K.
        rn = jnp.max(jnp.abs(Kreg), axis=1)
        dj = 1.0 / jnp.sqrt(jnp.where(rn > 1e-300, rn, 1.0))
        Ks = Kreg * dj[:, None] * dj[None, :]
        return K, Ks, dj

    # Stability ordering for pivot-free elimination: inequality slack
    # rows first (pivots -(Hs+eps), O(1) magnitudes), then the x block
    # (its Schur complement P + eps + A' H^-1 A is SPD), then equality
    # (zero-cone) rows last (their Schur pivots become
    # -(eps + A_eq S^-1 A_eq') rather than the raw -eps).  Without
    # this, an LP's leading eps*I pivots produce 1e8-scale multipliers
    # that destroy an f32 factorization.
    zero_mask = (
        np.asarray(layout.zero_mask)
        if layout is not None and getattr(layout, "has_zero", False)
        else np.zeros(m, dtype=bool)
    )
    mrows = np.arange(m) + n
    perm = np.concatenate([mrows[~zero_mask], np.arange(n), mrows[zero_mask]])
    iperm = np.argsort(perm)

    if method == "inverse":

        def factorize(P, A, Hs):
            K, Ks, dj = _assemble(P, A, Hs)
            # f32: pivoted inversion — the pivot-free recursion's f32
            # accuracy degrades with the late-IPM Hs spread (stability
            # ordering fixes the eps-pivot blowup but not the spread).
            # f64: the stability-ordered pivot-free block-Schur inverse
            # (pure matmuls; ~1e-16 headroom makes the recursion
            # accurate).  Either way a Newton-Schulz step tightens the
            # residual and every solve is one matrix-vector product.
            if factor_dtype == jnp.float32:
                Kf = Ks.astype(factor_dtype)
                Kinv = jnp.linalg.inv(Kf)
            else:
                Kf = Ks[perm][:, perm].astype(factor_dtype)
                Kinv = pivotfree_inv(Kf)
            Kinv = Kinv @ (2.0 * jnp.eye(N, dtype=factor_dtype) - Kf @ Kinv)
            ok = jnp.all(jnp.isfinite(Kinv))
            return {"Kinv": Kinv, "K": K, "dj": dj}, ok

        _permuted = factor_dtype != jnp.float32

        def _raw_solve(fac, b):
            dj = fac["dj"]
            if _permuted:
                bs = (dj * b)[perm].astype(factor_dtype)
                return dj * (fac["Kinv"] @ bs)[iperm].astype(jnp.float64)
            bs = (dj * b).astype(factor_dtype)
            return dj * (fac["Kinv"] @ bs).astype(jnp.float64)

    elif method == "qr":

        def factorize(P, A, Hs):
            # Householder QR: pivoting-free AND backward stable.  The
            # pivot-free block-Schur inverse loses ~8 digits on dense
            # ill-conditioned Hs blocks (late-IPM PSD cones: observed
            # INSUFFICIENT_PROGRESS at r_prim ~ 4e-4 on a PSD
            # projection) because intermediate Schur complements are
            # far worse conditioned than K itself; Householder factors
            # touch K only through orthogonal transforms.
            K, Ks, dj = _assemble(P, A, Hs)
            Qf, Rf = jnp.linalg.qr(Ks.astype(factor_dtype))
            ok = jnp.all(jnp.isfinite(Rf))
            return {"Q": Qf, "R": Rf, "K": K, "dj": dj}, ok

        def _raw_solve(fac, b):
            dj = fac["dj"]
            bs = (dj * b).astype(factor_dtype)
            y = fac["Q"].T @ bs
            x = jax.scipy.linalg.solve_triangular(fac["R"], y, lower=False)
            return dj * x.astype(jnp.float64)

    else:

        def factorize(P, A, Hs):
            K, Ks, dj = _assemble(P, A, Hs)
            lu, piv = jax.scipy.linalg.lu_factor(Ks.astype(factor_dtype))
            ok = jnp.all(jnp.isfinite(lu))
            return {"lu": lu, "piv": piv, "K": K, "dj": dj}, ok

        def _raw_solve(fac, b):
            dj = fac["dj"]
            x = jax.scipy.linalg.lu_solve(
                (fac["lu"], fac["piv"]), (dj * b).astype(factor_dtype)
            )
            return dj * x.astype(jnp.float64)

    def _refine(fac, b, x0):
        """Iterative refinement against the unregularized K
        (kktsolver_directldl.jl:389-449)."""
        K = fac["K"]
        normb = _inf_norm(b)
        tol = ir_abstol + ir_reltol * normb

        e0 = b - K @ x0
        norme0 = _inf_norm(e0)
        ok0 = jnp.isfinite(norme0)

        def cond(c):
            _, _, norme, i, stop, ok = c
            return (~stop) & ok & (i < ir_maxiter) & (norme > tol)

        def body(c):
            x, e, norme, i, _, _ = c
            dx = _raw_solve(fac, e)
            xn = x + dx
            en = b - K @ xn
            normen = _inf_norm(en)
            okn = jnp.isfinite(normen)
            ratio = norme / jnp.where(normen > 0, normen, 1e-300)
            # Reference semantics (kktsolver_directldl.jl:430-438): stop
            # once a pass improves by less than stop_ratio, accepting the
            # final step only if it improved at all.  With reduced-
            # precision factors convergence is geometric with a smaller
            # per-pass ratio, so the effective threshold is capped at
            # 1.2: each pass still making >20% progress keeps running
            # (max_iter bounds the loop either way), while a user
            # tightening the setting below 1.2 is honored exactly.
            accept = ratio > 1.0
            keep_going = ratio > min(ir_stopratio, 1.2)
            x_out = jnp.where(accept, xn, x)
            e_out = jnp.where(accept, en, e)
            norme_out = jnp.where(accept, normen, norme)
            return (x_out, e_out, norme_out, i + 1, ~keep_going, okn)

        x, _, norme, nir, _, ok = jax.lax.while_loop(
            cond, body, (x0, e0, norme0, 0, False, ok0)
        )
        return x, ok & jnp.isfinite(norme), nir

    def solve(fac, rx, rz):
        """-> (x, z, ok, n_refinement_passes)."""
        b = jnp.concatenate([rx, rz])
        x = _raw_solve(fac, b)
        if ir_enable:
            x, ok, nir = _refine(fac, b, x)
        else:
            ok = jnp.all(jnp.isfinite(x))
            nir = jnp.asarray(0)
        return x[:n], x[n:], ok, nir

    return factorize, solve
