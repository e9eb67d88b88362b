"""PSD triangle cone kernels: size-grouped, batched dense linalg.

Behavioral parity with `src/cones/coneops_psdtrianglecone.jl`.  Cones
are grouped by side length r (layout.psd_groups: r -> (k, sd) index
matrix with sd = r(r+1)/2) and each group runs one batched kernel:
Cholesky / SVD / eigh over (k, r, r) stacks — exactly the shape XLA's
batched decompositions want on an accelerator.

svec storage uses the scaled upper triangle in column-major order with
sqrt(2) off-diagonal scaling (svec_to_mat!/mat_to_svec!,
coneops_psdtrianglecone.jl:469-497), so <svec(X), svec(Y)> = <X, Y>_F.

NT scaling (update_scaling!, coneops_psdtrianglecone.jl:78-143):
L1 = chol(S), L2 = chol(Z), SVD(L2' L1) = U Sigma V', lambda = diag
Sigma, R = L1 V Sigma^{-1/2}, Rinv = Sigma^{-1/2} U' L2', and the KKT
block Hs = skron(R R') (skron!, coneops_psdtrianglecone.jl:502-540).
"""

import functools

import jax.numpy as jnp
import numpy as np

from .nonsymmetric import BIG

FMAX = float(np.finfo(np.float64).max)
ISQRT2 = 1.0 / np.sqrt(2.0)
SQRT2 = np.sqrt(2.0)


@functools.lru_cache(maxsize=64)
def _tri_maps(r: int):
    """Static index maps for side length r:
    (rows, cols): (sd,) matrix coords of each svec entry (row <= col);
    diagpos: svec positions of the diagonal;
    matidx: (r, r) svec position of (i, j) (symmetrized);
    scale_mat: (r, r) svec->mat scaling (1 diag, 1/sqrt2 off-diag);
    cvec: (sd,) mat->svec scaling (1 diag, sqrt2 off-diag implied in
    the symmetric-Kronecker formula)."""
    rows, cols = [], []
    for j in range(r):
        for i in range(j + 1):
            rows.append(i)
            cols.append(j)
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    sd = len(rows)
    diagpos = np.nonzero(rows == cols)[0].astype(np.int32)
    matidx = np.zeros((r, r), np.int32)
    for a in range(sd):
        matidx[rows[a], cols[a]] = a
        matidx[cols[a], rows[a]] = a
    scale_mat = np.full((r, r), ISQRT2)
    np.fill_diagonal(scale_mat, 1.0)
    cvec = np.where(rows == cols, 1.0, SQRT2)
    return rows, cols, diagpos, matidx, scale_mat, cvec


def svec_to_mat(x, r: int):
    """(..., sd) -> (..., r, r) symmetric matrices."""
    _, _, _, matidx, scale_mat, _ = _tri_maps(r)
    return x[..., matidx] * scale_mat


def mat_to_svec(M, r: int):
    """(..., r, r) -> (..., sd); symmetrizes like mat_to_svec!."""
    rows, cols, _, _, _, _ = _tri_maps(r)
    vals = (M[..., rows, cols] + M[..., cols, rows]) * 0.5
    diag = rows == cols
    return jnp.where(diag, vals, vals * SQRT2)


def _chol_logdet(M):
    """Batched (logdet, ok) via Cholesky; ok=False when not PD."""
    L = jnp.linalg.cholesky(M)
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    ok = jnp.all(jnp.isfinite(d) & (d > 0), axis=-1)
    return 2.0 * jnp.sum(jnp.log(jnp.where(d > 0, d, 1.0)), axis=-1), ok


def _groups(layout):
    return sorted(layout.psd_groups.items())


# ---------------------------------------------------------------------------
# composite-dispatch entry points (called from ops.py)
# ---------------------------------------------------------------------------


def unit_init(layout, z, s):
    """Identity matrices: 1 at the svec diagonal positions
    (unit_initialization!, coneops_psdtrianglecone.jl:46-61)."""
    for r, idx in _groups(layout):
        _, _, diagpos, _, _, _ = _tri_maps(r)
        z = z.at[idx[:, diagpos]].set(1.0)
        s = s.at[idx[:, diagpos]].set(1.0)
    return z, s


def margins(layout, z):
    """(min eigenvalue, sum of positive eigenvalues) across all PSD
    cones (margins, coneops_psdtrianglecone.jl:8-27)."""
    alpha = jnp.asarray(FMAX)
    beta = jnp.asarray(0.0)
    for r, idx in _groups(layout):
        Z = svec_to_mat(z[idx], r)
        e = jnp.linalg.eigvalsh(Z)
        alpha = jnp.minimum(alpha, jnp.min(e))
        beta = beta + jnp.sum(jnp.maximum(e, 0.0))
    return alpha, beta


def scaled_unit_shift(layout, z, alpha):
    """z += alpha * svec(I) per cone (scaled_unit_shift!,
    coneops_psdtrianglecone.jl:30-43)."""
    for r, idx in _groups(layout):
        _, _, diagpos, _, _, _ = _tri_maps(r)
        z = z.at[idx[:, diagpos]].add(alpha)
    return z


def identity_scaling(layout):
    state = {}
    for r, idx in _groups(layout):
        k = idx.shape[0]
        eye = jnp.broadcast_to(jnp.eye(r), (k, r, r))
        state[f"psd{r}_R"] = eye
        state[f"psd{r}_Rinv"] = eye
        state[f"psd{r}_lam"] = jnp.ones((k, r))
    return state


def update_scaling(layout, s, z):
    """NT scaling via two Choleskys + SVD, batched per size group
    (update_scaling!, coneops_psdtrianglecone.jl:78-143)."""
    state = {}
    ok = jnp.asarray(True)
    for r, idx in _groups(layout):
        S = svec_to_mat(s[idx], r)
        Z = svec_to_mat(z[idx], r)
        L1 = jnp.linalg.cholesky(S)
        L2 = jnp.linalg.cholesky(Z)
        okg = jnp.all(jnp.isfinite(L1)) & jnp.all(jnp.isfinite(L2))

        L1s = jnp.where(jnp.isfinite(L1), L1, 0.0)
        L2s = jnp.where(jnp.isfinite(L2), L2, 0.0)
        tmp = jnp.einsum("kji,kjl->kil", L2s, L1s)  # L2' L1
        U, lam, Vt = jnp.linalg.svd(tmp)
        lam_isqrt = 1.0 / jnp.sqrt(jnp.where(lam > 0, lam, 1.0))
        okg = okg & jnp.all(lam > 0)

        R = jnp.einsum("kij,klj->kil", L1s, Vt) * lam_isqrt[:, None, :]
        Rinv = (lam_isqrt[:, :, None] * jnp.swapaxes(U, 1, 2)) @ jnp.swapaxes(
            L2s, 1, 2
        )

        state[f"psd{r}_R"] = R
        state[f"psd{r}_Rinv"] = Rinv
        state[f"psd{r}_lam"] = lam
        ok = ok & okg
    return state, ok


def _skron(X, r: int):
    """Symmetric Kronecker product block: (k, sd, sd) with
    H[(ij),(kl)] = c_ij c_kl (X_ik X_jl + X_il X_jk)/2
    (skron!, coneops_psdtrianglecone.jl:502-540)."""
    rows, cols, _, _, _, cvec = _tri_maps(r)
    i, j = rows, cols
    Xik = X[:, i[:, None], i[None, :]]
    Xjl = X[:, j[:, None], j[None, :]]
    Xil = X[:, i[:, None], j[None, :]]
    Xjk = X[:, j[:, None], i[None, :]]
    cc = cvec[:, None] * cvec[None, :]
    return cc * (Xik * Xjl + Xil * Xjk) * 0.5


def add_Hs_dense(layout, state, Hmat):
    """Hs = skron(R R') scattered into the dense (m, m) block."""
    for r, idx in _groups(layout):
        R = state[f"psd{r}_R"]
        RRt = R @ jnp.swapaxes(R, 1, 2)
        Hs = _skron(RRt, r)
        Hmat = Hmat.at[idx[:, :, None], idx[:, None, :]].add(Hs)
    return Hmat


def mul_Hs(layout, state, x, y):
    """y = W'W x = svec((RR') X (RR')) (mul_Hs! via two W products,
    coneops_psdtrianglecone.jl:163-186)."""
    for r, idx in _groups(layout):
        R = state[f"psd{r}_R"]
        RRt = R @ jnp.swapaxes(R, 1, 2)
        X = svec_to_mat(x[idx], r)
        y = y.at[idx].set(mat_to_svec(RRt @ X @ RRt, r))
    return y


def affine_ds(layout, state, ds):
    """ds = svec(Lambda^2) (affine_ds!,
    coneops_psdtrianglecone.jl:189-206)."""
    for r, idx in _groups(layout):
        _, _, diagpos, _, _, _ = _tri_maps(r)
        lam = state[f"psd{r}_lam"]
        ds = ds.at[idx[:, diagpos]].set(lam * lam)
    return ds


def combined_ds_shift(layout, state, step_z, step_s, sigma_mu, shift):
    """shift = (W^{-T}ds) o (W dz) - sigma*mu*e
    (_combined_ds_shift_symmetric!, coneops_symmetric_common.jl:2-35):
    W dz = R' Dz R, W^{-T} ds = Rinv Ds Rinv', X o Y = (XY + YX)/2."""
    for r, idx in _groups(layout):
        R = state[f"psd{r}_R"]
        Rinv = state[f"psd{r}_Rinv"]
        _, _, diagpos, _, _, _ = _tri_maps(r)
        Dz = svec_to_mat(step_z[idx], r)
        Ds = svec_to_mat(step_s[idx], r)
        Wz = jnp.swapaxes(R, 1, 2) @ Dz @ R
        Ws = Rinv @ Ds @ jnp.swapaxes(Rinv, 1, 2)
        circ = (Ws @ Wz + Wz @ Ws) * 0.5
        vals = mat_to_svec(circ, r)
        vals = vals.at[:, diagpos].add(-sigma_mu)
        shift = shift.at[idx].set(vals)
    return shift


def centrality_correction(layout, state, z_t, s_t, lo, hi, corr):
    """Gondzio-corrector outlier term for PSD blocks: the scaled trial
    complementarity M = (W^{-T}S_t) o (W Z_t) is eigendecomposed and the
    eigenvalues outside [lo, hi] are pushed back (spectral clip); the
    returned svec term is M - clip(M).  See ops.centrality_correction
    (no reference counterpart)."""
    for r, idx in _groups(layout):
        R = state[f"psd{r}_R"]
        Rinv = state[f"psd{r}_Rinv"]
        Dz = svec_to_mat(z_t[idx], r)
        Ds = svec_to_mat(s_t[idx], r)
        Wz = jnp.swapaxes(R, 1, 2) @ Dz @ R
        Ws = Rinv @ Ds @ jnp.swapaxes(Rinv, 1, 2)
        M = (Ws @ Wz + Wz @ Ws) * 0.5
        lam, Q = jnp.linalg.eigh(M)
        dlam = lam - jnp.clip(lam, lo, hi)
        C = (Q * dlam[:, None, :]) @ jnp.swapaxes(Q, 1, 2)
        corr = corr.at[idx].set(mat_to_svec(C, r))
    return corr


def ds_from_dz_offset(layout, state, ds, out):
    """out = W'(lambda \\ ds): lambda-inverse circ is elementwise
    2 Z_ij/(lam_i + lam_j), then W'(.) = R (.) R'
    (_Δs_from_Δz_offset_symmetric! + λ_inv_circ_op!,
    coneops_psdtrianglecone.jl:305-325)."""
    for r, idx in _groups(layout):
        R = state[f"psd{r}_R"]
        lam = state[f"psd{r}_lam"]
        Z = svec_to_mat(ds[idx], r)
        denom = lam[:, :, None] + lam[:, None, :]
        X = 2.0 * Z / jnp.where(denom != 0, denom, 1.0)
        out = out.at[idx].set(mat_to_svec(R @ X @ jnp.swapaxes(R, 1, 2), r))
    return out


def step_length(layout, state, dz, ds, z, s, alpha_max):
    """min over cones of the PSD boundary steps: with
    d = Lam^{-1/2} (W dx) Lam^{-1/2}, alpha = 1/max(-eigmin(d))
    (step_length + step_length_psd_component,
    coneops_psdtrianglecone.jl:210-231,439-466)."""
    alpha = alpha_max
    for r, idx in _groups(layout):
        R = state[f"psd{r}_R"]
        Rinv = state[f"psd{r}_Rinv"]
        lam = state[f"psd{r}_lam"]
        lam_isqrt = 1.0 / jnp.sqrt(jnp.where(lam > 0, lam, 1.0))

        Dz = svec_to_mat(dz[idx], r)
        Ds = svec_to_mat(ds[idx], r)
        Wz = jnp.swapaxes(R, 1, 2) @ Dz @ R  # W dz
        Ws = Rinv @ Ds @ jnp.swapaxes(Rinv, 1, 2)  # W^{-T} ds
        for M in (Wz, Ws):
            scaled = lam_isqrt[:, :, None] * M * lam_isqrt[:, None, :]
            gamma = jnp.min(jnp.linalg.eigvalsh(scaled), axis=-1)
            lim = jnp.where(gamma < 0, 1.0 / jnp.maximum(-gamma, 1e-300), FMAX)
            alpha = jnp.minimum(alpha, jnp.min(lim, initial=FMAX))
    return alpha


def compute_barrier(layout, z, s, dz, ds, alpha):
    """-logdet(Z + a dZ) - logdet(S + a dS); +BIG when either leaves
    the cone (compute_barrier + _logdet_barrier,
    coneops_psdtrianglecone.jl:234-269)."""
    barrier = jnp.asarray(0.0)
    for r, idx in _groups(layout):
        Zi = svec_to_mat((z + alpha * dz)[idx], r)
        Si = svec_to_mat((s + alpha * ds)[idx], r)
        ldz, okz = _chol_logdet(Zi)
        lds, oks = _chol_logdet(Si)
        terms = jnp.where(okz & oks, -(ldz + lds), BIG)
        barrier = barrier + jnp.sum(terms)
    return barrier
