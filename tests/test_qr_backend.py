"""QR dense-KKT backend (kkt_solve_method="qr").

Regression for an on-device finding: the pivot-free block-Schur
inverse loses ~8 digits on dense ill-conditioned Hs blocks (late-IPM
PSD cones) — a nearest-PSD projection ended INSUFFICIENT_PROGRESS at
r_prim ~ 4e-4 through `inverse` (f64) while `lu` solved to 1e-14.
Householder QR is pivoting-free AND backward stable."""

import numpy as np
import pytest

import cuclarabel_tpu as cc


def _psd_projection(nv=24, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((nv, nv))
    M = (M + M.T) / 2.0
    sd = nv * (nv + 1) // 2
    sv = np.zeros(sd)
    a = 0
    for j in range(nv):
        for i in range(j + 1):
            sv[a] = M[i, j] * (1.0 if i == j else np.sqrt(2.0))
            a += 1
    P = np.eye(sd)
    q = -sv
    A = -np.eye(sd)
    b = np.zeros(sd)
    return P, q, A, b, [cc.PSDTriangleConeT(nv)], M


def test_qr_solves_psd_projection():
    P, q, A, b, cones, M = _psd_projection()
    s = cc.Solver(P, q, A, b, cones, kkt_solve_method="qr")
    sol = s.solve()
    assert sol.status == cc.SolverStatus.SOLVED
    assert sol.r_prim < 1e-9 and sol.r_dual < 1e-9
    # objective parity vs the eigendecomposition projection
    w, V = np.linalg.eigh(M)
    Mplus = (V * np.maximum(w, 0.0)) @ V.T
    ref_obj = 0.5 * np.sum(Mplus * Mplus) - np.sum(Mplus * M)
    assert sol.obj_val == pytest.approx(ref_obj, abs=1e-6)


def test_qr_matches_lu_on_qp():
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.ones((1, 2)), np.eye(2), -np.eye(2)])
    b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(2), cc.NonnegativeConeT(2)]
    s1 = cc.Solver(P, q, A, b, cones, kkt_solve_method="qr").solve()
    s2 = cc.Solver(P, q, A, b, cones, kkt_solve_method="lu").solve()
    assert s1.status == cc.SolverStatus.SOLVED
    assert np.allclose(s1.x, s2.x, atol=1e-8)


def test_qr_random_sweep():
    """Randomized LP/QP/SOCP mix through the qr backend: first-
    principles residual checks (the backend must be a drop-in for lu)."""
    rng = np.random.default_rng(7)
    for t in range(12):
        n = int(rng.integers(4, 16))
        F = rng.standard_normal((n, max(2, n // 2)))
        P = F @ F.T + 0.1 * np.eye(n) if t % 3 else None
        q = rng.standard_normal(n)
        rows = [np.ones((1, n)), -np.eye(n)]
        b = np.concatenate([[1.0], np.zeros(n)])
        cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(n)]
        if t % 2:
            G = rng.standard_normal((3, n)) / 3.0
            soc = np.vstack([np.zeros((1, n)), -G])
            rows.append(soc)
            b = np.concatenate([b, [1.5], np.zeros(3)])
            cones.append(cc.SecondOrderConeT(4))
        A = np.vstack(rows)
        sol = cc.Solver(P, q, A, b, cones, kkt_solve_method="qr").solve()
        assert sol.status == cc.SolverStatus.SOLVED, (t, sol.status)
        rp = np.abs(A @ sol.x + sol.s - b).max()
        Pd = P if P is not None else np.zeros((n, n))
        rd = np.abs(Pd @ sol.x + q + A.T @ sol.z).max()
        scale = 1 + np.abs(sol.x).max()
        assert rp < 1e-7 * scale and rd < 1e-7 * scale, (t, rp, rd)


def test_auto_resolution_on_gpu_is_lu(monkeypatch):
    # qr is selectable but never chosen by "auto": on a GPU (native
    # f64 LU) auto is pivoted LU at every precision
    from cuclarabel_tpu.kkt.dense import resolve_kkt_method
    from cuclarabel_tpu.settings import Settings

    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_kkt_method(Settings()) == "lu"
    assert resolve_kkt_method(
        Settings(kkt_factor_precision="float32")) == "lu"
    assert resolve_kkt_method(Settings(kkt_solve_method="qr")) == "qr"
