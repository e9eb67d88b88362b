"""BatchSparseSolver: batched same-pattern sparse problems must match
per-problem SparseSolver results (status, objective, residuals)."""

import numpy as np
import pytest
import scipy.sparse as sp

from cuclarabel_tpu.cones import api
from cuclarabel_tpu.parallel import BatchSparseSolver
from cuclarabel_tpu.settings import Settings
from cuclarabel_tpu.sparse_solver import SparseSolver


def _grid_family(k=8, B=5, seed=0, vary_values=False):
    rng = np.random.default_rng(seed)
    n = k * k
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (k, k))
    P = (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k))
         + sp.eye(n)).tocsc()
    A = sp.vstack([sp.csr_matrix(np.ones((1, n))), -sp.eye(n)]).tocsc()
    m = n + 1
    qs = rng.standard_normal((B, n))
    lbs = -1.0 - rng.random((B, n))
    bs = np.concatenate([np.ones((B, 1)), -lbs], axis=1)
    cones = [api.ZeroConeT(1), api.NonnegativeConeT(n)]
    P_vals = A_vals = None
    if vary_values:
        from cuclarabel_tpu.kkt.sparse_kkt import SparseProblem

        spp = SparseProblem.from_scipy(P, A)
        Pv0 = spp.P_vals(P)
        Av0 = spp.A_vals(A)
        P_vals = Pv0[None, :] * (1.0 + 0.3 * rng.random((B, Pv0.size)))
        A_vals = np.broadcast_to(Av0, (B,) + Av0.shape).copy()
    return P, qs, A, bs, cones, P_vals, A_vals


def test_batch_matches_single_qb_only():
    P, qs, A, bs, cones, _, _ = _grid_family(k=8, B=5, seed=0)
    batch = BatchSparseSolver(P, qs, A, bs, cones)
    sols = batch.solve()
    for i in range(len(sols)):
        ref = SparseSolver(
            P, qs[i], A, bs[i], cones,
            Settings(presolve_enable=False),
        ).solve()
        assert sols[i].status.name == "SOLVED"
        assert ref.status.name == "SOLVED"
        assert sols[i].obj_val == pytest.approx(ref.obj_val, abs=1e-7)
        np.testing.assert_allclose(sols[i].x, ref.x, atol=1e-6)


def test_batch_varying_matrix_values():
    """Per-problem P values over the shared pattern (scenario sweep)."""
    P, qs, A, bs, cones, P_vals, A_vals = _grid_family(
        k=6, B=4, seed=1, vary_values=True
    )
    batch = BatchSparseSolver(P, qs, A, bs, cones,
                              P_vals=P_vals, A_vals=A_vals)
    sols = batch.solve()
    from cuclarabel_tpu.kkt.sparse_kkt import SparseProblem

    for i, s in enumerate(sols):
        assert s.status.name == "SOLVED"
        # independent KKT residual of each scenario on its OWN data
        spp = SparseProblem.from_scipy(P, A)
        n = qs.shape[1]
        Pu = sp.coo_matrix(
            (P_vals[i], (spp.P_rows, spp.P_cols)), shape=(n, n)
        ).tocsc()
        Pi = Pu + sp.triu(Pu, 1).T
        rdual = np.abs(
            Pi @ s.x + qs[i] + np.asarray(A.T @ s.z).ravel()
        ).max()
        rprim = np.abs(np.asarray(A @ s.x).ravel() + s.s - bs[i]).max()
        scale = max(1.0, np.abs(bs[i]).max())
        assert rprim / scale < 1e-8
        assert rdual / scale < 1e-8


def test_batch_sparse_socp():
    """SOC rows exercise cone rectification in the device sparse
    equilibration."""
    rng = np.random.default_rng(3)
    B, n = 4, 12
    P = sp.eye(n).tocsc()
    qs = rng.standard_normal((B, n))
    # rows: sum(x) == 1; t = 2 (aux); ||x|| <= t via SOC(n+1)
    A = sp.vstack([
        sp.csr_matrix(np.ones((1, n))),
        sp.csr_matrix((1, n)),
        -sp.eye(n),
    ]).tocsc()
    bs = np.tile(
        np.concatenate([[1.0], [2.0], np.zeros(n)]), (B, 1)
    )
    cones = [api.ZeroConeT(1), api.SecondOrderConeT(n + 1)]
    sols = BatchSparseSolver(P, qs, A, bs, cones).solve()
    for i, s in enumerate(sols):
        assert s.status.name == "SOLVED"
        ref = SparseSolver(
            P, qs[i], A, bs[i], cones,
            Settings(presolve_enable=False),
        ).solve()
        assert s.obj_val == pytest.approx(ref.obj_val, abs=1e-6)


def test_batch_sparse_sdp_blocks():
    """PSD svec blocks ride the vmapped multifrontal (batched skron /
    eigh under vmap)."""
    rng = np.random.default_rng(9)
    B, sd = 3, 3  # 2x2 PSD blocks, svec dim 3
    n = 2 * sd
    tr = np.array([1.0, 0.0, 1.0])
    Aeq = np.zeros((2, n))
    Aeq[0, :sd] = tr
    Aeq[1, sd:] = tr
    A = sp.csc_matrix(np.vstack([Aeq, -np.eye(n)]))
    bs = np.tile(np.concatenate([[1.0, 1.0], np.zeros(n)]), (B, 1))
    qs = np.concatenate(
        [np.tile([1.0, 0.3, 1.5], (B, 1)),
         np.tile([2.0, -0.2, 0.7], (B, 1))], axis=1
    ) + 0.05 * rng.standard_normal((B, n))
    cones = [api.ZeroConeT(2), api.PSDTriangleConeT(2),
             api.PSDTriangleConeT(2)]
    sols = BatchSparseSolver(None, qs, A, bs, cones).solve()
    for i, s in enumerate(sols):
        assert s.status.name == "SOLVED"
        ref = SparseSolver(
            None, qs[i], A, bs[i], cones,
            Settings(presolve_enable=False),
        ).solve()
        assert s.obj_val == pytest.approx(ref.obj_val, abs=1e-6)


def test_batch_shards_over_devices():
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    P, qs, A, bs, cones, _, _ = _grid_family(k=6, B=8, seed=2)
    sols = BatchSparseSolver(P, qs, A, bs, cones, n_devices=4).solve()
    assert all(s.status.name == "SOLVED" for s in sols)


def test_batch_update_data_resolves():
    """update_data must re-solve with new values and no re-analysis."""
    P, qs, A, bs, cones, _, _ = _grid_family(k=6, B=3, seed=4)
    batch = BatchSparseSolver(P, qs, A, bs, cones)
    first = batch.solve()
    qs2 = qs * 2.0
    batch.update_data(q=qs2)
    second = batch.solve()
    for i in range(3):
        ref = SparseSolver(
            P, qs2[i], A, bs[i], cones,
            Settings(presolve_enable=False),
        ).solve()
        assert second[i].status.name == "SOLVED"
        assert second[i].obj_val == pytest.approx(ref.obj_val, abs=1e-7)
        assert second[i].obj_val != pytest.approx(first[i].obj_val,
                                                  abs=1e-9)
