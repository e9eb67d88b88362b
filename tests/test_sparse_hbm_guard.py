"""The sparse multifrontal refuses dispatches whose memory plan exceeds
the device-memory budget (an oversized N=20001 plan once took the
device down instead of failing cleanly), and the budget follows the
device's own memory statistics."""

import numpy as np
import pytest
import scipy.sparse as sp

import cuclarabel_tpu as cc
from cuclarabel_tpu.sparse_solver import SparseSolver


def _tiny_qp():
    n = 12
    P = sp.diags(np.ones(n)).tocsc()
    A = sp.vstack([sp.eye(n) * -1.0]).tocsc()
    b = np.zeros(n)
    q = -np.ones(n)
    return P, q, A, b, [cc.NonnegativeConeT(n)]


def test_guard_refuses_over_budget(monkeypatch):
    monkeypatch.setenv("CUCLARABEL_SPARSE_HBM_BUDGET", "1000")  # 1 kB
    P, q, A, b, cones = _tiny_qp()
    with pytest.raises(MemoryError, match="device memory"):
        SparseSolver(P, q, A, b, cones)


def test_guard_passes_under_budget(monkeypatch):
    monkeypatch.setenv("CUCLARABEL_SPARSE_HBM_BUDGET", str(int(8e9)))
    P, q, A, b, cones = _tiny_qp()
    sol = SparseSolver(P, q, A, b, cones).solve()
    assert sol.status == cc.SolverStatus.SOLVED
    np.testing.assert_allclose(sol.x, np.ones(12), atol=1e-7)


def test_memory_estimate_monotone():
    """The estimate grows with problem size and is plausibly sized."""
    from cuclarabel_tpu.kkt.sparse_kkt import SparseProblem, make_sparse_kkt
    from cuclarabel_tpu.cones.layout import build_layout
    from cuclarabel_tpu.settings import Settings

    def est(k):
        n = k * k
        # 2-D grid Laplacian-ish pattern
        rows, cols = [], []
        for i in range(n):
            rows.append(i), cols.append(i)
            if (i + 1) % k:
                rows.append(i), cols.append(i + 1)
            if i + k < n:
                rows.append(i), cols.append(i + k)
        P = sp.coo_matrix(
            (np.ones(len(rows)), (rows, cols)), shape=(n, n)
        ).tocsc()
        A = (-sp.eye(n)).tocsc()
        spp = SparseProblem.from_scipy(P, A)
        layout = build_layout((cc.NonnegativeConeT(n),))
        _, _, bufs = make_sparse_kkt(n, n, Settings(), layout, spp)
        # reach the plan through the memoized factorize fn's info
        from cuclarabel_tpu.kkt import sparse_kkt as st

        fac, _, _ = make_sparse_kkt(n, n, Settings(), layout, spp)
        return sum(v.nbytes for v in bufs.values())

    assert est(8) < est(16)


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats, expected", [
    # an 80 GB card with JAX's default 75 % reservation: a quarter of
    # the allocator limit (XLA holds ~4 live copies of a plan)
    ({"bytes_limit": 60_000_000_000, "bytes_in_use": 0}, 15_000_000_000),
    # XLA:CPU reports no statistics: the documented host default
    (None, 8_000_000_000),
    ({"bytes_in_use": 0}, 8_000_000_000),
])
def test_budget_from_memory_stats(monkeypatch, stats, expected):
    from cuclarabel_tpu.kkt.sparse_kkt import (
        HOST_MEMORY_BUDGET, memory_budget_bytes)

    monkeypatch.delenv("CUCLARABEL_SPARSE_HBM_BUDGET", raising=False)
    assert HOST_MEMORY_BUDGET == 8e9
    assert memory_budget_bytes(_FakeDevice(stats)) == expected


def test_budget_env_override_wins(monkeypatch):
    from cuclarabel_tpu.kkt.sparse_kkt import memory_budget_bytes

    monkeypatch.setenv("CUCLARABEL_SPARSE_HBM_BUDGET", "1.5e9")
    dev = _FakeDevice({"bytes_limit": 60_000_000_000})
    assert memory_budget_bytes(dev) == 1_500_000_000


def test_budget_reads_default_device(monkeypatch):
    # no device given: the first device's statistics decide
    import jax

    from cuclarabel_tpu.kkt.sparse_kkt import memory_budget_bytes

    monkeypatch.delenv("CUCLARABEL_SPARSE_HBM_BUDGET", raising=False)
    monkeypatch.setattr(
        jax, "devices",
        lambda *a: [_FakeDevice({"bytes_limit": 4_000_000_000})])
    assert memory_budget_bytes() == 1_000_000_000
