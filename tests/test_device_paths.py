"""Platform decisions and the dense KKT methods that every backend runs.

* `device.accelerator()` is the one capability function; the KKT
  resolver sends "auto" to pivoted LU whatever it reports.
* lu / inverse / qr each solve a quasidefinite KKT system at the
  portfolio bench's N_kkt=76 to f64 accuracy, alone and under vmap.
* the removed double-float engine is refused by validation.
* the persistent compile cache lands where the package says.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuclarabel_tpu.device import accelerator, gpu_name_and_power
from cuclarabel_tpu.kkt.dense import make_dense_kkt, resolve_kkt_method
from cuclarabel_tpu.settings import Settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gpu_name_and_power_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvidia-smi on it
    assert gpu_name_and_power().startswith("nvidia-smi unavailable")


@pytest.mark.parametrize("backend, expected", [
    ("gpu", "gpu"), ("cpu", None), ("rocm", "rocm"),
])
def test_accelerator_reads_default_backend(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert accelerator() == expected


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
@pytest.mark.parametrize("method, expected", [
    ("auto", "lu"), ("lu", "lu"), ("inverse", "inverse"), ("qr", "qr"),
])
def test_resolve_kkt_method_ignores_backend(monkeypatch, backend, method,
                                            expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resolve_kkt_method(Settings(kkt_solve_method=method)) == expected


def test_pallas_method_rejected_as_removed():
    with pytest.raises(ValueError, match="removed"):
        Settings(kkt_solve_method="pallas").validate()


def _quasidefinite(n, m, rng):
    F = rng.standard_normal((n, n))
    P = F @ F.T / n + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n))
    # Hs spanning several orders of magnitude, as late in an IPM
    Hs = np.diag(10.0 ** rng.uniform(-3, 3, m))
    return P, A, Hs


@pytest.mark.parametrize("method", ["lu", "inverse", "qr"])
def test_dense_kkt_method_matches_numpy(method):
    n, m = 33, 43  # the portfolio bench's N_kkt = 76
    rng = np.random.default_rng(0)
    factorize, solve = make_dense_kkt(
        n, m, Settings(kkt_solve_method=method), jnp.float64)

    def kkt(P, A, Hs, rx, rz):
        fac, ok = factorize(P, A, Hs)
        x, z, ok2, _ = solve(fac, rx, rz)
        return x, z, ok & ok2

    B = 4
    probs = [_quasidefinite(n, m, rng) for _ in range(B)]
    rhs = rng.standard_normal((B, n + m))
    single = []
    for (P, A, Hs), r in zip(probs, rhs):
        x, z, ok = jax.jit(kkt)(P, A, Hs, r[:n], r[n:])
        assert bool(ok)
        K = np.block([[P, A.T], [A, -Hs]])
        ref = np.linalg.solve(K, r)
        got = np.concatenate([x, z])
        assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()
        single.append(got)

    stack = [np.stack(a) for a in zip(*probs)]
    xb, zb, okb = jax.jit(jax.vmap(kkt))(*stack, rhs[:, :n], rhs[:, n:])
    assert bool(np.all(okb))
    np.testing.assert_allclose(np.concatenate([xb, zb], axis=1),
                               np.stack(single), rtol=0, atol=1e-12)


def _cache_dir_in_subprocess(env_update, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update)
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c",
         "import cuclarabel_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


# importing the package initializes no backend, so "cuda" is safe to
# name on a machine without one
@pytest.mark.parametrize("platforms", ["cpu", "cuda"])
def test_cache_dir_unset_lands_in_checkout(platforms):
    got = _cache_dir_in_subprocess(
        {"JAX_PLATFORMS": platforms}, drop=("JAX_COMPILATION_CACHE_DIR",))
    # one per-host-fingerprint subdirectory, whatever the backend: GPU
    # processes compile XLA:CPU programs too
    assert os.path.dirname(got) == os.path.join(REPO, ".jax_cache")
    assert os.path.basename(got).startswith("host-")
    assert got == _cache_dir_in_subprocess(
        {"JAX_PLATFORMS": "cpu" if platforms == "cuda" else "cuda"},
        drop=("JAX_COMPILATION_CACHE_DIR",))


def test_cache_dir_env_is_the_only_one(tmp_path):
    want = str(tmp_path / "cache")
    got = _cache_dir_in_subprocess(
        {"JAX_COMPILATION_CACHE_DIR": want, "JAX_PLATFORMS": "cpu"})
    assert got == want
