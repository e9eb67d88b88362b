"""host_solve routing policy (Settings.host_solve).

"on" routes a lone `Solver` solve to the in-process CPU device when the
default backend is an accelerator; "auto" and "off" never route.  These
tests pin the resolution rules (with the backend faked) and the
CPU-process no-op behavior."""

import numpy as np
import pytest

import cuclarabel_tpu as cc
from cuclarabel_tpu.settings import Settings
from cuclarabel_tpu.solver import _host_solve_device


def test_policy_inert_on_cpu_process():
    # conftest pins this process to the CPU backend: routing must be
    # off regardless of the setting (there is nothing to route away
    # from), and solves work normally
    assert _host_solve_device(Settings()) is None
    assert _host_solve_device(Settings(host_solve="on")) is None
    n = 6
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n)])
    s = cc.Solver(None, np.arange(1.0, n + 1), A, b,
                  [cc.ZeroConeT(1), cc.NonnegativeConeT(n)],
                  host_solve="on")
    sol = s.solve()
    assert sol.status == cc.SolverStatus.SOLVED
    assert s.info["linear_solver"]["host_solve"] is False


@pytest.fixture
def fake_gpu(monkeypatch):
    """Default backend faked as a GPU, with a stand-in CPU device."""
    import jax

    class _Dev:
        pass

    cpu = _Dev()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices",
                        lambda kind=None: [cpu] if kind == "cpu" else [])
    return cpu


@pytest.mark.parametrize("policy, method, routed", [
    ("on", "auto", True),
    ("on", "qr", True),  # an explicit method does not opt out
    ("auto", "auto", False),
    ("auto", "lu", False),
    ("off", "auto", False),
])
def test_policy_resolution_on_accelerator(fake_gpu, policy, method, routed):
    dev = _host_solve_device(
        Settings(host_solve=policy, kkt_solve_method=method))
    assert (dev is fake_gpu) if routed else (dev is None)


def test_routed_solve_keeps_the_requested_method(monkeypatch):
    # host_solve="on" in a (faked) GPU process: the lone solve runs on
    # the CPU device with the KKT method the user asked for
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    n = 6
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n)])
    s = cc.Solver(None, np.arange(1.0, n + 1), A, b,
                  [cc.ZeroConeT(1), cc.NonnegativeConeT(n)],
                  host_solve="on", kkt_solve_method="qr")
    sol = s.solve()
    assert sol.status == cc.SolverStatus.SOLVED
    info = s.info["linear_solver"]
    assert info["host_solve"] is True and info["method"] == "qr"


def test_validate_rejects_bad_value():
    with pytest.raises(ValueError, match="host_solve"):
        Settings(host_solve="maybe").validate()
