"""Test configuration: x64 on, and the CPU backend with 8 virtual devices
so that sharding tests run without accelerators.

JAX_PLATFORMS defaults to "cpu".  Tests marked `gpu` need an NVIDIA GPU
and skip without one; on a GPU machine run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# No persistent compilation cache for test runs: XLA:CPU executables
# compiled on one host can crash when loaded on another, and a test
# run should compile what it tests.
os.environ["JAX_COMPILATION_CACHE_DIR"] = ""

import jax  # noqa: E402

# a pytest plugin may have imported jax before the lines above ran
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_compilation_cache_dir", None)
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test, deselected with -m 'not slow'")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    A full-suite run accumulates hundreds of live XLA:CPU executables
    (the sparse multifrontal ones are huge level-scheduled programs);
    late in the process the CPU compiler aborts (SIGABRT inside
    backend_compile_and_load) even with system memory free.  Modules
    barely share programs, so dropping the caches between them costs
    little and keeps the compiler healthy."""
    yield
    jax.clear_caches()
