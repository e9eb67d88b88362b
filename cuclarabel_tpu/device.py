"""The one place that asks what the default JAX backend is.

Every platform decision in the package (host routing of lone solves,
device-memory budgets) reads `accelerator()` instead of matching
backend names itself.  `gpu_name_and_power()` is the card's name and
power limit that every measurement is recorded beside.
"""

import subprocess
from typing import Optional

import jax


def accelerator() -> Optional[str]:
    """Platform name of the default backend when it is an accelerator
    (``"gpu"`` for a CUDA device), or None when it is the host CPU."""
    platform = jax.default_backend()
    return None if platform == "cpu" else platform


def gpu_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    run as a child process (one line per card), or why it is missing."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
