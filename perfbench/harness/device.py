"""The card a run measures: the check that it is there, its name, its power
limit, and the check that no JAX module was loaded."""

from __future__ import annotations

import shutil
import subprocess
import sys

# top-level module names a run may not load (compared whole: ``repro_torch``
# is the port, ``repro`` the JAX package)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    """The run found fewer CUDA cards than its cell needs."""


def require_cards(chips: int) -> None:
    """Raise ``NoCard`` unless ``chips`` CUDA cards are visible: a run never
    falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark runs on an NVIDIA card "
                     "and never on the CPU")
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f"the cell needs {chips} CUDA cards and {n} are visible")


def card_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def power_limit_w() -> float | None:
    """The card's power limit in W as ``nvidia-smi`` reads it (None where it
    cannot): a share of a published peak is stated beside it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def forbidden_modules_loaded(names=None) -> list[str]:
    """Top-level names among ``names`` (``sys.modules`` by default) that a run
    may not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def sync(device) -> None:
    """Wait for ``device`` (a no-op off CUDA)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The peak of allocated memory on ``device`` so far (0 off CUDA)."""
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
