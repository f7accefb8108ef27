"""Persistent warmup: the kernels' build cache as a serving feature.

Counterpart of ``repro.api.cache``.  The reference persists XLA executables
(``jax_compilation_cache_dir``) so that a restarted service replays its
warmed geometries without recompiling.  The port compiles nothing per
geometry: PyTorch runs eagerly, and the only compiled artefacts are the CUDA
kernels' shared libraries, which ``kernels._build`` compiles with nvcc once
per source set into ``<root>/<hash>/lib<name>.so`` (the hash covers every
source and the flags, so a stale cache is never wrong, only cold).  This
module points that root at a directory of the caller's choosing, so that a
later process on the same machine loads the libraries instead of running
nvcc: that is all it does, and it is no XLA cache.

    api.enable_compilation_cache("/ckpts/kernel-cache")   # once, before traffic
    api.warmup(policy, m=512, n=768, rank=16, batch=16)    # builds -> disk
    # a fresh process restoring a service with cache_dir= loads them back
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["compilation_cache_entries", "enable_compilation_cache"]


def enable_compilation_cache(cache_dir: str | Path) -> Path:
    """Build and load the CUDA libraries under ``cache_dir`` (created if
    missing) from now on in this process; returns the directory.  Libraries
    already loaded stay loaded."""
    from repro_torch.kernels import _build

    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    _build.BUILD_ROOT = cache_dir
    return cache_dir


def compilation_cache_entries(cache_dir: str | Path) -> int:
    """Number of built libraries under ``cache_dir`` (0 for a missing
    directory).  A warm restore adds none."""
    cache_dir = Path(cache_dir)
    if not cache_dir.is_dir():
        return 0
    return sum(1 for _ in cache_dir.glob("*/lib*.so"))
