"""Shared helpers of the ``test_torch_*`` parity tests (not collected itself).

The reference package is imported under a local DeprecationWarning filter:
on jax 0.9 ``repro.core.engine`` imports ``jax.experimental.shard_map``,
which warns, and the repository's pytest settings turn warnings raised from
``repro.*`` into errors.
"""

from __future__ import annotations

import importlib
import warnings

import numpy as np
import pytest
import torch


def ref(module: str):
    """Import ``repro.<module>`` with the shard_map deprecation silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return importlib.import_module(f"repro.{module}")


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip when the machine has no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def t(x, dtype=torch.float64, device="cpu"):
    """numpy -> torch with a leading batch axis already present in ``x``."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def np_(x):
    return np.asarray(x.detach().cpu().float() if x.dtype.itemsize <= 2 else x.detach().cpu())


def svd_problem(rng, m, n, *, repeated=False):
    """Factors of a random (m, n) matrix and a rank-1 pair, as numpy arrays."""
    a_mat = rng.uniform(1, 9, (m, n))
    u, s, vt = np.linalg.svd(a_mat)
    if repeated:
        s = s.copy()
        s[1:3] = s[1]
    return u, s, vt.T.copy(), rng.normal(size=m), rng.normal(size=n)


def spectrum_problem(rng, m, n, r=None):
    """Orthonormal factors, singular values 100 .. 1 (geometric: none
    dominant, gaps wide enough for float32) and a pair with |a| |b| the median
    singular value: a full state (``r=None``) or a rank-r one, as numpy."""
    k = m if r is None else r
    u = np.linalg.qr(rng.normal(size=(m, k)))[0]
    v = np.linalg.qr(rng.normal(size=(n, n if r is None else r)))[0]
    s = np.geomspace(100.0, 1.0, k)
    a, b = rng.normal(size=m), rng.normal(size=n)
    b *= np.median(s) / (np.linalg.norm(a) * np.linalg.norm(b))
    return u, s, v, a, b


def truncated_problem(rng, m, n, r, *, true_rank=None):
    """Rank-r factors of a random matrix (of rank ``true_rank`` if given)."""
    if true_rank is None:
        a_mat = rng.normal(size=(m, n))
    else:
        a_mat = rng.normal(size=(m, true_rank)) @ rng.normal(size=(true_rank, n))
    u, s, vt = np.linalg.svd(a_mat, full_matrices=False)
    return (u[:, :r].copy(), s[:r].copy(), vt[:r].T.copy(), rng.normal(size=m),
            rng.normal(size=n))
