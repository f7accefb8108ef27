"""Randomized range-finder sketching: the low-rank extraction primitive.

Counterpart of ``repro.updates.sketch``.  A dense delta Δ is sketched as

    Y = Δ @ Ω            Ω: (n, l) fixed Gaussian test matrix, l = k + p
    Q = qr(Y)            (power iterations re-orthonormalise Δᵀ passes)
    B = Qᵀ @ Δ           Δ ≈ Q @ B, exactly when l >= rank(Δ)

and ``B`` is factored without a dense SVD: ``Bᵀ = Q₂R₂`` (tall QR), then
the (2l, 2l) Jordan–Wielandt eigendecomposition of ``R₂ᵀ`` (eigenpairs
``±σᵢ`` with vectors ``[uᵢ; ±vᵢ]/√2``), so singular values come out
unsquared.  A ``Sparse`` delta runs the two-sided single-pass sketch
(Tropp, Yurtsever, Udell & Cevher, arXiv:1609.00048): ``Y = SΩ`` and
``W = SᵀΨ`` through ``kernels.sparse_proj.sparse_project`` (kernel F on a
card), then the small core ``C = (ΨᵀQ)⁻¹ (ΨᵀY) (PᵀΩ)⁻¹``.

The test matrices are the reference's: numpy Philox draws with fixed seeds,
bitwise the same on every platform, moved to the device once per
(n, l, seed, dtype, device).  QR, solve and eigh go to ``torch.linalg``, as
the reference leaves them to XLA.  ``warmup_sketch`` runs a geometry's
sketch once on zeros before traffic, as the reference's does: that puts the
test matrices on the device, builds kernel F's library and initialises the
solver libraries, so the first event under traffic pays for none of it.

>>> import numpy as np
>>> rng = np.random.default_rng(0)
>>> delta = torch.as_tensor(rng.normal(size=(9, 3)) @ rng.normal(size=(3, 7)))  # rank 3
>>> u, s, v = sketch_svd(delta, k=3)
>>> tuple(u.shape), tuple(s.shape), tuple(v.shape)
((9, 3), (3,), (7, 3))
>>> bool(torch.allclose((u * s) @ v.mT, delta, atol=1e-9))
True
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.sparse_proj import sparse_project

__all__ = [
    "factored_svd",
    "range_finder",
    "sample_count",
    "sketch_svd",
    "sparse_sketch_svd",
    "warmup_sketch",
]

# the reference's seeds: _SEED draws the range sketch Ω, _SEED_CORANGE the
# co-range sketch Ψ of the sparse single-pass path
_SEED = 0
_SEED_CORANGE = 1


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def sample_count(k: int, oversample: int, m: int, n: int) -> int:
    """Sample columns l = min(k + oversample, m, n) the range-finder draws.

    >>> sample_count(8, 8, 1024, 1024), sample_count(8, 8, 4, 6)
    (16, 4)
    """
    return max(1, min(k + oversample, m, n))


@functools.lru_cache(maxsize=None)
def _test_matrix_np(n: int, l: int, seed: int) -> np.ndarray:
    return np.random.Generator(np.random.Philox(seed)).standard_normal((n, l))


@functools.lru_cache(maxsize=64)
def _test_matrix(n: int, l: int, dtype: torch.dtype, device: torch.device,
                 seed: int = _SEED) -> torch.Tensor:
    """The (n, l) test matrix on ``device``; callers must not write to it."""
    return torch.as_tensor(_test_matrix_np(n, l, seed)).to(device=device, dtype=dtype)


def _small_svd(c):
    """SVD of a small square core ``c`` (..., l, l) through one (2l, 2l) eigh
    of the Jordan–Wielandt embedding [[0, C], [Cᵀ, 0]]."""
    l = c.shape[-1]
    zero = torch.zeros_like(c)
    mtx = torch.cat([torch.cat([zero, c], dim=-1), torch.cat([c.mT, zero], dim=-1)], dim=-2)
    w, vecs = torch.linalg.eigh(mtx)                  # ascending: -σ₁ ... +σ₁
    s = torch.clamp(w.flip(-1)[..., :l], min=0.0)     # top l = +σ, descending
    vecs = vecs.flip(-1)[..., :, :l]

    def _unit(x):
        # each half has norm 1/√2 for σ > 0; the halves of σ = 0 are arbitrary
        # but their components vanish (u·σ = 0), so the guard is harmless
        nrm = torch.linalg.vector_norm(x, dim=-2, keepdim=True)
        return x / torch.where(nrm > 0, nrm, 1.0)

    return _unit(vecs[..., :l, :]), s, _unit(vecs[..., l:, :])


def _qb_svd(q, b):
    """(u, s, v) of ``Q @ B`` from the range-finder pair: tall QR of Bᵀ, then
    the Jordan–Wielandt core."""
    q2, r2 = torch.linalg.qr(b.mT)                     # Bᵀ = Q₂R₂
    uc, s, vc = _small_svd(r2.mT)                      # R₂ᵀ (l, l)
    return q @ uc, s, q2 @ vc


def _topk(u, s, v, k: int):
    """Top-k triplets, zero-padded up to k when fewer samples exist (a zero
    component binds to a zero rank-1 pair, an exact no-op update)."""
    l = s.shape[-1]
    if l >= k:
        return u[..., :, :k], s[..., :k], v[..., :, :k]
    pad = lambda x: torch.nn.functional.pad(x, (0, k - l))  # noqa: E731
    return pad(u), pad(s), pad(v)


def factored_svd(q, b, k: int):
    """Top-k triplets of the already-factored product ``q @ b``: ``q``
    (..., m, l) with orthonormal columns, ``b`` (..., l, n)."""
    return _topk(*_qb_svd(_tensor(q), _tensor(b)), k)


def range_finder(delta, k: int, *, oversample: int = 8, power_iters: int = 1):
    """The QB decomposition ``delta ≈ q @ b``: ``q`` (..., m, l), ``b``
    (..., l, n) with ``l = sample_count(k, oversample, m, n)``; exact whenever
    ``l >= rank(delta)``."""
    delta = _tensor(delta)
    m, n = delta.shape[-2:]
    l = sample_count(k, oversample, m, n)
    omega = _test_matrix(n, l, delta.dtype, delta.device)
    q, _ = torch.linalg.qr(delta @ omega)
    for _ in range(power_iters):
        z, _ = torch.linalg.qr(delta.mT @ q)
        q, _ = torch.linalg.qr(delta @ z)
    return q, q.mT @ delta


def sketch_svd(delta, k: int, *, oversample: int = 8, power_iters: int = 1):
    """Top-k SVD triplets ``(u, s, v)`` of ``delta`` (..., m, n) through the
    range-finder; leading batch axes run batched."""
    q, b = range_finder(delta, k, oversample=oversample, power_iters=power_iters)
    return _topk(*_qb_svd(q, b), k)


def sparse_sketch_svd(rows, cols, vals, *, m: int, n: int, k: int, oversample: int = 8):
    """Top-k triplets of the COO delta ``S[rows[e], cols[e]] += vals[e]`` on
    geometry (m, n): the ``Sparse`` op's lowering.  The two projections run
    where ``vals`` (…, nnz) lives (kernel F on a card).

        Y = S Ω,  W = Sᵀ Ψ          (independent fixed test matrices)
        Q = qr(Y),  P = qr(W)
        C = (ΨᵀQ)⁻¹ (ΨᵀY) (PᵀΩ)⁻¹  (small l x l solves)
        S ≈ Q C Pᵀ                   (exact whenever l >= rank(S))
    """
    vals = _tensor(vals)
    l = sample_count(k, oversample, m, n)
    omega = _test_matrix(n, l, vals.dtype, vals.device)                    # Ω: (n, l)
    psi = _test_matrix(m, l, vals.dtype, vals.device, seed=_SEED_CORANGE)  # Ψ: (m, l)
    y = sparse_project(rows, cols, vals, omega, m)             # S Ω: (.., m, l)
    w = sparse_project(cols, rows, vals, psi, n)               # SᵀΨ: (.., n, l)
    q, _ = torch.linalg.qr(y)
    p, _ = torch.linalg.qr(w)
    mid = psi.mT @ y                                           # ΨᵀY  (l, l)
    a = psi.mT @ q                                             # ΨᵀQ  (l, l)
    b = p.mT @ omega                                           # PᵀΩ  (l, l)
    # a and b are (rotated) l x l Gaussians: generically invertible and well
    # conditioned; in the exact regime the solves recover C = QᵀSP
    c = torch.linalg.solve(a, mid)                             # A⁻¹ (ΨᵀY)
    c = torch.linalg.solve(b.mT, c.mT).mT                      # ... (PᵀΩ)⁻¹
    uc, s, vc = _qb_svd(q, c)                                  # Q C = u s vcᵀ
    return _topk(uc, s, p @ vc, k)


def warmup_sketch(*, m: int, n: int, k: int, oversample: int = 8, power_iters: int = 1,
                  nnz: int | None = None, batch: int | None = None, dtype=torch.float64,
                  device="cuda"):
    """Run one geometry's sketch on zeros on ``device`` and wait for it
    (``planner.warmup_plan`` and the service's restore call this).
    ``nnz=None`` warms the dense range-finder, else the sparse single-pass
    sketch (kernel F on a card); ``batch`` the stacked form.  Returns the
    sketch's output, as the reference's does."""
    from repro_torch.api.policy import as_torch_dtype
    from repro_torch.api.state import resolve_device

    dev = resolve_device(device)
    dt = as_torch_dtype(dtype)
    lead = () if batch is None else (batch,)
    if nnz is None:
        out = sketch_svd(torch.zeros(lead + (m, n), dtype=dt, device=dev), k,
                         oversample=oversample, power_iters=power_iters)
    else:
        # the sparse single-pass path has no power_iters knob
        idx = torch.zeros(lead + (nnz,), dtype=torch.int32, device=dev)
        out = sparse_sketch_svd(idx, idx, torch.zeros(lead + (nnz,), dtype=dt, device=dev),
                                m=m, n=n, k=k, oversample=oversample)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out
