"""Deterministic, shardable synthetic token stream, in PyTorch.

Counterpart of ``repro.data.synthetic``, equal to it to the bit for every
``(seed, step, batch, seq, vocab)``.  Restart-exact: batch contents are a
pure function of (seed, step, position), so resuming from a checkpoint at
step k reproduces the exact remaining stream with no reader state.
Host-sharded: each data-parallel rank materialises only its slice.

The stream mixes a hash-noise channel and a structured channel (integer
walks with skip patterns), so small models have a learnable signal.

The reference hashes in uint32.  PyTorch has no uint32 ``arange`` on the CPU
and incomplete uint32 arithmetic, so the hash runs in int64 on values kept
in ``[0, 2**32)``: every sum and product is reduced mod 2**32 at once
(``_mul32`` splits the constant in 16-bit halves, so no int64 product
overflows), and only such non-negative values are shifted.  The tokens are
generated on ``device`` (the card by default), so a training step copies
nothing from the host (the step's term is a host scalar).
"""

from __future__ import annotations

import torch

from repro_torch.api.state import resolve_device

__all__ = ["batch_for_step", "host_slice_for_step"]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)`` and a 32-bit constant:
    both partial products stay below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """xorshift-mult avalanche over uint32 (values in int64)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def batch_for_step(seed, step, *, batch: int, seq: int, vocab: int,
                   device="cuda") -> dict:
    """Global batch for ``step``: ``{"tokens", "labels"}``, int32 ``(batch, seq)``
    on ``device``.  ``seed`` and ``step`` count mod 2**32, as the reference's
    uint32 casts do."""
    dev = resolve_device(device)
    seed, step = int(seed) & _M32, int(step) & _M32
    rows = torch.arange(batch, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(seq + 1, dtype=torch.int64, device=dev)[None, :]
    base = (_hash_u32((_mul32(rows, 2_654_435_761) + seed) & _M32)
            + ((step * 0x9E3779B9) & _M32)) & _M32
    noise = _hash_u32((base + _mul32(cols, 0x85EBCA6B)) & _M32)

    # structured channel: arithmetic token walks (learnable)
    span = max(vocab - 1, 1)
    stride = _hash_u32(base) % 7 + 1
    start = _hash_u32((base + 13) & _M32)
    walk = ((start + cols * stride) & _M32) % span

    use_noise = _hash_u32((base + cols) & _M32) % 4 == 0  # 25% noise
    toks = torch.where(use_noise, noise % span, walk).to(torch.int32)
    return {"tokens": toks[:, :seq], "labels": toks[:, 1:]}


def host_slice_for_step(seed, step, *, batch, seq, vocab, rank, world, device="cuda"):
    """Only this host's rows (rank-sliced global batch)."""
    full = batch_for_step(seed, step, batch=batch, seq=seq, vocab=vocab, device=device)
    per = batch // world
    sl = slice(rank * per, (rank + 1) * per)
    return {k: v[sl] for k, v in full.items()}
