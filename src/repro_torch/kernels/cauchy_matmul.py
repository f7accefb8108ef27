"""On-the-fly Cauchy matrix product (Trummer's hot spot).

Counterpart of ``repro.kernels.cauchy_matmul``:

    out[b, r, i] = sum_j w[b, r, j] / ((src_bj - av_bi) - tau_bi) * tmask_bi,

a zero denominator contributing 0.  ``cauchy_matmul_plain`` is the plain
PyTorch version; ``cauchy_matmul_cuda`` launches the hand-written kernel of
``csrc/cauchy_matmul.cu``, which builds each Cauchy tile in shared memory so
the (N, M) matrix never reaches device memory.  ``cauchy_matmul`` picks by
the device of ``w``: CPU takes the plain version, CUDA the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["cauchy_matmul", "cauchy_matmul_cuda", "cauchy_matmul_plain"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def cauchy_matmul_plain(w, src, anchor_vals, tau, tgt_mask):
    """``w`` (B, R, N), ``src`` (B, N), ``anchor_vals``/``tau``/``tgt_mask``
    (B, M) -> (B, R, M).  Invalid sources must be zero in ``w``."""
    denom = (src[:, :, None] - anchor_vals[:, None, :]) - tau[:, None, :]
    safe = torch.where(denom == 0.0, 1.0, denom)
    c = torch.where(denom != 0.0, 1.0 / safe, 0.0) * tgt_mask.to(w.dtype)[:, None, :]
    return w @ c


def cauchy_matmul_cuda(w, src, anchor_vals, tau, tgt_mask):
    """Kernel C: the same function on CUDA tensors (f32 or f64)."""
    bsz, r, n = w.shape
    m = anchor_vals.shape[1]
    dt = w.dtype
    if dt not in _SUFFIX:
        raise NotImplementedError(f"the Cauchy kernel takes f32 or f64; got {dt}")
    tm = tgt_mask.to(dt)
    shapes = {"src": (bsz, n), "anchor_vals": (bsz, m), "tau": (bsz, m), "tgt_mask": (bsz, m)}
    for name, x in zip(shapes, (src, anchor_vals, tau, tm)):
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}; got {tuple(x.shape)}")
    for name, x in (("w", w), ("src", src), ("anchor_vals", anchor_vals), ("tau", tau),
                    ("tgt_mask", tm)):
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous CUDA {dt} tensor; got "
                             f"{x.dtype} on {x.device}, contiguous={x.is_contiguous()}")
    out = torch.empty((bsz, r, m), dtype=dt, device=w.device)
    if out.numel() == 0:
        return out
    fn = getattr(_build.library("cauchy_matmul"), f"cauchy_matmul_{_SUFFIX[dt]}")
    _build.LAUNCHES["cauchy_matmul"] += 1
    _build.check(fn(*_build.ptrs(w, src, anchor_vals, tau, tm, out), bsz, r, n, m,
                    _build.stream()), "cauchy_matmul")
    return out


def cauchy_matmul(w, src, anchor_vals, tau, tgt_mask):
    """The plain version for CPU tensors, kernel C for CUDA tensors."""
    if w.is_cuda:
        return cauchy_matmul_cuda(w, src, anchor_vals, tau, tgt_mask)
    return cauchy_matmul_plain(w, src, anchor_vals, tau, tgt_mask)
