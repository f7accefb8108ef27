"""On-the-fly Cauchy matrix product (Trummer's hot spot).

Counterpart of ``repro.kernels.cauchy_matmul``:

    out[b, r, i] = sum_j w[b, r, j] / ((src_bj - av_bi) - tau_bi) * tmask_bi,

a zero denominator contributing 0.  ``cauchy_matmul_plain`` is the plain
PyTorch version; ``cauchy_matmul_cuda`` launches the hand-written kernel of
``csrc/cauchy_matmul.cu``, which builds each panel of Cauchy entries once in
shared memory (shared over a thread-block cluster where the panels alone
leave SMs idle) so the (N, M) matrix never reaches device memory, and
contracts f64 on the tensor cores.  ``cauchy_plan`` gives the plan the kernel
takes; ``cauchy_matmul_cuda_planned`` runs it on another plan (the bits do not
depend on the plan).  ``cauchy_matmul`` picks by the device of ``w``: CPU
takes the plain version, CUDA the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["cauchy_matmul", "cauchy_matmul_cuda", "cauchy_matmul_cuda_planned",
           "cauchy_matmul_plain", "cauchy_plan"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def cauchy_matmul_plain(w, src, anchor_vals, tau, tgt_mask):
    """``w`` (B, R, N), ``src`` (B, N), ``anchor_vals``/``tau``/``tgt_mask``
    (B, M) -> (B, R, M).  Invalid sources must be zero in ``w``."""
    denom = (src[:, :, None] - anchor_vals[:, None, :]) - tau[:, None, :]
    safe = torch.where(denom == 0.0, 1.0, denom)
    c = torch.where(denom != 0.0, 1.0 / safe, 0.0) * tgt_mask.to(w.dtype)[:, None, :]
    return w @ c


def cauchy_plan(bsz: int, r: int, n: int, m: int, dtype=torch.float64) -> dict:
    """The plan kernel C takes for ``bsz`` members of (r, n) x (n, m) in
    ``dtype``: ``targets`` a panel (16, 32 or 48) and ``cluster``, the blocks
    that share a panel (1, 2, 4 or 8)."""
    mt, csz = ctypes.c_int(0), ctypes.c_int(0)
    _build.library("cauchy_matmul").cauchy_plan(int(dtype == torch.float64), bsz, r, n, m,
                                                ctypes.byref(mt), ctypes.byref(csz))
    return {"targets": 16 * mt.value, "cluster": csz.value}


def cauchy_matmul_cuda(w, src, anchor_vals, tau, tgt_mask):
    """Kernel C: the same function on CUDA tensors (f32 or f64)."""
    return _launch(w, src, anchor_vals, tau, tgt_mask, None)


def cauchy_matmul_cuda_planned(w, src, anchor_vals, tau, tgt_mask, *, targets: int, cluster: int):
    """Kernel C on a given plan (``cauchy_plan``'s keys): ``targets`` 16, 32
    or 48, ``cluster`` 1, 2, 4 or 8."""
    if targets not in (16, 32, 48) or cluster not in (1, 2, 4, 8):
        raise ValueError(f"plan: targets 16, 32 or 48 and cluster 1, 2, 4 or 8; got "
                         f"{targets}, {cluster}")
    return _launch(w, src, anchor_vals, tau, tgt_mask, (targets // 16, cluster))


def _launch(w, src, anchor_vals, tau, tgt_mask, plan):
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
    lib = _build.library("cauchy_matmul")
    ptrs = _build.ptrs(w, src, anchor_vals, tau, tm, out)
    _build.LAUNCHES["cauchy_matmul"] += 1
    if plan is None:
        err = getattr(lib, f"cauchy_matmul_{_SUFFIX[dt]}")(*ptrs, bsz, r, n, m, _build.stream())
    else:
        err = getattr(lib, f"cauchy_matmul_planned_{_SUFFIX[dt]}")(*ptrs, bsz, r, n, m, *plan,
                                                                  _build.stream())
    _build.check(err, "cauchy_matmul")
    return out


def cauchy_matmul(w, src, anchor_vals, tau, tgt_mask):
    """The plain version for CPU tensors, kernel C for CUDA tensors."""
    if w.is_cuda:
        return cauchy_matmul_cuda(w, src, anchor_vals, tau, tgt_mask)
    return cauchy_matmul_plain(w, src, anchor_vals, tau, tgt_mask)
