"""FMM near-field block products with the Cauchy blocks built on the fly.

Counterpart of ``repro.kernels.nearfield``.  For each leaf box of an FMM
plan, the box's targets against the sources of boxes b-1, b, b+1:

    out[b, r, box, t] = sum_c w_near[b, r, box, c] * tm[b, box, t]
                        / ((av[b, box, t] - x[b, box, c]) + tau[b, box, t]),

a zero denominator contributing 0.  ``w_near`` (B, R, nb, 3cap) must be zero
at invalid source slots; ``x_near`` is (B, nb, 3cap), ``av_b`` / ``tau_b`` /
``tgt_mask`` are (B, nb, capt).  Note the sign: the denominator is
``y - x``, the opposite of kernel C's ``(src - av) - tau``.

``nearfield_plain`` is the plain PyTorch version (it builds the (3cap, capt)
blocks in memory); ``nearfield_cuda`` launches kernel E
(``csrc/nearfield.cu``), which builds each block tile in shared memory, so
the blocks never reach device memory.  ``nearfield`` picks by the device of
``w_near``: CPU takes the plain version, CUDA the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["nearfield", "nearfield_cuda", "nearfield_plain"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def nearfield_plain(w_near, x_near, av_b, tau_b, tgt_mask):
    """(B, R, nb, 3cap) weights -> (B, R, nb, capt)."""
    denom = (av_b[:, :, None, :] - x_near[:, :, :, None]) + tau_b[:, :, None, :]
    safe = torch.where(denom == 0.0, 1.0, denom)
    c = torch.where(denom != 0.0, 1.0 / safe, 0.0) * tgt_mask.to(w_near.dtype)[:, :, None, :]
    return torch.einsum("zrbc,zbct->zrbt", w_near, c)


def nearfield_cuda(w_near, x_near, av_b, tau_b, tgt_mask):
    """Kernel E: the same function on CUDA tensors (f32 or f64)."""
    bsz, r, nb, c3 = w_near.shape
    capt = av_b.shape[-1]
    dt = w_near.dtype
    if dt not in _SUFFIX:
        raise NotImplementedError(f"the near-field kernel takes f32 or f64; got {dt}")
    tm = tgt_mask.to(dt)
    shapes = {"x_near": (bsz, nb, c3), "av_b": (bsz, nb, capt), "tau_b": (bsz, nb, capt),
              "tgt_mask": (bsz, nb, capt)}
    for name, x in zip(shapes, (x_near, av_b, tau_b, tm)):
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}; got {tuple(x.shape)}")
    for name, x in (("w_near", w_near), ("x_near", x_near), ("av_b", av_b), ("tau_b", tau_b),
                    ("tgt_mask", tm)):
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous CUDA {dt} tensor; got "
                             f"{x.dtype} on {x.device}, contiguous={x.is_contiguous()}")
    out = torch.empty((bsz, r, nb, capt), dtype=dt, device=w_near.device)
    if out.numel() == 0:
        return out
    fn = getattr(_build.library("nearfield"), f"nearfield_{_SUFFIX[dt]}")
    _build.LAUNCHES["nearfield"] += 1
    _build.check(fn(*_build.ptrs(w_near, x_near, av_b, tau_b, tm, out), bsz, r, nb, c3, capt,
                    _build.stream()), "nearfield")
    return out


def nearfield(w_near, x_near, av_b, tau_b, tgt_mask):
    """The plain version for CPU tensors, kernel E for CUDA tensors."""
    if w_near.is_cuda:
        return nearfield_cuda(w_near, x_near, av_b, tau_b, tgt_mask)
    return nearfield_plain(w_near, x_near, av_b, tau_b, tgt_mask)
