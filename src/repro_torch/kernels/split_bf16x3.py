"""The exact split of a float32 tensor into three bf16 planes, in chunks along
a contraction axis.

``split_bf16x3(g, dim, length)`` cuts ``g``'s axis ``dim`` (of size K) into
``c = ceil(K / length)`` chunks of ``length`` (the last one zero-padded) and
returns ``(c, *g.shape[:dim], 3, length, *g.shape[dim + 1:])`` in bf16: for
each chunk the planes ``(lo, mid, hi)``.  ``hi`` is ``g`` truncated to bf16
(its top 16 bits), ``mid`` the remainder truncated, ``lo`` what is left, each
with ``g``'s sign, each truncated toward zero, so that ``(hi + mid) + lo`` is
``g`` bit for bit in float32 wherever ``|g| >= 2**-110`` (~7.7e-34; below it
``lo``'s last bits fall under bf16's smallest subnormal) and for ``+-0``.  A non-finite ``g``
gives non-finite planes.  Each chunk's planes sit stacked along the
contraction, the smallest first, as a batched product takes them
(``models.layers._split_products``).

``repeat_bf16x3(x, dim, length)`` lays a bf16 ``x`` out the same way with its
chunk in all three planes: the other operand of such a product.

``*_plain`` are the plain PyTorch versions (the CPU's path and the kernels'
oracles); ``*_cuda`` launch ``csrc/split_bf16x3.cu``, which replaces no TPU
kernel: it exists so that the backward's float32 products run on the bf16
tensor cores at float32 accuracy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["repeat_bf16x3", "repeat_bf16x3_cuda", "repeat_bf16x3_plain", "split_bf16x3",
           "split_bf16x3_cuda", "split_bf16x3_plain"]


def _top16(x: torch.Tensor) -> torch.Tensor:
    """``x`` truncated toward zero to bf16's 8 significant bits, as float32."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _geometry(g: torch.Tensor, dim: int, length: int):
    dim = dim % g.dim()
    if length < 1:
        raise ValueError(f"split_bf16x3: chunk length must be positive; got {length}")
    return dim, -(-g.shape[dim] // length)


def split_bf16x3_plain(g: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    dim, c = _geometry(g, dim, length)
    pad = [0, 0] * (g.dim() - 1 - dim) + [0, c * length - g.shape[dim]]
    x = F.pad(g, pad).reshape(*g.shape[:dim], c, length, *g.shape[dim + 1:])
    hi = _top16(x)
    r = torch.copysign(x - hi, x)
    mid = _top16(r)
    lo = _top16(torch.copysign(r - mid, x))         # exact where |g| >= 2**-110
    return torch.stack((lo, mid, hi), dim + 1).movedim(dim, 0).to(torch.bfloat16).contiguous()


def split_bf16x3_cuda(g: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """The kernel: ``g`` a contiguous float32 CUDA tensor."""
    return _launch("split_bf16x3", g, torch.float32, dim, length)


def split_bf16x3(g: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if g.is_cuda:
        return split_bf16x3_cuda(g, dim, length)
    return split_bf16x3_plain(g, dim, length)


def repeat_bf16x3_plain(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    dim, c = _geometry(x, dim, length)
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, c * length - x.shape[dim]]
    x = F.pad(x, pad).reshape(*x.shape[:dim], c, length, *x.shape[dim + 1:])
    return torch.stack((x, x, x), dim + 1).movedim(dim, 0).contiguous()


def repeat_bf16x3_cuda(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """The kernel: ``x`` a contiguous bf16 CUDA tensor."""
    return _launch("repeat_bf16x3", x, torch.bfloat16, dim, length)


def repeat_bf16x3(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """A bf16 ``x`` in ``split_bf16x3``'s layout, each chunk three times (the
    other operand of a product over the stacked planes): the plain version
    for CPU tensors, the kernel for CUDA tensors."""
    if x.is_cuda:
        return repeat_bf16x3_cuda(x, dim, length)
    return repeat_bf16x3_plain(x, dim, length)


def _launch(name: str, x: torch.Tensor, dtype: torch.dtype, dim: int, length: int):
    if not x.is_cuda or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous CUDA {dtype} tensor; got "
                         f"{x.dtype} on {x.device}, contiguous={x.is_contiguous()}")
    dim, c = _geometry(x, dim, length)
    inner = math.prod(x.shape[dim + 1:])
    out = torch.empty((c, *x.shape[:dim], 3, length, *x.shape[dim + 1:]), dtype=torch.bfloat16,
                      device=x.device)
    lib = _build.library("split_bf16x3")
    _build.LAUNCHES[name] += 1
    err = getattr(lib, name)(*_build.ptrs(x, out), math.prod(x.shape[:dim]),
                             x.shape[dim] * inner, length * inner, c, _build.stream())
    _build.check(err, name)
    return out
