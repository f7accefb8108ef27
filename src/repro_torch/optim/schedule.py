"""LR schedules (pure functions of the step counter), in PyTorch.

Counterpart of ``repro.optim.schedule``, equal to the bit to the learning
rate the reference's jitted train step computes.  XLA's CPU backend folds
each division by a constant into a product with its float32 reciprocal,
takes ``cos`` from the C library's ``cosf`` and contracts the cosine's
``0.1 + 0.45 * (1 + c)`` into one fused multiply-add.  The port computes the
same float32 operations in the same order on the host: float32 tensors on
the CPU for the arithmetic, ``cosf`` for the cosine (PyTorch's vectorised
float32 cosine differs from it in the last bit on about 5 % of arguments),
and the fused multiply-add exactly (``_fma32``).  The result is a 0-dim
float32 CPU tensor, which multiplies a card's tensors as a scalar, with no
copy and no wait.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from fractions import Fraction

import numpy as np
import torch

__all__ = ["warmup_cosine"]


@functools.cache
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = libm.cosf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 scalars with one rounding (a fused
    multiply-add): the exact value, rounded to the nearest float32, ties to
    even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = (np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf)))
    best = min(cands, key=lambda r: (abs(Fraction(float(r)) - exact),
                                     int(np.asarray(r).view(np.int32)) & 1))
    return _f32(float(best))


def warmup_cosine(step, *, base_lr, warmup_steps, total_steps, min_ratio=0.1) -> torch.Tensor:
    step = _f32(float(step))
    warm = step * (_f32(1.0) / _f32(max(warmup_steps, 1)))
    inv_span = _f32(1.0) / _f32(max(total_steps - warmup_steps, 1))
    prog = torch.clamp((step - _f32(warmup_steps)) * inv_span, 0.0, 1.0)
    cos = _f32(_cosf()(float(_f32(math.pi) * prog)))
    cos = _fma32(_f32(1.0) + cos, _f32((1 - min_ratio) * 0.5), _f32(min_ratio))
    return _f32(base_lr) * torch.where(step < warmup_steps, warm, cos)
