"""The fixed-count secular root solve, every root at once.

Counterpart of ``repro.kernels.secular_newton``.  For each root i of each
batch member b it solves

    w(tau) = 1 + rho_b * sum_j zc2[b, j] / ((dc[b, j] - av[b, i]) - tau) = 0

on the bracket ``[lo[b, i], hi[b, i]]`` by ``n_bisect`` bisection steps and
``n_newton`` safeguarded Newton steps on ``tau * w(tau)``
(``kernels.secular_body.secular_iterate``, ``poles_axis=0``).  ``zc2`` must
be zero at invalid poles; a root with the bracket [0, 0] comes out as 0.

``secular_solve_plain`` is the plain PyTorch version (it stores the (N, M)
difference tensor); ``secular_solve_cuda`` launches kernel D
(``csrc/secular_newton.cu``): a group of lanes per root holds the root's pole
differences in registers, and each term's reciprocal is a hardware seed and a
fixed correction, with no IEEE division.  It takes at most ``MAX_POLES``
poles.  ``secular_plan`` gives the lanes a root and the poles a lane for N
poles.  ``secular_solve`` picks by the device of ``dc``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.secular_body import secular_iterate

__all__ = ["MAX_POLES", "secular_plan", "secular_solve", "secular_solve_cuda",
           "secular_solve_plain"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# 32 poles a lane in registers, at most 256 lanes a root (one block)
MAX_POLES = 8192


def secular_plan(n: int) -> dict:
    """Kernel D's lane group for ``n`` poles: ``lanes`` a root and ``terms``,
    the poles each lane holds; chosen from ``n`` alone."""
    lanes, terms = ctypes.c_int(0), ctypes.c_int(0)
    _build.library("secular_newton").secular_plan(n, ctypes.byref(lanes), ctypes.byref(terms))
    return {"lanes": lanes.value, "terms": terms.value}


def secular_solve_plain(dc, zc2, rho, anchor_vals, lo, hi, *, n_bisect=58, n_newton=4):
    """``dc``/``zc2`` (B, N), ``rho`` (B,), ``anchor_vals``/``lo``/``hi``
    (B, M) -> ``tau`` (B, M)."""
    diff = dc[:, :, None] - anchor_vals[:, None, :]
    return secular_iterate(diff, zc2, rho, lo, hi, n_bisect=n_bisect, n_newton=n_newton,
                           poles_axis=0)


def secular_solve_cuda(dc, zc2, rho, anchor_vals, lo, hi, *, n_bisect=58, n_newton=4):
    """Kernel D: the same function on CUDA tensors (f32 or f64)."""
    bsz, n = dc.shape
    m = anchor_vals.shape[1]
    dt = dc.dtype
    if dt not in _SUFFIX:
        raise NotImplementedError(f"the secular kernel takes f32 or f64; got {dt}")
    shapes = {"zc2": (bsz, n), "rho": (bsz,), "anchor_vals": (bsz, m), "lo": (bsz, m),
              "hi": (bsz, m)}
    for name, x in zip(shapes, (zc2, rho, anchor_vals, lo, hi)):
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}; got {tuple(x.shape)}")
    for name, x in (("dc", dc), ("zc2", zc2), ("rho", rho), ("anchor_vals", anchor_vals),
                    ("lo", lo), ("hi", hi)):
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous CUDA {dt} tensor; got "
                             f"{x.dtype} on {x.device}, contiguous={x.is_contiguous()}")
    if n_bisect < 0 or n_newton < 0:
        raise ValueError(f"step counts must be >= 0; got {n_bisect}, {n_newton}")
    if n > MAX_POLES:
        raise ValueError(f"kernel D holds a root's poles in registers: at most {MAX_POLES} "
                         f"poles; got {n}")
    out = torch.empty((bsz, m), dtype=dt, device=dc.device)
    if out.numel() == 0:
        return out
    fn = getattr(_build.library("secular_newton"), f"secular_solve_{_SUFFIX[dt]}")
    _build.LAUNCHES["secular_solve"] += 1
    _build.check(fn(*_build.ptrs(dc, zc2, rho, anchor_vals, lo, hi, out), bsz, n, m,
                    n_bisect, n_newton, _build.stream()), "secular_solve")
    return out


def secular_solve(dc, zc2, rho, anchor_vals, lo, hi, *, n_bisect=58, n_newton=4):
    """The plain version for CPU tensors, kernel D for CUDA tensors."""
    fn = secular_solve_cuda if dc.is_cuda else secular_solve_plain
    return fn(dc, zc2, rho, anchor_vals, lo, hi, n_bisect=n_bisect, n_newton=n_newton)
