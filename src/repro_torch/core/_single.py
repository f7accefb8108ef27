"""The single-member front door of the core's batched functions.

The core computes over a leading batch axis.  The reference's core takes one
member, ``make_plan(d, z, rho)`` with ``d`` (n,), ``apply_update(plan, w)``
with ``w`` (m, n) and so on, and batches them with ``vmap``.
``single_member(rank)`` lets a batched function take both.  When its first
argument's first tensor (looked for through named tuples and plans) has
``rank - 1`` dimensions, every tensor argument gains a leading axis of 1, and
every tensor of the result loses it.  Any other call passes through as it is,
so the batched calls give the same bits as before.

A plan built from single-member inputs keeps single-member fields, so a
function that takes it returns single-member results too.  The fields that a
plan's class names in ``SHARED`` (operators with no batch axis) pass as
they are.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = ["single_member"]


def _is_plan(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x if isinstance(x, tuple) else (
        (getattr(x, f.name) for f in dataclasses.fields(x)) if _is_plan(x) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def _map(fn, x):
    """``fn`` over every batched tensor of ``x``, through tuples, named tuples
    and plans."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        items = [_map(fn, item) for item in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if _is_plan(x):
        shared = getattr(type(x), "SHARED", ())
        return dataclasses.replace(x, **{f.name: _map(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.name not in shared})
    return x


def single_member(rank: int):
    """Decorate a batched function whose first argument's first tensor has
    ``rank`` dimensions so that it also takes one member without the batch
    axis."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            first = _first_tensor(args[0]) if args else None
            if first is None or first.dim() != rank - 1:
                return fn(*args, **kw)
            lift = lambda t: t.unsqueeze(0)  # noqa: E731
            out = fn(*_map(lift, args), **{k: _map(lift, v) for k, v in kw.items()})
            return _map(lambda t: t.squeeze(0), out)

        return call

    return wrap
