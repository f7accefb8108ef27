"""Spans over a model block's forward, its remat recompute and its backward.

``traced_block(name, fn, x, *args)`` returns ``fn(x, *args)``.  While tracing
is on (``obs.start_tracing``) it runs the call inside span ``name`` and also
gives the block's backward to the same name: an identity autograd node on
``x`` (the block's entry) and one on the outputs (its exit).  The exit's
backward opens span ``name`` on the thread that runs the backward, and the
entry's backward closes it: between the two the autograd engine runs the
block's own nodes, since the next block's backward waits for this one's
entry.

Activation checkpointing recomputes a layer's forward inside the backward,
on the backward's thread.  A block entered while backward spans are open on
its thread closes them first and reopens them after it, so no span of one
name nests in another: the card's time of a name, summed over a step's
spans (``obs.device_times()``), holds the block's forward, recompute and
backward once each.

Tracing off: ``fn(x, *args)`` and nothing else, no node and no span.  The
identity nodes change no value.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.obs.trace import span, tracing

__all__ = ["traced_block"]

_local = threading.local()


def _open() -> list:
    """The backward spans open on this thread, ``[name, span]``, oldest first."""
    st = getattr(_local, "open", None)
    if st is None:
        st = _local.open = []
    return st


class _Entry(torch.autograd.Function):
    """Identity; its backward closes the block's backward span."""

    @staticmethod
    def forward(ctx, name, x):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        st = _open()
        if st and st[-1][0] == ctx.name:
            st.pop()[1].__exit__(None, None, None)
        return None, g


class _Exit(torch.autograd.Function):
    """Identity on every output; its backward opens the block's backward span."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if tracing():
            sp = span(ctx.name)
            sp.__enter__()
            _open().append([ctx.name, sp])
        return (None, *gs)


def _pause() -> list:
    """Close this thread's open backward spans; their names, to reopen."""
    st = _open()
    names = [name for name, _ in st]
    while st:
        st.pop()[1].__exit__(None, None, None)
    return names


def _resume(names: list) -> None:
    st = _open()
    for name in names:
        sp = span(name)
        sp.__enter__()
        st.append([name, sp])


def traced_block(name: str, fn, x, *args):
    """``fn(x, *args)`` (a tensor or a tuple of tensors), inside span ``name``
    over its forward and backward while tracing is on (module docstring)."""
    if not tracing():
        return fn(x, *args)
    grad = torch.is_grad_enabled() and x.requires_grad
    paused = _pause()
    try:
        if grad:
            x = _Entry.apply(name, x)
        with span(name):
            out = fn(x, *args)
        if grad:
            many = isinstance(out, tuple)
            outs = _Exit.apply(name, *(out if many else (out,)))
            out = outs if many else outs[0]
    finally:
        _resume(paused)
    return out
