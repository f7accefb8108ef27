"""CUDA-graph replay of the truncated update's (r+1) core.

The port's counterpart of running the core under ``jit``.  Brand's
augmentation (``svd_update._svd_update_truncated_impl``) hands Algorithm 6.1
on a (B, k, k) core, k = r + 1, to ``CoreGraphs.run``.  On a card, on the
``direct`` route and for k <= ``secular.GIVENS_LOOP_MAX`` (above it the
Givens loop asks the host whether any member rotates), that chain reads
nothing back to the host and issues the same launches on every call: about
16,000 small kernels at k = 33, each one paced by the host.  So:

* the first call with a key runs eagerly;
* the second warms the chain up once on a side stream, captures it as one
  graph whose inputs are static (B, k) buffers (the identity factors are
  built inside the graph), and replays it;
* every later call copies its inputs into the static buffers, replays, and
  clones ``u``, ``s`` and ``v`` out (the next call overwrites them).

The key is (device, dtype, B, k, ``deflate_rtol``, the float32 matmul
precision and TF32 switch).  It does not hold the state's m and n, so
truncated states of different shapes with one rank and batch share a graph.
A capture that raises leaves its key eager for good.  Off a card, on another
route, above the Givens limit, with autograd recording, or inside another
capture the chain runs eagerly.  The cache keeps the ``MAX_GRAPHS`` keys used
last; each entry has a lock (the service and the fleet call the engine from
threads), and a replay on another stream than the last one waits for it.
Captures use one side stream a device, so cuBLAS's workspace for it (32 MiB
on an H100) is allocated once: it is the graphs' one large buffer.

Counters (``obs``, when enabled): ``svd_core_graph_captures``,
``svd_core_graph_replays`` (one a replay, the capturing call's too) and
``svd_core_graph_fallbacks`` (captures that raised).
"""

from __future__ import annotations

import collections
import threading

import torch

from repro_torch import obs as _obs
from repro_torch.core.secular import GIVENS_LOOP_MAX

__all__ = ["CoreGraphs", "CORE_GRAPHS", "MAX_GRAPHS"]

MAX_GRAPHS = 16    # keys kept; each graph holds a memory pool of its own


def _count(name: str) -> None:
    if _obs.enabled():
        _obs.registry().counter(name).inc()


class _Entry:
    """One key's sightings and, from the second on, its graph."""

    __slots__ = ("lock", "seen", "eager", "graph", "inputs", "outputs", "stream")

    def __init__(self):
        self.lock = threading.Lock()
        self.seen = 0
        self.eager = False     # for good: its capture raised, or it left the cache
        self.graph = None
        self.inputs = None     # static (B, k) s_aug, ak, bk
        self.outputs = None    # the graph's u, s, v
        self.stream = None     # the stream of the last replay

    def release(self) -> None:
        """Drop the graph once its last replay has finished reading its
        buffers; a caller still holding the entry runs eagerly."""
        with self.lock:
            if self.stream is not None:
                self.stream.synchronize()
            self.graph = self.inputs = self.outputs = self.stream = None
            self.eager = True


class CoreGraphs:
    """A bounded cache of captured core updates, least recently used out."""

    def __init__(self):
        self._lock = threading.Lock()
        self._capture_lock = threading.Lock()   # one capture at a time in the process
        self._side: dict = {}                   # the capture stream of each device
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def clear(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.release()

    def _entry(self, key) -> _Entry:
        evicted = None
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _Entry()
                if len(self._entries) > MAX_GRAPHS:
                    evicted = self._entries.popitem(last=False)[1]
            else:
                self._entries.move_to_end(key)
        if evicted is not None:
            evicted.release()
        return e

    def run(self, core, s_aug, ak, bk, *, method: str, deflate_rtol):
        """``core(s_aug, ak, bk)`` -> ``(u, s, v)`` of the (B, k, k) core,
        eagerly or from the key's graph (see the module's docstring)."""
        args = (s_aug, ak, bk)
        if (method != "direct" or not s_aug.is_cuda or s_aug.shape[1] > GIVENS_LOOP_MAX
                or torch.cuda.is_current_stream_capturing()
                or (torch.is_grad_enabled() and any(x.requires_grad for x in args))):
            return core(*args)
        dev = s_aug.device
        key = (dev, s_aug.dtype, *s_aug.shape, deflate_rtol,
               torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
        e = self._entry(key)
        with e.lock, torch.cuda.device(dev):
            e.seen += 1
            if e.eager or e.seen == 1:
                return core(*args)
            cur = torch.cuda.current_stream(dev)
            if e.graph is None:
                try:
                    self._capture(e, core, args)
                except RuntimeError:
                    e.eager = True
                    _count("svd_core_graph_fallbacks")
                    return core(*args)
                _count("svd_core_graph_captures")
            else:
                if cur != e.stream:
                    cur.wait_stream(e.stream)
                for dst, src in zip(e.inputs, args):
                    dst.copy_(src)
            e.graph.replay()
            e.stream = cur
            _count("svd_core_graph_replays")
            return tuple(x.clone() for x in e.outputs)

    def _capture(self, e: _Entry, core, args) -> None:
        """Warm ``core`` up on the device's capture stream, then capture it
        there on static copies of ``args`` (which the first replay then reads)."""
        static = tuple(x.clone() for x in args)
        with self._capture_lock:
            side = self._side.get(static[0].device)
            if side is None:
                side = self._side[static[0].device] = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                core(*static)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                out = core(*static)
        e.graph, e.inputs, e.outputs = graph, static, tuple(out)


CORE_GRAPHS = CoreGraphs()
