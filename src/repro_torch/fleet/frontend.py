"""Continuous-batching admission over one ``SvdService``, in PyTorch.

Counterpart of ``repro.fleet.frontend``.  The plain service flushes at fixed
boundaries: a round dispatches when ``max_batch`` streams have a pending head
(or on an explicit ``flush()``), one event a stream.  This frontend replaces
the boundary with an admission window:

* a round is sealed at the next ``pump`` tick with device capacity (rounds in
  flight below the service's ``max_in_flight``), never at a fill count and
  never per admit; while the card is busy, arriving events join the open
  window, so the next round grows with load: wide (every ready stream) and
  deep (a backlogged stream contributes up to ``max_depth`` consecutive pairs
  as one rank-k column);
* ordering needs no locks beyond the service's: a stream's events sit in ONE
  FIFO, a round takes a prefix of it, and a depth-k column applies its pairs
  in FIFO order, so every stream's updates form one chain however windows
  cut it;
* backpressure is per shard: past ``max_backlog`` pending events the next
  ``admit`` waits for the oldest round in flight before queueing.

Visibility: ``admit`` returns the service's enqueue token; ``poll()`` drains
tokens whose round has retired.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch import obs as _obs
from repro_torch.serve.svd_service import SvdService

__all__ = ["ContinuousBatcher"]


def _on_device(device):
    """The context that makes ``device`` current for a CUDA device (a no-op
    for None and the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ContinuousBatcher:
    """Capacity-triggered admission over one shard's ``SvdService``.

    ``max_depth``: deepest rank-k column a sealed round may take from one
    stream's backlog (1 = one event a stream a round).  ``max_backlog``:
    pending-event bound that blocks ``admit`` (None = the service's
    ``max_in_flight`` bounds host run-ahead on its own).  ``device``: the
    shard's ``torch.device``, current while its rounds dispatch (None = the
    process default).  ``continuous=False`` keeps the service's own fixed
    boundaries (autoflush at ``max_batch``).
    """

    def __init__(self, service: SvdService, *, max_depth: int = 8,
                 max_backlog: int | None = None, device=None, continuous: bool = True):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1; got {max_depth}")
        self.service = service
        self.max_depth = max_depth
        self.max_backlog = max_backlog
        self.device = device
        self.continuous = continuous

    # -- admission ----------------------------------------------------------

    def admit(self, stream_id: str, a, b) -> int:
        """Admit one rank-1 event into the open window; returns its token.
        Admission never seals: rounds are sealed by ``pump``, by
        backpressure or by ``drain``, each of which sees the whole window."""
        self._backpressure()
        return self._enqueue(lambda: self.service.enqueue(stream_id, a, b))

    def admit_op(self, stream_id: str, op) -> int:
        """Admit one structured event; returns the token of its last lowered
        sub-event (visible = the whole op applied)."""
        self._backpressure()
        return self._enqueue(lambda: self.service.enqueue_op(stream_id, op))

    def _enqueue(self, do):
        if not self.continuous:
            return do()
        # suppress the service's count-triggered autoflush: the window seals
        # on capacity, not on fill (explicit flush()/drain() keep theirs)
        saved, self.service.max_batch = self.service.max_batch, 1 << 30
        try:
            return do()
        finally:
            self.service.max_batch = saved

    def _backpressure(self) -> None:
        if self.max_backlog is None or not self.continuous:
            return
        if self.service.pending() < self.max_backlog:
            return
        with _obs.span("backpressure", **self.service._obs_labels):
            while self.service.pending() >= self.max_backlog:
                # the window is as deep as allowed: wait for the oldest
                # round, then seal, freeing FIFO space
                with self.service._lock:
                    if self.service._in_flight:
                        self.service._retire_oldest()
                        self.service.stats.backpressure_waits += 1
                if not self.pump():
                    break   # nothing dispatchable

    # -- sealing ------------------------------------------------------------

    def pump(self, *, once: bool = False) -> int:
        """Seal rounds while the device has capacity and events are pending;
        returns the events dispatched.  Never blocks: with the in-flight
        buffer full the window stays open.  The event-loop tick."""
        if not self.continuous or not self.service.pending():
            return 0
        dispatched = 0
        with _obs.span("pump", **self.service._obs_labels) as sp, _on_device(self.device):
            while self.service.pending() and self.service.has_capacity():
                n = self.service.flush_round(max_depth=self.max_depth)
                if n == 0:
                    break
                dispatched += n
                if once:
                    break
            sp.set(dispatched=dispatched)
        return dispatched

    def poll(self) -> list[int]:
        """Newly visible tokens (their rounds retired); non-blocking."""
        return self.service.take_visible()

    def drain(self) -> int:
        """Seal everything (deep rounds, retiring rounds in flight as needed)
        and wait until it is visible: the shutdown and snapshot barrier."""
        n = 0
        if self.continuous:
            while self.service.pending():
                d = self.pump()
                n += d
                if not d:
                    # in-flight buffer full: wait for the oldest round, then
                    # keep sealing (service.drain alone would seal depth 1)
                    with self.service._lock:
                        if not self.service._in_flight:
                            break
                        self.service._retire_oldest()
        with _on_device(self.device):
            return n + self.service.drain()
