"""One fleet shard: a ``SvdService`` partition plus its admission frontend.

Counterpart of ``repro.fleet.shard``.  A shard is the unit of ownership:
every stream hashed to shard ``i`` (``placement.shard_of``) lives in shard
``i``'s service, with its state, FIFO, flush rounds and rounds in flight.
Shards flush independently: shard ``i`` sealing a round never waits on shard
``j``'s device work.  Cross-shard composition happens only at query time
(``fleet.SvdFleet`` merges settled states through ``dist.merge``).
"""

from __future__ import annotations

import torch

from repro_torch.api import UpdatePolicy, as_state
from repro_torch.fleet.frontend import ContinuousBatcher
from repro_torch.serve.svd_service import SvdService

__all__ = ["FleetShard"]


class FleetShard:
    """Shard ``index``: one ``SvdService`` + one ``ContinuousBatcher``.

    The shard's service is a complete standalone service (snapshot, restore,
    merge, eviction all work per shard); the shard adds identity, the device
    its streams live on (``device``; None leaves them where they were
    registered) and the admission frontend.
    """

    def __init__(self, index: int, *, policy: UpdatePolicy | None = None, max_batch: int = 64,
                 pad_to_bucket: bool = True, max_in_flight: int = 2, continuous: bool = True,
                 max_depth: int = 8, max_backlog: int | None = None, device=None,
                 service: SvdService | None = None):
        self.index = index
        self.device = None if device is None else torch.device(device)
        self.service = service if service is not None else SvdService(
            max_batch=max_batch, pad_to_bucket=pad_to_bucket, max_in_flight=max_in_flight,
            policy=policy)
        # per-shard series in the obs registry: every serve_* gauge and
        # health_* probe this shard publishes carries shard=<index>
        self.service._obs_labels = {"shard": str(index)}
        self.frontend = ContinuousBatcher(self.service, max_depth=max_depth,
                                          max_backlog=max_backlog, device=self.device,
                                          continuous=continuous)

    # thin delegation: the fleet routes per stream, shards do the work

    def register(self, stream_id: str, state) -> None:
        """Register a stream, its tensors moved to the shard's device."""
        st = as_state(state)
        if self.device is not None:
            st = st.replace(**{f: getattr(st, f).to(self.device) for f in ("u", "s", "v")})
        self.service.register(stream_id, st)

    def enqueue(self, stream_id: str, a, b) -> int:
        return self.frontend.admit(stream_id, a, b)

    def enqueue_op(self, stream_id: str, op) -> int:
        return self.frontend.admit_op(stream_id, op)

    def pending(self) -> int:
        return self.service.pending()

    def poll(self) -> list[int]:
        return self.frontend.poll()

    def pump(self) -> int:
        return self.frontend.pump()

    def flush(self) -> int:
        return self.service.flush()

    def drain(self) -> int:
        # through the frontend: it seals maximally deep and wide rounds
        # first, then runs the service's blocking barrier
        return self.frontend.drain()

    def snapshot(self):
        return self.service.snapshot()
