"""``SvdFleet``: the population-sharded service tier (DESIGN.md §13), in
PyTorch.

Counterpart of ``repro.fleet.fleet``.  One ``SvdService`` owns every stream it
serves; a mesh can spread a flush's batch but never the stream population.
The fleet partitions the population itself: ``num_shards`` independent
services (``fleet.shard.FleetShard``), streams assigned by deterministic
hashed placement (``fleet.placement``), each shard with its own FIFOs,
rounds, rounds in flight and continuous-batching admission window
(``fleet.frontend``).  The public surface is the service's (``register`` /
``enqueue`` / ``enqueue_op`` / ``state`` / ``flush`` / ``drain`` /
``merge_streams``), so a caller scales from one service to a fleet by
swapping the constructor.  ``devices="auto"`` keeps shard ``i``'s streams on
card ``i mod n_cards`` (``placement.plan_devices``).

Shards compose only at query time: ``query`` settles each member stream on
its own shard, then runs one ``dist.merge.merge_tree`` over the settled
states in ``stream_ids`` order, on the first stream's device.  The settle
path applies each stream's queue through the per-stream sequence a
standalone service would, so a fleet query over enqueued traffic equals the
single service's, to the bit, at any shard count.

``FleetSnapshot`` (snapshot **v8**) captures the whole tier, one
``ServiceSnapshot`` (v7 payload) per shard plus the placement spec, in the
reference's on-disk layout: either package restores the other's files, bit
for bit.  A restore may take another shard count: ``regrouped`` moves every
stream's leaves (state and pending FIFO, wholesale and bitwise) to the shard
the new spec hashes it to (``train.elastic.plan_shard_count`` sizes it to the
live cards).  The rounds of the new layout batch other stream counts, so an
elastic restore also warms every batch bucket and rank-k depth of each
warmed geometry.
"""

from __future__ import annotations

import dataclasses

from repro_torch import obs as _obs
from repro_torch.api import UpdatePolicy
from repro_torch.api.policy import as_torch_dtype
from repro_torch.api.state import SvdState
from repro_torch.api.update import warmup as _api_warmup
from repro_torch.dist.merge import merge_tree
from repro_torch.fleet.placement import PlacementSpec, plan_devices, shard_of
from repro_torch.fleet.shard import FleetShard
from repro_torch.serve.svd_service import ServiceSnapshot, SvdService, SvdServiceStats
from repro_torch import _tree
from repro_torch.train import checkpoint as _checkpoint

__all__ = ["FLEET_SNAPSHOT_VERSION", "FleetSnapshot", "SvdFleet"]

# the version line is shared with serve: v4 was the first fleet format (v3
# service payloads), v6 carried v5 payloads, v8 carries v7 payloads; older
# fleet snapshots load (the service payload loader takes any version <= 7)
FLEET_SNAPSHOT_VERSION = 8
_SNAPSHOT_FORMAT = "repro.fleet.FleetSnapshot"

# fleet-level config a snapshot records (devices are runtime placement and
# deliberately absent, like the service's mesh)
_CONFIG_FIELDS = ("continuous", "max_depth", "max_backlog")


@dataclasses.dataclass(frozen=True)
class FleetSnapshot:
    """Versioned capture of a whole fleet: per-shard ``ServiceSnapshot``
    payloads (the leaves, in the reference's order) + the placement spec and
    admission config (structure, mirrored into the JSON aux spec so that a
    fresh process rebuilds the routing table before loading a leaf)."""

    tree_fields = ("shards",)

    shards: tuple            # tuple[ServiceSnapshot, ...], index = shard id
    version: int = FLEET_SNAPSHOT_VERSION
    placement: PlacementSpec = PlacementSpec(1)
    config: tuple = ()       # (field, value) pairs of _CONFIG_FIELDS

    def aux(self) -> dict:
        return {
            "format": _SNAPSHOT_FORMAT,
            "version": self.version,
            "placement": self.placement.to_json(),
            "config": dict(self.config),
            "shards": [s.aux() for s in self.shards],
        }

    @classmethod
    def skeleton(cls, aux: dict) -> "FleetSnapshot":
        return cls(shards=tuple(ServiceSnapshot.skeleton(sa) for sa in aux["shards"]),
                   version=FLEET_SNAPSHOT_VERSION,
                   placement=PlacementSpec.from_json(aux["placement"]),
                   config=tuple(aux["config"].items()))

    def leaves(self) -> list:
        """The snapshot's leaves in the reference's pytree order."""
        return _tree.tree_leaves(self)

    @classmethod
    def from_leaves(cls, leaves, aux: dict) -> "FleetSnapshot":
        return _tree.tree_unflatten(cls.skeleton(aux), list(leaves))

    def save(self, ckpt_dir, step: int, *, keep: int = 3):
        return _checkpoint.save(ckpt_dir, step, self, keep=keep, aux=self.aux())

    @classmethod
    def load(cls, ckpt_dir, step: int | None = None) -> tuple[int, "FleetSnapshot"]:
        """``(step, snapshot)`` from a checkpoint directory; leaves come back
        as saved (numpy, bitwise) and reach a device in ``from_snapshot``."""
        step, aux = _checkpoint.load_aux(ckpt_dir, step)
        if aux is None or aux.get("format") != _SNAPSHOT_FORMAT:
            raise ValueError(
                f"checkpoint at step {step} is not a FleetSnapshot "
                f"(aux format: {None if aux is None else aux.get('format')!r})")
        if aux["version"] > FLEET_SNAPSHOT_VERSION:
            raise ValueError(f"snapshot version {aux['version']} is newer than this build "
                             f"understands (<= {FLEET_SNAPSHOT_VERSION})")
        _, leaves = _checkpoint.restore(ckpt_dir, None, step)
        return step, cls.from_leaves(leaves, aux)

    def regrouped(self, num_shards: int) -> "FleetSnapshot":
        """The same fleet under ``placement.replaced(num_shards)``: every
        stream's leaves (state, pending pair stacks, ops, order string) move
        wholesale to the shard the new spec hashes it to, bitwise, with no
        update run.  Warmed sets union into every new shard; per-shard stats
        reset (they are per-process observability, not stream state)."""
        if num_shards == self.placement.num_shards:
            return self
        new_spec = self.placement.replaced(num_shards)
        if not self.shards:
            return FleetSnapshot(shards=(), placement=new_spec, config=self.config)
        proto = self.shards[0]       # shards share the service config
        warmed = tuple(sorted({w for s in self.shards for w in s.warmed}))
        zero_stats = tuple(dataclasses.asdict(SvdServiceStats()).items())
        buckets: list[list] = [[] for _ in range(num_shards)]
        for snap in self.shards:
            for i, sid in enumerate(snap.stream_ids):
                buckets[shard_of(new_spec, sid)].append((
                    sid, snap.states[i], snap.pending_a[i], snap.pending_b[i],
                    snap.pending_ops[i] if snap.pending_ops else (),
                    snap.pending_order[i] if snap.pending_order else ""))
        shards = tuple(
            ServiceSnapshot(
                states=tuple(e[1] for e in bucket),
                pending_a=tuple(e[2] for e in bucket),
                pending_b=tuple(e[3] for e in bucket),
                pending_ops=tuple(e[4] for e in bucket),
                version=proto.version,
                stream_ids=tuple(e[0] for e in bucket),
                policy_spec=proto.policy_spec,
                max_batch=proto.max_batch,
                pad_to_bucket=proto.pad_to_bucket,
                max_in_flight=proto.max_in_flight,
                stats=zero_stats,
                pending_order=tuple(e[5] for e in bucket),
                warmed=warmed,
            )
            for bucket in buckets)
        return FleetSnapshot(shards=shards, placement=new_spec, config=self.config)


def _device_plan(n: int, devices, mesh) -> tuple:
    if devices == "auto":
        return plan_devices(n, mesh=mesh)
    if devices is None:
        return (None,) * max(n, 1)
    return tuple(devices)


class SvdFleet:
    """A population-sharded ``SvdService``: the same surface over
    ``num_shards`` independent services.

        fleet = SvdFleet(num_shards=4, policy=UpdatePolicy(method="fused"),
                         devices="auto")
        fleet.register("user-1", api.SvdState.from_dense(m1, rank=8))
        fleet.enqueue("user-1", a, b)       # routed, admitted
        merged = fleet.query(["user-1", "user-2"])   # cross-shard merge
        fleet.save("/ckpts/fleet", step=1)  # FleetSnapshot v8

    ``continuous=True`` (default) runs each shard behind its admission window
    (``fleet.frontend``); ``False`` keeps every shard's fixed boundaries.
    ``devices``: ``"auto"`` pins shard ``i`` to card ``i mod n``
    (``placement.plan_devices``), a sequence names them, None leaves each
    stream where it was registered.
    """

    def __init__(self, num_shards: int = 1, *, policy: UpdatePolicy | None = None,
                 max_batch: int = 64, pad_to_bucket: bool = True, max_in_flight: int = 2,
                 continuous: bool = True, max_depth: int = 8, max_backlog: int | None = None,
                 placement: PlacementSpec | None = None, devices=None):
        self.placement = placement if placement is not None else PlacementSpec(num_shards)
        if self.placement.num_shards != num_shards:
            raise ValueError(f"placement spec is for {self.placement.num_shards} shards; "
                             f"fleet has {num_shards}")
        self.policy = policy if policy is not None else UpdatePolicy()
        self.continuous = continuous
        self.max_depth = max_depth
        self.max_backlog = max_backlog
        devices = _device_plan(num_shards, devices, self.policy.mesh)
        self.shards = tuple(
            FleetShard(i, policy=self.policy, max_batch=max_batch, pad_to_bucket=pad_to_bucket,
                       max_in_flight=max_in_flight, continuous=continuous, max_depth=max_depth,
                       max_backlog=max_backlog, device=devices[i % len(devices)])
            for i in range(num_shards))

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def shard_of(self, stream_id: str) -> int:
        return shard_of(self.placement, stream_id)

    def _shard(self, stream_id: str) -> FleetShard:
        return self.shards[self.shard_of(stream_id)]

    # -- the service surface, routed ----------------------------------------

    def register(self, stream_id: str, state) -> None:
        self._shard(stream_id).register(stream_id, state)

    def enqueue(self, stream_id: str, a, b) -> tuple[int, int]:
        """Route and admit one rank-1 event; returns its fleet-level
        visibility token ``(shard, token)`` (see ``poll``)."""
        sh = self.shard_of(stream_id)
        return (sh, self.shards[sh].enqueue(stream_id, a, b))

    def enqueue_op(self, stream_id: str, op) -> tuple[int, int]:
        sh = self.shard_of(stream_id)
        return (sh, self.shards[sh].enqueue_op(stream_id, op))

    def state(self, stream_id: str) -> SvdState:
        return self._shard(stream_id).service.state(stream_id)

    def evict(self, stream_id: str) -> SvdState:
        return self._shard(stream_id).service.evict(stream_id)

    def pending(self) -> int:
        return sum(s.pending() for s in self.shards)

    def pump(self) -> int:
        """One admission pass over every shard (the fleet's event-loop
        tick); returns the events dispatched."""
        return sum(s.pump() for s in self.shards)

    def poll(self) -> list[tuple[int, int]]:
        """Newly visible fleet tokens ``(shard, token)`` across all shards."""
        return [(i, t) for i, s in enumerate(self.shards) for t in s.poll()]

    def flush(self) -> int:
        return sum(s.flush() for s in self.shards)

    def drain(self) -> int:
        return sum(s.drain() for s in self.shards)

    def stats(self) -> SvdServiceStats:
        """Fleet-aggregate counters (sums over shards; ``max_*`` and
        ``*_peak`` fields the max).  With ``repro_torch.obs`` enabled the
        aggregate is also published as ``fleet_<field>`` gauges."""
        agg = SvdServiceStats()
        for s in self.shards:
            st = s.service.stats
            for f in dataclasses.fields(SvdServiceStats):
                if f.name.startswith("max_") or f.name.endswith("_peak"):
                    setattr(agg, f.name, max(getattr(agg, f.name), getattr(st, f.name)))
                else:
                    setattr(agg, f.name, getattr(agg, f.name) + getattr(st, f.name))
        if _obs.enabled():
            reg = _obs.registry()
            for f in dataclasses.fields(SvdServiceStats):
                reg.gauge(f"fleet_{f.name}").set(getattr(agg, f.name))
        return agg

    # -- query-time cross-shard composition ---------------------------------

    def settle(self, stream_ids) -> list[SvdState]:
        """Per-stream settled states in ``stream_ids`` order (each shard
        applies its own members' queues; no cross-shard traffic)."""
        by_shard: dict[int, list[str]] = {}
        for sid in stream_ids:
            by_shard.setdefault(self.shard_of(sid), []).append(sid)
        settled: dict[str, SvdState] = {}
        for sh, sids in by_shard.items():
            settled.update(zip(sids, self.shards[sh].service.settle(sids)))
        return [settled[sid] for sid in stream_ids]

    def query(self, stream_ids, *, rank: int | None = None) -> SvdState:
        """Truncated SVD of the row concatenation of the named streams
        (``stream_ids`` order), wherever they live: settle on the owning
        shards, then one ``merge_tree`` on the first stream's device, the
        only point where shards compose (``(m + n + 1) r`` floats a
        stream)."""
        states = self.settle(stream_ids)
        home = states[0].device
        states = [st if st.device == home else SvdState(*(x.to(home) for x in (st.u, st.s, st.v)))
                  for st in states]
        return merge_tree(states, rank=rank, policy=self.policy)

    def merge_streams(self, stream_ids, *, target: str | None = None,
                      rank: int | None = None) -> SvdState:
        """Service-compatible alias of ``query``; with ``target`` the merged
        state registers as a new stream on its hashed shard."""
        merged = self.query(stream_ids, rank=rank)
        if target is not None:
            self.register(target, merged)
        return merged

    # -- checkpointing -------------------------------------------------------

    def snapshot(self) -> FleetSnapshot:
        """Barrier and capture every shard (consistent per shard; shards are
        independent, so the fleet snapshot is the tuple of shard points)."""
        return FleetSnapshot(shards=tuple(s.snapshot() for s in self.shards),
                             version=FLEET_SNAPSHOT_VERSION, placement=self.placement,
                             config=tuple((f, getattr(self, f)) for f in _CONFIG_FIELDS))

    def save(self, ckpt_dir, step: int, *, keep: int = 3):
        return self.snapshot().save(ckpt_dir, step, keep=keep)

    @classmethod
    def from_snapshot(cls, snap: FleetSnapshot, *, mesh=None, policy: UpdatePolicy | None = None,
                      devices=None, device="cuda") -> "SvdFleet":
        """Rebuild a fleet from a snapshot (same shard count as ``snap``;
        re-place first with ``snap.regrouped`` for an elastic restore).
        Shard ``i``'s states go to its planned device (``devices``), else to
        ``device``; each service rebuilds through ``SvdService.from_snapshot``,
        warming its warmed set there."""
        cfg = dict(snap.config)
        n = len(snap.shards)
        plan_mesh = policy.mesh if policy is not None else mesh
        plan = _device_plan(n, devices, plan_mesh)
        homes = [plan[i % len(plan)] for i in range(n)]
        services = [SvdService.from_snapshot(s, mesh=mesh, policy=policy,
                                             device=home if home is not None else device)
                    for s, home in zip(snap.shards, homes)]
        fleet = cls.__new__(cls)
        fleet.placement = snap.placement
        fleet.policy = (services[0].policy if services else
                        policy if policy is not None else UpdatePolicy(mesh=mesh))
        fleet.continuous = bool(cfg.get("continuous", True))
        fleet.max_depth = int(cfg.get("max_depth", 8))
        fleet.max_backlog = cfg.get("max_backlog")
        fleet.shards = tuple(
            FleetShard(i, continuous=fleet.continuous, max_depth=fleet.max_depth,
                       max_backlog=fleet.max_backlog, device=homes[i], service=services[i])
            for i in range(n))
        return fleet

    @classmethod
    def restore(cls, ckpt_dir, *, step: int | None = None, num_shards: int | str | None = None,
                mesh=None, policy: UpdatePolicy | None = None, devices=None, cache_dir=None,
                device="cuda") -> tuple[int, "SvdFleet"]:
        """Load the latest (or ``step``-th) fleet snapshot and rebuild it.

        ``num_shards``: None keeps the recorded count; an int re-places every
        stream under ``placement.replaced(num_shards)`` (the elastic restore,
        bitwise per stream), and then warms every batch bucket and rank-k
        depth of each warmed geometry, since the new layout batches other
        stream counts;
        ``"auto"`` sizes the fleet to the live devices
        (``train.elastic.plan_shard_count``: ``devices`` when it names them,
        else the cards).  ``cache_dir`` points the kernels' build cache there
        first (``api.enable_compilation_cache``).
        """
        if cache_dir is not None:
            from repro_torch.api.cache import enable_compilation_cache

            enable_compilation_cache(cache_dir)
        step, snap = FleetSnapshot.load(ckpt_dir, step)
        if num_shards == "auto":
            from repro_torch.train.elastic import plan_shard_count

            num_shards = plan_shard_count(devices=None if devices in (None, "auto") else devices)
        regroup = num_shards is not None and num_shards != len(snap.shards)
        if regroup:
            snap = snap.regrouped(int(num_shards))
        fleet = cls.from_snapshot(snap, mesh=mesh, policy=policy, devices=devices, device=device)
        if regroup:
            for sh in fleet.shards:
                _warm_layout(sh.service, fleet.max_depth,
                             sh.device if sh.device is not None else device)
        return step, fleet


def _warm_layout(svc: SvdService, max_depth: int, device) -> None:
    """Warm every round geometry ``svc`` can dispatch for each batched
    geometry of its warmed set: each power-of-two batch up to ``max_batch``
    (the sizes rounds pad to) at each power-of-two depth up to
    ``max_depth`` (the rank-k columns a sealed round takes)."""

    def pow2(cap):
        return [1 << j for j in range(max(cap, 1).bit_length())]

    geoms = {(m, n, r, dt) for kind, _, m, n, r, dt in svc._warmed
             if kind == "trunc_batch" or kind.startswith("trunc_scan")}
    for m, n, r, dtype_name in sorted(geoms):
        for depth in pow2(max_depth):
            for bsz in pow2(svc.max_batch):
                _api_warmup(svc.policy, m=m, n=n, batch=bsz, rank=r,
                            k=None if depth == 1 else depth,
                            dtype=as_torch_dtype(dtype_name), device=device)
