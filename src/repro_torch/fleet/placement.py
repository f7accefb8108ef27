"""Deterministic stream -> shard placement for the fleet tier, in PyTorch.

Counterpart of ``repro.fleet.placement``, with the same hash, so that a
stream lands on the same shard in both packages and in every process:

* **deterministic across processes**: a restored fleet (possibly on another
  machine) must route every stream to the shard that holds its state.
  Python's builtin ``hash`` is salted per process, so placement hashes with
  keyed ``blake2b``: same id, same shard, every process.
* **balanced without coordination**: shards never exchange load; the hash's
  uniformity is the balancer.
* **re-placeable**: the spec is pure data ``(num_shards, salt)``; an elastic
  restore onto another shard count is ``spec.replaced(k)`` plus a regroup of
  the per-stream snapshot leaves (``fleet.FleetSnapshot``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter

import torch

from repro_torch.dist.mesh import check_mesh
from repro_torch.dist.sharding import batch_pspecs

__all__ = ["PlacementSpec", "assign", "plan_devices", "shard_loads", "shard_of"]


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """The complete placement function, as data: ``shard_of`` is a pure
    function of (spec, stream_id).  Frozen and hashable; JSON round-trips
    through ``to_json``/``from_json``, so ``FleetSnapshot`` carries it in its
    aux spec."""

    num_shards: int
    salt: str = "repro.fleet"

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1; got {self.num_shards}")

    def replaced(self, num_shards: int) -> "PlacementSpec":
        """The same placement family at a new shard count (same salt)."""
        return dataclasses.replace(self, num_shards=num_shards)

    def to_json(self) -> dict:
        return {"num_shards": self.num_shards, "salt": self.salt}

    @classmethod
    def from_json(cls, d: dict) -> "PlacementSpec":
        return cls(num_shards=int(d["num_shards"]), salt=d["salt"])


def shard_of(spec: PlacementSpec, stream_id: str) -> int:
    """The shard owning ``stream_id`` (keyed blake2b of its UTF-8 bytes)."""
    digest = hashlib.blake2b(stream_id.encode("utf-8"), digest_size=8,
                             key=spec.salt.encode("utf-8")[:64]).digest()
    return int.from_bytes(digest, "big") % spec.num_shards


def assign(spec: PlacementSpec, stream_ids) -> dict[str, int]:
    """``shard_of`` over many ids: ``{stream_id: shard}``."""
    return {sid: shard_of(spec, sid) for sid in stream_ids}


def shard_loads(spec: PlacementSpec, stream_ids) -> list[int]:
    """Streams per shard under ``spec``: the balance observable."""
    counts = Counter(shard_of(spec, sid) for sid in stream_ids)
    return [counts.get(i, 0) for i in range(spec.num_shards)]


def plan_devices(num_shards: int, *, devices=None, mesh=None) -> tuple:
    """Per-shard device plan: shard ``i`` keeps its streams and runs its
    flush rounds on ``plan[i]`` (round-robin when shards outnumber devices).

    ``devices=None, mesh=None`` takes the cards of this process
    (``torch.cuda.device_count()``).  With a ``mesh`` (``dist.mesh.Mesh``)
    the plan walks the devices of the mesh axes a flush's batch is split over
    (``dist.batch_pspecs`` names them), first, then the rest, so shard
    placement and in-shard batch splitting agree on which devices carry
    flush work."""
    if devices is None:
        if check_mesh(mesh) is not None:
            axes = batch_pspecs(torch.zeros(1, 1))[0]
            axes = axes if isinstance(axes, tuple) else (axes,)
            names = [ax for ax in axes if ax in mesh.shape]
            order = ([mesh.axis_names.index(ax) for ax in names]
                     + [i for i, ax in enumerate(mesh.axis_names) if ax not in names])
            devices = list(mesh.devices.transpose(order).flat)
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("no devices to place shards on")
    return tuple(torch.device(devices[i % len(devices)]) for i in range(num_shards))
