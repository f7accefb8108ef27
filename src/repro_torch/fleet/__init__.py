"""``repro_torch.fleet``: the population-sharded ``SvdService`` tier
(DESIGN.md §13), in PyTorch.

Layering (each file one layer, composed top-down):

    placement.py   deterministic hashed stream -> shard assignment (pure data)
    frontend.py    continuous-batching admission over one service
    shard.py       one SvdService + frontend = one fleet shard, on one device
    fleet.py       SvdFleet: routing, query-time merge, FleetSnapshot v8

The fleet exposes the service surface (register / enqueue / enqueue_op /
state / flush / drain / merge_streams) over ``num_shards`` independent
services; shards compose only at query time through ``dist.merge``.
"""

from repro_torch.fleet.fleet import FLEET_SNAPSHOT_VERSION, FleetSnapshot, SvdFleet
from repro_torch.fleet.frontend import ContinuousBatcher
from repro_torch.fleet.placement import (
    PlacementSpec,
    assign,
    plan_devices,
    shard_loads,
    shard_of,
)
from repro_torch.fleet.shard import FleetShard

__all__ = [
    "FLEET_SNAPSHOT_VERSION",
    "ContinuousBatcher",
    "FleetShard",
    "FleetSnapshot",
    "PlacementSpec",
    "SvdFleet",
    "assign",
    "plan_devices",
    "shard_loads",
    "shard_of",
]
