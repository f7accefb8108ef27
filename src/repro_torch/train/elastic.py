"""Elastic scaling: size the mesh and the fleet to the devices alive at
restart, in PyTorch.

Counterpart of ``repro.train.elastic``.  Checkpoints and fleet snapshots hold
full host arrays, so they are independent of the mesh and of the shard
count.  On restart ``plan_mesh`` takes the largest ``(data, model)``
factorisation of the cards present and ``plan_shard_count`` sizes a restored
fleet (``SvdFleet.restore(num_shards="auto")``) to one shard per device;
``FleetSnapshot.regrouped`` then moves every stream's leaves, bitwise, and
``reshard`` places a restored parameter tree on the new mesh.
"""

from __future__ import annotations

import torch

from repro_torch._tree import flatten_up_to, tree_flatten_with_names, tree_unflatten
from repro_torch.dist import sharding as sh
from repro_torch.dist.mesh import Mesh, check_mesh, make_host_mesh

__all__ = ["largest_factorization", "plan_mesh", "plan_shard_count", "reshard"]


def largest_factorization(n: int, max_model: int = 16) -> tuple[int, int]:
    """``(data, model)`` with ``model`` as large as possible, ``model | n``,
    ``model <= max_model``.

    >>> largest_factorization(12, max_model=8)
    (2, 6)
    """
    for m in range(min(max_model, n), 0, -1):
        if n % m == 0:
            return n // m, m
    return n, 1


def plan_mesh(max_model: int = 16, *, device="cuda") -> Mesh:
    """A ``(data, model)`` mesh over the cards present (the CPU's one device
    for ``device="cpu"``), factorised by ``largest_factorization``."""
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    data, model = largest_factorization(max(n, 1), max_model)
    return make_host_mesh(data, model, device=device)


def plan_shard_count(max_shards: int | None = None, *, devices=None) -> int:
    """Fleet shard count for the devices alive: one service shard a device
    (``devices`` when given, else the cards), optionally capped."""
    n = len(devices) if devices is not None else torch.cuda.device_count()
    if n < 1:
        raise ValueError("no live devices to plan shards for")
    return min(n, max_shards) if max_shards is not None else n


def reshard(tree, mesh: Mesh):
    """Place a host parameter tree on ``mesh`` by the parameter rules
    (``dist.sharding.param_pspecs``): every axis a spec shards must divide
    into that mesh's axis sizes, else ``ValueError``.  A leaf of the port is
    whole on its device, so each leaf goes to the mesh's first device, its
    values unchanged to the bit; on one card every entry of the mesh is that
    card."""
    home = check_mesh(mesh).devices.flat[0]
    sizes = mesh.shape
    names, leaves = tree_flatten_with_names(tree)
    specs = flatten_up_to(tree, sh.param_pspecs(tree))
    for name, leaf, spec in zip(names, leaves, specs):
        for i, (dim, ax) in enumerate(zip(leaf.shape, spec)):
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                mesh.axis_size(a)
            k = sh.spec_divisor(ax, sizes)
            if dim % k:       # the reference's device_put raises the same
                raise ValueError(f"leaf {name}: spec {spec} implies that array axis {i} is "
                                 f"partitioned {k} times on mesh {sizes}, but does not evenly "
                                 f"divide the dimension size {dim}")
    return tree_unflatten(tree, [x.to(home) for x in leaves])
