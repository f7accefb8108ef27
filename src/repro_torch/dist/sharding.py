"""The batch half of the sharding rulebook, in PyTorch.

Counterpart of ``repro.dist.sharding``'s batch-axis rules: a flush of B
stacked updates spreads its leading batch axis over the ``data`` mesh axis
(``pod`` and ``data`` when multi-pod), every per-update axis replicated.  A
spec is a tuple with one entry per axis of the leaf (an axis name, a tuple of
names, or None), the shape of the reference's ``PartitionSpec``.
``AXIS_SIZES`` are the reference's production axis sizes, the divisibility
contract its specs are checked against.

The parameter and cache rules (``param_pspecs``, ``cache_pspecs``,
``gather_for_compute``) describe the models and wait for them (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses

from repro_torch.dist.mesh import Mesh, check_mesh

__all__ = ["AXIS_SIZES", "BatchSharding", "batch_pad", "batch_pspecs", "batch_sharding"]

#: Production mesh axis sizes: the divisibility contract of every spec.
AXIS_SIZES: dict[str, int] = {"pod": 2, "data": 16, "model": 16}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    return fn(tree)


def batch_pspecs(batch, *, multi_pod: bool = False):
    """Data-parallel specs for a batch (a tensor, or dicts, tuples and lists
    of them): each leaf's leading dim over ``data`` (``("pod", "data")``
    multi-pod), everything else replicated; a 0-d leaf replicates (``()``).

    >>> import torch
    >>> batch_pspecs({"x": torch.zeros(4, 3), "t": torch.zeros(())})
    {'x': ('data', None), 't': ()}
    """
    ax = ("pod", "data") if multi_pod else "data"

    def spec(leaf):
        nd = len(leaf.shape)
        return () if nd == 0 else (ax,) + (None,) * (nd - 1)

    return _map(spec, batch)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """A leading batch axis split over one mesh axis, every other axis
    replicated: what ``core.engine.SvdEngine(sharding=...)`` spreads its
    batched updates by (the reference's ``NamedSharding(mesh, P(axis))``)."""

    mesh: Mesh
    axis: str = "data"

    def __post_init__(self):
        if check_mesh(self.mesh) is None:
            raise TypeError("BatchSharding needs a Mesh")
        self.mesh.axis_size(self.axis)


def batch_sharding(mesh: Mesh, axis: str = "data") -> BatchSharding:
    """Sharding that splits a leading batch axis over one mesh axis."""
    return BatchSharding(mesh, axis)


def batch_pad(b: int, mesh: Mesh, axis: str = "data") -> int:
    """Rows of padding that make a batch of ``b`` divisible by the mesh axis
    (batched updates pad by repeating their last member, results discarded)."""
    return (-b) % check_mesh(mesh).axis_size(axis)
