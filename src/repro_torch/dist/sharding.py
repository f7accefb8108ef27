"""Sharding specs: one rulebook for parameters, batches and decode caches,
in PyTorch.

Counterpart of ``repro.dist.sharding``.  A spec is a tuple with one entry per
leading axis of the leaf (an axis name, a tuple of names, or None), trailing
unsharded axes dropped: the shape of the reference's ``PartitionSpec``.
The production mesh is ``(data=16, model=16)`` a pod, with an optional
leading ``pod=2`` axis (``launch.mesh.make_production_mesh``); every axis a
spec shards is divisible by the product of the production sizes of the mesh
axes named for it (``AXIS_SIZES``).

The rules follow the shapes, so one code covers every family:

* **parameters** (``param_pspecs``): 1-D leaves (norm gains, biases)
  replicate.  In a leaf of two axes or more the rightmost divisible axis of
  the last two takes ``model`` (tensor parallelism: the d_ff / head / vocab /
  expert-width axis in every family) and the rightmost remaining divisible
  axis takes ``data`` (ZeRO/FSDP weight sharding, gathered at use by
  ``gather_for_compute`` when ``cfg.fsdp_gather_params``).  A leaf under a
  stacked-layer key (``layers``, ``groups``, ...) never shards its leading
  depth axis.
* **batches** (``batch_pspecs``): the leading (global-batch) axis over
  ``data`` (and ``pod`` when multi-pod), everything else replicated.
* **caches** (``cache_pspecs``): stacked decode caches are ``(L, batch, seq,
  ...)``, the batch axis over ``data``; a long-context cell (batch 1) shards
  its longest trailing axis (the sequence) instead when
  ``seq_shard_fallback``, or replicates.

A leaf of the port is a whole tensor on one device: the specs say where a
deployment would place the pieces (``launch.dryrun`` reckons bytes and
collectives from them), ``train.elastic.reshard`` checks a tree against a
mesh's axis sizes by them, and a mesh's batch axis splits a batch or a
flush over its entries (``core.engine``, ``train.loop``).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.dist.mesh import Mesh, check_mesh

__all__ = ["AXIS_SIZES", "BatchSharding", "batch_pad", "batch_pspecs", "batch_sharding",
           "cache_pspecs", "gather_for_compute", "param_pspecs", "spec_divisor"]

#: Production mesh axis sizes: the divisibility contract of every spec.
AXIS_SIZES: dict[str, int] = {"pod": 2, "data": 16, "model": 16}

#: Tree keys whose children are layer stacks (the reference's ``lax.scan``
#: axis): their leading depth axis is never sharded.  The port's trees keep
#: the reference's keys (``convert.params_from_reference`` maps them one to
#: one), and the port's ``dense_layers`` (``MoEPortConfig.first_dense``).
_STACKED_KEYS = frozenset({"layers", "groups", "tail", "blocks", "enc_layers", "dec_layers",
                           "dense_layers"})


def _is_leaf(x) -> bool:
    return hasattr(x, "shape")       # a tensor, a TensorSpec, a numpy array


def _map(fn, tree, keys=frozenset()):
    """``fn(leaf, keys)`` over a tree of dicts, tuples and lists, ``keys`` the
    dict keys on the path to the leaf."""
    if _is_leaf(tree):
        return fn(tree, keys)
    if isinstance(tree, dict):
        return {k: _map(fn, v, keys | {k}) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x, keys) for x in tree)
    return fn(tree, keys)


def spec_divisor(ax, sizes=None) -> int:
    """The number of pieces a spec entry (an axis name or a tuple of names)
    cuts its axis into, at ``sizes`` (default ``AXIS_SIZES``)."""
    sizes = AXIS_SIZES if sizes is None else sizes
    if ax is None:
        return 1
    return math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))


def _divides(dim: int, ax) -> bool:
    return dim % spec_divisor(ax) == 0


def _trim(axes: list) -> tuple:
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def _leaf_param_spec(shape: tuple, *, stacked: bool) -> tuple:
    """Model and data axes of one parameter leaf (see the module docstring)."""
    nd = len(shape)
    if nd < 2:
        return ()
    axes: list = [None] * nd
    first = 1 if stacked else 0       # the stack's depth axis stays whole
    for i in (nd - 1, nd - 2):        # tensor parallel: rightmost divisible
        if i >= first and _divides(shape[i], "model"):
            axes[i] = "model"
            break
    for i in range(nd - 1, first - 1, -1):    # FSDP: rightmost remaining divisible
        if axes[i] is None and _divides(shape[i], "data"):
            axes[i] = "data"
            break
    return _trim(axes)


def param_pspecs(tree):
    """Specs of a parameter tree (tensors, meta tensors from ``api.init(None,
    device="meta")``, or anything with a ``shape``), in its structure.

    >>> import torch
    >>> param_pspecs({"layers": {"w": torch.empty(4, 32, 48, device="meta")},
    ...               "head": torch.empty(32, 48, device="meta"), "g": torch.empty(48)})
    {'layers': {'w': (None, 'data', 'model')}, 'head': ('data', 'model'), 'g': ()}
    """
    return _map(lambda leaf, keys: _leaf_param_spec(tuple(leaf.shape),
                                                    stacked=bool(keys & _STACKED_KEYS)), tree)


def _data_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def batch_pspecs(batch, *, multi_pod: bool = False):
    """Data-parallel specs for a batch (a tensor, or dicts, tuples and lists
    of them): each leaf's leading dim over ``data`` (``("pod", "data")``
    multi-pod), everything else replicated; a 0-d leaf replicates (``()``).

    >>> import torch
    >>> batch_pspecs({"x": torch.zeros(4, 3), "t": torch.zeros(())})
    {'x': ('data', None), 't': ()}
    """
    ax = _data_axes(multi_pod)

    def spec(leaf, _keys):
        nd = len(leaf.shape)
        return () if nd == 0 else (ax,) + (None,) * (nd - 1)

    return _map(spec, batch)


def cache_pspecs(cache, *, multi_pod: bool = False, long_context: bool = False,
                 seq_shard_fallback: bool = True):
    """Specs of stacked decode caches and recurrent states ``(L, batch,
    ...)``: the batch axis (the leading one of a 2-D leaf) over ``data``.  A
    ``long_context`` (batch 1) cell shards its longest trailing axis (the
    sequence) instead when ``seq_shard_fallback``, else the cache replicates.

    >>> import torch
    >>> kv = {"k": torch.empty(2, 32, 1024, 8, 64, device="meta")}
    >>> cache_pspecs(kv), cache_pspecs(kv, long_context=True)
    ({'k': (None, 'data')}, {'k': (None, None, 'data')})
    """
    ax = _data_axes(multi_pod)

    def spec(leaf, _keys):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd < 2:
            return ()
        bdim = 1 if nd >= 3 else 0          # the leading axis is the layer stack
        axes: list = [None] * nd
        if not long_context and _divides(shape[bdim], ax):
            axes[bdim] = ax
        elif long_context and seq_shard_fallback and nd > bdim + 1:
            sdim = max(range(bdim + 1, nd), key=lambda i: shape[i])
            if _divides(shape[sdim], ax):
                axes[sdim] = ax
        return _trim(axes)

    return _map(spec, cache)


def gather_for_compute(params, compute_dtype):
    """ZeRO-3 gather at use: every floating leaf cast to the compute dtype,
    the others as they are.  The reference also constrains each leaf to
    replicated, so XLA all-gathers an FSDP-sharded weight where it is used; a
    leaf of the port is already whole on its device, so placement is left
    alone and the cast is all there is to do (``launch.roofline``'s
    ``collective_bytes`` counts the all-gathers a sharded deployment pays)."""
    from repro_torch.models.layers import as_dtype

    cd = as_dtype(compute_dtype)
    return _map(lambda x, _keys: x.to(cd) if x.is_floating_point() else x, params)


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
