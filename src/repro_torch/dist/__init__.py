"""``repro_torch.dist``: the distributed layer, in PyTorch.

Counterpart of ``repro.dist``:

* ``dist.mesh`` — ``Mesh``, a named grid of devices in one process (the
  counterpart of ``jax.sharding.Mesh``), and ``make_host_mesh``;
* ``dist.sharding`` — the rulebook of specs: parameters (``param_pspecs``),
  decode caches (``cache_pspecs``), batches (``batch_pspecs``), the ZeRO-3
  cast at use (``gather_for_compute``), and the batch-axis helpers
  (``batch_sharding``, ``batch_pad``) the engine and the service spread a
  flush by;
* ``dist.collectives`` — the compressed all-reduce's collectives on a
  ``torch.distributed`` group (factor means and sums, the truncated-SVD
  factor all-gather) and their wire accounting;
* ``dist.merge`` — the log-depth truncated-SVD merge built from the paper's
  rank-1 updates (``merge_pair``, ``merge_append``, ``merge_tree``) and its
  cross-process form ``distributed_merge``.
"""

from repro_torch.dist import collectives, merge, mesh, sharding
from repro_torch.dist.collectives import (
    all_gather_tsvd,
    factor_wire_bytes,
    pmean_factor,
    psum_factor,
)
from repro_torch.dist.merge import distributed_merge, merge_append, merge_pair, merge_tree
from repro_torch.dist.mesh import Mesh, make_host_mesh
from repro_torch.dist.sharding import (
    AXIS_SIZES,
    BatchSharding,
    batch_pad,
    batch_pspecs,
    batch_sharding,
    cache_pspecs,
    gather_for_compute,
    param_pspecs,
)

__all__ = [
    "AXIS_SIZES",
    "BatchSharding",
    "Mesh",
    "all_gather_tsvd",
    "batch_pad",
    "batch_pspecs",
    "batch_sharding",
    "cache_pspecs",
    "collectives",
    "distributed_merge",
    "factor_wire_bytes",
    "gather_for_compute",
    "make_host_mesh",
    "merge",
    "merge_append",
    "merge_pair",
    "merge_tree",
    "mesh",
    "param_pspecs",
    "pmean_factor",
    "psum_factor",
    "sharding",
]
