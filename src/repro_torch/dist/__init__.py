"""``repro_torch.dist``: the local merge and the wire accounting, in PyTorch.

Counterpart of ``repro.dist``, so far without meshes (ROADMAP A7):

* ``dist.merge`` — the log-depth truncated-SVD merge built from the paper's
  rank-1 updates (``merge_pair``, ``merge_append``, ``merge_tree``); its
  cross-card form ``distributed_merge`` is refused by name;
* ``dist.collectives`` — ``factor_wire_bytes``; the collectives are refused
  by name.
"""

from repro_torch.dist import collectives, merge
from repro_torch.dist.collectives import factor_wire_bytes
from repro_torch.dist.merge import distributed_merge, merge_append, merge_pair, merge_tree

__all__ = [
    "collectives",
    "distributed_merge",
    "factor_wire_bytes",
    "merge",
    "merge_append",
    "merge_pair",
    "merge_tree",
]
