"""``repro_torch.updates``: structured perturbations lowered onto the rank-1
engine, in PyTorch (counterpart of ``repro.updates``).

Ops (``RankK``, ``AppendRows``/``AppendCols``, ``RemoveRows``/``RemoveCols``,
``Window``, ``DenseDelta``, ``Sparse``, ``Decay``, ``Compose``) with exact
dense semantics, and a planner that turns any of them into a schedule of
``repro_torch.api`` rank-1 updates.  Low-rank extraction runs through the
randomized range-finder of ``updates.sketch``; ``Sparse`` deltas reach the
matrix only through kernel F (``kernels.sparse_proj``):

    from repro_torch import api
    from repro_torch.updates import Compose, Decay, Sparse

    state = api.SvdState.from_dense(x, rank=16)             # on the card
    state = api.apply(state, Compose((Decay(0.99), Sparse(rows, cols, vals, rank=8))))

``api.apply`` / ``api.apply_many`` are the entry points; this module builds
ops and shows the planner.
"""

from repro_torch.updates.ops import (
    AppendCols,
    AppendRows,
    Compose,
    Decay,
    DenseDelta,
    RankK,
    RemoveCols,
    RemoveRows,
    Sparse,
    UpdateOp,
    Window,
    skeleton_from_spec,
    spec_from_json,
    spec_to_json,
)
from repro_torch.updates.planner import (
    apply,
    apply_many,
    lower,
    op_low_rank_factors,
    schedule_cache_clear,
    schedule_cache_info,
    warmup_plan,
)
from repro_torch.updates.sketch import (
    factored_svd,
    range_finder,
    sketch_svd,
    sparse_sketch_svd,
    warmup_sketch,
)

__all__ = [
    "AppendCols",
    "AppendRows",
    "Compose",
    "Decay",
    "DenseDelta",
    "RankK",
    "RemoveCols",
    "RemoveRows",
    "Sparse",
    "UpdateOp",
    "Window",
    "apply",
    "apply_many",
    "factored_svd",
    "lower",
    "op_low_rank_factors",
    "range_finder",
    "schedule_cache_clear",
    "schedule_cache_info",
    "skeleton_from_spec",
    "sketch_svd",
    "sparse_sketch_svd",
    "spec_from_json",
    "spec_to_json",
    "warmup_plan",
]
