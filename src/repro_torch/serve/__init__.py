"""``repro_torch.serve``: the streaming SVD-update service, in PyTorch.

``serve.svd_service`` — the checkpointable async micro-batching rank-1
SVD-update service: many streams enqueue ``(a, b)`` pairs and structured
events, each flush is one batched ``core.engine.SvdEngine`` call per
geometry group, rounds complete on CUDA events, snapshots persist through
``train.checkpoint`` (DESIGN.md §9).  The reference's LM engine
(``serve.engine``) is not ported yet (ROADMAP A9).
"""

from repro_torch.serve.svd_service import (  # noqa: F401
    SNAPSHOT_VERSION,
    ServiceSnapshot,
    SvdService,
    SvdServiceStats,
)
