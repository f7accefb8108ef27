"""The compressed all-reduce's collectives and wire accounting, on
``torch.distributed``.

Counterpart of ``repro.dist.collectives``.  The paper's system pitch: at
data-parallel scale a dense gradient all-reduce moves ``m*n`` floats per
layer per step, while the rank-r compressed path moves only the two factors,
``r*(m+n)`` floats (``factor_wire_bytes``).  This module is the one place
those collectives are issued.

The reference's axis name becomes a ``torch.distributed`` process group
(``ProcessGroup``, or ``dist.group.WORLD``); ``None`` keeps the single-worker
meaning, a no-op, so the same code runs without a group.  Each call is a
collective: every rank of the group makes it, in the same order.  Tensors
stay where they are: NCCL moves CUDA tensors between cards, gloo CPU tensors
(and CUDA ones, staging them through the host inside gloo).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.api.state import like_container

__all__ = [
    "all_gather_tsvd",
    "factor_wire_bytes",
    "pmean_factor",
    "psum_factor",
]


def _check_group(group) -> None:
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"expected a torch.distributed ProcessGroup (or None); got "
                        f"{type(group).__name__}")


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    _check_group(group)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def pmean_factor(x: torch.Tensor, group) -> torch.Tensor:
    """Mean-reduce one compression factor across the group (``all_reduce``
    with ``AVG``).  The only thing that crosses the wire in a compressed
    all-reduce round is this ``(m, r)`` / ``(n, r)`` factor."""
    if group is None:
        return x
    return _all_reduce(x, group, dist.ReduceOp.AVG)


def psum_factor(x: torch.Tensor, group) -> torch.Tensor:
    """Sum-reduce one factor across the group (``all_reduce`` with ``SUM``);
    a no-op without a group."""
    if group is None:
        return x
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_gather_tsvd(tsvd, group):
    """Gather per-worker truncated-SVD factors: ``u``, ``s`` and ``v`` gain a
    leading ``(n_workers,)`` axis, in rank order, in ``tsvd``'s container
    type.  Wire cost is ``r*(m+n+1)`` floats per worker, the input of
    ``dist.merge.distributed_merge``'s local merge tree.  ``group=None``
    returns the single-worker stack (leading axis 1)."""
    leaves = (tsvd.u, tsvd.s, tsvd.v)
    if group is None:
        return like_container(tsvd, *(x[None] for x in leaves))
    _check_group(group)
    world = dist.get_world_size(group)

    def gather(x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    return like_container(tsvd, *(gather(x) for x in leaves))


def factor_wire_bytes(m: int, n: int, rank: int, *, n_workers: int = 1,
                      itemsize: int = 4) -> dict:
    """Per-layer wire accounting: dense all-reduce vs the compressed factor
    exchange (two pmean rounds) vs a full factor all-gather.

    >>> factor_wire_bytes(8, 8, 2, n_workers=2)["factor_allgather"]
    272
    """
    dense = m * n * itemsize
    compressed = rank * (m + n) * itemsize
    gather = n_workers * rank * (m + n + 1) * itemsize
    return {
        "dense_allreduce": dense,
        "compressed_allreduce": compressed,
        "factor_allgather": gather,
        "ratio": dense / compressed,
    }
