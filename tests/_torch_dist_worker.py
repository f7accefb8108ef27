"""One rank of the ``test_torch_dist`` gloo worlds (not collected itself).

Each rank joins a gloo process group through a file store (no TCP port, so
parallel test workers cannot collide), runs every collective check once and
writes its results to ``<out_dir>/rank<r>.npz``.  It imports torch and the
port only: the reference is compared in the test process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

M, N, R = 8, 12, 3


def factor(rank: int) -> np.ndarray:
    """Rank ``rank``'s (M, R) compression factor."""
    return np.random.default_rng(100 + rank).normal(size=(M, R))


def shard(rank: int) -> tuple:
    """Rank ``rank``'s truncated SVD (u, s, v) of its (M, N) row block of
    one matrix of rank R (so the merge is exact up to rounding)."""
    rng = np.random.default_rng(7)
    right = rng.normal(size=(R, N))
    block = np.random.default_rng(200 + rank).normal(size=(M, R)) @ right
    u, s, vt = np.linalg.svd(block, full_matrices=False)
    return u[:, :R].copy(), s[:R].copy(), vt[:R].T.copy()


def run(rank: int, world: int, init: str, out_dir: str) -> None:
    from repro_torch.api import SvdState
    from repro_torch.core.svd_update import TruncatedSvd
    from repro_torch.dist import all_gather_tsvd, distributed_merge, pmean_factor, psum_factor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        x = torch.as_tensor(factor(rank))
        local = TruncatedSvd(*(torch.as_tensor(a) for a in shard(rank)))
        gathered = all_gather_tsvd(SvdState(*local), group)
        merged = distributed_merge(local, group, rank=R)
        out = {"pmean": pmean_factor(x, group), "psum": psum_factor(x, group),
               "x_after": x, "gather_type": np.array(type(gathered).__name__),
               "merged_type": np.array(type(merged).__name__)}
        out.update({f"gathered_{f}": getattr(gathered, f) for f in ("u", "s", "v")})
        out.update({f"merged_{f}": getattr(merged, f) for f in ("u", "s", "v")})
        np.savez(f"{out_dir}/rank{rank}.npz",
                 **{k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()})
    finally:
        dist.destroy_process_group()
