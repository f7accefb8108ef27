"""One rank of the ``test_torch_optim`` gloo world (not collected itself).

Each rank joins a gloo process group through a file store, runs
``optim.compression.compressed_allreduce`` on its own gradients (a tree of
two 2-D leaves of one geometry, one of another, and a bias) and
``agree_basis`` on its own tracker, and writes the results to
``<out_dir>/rank<r>.npz``.  It imports torch and the port only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

M, N, R = 12, 10, 3


def grads(rank: int) -> dict:
    """Rank ``rank``'s gradient tree (float64)."""
    rng = np.random.default_rng(300 + rank)
    return {"a": rng.normal(size=(M, N)), "b": rng.normal(size=(M, N)),
            "c": rng.normal(size=(N, M)), "bias": rng.normal(size=(N,))}


def init_state(m: int, n: int, seed: int) -> tuple:
    """(v_basis, tracker u) of a compression state, the same on every rank."""
    rng = np.random.default_rng(seed)
    v0 = np.linalg.qr(rng.normal(size=(n, R)))[0]
    u0 = np.linalg.qr(rng.normal(size=(m, R)))[0]
    return v0, u0


def tracker(rank: int) -> tuple:
    """Rank ``rank``'s rank-R tracker of its (M, N) row block."""
    rng = np.random.default_rng(400 + rank)
    u, s, vt = np.linalg.svd(rng.normal(size=(M, N)), full_matrices=False)
    return u[:, :R].copy(), s[:R].copy(), vt[:R].T.copy()


def _state(m, n, seed):
    from repro_torch.api import SvdState
    from repro_torch.optim.compression import CompressionState

    v0, u0 = (torch.as_tensor(x) for x in init_state(m, n, seed))
    return CompressionState(v_basis=v0, error=torch.zeros((m, n), dtype=torch.float64),
                            tracker=SvdState(u=u0, s=torch.zeros(R, dtype=torch.float64), v=v0))


def run(rank: int, world: int, init: str, out_dir: str) -> None:
    from repro_torch.api import SvdState
    from repro_torch.optim.compression import agree_basis, compressed_allreduce

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        g = {k: torch.as_tensor(v) for k, v in grads(rank).items()}
        states = {"a": _state(M, N, 1), "b": _state(M, N, 2), "c": _state(N, M, 3), "bias": None}
        out_g, out_s = compressed_allreduce(states, g, axis_name=group)
        st = _state(M, N, 4)
        st = st._replace(tracker=SvdState(*(torch.as_tensor(x) for x in tracker(rank))))
        agreed = agree_basis(st, axis_name=group)
        out = {f"g_{k}": v for k, v in out_g.items()}
        for k in ("a", "b", "c"):
            out[f"err_{k}"] = out_s[k].error
            out[f"vb_{k}"] = out_s[k].v_basis
            out.update({f"tr_{k}_{f}": getattr(out_s[k].tracker, f) for f in ("u", "s", "v")})
        out["agree_vb"] = agreed.v_basis
        out.update({f"agree_{f}": getattr(agreed.tracker, f) for f in ("u", "s", "v")})
        np.savez(f"{out_dir}/rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()
