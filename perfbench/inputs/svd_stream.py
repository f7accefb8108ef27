"""Inputs of an SVD-update service cell: every stream's starting truncated
SVD, drawn on the device, and the pool of rank-1 events the clients send,
drawn on the device and held on the host as a client's events arrive.

Stream ``i``'s ``j``-th event is pool entry ``(offset(i) + j) mod P``: the
same for every seed and every run length, so the work a run does depends on
the seed only through the values.  Each event is a pair of unit vectors; the
streams' spectra lie a decade or more above it (``traffic["spectrum"]``), so
the triplet each update discards is the new one's residual and no two kept
values come close: every update is determined up to signs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.inputs import derive_seed

_STATES, _POOL, _SAMPLE = 1, 2, 3


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def make_states(cfg: dict, traffic: dict, seed: int, device):
    """``(u (S, m, r), s (S, r), v (S, n, r))`` of all ``S`` streams: three
    batched draws and two batched QR factorisations on the device."""
    S, m, n, r, dt = cfg["streams"], cfg["m"], cfg["n"], cfg["rank"], dtype_of(cfg)
    hi, lo = traffic["spectrum"]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, _STATES))
    u, _ = torch.linalg.qr(torch.randn((S, m, r), generator=gen, device=device, dtype=dt))
    v, _ = torch.linalg.qr(torch.randn((S, n, r), generator=gen, device=device, dtype=dt))
    base = torch.logspace(math.log10(hi), math.log10(lo), r, dtype=dt, device=device)
    s = base * (1 + 0.01 * torch.rand((S, r), generator=gen, device=device, dtype=dt))
    return u.contiguous(), s, v.contiguous()


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """``(a (P, m), b (P, n))`` float arrays on the host, unit rows."""
    p, dt = traffic["pool"], dtype_of(cfg)
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, _POOL))
    out = []
    for width in (cfg["m"], cfg["n"]):
        x = torch.randn((p, width), generator=gen, device=device, dtype=dt)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        out.append(np.ascontiguousarray(x.cpu().numpy()))
    return out[0], out[1]


def offsets(cfg: dict, traffic: dict) -> np.ndarray:
    s, p = cfg["streams"], traffic["pool"]
    return (np.arange(s, dtype=np.int64) * p) // s


def event_indices(cfg: dict, traffic: dict, stream: int, count: int) -> np.ndarray:
    """Pool indices of stream ``stream``'s first ``count`` events."""
    return (offsets(cfg, traffic)[stream] + np.arange(count)) % traffic["pool"]


def sample_streams(cfg: dict, traffic: dict, seed: int) -> list[int]:
    """The streams whose states the comparison checks, drawn from the seed."""
    rng = np.random.default_rng(derive_seed(seed, _SAMPLE))
    k = min(traffic["checked_streams"], cfg["streams"])
    return sorted(int(i) for i in rng.choice(cfg["streams"], size=k, replace=False))
