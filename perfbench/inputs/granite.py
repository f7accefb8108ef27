"""Inputs of a dense-decoder training cell: the weights, the spectral
trackers' starting state and the token batches, all drawn on the device from
the seed.

The weights follow the port's parameter layout (``embed.table``, the stacked
``layers`` leaves, ``final_norm``, the untied ``head``) and its init scales
(uniform in +-1/sqrt(fan_in), norm weights at one, biases at nought), one large draw a leaf
from a generator of its own, so any leaf can be drawn again alone.

The trackers start warm, as in a run resumed mid-training: random
orthonormal bases and a spectrum spread over a decade with no two values
close (``traffic["tracker_spectrum"]``), so every singular triplet of every
update is determined up to its sign.  A zero spectrum (a fresh tracker)
leaves all but one triplet of the first update free, and a free triplet
would make any two correct implementations part.
"""

from __future__ import annotations

import math

import torch

from perfbench.inputs import derive_seed

_WEIGHTS, _TRACKERS, _BATCHES = 1, 2, 3
ONES, ZEROS = "ones", "zeros"


def padded_vocab(cfg: dict) -> int:
    p = cfg["vocab_pad_to"]
    return (cfg["vocab_size"] + p - 1) // p * p


def leaf_specs(cfg: dict) -> list[tuple]:
    """``(path, shape, scale)`` of every parameter leaf in sorted path order;
    ``scale`` ``ONES`` marks a norm's weight, ``ZEROS`` a bias (the port's
    init of both)."""
    d, f, L = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    h, kvh = cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("d_head") or d // h
    vp = padded_vocab(cfg)
    if cfg["mlp_type"] not in ("swiglu", "gelu") or cfg["norm_type"] not in ("rmsnorm", "layernorm") \
            or cfg.get("tie_embeddings"):
        raise NotImplementedError("the inputs cover the dense decoder with a SwiGLU or GELU MLP, "
                                  "RMSNorm or LayerNorm, and an untied head")
    specs = [
        (("embed", "table"), (vp, d), d ** -0.5),
        (("head",), (d, vp), d ** -0.5),
        (("layers", "attn", "wk"), (L, d, kvh * dh), d ** -0.5),
        (("layers", "attn", "wo"), (L, h * dh, d), (h * dh) ** -0.5),
        (("layers", "attn", "wq"), (L, d, h * dh), d ** -0.5),
        (("layers", "attn", "wv"), (L, d, kvh * dh), d ** -0.5),
        (("layers", "mlp", "wd"), (L, f, d), f ** -0.5),
    ]
    if cfg["mlp_type"] == "swiglu":
        specs += [(("layers", "mlp", "wg"), (L, d, f), d ** -0.5),
                  (("layers", "mlp", "wu"), (L, d, f), d ** -0.5)]
    else:
        specs += [(("layers", "mlp", "wi"), (L, d, f), d ** -0.5)]
    for norm, lead in (("final_norm", ()), (("layers", "ln1"), (L,)), (("layers", "ln2"), (L,))):
        path = norm if isinstance(norm, tuple) else (norm,)
        specs.append((path + ("w",), lead + (d,), ONES))
        if cfg["norm_type"] == "layernorm":
            specs.append((path + ("b",), lead + (d,), ZEROS))
    if cfg.get("qkv_bias"):
        specs += [(("layers", "attn", "bq"), (L, h * dh), ZEROS),
                  (("layers", "attn", "bk"), (L, kvh * dh), ZEROS),
                  (("layers", "attn", "bv"), (L, kvh * dh), ZEROS)]
    return sorted(specs)


def make_leaf(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` of ``leaf_specs`` (float32)."""
    _, shape, scale = leaf_specs(cfg)[index]
    if scale in (ONES, ZEROS):
        return (torch.ones if scale == ONES else torch.zeros)(shape, dtype=torch.float32,
                                                             device=device)
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, _WEIGHTS, index))
    x = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(2 * scale).sub_(scale)


def nest(flat: dict) -> dict:
    """``{path: tensor}`` -> the nested parameter dict."""
    out: dict = {}
    for path, x in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def flatten(tree, prefix=()) -> dict:
    """The nested dict -> ``{path: tensor}`` in sorted path order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def make_weights(cfg: dict, seed: int, device) -> dict:
    return nest({path: make_leaf(cfg, seed, i, device)
                 for i, (path, _, _) in enumerate(leaf_specs(cfg))})


def tracked(shape, rank: int) -> bool:
    """Whether spectral-Adam keeps a tracker for a leaf of ``shape``: a matrix
    whose smaller side exceeds four times the rank."""
    return len(shape) == 2 and min(shape) > 4 * rank


def make_trackers(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """``{path: (u (m, r), s (r,), v (n, r), power_v (n,))}`` for every tracked
    leaf, float32."""
    r = traffic["optimizer"]["spectral_rank"]
    hi, lo = traffic["tracker_spectrum"]
    out = {}
    for i, (path, shape, _) in enumerate(leaf_specs(cfg)):
        if not tracked(shape, r):
            continue
        m, n = shape
        gen = torch.Generator(device=device).manual_seed(derive_seed(seed, _TRACKERS, i))
        u, _ = torch.linalg.qr(torch.randn((m, r), generator=gen, device=device))
        v, _ = torch.linalg.qr(torch.randn((n, r), generator=gen, device=device))
        pv = torch.randn((n,), generator=gen, device=device) / math.sqrt(n)
        s = torch.logspace(math.log10(hi), math.log10(lo), r, dtype=torch.float32, device=device)
        out[path] = (u.contiguous(), s, v.contiguous(), pv)
    return out


class Batches:
    """The token batches of a run: step ``i``'s ``{"tokens", "labels"}``,
    int32 ``(batch, seq)``, drawn in step order from one generator on the
    device (uniform over the vocabulary; every row differs)."""

    def __init__(self, cfg: dict, seed: int, device):
        self.vocab, self.batch, self.seq = cfg["vocab_size"], cfg["global_batch"], cfg["seq_len"]
        self.gen = torch.Generator(device=device).manual_seed(derive_seed(seed, _BATCHES))
        self.device = device
        self.drawn = 0

    def next(self) -> dict:
        toks = torch.randint(0, self.vocab, (self.batch, self.seq + 1), generator=self.gen,
                             device=self.device, dtype=torch.int64).to(torch.int32)
        self.drawn += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
