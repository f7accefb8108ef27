"""Inputs of a DeepSeek-V2 training cell (MLA with YaRN rope, a leading dense
layer, MoE layers holding one chip's share of the routed experts): the
weights, the spectral trackers' starting state and the token batches, drawn
on the device from the seed as ``inputs.granite`` draws a dense decoder's.

The configuration file uses the published config's keys (``dims`` reads
them).  The weights follow the port's layout for it: ``embed.table``,
``dense_layers`` (the first ``first_k_dense_replace`` layers stacked, each
with ``ln1``, ``ln2``, ``mla`` and a SwiGLU ``mlp`` of ``intermediate_size``),
``layers`` (the MoE layers stacked: ``ln1``, ``ln2``, ``mla``, ``moe`` with a
float32 ``router`` of every routed expert's output, the held experts'
``wg``/``wu``/``wd`` and the ``shared`` SwiGLU), ``final_norm`` and the
untied ``head``.  Init scales are the port's: uniform in +-1/sqrt(fan_in),
norm weights at one.  Only the 2-D leaves (the embedding and the head) keep
trackers.

These weights route unevenly (``tools/route_probe.py`` reads it).  A fresh
draw's attention is near uniform, so each block adds nearly one vector to
every later position of a sequence; that vector outgrows the embedding
within a few layers, points another way in each sequence (no low-dimensional
subspace holds them), and the router ranks the experts by it.  So most of
the held experts' routed choices are dropped over capacity, and no router
drawn ahead of the sequences avoids it.  Scales that keep the residual
stream the token's own (a unit-variance embedding and output projections
scaled by 1/sqrt(2 L)) balance the routing, but they flatten the tracked
leaves' gradient spectra, and the reference comparison of spectral-Adam's
steps then loses its margin.
"""

from __future__ import annotations

import math

import torch

from perfbench.inputs import derive_seed
from perfbench.inputs import granite as gin
from perfbench.inputs.granite import Batches, flatten, nest, tracked  # noqa: F401

ONES = gin.ONES
_WEIGHTS, _TRACKERS = 1, 2    # derive_seed parts, as inputs.granite's


def dims(cfg: dict) -> dict:
    """The sizes the inputs, the reference and the counts use."""
    ep = cfg["expert_parallel"]
    held = cfg["n_routed_experts"]
    return {"d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
            "dn": cfg["qk_nope_head_dim"], "dr": cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"], "r": cfg["kv_lora_rank"],
            "f_dense": cfg["intermediate_size"], "f_exp": cfg["moe_intermediate_size"],
            "n_dense": cfg["first_k_dense_replace"],
            "n_moe": cfg["num_hidden_layers"] - cfg["first_k_dense_replace"],
            "n_routed": ep["routed_experts"], "n_held": held, "held_start": ep["rank"] * held,
            "n_shared": cfg["n_shared_experts"], "k": cfg["num_experts_per_tok"],
            "vocab": cfg["vocab_size"], "vocab_padded": gin.padded_vocab(cfg)}


def _mla_specs(prefix, n, z) -> list:
    d, h, r = z["d"], z["h"], z["r"]
    return [(prefix + ("wq",), (n, d, h * (z["dn"] + z["dr"])), d ** -0.5),
            (prefix + ("w_dkv",), (n, d, r + z["dr"]), d ** -0.5),
            (prefix + ("kv_norm",), (n, r), ONES),
            (prefix + ("w_uk",), (n, r, h * z["dn"]), r ** -0.5),
            (prefix + ("w_uv",), (n, r, h * z["dv"]), r ** -0.5),
            (prefix + ("wo",), (n, h * z["dv"], d), (h * z["dv"]) ** -0.5)]


def _swiglu_specs(prefix, lead, d, f) -> list:
    return [(prefix + ("wg",), lead + (d, f), d ** -0.5),
            (prefix + ("wu",), lead + (d, f), d ** -0.5),
            (prefix + ("wd",), lead + (f, d), f ** -0.5)]


def leaf_specs(cfg: dict) -> list[tuple]:
    """``(path, shape, scale)`` of every parameter leaf in sorted path order
    (``scale`` ``ONES`` marks a norm's weight)."""
    z = dims(cfg)
    d, vp = z["d"], z["vocab_padded"]
    if cfg.get("tie_word_embeddings") or cfg.get("q_lora_rank") is not None:
        raise NotImplementedError("the inputs cover an untied head and MLA without q-LoRA")
    specs = [(("embed", "table"), (vp, d), d ** -0.5), (("head",), (d, vp), d ** -0.5),
             (("final_norm", "w"), (d,), ONES)]
    for stack, n in (("dense_layers", z["n_dense"]), ("layers", z["n_moe"])):
        if not n:
            continue
        specs += [((stack, "ln1", "w"), (n, d), ONES), ((stack, "ln2", "w"), (n, d), ONES)]
        specs += _mla_specs((stack, "mla"), n, z)
    if z["n_dense"]:
        specs += _swiglu_specs(("dense_layers", "mlp"), (z["n_dense"],), d, z["f_dense"])
    n = z["n_moe"]
    specs.append((("layers", "moe", "router"), (n, d, z["n_routed"]), d ** -0.5))
    specs += _swiglu_specs(("layers", "moe"), (n, z["n_held"]), d, z["f_exp"])
    if z["n_shared"]:
        specs += _swiglu_specs(("layers", "moe", "shared"), (n,), d, z["n_shared"] * z["f_exp"])
    return sorted(specs)


def _draw(spec, seed: int, index: int, device) -> torch.Tensor:
    _, shape, scale = spec
    if scale == ONES:
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, _WEIGHTS, index))
    x = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(2 * scale).sub_(scale)


def make_leaf(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` of ``leaf_specs`` (float32), one generator a leaf."""
    return _draw(leaf_specs(cfg)[index], seed, index, device)


def make_weights(cfg: dict, seed: int, device) -> dict:
    return nest({spec[0]: _draw(spec, seed, i, device) for i, spec in enumerate(leaf_specs(cfg))})


def make_trackers(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """``{path: (u (m, r), s (r,), v (n, r), power_v (n,))}`` for every tracked
    leaf (the embedding and the head), float32, drawn as
    ``inputs.granite.make_trackers`` draws a dense decoder's."""
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
