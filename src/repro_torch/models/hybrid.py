"""Zamba2-style hybrid: Mamba2 backbone with a weight-shared attention block,
in PyTorch.

Counterpart of ``repro.models.hybrid``: ``n_layers`` Mamba2 layers and one
*shared* transformer block (attention + MLP, a single weight copy) applied
after every ``attn_every`` of them.  The layout is the reference's: the
Mamba layers stacked as ``groups`` ``(n_groups, k, ...)`` and a stacked
``tail`` of ``n_layers % k`` layers; the shared block's weights are one copy,
applied ``n_groups`` times, each application with its own KV cache
(``attn_kv`` stacked on ``n_groups``).  Like the reference, the shared block
acts on the residual stream directly (no embedding concat, no
per-application LoRA).

Serving state: ``{"groups": {"conv", "ssm"} (n_groups, k, ...),
"attn_kv": {"k", "v"} (n_groups, ...), "tail": ...}``.  ``hybrid_prefill``
reads the exact terminal SSM states off the chunked recurrence;
``hybrid_decode_step`` writes every layer's state and every application's
KV entry into that tree in place and returns it (the state passed in is
consumed, as the reference's donated buffer).
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.api.state import init_generator
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    as_dtype,
    cross_entropy,
    dot,
    embed_init,
    embed_lookup,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
    uniform_init,
)
from repro_torch.models.transformer import _into_stacked, _unbind_tree, remat_wrap, scan_or_unroll

__all__ = [
    "hybrid_decode_step",
    "hybrid_forward",
    "hybrid_init",
    "hybrid_layout",
    "hybrid_prefill",
    "hybrid_state_spec",
    "hybrid_train_loss",
]


def hybrid_layout(cfg):
    k = cfg.attn_every
    n_groups = cfg.n_layers // k
    return n_groups, k, cfg.n_layers - n_groups * k


def _mamba_layers_init(gen, cfg, dtype, lead):
    return {"ln": norm_init(cfg.d_model, cfg.norm_type, dtype, gen.device, lead),
            "ssm": ssm_mod.ssm_init(gen, cfg, dtype, lead)}


def hybrid_init(gen: torch.Generator | None, cfg, *, device="cuda") -> dict:
    """Random parameters on ``device`` (the card by default; ``gen`` must draw
    there; ``gen=None`` with ``device="meta"`` builds shapes only) in the
    reference's layout and scales (not its bits: carry those over with
    ``convert.params_from_reference``)."""
    gen, _ = init_generator(gen, device)
    dtype = as_dtype(cfg.param_dtype)
    n_groups, k, tail = hybrid_layout(cfg)
    dev = gen.device
    params = {
        "groups": _mamba_layers_init(gen, cfg, dtype, (n_groups, k)),
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "shared": {
            "ln1": norm_init(cfg.d_model, cfg.norm_type, dtype, dev),
            "attn": attn.attn_init(gen, cfg, dtype),
            "ln2": norm_init(cfg.d_model, cfg.norm_type, dtype, dev),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype),
        },
        "final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype, dev),
        "head": uniform_init(gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dtype),
    }
    if tail:
        params["tail"] = _mamba_layers_init(gen, cfg, dtype, (tail,))
    return params


def _shared_block_train(x, sp, cfg, positions):
    h = x + attn.attn_train(norm_apply(x, sp["ln1"], cfg.norm_type), sp["attn"], cfg, positions)
    return h + mlp_apply(norm_apply(h, sp["ln2"], cfg.norm_type), sp["mlp"], cfg.mlp_type,
                         cfg.compute_dtype)


def _mamba_train(x, lp, cfg):
    return x + ssm_mod.ssm_train(norm_apply(x, lp["ln"], cfg.norm_type), lp["ssm"], cfg)


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def _head_logits(x, params, cfg):
    logits = dot(norm_apply(x, params["final_norm"], cfg.norm_type), params["head"],
                 cfg.compute_dtype)
    vmask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
    return torch.where(vmask, logits, -1e30)


def hybrid_forward(params, batch, cfg):
    x = embed_lookup(batch["tokens"], params["embed"])
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    shared = params["shared"]

    def mamba_body(c, lp):
        return _mamba_train(c, lp, cfg), None

    def group_body(carry, gp):
        h, _ = scan_or_unroll(mamba_body, carry, gp, cfg)
        return _shared_block_train(h, shared, cfg, positions), None

    x, _ = scan_or_unroll(remat_wrap(group_body, cfg), x, params["groups"], cfg)
    if "tail" in params:
        x, _ = scan_or_unroll(mamba_body, x, params["tail"], cfg)
    return _head_logits(x, params, cfg)


def hybrid_train_loss(params, batch, cfg):
    return cross_entropy(hybrid_forward(params, batch, cfg), batch["labels"], cfg.vocab_size)


# ---------------------------------------------------------------------------
# Serving: per-layer SSM states + per-application shared-attention KV
# ---------------------------------------------------------------------------


def hybrid_state_spec(cfg, batch, max_len, dtype):
    """``TensorSpec``s of the serving state (the SSM states float32)."""
    from repro_torch.models.registry import TensorSpec

    n_groups, k, tail = hybrid_layout(cfg)
    _, n_heads, conv_dim = ssm_mod.ssm_dims(cfg)
    s, dt = cfg.ssm, as_dtype(dtype)

    def one(lead):
        return {"conv": TensorSpec(lead + (batch, s.conv_width - 1, conv_dim), dt),
                "ssm": TensorSpec(lead + (batch, n_heads, s.d_state, s.head_dim),
                                  torch.float32)}

    kv = TensorSpec((n_groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim), dt)
    spec = {"groups": one((n_groups, k)), "attn_kv": {"k": kv, "v": kv}}
    if tail:
        spec["tail"] = one((tail,))
    return spec


def _mamba_prefill(x, lp, cfg):
    """Training-mode ssm over the prompt + the exact terminal decode state
    (read off the chunked recurrence, no per-token replay)."""
    out, state = ssm_mod.ssm_train(norm_apply(x, lp["ln"], cfg.norm_type), lp["ssm"], cfg,
                                   return_final_state=True)
    return x + out, state


def hybrid_prefill(params, batch, cfg, *, max_len=None):
    """Prompt prefill: (last-position logits, serving state with the KV caches
    zero-padded to ``max_len``)."""
    x = embed_lookup(batch["tokens"], params["embed"])
    b, s, _ = x.shape
    max_len = max_len or s
    positions = _positions(b, s, x.device)
    shared = params["shared"]
    n_groups, k, tail = hybrid_layout(cfg)
    g_states = kvs = t_states = None
    for gi, gp in enumerate(_unbind_tree(params["groups"], n_groups)):
        for li, lp in enumerate(_unbind_tree(gp, k)):
            x, st = _mamba_prefill(x, lp, cfg)
            g_states = _into_stacked(g_states, (gi, li), (n_groups, k), st)
        a_out, kv = attn.attn_prefill(norm_apply(x, shared["ln1"], cfg.norm_type),
                                      shared["attn"], cfg, positions)
        kvs = _into_stacked(kvs, gi, (n_groups,), kv, max_len)
        x = x + a_out
        x = x + mlp_apply(norm_apply(x, shared["ln2"], cfg.norm_type), shared["mlp"],
                          cfg.mlp_type, cfg.compute_dtype)
    state = {"groups": g_states, "attn_kv": kvs}
    if tail:
        for li, lp in enumerate(_unbind_tree(params["tail"], tail)):
            x, st = _mamba_prefill(x, lp, cfg)
            t_states = _into_stacked(t_states, li, (tail,), st)
        state["tail"] = t_states
    return _head_logits(x[:, -1:, :], params, cfg), state


def _promote_conv(states, dtype):
    """The reference's decode returns a conv buffer promoted to the
    activations' dtype; an in-place state takes that dtype once, up front."""
    if states["conv"].dtype != torch.promote_types(states["conv"].dtype, dtype):
        states["conv"] = states["conv"].to(dtype)


def _mamba_decode(x, lp, st, cfg):
    out, _ = ssm_mod.ssm_decode(norm_apply(x, lp["ln"], cfg.norm_type), lp["ssm"], cfg, st)
    return x + out


def hybrid_decode_step(params, state, token, pos, cfg):
    """One decode step; ``state`` is written in place at ``pos`` and returned."""
    x = embed_lookup(token, params["embed"])
    shared = params["shared"]
    n_groups, k, tail = hybrid_layout(cfg)
    for part in ("groups", "tail"):
        if part in state:
            _promote_conv(state[part], x.dtype)
    for gi, gp in enumerate(_unbind_tree(params["groups"], n_groups)):
        for li, lp in enumerate(_unbind_tree(gp, k)):
            x = _mamba_decode(x, lp, tree_map(lambda v: v[gi, li], state["groups"]), cfg)
        kv = tree_map(lambda v: v[gi], state["attn_kv"])
        a_out, _ = attn.attn_decode(norm_apply(x, shared["ln1"], cfg.norm_type),
                                    shared["attn"], cfg, kv, pos)
        x = x + a_out
        x = x + mlp_apply(norm_apply(x, shared["ln2"], cfg.norm_type), shared["mlp"],
                          cfg.mlp_type, cfg.compute_dtype)
    if tail:
        for li, lp in enumerate(_unbind_tree(params["tail"], tail)):
            x = _mamba_decode(x, lp, tree_map(lambda v: v[li], state["tail"]), cfg)
    return _head_logits(x, params, cfg), state
