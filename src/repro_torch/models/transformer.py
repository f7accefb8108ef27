"""Decoder-only transformer (dense / MoE / MLA variants), train and serve,
in PyTorch.

Counterpart of ``repro.models.transformer``.  Parameters are the reference's
nested dict: ``embed``, ``layers`` (every leaf stacked on a leading
``n_layers`` axis), ``final_norm`` and, untied, ``head``; checkpoints, the
converters and spectral-Adam's eligibility (2-D leaves only) depend on that
layout.  A layer holds ``attn`` or ``mla``, and ``mlp`` or ``moe``.  An MoE
config with ``MoEPortConfig.first_dense`` k > 0 (not in the reference) adds
``dense_layers``, the first k layers stacked on their own axis with an
``mlp`` of ``d_ff``; ``layers`` then holds the other ``n_layers - k``.
Training runs the two stacks in turn, and serving takes them as one stack
of ``n_layers`` (the cache's leading axis).

Spans (``obs.blocks.traced_block``, while tracing is on): ``mla``, ``moe``
and, for an MoE decoder's leading dense layers, ``dense_mlp``, over each
block's forward, remat recompute and backward.

The layer loop unbinds each stacked leaf once per forward
(``torch.unbind``): its backward is one ``stack`` of the layers' gradients,
where indexing ``W[l]`` per layer would build a zero tensor of the full
stacked size for every layer.  Remat: ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant); policy ``"dots"`` saves the
outputs of the 2-D matrix products (the reference's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest.  Neither
changes a value; prefill runs without it when grad is disabled.

Serving: ``decoder_prefill`` returns the stacked cache (leading
``n_layers`` axis) padded to ``max_len``, in the activations' dtype as the
reference's; ``decoder_decode_step`` writes each layer's new entry into that
stacked cache in place and returns it (the cache passed in is consumed, as
the reference's donated buffer).
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch._tree import tree_map
from repro_torch.api.state import init_generator
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
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
from repro_torch.obs.blocks import traced_block

__all__ = [
    "decode_cache_spec",
    "decoder_decode_step",
    "decoder_forward",
    "decoder_init",
    "decoder_prefill",
    "decoder_train_loss",
    "remat_wrap",
    "scan_or_unroll",
]

# the 2-D products the "dots" policy saves (mm with and without out_dtype)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.mm.dtype}


def _use_mla(cfg) -> bool:
    return cfg.mla is not None


def _use_moe(cfg) -> bool:
    return cfg.moe is not None


def _unbind_tree(stacked, n: int) -> list:
    """One dict per layer from a dict of stacked leaves (one ``unbind`` a leaf)."""
    if isinstance(stacked, dict):
        parts = {k: _unbind_tree(v, n) for k, v in stacked.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(torch.unbind(stacked, 0))


def scan_or_unroll(body, carry, stacked, cfg=None, *, length=None):
    """``body(carry, slice) -> (carry, y)`` over the leading axis of
    ``stacked`` (a dict of stacked leaves, or None with ``length``); the ``y``
    come back stacked (or None).  The reference's ``lax.scan`` and its
    unrolled form are the same loop here."""
    if stacked is None:
        slices = [None] * length
    else:
        n = length if length is not None else _first_leaf(stacked).shape[0]
        slices = _unbind_tree(stacked, n)
    ys = []
    for sl in slices:
        carry, y = body(carry, sl)
        ys.append(y)
    if ys and ys[0] is not None:
        return carry, _stack_ys(ys)
    return carry, None


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _stack_ys(ys):
    if isinstance(ys[0], dict):
        return {k: _stack_ys([y[k] for y in ys]) for k in ys[0]}
    return torch.stack(ys)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(body, cfg):
    """Activation checkpointing of ``body`` by ``cfg.remat_policy``: "full"
    recomputes everything in the backward, "dots" saves the 2-D products'
    outputs and recomputes the rest."""
    if not cfg.remat:
        return body
    if cfg.remat_policy == "dots":
        ctx_fn = partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda carry, xs: checkpoint(body, carry, xs, use_reentrant=False,
                                            context_fn=ctx_fn)
    return lambda carry, xs: checkpoint(body, carry, xs, use_reentrant=False)


def _first_dense(cfg) -> int:
    """Leading dense layers of an MoE decoder (``MoEPortConfig.first_dense``)."""
    return getattr(cfg.moe, "first_dense", 0) if _use_moe(cfg) else 0


def _layer_init(gen, cfg, dtype, n, *, dense=False):
    lead = (n,)
    p = {"ln1": norm_init(cfg.d_model, cfg.norm_type, dtype, gen.device, lead),
         "ln2": norm_init(cfg.d_model, cfg.norm_type, dtype, gen.device, lead)}
    if _use_mla(cfg):
        p["mla"] = mla_mod.mla_init(gen, cfg, dtype, lead)
    else:
        p["attn"] = attn.attn_init(gen, cfg, dtype, lead)
    if _use_moe(cfg) and not dense:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, lead)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, lead)
    return p


def _stacks(params) -> list:
    """The stacked layer groups in depth order: the leading dense layers
    (``dense_layers``, when the config has them), then ``layers``."""
    return [params[k] for k in ("dense_layers", "layers") if k in params]


def _all_layers(params, cfg) -> list:
    """One dict per layer, in depth order (one ``unbind`` a stacked leaf)."""
    k = _first_dense(cfg)
    out = _unbind_tree(params["dense_layers"], k) if k else []
    return out + _unbind_tree(params["layers"], cfg.n_layers - k)


def decoder_init(gen: torch.Generator | None, cfg, *, device="cuda") -> dict:
    """Random parameters on ``device`` (the card by default; ``gen`` must draw
    there; ``gen=None`` with ``device="meta"`` builds shapes only), in the
    reference's layout and scales.  ``torch.Generator`` draws, so not the
    reference's bits: carry those over with ``convert.params_from_reference``."""
    gen, _ = init_generator(gen, device)
    dtype = as_dtype(cfg.param_dtype)
    k = _first_dense(cfg)
    params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)}
    if k:
        params["dense_layers"] = _layer_init(gen, cfg, dtype, k, dense=True)
    params["layers"] = _layer_init(gen, cfg, dtype, cfg.n_layers - k)
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm_type, dtype, gen.device)
    if not cfg.tie_embeddings:
        params["head"] = uniform_init(gen, (cfg.d_model, cfg.padded_vocab),
                                      cfg.d_model ** -0.5, dtype)
    return params


def _mixer_train(x, lp, cfg, positions):
    if _use_mla(cfg):
        return traced_block("mla", mla_mod.mla_train, x, lp["mla"], cfg, positions)
    return attn.attn_train(x, lp["attn"], cfg, positions)


def _ffn(x, lp, cfg):
    """The layer's MoE or MLP (spans ``moe``, or ``dense_mlp`` for an MoE
    decoder's leading dense layers): ``(out, balance loss)``, the loss 0.0
    but for an MoE layer (``moe_apply``)."""
    if "moe" in lp:
        return traced_block("moe", moe_mod.moe_apply, x, lp["moe"], cfg)
    if _use_moe(cfg):
        return traced_block("dense_mlp", mlp_apply, x, lp["mlp"], cfg.mlp_type,
                            cfg.compute_dtype), 0.0
    return mlp_apply(x, lp["mlp"], cfg.mlp_type, cfg.compute_dtype), 0.0


def _layer_train(x, lp, cfg, positions):
    """``(layer output, the layer's balance loss)``."""
    h = x + _mixer_train(norm_apply(x, lp["ln1"], cfg.norm_type), lp, cfg, positions)
    out, aux = _ffn(norm_apply(h, lp["ln2"], cfg.norm_type), lp, cfg)
    return h + out, aux


def _logits(x, params, cfg):
    w = params["embed"]["table"].mT if cfg.tie_embeddings else params["head"]
    logits = dot(x, w, cfg.compute_dtype)
    vmask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
    return torch.where(vmask, logits, -1e30)


def _embed_inputs(params, batch, cfg):
    """Tokens (+ optional VLM patch embeddings prepended)."""
    x = embed_lookup(batch["tokens"], params["embed"])
    if cfg.frontend == "vision" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def _forward(params, batch, cfg):
    """``(logits, balance loss summed over the layers)``."""
    x = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)

    def body(carry, lp):
        y, aux = _layer_train(carry[0], lp, cfg, positions)
        return (y, carry[1] + aux), None

    carry = (x, 0.0)
    for stack in _stacks(params):
        carry, _ = scan_or_unroll(remat_wrap(body, cfg), carry, stack, cfg)
    x, aux = carry
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x, params, cfg), aux


def decoder_forward(params, batch, cfg):
    return _forward(params, batch, cfg)[0]


def decoder_train_loss(params, batch, cfg):
    """Mean token cross entropy, plus the MoE layers' sequence-wise balance
    losses where the config sets ``MoEPortConfig.seq_aux_alpha``."""
    logits, aux = _forward(params, batch, cfg)
    labels = batch["labels"]
    if cfg.frontend == "vision" and "patches" in batch:
        logits = logits[:, -labels.shape[1]:, :]  # loss on the token stream only
    return cross_entropy(logits, labels, cfg.vocab_size) + aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def decode_cache_spec(cfg, batch, max_len, dtype):
    """``TensorSpec``s of the stacked decode cache (leading ``n_layers``)."""
    from repro_torch.models.registry import TensorSpec

    dt = as_dtype(dtype)
    lead = (cfg.n_layers, batch, max_len)
    if _use_mla(cfg):
        return {"c_kv": TensorSpec(lead + (cfg.mla.kv_lora_rank,), dt),
                "k_rope": TensorSpec(lead + (cfg.mla.qk_rope_head_dim,), dt)}
    kv = lead + (cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": TensorSpec(kv, torch.int8), "v": TensorSpec(kv, torch.int8),
                "k_scale": TensorSpec(lead + (cfg.n_kv_heads,), torch.float32),
                "v_scale": TensorSpec(lead + (cfg.n_kv_heads,), torch.float32)}
    return {"k": TensorSpec(kv, dt), "v": TensorSpec(kv, dt)}


def _into_stacked(stacked, i, lead, cache, max_len=None):
    """Write a prefill cache (leaves ``(b, s, ...)``) at index ``i`` of stacked
    buffers ``lead + (b, max_len, ...)`` zero-padded along the sequence (made
    on the first call; ``max_len`` None keeps ``s``): the reference's pad and
    scan stacking without the copies."""
    if stacked is None:
        stacked = {k: torch.zeros(tuple(lead) + (v.shape[0], max_len or v.shape[1])
                                  + tuple(v.shape[2:]), dtype=v.dtype, device=v.device)
                   for k, v in cache.items()}
    for k, v in cache.items():
        stacked[k][i][:, :v.shape[1]] = v
    return stacked


def decoder_prefill(params, batch, cfg, *, max_len=None):
    """Returns (last-position logits, stacked cache padded to ``max_len``)."""
    x = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    max_len = max_len or s
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)

    def body(x_in, lp):
        h_norm = norm_apply(x_in, lp["ln1"], cfg.norm_type)
        if _use_mla(cfg):
            h, cache = mla_mod.mla_prefill(h_norm, lp["mla"], cfg, positions)
        else:
            h, cache = attn.attn_prefill(h_norm, lp["attn"], cfg, positions)
        h = x_in + h
        return h + _ffn(norm_apply(h, lp["ln2"], cfg.norm_type), lp, cfg)[0], cache

    if torch.is_grad_enabled():
        body = remat_wrap(body, cfg)
    stacked = None
    for i, lp in enumerate(_all_layers(params, cfg)):
        x, cache = body(x, lp)
        stacked = _into_stacked(stacked, i, (cfg.n_layers,), cache, max_len)
        del cache
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x[:, -1:, :], params, cfg), stacked


def decoder_decode_step(params, cache, token, pos, cfg):
    """One decode step.  ``token`` (b, 1) int32; ``cache`` stacked over
    layers, written in place at ``pos`` (a Python int, or a 0-dim tensor) and
    returned."""
    x = embed_lookup(token, params["embed"])
    for i, lp in enumerate(_all_layers(params, cfg)):
        cache_l = tree_map(lambda c, i=i: c[i], cache)  # views: the writes land in ``cache``
        h_norm = norm_apply(x, lp["ln1"], cfg.norm_type)
        if _use_mla(cfg):
            h, _ = mla_mod.mla_decode(h_norm, lp["mla"], cfg, cache_l, pos)
        else:
            h, _ = attn.attn_decode(h_norm, lp["attn"], cfg, cache_l, pos)
        h = x + h
        x = h + _ffn(norm_apply(h, lp["ln2"], cfg.norm_type), lp, cfg)[0]
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x, params, cfg), cache
