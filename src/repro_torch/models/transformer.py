"""Decoder-only transformer (dense), the train path, in PyTorch.

Counterpart of ``repro.models.transformer``'s ``decoder_init``,
``decoder_forward``, ``decoder_train_loss``, ``scan_or_unroll`` and
``remat_wrap``.  Parameters are the reference's nested dict: ``embed``,
``layers`` (every leaf stacked on a leading ``n_layers`` axis), ``final_norm``
and, untied, ``head``; checkpoints, the converters and spectral-Adam's
eligibility (2-D leaves only) depend on that layout.

The layer loop unbinds each stacked leaf once per forward
(``torch.unbind``): its backward is one ``stack`` of the layers' gradients,
where indexing ``W[l]`` per layer would build a zero tensor of the full
stacked size for every layer.  Remat: ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant); policy ``"dots"`` saves the
outputs of the 2-D matrix products (the reference's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest.  Neither
changes a value.  MoE and MLA blocks, prefill and decode wait for ROADMAP A9.
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
from repro_torch.api.state import generator_device
from repro_torch.models import attention as attn
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

__all__ = [
    "decoder_forward",
    "decoder_init",
    "decoder_train_loss",
    "remat_wrap",
    "scan_or_unroll",
]

_NOT_PORTED = "not ported yet: MoE and MLA decoder blocks wait for ROADMAP A9"

# the 2-D products the "dots" policy saves (mm with and without out_dtype)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.mm.dtype}


def _check_dense(cfg) -> None:
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED}")


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


def _layer_init(gen, cfg, dtype, n):
    lead = (n,)
    dev = gen.device
    stacked_norm = lambda: tree_map(  # noqa: E731
        lambda x: x.expand(lead + x.shape).contiguous(),
        norm_init(cfg.d_model, cfg.norm_type, dtype, dev))
    return {"ln1": stacked_norm(), "ln2": stacked_norm(),
            "attn": attn.attn_init(gen, cfg, dtype, lead),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, lead)}


def decoder_init(gen: torch.Generator, cfg, *, device="cuda") -> dict:
    """Random parameters on ``device`` (the card by default; ``gen`` must draw
    there), in the reference's layout and scales.  ``torch.Generator`` draws,
    so not the reference's bits: carry those over with
    ``convert.params_from_reference``."""
    _check_dense(cfg)
    generator_device(gen, device)
    dtype = as_dtype(cfg.param_dtype)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "layers": _layer_init(gen, cfg, dtype, cfg.n_layers),
        "final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = uniform_init(gen, (cfg.d_model, cfg.padded_vocab),
                                      cfg.d_model ** -0.5, dtype)
    return params


def _layer_train(x, lp, cfg, positions):
    h = x + attn.attn_train(norm_apply(x, lp["ln1"], cfg.norm_type), lp["attn"], cfg, positions)
    return h + mlp_apply(norm_apply(h, lp["ln2"], cfg.norm_type), lp["mlp"], cfg.mlp_type,
                         cfg.compute_dtype)


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


def decoder_forward(params, batch, cfg):
    _check_dense(cfg)
    x = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)

    def body(carry, lp):
        return _layer_train(carry, lp, cfg, positions), None

    x, _ = scan_or_unroll(remat_wrap(body, cfg), x, params["layers"], cfg)
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x, params, cfg)


def decoder_train_loss(params, batch, cfg):
    logits = decoder_forward(params, batch, cfg)
    labels = batch["labels"]
    if cfg.frontend == "vision" and "patches" in batch:
        logits = logits[:, -labels.shape[1]:, :]  # loss on the token stream only
    return cross_entropy(logits, labels, cfg.vocab_size)
