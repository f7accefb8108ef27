"""RWKV-6 decoder-only model (attention-free), train and serve, in PyTorch.

Counterpart of ``repro.models.rwkv_model``.  Parameters are the reference's
nested dict: ``embed``, ``layers`` (``ln1``, ``ln2`` and the block's
``mix``, every leaf stacked on a leading ``n_layers`` axis), ``final_norm``
and ``head``.

Serving keeps the reference's signatures: ``rwkv_prefill(params, batch,
cfg)`` takes no ``max_len`` (the state is O(1) in the context), so
``serve.engine.generate``, which passes one, raises the reference's
``TypeError``; the family serves through ``prefill`` + ``decode_step``.  The
state is ``{tm_x, wkv, cm_x}`` stacked on ``n_layers``; a prefill builds its
zero states in the activations' dtype and ``rwkv_decode_step`` returns a new
state (nothing written in place) whose token shifts are in the activations'
dtype, whatever dtype the state it was given held, as the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.api.state import init_generator
from repro_torch.models import rwkv as rw
from repro_torch.models.layers import (
    as_dtype,
    cross_entropy,
    dot,
    embed_init,
    embed_lookup,
    norm_apply,
    norm_init,
    uniform_init,
)
from repro_torch.models.transformer import remat_wrap, scan_or_unroll

__all__ = [
    "rwkv_forward",
    "rwkv_model_init",
    "rwkv_train_loss",
    "rwkv_prefill",
    "rwkv_decode_step",
    "rwkv_state_spec",
]


def rwkv_model_init(gen: torch.Generator | None, cfg, *, device="cuda") -> dict:
    """Random parameters on ``device`` (the card by default; ``gen`` must draw
    there; ``gen=None`` with ``device="meta"`` builds shapes only) in the
    reference's layout and scales (not its bits: carry those over with
    ``convert.params_from_reference``)."""
    gen, dev = init_generator(gen, device)
    dtype = as_dtype(cfg.param_dtype)
    n = cfg.n_layers
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "layers": {"ln1": norm_init(cfg.d_model, cfg.norm_type, dtype, dev, (n,)),
                   "ln2": norm_init(cfg.d_model, cfg.norm_type, dtype, dev, (n,)),
                   "mix": rw.rwkv_init(gen, cfg, dtype, (n,), device=dev)},
        "final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype, dev),
        "head": uniform_init(gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dtype),
    }


def _logits(x, params, cfg):
    logits = dot(x, params["head"], cfg.compute_dtype)
    vmask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
    return torch.where(vmask, logits, -1e30)


def _run_layers(x, params, cfg, states=None):
    """``states``: stacked ``{tm_x, wkv, cm_x}`` or None (zeros in the
    activations' dtype, wkv float32).  Returns (x, the stacked new states)."""
    b = x.shape[0]
    if states is None:
        zero = rw.init_rwkv_state(b, cfg, x.dtype, device=x.device)
        states = {k: v.expand((cfg.n_layers,) + v.shape) for k, v in zero.items()}

    def body(h, xs):
        lp, st = xs["lp"], xs["st"]
        tm_in = norm_apply(h, lp["ln1"], cfg.norm_type)
        tm_out, (tm_x, wkv) = rw.rwkv_time_mix_train(tm_in, lp["mix"], cfg, st["tm_x"], st["wkv"])
        h = h + tm_out
        cm_in = norm_apply(h, lp["ln2"], cfg.norm_type)
        cm_out, cm_x = rw.rwkv_channel_mix_train(cm_in, lp["mix"], cfg, st["cm_x"])
        h = h + cm_out
        return h, {"tm_x": tm_x, "wkv": wkv, "cm_x": cm_x}

    if torch.is_grad_enabled():
        body = remat_wrap(body, cfg)
    return scan_or_unroll(body, x, {"lp": params["layers"], "st": states}, cfg)


def rwkv_forward(params, batch, cfg):
    """The full causal forward's logits (the reference's tests build it from
    ``_run_layers`` and ``_logits``)."""
    x = embed_lookup(batch["tokens"], params["embed"])
    x, _ = _run_layers(x, params, cfg)
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x, params, cfg)


def rwkv_train_loss(params, batch, cfg):
    return cross_entropy(rwkv_forward(params, batch, cfg), batch["labels"], cfg.vocab_size)


def rwkv_state_spec(cfg, batch, dtype):
    """``TensorSpec``s of the stacked state (wkv float32)."""
    from repro_torch.models.registry import TensorSpec

    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    h = d // hd
    L = cfg.n_layers
    dt = as_dtype(dtype)
    return {
        "tm_x": TensorSpec((L, batch, d), dt),
        "wkv": TensorSpec((L, batch, h, hd, hd), torch.float32),
        "cm_x": TensorSpec((L, batch, d), dt),
    }


def rwkv_prefill(params, batch, cfg):
    """Prompt pass; returns (last logits, per-layer states): O(1) state size,
    which is what makes the 500k-context decode shape viable."""
    x = embed_lookup(batch["tokens"], params["embed"])
    x, states = _run_layers(x, params, cfg)
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x[:, -1:, :], params, cfg), states


def rwkv_decode_step(params, states, token, pos, cfg):
    """One decode step; ``pos`` is ignored (a position-free architecture), so
    a step asks the host nothing.  Returns (logits, new stacked states)."""
    del pos
    x = embed_lookup(token, params["embed"])

    def body(h, xs):
        lp, st = xs["lp"], xs["st"]
        tm_in = norm_apply(h, lp["ln1"], cfg.norm_type)
        tm_out, st2 = rw.rwkv_decode_step(tm_in, lp["mix"], cfg, st)
        h = h + tm_out
        cm_in = norm_apply(h, lp["ln2"], cfg.norm_type)
        cm_out, cm_x = rw.rwkv_channel_mix_decode(cm_in, lp["mix"], cfg, st)
        h = h + cm_out
        return h, {"tm_x": st2["tm_x"], "wkv": st2["wkv"], "cm_x": cm_x}

    x, new_states = scan_or_unroll(body, x, {"lp": params["layers"], "st": states}, cfg)
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x, params, cfg), new_states
