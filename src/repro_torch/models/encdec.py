"""Whisper-style encoder-decoder backbone, train and serve, in PyTorch.

Counterpart of ``repro.models.encdec``.  The conv/audio frontend is a stub,
as in the reference: ``input_specs`` feeds precomputed frame embeddings (b,
s_enc, d_model).  Positions are sinusoidal (parameter-free).  Decoder =
causal self-attention + cross-attention + GELU MLP (tanh approximation),
layernorm throughout.  Parameters are the reference's nested dict:
``embed``, ``enc_layers`` and ``dec_layers`` (every leaf stacked on a
leading ``n_layers`` axis), ``enc_norm``, ``final_norm`` and ``head``.

The frames keep their dtype: the encoder adds the sinusoid cast to it, so
under bf16 frames the memory and the cross K/V are bf16 while the decoder's
activations are the parameters' dtype, and the cross-attention promotes as
the reference's.

Serving: ``encdec_prefill(..., max_dec_len=)`` (the reference's keyword: no
``max_len``, so ``serve.engine.generate`` raises the reference's
``TypeError``) returns ``{"self": {k, v}, "cross": {k, v}}`` stacked on
``n_layers``, the self K/V zero-padded to ``max_dec_len`` (the prompt's own
length by default) and the cross K/V over the encoder's length with
``n_heads`` heads.  ``encdec_decode_step`` writes each layer's self entry
into that cache in place (clamped to its last slot past the end, as the
reference's dynamic update slice) and returns it: the cache passed in is
consumed, as the reference's donated buffer.
"""

from __future__ import annotations

import math

import torch

from repro_torch._tree import tree_map
from repro_torch.api.state import init_generator
from repro_torch.models import attention as attn
from repro_torch.models.attention import _sdpa  # shared scaled-dot-product core
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
    "encdec_cache_spec",
    "encdec_decode_step",
    "encdec_forward",
    "encdec_init",
    "encdec_prefill",
    "encdec_train_loss",
]


def _sinusoid(positions, d_model):
    """(..., d_model) float32: sin then cos of ``positions`` times the
    frequencies ``exp(-ln(10000) i / half)``."""
    half = d_model // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _xattn_init(gen, cfg, dtype, lead=()):
    lead = tuple(lead)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    s = (1.0 / d) ** 0.5
    return {
        "wq": uniform_init(gen, lead + (d, h * dh), s, dtype),
        "wk": uniform_init(gen, lead + (d, h * dh), s, dtype),
        "wv": uniform_init(gen, lead + (d, h * dh), s, dtype),
        "wo": uniform_init(gen, lead + (h * dh, d), (1.0 / (h * dh)) ** 0.5, dtype),
    }


def _enc_layer_init(gen, cfg, dtype, lead):
    dev = gen.device
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm_type, dtype, dev, lead),
        "attn": attn.attn_init(gen, cfg, dtype, lead),
        "ln2": norm_init(cfg.d_model, cfg.norm_type, dtype, dev, lead),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, lead),
    }


def _dec_layer_init(gen, cfg, dtype, lead):
    dev = gen.device
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm_type, dtype, dev, lead),
        "self": attn.attn_init(gen, cfg, dtype, lead),
        "ln_x": norm_init(cfg.d_model, cfg.norm_type, dtype, dev, lead),
        "cross": _xattn_init(gen, cfg, dtype, lead),
        "ln2": norm_init(cfg.d_model, cfg.norm_type, dtype, dev, lead),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, lead),
    }


def encdec_init(gen: torch.Generator | None, cfg, *, device="cuda") -> dict:
    """Random parameters on ``device`` (the card by default; ``gen`` must draw
    there; ``gen=None`` with ``device="meta"`` builds shapes only) in the
    reference's layout and scales (not its bits: carry those over with
    ``convert.params_from_reference``)."""
    gen, dev = init_generator(gen, device)
    dtype = as_dtype(cfg.param_dtype)
    lead = (cfg.n_layers,)
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "enc_layers": _enc_layer_init(gen, cfg, dtype, lead),
        "enc_norm": norm_init(cfg.d_model, cfg.norm_type, dtype, dev),
        "dec_layers": _dec_layer_init(gen, cfg, dtype, lead),
        "final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype, dev),
        "head": uniform_init(gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dtype),
    }


def _remat(body, cfg):
    """Checkpointing only where a backward will run (it changes no value)."""
    return remat_wrap(body, cfg) if torch.is_grad_enabled() else body


def _positions(b, s, device):
    pos = torch.arange(s, dtype=torch.int32, device=device)
    return pos, pos[None, :].expand(b, s)


def _encode(params, frames, cfg):
    b, s, _ = frames.shape
    pos, positions = _positions(b, s, frames.device)
    x = frames + _sinusoid(pos, cfg.d_model)[None].to(frames.dtype)

    def body(carry, lp):
        h = carry + attn.attn_train(norm_apply(carry, lp["ln1"], cfg.norm_type), lp["attn"], cfg,
                                    positions, causal=False)
        h = h + mlp_apply(norm_apply(h, lp["ln2"], cfg.norm_type), lp["mlp"], cfg.mlp_type,
                          cfg.compute_dtype)
        return h, None

    x, _ = scan_or_unroll(_remat(body, cfg), x, params["enc_layers"], cfg)
    return norm_apply(x, params["enc_norm"], cfg.norm_type)


def _cross_attn(x, memory_kv, lp, cfg):
    """x: (b, sq, d); memory_kv: precomputed {"k", "v"}: (b, s_enc, h, dh)."""
    b, sq, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    cd = cfg.compute_dtype
    q = dot(x, lp["wq"], cd).reshape(b, sq, h, dh).to(x.dtype)
    o = _sdpa(q, memory_kv["k"], memory_kv["v"], cfg, causal=False)
    return dot(o, lp["wo"], cd).to(x.dtype)


def _memory_kv(memory, lp, cfg):
    b, s, _ = memory.shape
    h, dh = cfg.n_heads, cfg.head_dim
    cd = cfg.compute_dtype
    k = dot(memory, lp["wk"], cd).reshape(b, s, h, dh).to(memory.dtype)
    v = dot(memory, lp["wv"], cd).reshape(b, s, h, dh).to(memory.dtype)
    return {"k": k, "v": v}


def _mlp(h, lp, cfg):
    return mlp_apply(norm_apply(h, lp["ln2"], cfg.norm_type), lp["mlp"], cfg.mlp_type,
                     cfg.compute_dtype)


def _dec_layer_train(x, memory, lp, cfg, positions):
    h = x + attn.attn_train(norm_apply(x, lp["ln1"], cfg.norm_type), lp["self"], cfg, positions)
    mkv = _memory_kv(memory, lp["cross"], cfg)
    h = h + _cross_attn(norm_apply(h, lp["ln_x"], cfg.norm_type), mkv, lp["cross"], cfg)
    return h + _mlp(h, lp, cfg)


def _logits(x, params, cfg):
    logits = dot(x, params["head"], cfg.compute_dtype)
    vmask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
    return torch.where(vmask, logits, -1e30)


def _embed_tokens(params, tokens, cfg):
    b, s = tokens.shape
    pos, positions = _positions(b, s, tokens.device)
    x = embed_lookup(tokens, params["embed"])
    return x + _sinusoid(pos, cfg.d_model)[None].to(x.dtype), positions


def encdec_forward(params, batch, cfg):
    memory = _encode(params, batch["frames"], cfg)
    x, positions = _embed_tokens(params, batch["tokens"], cfg)

    def body(carry, lp):
        return _dec_layer_train(carry, memory, lp, cfg, positions), None

    x, _ = scan_or_unroll(_remat(body, cfg), x, params["dec_layers"], cfg)
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x, params, cfg)


def encdec_train_loss(params, batch, cfg):
    return cross_entropy(encdec_forward(params, batch, cfg), batch["labels"], cfg.vocab_size)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def encdec_cache_spec(cfg, batch, enc_len, max_dec_len, dtype):
    """``TensorSpec``s of the decode cache: the self K/V with ``n_kv_heads``,
    the cross K/V with ``n_heads`` (stacked on ``n_layers``)."""
    from repro_torch.models.registry import TensorSpec

    L, h, dh, kvh = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    dt = as_dtype(dtype)
    self_kv = TensorSpec((L, batch, max_dec_len, kvh, dh), dt)
    cross_kv = TensorSpec((L, batch, enc_len, h, dh), dt)
    return {"self": {"k": self_kv, "v": self_kv}, "cross": {"k": cross_kv, "v": cross_kv}}


def encdec_prefill(params, batch, cfg, *, max_dec_len=None):
    """Encode frames + prefill the decoder prompt; returns (last logits,
    caches), the self K/V zero-padded to ``max_dec_len``."""
    memory = _encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    max_dec_len = max_dec_len or tokens.shape[1]
    x, positions = _embed_tokens(params, tokens, cfg)
    lead = (cfg.n_layers,)
    self_st = cross_st = None
    for i, lp in enumerate(_unbind_tree(params["dec_layers"], cfg.n_layers)):
        a, self_kv = attn.attn_prefill(norm_apply(x, lp["ln1"], cfg.norm_type), lp["self"], cfg,
                                       positions)
        h = x + a
        mkv = _memory_kv(memory, lp["cross"], cfg)
        h = h + _cross_attn(norm_apply(h, lp["ln_x"], cfg.norm_type), mkv, lp["cross"], cfg)
        x = h + _mlp(h, lp, cfg)
        self_st = _into_stacked(self_st, i, lead, self_kv, max_dec_len)
        cross_st = _into_stacked(cross_st, i, lead, mkv)
        del self_kv, mkv
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x[:, -1:, :], params, cfg), {"self": self_st, "cross": cross_st}


def _decode_position(pos, device):
    """(1,) int32 of a Python or tensor ``pos`` (a tensor stays on its
    device: no host wait)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), pos, dtype=torch.int32, device=device)


def encdec_decode_step(params, cache, token, pos, cfg):
    """One decode step: ``token`` (b, 1) int32 at ``pos`` (a Python int or a
    0-dim tensor).  The self cache is written in place and ``cache``
    returned; the cross cache is read."""
    x = embed_lookup(token, params["embed"])
    x = x + _sinusoid(_decode_position(pos, x.device), cfg.d_model)[None].to(x.dtype)
    for i, lp in enumerate(_unbind_tree(params["dec_layers"], cfg.n_layers)):
        self_kv = tree_map(lambda c, i=i: c[i], cache["self"])  # views: the writes land in cache
        cross_kv = tree_map(lambda c, i=i: c[i], cache["cross"])
        a, _ = attn.attn_decode(norm_apply(x, lp["ln1"], cfg.norm_type), lp["self"], cfg,
                                self_kv, pos)
        h = x + a
        h = h + _cross_attn(norm_apply(h, lp["ln_x"], cfg.norm_type), cross_kv, lp["cross"], cfg)
        x = h + _mlp(h, lp, cfg)
    x = norm_apply(x, params["final_norm"], cfg.norm_type)
    return _logits(x, params, cfg), cache
