"""Multi-head Latent Attention (DeepSeek-V2) with compressed KV cache, in
PyTorch.

Counterpart of ``repro.models.mla``: the V2-Lite variant (no q-LoRA; KV
compressed to ``kv_lora_rank`` + one shared RoPE key of
``qk_rope_head_dim``, cached after RoPE).  Scores are taken in the
compressed space: ``q_nope`` is absorbed through ``w_uk`` and the values stay
compressed until after the weighted sum, as the reference's einsums do it
(the reshapes ``(r, h, dn)`` and ``(r, h, dv)``, float32 products of
compute-dtype operands cast back to the activations' dtype).  Plain tensor
code through ``layers.bdot``.  ``MLAPortConfig.yarn`` applies DeepSeek-V2's
YaRN to the rope dimensions and its mscale to the softmax scale.
``mla_decode`` writes the new entry into the cache in place and returns it
(the cache passed in is consumed, as the reference's donated buffer).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    as_dtype,
    bdot,
    dot,
    rmsnorm,
    rope_apply,
    uniform_init,
    yarn_mscale,
)

__all__ = ["mla_init", "mla_train", "mla_prefill", "mla_decode", "init_mla_cache"]


def mla_init(gen, cfg, dtype, lead=()):
    """MLA weights; ``lead`` prepends axes (the stacked layers)."""
    lead = tuple(lead)
    d, h, m = cfg.d_model, cfg.n_heads, cfg.mla
    dn, dr, dv, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank
    s = (1.0 / d) ** 0.5
    return {
        "wq": uniform_init(gen, lead + (d, h * (dn + dr)), s, dtype),
        "w_dkv": uniform_init(gen, lead + (d, r + dr), s, dtype),
        "kv_norm": torch.ones(lead + (r,), dtype=as_dtype(dtype), device=gen.device),
        "w_uk": uniform_init(gen, lead + (r, h * dn), (1.0 / r) ** 0.5, dtype),
        "w_uv": uniform_init(gen, lead + (r, h * dv), (1.0 / r) ** 0.5, dtype),
        "wo": uniform_init(gen, lead + (h * dv, d), (1.0 / (h * dv)) ** 0.5, dtype),
    }


def _yarn(cfg):
    """The config's YaRN scaling (``MLAPortConfig.yarn``), or None."""
    return getattr(cfg.mla, "yarn", None)


def softmax_scale(cfg) -> float:
    """``(dn + dr)^-1/2``, times ``yarn_mscale(s, mscale_all_dim)^2`` under YaRN."""
    m = cfg.mla
    scale = 1.0 / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    yarn = _yarn(cfg)
    if yarn is not None and yarn.mscale_all_dim:
        scale *= yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2
    return scale


def _project(x, p, cfg, positions):
    """Per-head ``q_nope``, ``q_rope`` and the compressed ``c_kv``, ``k_rope``."""
    b, s, _ = x.shape
    h, m = cfg.n_heads, cfg.mla
    dn, r = m.qk_nope_head_dim, m.kv_lora_rank
    cd = cfg.compute_dtype
    q = dot(x, p["wq"], cd).reshape(b, s, h, -1).to(x.dtype)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    yarn = _yarn(cfg)
    q_rope = rope_apply(q_rope, positions, cfg.rope_theta, yarn)
    ckv_full = dot(x, p["w_dkv"], cd).to(x.dtype)
    c_kv = rmsnorm(ckv_full[..., :r], p["kv_norm"])
    k_rope = rope_apply(ckv_full[..., r:][:, :, None, :], positions, cfg.rope_theta,
                        yarn)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _per_head(a, w, r, h, cd, *, into_r):
    """``einsum("bqhd,rhd->bqhr")`` (``into_r``) or ``("bqhr,rhd->bqhd")``:
    ``a`` (b, q, h, .), ``w`` (r, h*.) -> float32 (b, q, h, .), one product a
    head."""
    b, sq = a.shape[:2]
    ah = a.permute(2, 0, 1, 3).reshape(h, b * sq, a.shape[-1])
    wh = w.reshape(r, h, -1).permute(1, 0, 2)                       # (h, r, .)
    out = bdot(ah, wh.mT if into_r else wh, cd)                      # (h, b*q, .)
    return out.reshape(h, b, sq, -1).permute(1, 2, 0, 3)


def _scores(q_abs, q_rope, c_kv, k_rope, cd, scale):
    """``(einsum("bqhr,bsr->bhqs") + einsum("bqhd,bsd->bhqs")) * scale``."""
    b, sq, h, _ = q_abs.shape
    qa = q_abs.permute(0, 2, 1, 3).reshape(b, h * sq, -1)
    qr = q_rope.permute(0, 2, 1, 3).reshape(b, h * sq, -1)
    s = bdot(qa, c_kv.mT, cd) + bdot(qr, k_rope.mT, cd)
    return (s * scale).reshape(b, h, sq, -1)


def _attend_compressed(q_nope, q_rope, c_kv, k_rope, p, cfg, valid, out_dtype):
    """The absorbed attention over ``c_kv``/``k_rope`` with the mask
    ``valid`` (broadcast over (b, h, q, s)); returns the output projection."""
    b, sq, h, dn = q_nope.shape
    m = cfg.mla
    r, dv = m.kv_lora_rank, m.v_head_dim
    cd = as_dtype(cfg.compute_dtype)
    q_abs = _per_head(q_nope, p["w_uk"], r, h, cd, into_r=True).to(out_dtype)
    scores = _scores(q_abs, q_rope, c_kv, k_rope, cd, softmax_scale(cfg))
    scores = torch.where(valid, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    # values also stay compressed until after the weighted sum
    ctx = bdot(w.to(cd).reshape(b, h * sq, -1), c_kv, cd).reshape(b, h, sq, r)
    ctx = ctx.permute(0, 2, 1, 3).to(out_dtype)                       # (b, q, h, r)
    o = _per_head(ctx, p["w_uv"], r, h, cd, into_r=False)            # (b, q, h, dv)
    o = o.reshape(b, sq, h * dv).to(out_dtype)
    return dot(o, p["wo"], cd).to(out_dtype)


def _absorbed_attention(q_nope, q_rope, c_kv, k_rope, p, cfg, q_offset=0):
    """Causal scores in compressed space: ``q_nope`` absorbed through ``w_uk``."""
    sq, sk = q_nope.shape[1], c_kv.shape[1]
    qpos = torch.arange(sq, device=q_nope.device) + q_offset
    valid = qpos[:, None] >= torch.arange(sk, device=q_nope.device)[None, :]
    return _attend_compressed(q_nope, q_rope, c_kv, k_rope, p, cfg, valid, q_nope.dtype)


def _attend(q_nope, q_rope, c_kv, k_rope, p, cfg, out_shape):
    """Absorbed attention, query-chunked when ``cfg.mla_q_chunk`` divides the
    sequence: the (h, sq, sk) scores shrink to (h, qc, sk) a chunk (the
    reference's ``lax.map`` as a loop)."""
    qc = cfg.mla_q_chunk
    sq = q_nope.shape[1]
    if qc and sq > qc and sq % qc == 0:
        outs = [_absorbed_attention(q_nope[:, i:i + qc], q_rope[:, i:i + qc], c_kv, k_rope,
                                    p, cfg, q_offset=i)
                for i in range(0, sq, qc)]
        return torch.cat(outs, dim=1).reshape(out_shape)
    return _absorbed_attention(q_nope, q_rope, c_kv, k_rope, p, cfg)


def mla_train(x, p, cfg, positions):
    q_nope, q_rope, c_kv, k_rope = _project(x, p, cfg, positions)
    return _attend(q_nope, q_rope, c_kv, k_rope, p, cfg, x.shape)


def init_mla_cache(batch, max_len, cfg, dtype, *, device="cuda"):
    m, dt = cfg.mla, as_dtype(dtype)
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dt, device=device)}


def mla_prefill(x, p, cfg, positions):
    q_nope, q_rope, c_kv, k_rope = _project(x, p, cfg, positions)
    out = _attend(q_nope, q_rope, c_kv, k_rope, p, cfg, x.shape)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(x, p, cfg, cache, pos):
    """One-token decode against the compressed cache, written in place at
    ``pos`` (the cache passed in is consumed); positions beyond ``pos`` are
    masked."""
    b = x.shape[0]
    q_nope, q_rope, c_kv_new, k_rope_new = _project(x, p, cfg, attn._positions(b, pos, x.device))
    c_kv = attn._write(cache["c_kv"], c_kv_new, pos)
    k_rope = attn._write(cache["k_rope"], k_rope_new, pos)
    valid = attn._decode_valid(c_kv.shape[1], pos, x.device)
    out = _attend_compressed(q_nope, q_rope, c_kv, k_rope, p, cfg, valid, x.dtype)
    return out, cache
