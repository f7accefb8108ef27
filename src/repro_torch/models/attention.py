"""GQA/MQA/MHA attention, the train path, in PyTorch.

Counterpart of ``repro.models.attention``'s ``attn_init``, ``_qkv``,
``_sdpa_full``, ``_sdpa_blockwise``, ``_sdpa``, ``_maybe_rope`` and
``attn_train``.  Plain tensor code that follows the reference's einsums:
float32 scores from compute-dtype operands (``layers.bdot``), the ``-1e30``
causal mask, and the blockwise form's online softmax over KV blocks.  It
does not call ``scaled_dot_product_attention``: the reference computes
attention outside any kernel, so its numerics are the ones held here.  The
KV cache, prefill and decode wait for ROADMAP A9 (``serve/engine.py``).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import as_dtype, bdot, dot, rope_apply, uniform_init

__all__ = ["attn_init", "attn_train"]


def attn_init(gen, cfg, dtype, lead=()):
    """Attention weights; ``lead`` prepends axes (the stacked layers)."""
    lead = tuple(lead)
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = (1.0 / d) ** 0.5
    p = {
        "wq": uniform_init(gen, lead + (d, h * dh), s, dtype),
        "wk": uniform_init(gen, lead + (d, kvh * dh), s, dtype),
        "wv": uniform_init(gen, lead + (d, kvh * dh), s, dtype),
        "wo": uniform_init(gen, lead + (h * dh, d), (1.0 / (h * dh)) ** 0.5, dtype),
    }
    if cfg.qkv_bias:
        dt, dev = as_dtype(dtype), gen.device
        p["bq"] = torch.zeros(lead + (h * dh,), dtype=dt, device=dev)
        p["bk"] = torch.zeros(lead + (kvh * dh,), dtype=dt, device=dev)
        p["bv"] = torch.zeros(lead + (kvh * dh,), dtype=dt, device=dev)
    return p


def _qkv(x, p, cfg):
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.compute_dtype
    q = dot(x, p["wq"], cd)
    k = dot(x, p["wk"], cd)
    v = dot(x, p["wv"], cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(b, s, h, dh).to(x.dtype)
    k = k.reshape(b, s, kvh, dh).to(x.dtype)
    v = v.reshape(b, s, kvh, dh).to(x.dtype)
    return q, k, v


def _group_q(q, kvh):
    """(b, sq, h, dh) -> (b*kvh, rep*sq, dh): the "bkrq" rows of a group."""
    b, sq, h, dh = q.shape
    rep = h // kvh
    return q.reshape(b, sq, kvh, rep, dh).permute(0, 2, 3, 1, 4).reshape(b * kvh, rep * sq, dh)


def _kv_rows(k):
    """(b, sk, kvh, dh) -> (b*kvh, sk, dh)."""
    b, sk, kvh, dh = k.shape
    return k.permute(0, 2, 1, 3).reshape(b * kvh, sk, dh)


def _ungroup(out, b, kvh, rep, sq, dh):
    """(b*kvh, rep*sq, dh) ("bkrqd") -> (b, sq, h*dh) ("bqkrd")."""
    out = out.reshape(b, kvh, rep, sq, dh).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, kvh * rep * dh)


def _causal(sq, sk, q_offset, k_offset, device):
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device) + k_offset
    return qpos[:, None] >= kpos[None, :]


def _sdpa_full(q, k, v, cfg, causal, q_offset=0):
    """Vanilla attention: materialises the (sq, sk) score tensor."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    cd = cfg.compute_dtype
    scores = bdot(_group_q(q, kvh), _kv_rows(k).mT, cd) / (dh ** 0.5)  # (b*kvh, rep*sq, sk)
    scores = scores.reshape(b * kvh, rep, sq, sk)
    if causal:
        mask = _causal(sq, sk, q_offset, 0, q.device)
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = bdot(w.to(as_dtype(cd)).reshape(b * kvh, rep * sq, sk), _kv_rows(v), cd)
    return _ungroup(out, b, kvh, rep, sq, dh).to(q.dtype)


def _sdpa_blockwise(q, k, v, cfg, causal, q_offset=0):
    """Flash-style attention: online softmax over KV blocks (the reference's
    ``lax.scan`` as a loop).  Exact: matches ``_sdpa_full`` to rounding."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    cd = as_dtype(cfg.compute_dtype)
    bk = min(cfg.attn_block_k, sk)
    if sk % bk:
        return _sdpa_full(q, k, v, cfg, causal, q_offset)
    nb = sk // bk

    qg = _group_q(q, kvh).to(cd) / (dh ** 0.5)                    # (b*kvh, rep*sq, dh)
    kr, vr = _kv_rows(k), _kv_rows(v)
    m = torch.full((b * kvh, rep, sq), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b * kvh, rep, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b * kvh, rep, sq, dh), dtype=torch.float32, device=q.device)
    for j in range(nb):
        k_j, v_j = kr[:, j * bk:(j + 1) * bk], vr[:, j * bk:(j + 1) * bk]
        s = bdot(qg, k_j.mT, cd).reshape(b * kvh, rep, sq, bk)
        if causal:
            s = torch.where(_causal(sq, bk, q_offset, j * bk, q.device), s, -1e30)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = bdot(p.to(cd).reshape(b * kvh, rep * sq, bk), v_j, cd).reshape(b * kvh, rep, sq, dh)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return _ungroup(out.reshape(b * kvh, rep * sq, dh), b, kvh, rep, sq, dh).to(q.dtype)


def _sdpa(q, k, v, cfg, causal, q_offset=0):
    """q: (b, sq, h, dh); k/v: (b, sk, kvh, dh).  GQA via head grouping;
    blockwise when ``cfg.attn_block_k`` is set and the KV length warrants it."""
    sq, sk = q.shape[1], k.shape[1]
    if cfg.attn_block_k and sk > cfg.attn_block_k and sq > 1:
        return _sdpa_blockwise(q, k, v, cfg, causal, q_offset)
    return _sdpa_full(q, k, v, cfg, causal, q_offset)


def _maybe_rope(q, k, cfg, positions):
    if cfg.use_rope:
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
    return q, k


def attn_train(x, p, cfg, positions, causal=True):
    q, k, v = _qkv(x, p, cfg)
    q, k = _maybe_rope(q, k, cfg, positions)
    o = _sdpa(q, k, v, cfg, causal=causal)
    return dot(o, p["wo"], cfg.compute_dtype).to(x.dtype)
