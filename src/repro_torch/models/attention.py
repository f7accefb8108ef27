"""GQA/MQA/MHA attention with KV cache (train, prefill, decode), in PyTorch.

Counterpart of ``repro.models.attention``.  Plain tensor code that follows
the reference's einsums: float32 scores from compute-dtype operands
(``layers.bdot``), the ``-1e30`` causal mask, and the blockwise form's online
softmax over KV blocks.  It does not call ``scaled_dot_product_attention``:
the reference computes attention outside any kernel, so its numerics are the
ones held here.

The decode cache is written in place.  The reference's engine donates the
cache to a jitted ``decode_step``, so XLA writes each step into the same
buffer; ``attn_decode`` writes the new entries into the tensors it is given
and returns them (the cache passed in is consumed, as donation does: keep a
``clone()`` to reuse the old one).  The int8 cache holds per-(token, head)
symmetric int8 entries with float32 scales; each step dequantizes the whole
cache, as the reference does.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import as_dtype, bdot, dot, rope_apply, uniform_init

__all__ = ["attn_init", "attn_train", "attn_prefill", "attn_decode", "init_kv_cache"]


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


# ---------------------------------------------------------------------------
# KV cache, prefill and decode
# ---------------------------------------------------------------------------


def init_kv_cache(batch, max_len, cfg, dtype, *, device="cuda"):
    """Zero cache of one layer: ``k``/``v`` ``(batch, max_len, kvh, dh)`` in
    ``dtype``, or with ``cfg.kv_cache_dtype == "int8"`` int8 entries and
    float32 ``k_scale``/``v_scale`` ``(batch, max_len, kvh)``."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
    dt = as_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _quantize_kv(x):
    """Per-(token, head) symmetric int8 of ``x`` (b, s, kvh, dh): rounded half
    to even (``torch.round``, as ``jnp.round``), scale ``max|x| / 127 + 1e-12``
    in float32."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(as_dtype(dtype))


def _write(buf, new, pos):
    """``buf[:, pos] = new[:, 0]`` in place (``new`` cast to ``buf``'s dtype):
    the reference's ``dynamic_update_slice_in_dim`` on a donated buffer.  The
    slot is the one that call picks: a negative ``pos`` counts from the end
    (jax adds ``sk``), then the start is clamped to ``[0, sk - 1]`` as XLA
    clamps it, so past the end of the cache the entry overwrites the last
    slot.  A Python ``pos`` is resolved on the host and written through a
    slice; a tensor ``pos`` on its device, and written with ``index_copy_``
    (no host wait)."""
    new = new.to(buf.dtype)
    sk = buf.shape[1]
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1).to(device=buf.device, dtype=torch.long)
        idx = torch.where(idx < 0, idx + sk, idx).clamp(0, sk - 1)
        buf.index_copy_(1, idx, new)
    else:
        slot = int(pos)
        slot = min(max(slot + sk if slot < 0 else slot, 0), sk - 1)
        buf[:, slot:slot + 1] = new
    return buf


def _positions(b, pos, device):
    """The decode step's (b, 1) int32 positions from a Python or tensor ``pos``."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1, 1).to(device=device, dtype=torch.int32).expand(b, 1)
    return torch.full((b, 1), pos, dtype=torch.int32, device=device)


def _decode_valid(sk, pos, device):
    """The decode mask: the cache positions ``<= pos`` of ``sk``."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device)
    return torch.arange(sk, device=device) <= pos


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _rows_cd(x, cd):
    """(b, sk, kvh, dh) -> (b*kvh, sk, dh) in the compute dtype, one pass
    (the transpose and the cast in one copy)."""
    b, sk, kvh, dh = x.shape
    out = torch.empty((b, kvh, sk, dh), dtype=cd, device=x.device)
    out.copy_(x.permute(0, 2, 1, 3))
    return out.view(b * kvh, sk, dh)


def attn_prefill(x, p, cfg, positions):
    """Full-sequence prefill; returns ``(out, {"k", "v"})`` with ``seq_len``
    entries in the activations' dtype (no scales, whatever
    ``kv_cache_dtype`` says, as the reference)."""
    q, k, v = _qkv(x, p, cfg)
    q, k = _maybe_rope(q, k, cfg, positions)
    o = _sdpa(q, k, v, cfg, causal=True)
    out = dot(o, p["wo"], cfg.compute_dtype).to(x.dtype)
    return out, {"k": k, "v": v}


def attn_decode(x, p, cfg, cache, pos):
    """One-token decode: ``x`` (b, 1, d); ``cache`` holds ``pos`` valid
    entries.  Writes the new entry into ``cache`` in place and returns
    ``(out, cache)``: the cache passed in is consumed.

    With ``cfg.kv_cache_dtype == "int8"`` the entry is quantized per (token,
    head) with a float32 scale, and the whole cache is dequantized to the
    activations' dtype for the step.  A float cache under an int8 config
    raises the reference's ``TypeError`` (its ``dynamic_update_slice`` of int8
    entries into the float buffer that ``attn_prefill`` returns)."""
    b = x.shape[0]
    q, k, v = _qkv(x, p, cfg)
    q, k = _maybe_rope(q, k, cfg, _positions(b, pos, x.device))
    cd = as_dtype(cfg.compute_dtype)
    if cfg.kv_cache_dtype == "int8":
        if cache["k"].dtype != torch.int8:
            raise TypeError("lax.dynamic_update_slice requires arguments to have the same "
                            f"dtypes, got {_dtype_name(cache['k'].dtype)}, int8.")
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        for name, new in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            _write(cache[name], new, pos)
        ck = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        cv = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        ck = _write(cache["k"], k, pos)
        cv = _write(cache["v"], v, pos)
    # attend over the whole (static) cache; mask positions beyond pos
    sk, kvh, dh, h = ck.shape[1], cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    rep = h // kvh
    scores = bdot(_group_q(q, kvh), _rows_cd(ck, cd).mT, cd) / (dh ** 0.5)  # (b*kvh, rep, sk)
    scores = torch.where(_decode_valid(sk, pos, x.device), scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    o = bdot(w.to(cd), _rows_cd(cv, cd), cd)
    o = _ungroup(o, b, kvh, rep, 1, dh).to(x.dtype)
    return dot(o, p["wo"], cd).to(x.dtype), cache
