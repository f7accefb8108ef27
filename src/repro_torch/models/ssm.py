"""Mamba2 (SSD) block: chunked matmul-form training scan + O(1) decode step,
in PyTorch.

Counterpart of ``repro.models.ssm``.  Within a chunk the interactions are
(Q x Q) masked products; the inter-chunk state is a short loop over the
chunk summaries (b, h, d_state, head_dim): the reference's ``lax.scan``, 8
chunks at l = 1024 and chunk 128.  The causal mask sits *inside* the exp: an
exp of the masked (positive) exponents would give inf and poison the
backward through the ``where``.  Decode keeps (conv buffer, SSM state) per
layer; the SSM state is float32 whatever the compute dtype, and
``ssm_decode`` writes both into the tensors it is given and returns them
(the state passed in is consumed, as the reference's donated buffer).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import as_dtype, bdot, dot, rmsnorm, uniform_init

__all__ = ["ssm_init", "ssm_train", "ssm_decode", "init_ssm_state", "ssm_dims"]


def ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def ssm_init(gen, cfg, dtype, lead=()):
    """Mamba2 weights; ``lead`` prepends axes (stacked layers)."""
    lead = tuple(lead)
    s, d = cfg.ssm, cfg.d_model
    d_inner, n_heads, conv_dim = ssm_dims(cfg)
    dt, dev = as_dtype(dtype), gen.device
    sc = (1.0 / d) ** 0.5

    def const(x):
        return x.to(dt).expand(lead + x.shape).contiguous()

    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float64, device=dev).to(dt))
    return {
        "in_proj": uniform_init(gen, lead + (d, 2 * d_inner + 2 * s.d_state + n_heads), sc, dt),
        "conv_w": uniform_init(gen, lead + (s.conv_width, conv_dim), 0.5, dt),
        "conv_b": const(torch.zeros((conv_dim,), device=dev)),
        "a_log": const(a_log),
        "dt_bias": const(torch.zeros((n_heads,), device=dev)),
        "d_skip": const(torch.ones((n_heads,), device=dev)),
        "norm_w": const(torch.ones((d_inner,), device=dev)),
        "out_proj": uniform_init(gen, lead + (d_inner, d), (1.0 / d_inner) ** 0.5, dt),
    }


def _split(zxbcdt, cfg):
    s = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * s.d_state]
    dt = zxbcdt[..., -n_heads:]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv along time.  ``xbc`` (b, l, c); ``w`` (k, c)."""
    k, l = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + l, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def ssm_train(x, p, cfg, *, return_final_state=False):
    """``x`` (b, l, d) -> (b, l, d); l must be a multiple of ``cfg.ssm.chunk``.
    With ``return_final_state`` also the exact terminal decode state: the
    SSM state after the last chunk and the conv buffer (the last
    ``conv_width - 1`` raw conv inputs)."""
    s = cfg.ssm
    cd = cfg.compute_dtype
    b, l, _ = x.shape
    d_inner, n_heads, _ = ssm_dims(cfg)
    hd, n = s.head_dim, s.d_state
    q = min(s.chunk, l)
    if l % q:
        raise ValueError(f"sequence length {l} not divisible by SSD chunk {q}")
    nc = l // q

    zxbcdt = dot(x, p["in_proj"], cd).to(x.dtype)
    z, xbc, dt_raw = _split(zxbcdt, cfg)
    xbc_preact = xbc
    xbc = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xs = xbc[..., :d_inner].reshape(b, l, n_heads, hd)
    bmat = xbc[..., d_inner:d_inner + n]                       # (b, l, n)
    cmat = xbc[..., d_inner + n:]                              # (b, l, n)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                         # (h,) negative
    da = dt * a[None, None, :]                                 # (b, l, h) <= 0

    xs_c = xs.reshape(b, nc, q, n_heads, hd)
    b_c = bmat.reshape(b, nc, q, n)
    c_c = cmat.reshape(b, nc, q, n)
    dt_c = dt.reshape(b, nc, q, n_heads)
    da_c = da.reshape(b, nc, q, n_heads)

    seg = torch.cumsum(da_c, dim=2)                            # inclusive (b, nc, q, h)
    seg_tot = seg[:, :, -1, :]                                 # (b, nc, h)

    # within-chunk: Y_diag[t] = sum_{s<=t} exp(seg_t - seg_s) CB[t,s] dt_s x_s
    cb = bdot(c_c.reshape(b * nc, q, n), b_c.reshape(b * nc, q, n).mT, cd).reshape(b, nc, q, q)
    ldecay = seg[:, :, :, None, :] - seg[:, :, None, :, :]    # (b, nc, t, s, h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # the mask INSIDE the exp (see the module docstring)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], ldecay, -torch.inf))
    w_ts = cb[..., None] * decay                               # (b, nc, t, s, h)
    xdt = xs_c.float() * dt_c[..., None]                       # (b, nc, q, h, p)
    y_diag = torch.einsum("bctsh,bcshp->bcthp", w_ts, xdt)

    # chunk summary states: S_c = sum_s exp(seg_tot - seg_s) dt_s B_s x_s^T
    dec_to_end = torch.exp(seg_tot[:, :, None, :] - seg)       # (b, nc, q, h)
    wx = (dec_to_end * dt_c)[..., None] * xs_c.float()         # (b, nc, q, h, p)
    bx = torch.einsum("bcqn,bcqhp->bchnp", b_c.float(), wx)

    # inter-chunk recurrence over chunk states (the state BEFORE each chunk)
    state = torch.zeros((b, n_heads, n, hd), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(seg_tot[:, c])[:, :, None, None] + bx[:, c]
    states_prev = torch.stack(prev, dim=1)                     # (b, nc, h, n, p)

    # inter-chunk contribution: Y_off[t] = exp(seg_t) C_t . S_prev
    y_off = torch.einsum("bcqn,bchnp->bcqhp", c_c.float(), states_prev) * torch.exp(seg)[..., None]
    y = (y_diag + y_off).reshape(b, l, n_heads, hd)
    y = y + xs.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, l, d_inner).to(x.dtype)

    y = rmsnorm(y * F.silu(z), p["norm_w"])
    out = dot(y, p["out_proj"], cd).to(x.dtype)
    if return_final_state:
        return out, {"conv": xbc_preact[:, -(s.conv_width - 1):, :], "ssm": state}
    return out


def init_ssm_state(batch, cfg, dtype, *, device="cuda"):
    s = cfg.ssm
    _, n_heads, conv_dim = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=as_dtype(dtype),
                            device=device),
        "ssm": torch.zeros((batch, n_heads, s.d_state, s.head_dim), dtype=torch.float32,
                           device=device),
    }


def ssm_decode(x, p, cfg, state):
    """One-token step.  ``x`` (b, 1, d); returns ``(y, state)`` with the conv
    buffer shifted and the SSM state advanced in place (the state passed in
    is consumed).  A conv buffer narrower than the activations (a bf16 state
    spec under float32 parameters) comes back as a new tensor in the
    activations' dtype, as the reference promotes it."""
    s = cfg.ssm
    cd = cfg.compute_dtype
    b = x.shape[0]
    d_inner, n_heads, _ = ssm_dims(cfg)
    hd, n = s.head_dim, s.d_state

    zxbcdt = dot(x, p["in_proj"], cd).to(x.dtype)
    z, xbc, dt_raw = _split(zxbcdt, cfg)

    conv = state["conv"]
    buf = torch.cat([conv, xbc], dim=1)                        # (b, k, c)
    conv_out = torch.einsum("bkc,kc->bc", buf.float(), p["conv_w"].float()) + p["conv_b"].float()
    xbc1 = F.silu(conv_out)[:, None, :].to(x.dtype)
    if buf.dtype == conv.dtype:
        conv.copy_(buf[:, 1:, :])
    else:
        state["conv"] = buf[:, 1:, :].contiguous()

    xs = xbc1[..., :d_inner].reshape(b, n_heads, hd)
    bvec = xbc1[:, 0, d_inner:d_inner + n]
    cvec = xbc1[:, 0, d_inner + n:]

    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * a[None, :])                         # (b, h)

    ssm = state["ssm"]
    upd = torch.einsum("bn,bhp->bhnp", bvec.float(), dt[:, :, None] * xs.float())
    ssm.mul_(decay[:, :, None, None]).add_(upd)
    y = torch.einsum("bn,bhnp->bhp", cvec.float(), ssm)
    y = y + xs.float() * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"])
    out = dot(y, p["out_proj"], cd).to(x.dtype)
    return out, state
