"""RWKV-6 ("Finch") blocks: data-dependent decay linear attention, in PyTorch.

Counterpart of ``repro.models.rwkv``.  Training uses the chunked matmul
formulation (strictly-causal (Q x Q) score products with the per-channel
decay folded into q/k scalings, then a short loop over the chunk summaries:
the reference's ``lax.scan``); decode is the O(1) recurrence.
``wkv_recurrent``, the step-by-step recurrence, backs the tests.

The numerics are the reference's: the log-decay ``logw`` is float32 whatever
the parameters are, the chunked form works in ``promote_types(r.dtype,
float32)`` (float64 under float64 inputs) and keeps its three clips at
``_LOGW_CLIP``, and mixed dtypes promote as ``jnp`` promotes them.

State per layer: time-mix token shift ``tm_x`` (b, d), wkv state ``wkv``
(b, h, dk, dv), channel-mix token shift ``cm_x`` (b, d).  The decode step
returns new tensors in the dtypes the reference's step gives (the token
shifts in the activations' dtype, whatever the state held): it writes
nothing in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.api.state import generator_device
from repro_torch.models.layers import as_dtype, dot, rmsnorm, uniform_init

__all__ = [
    "rwkv_init",
    "rwkv_time_mix_train",
    "rwkv_channel_mix_train",
    "rwkv_channel_mix_decode",
    "rwkv_decode_step",
    "init_rwkv_state",
    "wkv_recurrent",
]

_LOGW_CLIP = 30.0  # bounds per-chunk decay products in the matmul split


def rwkv_init(gen, cfg, dtype, lead=(), *, device="cuda"):
    """One RWKV-6 block's weights (time mix and channel mix) on ``device``
    (``gen`` must draw there), in the reference's names and scales; ``lead``
    prepends axes (the stacked layers)."""
    dev = generator_device(gen, device)
    lead = tuple(lead)
    d, r = cfg.d_model, cfg.rwkv
    h = d // r.head_dim
    dt = as_dtype(dtype)
    s = (1.0 / d) ** 0.5

    def full(value):
        return torch.full(lead + (d,), value, dtype=dt, device=dev)

    def uni(shape, scale):
        return uniform_init(gen, lead + shape, scale, dt)

    return {
        "mu_r": full(0.5),
        "mu_k": full(0.5),
        "mu_v": full(0.5),
        "mu_g": full(0.5),
        "mu_w": full(0.5),
        "wr": uni((d, d), s),
        "wk": uni((d, d), s),
        "wv": uni((d, d), s),
        "wg": uni((d, d), s),
        "w0": full(-2.0),  # base log-decay rate
        "w_lora_a": uni((d, r.decay_lora), s),
        "w_lora_b": uni((r.decay_lora, d), (1.0 / r.decay_lora) ** 0.5),
        "u_bonus": uni((h, r.head_dim), 0.5),
        "ln_x": full(1.0),
        "wo": uni((d, d), s),
        # channel mix
        "cm_mu_k": full(0.5),
        "cm_mu_r": full(0.5),
        "cm_wk": uni((d, cfg.d_ff), s),
        "cm_wv": uni((cfg.d_ff, d), (1.0 / cfg.d_ff) ** 0.5),
        "cm_wr": uni((d, d), s),
    }


def _common(*xs):
    """``xs`` cast to their promoted dtype (``jnp``'s rule on these types)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _shift(x, x_prev_last):
    """Token shift: x_{t-1} with x_prev_last (b, d) as position -1."""
    prev, rest = _common(x_prev_last[:, None, :], x[:, :-1, :])
    return torch.cat([prev, rest], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)[None, None, :]


def _projections(x, xs, p, cfg):
    cd = cfg.compute_dtype
    r = dot(_lerp(x, xs, p["mu_r"]), p["wr"], cd)
    k = dot(_lerp(x, xs, p["mu_k"]), p["wk"], cd)
    v = dot(_lerp(x, xs, p["mu_v"]), p["wv"], cd)
    g = dot(_lerp(x, xs, p["mu_g"]), p["wg"], cd)
    # data-dependent decay (the RWKV-6 signature)
    wx = _lerp(x, xs, p["mu_w"])
    lora = dot(torch.tanh(dot(wx, p["w_lora_a"], cd)).to(x.dtype), p["w_lora_b"], cd)
    logw = -torch.exp(torch.clamp(p["w0"].float()[None, None, :] + lora.float(),
                                  -8.0, 4.0))  # log w_t <= 0
    return r.to(x.dtype), k.to(x.dtype), v.to(x.dtype), g.to(x.dtype), logw


def wkv_recurrent(r, k, v, logw, u, state):
    """Reference recurrence.  r/k/v: (b, l, h, dk|dv); logw: (b, l, h, dk);
    u: (h, dk); state: (b, h, dk, dv).

    y_t = (S_{t-1} + u k_t v_t^T)^T r_t ;  S_t = diag(w_t) S_{t-1} + k_t v_t^T

    Mixed dtypes promote term by term as the reference's einsums do (its scan
    keeps the carry's dtype, so the state must already hold the promoted
    one)."""
    s = state
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], logw[:, t]  # (b, h, dk), ...
        bonus = torch.sum(rt * u * kt, dim=-1, keepdim=True) * vt
        ys.append(torch.einsum("bhi,bhij->bhj", *_common(rt, s)) + bonus)
        s = s * torch.exp(lwt)[..., None] + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, dim=1), s


def _wkv_chunked(r, k, v, logw, u, state, chunk, unroll=False):
    """Chunked matmul WKV.  Shapes as in ``wkv_recurrent``; ``l % chunk``
    must be 0 (else the reference's reshape raises, and so does this).
    ``unroll`` is the reference's scan/unroll switch: one loop here."""
    del unroll
    b, l, h, dk = r.shape
    dv = v.shape[-1]
    q = chunk
    nc = l // q
    if nc * q != l:
        raise TypeError(f"cannot reshape array of shape {tuple(r.shape)} (size {r.numel()}) "
                        f"into shape {(b, nc, q, h, dk)} (size {b * nc * q * h * dk})")
    f32 = torch.promote_types(r.dtype, torch.float32)  # >= f32; f64 under f64 inputs

    rc = r.reshape(b, nc, q, h, dk).to(f32)
    kc = k.reshape(b, nc, q, h, dk).to(f32)
    vc = v.reshape(b, nc, q, h, dv).to(f32)
    lw = logw.reshape(b, nc, q, h, dk).to(f32)

    lpw = torch.cumsum(lw, dim=2) - lw               # exclusive cumsum: prod_{s<t} w_s
    lpw_tot = lpw[:, :, -1] + lw[:, :, -1]           # full-chunk decay

    # matmul split (clipped to avoid overflow in exp(-lpw))
    q_dec = rc * torch.exp(torch.clamp(lpw, min=-_LOGW_CLIP))
    k_dec = kc * torch.exp(torch.clamp(-(lpw + lw), max=_LOGW_CLIP))

    scores = torch.einsum("bcqhi,bcshi->bchqs", q_dec, k_dec)   # strict-causal
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device), diagonal=-1)
    scores = torch.where(mask, scores, 0.0)
    y_intra = torch.einsum("bchqs,bcshj->bcqhj", scores, vc)

    # u bonus (diagonal term)
    bonus = torch.sum(rc * u.to(f32) * kc, dim=-1)
    y_intra = y_intra + bonus[..., None] * vc

    # chunk state summaries: sum_s (k_s * prod_{u>s} w_u) v_s^T
    k_tail = kc * torch.exp(torch.clamp(lpw_tot[:, :, None] - (lpw + lw), min=-_LOGW_CLIP))
    s_local = torch.einsum("bcshi,bcshj->bchij", k_tail, vc)

    s = state.to(f32)
    ys = []
    for c in range(nc):
        ys.append(torch.einsum("bqhi,bhij->bqhj", q_dec[:, c], s))
        s = s * torch.exp(lpw_tot[:, c])[..., None] + s_local[:, c]
    y_inter = torch.stack(ys, dim=1)

    y = (y_intra + y_inter).reshape(b, l, h, dv)
    return y, s


def rwkv_time_mix_train(x, p, cfg, x_last, state):
    """x: (b, l, d).  Returns (out, (new_x_last, new_state))."""
    r_cfg = cfg.rwkv
    d = cfg.d_model
    h = d // r_cfg.head_dim
    b, l, _ = x.shape
    xs = _shift(x, x_last)
    r, k, v, g, logw = _projections(x, xs, p, cfg)
    hr, hk, hv, hw = (a.reshape(b, l, h, r_cfg.head_dim) for a in (r, k, v, logw))
    y, new_state = _wkv_chunked(hr, hk, hv, hw, p["u_bonus"], state, r_cfg.chunk,
                                unroll=not cfg.scan_layers)
    y = y.reshape(b, l, d).to(x.dtype)
    y = rmsnorm(y, p["ln_x"]) * F.silu(g)
    out = dot(y, p["wo"], cfg.compute_dtype).to(x.dtype)
    return out, (x[:, -1, :], new_state)


def rwkv_channel_mix_train(x, p, cfg, x_last):
    cd = cfg.compute_dtype
    xs = _shift(x, x_last)
    xk = _lerp(x, xs, p["cm_mu_k"])
    xr = _lerp(x, xs, p["cm_mu_r"])
    k = torch.square(F.relu(dot(xk, p["cm_wk"], cd))).to(x.dtype)
    kv = dot(k, p["cm_wv"], cd).to(x.dtype)
    return torch.sigmoid(dot(xr, p["cm_wr"], cd)).to(x.dtype) * kv, x[:, -1, :]


def init_rwkv_state(batch, cfg, dtype, *, device="cuda"):
    """Zero state of one layer: the token shifts in ``dtype``, wkv float32."""
    d, r = cfg.d_model, cfg.rwkv
    h = d // r.head_dim
    dt = as_dtype(dtype)
    return {
        "tm_x": torch.zeros((batch, d), dtype=dt, device=device),
        "wkv": torch.zeros((batch, h, r.head_dim, r.head_dim), dtype=torch.float32,
                           device=device),
        "cm_x": torch.zeros((batch, d), dtype=dt, device=device),
    }


def rwkv_decode_step(x, p, cfg, state):
    """One token through the time mix.  x: (b, 1, d).  Returns (out, state'),
    with state' = {tm_x: this token's input, wkv: the new state, cm_x: the
    state's own, unchanged} (the model replaces ``cm_x`` after the channel
    mix, as the reference does)."""
    r_cfg = cfg.rwkv
    d = cfg.d_model
    h = d // r_cfg.head_dim
    b = x.shape[0]
    xs = state["tm_x"][:, None, :].to(x.dtype)
    r, k, v, g, logw = _projections(x, xs, p, cfg)
    hr, hk, hv, hw = (a.reshape(b, 1, h, r_cfg.head_dim) for a in (r, k, v, logw))
    y, wkv = wkv_recurrent(hr, hk, hv, hw, p["u_bonus"], state["wkv"])
    y = y.reshape(b, 1, d).to(x.dtype)
    y = rmsnorm(y, p["ln_x"]) * F.silu(g)
    tm_out = dot(y, p["wo"], cfg.compute_dtype).to(x.dtype)
    return tm_out, {"tm_x": x[:, 0, :], "wkv": wkv, "cm_x": state["cm_x"]}


def rwkv_channel_mix_decode(x, p, cfg, state):
    # _shift handles the single-token case: x_{t-1} comes from the carried state
    out, cm_x = rwkv_channel_mix_train(x, p, cfg, state["cm_x"])
    return out, cm_x
