"""Plain reference of a DeepSeek-V2 training cell: the loss, with the
sequence-wise balance loss, and its gradients, of one chip's share of the
model (``inputs.deepseek_v2``'s layout).

Float32, TF32 off (``reference.granite.full_float32`` around every run);
each matrix product takes operands rounded to the compute format and
accumulates in float32, and the cotangents of its operands are rounded the
same way on the way back (``reference.granite._mm``): ``"bfloat16"`` for the
reference, ``"float8"`` for its control.  The router's product is float32,
as DeepSeek-V2 and the port compute it.  Written from the paper
(arXiv:2405.04434) and the published config; the configuration file's
``departures`` list where it differs from the published model.

* Multi-head latent attention, unabsorbed as the paper writes it: per head a
  query of 128 + 64 dims, a key of the 128-dim up-projection of the
  RMS-normed 512-dim latent beside the one 64-dim rope key shared by the
  heads, a value of the 128-dim up-projection; causal softmax at scale
  (dn + dr)^-1/2 times mscale^2.
* YaRN on the 64 rope dimensions (the halves rotated): frequencies
  ``theta^(-2i/d)`` blended with the same over the factor along a linear ramp
  between the pairs ``floor(c(beta_fast))`` and ``ceil(c(beta_slow))``,
  ``c(beta) = d ln(L0 / (2 pi beta)) / (2 ln theta)``; cos and sin times
  ``g(s, mscale) / g(s, mscale_all_dim)``, ``g(s, m) = 0.1 m ln s + 1``.
* The first ``first_k_dense_replace`` layers end in a SwiGLU MLP of
  ``intermediate_size``; the others in the MoE layer: a float32 softmax router
  over all routed experts, the top k (ties to the lower index), the gates
  not renormalised (``norm_topk_prob`` false, ``routed_scaling_factor`` 1);
  in each group of ``moe_group_size`` tokens (in batch-major order) each
  expert takes the first ``int(capacity_factor * group * k / E)`` choices in
  (token, rank) order and drops the rest.  Only the held experts
  (``expert_parallel``) add their gated SwiGLU outputs; the shared experts'
  SwiGLU (width ``n_shared * moe_intermediate_size``) is added for every
  token.  The sequence-wise balance loss of each MoE layer is
  ``alpha * mean over sequences of sum_e f_e P_e``, ``f_e`` the sequence's
  choices of expert ``e`` over ``s k / E`` (no gradient), ``P_e`` its mean
  router probability, and is added to the loss.
* RMSNorm (eps ``rms_norm_eps``) before each block, the latent's own norm,
  the final norm; an untied head over the vocabulary slice; the mean next
  token cross entropy.  Each layer is recomputed in the backward
  (checkpointing changes no value).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.inputs import deepseek_v2 as din
from perfbench.reference.granite import _mm, _Round


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _mscale(factor, m):
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(dim: int, theta: float, scaling: dict, device=None):
    """The YaRN inverse frequencies of ``dim`` rope dimensions (module docstring)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / theta ** exps
    inter = 1.0 / (scaling["factor"] * theta ** exps)
    l0 = scaling["original_max_position_embeddings"]

    def corr(beta):
        return dim * math.log(l0 / (beta * 2 * math.pi)) / (2 * math.log(theta))

    lo = max(math.floor(corr(scaling["beta_fast"])), 0)
    hi = min(math.ceil(corr(scaling["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / ((hi - lo) or 0.001)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(cfg: dict) -> float:
    sc = cfg["rope_scaling"]
    base = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    return base * _mscale(sc["factor"], sc["mscale_all_dim"]) ** 2


def _rope(x, cfg):
    """x (b, s, heads, dr): the halves rotated by YaRN's angles."""
    sc = cfg["rope_scaling"]
    inv = yarn_inv_freq(x.shape[-1], float(cfg["rope_theta"]), sc, x.device)
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * inv[None]
    m = _mscale(sc["factor"], sc["mscale"]) / _mscale(sc["factor"], sc["mscale_all_dim"])
    sin, cos = (torch.sin(ang) * m)[:, None, :], (torch.cos(ang) * m)[:, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mla(x, p, cfg, fmt):
    b, s, _ = x.shape
    z = din.dims(cfg)
    h, dn, dr, dv, r = z["h"], z["dn"], z["dr"], z["dv"], z["r"]
    q = _mm(x, p["wq"], fmt).reshape(b, s, h, dn + dr)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], cfg)], dim=-1)
    ckv = _mm(x, p["w_dkv"], fmt)
    c = _rmsnorm(ckv[..., :r], p["kv_norm"], cfg["rms_norm_eps"])
    k_rope = _rope(ckv[..., r:][:, :, None, :], cfg)                   # (b, s, 1, dr)
    k_nope = _mm(c, p["w_uk"], fmt).reshape(b, s, h, dn)
    v = _mm(c, p["w_uv"], fmt).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))             # (b, h, s, .)
    scores = _mm(qh, kh.mT, fmt) * softmax_scale(cfg)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(torch.where(causal, scores, -1e30), dim=-1)
    out = _mm(w, vh, fmt).permute(0, 2, 1, 3).reshape(b, s, h * dv)
    return _mm(out, p["wo"], fmt)


def _swiglu(x, p, fmt):
    return _mm(F.silu(_mm(x, p["wg"], fmt)) * _mm(x, p["wu"], fmt), p["wd"], fmt)


def _moe(x, p, cfg, fmt):
    """The held experts' gated outputs plus the shared experts', and the
    layer's balance loss."""
    b, s, d = x.shape
    z = din.dims(cfg)
    e_n, k, start = z["n_routed"], z["k"], z["held_start"]
    probs = torch.softmax(torch.matmul(x, p["router"]), dim=-1)        # (b, s, E) float32
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]

    counts = F.one_hot(idx.reshape(b, s * k), e_n).sum(1).to(torch.float32)
    aux = cfg["aux_loss_alpha"] * torch.mean(
        torch.sum(counts / (s * k / e_n) * probs.mean(1), dim=-1))

    t = b * s
    gs = min(cfg["moe_group_size"], t)
    capacity = max(1, int(cfg["capacity_factor"] * gs * k / e_n))
    flat_idx = idx.reshape(t // gs, gs * k)
    chosen = F.one_hot(flat_idx, e_n)                                    # (G, gs*k, E)
    before = torch.cumsum(chosen, dim=1) - chosen
    pos = torch.gather(before, -1, flat_idx[..., None])[..., 0].reshape(t, k)
    kept = pos < capacity

    xt = x.reshape(t, d)
    gates, idx = gates.reshape(t, k), idx.reshape(t, k)
    out = torch.zeros_like(xt)
    for e in range(start, start + z["n_held"]):
        tok, rank = torch.nonzero((idx == e) & kept, as_tuple=True)
        if not len(tok):
            continue
        ep = {n: p[n][e - start] for n in ("wg", "wu", "wd")}
        y = _swiglu(xt[tok], ep, fmt)
        g = _Round.apply(gates[tok, rank][:, None], fmt)
        out = out.index_add(0, tok, g * _Round.apply(y, fmt))
    out = out.reshape(b, s, d)
    if z["n_shared"]:
        out = out + _swiglu(x, p["shared"], fmt)
    return out, aux


def _layer(x, aux, lp, cfg, fmt):
    eps = cfg["rms_norm_eps"]
    h = x + _mla(_rmsnorm(x, lp["ln1"]["w"], eps), lp["mla"], cfg, fmt)
    hn = _rmsnorm(h, lp["ln2"]["w"], eps)
    if "moe" in lp:
        y, a = _moe(hn, lp["moe"], cfg, fmt)
        return h + y, aux + a
    return h + _swiglu(hn, lp["mlp"], fmt), aux


def _per_layer(stack: dict, n: int) -> list:
    """One dict a layer from the stacked leaves (one unbind a leaf)."""
    def unbind(tree):
        if isinstance(tree, dict):
            parts = {k: unbind(v) for k, v in tree.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n)]
        return list(torch.unbind(tree, 0))

    return unbind(stack)


def loss(params: dict, batch: dict, cfg: dict, fmt: str = "bfloat16"):
    """Mean next-token cross entropy over the vocabulary slice plus the MoE
    layers' balance losses."""
    z = din.dims(cfg)
    x = F.embedding(batch["tokens"].long(), params["embed"]["table"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = []
    if z["n_dense"]:
        layers += _per_layer(params["dense_layers"], z["n_dense"])
    layers += _per_layer(params["layers"], z["n_moe"])
    for lp in layers:
        x, aux = checkpoint(_layer, x, aux, lp, cfg, fmt, use_reentrant=False)
    x = _rmsnorm(x, params["final_norm"]["w"], cfg["rms_norm_eps"])
    logits = _mm(x, params["head"], fmt)
    vmask = torch.arange(logits.shape[-1], device=x.device) < z["vocab"]
    logits = torch.where(vmask, logits, -1e30)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold) + aux


def loss_and_grads(params: dict, batch: dict, cfg: dict, fmt: str = "bfloat16"):
    flat = din.flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in flat.values()]
    value = loss(din.nest(dict(zip(flat, leaves))), batch, cfg, fmt)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), dict(zip(flat, grads))
