"""Plain reference of a training cell: the dense decoder's loss and gradients,
and spectral-Adam's step with its trackers' rank-1 SVD updates.

The model follows the port's block (pre-norm RMSNorm or LayerNorm, causal
attention with grouped KV heads, optional Q/K/V biases and RoPE, a SwiGLU or
tanh-GELU MLP, an untied head; see the config file's ``departures`` for
where that differs from the published model) in float32 with TF32 off.  Every matrix product takes operands rounded to the
configuration's compute format and accumulates in float32, and the
cotangents of its operands are rounded to that format on the way back (the
rule the program's products follow).  The format is ``"bfloat16"`` for the
reference and ``"float8"`` (per-tensor scaled e4m3) for its control.

Spectral-Adam: every matrix whose smaller side exceeds four times the rank
keeps a tracker, a rank-r SVD of its gradients' history.  A step takes one
power iteration of the gradient from the tracker's vector, decays the
tracker's values by 0.99, adds the rank-1 pair (``reference.svd_stream``'s
plain update, the core in float64), projects the gradient on the new left
basis and keeps Adam's moments in that (r, n) space.  Other leaves take
AdamW without clipping.

A singular vector's sign is free: the update determines each triplet up to
it, and the port takes it from its own algorithm.  The moments kept in the
projected space see it, so ``align`` gives, for every step, the left bases
whose column signs the reference adopts (the program's trackers after that
step); every other number is the reference's own.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.inputs import granite as gin
from perfbench.reference.svd_stream import truncated_update

_E4M3_MAX = 448.0
DECAY = 0.99
RMS_EPS = 1e-6
LN_EPS = 1e-5


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x):
    scale = x.detach().abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDING = {"bfloat16": _bf16, "float8": _fp8}


class _Round(torch.autograd.Function):
    """Round to the compute format, forward and backward."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return ROUNDING[fmt](x)

    @staticmethod
    def backward(ctx, g):
        return ROUNDING[ctx.fmt](g), None


def _mm(x, w, fmt):
    return torch.matmul(_Round.apply(x, fmt), _Round.apply(w, fmt))


def _norm(x, p, cfg):
    if cfg["norm_type"] == "rmsnorm":
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + RMS_EPS) * p["w"]
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * p["w"] + p["b"]


def _proj(x, lp, name, cfg, fmt):
    """``x @ w<name>`` plus ``b<name>`` where the configuration has Q/K/V biases."""
    y = _mm(x, lp["w" + name], fmt)
    return y + lp["b" + name] if cfg.get("qkv_bias") else y


def _rope(x, theta):
    """x (b, s, heads, dh): the halves rotated by position (the port's form)."""
    half = x.shape[-1] // 2
    inv = 1.0 / torch.pow(float(theta), torch.arange(0, half, dtype=torch.float32,
                                                      device=x.device) / half)
    pos = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)
    ang = pos[:, None] * inv[None, :]
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(x, lp, cfg, fmt):
    b, s, d = x.shape
    h, kvh = cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("d_head") or d // h
    rep = h // kvh
    q = _rope(_proj(x, lp, "q", cfg, fmt).reshape(b, s, h, dh),
              cfg["rope_theta"]).reshape(b, s, kvh, rep, dh)
    k = _rope(_proj(x, lp, "k", cfg, fmt).reshape(b, s, kvh, dh), cfg["rope_theta"])
    v = _proj(x, lp, "v", cfg, fmt).reshape(b, s, kvh, dh)
    qg = q.permute(0, 2, 3, 1, 4)                       # (b, kvh, rep, s, dh)
    kg = k.permute(0, 2, 1, 3)[:, :, None]              # (b, kvh, 1, s, dh)
    vg = v.permute(0, 2, 1, 3)[:, :, None]
    scores = _mm(qg, kg.mT, fmt) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(torch.where(causal, scores, -1e30), dim=-1)
    out = _mm(w, vg, fmt)                               # (b, kvh, rep, s, dh)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h * dh)
    return _mm(out, lp["wo"], fmt)


def _layer(x, lp, cfg, fmt):
    h = x + _attention(_norm(x, lp["ln1"], cfg), lp["attn"], cfg, fmt)
    m = _norm(h, lp["ln2"], cfg)
    mlp = lp["mlp"]
    if cfg["mlp_type"] == "swiglu":
        g = F.silu(_mm(m, mlp["wg"], fmt)) * _mm(m, mlp["wu"], fmt)
    else:
        g = F.gelu(_mm(m, mlp["wi"], fmt), approximate="tanh")
    return h + _mm(g, mlp["wd"], fmt)


def loss(params: dict, batch: dict, cfg: dict, fmt: str = "bfloat16"):
    """Mean next-token cross entropy of the decoder (each layer recomputed in
    the backward, as the port's "full" remat does; it changes no value)."""
    x = F.embedding(batch["tokens"].long(), params["embed"]["table"])
    # one unbind a stacked leaf: its backward stacks the layers' gradients
    per_layer = {k: {kk: torch.unbind(vv, 0) for kk, vv in sub.items()}
                 for k, sub in params["layers"].items()}
    for li in range(cfg["n_layers"]):
        lp = {k: {kk: vv[li] for kk, vv in sub.items()} for k, sub in per_layer.items()}
        x = checkpoint(_layer, x, lp, cfg, fmt, use_reentrant=False)
    x = _norm(x, params["final_norm"], cfg)
    logits = _mm(x, params["head"], fmt)
    vmask = torch.arange(logits.shape[-1], device=x.device) < cfg["vocab_size"]
    logits = torch.where(vmask, logits, -1e30)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def loss_and_grads(params: dict, batch: dict, cfg: dict, fmt: str = "bfloat16"):
    flat = gin.flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in flat.values()]
    value = loss(gin.nest(dict(zip(flat, leaves))), batch, cfg, fmt)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), dict(zip(flat, grads))


def learning_rate(step: int, opt: dict, min_ratio: float = 0.1) -> float:
    """Linear warm-up to ``lr``, then a cosine to ``min_ratio`` of it."""
    lr, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


@contextlib.contextmanager
def full_float32():
    """float32 products in float32 (TF32 off) while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _track(tracker, grad, align_u):
    """One tracker update from a gradient: ``(u, s, v, power_v)``."""
    u, s, v, pv = tracker
    gv = grad @ pv
    lu = gv / (torch.linalg.vector_norm(gv) + 1e-30)
    gtu = grad.mT @ lu
    sigma = torch.linalg.vector_norm(gtu)
    pv_new = gtu / (sigma + 1e-30)
    root = torch.sqrt(sigma)
    nu, ns, nv = truncated_update(u[None], (s * DECAY)[None], v[None], (lu * root)[None],
                                  (pv_new * root)[None], core_dtype=torch.float64)
    nu, ns, nv = nu[0], ns[0], nv[0]
    if align_u is not None:
        sign = torch.where(torch.sum(nu * align_u.to(nu.device), dim=0) < 0, -1.0, 1.0)
        nu, nv = nu * sign, nv * sign
    return nu, ns, nv, pv_new


def run_steps(cfg: dict, traffic: dict, seed: int, device, steps: int, *,
              fmt: str = "bfloat16", align=None) -> dict:
    """``steps`` spectral-Adam steps from the seeded inputs.  ``align[t]``:
    ``{path: u}`` the left bases whose column signs step ``t`` adopts.

    Returns the losses, each leaf's first gradient norm (whole) and as the
    optimizer keeps it (its first moment after step 1 over 1 - beta1; the
    projected one for a tracked leaf), each leaf's change after ``steps``,
    and the trackers after the last step."""
    opt = traffic["optimizer"]
    b1, b2 = opt["betas"]
    eps, wd, rank = opt["eps"], opt["weight_decay"], opt["spectral_rank"]
    batches = gin.Batches(cfg, seed, device)
    out = {"losses": [], "grad_norm": {}, "seen_grad_norm": {}, "change_norm": {}}
    with full_float32(), torch.no_grad():
        params = gin.flatten(gin.make_weights(cfg, seed, device))
        trackers = gin.make_trackers(cfg, traffic, seed, device)
        m = {p: None for p in params}
        v = {p: None for p in params}
        for t in range(steps):
            with torch.enable_grad():
                value, grads = loss_and_grads(gin.nest(params), batches.next(), cfg, fmt)
            out["losses"].append(float(value))
            lr = learning_rate(t, opt)
            bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            for path, g in grads.items():
                if t == 0:
                    out["grad_norm"][path] = float(torch.linalg.vector_norm(g.double()))
                if path in trackers:
                    trackers[path] = _track(trackers[path], g, None if align is None
                                            else align[t][path])
                    g = trackers[path][0].mT @ g
                m[path] = (1 - b1) * g if m[path] is None else b1 * m[path] + (1 - b1) * g
                v[path] = (1 - b2) * g * g if v[path] is None else b2 * v[path] + (1 - b2) * g * g
                if t == 0:
                    out["seen_grad_norm"][path] = float(
                        torch.linalg.vector_norm(m[path].double()) / (1 - b1))
                upd = (m[path] / bc1) / (torch.sqrt(v[path] / bc2) + eps)
                if path in trackers:
                    upd = trackers[path][0] @ upd
                params[path] = params[path] - lr * (upd + wd * params[path])
            del grads
        for i, (path, _, _) in enumerate(gin.leaf_specs(cfg)):
            start = gin.make_leaf(cfg, seed, i, device)
            out["change_norm"][path] = float(torch.linalg.vector_norm(
                (params[path] - start).double()))
            del start
    out["trackers"] = {p: tuple(x.cpu() for x in tr[:3]) for p, tr in trackers.items()}
    return out
