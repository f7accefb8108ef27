"""Mixture-of-Experts layer (DeepSeek-MoE style: shared + fine-grained
routed), in PyTorch.

Counterpart of ``repro.models.moe``: GShard/Switch capacity dispatch over
fixed-size token groups, top-k routing with a static per-expert capacity,
dispatch and combine as dense products over one-hot tensors.  Overflowed
choices fall through on the residual path (standard capacity semantics), so
at decode (one group of ``b`` tokens) the capacity is
``max(1, int(1.25 * b * k / E))``.

The reference's ``lax.top_k`` breaks ties by the lower index; ``torch.topk``
promises no order among equal values on CUDA, so the top k are taken from a
stable descending sort.  One-hots are comparisons with an ``arange`` and
``cumsum`` has an explicit dtype: nothing asks the host for a value.  Dtypes
follow each reference einsum: those with ``preferred_element_type=f32`` give
float32, the others (dispatch, ``x_exp``, the combine) the compute dtype,
here as a float32 product rounded once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import as_dtype, bdot, mlp_apply, mlp_init, uniform_init

__all__ = ["moe_init", "moe_apply", "moe_aux_loss"]


def _constrain(x, spec, cfg):
    """The reference's expert-parallel sharding annotation
    (``cfg.moe_shard_constraints``): the placement ``spec`` names for ``x``
    on a model mesh.  A tensor of the port is whole on its device, so, as the
    reference's constraint outside a mesh context, it returns ``x`` itself,
    its values unchanged; only the spec's rank is checked."""
    if not cfg.moe_shard_constraints:
        return x
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} does not fit a tensor of shape {tuple(x.shape)}")
    return x


def moe_init(gen, cfg, dtype, lead=()):
    """MoE weights; ``lead`` prepends axes (the stacked layers).  The router is
    float32 whatever ``dtype``."""
    lead = tuple(lead)
    d, m = cfg.d_model, cfg.moe
    s_in = (1.0 / d) ** 0.5
    s_out = (1.0 / m.d_ff_expert) ** 0.5
    p = {
        "router": uniform_init(gen, lead + (d, m.n_routed), s_in, torch.float32),
        "wg": uniform_init(gen, lead + (m.n_routed, d, m.d_ff_expert), s_in, dtype),
        "wu": uniform_init(gen, lead + (m.n_routed, d, m.d_ff_expert), s_in, dtype),
        "wd": uniform_init(gen, lead + (m.n_routed, m.d_ff_expert, d), s_out, dtype),
    }
    if m.n_shared > 0:
        p["shared"] = mlp_init(gen, d, m.n_shared * m.d_ff_expert, "swiglu", dtype, lead)
    return p


def _top_k(probs, k):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(xg, router, m):
    """Router probabilities (float32), the top-k gates and expert indices."""
    logits = torch.matmul(xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, m.top_k)
    return probs, gate_vals, gate_idx


def moe_apply(x, p, cfg):
    """``x`` (b, s, d) -> (b, s, d).  Router in float32; experts in the
    compute dtype.  The dispatch, the experts' inputs and their outputs pass
    ``_constrain`` in the reference's shapes, (g, s, E, C) and (g, E, C, d)."""
    b, s, d = x.shape
    m = cfg.moe
    cd = as_dtype(cfg.compute_dtype)
    e_n, k = m.n_routed, m.top_k
    t = b * s
    gs = min(m.group_size, t)
    if t % gs:
        raise ValueError(f"token count {t} not divisible by MoE group size {gs}")
    g = t // gs
    xg = x.reshape(g, gs, d)

    # --- routing (float32)
    _, gate_vals, gate_idx = _route(xg, p["router"], m)                 # (g, s, k)
    gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True) + 1e-9)
    capacity = max(1, int(m.capacity_factor * gs * k / e_n))

    # --- position within expert, per group, over the flattened (s*k) choices
    onehot = _one_hot(gate_idx, e_n, torch.int32)                      # (g, s, k, E)
    flat = onehot.reshape(g, gs * k, e_n)
    pos_in_expert = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = torch.sum(pos_in_expert * flat, dim=-1, dtype=torch.int32).reshape(g, gs, k)
    keep = pos < capacity
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    # --- dispatch one-hots as dense products
    cap_oh = _one_hot(torch.where(keep, pos, capacity), capacity, cd)   # (g, s, k, C)
    oh_cd = onehot.to(cd)
    # einsum("gske,gskc->gsec"): (g*s, E, k) @ (g*s, k, C)
    disp = bdot(oh_cd.reshape(g * gs, k, e_n).mT, cap_oh.reshape(g * gs, k, capacity), cd)
    disp = _constrain(disp.to(cd).reshape(g, gs, e_n, capacity), ("data", None, "model", None),
                      cfg).reshape(g, gs, e_n * capacity)
    # einsum("gsec,gsd->gecd"): (g, E*C, s) @ (g, s, d)
    x_exp = bdot(disp.mT, xg.to(cd), cd).to(cd)                        # (g, E*C, d)
    x_exp = _constrain(x_exp.reshape(g, e_n, capacity, d), ("data", "model", None, None), cfg)
    x_exp = x_exp.permute(1, 0, 2, 3).reshape(e_n, g * capacity, d)

    # --- expert FFNs, batched over E
    g_act = bdot(x_exp, p["wg"], cd)                                   # (E, g*C, f)
    u_act = bdot(x_exp, p["wu"], cd)
    h = (F.silu(g_act) * u_act).to(cd)
    y_exp = bdot(h, p["wd"], cd).to(cd)                                 # (E, g*C, d)
    y_exp = _constrain(y_exp.reshape(e_n, g, capacity, d).permute(1, 0, 2, 3),
                       ("data", "model", None, None), cfg).reshape(g, e_n * capacity, d)

    # --- combine (dispatch weighted by gates): einsum("gske,gskc,gsk->gsec")
    gated = oh_cd * gate_vals.to(cd)[..., None]                         # (g, s, k, E)
    gate_disp = bdot(gated.reshape(g * gs, k, e_n).mT, cap_oh.reshape(g * gs, k, capacity), cd)
    gate_disp = gate_disp.to(cd).reshape(g, gs, e_n * capacity)
    y = bdot(gate_disp, y_exp, cd).to(cd)                               # (g, s, d)
    out = y.reshape(b, s, d).to(x.dtype)

    if m.n_shared > 0:
        out = out + mlp_apply(x, p["shared"], "swiglu", cd)
    return out


def moe_aux_loss(x, p, cfg):
    """Load-balance auxiliary loss (mean fraction * mean prob per expert)."""
    b, s, d = x.shape
    m = cfg.moe
    probs, _, idx = _route(x.reshape(1, b * s, d), p["router"], m)
    probs, idx = probs[0], idx[0]
    frac = torch.mean(_one_hot(idx, m.n_routed, torch.float32), dim=(0, 1))
    imp = torch.mean(probs, dim=0)
    return m.n_routed * torch.sum(frac * imp)
