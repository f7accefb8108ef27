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

``MoEPortConfig`` adds an expert share (the layer holds ``n_held`` of the
``n_routed`` experts, routes over all of them and computes its own experts'
part: one device of an expert-parallel group, without the exchange),
unnormalised top-k gates and DeepSeek-V2's sequence-wise balance loss
(``moe_apply``'s second output).  With ``obs`` enabled the layer counts, on the card,
the choices routed to its experts and those dropped over capacity
(``read_counters``); disabled, nothing is counted or read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs as _obs
from repro_torch.models.layers import as_dtype, bdot, mlp_apply, mlp_init, uniform_init
from repro_torch.obs.trace import span

__all__ = ["moe_init", "moe_apply", "moe_aux_loss", "read_counters"]

_COUNTS: dict = {}   # device -> int64 (2,): choices routed to held experts, dropped of them


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
    float32 whatever ``dtype`` and has ``n_routed`` outputs; the experts'
    weights are the held experts' (``_held``)."""
    lead = tuple(lead)
    d, m = cfg.d_model, cfg.moe
    e_h = _held(m)[1]
    s_in = (1.0 / d) ** 0.5
    s_out = (1.0 / m.d_ff_expert) ** 0.5
    p = {
        "router": uniform_init(gen, lead + (d, m.n_routed), s_in, torch.float32),
        "wg": uniform_init(gen, lead + (e_h, d, m.d_ff_expert), s_in, dtype),
        "wu": uniform_init(gen, lead + (e_h, d, m.d_ff_expert), s_in, dtype),
        "wd": uniform_init(gen, lead + (e_h, m.d_ff_expert, d), s_out, dtype),
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


def _held(m) -> tuple[int, int]:
    """``(first, count)`` of the experts this layer holds
    (``MoEPortConfig``'s share; all of them for a plain ``MoEConfig``)."""
    return getattr(m, "held_start", 0), getattr(m, "n_held", 0) or m.n_routed


def _recomputing() -> bool:
    """Whether this forward runs inside a backward (activation
    checkpointing's recompute), where the counters have counted already."""
    node = getattr(torch._C, "_current_autograd_node", None)
    return node is not None and node() is not None


def _count(in_held, keep) -> None:
    """Add a forward's choices routed to held experts and those of them
    dropped over capacity to the device's counters (no host read)."""
    if not _obs.enabled() or _recomputing():
        return
    acc = _COUNTS.get(in_held.device)
    if acc is None:
        acc = _COUNTS[in_held.device] = torch.zeros(2, dtype=torch.int64, device=in_held.device)
    acc += torch.stack([torch.sum(in_held, dtype=torch.int64),
                        torch.sum(in_held & ~keep, dtype=torch.int64)])


def read_counters() -> dict:
    """``{"routed_held", "dropped"}``: the choices routed to held experts and
    those dropped over capacity, counted while ``obs`` was enabled (the
    remat recompute not counted) since the last read, summed over devices.
    One host read a device; the counts are reset and added to the obs
    registry's counters ``moe_routed_held`` and ``moe_dropped``."""
    routed = dropped = 0
    for acc in _COUNTS.values():
        r, d = acc.tolist()
        acc.zero_()
        routed, dropped = routed + r, dropped + d
    reg = _obs.registry()
    reg.counter("moe_routed_held").inc(routed)
    reg.counter("moe_dropped").inc(dropped)
    return {"routed_held": routed, "dropped": dropped}


def _seq_aux(probs, gate_idx, b, s, m):
    """DeepSeek-V2's sequence-wise balance loss: ``alpha`` times the mean over
    sequences of ``sum_e f_e P_e``, ``f_e`` the sequence's choices of expert
    ``e`` over ``s k / E``, ``P_e`` its mean router probability (the counts
    carry no gradient)."""
    e_n, k = m.n_routed, m.top_k
    counts = torch.sum(_one_hot(gate_idx.reshape(b, s * k), e_n, torch.float32), dim=1)
    f = counts / (s * k / e_n)
    return m.seq_aux_alpha * torch.mean(torch.sum(f * torch.mean(probs.reshape(b, s, e_n), 1), -1))


def moe_apply(x, p, cfg):
    """``x`` (b, s, d) -> ``(out (b, s, d), aux)``, ``aux`` the sequence-wise
    balance loss (a float32 scalar, zero unless ``MoEPortConfig.seq_aux_alpha``
    is set).  Router in float32; experts in the compute dtype.  The dispatch,
    the experts' inputs and their outputs pass ``_constrain`` in the
    reference's shapes, (g, s, E, C) and (g, E, C, d), E the experts held.
    Spans: ``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
    ``moe.shared``."""
    b, s, d = x.shape
    m = cfg.moe
    cd = as_dtype(cfg.compute_dtype)
    e_n, k = m.n_routed, m.top_k
    start, e_h = _held(m)
    t = b * s
    gs = min(m.group_size, t)
    if t % gs:
        raise ValueError(f"token count {t} not divisible by MoE group size {gs}")
    g = t // gs
    xg = x.reshape(g, gs, d)

    # --- routing (float32), over all n_routed experts
    with span("moe.route"):
        probs, gate_vals, gate_idx = _route(xg, p["router"], m)          # (g, s, k)
        if getattr(m, "norm_topk", True):
            gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True) + 1e-9)
        capacity = max(1, int(m.capacity_factor * gs * k / e_n))
        alpha = getattr(m, "seq_aux_alpha", 0.0)
        aux = (_seq_aux(probs, gate_idx, b, s, m) if alpha
               else torch.zeros((), dtype=torch.float32, device=x.device))

    with span("moe.dispatch"):
        # --- position within each held expert, per group, over the flattened
        # (s*k) choices; a choice of an expert not held is a zero row
        local = gate_idx - start if start else gate_idx
        onehot = _one_hot(local, e_h, torch.int32)                     # (g, s, k, E)
        flat = onehot.reshape(g, gs * k, e_h)
        pos_in_expert = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
        pos = torch.sum(pos_in_expert * flat, dim=-1, dtype=torch.int32).reshape(g, gs, k)
        keep = pos < capacity
        if _obs.enabled():
            _count((local >= 0) & (local < e_h), keep)
        gate_vals = gate_vals * keep.to(gate_vals.dtype)

        # --- dispatch one-hots as dense products
        cap_oh = _one_hot(torch.where(keep, pos, capacity), capacity, cd)   # (g, s, k, C)
        oh_cd = onehot.to(cd)
        # einsum("gske,gskc->gsec"): (g*s, E, k) @ (g*s, k, C)
        disp = bdot(oh_cd.reshape(g * gs, k, e_h).mT, cap_oh.reshape(g * gs, k, capacity), cd)
        disp = _constrain(disp.to(cd).reshape(g, gs, e_h, capacity),
                          ("data", None, "model", None), cfg).reshape(g, gs, e_h * capacity)
        # einsum("gsec,gsd->gecd"): (g, E*C, s) @ (g, s, d)
        x_exp = bdot(disp.mT, xg.to(cd), cd).to(cd)                    # (g, E*C, d)
        x_exp = _constrain(x_exp.reshape(g, e_h, capacity, d), ("data", "model", None, None),
                           cfg)
        x_exp = x_exp.permute(1, 0, 2, 3).reshape(e_h, g * capacity, d)

    # --- expert FFNs, batched over E
    with span("moe.experts"):
        g_act = bdot(x_exp, p["wg"], cd)                               # (E, g*C, f)
        u_act = bdot(x_exp, p["wu"], cd)
        h = (F.silu(g_act) * u_act).to(cd)
        y_exp = bdot(h, p["wd"], cd).to(cd)                             # (E, g*C, d)
        y_exp = _constrain(y_exp.reshape(e_h, g, capacity, d).permute(1, 0, 2, 3),
                           ("data", "model", None, None), cfg).reshape(g, e_h * capacity, d)

    # --- combine (dispatch weighted by gates): einsum("gske,gskc,gsk->gsec")
    with span("moe.combine"):
        gated = oh_cd * gate_vals.to(cd)[..., None]                     # (g, s, k, E)
        gate_disp = bdot(gated.reshape(g * gs, k, e_h).mT,
                         cap_oh.reshape(g * gs, k, capacity), cd)
        gate_disp = gate_disp.to(cd).reshape(g, gs, e_h * capacity)
        y = bdot(gate_disp, y_exp, cd).to(cd)                           # (g, s, d)
        out = y.reshape(b, s, d).to(x.dtype)

    if m.n_shared > 0:
        with span("moe.shared"):
            out = out + mlp_apply(x, p["shared"], "swiglu", cd)
    return out, aux


def moe_aux_loss(x, p, cfg):
    """Load-balance auxiliary loss (mean fraction * mean prob per expert)."""
    b, s, d = x.shape
    m = cfg.moe
    probs, _, idx = _route(x.reshape(1, b * s, d), p["router"], m)
    probs, idx = probs[0], idx[0]
    frac = torch.mean(_one_hot(idx, m.n_routed, torch.float32), dim=(0, 1))
    imp = torch.mean(probs, dim=0)
    return m.n_routed * torch.sum(frac * imp)
