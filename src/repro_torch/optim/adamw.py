"""AdamW with global-norm clipping (functions over parameter trees), in
PyTorch.

Counterpart of ``repro.optim.adamw``, with the same ``AdamWState`` layout
(``step``, ``m``, ``v``), so checkpoints carry over between the packages.
``step`` is a 0-dim int32 tensor kept on the CPU whatever the parameters'
device: the bias corrections are computed from it on the host in float32
and multiply the card's tensors as scalars, and the gradient norm and the
clip scale stay on the device, so an update makes no host wait.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-dim int32, on the CPU
    m: object           # tree like params, float32
    v: object


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(g.float()))
                                             for g in leaves])))


def bias_corrections(step: torch.Tensor, betas) -> tuple[torch.Tensor, torch.Tensor]:
    """``1 - beta ** step`` for both betas, float32 on the CPU."""
    t = step.to(torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    return (one - torch.tensor(betas[0], dtype=torch.float32) ** t,
            one - torch.tensor(betas[1], dtype=torch.float32) ** t)


def adamw_update(grads, state: AdamWState, params, *, lr, betas=(0.9, 0.95), eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0, donate: bool = False):
    """One AdamW step: ``(new_params, new_state, gnorm)``; ``gnorm`` is the
    pre-clip global norm, a 0-dim tensor on the gradients' device.
    ``donate``: ``params`` and the moments of ``state`` are updated in place
    and returned (the reference's jitted step donates them) by the same
    operations in the same order, so the same values."""
    b1, b2 = betas
    step = state.step + 1
    bc1, bc2 = bias_corrections(step, betas)

    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0) if grad_clip else None

    g_l, m_l, v_l, p_l = (tree_leaves(t) for t in (grads, state.m, state.v, params))
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(g_l, m_l, v_l, p_l):
        g = g.float() if scale is None else g.float() * scale
        pf = p.float()
        if donate:
            m2 = m.mul_(b1).add_((1 - b1) * g)
            v2 = v.mul_(b2).add_(((1 - b2) * g).mul_(g))
            delta = (m2 / bc1).div_((v2 / bc2).sqrt_().add_(eps)).add_(weight_decay * pf)
            delta.mul_(lr)
            new_p.append(p.sub_(delta) if pf is p else p.copy_(pf.sub_(delta)))
        else:
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            mhat = m2 / bc1
            vhat = v2 / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf
            new_p.append((pf - lr * delta).to(p.dtype))
        new_m.append(m2)
        new_v.append(v2)
    return (tree_unflatten(grads, new_p),
            AdamWState(step=step, m=tree_unflatten(grads, new_m), v=tree_unflatten(grads, new_v)),
            gnorm)
