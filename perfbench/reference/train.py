"""Plain reference of a training cell's optimizer steps, for any model
reference (``reference.granite``, ``reference.deepseek_v2``) and its
inputs (``inputs.granite``, ``inputs.deepseek_v2``).

``traffic["optimizer"]["name"]`` picks the step:

* ``"spectral-adam"`` (the default): ``reference.granite``'s step, whose
  tracker update (``_track``) and schedule this module imports: every 2-D
  leaf whose smaller side exceeds four times the rank keeps a tracker and
  Adam's moments in its projected space; no clipping;
* ``"adamw"``: AdamW on every leaf after the gradients are scaled to a
  global norm of at most ``grad_clip`` (``min(1, clip / (norm + 1e-12))``,
  the port's ``OptimizerConfig.grad_clip``, 1.0 by default).

Returns what ``reference.granite.run_steps`` returns: the losses, each
leaf's first gradient norm (whole, and as the optimizer keeps it: its first
moment after step 1 over 1 - beta1, projected for a tracked leaf, clipped
under AdamW), each leaf's change after the steps, and the trackers after
the last step (none under AdamW).
"""

from __future__ import annotations

import torch

from perfbench.reference.granite import _track, full_float32, learning_rate


def run_steps(model, inputs, cfg: dict, traffic: dict, seed: int, device, steps: int, *,
              fmt: str = "bfloat16", align=None) -> dict:
    """``steps`` optimizer steps of ``model.loss_and_grads`` from the seeded
    ``inputs``.  ``align[t]``: ``{path: u}``, the left bases whose column
    signs step ``t`` adopts (spectral-Adam)."""
    opt = traffic["optimizer"]
    adamw = opt.get("name", "spectral-adam") == "adamw"
    b1, b2 = opt["betas"]
    eps, wd = opt["eps"], opt["weight_decay"]
    batches = inputs.Batches(cfg, seed, device)
    out = {"losses": [], "grad_norm": {}, "seen_grad_norm": {}, "change_norm": {}}
    with full_float32(), torch.no_grad():
        params = inputs.flatten(inputs.make_weights(cfg, seed, device))
        trackers = {} if adamw else inputs.make_trackers(cfg, traffic, seed, device)
        m = dict.fromkeys(params)
        v = dict.fromkeys(params)
        for t in range(steps):
            with torch.enable_grad():
                value, grads = model.loss_and_grads(inputs.nest(params), batches.next(), cfg, fmt)
            out["losses"].append(float(value))
            lr = learning_rate(t, opt)
            bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            if adamw:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
                scale = torch.clamp(opt.get("grad_clip", 1.0) / (norm + 1e-12), max=1.0)
            for path, g in grads.items():
                if t == 0:
                    out["grad_norm"][path] = float(torch.linalg.vector_norm(g.double()))
                if adamw:
                    g = g * scale
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
        for i, (path, _, _) in enumerate(inputs.leaf_specs(cfg)):
            start = inputs.make_leaf(cfg, seed, i, device)
            out["change_norm"][path] = float(torch.linalg.vector_norm(
                (params[path] - start).double()))
            del start
    out["trackers"] = {p: tuple(x.cpu() for x in tr[:3]) for p, tr in trackers.items()}
    return out
