"""Driver of a training cell: ``repro_torch.train.loop.train_step`` with
spectral-Adam on the configuration's dense decoder.

Set-up makes the weights, the warm trackers and the batches from the seed
(``perfbench.inputs.granite``), builds the optimizer state around them, and
drives that one state through the window's own call:

* steps 0-2 are the compared steps: after step 0 each leaf's first moment
  (the gradient as the optimizer got it), after each step the trackers' left
  bases (their column signs, for the reference), after step 2 each leaf's
  change from its start;
* step 3 reaches the first basis refresh (every ``basis_refresh_every``
  steps), so the window finds every path of a step warm.

The window runs steps until ``--seconds`` have passed, then synchronizes:
``train_tokens_per_s`` is every token of every step over all that time.
With ``--trace 1`` the window runs with CUDA events around the step's
pieces (the forward and backward, the optimizer, the trackers' update, the
refresh), and two more steps run under the profiler.

Once the window has closed and the peak memory is read, the program's state
is freed and the plain reference (``perfbench.reference.granite``) follows
the compared steps from the same seed.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time

import torch

from perfbench.harness.device import peak_bytes, sync
from perfbench.harness.host import collector_held
from perfbench.harness.trace import profile_stretch, span
from perfbench.inputs import derive_seed
from perfbench.inputs import granite as gin
from perfbench.reference import granite as ref

COMPARED = 3      # steps the reference follows
_STATE_GEN = 7    # derive_seed part of the optimizer state's own draws


def model_config(cfg: dict):
    """The port's ``ModelConfig`` from the configuration file's fields."""
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_leaf(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def build_state(cfg: dict, traffic: dict, params: dict, seed: int, device):
    """Spectral-Adam's state for ``params`` with the seeded warm trackers."""
    from repro_torch.optim import spectral_adam as SA

    rank = traffic["optimizer"]["spectral_rank"]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, _STATE_GEN))
    state = SA.spectral_adam_init(gen, params, rank=rank, device=device)
    for path, (u, s, v, pv) in gin.make_trackers(cfg, traffic, seed, device).items():
        (ls,) = _leaf(state.leaves, path)
        spec = ls.spectral
        spec = spec._replace(tracker=spec.tracker.replace(u=u, s=s, v=v), power_v=pv)
        _set_leaf(state.leaves, path, (ls._replace(spectral=spec),))
    return state


class StepTimers:
    """CUDA events around the pieces of a step, by wrapping the functions
    ``train_step`` calls (module attributes of the port), each inside a
    benchmark span.  ``split()``: per step, ms of each piece."""

    PIECES = (("loop", "loss_and_grads", "fwd_bwd"),
              ("loop", "spectral_adam_update", "optimizer"),
              ("spectral_adam", "spectral_update_basis_grouped", "trackers"),
              ("spectral_adam", "_refresh", "refresh"))

    def __init__(self):
        from repro_torch.optim import spectral_adam
        from repro_torch.train import loop

        self.mods = {"loop": loop, "spectral_adam": spectral_adam}
        self.saved = [getattr(self.mods[m], f) for m, f, _ in self.PIECES]
        self.marks: list = []

    def _wrap(self, label, fn):
        def timed(*args, **kwargs):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with span(label):
                e0.record()
                out = fn(*args, **kwargs)
                e1.record()
            self.marks.append((label, e0, e1))
            return out

        return timed

    def __enter__(self):
        for (m, f, label), fn in zip(self.PIECES, self.saved):
            setattr(self.mods[m], f, self._wrap(label, fn))
        return self

    def __exit__(self, *exc):
        for (m, f, _), fn in zip(self.PIECES, self.saved):
            setattr(self.mods[m], f, fn)

    def split(self) -> list[dict]:
        torch.cuda.synchronize()
        steps = []
        for label, e0, e1 in self.marks:
            if label == "fwd_bwd":
                steps.append({"fwd_bwd": 0.0, "optimizer": 0.0, "trackers": 0.0, "refresh": 0.0})
            steps[-1][label] += e0.elapsed_time(e1)
        return steps


def _flat_state_moments(state, paths) -> dict:
    return {p: _leaf(state.leaves, p)[0].m for p in paths}


def _tracker_u(state, paths) -> dict:
    return {p: _leaf(state.leaves, p)[0].spectral.tracker.u.detach().cpu() for p in paths}


def _tracker_usv(state, paths) -> dict:
    out = {}
    for p in paths:
        tr = _leaf(state.leaves, p)[0].spectral.tracker
        out[p] = tuple(x.detach().cpu() for x in (tr.u, tr.s, tr.v))
    return out


def program_readings(cfg: dict, traffic: dict, seed: int, device, api, opt):
    """Set-up: the program's state driven through the compared steps and the
    refresh by the window's own call, with the readings the reference is
    compared on.  Returns ``(params, state, batches, readings)``."""
    from repro_torch.train import loop

    b1 = traffic["optimizer"]["betas"][0]
    rank = traffic["optimizer"]["spectral_rank"]
    params = gin.make_weights(cfg, seed, device)
    state = build_state(cfg, traffic, params, seed, device)
    batches = gin.Batches(cfg, seed, device)
    paths = [p for p, _, _ in gin.leaf_specs(cfg)]
    tracked = [p for p, shape, _ in gin.leaf_specs(cfg) if gin.tracked(shape, rank)]
    readings = {"losses": [], "align": [], "seen_grad_norm": {}, "change_norm": {}}
    for t in range(COMPARED + 1):
        params, state, loss, _ = loop.train_step(api, opt, params, state, batches.next(), t,
                                                 spectral=True)
        if t < COMPARED:
            readings["losses"].append(loss)
            readings["align"].append(_tracker_u(state, tracked))
        if t == 0:
            for p, m in _flat_state_moments(state, paths).items():
                readings["seen_grad_norm"][p] = float(
                    torch.linalg.vector_norm(m.double())) / (1 - b1)
        if t == COMPARED - 1:
            flat = gin.flatten(params)
            for i, p in enumerate(paths):
                start = gin.make_leaf(cfg, seed, i, device)
                readings["change_norm"][p] = float(torch.linalg.vector_norm(
                    (flat[p] - start).double()))
                del start
            readings["trackers"] = _tracker_usv(state, tracked)
    readings["losses"] = [float(x) for x in readings["losses"]]
    return params, state, batches, readings


def leaf_gaps(prog: dict, refr: dict) -> dict:
    """Per leaf (``"/"``-joined path), the gaps ``compare`` takes the worst of."""
    out = {}
    for key in ("seen_grad_norm", "change_norm"):
        med = statistics.median(refr[key].values())
        out[key] = {"/".join(p): abs(prog[key][p] - w) / max(w, med)
                    for p, w in refr[key].items()}
    out["tracker"] = {"/".join(p): low_rank_gap(prog["trackers"][p], want)
                      for p, want in refr["trackers"].items()}
    out["tracker_sigma"] = {"/".join(p): float((prog["trackers"][p][1].double()
                                                - want[1].double()).abs().max() / want[1][0])
                            for p, want in refr["trackers"].items()}
    return out


def compare(prog: dict, refr: dict) -> dict:
    """The numbers ``correct`` is decided on (see the limits file):

    * ``loss``: each compared step's loss, the largest gap over the
      reference's, relative;
    * ``seen_grad``: each leaf's first gradient norm as the optimizer keeps
      it, the worst leaf's gap over the larger of its reference norm and the
      median leaf's;
    * ``change``: each leaf's change after the compared steps, the same way,
      over the leaves whose reference gradient is not nought to rounding
      (norm at least a thousandth of the median leaf's);
    * ``tracker_sigma``: each tracker's singular values after the compared
      steps, the largest gap over the reference's largest value.

    The gap of a tracker's ``U diag(s) V^T`` (``leaf_gaps``) is not
    compared: the port's float32 update leaves it at up to 0.16 on sound
    runs, within three times of what a tracker left unchanged reads (PERF.md
    section 7)."""
    gaps = leaf_gaps(prog, refr)
    gmed = statistics.median(refr["grad_norm"].values())
    moving = {"/".join(p) for p, g in refr["grad_norm"].items() if g >= 1e-3 * gmed}
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], refr["losses"])),
            "seen_grad": max(gaps["seen_grad_norm"].values()),
            "change": max(g for p, g in gaps["change_norm"].items() if p in moving),
            "tracker_sigma": max(gaps["tracker_sigma"].values(), default=0.0)}


def low_rank_gap(got, want) -> float:
    """``|U diag(s) V^T - U' diag(s') V'^T|_F / |U' diag(s') V'^T|_F`` from the
    factors alone, in float64."""
    (gu, gs, gv), (wu, ws, wv) = ([x.double() for x in t] for t in (got, want))

    def inner(au, as_, av, bu, bs, bv):
        return float(torch.sum((as_[:, None] * (au.mT @ bu) * bs[None, :]) * (av.mT @ bv)))

    gg, ww, gw = inner(gu, gs, gv, gu, gs, gv), inner(wu, ws, wv, wu, ws, wv), \
        inner(gu, gs, gv, wu, ws, wv)
    return math.sqrt(max(gg + ww - 2 * gw, 0.0) / ww)


def program(cfg: dict, traffic: dict):
    """The port's model API for the configuration (its parameter layout
    checked against the benchmark's inputs) and its ``OptimizerConfig``."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models.registry import build_model

    api = build_model(model_config(cfg))
    meta = gin.flatten(api.init(None, device="meta"))
    specs = {p: shape for p, shape, _ in gin.leaf_specs(cfg)}
    if {p: tuple(x.shape) for p, x in meta.items()} != specs:
        raise RuntimeError(f"the port's parameter layout {sorted(meta)} differs from the "
                           f"benchmark's inputs {sorted(specs)}")
    o = traffic["optimizer"]
    opt = OptimizerConfig(lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
                          weight_decay=o["weight_decay"], warmup_steps=o["warmup_steps"],
                          total_steps=o["total_steps"], spectral_rank=o["spectral_rank"],
                          basis_refresh_every=o["basis_refresh_every"])
    return api, opt


def run(ctx) -> dict:
    from repro_torch.train import loop

    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    api, opt = program(cfg, traffic)
    tokens_a_step = cfg["global_batch"] * cfg["seq_len"]

    params, state, batches, readings = program_readings(cfg, traffic, ctx.seed, dev, api, opt)
    holder = {"params": params, "state": state, "step": COMPARED + 1}
    del params, state

    def one_step():
        with span("step"):
            holder["params"], holder["state"], loss, _ = loop.train_step(
                api, opt, holder["params"], holder["state"], batches.next(), holder["step"],
                spectral=True)
        holder["step"] += 1
        return loss

    rec: dict = {"tokens_a_step": tokens_a_step, "model": cfg}
    losses = []
    timers = StepTimers() if ctx.trace else None
    sync(dev)
    if timers:
        timers.__enter__()
    try:
        with collector_held():
            t0 = time.perf_counter()
            ctx.window_start(t0)
            while time.perf_counter() - t0 < ctx.seconds:
                losses.append(one_step())
            sync(dev)
            t1 = time.perf_counter()
    finally:
        if timers:
            timers.__exit__()
    steps = len(losses)
    window = t1 - t0
    e2e = {"train_tokens_per_s": steps * tokens_a_step / window}
    rec.update(window_s=window, steps=steps, step_s=window / steps)
    ctx.log(f"window: {steps} steps in {window:.3f} s, {window / steps * 1e3:.1f} ms a step")
    trace = None
    if timers:
        rec["pieces"] = timers.split()
        with StepTimers():
            trace = profile_stretch(lambda: [one_step() for _ in range(traffic["trace_steps"])],
                                    ctx.trace_path)
    failed = sum(not math.isfinite(float(x)) for x in losses)
    peak = peak_bytes(dev)

    del holder, one_step, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    refr = ref.run_steps(cfg, traffic, ctx.seed, dev, COMPARED, align=readings["align"])
    nums = compare(readings, refr)
    ctx.log("program losses " + ", ".join(f"{x:.6f}" for x in readings["losses"])
            + " | reference " + ", ".join(f"{x:.6f}" for x in refr["losses"]))
    return {"e2e": e2e, "attempted": steps, "failed": failed, "numbers": nums,
            "memory_peak_bytes": peak, "rec": rec, "trace": trace}
