"""Driver of a training cell on any configuration the benchmark has inputs
and a plain reference for: ``repro_torch.train.loop.train_step`` with the
traffic's optimizer.

* The configuration's ``inputs`` key names ``perfbench.inputs.<name>`` and
  ``perfbench.reference.<name>`` (``granite`` when the file has none).  A
  file with the published config's keys (``model_type`` ``deepseek_v2``) is
  turned into the port's ``ModelConfig`` by ``model_config``, which refuses
  every key it does not know and every value the port does not build, so a
  port without the options fails at once; a file of the port's own fields
  (granite) is taken field by field, unknown keys refused too.
* The traffic's ``optimizer.name`` is ``spectral-adam`` (warm trackers from
  ``tracker_spectrum``, as ``drivers/train_step.py``) or ``adamw`` (the
  port's global-norm clipping, ``grad_clip``); ``donate`` true runs each step
  with ``train_step(..., donate=True)`` (the parameters and moments updated in
  place, as the reference's jitted step donates them).

Set-up makes the weights, the optimizer state and the batches from the
seed and drives that one state through ``COMPARED`` compared steps and one
more (the first basis refresh under spectral-Adam) by the window's own
call.  The window runs steps until ``--seconds`` have passed, then
synchronizes: ``train_tokens_per_s`` is every token of every step over all
that time.  With ``--trace 1``, after the window, on the same state:

* ``span_steps`` steps with the program's device-timed spans
  (``obs.start_tracing(device=True)``) and ``obs`` enabled, no profiler:
  ``rec["program_spans"]`` (each step's device ms by span name) and the MoE
  layers' counters (``rec["moe_counters"]``);
* ``trace_steps`` steps under the profiler with the program's spans on, the
  process's first profiler session: the benchmark's trace
  (``harness.trace``, ``device_idle.train``) and ``rec["program_trace"]``
  (``harness.program_trace``) from the one Chrome trace.

Then the peak memory is read, the program's state is freed, and the plain
reference follows the compared steps from the same seed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import time

import torch

from perfbench.harness import manifest
from perfbench.harness.device import peak_bytes, sync
from perfbench.harness.host import collector_held
from perfbench.harness.program_stretch import _by_step
from perfbench.harness.program_trace import reduce_program_trace
from perfbench.harness.trace import profile_stretch, span
from perfbench.inputs import derive_seed
from perfbench.reference import train as rtrain

COMPARED = 3      # steps the reference follows
_STATE_GEN = 7    # derive_seed part of the optimizer state's own draws

# keys of a configuration file that describe it and set nothing in the port
_ABOUT = frozenset({"name", "source", "paper", "inputs", "published", "reduced", "assumed",
                    "departures", "deployment", "port_config", "global_batch", "seq_len"})


def modules(cfg: dict):
    """``(inputs, reference)`` modules of the configuration."""
    name = cfg.get("inputs", "granite")
    return (importlib.import_module(f"perfbench.inputs.{name}"),
            importlib.import_module(f"perfbench.reference.{name}"))


def _port_fields(cfg: dict):
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(cfg) - names - _ABOUT)
    if unknown:
        raise ValueError(f"configuration keys the port does not know: {unknown}")
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def _require(cfg: dict, key: str, want) -> None:
    if cfg[key] != want:
        raise ValueError(f"{key} = {cfg[key]!r}: the port builds {want!r} only")


def _deepseek_v2(cfg: dict):
    """The port's ``ModelConfig`` of a DeepSeek-V2 config file (the published
    keys, ``expert_parallel`` and the run's settings)."""
    from repro_torch.configs.base import (
        MLAPortConfig,
        ModelConfig,
        MoEPortConfig,
        YarnConfig,
    )

    fixed = {"model_type": "deepseek_v2", "attention_bias": False, "q_lora_rank": None,
             "hidden_act": "silu", "scoring_func": "softmax", "topk_method": "greedy",
             "n_group": 1, "topk_group": 1, "moe_layer_freq": 1, "routed_scaling_factor": 1,
             "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "seq_aux": True}
    used = set(fixed) | {
        "hidden_size", "num_attention_heads", "num_key_value_heads", "intermediate_size",
        "num_hidden_layers", "vocab_size", "rope_theta", "kv_lora_rank", "qk_nope_head_dim",
        "qk_rope_head_dim", "v_head_dim", "rope_scaling", "first_k_dense_replace",
        "moe_intermediate_size", "n_routed_experts", "n_shared_experts",
        "num_experts_per_tok", "norm_topk_prob", "max_position_embeddings",
        "expert_parallel", "aux_loss_alpha", "capacity_factor", "moe_group_size",
        "vocab_pad_to", "compute_dtype", "param_dtype", "remat", "remat_policy"}
    unknown = sorted(set(cfg) - used - _ABOUT)
    if unknown:
        raise ValueError(f"configuration keys the port does not know: {unknown}")
    for key, want in fixed.items():
        _require(cfg, key, want)
    if cfg["seq_len"] > cfg["max_position_embeddings"]:
        raise ValueError("seq_len past max_position_embeddings")
    sc = dict(cfg["rope_scaling"])
    if sc.pop("type") != "yarn":
        raise ValueError(f"rope_scaling type {cfg['rope_scaling']['type']!r}: the port has yarn")
    yarn = YarnConfig(factor=sc.pop("factor"),
                      original_max_position=sc.pop("original_max_position_embeddings"),
                      beta_fast=sc.pop("beta_fast"), beta_slow=sc.pop("beta_slow"),
                      mscale=sc.pop("mscale"), mscale_all_dim=sc.pop("mscale_all_dim"))
    if sc:
        raise ValueError(f"rope_scaling keys the port does not know: {sorted(sc)}")
    ep = dict(cfg["expert_parallel"])
    chips, rank, routed = ep.pop("chips"), ep.pop("rank"), ep.pop("routed_experts")
    ep.pop("vocab_size")
    held = cfg["n_routed_experts"]
    if ep or chips * held != routed or not 0 <= rank < chips:
        raise ValueError(f"expert_parallel {cfg['expert_parallel']} does not divide "
                         f"{routed} experts into {held} a chip")
    moe = MoEPortConfig(n_routed=routed, n_shared=cfg["n_shared_experts"],
                        top_k=cfg["num_experts_per_tok"],
                        d_ff_expert=cfg["moe_intermediate_size"],
                        capacity_factor=cfg["capacity_factor"],
                        group_size=cfg["moe_group_size"], n_held=held, held_start=rank * held,
                        norm_topk=cfg["norm_topk_prob"],
                        first_dense=cfg["first_k_dense_replace"],
                        seq_aux_alpha=cfg["aux_loss_alpha"])
    mla = MLAPortConfig(kv_lora_rank=cfg["kv_lora_rank"],
                        qk_nope_head_dim=cfg["qk_nope_head_dim"],
                        qk_rope_head_dim=cfg["qk_rope_head_dim"],
                        v_head_dim=cfg["v_head_dim"], yarn=yarn)
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], mlp_type="swiglu", norm_type="rmsnorm",
        rope_theta=float(cfg["rope_theta"]), tie_embeddings=False,
        vocab_pad_to=cfg["vocab_pad_to"], moe=moe, mla=mla,
        compute_dtype=cfg["compute_dtype"], param_dtype=cfg["param_dtype"],
        remat=cfg["remat"], remat_policy=cfg["remat_policy"])


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of the configuration file (module docstring)."""
    if cfg.get("model_type") == "deepseek_v2":
        return _deepseek_v2(cfg)
    return _port_fields(cfg)


def spectral(traffic: dict) -> bool:
    name = traffic["optimizer"].get("name", "spectral-adam")
    if name not in ("spectral-adam", "adamw"):
        raise ValueError(f"optimizer {name!r}: spectral-adam or adamw")
    return name == "spectral-adam"


def program(cfg: dict, traffic: dict):
    """The port's model API for the configuration (its parameter layout
    checked against the benchmark's inputs) and its ``OptimizerConfig``."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models.registry import build_model

    inputs, _ = modules(cfg)
    api = build_model(model_config(cfg))
    meta = inputs.flatten(api.init(None, device="meta"))
    specs = {p: shape for p, shape, _ in inputs.leaf_specs(cfg)}
    if {p: tuple(x.shape) for p, x in meta.items()} != specs:
        raise RuntimeError(f"the port's parameter layout {sorted(meta)} differs from the "
                           f"benchmark's inputs {sorted(specs)}")
    o = traffic["optimizer"]
    kw = dict(lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"], weight_decay=o["weight_decay"],
              warmup_steps=o["warmup_steps"], total_steps=o["total_steps"])
    if spectral(traffic):
        kw.update(spectral_rank=o["spectral_rank"], basis_refresh_every=o["basis_refresh_every"])
    else:
        kw.update(grad_clip=o.get("grad_clip", 1.0))
    return api, OptimizerConfig(**kw)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_leaf(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def build_state(cfg: dict, traffic: dict, params: dict, seed: int, device):
    """The optimizer's state for ``params``: spectral-Adam's with the seeded
    warm trackers, or AdamW's."""
    if not spectral(traffic):
        from repro_torch.optim.adamw import adamw_init

        return adamw_init(params)
    from repro_torch.optim import spectral_adam as SA

    inputs, _ = modules(cfg)
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, _STATE_GEN))
    state = SA.spectral_adam_init(gen, params, rank=traffic["optimizer"]["spectral_rank"],
                                  device=device)
    for path, (u, s, v, pv) in inputs.make_trackers(cfg, traffic, seed, device).items():
        (ls,) = _leaf(state.leaves, path)
        spec = ls.spectral
        spec = spec._replace(tracker=spec.tracker.replace(u=u, s=s, v=v), power_v=pv)
        _set_leaf(state.leaves, path, (ls._replace(spectral=spec),))
    return state


def _moments(state, paths) -> dict:
    """Each leaf's first moment, AdamW's or spectral-Adam's."""
    if hasattr(state, "m"):
        return {p: _leaf(state.m, p) for p in paths}
    return {p: _leaf(state.leaves, p)[0].m for p in paths}


def _trackers(state, paths) -> dict:
    out = {}
    for p in paths:
        tr = _leaf(state.leaves, p)[0].spectral.tracker
        out[p] = tuple(x.detach().cpu() for x in (tr.u, tr.s, tr.v))
    return out


class Stepper:
    """The program's state and ``train_step`` on it, one batch after another."""

    def __init__(self, cfg, traffic, seed, device, api, opt):
        from repro_torch.train import loop

        inputs, _ = modules(cfg)
        self.loop, self.api, self.opt = loop, api, opt
        self.params = inputs.make_weights(cfg, seed, device)
        self.state = build_state(cfg, traffic, self.params, seed, device)
        self.batches = inputs.Batches(cfg, seed, device)
        self.spectral = spectral(traffic)
        self.kw = {"donate": True} if traffic.get("donate") else {}
        self.step = 0

    def __call__(self):
        self.params, self.state, loss, _ = self.loop.train_step(
            self.api, self.opt, self.params, self.state, self.batches.next(), self.step,
            spectral=self.spectral, **self.kw)
        self.step += 1
        return loss


def program_readings(cfg: dict, traffic: dict, seed: int, device, api, opt):
    """Set-up: the program's state driven through the compared steps and one
    more by the window's own call, with the readings the reference is
    compared on.  Returns ``(stepper, readings)``."""
    inputs, _ = modules(cfg)
    b1 = traffic["optimizer"]["betas"][0]
    st = Stepper(cfg, traffic, seed, device, api, opt)
    paths = [p for p, _, _ in inputs.leaf_specs(cfg)]
    rank = traffic["optimizer"].get("spectral_rank", 0)
    tracked = [p for p, shape, _ in inputs.leaf_specs(cfg)
               if st.spectral and inputs.tracked(shape, rank)]
    readings = {"losses": [], "align": [], "seen_grad_norm": {}, "change_norm": {}}
    for t in range(COMPARED + 1):
        loss = st()
        if t < COMPARED:
            readings["losses"].append(loss)
            readings["align"].append({p: _leaf(st.state.leaves, p)[0].spectral.tracker.u
                                      .detach().cpu() for p in tracked})
        if t == 0:
            for p, m in _moments(st.state, paths).items():
                readings["seen_grad_norm"][p] = float(
                    torch.linalg.vector_norm(m.double())) / (1 - b1)
        if t == COMPARED - 1:
            flat = inputs.flatten(st.params)
            for i, p in enumerate(paths):
                start = inputs.make_leaf(cfg, seed, i, device)
                readings["change_norm"][p] = float(torch.linalg.vector_norm(
                    (flat[p] - start).double()))
                del start
            readings["trackers"] = _trackers(st.state, tracked)
    readings["losses"] = [float(x) for x in readings["losses"]]
    return st, readings


def compare(prog: dict, refr: dict, traffic: dict) -> dict:
    """The numbers ``correct`` is decided on: ``drivers/train_step.py``'s
    ``compare`` (``loss``, ``seen_grad``, ``change``, ``tracker_sigma``), the
    last left out under AdamW (no trackers)."""
    nums = manifest.driver("train_step").compare(prog, refr)
    if not spectral(traffic):
        del nums["tracker_sigma"]
    return nums


def reference(cfg: dict, traffic: dict, seed: int, device, *, fmt="bfloat16", align=None):
    inputs, model = modules(cfg)
    return rtrain.run_steps(model, inputs, cfg, traffic, seed, device, COMPARED, fmt=fmt,
                            align=align)


def _program_spans(stepper, n: int) -> dict:
    """``n`` steps with the program's device-timed spans and ``obs`` enabled
    (the MoE layers' counters), no profiler; a program without device-timed
    spans gives nothing."""
    from repro_torch import obs

    if not hasattr(obs, "device_times"):
        return {}
    obs.clear_trace()
    was = obs.enabled()
    obs.enable()
    try:
        with collector_held():
            obs.start_tracing(device=True)
            for _ in range(n):
                stepper()
            obs.stop_tracing()
        out = {"program_spans": _by_step(obs.device_times()),
               "dropped": obs.dropped_events()}
        from repro_torch.models import moe

        if hasattr(moe, "read_counters"):
            out["moe_counters"] = moe.read_counters()
    finally:
        obs.stop_tracing()
        obs.clear_trace()
        if not was:
            obs.disable()
    return out


def _profiled(stepper, n: int, path) -> tuple:
    """``n`` steps under the profiler with the program's spans on: the
    benchmark's reduced trace and the program's."""
    from repro_torch import obs

    obs.clear_trace()
    obs.start_tracing()
    try:
        trace = profile_stretch(lambda: [stepper() for _ in range(n)], path)
    finally:
        obs.stop_tracing()
        dropped = obs.dropped_events()
        obs.clear_trace()
    with open(path) as f:
        prog = reduce_program_trace(json.load(f))
    return trace, prog, dropped


def run(ctx) -> dict:
    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    api, opt = program(cfg, traffic)
    tokens_a_step = cfg["global_batch"] * cfg["seq_len"]

    stepper, readings = program_readings(cfg, traffic, ctx.seed, dev, api, opt)

    def one_step():
        with span("step"):
            return stepper()

    rec: dict = {"tokens_a_step": tokens_a_step, "model": cfg}
    losses = []
    sync(dev)
    with collector_held():
        t0 = time.perf_counter()
        ctx.window_start(t0)
        while time.perf_counter() - t0 < ctx.seconds:
            losses.append(one_step())
        sync(dev)
        t1 = time.perf_counter()
    steps = len(losses)
    window = t1 - t0
    e2e = {"train_tokens_per_s": steps * tokens_a_step / window}
    rec.update(window_s=window, steps=steps, step_s=window / steps)
    ctx.log(f"window: {steps} steps in {window:.3f} s, {window / steps * 1e3:.1f} ms a step")
    trace = None
    if ctx.trace:
        spans = _program_spans(stepper, traffic["span_steps"])
        rec.update(spans)
        trace, prog_trace, dropped = _profiled(stepper, traffic["trace_steps"], ctx.trace_path)
        if "program_spans" in spans:
            rec["program_trace"] = prog_trace
            rec["dropped"] = rec.get("dropped", 0) + dropped
    failed = sum(not math.isfinite(float(x)) for x in losses)
    peak = peak_bytes(dev)
    ctx.log(f"peak {peak / 1e9:.2f} GB")

    del stepper, one_step, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    refr = reference(cfg, traffic, ctx.seed, dev, align=readings["align"] or None)
    nums = compare(readings, refr, traffic)
    ctx.log("program losses " + ", ".join(f"{x:.6f}" for x in readings["losses"])
            + " | reference " + ", ".join(f"{x:.6f}" for x in refr["losses"]))
    return {"e2e": e2e, "attempted": steps, "failed": failed, "numbers": nums,
            "memory_peak_bytes": peak, "rec": rec, "trace": trace}
