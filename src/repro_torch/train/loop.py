"""Training loop: the step, auto-resume, straggler hooks, metrics, in PyTorch.

Counterpart of ``repro.train.loop``.  Composes the model (``models.registry``),
the optimizer (AdamW, or spectral-Adam when ``spectral_rank > 0``), the
warmup-cosine schedule, the deterministic data stream and the atomic
checkpoints of ``train.checkpoint``, in the reference's layout, so a
checkpoint either package's ``train`` wrote resumes in the other.

* Every ``checkpoint_every`` steps an atomic checkpoint of ``(params,
  opt_state)`` is written, and a final one at the end; on start the loop
  resumes from the latest COMPLETE one.
* The data stream is a pure function of the step, so a resumed run
  continues with the same batches.
* A step reads nothing back from the card unless it logs (every
  ``log_every`` steps and the last one: the loss and the gradient norm) or
  saves; the straggler watchdog (``straggler_timeout_s``) times the host's
  side of each step, as the reference's does, records slow steps and calls
  ``on_straggler(step, seconds)``.

As in the reference, the optimizer state is restored in AdamW's layout
before the spectral state is built, so resuming a spectral-Adam run raises
the checkpoint's ``ValueError`` (ROADMAP queue C).  ``spectral_params`` is
accepted and unused, as in the reference.

Under ``mesh=`` (a ``dist.Mesh`` with a ``data`` axis) the parameters and
AdamW's moments are placed by ``train.elastic.reshard``, and a step splits
its batch over the ``data`` entries (``dist.sharding.batch_pspecs``):
contiguous slices, each run forward and backward on its entry's device
(``Mesh.batch_devices``), the slices' losses and gradients averaged in a
fixed order on the parameters' device, then one optimizer update there
(``mesh_loss_and_grads``).  The loss is a token mean and the slices are
equal, so this is the global step's math, which the reference's GSPMD step
keeps.  Where it would not be, the step raises rather than compute something
else: a batch that the ``data`` axis does not divide (the reference's jit
raises the same ``ValueError``), and an MoE config whose dispatch groups a
slice would not hold whole (a group of ``min(group_size, tokens)`` tokens
sets the capacity).  As in the reference, a mesh places the optimizer state
by AdamW's specs only, so ``spectral_rank > 0`` with a mesh raises a
``ValueError`` at the first step (ROADMAP queue C).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.api.state import resolve_device
from repro_torch.configs.base import OptimizerConfig, RunConfig
from repro_torch.data.synthetic import batch_for_step
from repro_torch.dist.mesh import check_mesh
from repro_torch.dist.sharding import batch_pspecs
from repro_torch.models.registry import ModelApi, build_model
from repro_torch.obs.trace import span
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim.spectral_adam import spectral_adam_init, spectral_adam_update
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import reshard

__all__ = ["TrainResult", "loss_and_grads", "mesh_loss_and_grads", "train", "train_step"]


@dataclass
class TrainResult:
    final_step: int
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    resumed_from: int | None = None
    straggler_events: list = field(default_factory=list)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def loss_and_grads(api: ModelApi, params, batch):
    """``(loss, grads)`` of ``api.train_loss`` at ``params`` (the reference's
    ``jax.value_and_grad``); the parameters themselves are not modified."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = api.train_loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def _slices(api: ModelApi, batch: dict, specs: dict, n: int) -> int:
    """Rows of each of ``n`` equal slices of ``batch`` over the ``data``
    axis (``specs``: its ``batch_pspecs``); raises where the split would
    change the step's math."""
    lead = {k: x.shape[0] for k, x in batch.items() if specs[k]}
    for k, b in lead.items():
        if b % n:
            raise ValueError(f"batch[{k!r}] of shape {tuple(batch[k].shape)} is split over the "
                             f"mesh's data axis: the global size of its dimension 0 should be "
                             f"divisible by {n}, but it is equal to {b}")
    cfg = api.cfg
    if cfg.moe is not None:
        b, s = batch["tokens"].shape[:2]
        s += cfg.n_frontend_tokens if cfg.frontend == "vision" and "patches" in batch else 0
        gs = min(cfg.moe.group_size, b * s)
        if (b * s // n) % gs:
            raise ValueError(f"MoE dispatch groups of {gs} tokens (group_size "
                             f"{cfg.moe.group_size}, {b * s} tokens in the batch) do not fit "
                             f"whole in a slice of {b * s // n} tokens over {n} data entries; "
                             f"the slices would change the groups and the capacity")
    return next(iter(lead.values())) // n


def _accumulate(acc, x, home):
    """``acc + x`` leaf by leaf on ``home`` (the first slice starts the sum)."""
    if acc is None:
        return tree_map(lambda a: a.to(home), x)
    return tree_map(lambda a, b: a.add_(b.to(home)), acc, x)


def _average(acc, n: int):
    return tree_map(lambda a: a.div_(n), acc)


def mesh_loss_and_grads(api: ModelApi, params, batch, mesh):
    """``loss_and_grads`` with the batch split over ``mesh``'s ``data`` axis:
    each entry's slice forward and backward on its device, the losses and
    gradients summed in the entries' order on the parameters' device and
    divided by the number of entries (see the module docstring)."""
    devs = check_mesh(mesh).batch_devices("data")
    specs = batch_pspecs(batch)
    per = _slices(api, batch, specs, len(devs))
    home = tree_leaves(params)[0].device
    loss = grads = None
    for j, dev in enumerate(devs):
        part = {k: (x[j * per:(j + 1) * per] if specs[k] else x).to(dev) for k, x in batch.items()}
        p_dev = params if dev == home else tree_map(lambda x, d=dev: x.to(d), params)
        lj, gj = loss_and_grads(api, p_dev, part)
        loss, grads = _accumulate(loss, lj, home), _accumulate(grads, gj, home)
    return _average(loss, len(devs)), _average(grads, len(devs))


def train_step(api: ModelApi, opt: OptimizerConfig, params, opt_state, batch, step: int, *,
               spectral: bool, mesh=None, donate: bool = False):
    """One step of ``train``: ``(params, opt_state, loss, gnorm)``, the loss and
    the pre-clip gradient norm as 0-dim tensors on the card (nothing is read
    back).  The spectral path does not clip, as in the reference.  With
    ``mesh`` the batch is split over its ``data`` axis
    (``mesh_loss_and_grads``).  ``donate``: ``params`` and ``opt_state``'s
    moments are updated in place and returned, as the reference's jitted step
    donates them (the same values; the update then holds one copy of each
    instead of two).  Spans (``obs``): ``train_step`` around it all,
    ``fwd_bwd`` and ``optimizer`` around its two parts."""
    with span("train_step"):
        with span("fwd_bwd"):
            if mesh is None:
                loss, grads = loss_and_grads(api, params, batch)
            else:
                loss, grads = mesh_loss_and_grads(api, params, batch, mesh)
        lr = warmup_cosine(step, base_lr=opt.lr, warmup_steps=opt.warmup_steps,
                           total_steps=opt.total_steps)
        with torch.no_grad():
            if spectral:
                # basis_refresh_every: the local re-factorisation (no group: the
                # gradients are already the global ones)
                with span("optimizer"):
                    new_params, new_state = spectral_adam_update(
                        grads, opt_state, params, lr=lr, betas=opt.betas, eps=opt.eps,
                        weight_decay=opt.weight_decay,
                        basis_refresh_every=opt.basis_refresh_every, donate=donate)
                gnorm = global_norm(grads)
            else:
                with span("optimizer"):
                    new_params, new_state, gnorm = adamw_update(
                        grads, opt_state, params, lr=lr, betas=opt.betas, eps=opt.eps,
                        weight_decay=opt.weight_decay, grad_clip=opt.grad_clip,
                        donate=donate)
    return new_params, new_state, loss, gnorm


def train(
    run: RunConfig,
    *,
    batch_size: int,
    seq_len: int,
    device=None,
    mesh=None,
    straggler_timeout_s: float = 300.0,
    on_straggler: Callable[[int, float], Any] | None = None,
    spectral_params: dict | None = None,
) -> TrainResult:
    """Train ``run`` on ``device`` (the card by default; ``device="cpu"`` runs
    the plain PyTorch path on the CPU), under ``mesh`` when given (see the
    module docstring)."""
    check_mesh(mesh)
    dev = resolve_device("cuda" if device is None else device)
    cfg = run.model
    opt = run.optimizer
    api = build_model(cfg)

    params = api.init(_generator(run.seed, dev), device=dev)
    opt_state = adamw_init(params)
    start_step = 0
    resumed_from = None

    # ---- auto-resume (in AdamW's layout, as the reference restores)
    latest = ckpt.latest_step(run.checkpoint_dir)
    if latest is not None:
        start_step, (params, opt_state) = ckpt.restore(
            run.checkpoint_dir, (params, opt_state), latest)
        resumed_from = start_step

    # optional paper-technique policy: streaming-SVD low-rank moment projection
    use_spectral = opt.spectral_rank > 0
    if use_spectral:
        opt_state = spectral_adam_init(_generator(run.seed + 1, dev), params,
                                       rank=opt.spectral_rank, device=dev)

    if mesh is not None:
        if use_spectral and start_step < run.steps:
            raise ValueError("pytree structure error: under a mesh the optimizer state is "
                             "placed by AdamW's specs (AdamWState), but spectral_rank > 0 "
                             "builds a SpectralAdamState, as in the reference's train")
        params = reshard(params, mesh)
        if not use_spectral:
            opt_state = AdamWState(step=opt_state.step, m=reshard(opt_state.m, mesh),
                                   v=reshard(opt_state.v, mesh))

    result = TrainResult(final_step=start_step, resumed_from=resumed_from)
    for step in range(start_step, run.steps):
        t0 = time.time()
        batch = batch_for_step(run.seed, step, batch=batch_size, seq=seq_len,
                               vocab=cfg.vocab_size, device=dev)
        params, opt_state, loss, gnorm = train_step(api, opt, params, opt_state, batch, step,
                                                    spectral=use_spectral, mesh=mesh)
        if step % run.log_every == 0 or step == run.steps - 1:
            lv = float(loss)
            gv = float(gnorm)
            result.losses.append((step, lv))
            result.grad_norms.append((step, gv))
            print(f"step {step:6d} loss {lv:.4f} gnorm {gv:.3f} "
                  f"dt {time.time() - t0:.2f}s", flush=True)
        dt = time.time() - t0
        if dt > straggler_timeout_s:
            result.straggler_events.append((step, dt))
            if on_straggler is not None:
                on_straggler(step, dt)
        if run.checkpoint_every and (step + 1) % run.checkpoint_every == 0:
            ckpt.save(run.checkpoint_dir, step + 1, (params, opt_state),
                      keep=run.keep_checkpoints)
        result.final_step = step + 1

    if run.checkpoint_every:
        ckpt.save(run.checkpoint_dir, result.final_step, (params, opt_state),
                  keep=run.keep_checkpoints)
    return result
