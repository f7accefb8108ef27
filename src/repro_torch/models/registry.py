"""Architecture registry: one API for the assigned architectures, in PyTorch.

Counterpart of ``repro.models.registry``.  ``build_model(cfg)`` returns a
``ModelApi`` whose ``train_loss(params, batch)`` serves the train shapes and
whose ``input_specs(shape)`` gives ``TensorSpec`` stand-ins (shape and dtype,
no allocation) for every input of the entry point.  The dense decoder family
(dense and VLM configs) is ported; ``prefill`` and ``decode_step``, and the
hybrid, RWKV and encoder-decoder families, raise by name (ROADMAP A9).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.models.layers import as_dtype

__all__ = ["ModelApi", "TensorSpec", "build_model", "zeros_like_specs"]

_A9 = "not ported yet: {what} waits for ROADMAP A9"


class TensorSpec(NamedTuple):
    """Shape and dtype of an input (the port's ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


class ModelApi(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]  # (gen, *, device="cuda") -> params
    train_loss: Callable[..., torch.Tensor]
    prefill: Callable[..., tuple]
    decode_step: Callable[..., tuple]
    input_specs: Callable[[ShapeConfig], dict]


def zeros_like_specs(specs, device="cuda"):
    if isinstance(specs, TensorSpec):
        return torch.zeros(specs.shape, dtype=specs.dtype, device=device)
    return {k: zeros_like_specs(v, device) for k, v in specs.items()}


def _tok(b, s):
    return TensorSpec((b, s), torch.int32)


def _refuse(what: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(_A9.format(what=what))

    return fn


def _decoder_api(cfg: ModelConfig) -> ModelApi:
    act_dt = as_dtype(cfg.compute_dtype)

    def input_specs(shape: ShapeConfig):
        if shape.kind != "train":
            raise NotImplementedError(_A9.format(what=f"the {shape.kind} inputs (KV cache)"))
        b, s = shape.global_batch, shape.seq_len
        if cfg.frontend == "vision":
            p = cfg.n_frontend_tokens
            return {"batch": {"tokens": _tok(b, s - p), "labels": _tok(b, s - p),
                              "patches": TensorSpec((b, p, cfg.d_model), act_dt)}}
        return {"batch": {"tokens": _tok(b, s), "labels": _tok(b, s)}}

    return ModelApi(
        cfg=cfg,
        init=lambda gen, *, device="cuda": transformer.decoder_init(gen, cfg, device=device),
        train_loss=lambda params, batch: transformer.decoder_train_loss(params, batch, cfg),
        prefill=_refuse("decoder prefill (serve/engine.py)"),
        decode_step=_refuse("decoder decode (serve/engine.py)"),
        input_specs=input_specs,
    )


def build_model(cfg: ModelConfig) -> ModelApi:
    if cfg.encdec:
        raise NotImplementedError(_A9.format(what=f"{cfg.name}: the encoder-decoder family"))
    if cfg.rwkv is not None:
        raise NotImplementedError(_A9.format(what=f"{cfg.name}: the RWKV family"))
    if cfg.ssm is not None and cfg.attn_every > 0:
        raise NotImplementedError(_A9.format(what=f"{cfg.name}: the hybrid family"))
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(_A9.format(what=f"{cfg.name}: MoE and MLA decoder blocks"))
    return _decoder_api(cfg)
