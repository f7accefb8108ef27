"""Architecture registry: one API for the assigned architectures, in PyTorch.

Counterpart of ``repro.models.registry``.  ``build_model(cfg)`` returns a
``ModelApi`` whose entry points cover the shape kinds:

  train_loss(params, batch)              — train shapes
  prefill(params, batch, **kw)           — prefill shapes
  decode_step(params, cache, token, pos) — decode shapes

``input_specs(shape)`` gives ``TensorSpec`` stand-ins (shape and dtype, no
allocation) for every input of the entry point, and ``init(None,
device="meta")`` the parameter tree as empty meta tensors (shapes and dtypes,
nothing drawn or allocated: the reference's ``jax.eval_shape(api.init,
key)``).  Every family is ported: the
decoder (dense, VLM, MoE and MLA configs), the hybrid, RWKV and the
encoder-decoder.  ``prefill``'s keyword is each family's own, as in the
reference: ``max_len=`` for the decoder and the hybrid, ``max_dec_len=``
for the encoder-decoder, none for RWKV (so ``serve.engine.generate`` raises
the reference's ``TypeError`` for those two).  The decoder's, the hybrid's
and the encoder-decoder's ``decode_step`` write the cache in place and
return it; RWKV's returns a new state.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, rwkv_model, transformer
from repro_torch.models.layers import as_dtype

__all__ = ["ModelApi", "TensorSpec", "build_model", "zeros_like_specs"]


class TensorSpec(NamedTuple):
    """Shape and dtype of an input (the port's ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


class ModelApi(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]  # (gen=None, *, device="cuda") -> params
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


def _decode_specs(cache, b):
    return {"cache": cache, "token": _tok(b, 1), "pos": TensorSpec((), torch.int32)}


def _decoder_api(cfg: ModelConfig) -> ModelApi:
    act_dt = as_dtype(cfg.compute_dtype)

    def input_specs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":  # one new token against a cache of seq_len
            return _decode_specs(transformer.decode_cache_spec(cfg, b, s, act_dt), b)
        batch = {"tokens": _tok(b, s)}
        if cfg.frontend == "vision":
            p = cfg.n_frontend_tokens
            batch = {"tokens": _tok(b, s - p),
                     "patches": TensorSpec((b, p, cfg.d_model), act_dt)}
        if shape.kind == "train":
            batch["labels"] = batch["tokens"]
        return {"batch": batch}

    return ModelApi(
        cfg=cfg,
        init=lambda gen=None, *, device="cuda": transformer.decoder_init(gen, cfg, device=device),
        train_loss=lambda params, batch: transformer.decoder_train_loss(params, batch, cfg),
        prefill=lambda params, batch, **kw: transformer.decoder_prefill(params, batch, cfg, **kw),
        decode_step=lambda params, cache, token, pos: transformer.decoder_decode_step(
            params, cache, token, pos, cfg),
        input_specs=input_specs,
    )


def _hybrid_api(cfg: ModelConfig) -> ModelApi:
    act_dt = as_dtype(cfg.compute_dtype)

    def input_specs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return _decode_specs(hybrid.hybrid_state_spec(cfg, b, s, act_dt), b)
        batch = {"tokens": _tok(b, s)}
        if shape.kind == "train":
            batch["labels"] = _tok(b, s)
        return {"batch": batch}

    return ModelApi(
        cfg=cfg,
        init=lambda gen=None, *, device="cuda": hybrid.hybrid_init(gen, cfg, device=device),
        train_loss=lambda params, batch: hybrid.hybrid_train_loss(params, batch, cfg),
        prefill=lambda params, batch, **kw: hybrid.hybrid_prefill(params, batch, cfg, **kw),
        decode_step=lambda params, cache, token, pos: hybrid.hybrid_decode_step(
            params, cache, token, pos, cfg),
        input_specs=input_specs,
    )


def _rwkv_api(cfg: ModelConfig) -> ModelApi:
    act_dt = as_dtype(cfg.compute_dtype)

    def input_specs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return _decode_specs(rwkv_model.rwkv_state_spec(cfg, b, act_dt), b)
        batch = {"tokens": _tok(b, s)}
        if shape.kind == "train":
            batch["labels"] = _tok(b, s)
        return {"batch": batch}

    return ModelApi(
        cfg=cfg,
        init=lambda gen=None, *, device="cuda": rwkv_model.rwkv_model_init(gen, cfg, device=device),
        train_loss=lambda params, batch: rwkv_model.rwkv_train_loss(params, batch, cfg),
        prefill=lambda params, batch: rwkv_model.rwkv_prefill(params, batch, cfg),
        decode_step=lambda params, cache, token, pos: rwkv_model.rwkv_decode_step(
            params, cache, token, pos, cfg),
        input_specs=input_specs,
    )


def _encdec_api(cfg: ModelConfig) -> ModelApi:
    act_dt = as_dtype(cfg.compute_dtype)

    def input_specs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        s_dec = max(s // cfg.dec_ratio, 64)
        if shape.kind == "decode":  # self and cross caches both of seq_len
            return _decode_specs(encdec.encdec_cache_spec(cfg, b, s, s, act_dt), b)
        batch = {"frames": TensorSpec((b, s, cfg.d_model), act_dt), "tokens": _tok(b, s_dec)}
        if shape.kind == "train":
            batch["labels"] = _tok(b, s_dec)
        return {"batch": batch}

    return ModelApi(
        cfg=cfg,
        init=lambda gen=None, *, device="cuda": encdec.encdec_init(gen, cfg, device=device),
        train_loss=lambda params, batch: encdec.encdec_train_loss(params, batch, cfg),
        prefill=lambda params, batch, **kw: encdec.encdec_prefill(params, batch, cfg, **kw),
        decode_step=lambda params, cache, token, pos: encdec.encdec_decode_step(
            params, cache, token, pos, cfg),
        input_specs=input_specs,
    )


def build_model(cfg: ModelConfig) -> ModelApi:
    if cfg.encdec:
        return _encdec_api(cfg)
    if cfg.rwkv is not None:
        return _rwkv_api(cfg)
    if cfg.ssm is not None and cfg.attn_every > 0:
        return _hybrid_api(cfg)
    return _decoder_api(cfg)
