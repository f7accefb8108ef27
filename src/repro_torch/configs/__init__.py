"""Architecture configs: ``get(arch_id)`` / ``get_smoke(arch_id)``.

The port's own copies of ``repro.configs`` (data only, equal field by field).
Arch ids match the assignment table; shapes come from ``base.SHAPES``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    RunConfig,
    RWKVConfig,
    ShapeConfig,
    SSMConfig,
)

_MODULES = {
    "qwen1.5-32b": "qwen1_5_32b",
    "nemotron-4-15b": "nemotron_4_15b",
    "granite-34b": "granite_34b",
    "qwen2-72b": "qwen2_72b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-base": "whisper_base",
    "zamba2-7b": "zamba2_7b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}

ARCH_IDS = tuple(_MODULES)

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs
# (skips documented in DESIGN.md §6).
LONG_CONTEXT_ARCHS = ("zamba2-7b", "rwkv6-1.6b")


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get(arch_id: str) -> ModelConfig:
    return _mod(arch_id).config()


def get_smoke(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke()


def cells():
    """All assigned (arch, shape) dry-run cells, with documented skips."""
    out = []
    for arch in ARCH_IDS:
        for shape_name, shape in SHAPES.items():
            if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            out.append((arch, shape_name))
    return out


__all__ = [
    "ARCH_IDS",
    "LONG_CONTEXT_ARCHS",
    "SHAPES",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "OptimizerConfig",
    "RunConfig",
    "RWKVConfig",
    "ShapeConfig",
    "SSMConfig",
    "cells",
    "get",
    "get_smoke",
]
