"""Assigned-architecture registry: one module per architecture.

Every config is importable as ``repro_torch.configs.get("<arch-id>")`` and
selectable from launchers via ``--arch <arch-id>``.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (
    deepseek_67b,
    llama3_2_1b,
    internlm2_1_8b,
    yi_6b,
    hymba_1_5b,
    falcon_mamba_7b,
    internvl2_2b,
    qwen2_moe_a2_7b,
    deepseek_v2_236b,
    seamless_m4t_medium,
)

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        deepseek_67b,
        llama3_2_1b,
        internlm2_1_8b,
        yi_6b,
        hymba_1_5b,
        falcon_mamba_7b,
        internvl2_2b,
        qwen2_moe_a2_7b,
        deepseek_v2_236b,
        seamless_m4t_medium,
    )
}

SMOKE_REGISTRY = {
    m.CONFIG.name: m.SMOKE_CONFIG
    for m in (
        deepseek_67b,
        llama3_2_1b,
        internlm2_1_8b,
        yi_6b,
        hymba_1_5b,
        falcon_mamba_7b,
        internvl2_2b,
        qwen2_moe_a2_7b,
        deepseek_v2_236b,
        seamless_m4t_medium,
    )
}


def get(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke(name: str) -> ModelConfig:
    return SMOKE_REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)
