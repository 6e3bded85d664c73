"""Assigned-architecture registry: one module per architecture.

Every config is importable as ``repro_torch.configs.get("<arch-id>")`` and
selectable from launchers via ``--arch <arch-id>``.  :func:`names` lists
the architectures the JAX package lists too (the tests hold the port
against it on them); :func:`port_names` adds those only the port has.
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
    deepseek_v2_lite,
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


# the port's alone: the JAX package has no such configuration
_PORT_ONLY = {m.CONFIG.name: m for m in (deepseek_v2_lite,)}


def get(name: str) -> ModelConfig:
    if name in _PORT_ONLY:
        return _PORT_ONLY[name].CONFIG
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {port_names()}")
    return _REGISTRY[name]


def get_smoke(name: str) -> ModelConfig:
    if name in _PORT_ONLY:
        return _PORT_ONLY[name].SMOKE_CONFIG
    return SMOKE_REGISTRY[name]


def names() -> list[str]:
    """The architectures both packages list."""
    return sorted(_REGISTRY)


def port_names() -> list[str]:
    """Every architecture the port runs: :func:`names` and the port's own."""
    return sorted([*_REGISTRY, *_PORT_ONLY])
