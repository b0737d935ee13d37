"""Config registry: every assigned architecture selectable by --arch <id>."""
from __future__ import annotations

from . import (
    deepseek_67b,
    grok1_314b,
    internvl2_26b,
    kimi_k2_1t,
    llama3_405b,
    llama3p2_1b,
    qwen2_0p5b,
    seamless_m4t_medium,
    xlstm_125m,
    zamba2_2p7b,
)
from .base import ArchConfig
from .shapes import SHAPES, ShapePreset, cell_applicable

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        zamba2_2p7b,
        xlstm_125m,
        kimi_k2_1t,
        grok1_314b,
        llama3_405b,
        deepseek_67b,
        llama3p2_1b,
        qwen2_0p5b,
        seamless_m4t_medium,
        internvl2_26b,
    )
}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return REGISTRY[name[: -len("-smoke")]].smoke()
    return REGISTRY[name]


__all__ = ["ArchConfig", "REGISTRY", "ARCH_IDS", "get_config", "SHAPES",
           "ShapePreset", "cell_applicable"]
