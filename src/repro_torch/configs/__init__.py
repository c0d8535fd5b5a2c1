"""Config registry: ``get_config(name)`` / ``list_configs()`` / shapes."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig, applicable
from repro_torch.configs.shapes import SHAPES, get_shape

from repro_torch.configs import (
    qwen2_5_14b,
    codeqwen1_5_7b,
    llama3_2_3b,
    minitron_8b,
    mamba2_130m,
    qwen2_vl_2b,
    qwen3_moe_235b,
    phi3_5_moe,
    seamless_m4t_v2,
    recurrentgemma_9b,
)

_MODULES = (
    qwen2_5_14b,
    codeqwen1_5_7b,
    llama3_2_3b,
    minitron_8b,
    mamba2_130m,
    qwen2_vl_2b,
    qwen3_moe_235b,
    phi3_5_moe,
    seamless_m4t_v2,
    recurrentgemma_9b,
)

CONFIGS = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# CLI-friendly aliases (exact assigned ids)
ALIASES = {
    "qwen2.5-14b": "qwen2.5-14b",
    "codeqwen1.5-7b": "codeqwen1.5-7b",
    "llama3.2-3b": "llama3.2-3b",
    "minitron-8b": "minitron-8b",
    "mamba2-130m": "mamba2-130m",
    "qwen2-vl-2b": "qwen2-vl-2b",
    "qwen3-moe-235b-a22b": "qwen3-moe-235b-a22b",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
    "seamless-m4t-large-v2": "seamless-m4t-large-v2",
    "recurrentgemma-9b": "recurrentgemma-9b",
}


def get_config(name: str) -> ModelConfig:
    key = ALIASES.get(name, name)
    try:
        return CONFIGS[key]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}") from None


def list_configs():
    return sorted(CONFIGS)


__all__ = [
    "ModelConfig", "ShapeConfig", "applicable", "SHAPES", "get_shape",
    "CONFIGS", "get_config", "list_configs",
]
