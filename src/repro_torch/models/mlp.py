"""SwiGLU MLP."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import normal, torch_dtype


#: Logical axes of :func:`mlp_init`'s leaves (JAX's ``Param.axes``).
MLP_AXES = {"wi_gate": ("fsdp", "ffn"), "wi_up": ("fsdp", "ffn"),
            "wo": ("ffn", "fsdp")}


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    pd = torch_dtype(cfg.param_dtype)
    return {
        "wi_gate": normal(gen, (d, f), pd),
        "wi_up": normal(gen, (d, f), pd),
        "wo": normal(gen, (f, d), pd, scale=f ** -0.5),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ p["wi_gate"].to(dt)
    u = x @ p["wi_up"].to(dt)
    return (F.silu(g) * u) @ p["wo"].to(dt)
