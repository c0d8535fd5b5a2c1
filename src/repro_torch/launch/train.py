"""Training presets (the training loop itself is not ported yet)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def tiny_preset(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg.reduced(), name=cfg.name + "-tiny", num_layers=4, d_model=128,
        d_ff=256, vocab_size=512)
