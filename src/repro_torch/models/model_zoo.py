"""Model facade over the ported families: dense (llama3.2-3b), moe
(phi3.5-moe, qwen3-moe: the dense family's attention with a
mixture-of-experts feed-forward), ssm (mamba2-130m) and hybrid
(recurrentgemma-9b).  The ssm family keeps
recurrent caches (conv history and SSD state per layer), the hybrid family
recurrent caches for its RG-LRU layers and ring-buffer K/V of the local
window for its attention layers; as in the JAX package, both are served
through ``Model.prefill`` and ``Model.decode_step``, not the paged
engine."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA device without a card raises
    (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Model:
    """Uniform facade: ``init`` builds parameters on ``device``; forward,
    loss, prefill and decode run wherever their tensors are."""

    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return transformer.lm_init(gen, self.cfg)

    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return transformer.lm_forward(params, batch, self.cfg)

    def loss(self, params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return transformer.lm_loss(params, batch, self.cfg)

    def prefill(self, params, batch, max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return transformer.lm_prefill(params, batch, self.cfg, max_len)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        return transformer.lm_init_cache(self.cfg, batch, max_len,
                                         self.device)

    def decode_step(self, params, cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return transformer.lm_decode_step(params, cache, tokens, self.cfg)


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The facade for ``cfg`` on ``device`` (dense, moe, ssm or hybrid); a
    family that is not ported yet (encdec, vlm: item 4) raises."""
    transformer.check_family(cfg)
    return Model(cfg, resolve_device(device))
