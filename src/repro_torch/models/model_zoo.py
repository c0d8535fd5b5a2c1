"""Model facade over every family: dense (llama3.2-3b and the other dense
configs), moe (phi3.5-moe, qwen3-moe: the dense family's attention with a
mixture-of-experts feed-forward), vlm (qwen2-vl-2b: the dense layout fed
with patch embeddings and M-RoPE positions), ssm (mamba2-130m), hybrid
(recurrentgemma-9b) and encdec (seamless-m4t-large-v2).  The ssm family
keeps recurrent caches (conv history and SSD state per layer), the hybrid
family recurrent caches for its RG-LRU layers and ring-buffer K/V of the
local window for its attention layers, the encdec family the decoder's
K/V and the cross-attention K/V of the encoder's output; as in the JAX
package, these three are served through ``Model.prefill`` and
``Model.decode_step``, not the paged engine."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.rpc import ShapeDtype
from repro_torch.models import encdec, transformer
from repro_torch.models.common import torch_dtype


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

    @property
    def is_encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def init(self, seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.is_encdec:
            return encdec.encdec_init(gen, self.cfg)
        return transformer.lm_init(gen, self.cfg)

    def param_axes(self) -> Dict[str, Any]:
        """The logical axes of :meth:`init`'s tree, leaf for leaf (JAX's
        ``Param.axes`` in the per-layer-list layout)."""
        if self.is_encdec:
            return encdec.encdec_axes(self.cfg)
        return transformer.lm_axes(self.cfg)

    def param_specs(self) -> Tuple[Any, Any]:
        """(:class:`~repro_torch.core.rpc.ShapeDtype` tree, axes tree) of
        :meth:`init`, allocating nothing (JAX's ``eval_shape``): the init
        runs on fake tensors."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.tree import tree_map
        init = encdec.encdec_init if self.is_encdec else transformer.lm_init
        with FakeTensorMode():
            tree = init(torch.Generator(device="cpu"), self.cfg)
            specs = tree_map(lambda t: ShapeDtype(t.shape, t.dtype), tree)
        return specs, self.param_axes()

    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.is_encdec:
            return encdec.encdec_forward(params, batch, self.cfg)
        return transformer.lm_forward(params, batch, self.cfg)

    def loss(self, params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The LM's loss; encdec: cross entropy of the decoder's next
        tokens, the last position masked."""
        if not self.is_encdec:
            return transformer.lm_loss(params, batch, self.cfg)
        logits, aux = encdec.encdec_forward(params, batch, self.cfg)
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                           dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1] = 0.0
        ce, denom = transformer.cross_entropy(logits, labels, mask)
        return ce, {"loss": ce, "ce": ce, "aux": aux, "tokens": denom}

    def prefill(self, params, batch, max_len: int
                ) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
        """The LM's prefill.  encdec: the encoder over ``batch["embeds"]``
        (B, S_enc, d) fills a cache of ``enc_len`` S_enc, with
        ``batch["enc_lens"]`` or S_enc for every row; then ``(None,
        cache)``, or with ``batch["tokens"]`` one decode step of
        ``tokens[:, 0]`` and its logits."""
        if not self.is_encdec:
            return transformer.lm_prefill(params, batch, self.cfg, max_len)
        embeds = batch["embeds"]
        B, S_enc = embeds.shape[:2]
        cache = encdec.encdec_init_cache(self.cfg, B, max_len, embeds.device,
                                         enc_len=S_enc)
        enc_lens = batch.get("enc_lens")
        if enc_lens is None:
            enc_lens = torch.full((B,), S_enc, dtype=torch.int32,
                                  device=embeds.device)
        cache = encdec.encdec_prefill_cross(params, cache, embeds, enc_lens,
                                            self.cfg)
        bos = batch.get("tokens")
        if bos is not None and bos.shape[1] > 0:
            return encdec.encdec_decode_step(params, cache, bos[:, 0],
                                             self.cfg)
        return None, cache

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        if self.is_encdec:
            return encdec.encdec_init_cache(self.cfg, batch, max_len,
                                            self.device)
        return transformer.lm_init_cache(self.cfg, batch, max_len,
                                         self.device)

    def cache_axes(self) -> Dict[str, Any]:
        """The logical axes of :meth:`init_cache`'s tree, leaf for leaf (the
        second value of JAX's ``Model.init_cache``)."""
        if self.is_encdec:
            return encdec.encdec_cache_axes(self.cfg)
        return transformer.lm_cache_axes(self.cfg)

    def decode_step(self, params, cache, tokens: torch.Tensor,
                    embeds: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token (B,), or its embedding ``embeds`` (B, 1, d) (the LM
        families; encdec takes tokens, as in JAX)."""
        if self.is_encdec:
            return encdec.encdec_decode_step(params, cache, tokens, self.cfg)
        return transformer.lm_decode_step(params, cache, tokens, self.cfg,
                                          embeds=embeds)


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The facade for ``cfg`` (any of the ten configs' families) on
    ``device``."""
    return Model(cfg, resolve_device(device))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ShapeDtype]:
    """The ``batch`` of a train or prefill cell as
    :class:`~repro_torch.core.rpc.ShapeDtype` stand-ins (no allocation), or
    a decode step's ``tokens`` (B,) for decode kinds (caches come from
    ``init_cache``).  Families fed with embeddings take ``embeds`` (B, S,
    d) and the decoder's ``tokens`` (encdec) or next-token ``labels`` and,
    with M-RoPE, ``positions`` (3, B, S) (vlm); the others ``tokens``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind not in ("train", "prefill"):
        return {"tokens": ShapeDtype((B,), i32)}
    batch: Dict[str, ShapeDtype] = {}
    if cfg.embeds_input:
        batch["embeds"] = ShapeDtype((B, S, cfg.d_model),
                                     torch_dtype(cfg.dtype))
        if cfg.family == "encdec":
            batch["tokens"] = ShapeDtype((B, S), i32)
        else:
            batch["labels"] = ShapeDtype((B, S), i32)
            if cfg.mrope_sections:
                batch["positions"] = ShapeDtype(
                    (len(cfg.mrope_sections), B, S), i32)
    else:
        batch["tokens"] = ShapeDtype((B, S), i32)
    return batch


def batch_sharding_axes(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The logical axes of each :func:`input_specs` leaf."""
    if shape.kind not in ("train", "prefill"):
        return {"tokens": ("batch",)}
    axes: Dict[str, Tuple[Optional[str], ...]] = {}
    if cfg.embeds_input:
        axes["embeds"] = ("batch", "seq", "embed")
        if cfg.family == "encdec":
            axes["tokens"] = ("batch", "seq")
        else:
            axes["labels"] = ("batch", "seq")
            if cfg.mrope_sections:
                axes["positions"] = (None, "batch", "seq")
    else:
        axes["tokens"] = ("batch", "seq")
    return axes
