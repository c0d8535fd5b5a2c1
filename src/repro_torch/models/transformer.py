"""Decoder-only LM, dense family: init, contiguous KV cache, one-token decode.

Parameters are a nested dict in the JAX package's layout, except that
``params["layers"]`` is a list of per-layer dicts (the JAX package stacks
layers on axis 0 for ``lax.scan``; here a Python loop walks the list).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import attn_decode, attn_init
from repro_torch.models.common import ones, rmsnorm, torch_dtype
from repro_torch.models.mlp import mlp_apply, mlp_init


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port serves the "
            "dense family")


def _attn_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = torch_dtype(cfg.param_dtype)
    return {
        "ln1": ones((cfg.d_model,), pd, gen.device),
        "attn": attn_init(gen, cfg),
        "ln2": ones((cfg.d_model,), pd, gen.device),
        "mlp": mlp_init(gen, cfg),
    }


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Full parameter dict on ``gen.device``."""
    _check_dense(cfg)
    pd = torch_dtype(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": common.embedding_init(gen, cfg),
        "ln_f": ones((cfg.d_model,), pd, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.lm_head_init(gen, cfg)
    params["layers"] = [_attn_layer_init(gen, cfg)
                        for _ in range(cfg.num_layers)]
    return params


def _lm_head(params, cfg: ModelConfig) -> torch.Tensor:
    """LM head weights (d, V)."""
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """Contiguous cache: k/v (L, B, max_len, Hkv, hd) and lengths (B,)."""
    _check_dense(cfg)
    hd = cfg.resolved_head_dim
    cdt = torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=cdt, device=device),
        "v": torch.zeros(shape, dtype=cdt, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def lm_decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B,) int -> (logits (B, V) fp32, cache).  The cache's K/V
    are written in place; ``lengths`` advances by one."""
    _check_dense(cfg)
    lengths = cache["lengths"]
    x = common.embed_tokens(params["embed"], tokens[:, None], cfg)
    angles = common.rope_angles(lengths[:, None], cfg.resolved_head_dim,
                                cfg.rope_theta)
    for li, layer in enumerate(params["layers"]):
        h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
        a, _, _ = attn_decode(layer["attn"], h, cfg, k_cache=cache["k"][li],
                              v_cache=cache["v"][li], lengths=lengths,
                              angles=angles)
        x = x + a
        h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
        x = x + mlp_apply(layer["mlp"], h)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = common.lm_logits(x, _lm_head(params, cfg), cfg)[:, 0]
    cache["lengths"] = lengths + 1
    return logits, cache
