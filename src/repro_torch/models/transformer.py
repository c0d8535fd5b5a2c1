"""Decoder-only LM, dense and ssm families: init, full-sequence forward and
loss (training), prefill, decode caches, one-token decode.

Parameters are a nested dict in the JAX package's layout, except that
``params["layers"]`` is a list of per-layer dicts (the JAX package stacks
layers on axis 0 for ``lax.scan``; here a Python loop walks the list).
Caches keep the JAX layout: stacked on a leading layer axis.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import attn_apply, attn_decode, attn_init
from repro_torch.models.common import ones, rmsnorm, torch_dtype
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.ssd import (
    ssd_apply, ssd_decode, ssd_init, ssd_init_cache)

PORTED_FAMILIES = ("dense", "ssm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port runs "
            f"{' and '.join(PORTED_FAMILIES)} (hybrid, moe, encdec and vlm "
            "are still to come)")


def _attn_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = torch_dtype(cfg.param_dtype)
    return {
        "ln1": ones((cfg.d_model,), pd, gen.device),
        "attn": attn_init(gen, cfg),
        "ln2": ones((cfg.d_model,), pd, gen.device),
        "mlp": mlp_init(gen, cfg),
    }


def _ssm_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = torch_dtype(cfg.param_dtype)
    return {"ln1": ones((cfg.d_model,), pd, gen.device),
            "ssd": ssd_init(gen, cfg)}


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Full parameter dict on ``gen.device``."""
    check_family(cfg)
    pd = torch_dtype(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": common.embedding_init(gen, cfg),
        "ln_f": ones((cfg.d_model,), pd, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.lm_head_init(gen, cfg)
    layer_init = _ssm_layer_init if cfg.family == "ssm" else _attn_layer_init
    params["layers"] = [layer_init(gen, cfg) for _ in range(cfg.num_layers)]
    return params


def _lm_head(params, cfg: ModelConfig) -> torch.Tensor:
    """LM head weights (d, V)."""
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# ---------------------------------------------------------------------------
# Remat policies
# ---------------------------------------------------------------------------

def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """Wrap a layer body per ``cfg.remat``.  ``"none"`` saves every
    activation.  ``"full"`` (JAX's ``nothing_saveable``) runs the layer
    under ``torch.utils.checkpoint`` (non-reentrant): only the layer's
    inputs are saved and the backward recomputes the layer.  ``"dots"``
    (JAX saves the matmul outputs) maps to the same full recompute here.
    Without autograd (``torch.no_grad``) nothing is saved either way."""
    if cfg.remat == "none":
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _angles_for(cfg: ModelConfig, batch, B: int, S: int,
                device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        positions = common.default_positions(B, S, cfg, device)
    return common.rope_angles(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)


def _layer(layer, x: torch.Tensor, angles: torch.Tensor, *,
           cfg: ModelConfig, causal: bool) -> torch.Tensor:
    h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
    x = x + attn_apply(layer["attn"], h, cfg, angles=angles, causal=causal)
    h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
    return x + mlp_apply(layer["mlp"], h)


def _ssm_layer(layer, x: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
    return x + ssd_apply(layer["ssd"], h, cfg)


def lm_forward(params, batch, cfg: ModelConfig, *, causal: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V) fp32, aux_loss)."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = common.embed_tokens(params["embed"], tokens, cfg)
    B, S = tokens.shape
    if cfg.family == "ssm":
        body = _remat(functools.partial(_ssm_layer, cfg=cfg), cfg)
        for layer in params["layers"]:
            x = body(layer, x)
    else:
        angles = _angles_for(cfg, batch, B, S, x.device)
        body = _remat(functools.partial(_layer, cfg=cfg, causal=causal), cfg)
        for layer in params["layers"]:
            x = body(layer, x, angles)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = common.lm_logits(x, _lm_head(params, cfg), cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token CE. logits (B,S,V) fp32; labels, mask (B,S).  The label
    logit is a gather; the JAX version takes a masked sum over the vocab
    axis so that a vocab-sharded logit stays local, and both pick the same
    value."""
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - lab) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll) / denom, denom


def lm_loss(params, batch, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = lm_forward(params, batch, cfg)
    if "labels" in batch:
        labels = batch["labels"]
        mask = (labels >= 0).float()
        labels = torch.clamp(labels, min=0)
    else:
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                           dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1] = 0.0
    ce, denom = cross_entropy(logits, labels, mask)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# KV cache, prefill
# ---------------------------------------------------------------------------

def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> Dict[str, Any]:
    """dense: contiguous k/v (L, B, max_len, Hkv, hd); ssm: per-layer
    recurrent state ``layers`` = {"conv" (L, B, W-1, conv_dim), "ssm"
    (L, B, H, P, N) fp32}, whatever ``max_len``; both with lengths (B,)."""
    check_family(cfg)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        one = ssd_init_cache(cfg, batch, device)
        return {"layers": {k: v[None].repeat((cfg.num_layers,) +
                                             (1,) * v.ndim)
                           for k, v in one.items()},
                "lengths": lengths}
    hd = cfg.resolved_head_dim
    cdt = torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=cdt, device=device),
        "v": torch.zeros(shape, dtype=cdt, device=device),
        "lengths": lengths,
    }


def lm_prefill(params, batch, cfg: ModelConfig, max_len: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward over the prompt that also fills the decode
    cache.  Returns (last-token logits (B, V) fp32, the cache of
    :func:`lm_init_cache` with every layer's K/V at positions 0..S-1, or
    every ssm layer's state after position S-1, and ``lengths`` = S)."""
    check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = common.embed_tokens(params["embed"], tokens, cfg)
    cache = lm_init_cache(cfg, B, max_len, x.device)
    if cfg.family == "ssm":
        x = _ssm_prefill(params, x, cache["layers"], cfg)
    else:
        x = _dense_prefill(params, batch, x, cache, cfg, max_len)
    cache["lengths"].fill_(S)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = common.lm_logits(x[:, -1:], _lm_head(params, cfg), cfg)[:, 0]
    return logits, cache


def _ssm_prefill(params, x: torch.Tensor, states: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    for li, layer in enumerate(params["layers"]):
        h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
        y, st = ssd_apply(layer["ssd"], h, cfg, return_state=True)
        x = x + y
        for key, v in st.items():
            states[key][li] = v
    return x


def _dense_prefill(params, batch, x: torch.Tensor, cache, cfg: ModelConfig,
                   max_len: int) -> torch.Tensor:
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    angles = _angles_for(cfg, batch, B, S, x.device)
    for li, layer in enumerate(params["layers"]):
        h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
        a, (k, v) = attn_apply(layer["attn"], h, cfg, angles=angles,
                               return_kv=True)
        x = x + a
        h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
        x = x + mlp_apply(layer["mlp"], h)
        cache["k"][li, :, :S] = k.to(cache["k"].dtype)
        cache["v"][li, :, :S] = v.to(cache["v"].dtype)
    return x


def lm_decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B,) int -> (logits (B, V) fp32, cache).  The cache's K/V
    (or recurrent states) are written in place; ``lengths`` advances by
    one."""
    check_family(cfg)
    lengths = cache["lengths"]
    x = common.embed_tokens(params["embed"], tokens[:, None], cfg)
    if cfg.family == "ssm":
        x = _ssm_decode(params, x, cache["layers"], cfg)
    else:
        x = _dense_decode(params, x, cache, cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = common.lm_logits(x, _lm_head(params, cfg), cfg)[:, 0]
    cache["lengths"] = lengths + 1
    return logits, cache


def _ssm_decode(params, x: torch.Tensor, states: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> torch.Tensor:
    for li, layer in enumerate(params["layers"]):
        h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
        y, st = ssd_decode(layer["ssd"], h,
                           {k: v[li] for k, v in states.items()}, cfg)
        x = x + y
        for key, v in st.items():
            states[key][li] = v
    return x


def _dense_decode(params, x: torch.Tensor, cache, cfg: ModelConfig
                  ) -> torch.Tensor:
    lengths = cache["lengths"]
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
    return x
