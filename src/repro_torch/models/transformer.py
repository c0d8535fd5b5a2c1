"""Decoder-only LM, dense, ssm and hybrid families: init, full-sequence
forward and loss (training), prefill, decode caches, one-token decode.

Parameters are a nested dict in the JAX package's layout, except that
``params["layers"]`` (and the hybrid family's ``params["rec_layers"]`` and
``params["attn_layers"]``) is a list of per-layer dicts (the JAX package
stacks layers on axis 0 for ``lax.scan``; here a Python loop walks the
list).  Caches keep the JAX layout: stacked on a leading layer axis.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import attn_apply, attn_decode, attn_init
from repro_torch.models.common import ones, rmsnorm, torch_dtype
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.rglru import (
    rglru_apply, rglru_decode, rglru_init, rglru_init_cache)
from repro_torch.models.ssd import (
    ssd_apply, ssd_decode, ssd_init, ssd_init_cache)

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port runs "
            f"{', '.join(PORTED_FAMILIES)} (moe, encdec and vlm are still "
            "to come)")


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


def _rec_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = torch_dtype(cfg.param_dtype)
    return {
        "ln1": ones((cfg.d_model,), pd, gen.device),
        "rglru": rglru_init(gen, cfg),
        "ln2": ones((cfg.d_model,), pd, gen.device),
        "mlp": mlp_init(gen, cfg),
    }


def hybrid_layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """The hybrid family's layer kinds: the block pattern repeated, cut to
    ``num_layers`` (recurrentgemma-9b: 12 x (rec, rec, attn) + rec, rec)."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    kinds = []
    while len(kinds) < cfg.num_layers:
        kinds.extend(pat)
    return tuple(kinds[: cfg.num_layers])


def _hybrid_layers(params, cfg: ModelConfig):
    """(kind, index within its kind, layer parameters) in pattern order."""
    seen = {"rec": 0, "attn": 0}
    for kind in hybrid_layer_kinds(cfg):
        i = seen[kind]
        seen[kind] += 1
        yield kind, i, params[f"{kind}_layers"][i]


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
    if cfg.family == "hybrid":
        params["rec_layers"], params["attn_layers"] = [], []
        for kind in hybrid_layer_kinds(cfg):
            if kind == "rec":
                params["rec_layers"].append(_rec_layer_init(gen, cfg))
            else:
                params["attn_layers"].append(_attn_layer_init(gen, cfg))
        return params
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
           cfg: ModelConfig, causal: bool,
           window: Optional[int] = None) -> torch.Tensor:
    h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
    x = x + attn_apply(layer["attn"], h, cfg, angles=angles, causal=causal,
                       window=window)
    h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
    return x + mlp_apply(layer["mlp"], h)


def _rec_layer(layer, x: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
    x = x + rglru_apply(layer["rglru"], h, cfg)
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
    elif cfg.family == "hybrid":
        angles = _angles_for(cfg, batch, B, S, x.device)
        x = _hybrid_forward(params, x, angles, cfg, causal)
    else:
        angles = _angles_for(cfg, batch, B, S, x.device)
        body = _remat(functools.partial(_layer, cfg=cfg, causal=causal), cfg)
        for layer in params["layers"]:
            x = body(layer, x, angles)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = common.lm_logits(x, _lm_head(params, cfg), cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def _hybrid_forward(params, x: torch.Tensor, angles: torch.Tensor,
                    cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """The layers in pattern order, each under ``_remat``; attention layers
    see the local window.  (The JAX package scans whole pattern groups and
    unrolls the remainder layers; here every layer is one loop step.)"""
    rec = _remat(functools.partial(_rec_layer, cfg=cfg), cfg)
    att = _remat(functools.partial(_layer, cfg=cfg, causal=causal,
                                   window=cfg.local_window), cfg)
    for kind, _, layer in _hybrid_layers(params, cfg):
        x = rec(layer, x) if kind == "rec" else att(layer, x, angles)
    return x


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

def _stack_cache(one: Dict[str, torch.Tensor], n: int
                 ) -> Dict[str, torch.Tensor]:
    return {k: v[None].repeat((n,) + (1,) * v.ndim) for k, v in one.items()}


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> Dict[str, Any]:
    """dense: contiguous k/v (L, B, max_len, Hkv, hd); ssm: per-layer
    recurrent state ``layers`` = {"conv" (L, B, W-1, conv_dim), "ssm"
    (L, B, H, P, N) fp32}, whatever ``max_len``; hybrid: ``rec`` = {"conv"
    (n_rec, B, W-1, lru_width), "h" (n_rec, B, lru_width) fp32} and ring
    k/v (n_attn, B, min(local_window, max_len), Hkv, hd); all with lengths
    (B,)."""
    check_family(cfg)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        return {"layers": _stack_cache(ssd_init_cache(cfg, batch, device),
                                       cfg.num_layers),
                "lengths": lengths}
    hd = cfg.resolved_head_dim
    cdt = torch_dtype(cfg.dtype)
    if cfg.family == "hybrid":
        kinds = hybrid_layer_kinds(cfg)
        n_rec = kinds.count("rec")
        w = min(cfg.local_window, max_len)
        shape = (len(kinds) - n_rec, batch, w, cfg.num_kv_heads, hd)
        return {
            "rec": _stack_cache(rglru_init_cache(cfg, batch, device), n_rec),
            "k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device),
            "lengths": lengths,
        }
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
    :func:`lm_init_cache` with every layer's K/V at positions 0..S-1 (the
    hybrid family's ring: the last ``w`` positions at ring index pos % w),
    or every recurrent layer's state after position S-1, and ``lengths`` =
    S)."""
    check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = common.embed_tokens(params["embed"], tokens, cfg)
    cache = lm_init_cache(cfg, B, max_len, x.device)
    if cfg.family == "ssm":
        x = _ssm_prefill(params, x, cache["layers"], cfg)
    elif cfg.family == "hybrid":
        x = _hybrid_prefill(params, batch, x, cache, cfg)
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


def _ring_fill(cache_kv: torch.Tensor, kv: torch.Tensor, w: int) -> None:
    """Write the last ``w`` positions of kv (B, S, H, D) into the ring cache
    (B, w, H, D) at ring indices pos % w, in place."""
    S = kv.shape[1]
    n = min(S, w)
    idx = torch.arange(S - n, S, device=kv.device) % w
    cache_kv[:, idx] = kv[:, S - n:].to(cache_kv.dtype)


def _hybrid_prefill(params, batch, x: torch.Tensor, cache,
                    cfg: ModelConfig) -> torch.Tensor:
    B, S = x.shape[:2]
    angles = _angles_for(cfg, batch, B, S, x.device)
    w = cache["k"].shape[2]
    states = cache["rec"]
    for kind, i, layer in _hybrid_layers(params, cfg):
        h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
        if kind == "rec":
            y, st = rglru_apply(layer["rglru"], h, cfg, return_state=True)
            for key, v in st.items():
                states[key][i] = v
        else:
            y, (k, v) = attn_apply(layer["attn"], h, cfg, angles=angles,
                                   causal=True, window=cfg.local_window,
                                   return_kv=True)
            _ring_fill(cache["k"][i], k, w)
            _ring_fill(cache["v"][i], v, w)
        x = x + y
        h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
        x = x + mlp_apply(layer["mlp"], h)
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
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, x, cache, cfg)
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


def _hybrid_decode(params, x: torch.Tensor, cache, cfg: ModelConfig
                   ) -> torch.Tensor:
    """Attention layers write the ring at lengths % w and attend over
    min(lengths + 1, w) entries; recurrent layers update their states in
    place."""
    lengths = cache["lengths"]
    w = cache["k"].shape[2]
    ring = lengths % w
    eff_len = torch.clamp(lengths + 1, max=w)
    angles = common.rope_angles(lengths[:, None], cfg.resolved_head_dim,
                                cfg.rope_theta)
    states = cache["rec"]
    for kind, i, layer in _hybrid_layers(params, cfg):
        h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
        if kind == "rec":
            y, st = rglru_decode(layer["rglru"], h,
                                 {k: v[i] for k, v in states.items()}, cfg)
            for key, v in st.items():
                states[key][i] = v
        else:
            y, _, _ = attn_decode(layer["attn"], h, cfg,
                                  k_cache=cache["k"][i],
                                  v_cache=cache["v"][i], lengths=lengths,
                                  angles=angles, write_pos=ring,
                                  valid_len=eff_len)
        x = x + y
        h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
        x = x + mlp_apply(layer["mlp"], h)
    return x
