"""Encoder-decoder assembly (seamless-m4t style, audio frontend stubbed).

Encoder: bidirectional self-attention over precomputed frame embeddings.
Decoder: causal self-attention and cross attention into the encoder
output.  The port of ``repro/models/encdec.py``: ``params["enc_layers"]``
and ``params["dec_layers"]`` are lists of per-layer dicts (JAX stacks them
for ``lax.scan``); caches keep JAX's layout, stacked on a leading layer
axis, and decode writes them in place.

Three of JAX's semantics are kept on purpose, as parity and not as
fixes: :func:`encode` attends over every frame, padded ones included;
:func:`decode_train`'s cross attention ignores ``enc_lens``; only
:func:`encdec_decode_step` honours ``enc_lens``.  A row whose ``enc_lens``
is 0 follows the port's decode rule and gets 0 from cross attention (the
JAX reference averages the masked frames).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import (
    attn_apply, attn_axes, attn_decode, attn_init, cross_attn_apply,
    cross_attn_decode, cross_kv)
from repro_torch.models.common import (
    EMBED_AXES, LM_HEAD_AXES, NORM_AXES, ones, rmsnorm, torch_dtype)
from repro_torch.models.mlp import MLP_AXES, mlp_apply, mlp_init
from repro_torch.models.transformer import _remat


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = torch_dtype(cfg.param_dtype)
    return {
        "ln1": ones((cfg.d_model,), pd, gen.device),
        "attn": attn_init(gen, cfg),
        "ln2": ones((cfg.d_model,), pd, gen.device),
        "mlp": mlp_init(gen, cfg),
    }


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = torch_dtype(cfg.param_dtype)
    return {
        "ln1": ones((cfg.d_model,), pd, gen.device),
        "self_attn": attn_init(gen, cfg),
        "ln_x": ones((cfg.d_model,), pd, gen.device),
        "cross_attn": attn_init(gen, cfg),
        "ln2": ones((cfg.d_model,), pd, gen.device),
        "mlp": mlp_init(gen, cfg),
    }


def encdec_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Full parameter dict on ``gen.device``: the decoder's token
    embedding and head, ``cfg.encoder_layers`` encoder and
    ``cfg.decoder_layers`` decoder layers, and the two final norms."""
    pd = torch_dtype(cfg.param_dtype)
    return {
        "embed": common.embedding_init(gen, cfg),
        "lm_head": common.lm_head_init(gen, cfg),
        "enc_layers": [_enc_layer_init(gen, cfg)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [_dec_layer_init(gen, cfg)
                       for _ in range(cfg.decoder_layers)],
        "ln_enc": ones((cfg.d_model,), pd, gen.device),
        "ln_f": ones((cfg.d_model,), pd, gen.device),
    }


def encdec_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of :func:`encdec_init`'s tree, leaf for leaf."""
    enc = [{"ln1": NORM_AXES, "attn": attn_axes(cfg), "ln2": NORM_AXES,
            "mlp": dict(MLP_AXES)} for _ in range(cfg.encoder_layers)]
    dec = [{"ln1": NORM_AXES, "self_attn": attn_axes(cfg), "ln_x": NORM_AXES,
            "cross_attn": attn_axes(cfg), "ln2": NORM_AXES,
            "mlp": dict(MLP_AXES)} for _ in range(cfg.decoder_layers)]
    return {"embed": EMBED_AXES, "lm_head": LM_HEAD_AXES, "enc_layers": enc,
            "dec_layers": dec, "ln_enc": NORM_AXES, "ln_f": NORM_AXES}


def _enc_layer(layer, x: torch.Tensor, angles: torch.Tensor, *,
               cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
    x = x + attn_apply(layer["attn"], h, cfg, angles=angles, causal=False)
    h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
    return x + mlp_apply(layer["mlp"], h)


def encode(params, embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """embeds (B, S_enc, d) precomputed frame embeddings -> the encoder
    output (B, S_enc, d): bidirectional over all S_enc frames (padded ones
    too, as in JAX), rotary at positions 0..S_enc-1, then ``ln_enc``."""
    x = embeds.to(torch_dtype(cfg.dtype))
    B, S = x.shape[:2]
    angles = common.rope_angles(
        common.default_positions(B, S, cfg, x.device),
        cfg.resolved_head_dim, cfg.rope_theta)
    body = _remat(functools.partial(_enc_layer, cfg=cfg), cfg)
    for layer in params["enc_layers"]:
        x = body(layer, x, angles)
    return rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _dec_layer(layer, x: torch.Tensor, enc_out: torch.Tensor,
               angles: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
    x = x + attn_apply(layer["self_attn"], h, cfg, angles=angles,
                       causal=True)
    h = rmsnorm(x, layer["ln_x"], cfg.norm_eps)
    kv = cross_kv(layer["cross_attn"], enc_out, cfg)
    x = x + cross_attn_apply(layer["cross_attn"], h, kv, cfg)
    h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
    return x + mlp_apply(layer["mlp"], h)


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S_dec) -> fp32 logits (B, S_dec,
    V).  Cross attention covers every encoder position (JAX's: no
    ``enc_lens`` here)."""
    x = common.embed_tokens(params["embed"], tokens, cfg)
    B, S = x.shape[:2]
    angles = common.rope_angles(
        common.default_positions(B, S, cfg, x.device),
        cfg.resolved_head_dim, cfg.rope_theta)
    body = _remat(functools.partial(_dec_layer, cfg=cfg), cfg)
    for layer in params["dec_layers"]:
        x = body(layer, x, enc_out, angles)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return common.lm_logits(x, params["lm_head"], cfg)


def encdec_forward(params, batch, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch {"embeds" (B, S_enc, d), "tokens" (B, S_dec)} -> (logits, aux
    0)."""
    enc_out = encode(params, batch["embeds"], cfg)
    logits = decode_train(params, batch["tokens"], enc_out, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device, enc_len: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """Self-attention K/V (L_dec, B, max_len, Hkv, hd), cross-attention
    K/V (L_dec, B, enc_len, Hkv, hd) with ``enc_len`` ``max_len`` by
    default (filled by :func:`encdec_prefill_cross`), ``enc_lens`` and
    ``lengths`` (B,) int32."""
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    cdt = torch_dtype(cfg.dtype)
    n_dec = cfg.decoder_layers
    enc_len = enc_len if enc_len is not None else max_len

    def zeros(T):
        return torch.zeros((n_dec, batch, T, hkv, hd), dtype=cdt,
                           device=device)

    return {
        "k": zeros(max_len), "v": zeros(max_len),
        "xk": zeros(enc_len), "xv": zeros(enc_len),
        "enc_lens": torch.zeros((batch,), dtype=torch.int32, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def encdec_cache_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """The logical axes of :func:`encdec_init_cache`'s leaves (the second
    value of JAX's ``encdec_init_cache``)."""
    kv = ("stack", "batch", "seq_kv", None, "head_dim")
    return {"k": kv, "v": kv, "xk": kv, "xv": kv, "enc_lens": ("batch",),
            "lengths": ("batch",)}


def encdec_prefill_cross(params, cache: Dict[str, torch.Tensor],
                         embeds: torch.Tensor, enc_lens: torch.Tensor,
                         cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Run the encoder and fill the cross-attention K/V of every decoder
    layer: the cache with ``xk``/``xv`` (L_dec, B, S_enc, Hkv, hd) and
    ``enc_lens`` replaced."""
    enc_out = encode(params, embeds, cfg)
    ks, vs = zip(*(cross_kv(layer["cross_attn"], enc_out, cfg)
                   for layer in params["dec_layers"]))
    return {**cache,
            "xk": torch.stack(ks).to(cache["xk"].dtype),
            "xv": torch.stack(vs).to(cache["xv"].dtype),
            "enc_lens": enc_lens.to(device=enc_out.device,
                                    dtype=torch.int32)}


def encdec_decode_step(params, cache: Dict[str, torch.Tensor],
                       tokens: torch.Tensor, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B,) -> (fp32 logits (B, V), cache): causal self attention
    over the decoder's cache (written in place at ``lengths``), cross
    attention over the first ``enc_lens`` encoder positions; ``lengths``
    advances by one."""
    lengths = cache["lengths"]
    x = common.embed_tokens(params["embed"], tokens[:, None], cfg)
    angles = common.rope_angles(lengths[:, None], cfg.resolved_head_dim,
                                cfg.rope_theta)
    for li, layer in enumerate(params["dec_layers"]):
        h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
        a, _, _ = attn_decode(layer["self_attn"], h, cfg,
                              k_cache=cache["k"][li], v_cache=cache["v"][li],
                              lengths=lengths, angles=angles)
        x = x + a
        h = rmsnorm(x, layer["ln_x"], cfg.norm_eps)
        x = x + cross_attn_decode(layer["cross_attn"], h,
                                  (cache["xk"][li], cache["xv"][li]),
                                  cache["enc_lens"], cfg)
        h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
        x = x + mlp_apply(layer["mlp"], h)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = common.lm_logits(x, params["lm_head"], cfg)[:, 0]
    cache["lengths"] = lengths + 1
    return logits, cache
