"""GQA multi-head attention: the full-sequence path (training, prefill) on
the flash kernel, and the one-token decode path over a contiguous cache.

Query heads are zero-padded to ``cfg.padded_heads`` exactly as in the JAX
package, so query head h reads KV head ``h // (padded_heads // Hkv)``.  At
llama3.2-3b width that is 32 padded heads over 8 KV heads (G = 4): real
heads 0-23 read KV heads 0-5, and KV heads 6-7 serve only pad heads, whose
outputs ``_mask_heads`` zeroes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common
from repro_torch.models.common import normal, torch_dtype, zeros


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Q heads zero-padded to ``cfg.padded_heads``: pad rows of ``wq`` and
    ``wo`` are zero and their outputs are masked in ``_mask_heads``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.padded_heads, cfg.num_kv_heads
    real = cfg.num_heads
    pd = torch_dtype(cfg.param_dtype)
    dev = gen.device

    def padded(shape, scale=None, head_axis=None):
        v = normal(gen, shape, pd, scale=scale)
        if hq != real:
            mask_shape = [1] * len(shape)
            mask_shape[head_axis] = shape[head_axis]
            mask = (torch.arange(shape[head_axis], device=dev) < real)
            v = v * mask.reshape(mask_shape).to(pd)
        return v

    p = {
        "wq": padded((d, hq, hd), head_axis=1),
        "wk": normal(gen, (d, hkv, hd), pd),
        "wv": normal(gen, (d, hkv, hd), pd),
        "wo": padded((hq, hd, d), scale=(real * hd) ** -0.5, head_axis=0),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((hq, hd), pd, dev)
        p["bk"] = zeros((hkv, hd), pd, dev)
        p["bv"] = zeros((hkv, hd), pd, dev)
    return p


def _mask_heads(out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Zero pad-head outputs (dim -2 is heads)."""
    if cfg.padded_heads == cfg.num_heads:
        return out
    mask = torch.arange(cfg.padded_heads, device=out.device) < cfg.num_heads
    return out * mask[:, None].to(out.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, hd) -> (B, S, H, hd)."""
    d, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, H * hd)).reshape(
        *x.shape[:-1], H, hd)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 angles: Optional[torch.Tensor]):
    """x: (B,S,d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), rotary applied."""
    dt = x.dtype
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if angles is not None:
        q = common.apply_rope(q, angles)
        k = common.apply_rope(k, angles)
    return q, k, v


def attn_apply(
    p, x: torch.Tensor, cfg: ModelConfig, *,
    angles: Optional[torch.Tensor],
    causal: bool = True,
    window: Optional[int] = None,
    return_kv: bool = False,
):
    """Full-sequence attention (training / prefill): x (B, S, d) ->
    (B, S, d), and the rotated (k, v) (B, S, Hkv, hd) with ``return_kv``."""
    q, k, v = _project_qkv(p, x, cfg, angles)
    out = attn_out(p, flash_attention(q, k, v, causal=causal, window=window),
                   cfg)
    if return_kv:
        return out, (k, v)
    return out


def attn_out(p, a: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Attention output (..., Hq, hd) -> masked heads through ``wo`` ->
    (..., d)."""
    a = _mask_heads(a, cfg)
    hq, hd, d = p["wo"].shape
    return a.reshape(*a.shape[:-2], hq * hd) @ p["wo"].to(a.dtype).reshape(
        hq * hd, d)


def attn_decode(
    p, x: torch.Tensor, cfg: ModelConfig, *,
    k_cache: torch.Tensor,            # (B, T, Hkv, hd)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,            # (B,) current length BEFORE this token
    angles: Optional[torch.Tensor],   # (B, 1, hd//2)
    window: Optional[int] = None,
    write_pos: Optional[torch.Tensor] = None,   # ring-buffer write index (B,)
    valid_len: Optional[torch.Tensor] = None,   # valid entries AFTER the write (B,)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  Returns (out (B,1,d), k_cache, v_cache).  The
    caches are updated in place (the JAX version returns new arrays).

    The default is a contiguous cache: the token's K/V land at ``lengths``
    and attention covers ``lengths + 1`` entries.  ``write_pos`` and
    ``valid_len`` make the cache a ring buffer (local-attention windows):
    the K/V land at ``write_pos`` and attention covers the first
    ``valid_len`` entries, in ring order, which the softmax does not see
    because rotary phases were applied with absolute positions at write
    time."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, angles)      # S == 1
    idx = torch.arange(B, device=x.device)
    pos = (lengths if write_pos is None else write_pos).to(torch.int64)
    k_cache[idx, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[idx, pos] = v[:, 0].to(v_cache.dtype)
    vl = lengths + 1 if valid_len is None else valid_len
    out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                           vl, window=window)
    return attn_out(p, out, cfg)[:, None], k_cache, v_cache
