"""RG-LRU recurrent block (Griffin / recurrentgemma).

Follows ``repro/models/rglru.py``.  Two parallel branches from d_model:
  (1) linear -> causal depthwise conv -> RG-LRU gated linear recurrence
  (2) linear -> GeLU (tanh approximation, ``jax.nn.gelu``'s default)
merged by an elementwise product and projected back to d_model.

The RG-LRU recurrence (diagonal gates):
  r_t = sigmoid(g_r * u_t + b_r)           recurrence gate
  i_t = sigmoid(g_i * u_t + b_i)           input gate
  a_t = exp(-c * softplus(a_param) * r_t)  (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
The gates and the recurrence run in fp32 (the scan sees fp32 a and b and
returns fp32 h, cast to the compute dtype afterwards); the projections and
the conv run in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import linear_scan, linear_scan_decode_step
from repro_torch.models.common import normal, torch_dtype, zeros

_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig
               ) -> Dict[str, torch.Tensor]:
    d, w = cfg.d_model, cfg.lru_width
    pd = torch_dtype(cfg.param_dtype)
    dev = gen.device
    f32 = torch.float32
    # a in (0.9, 0.999) at init, as in Griffin (deterministic, as in JAX)
    a = torch.linspace(0.9, 0.999, max(w, 1), dtype=f32, device=dev)
    return {
        "in_proj": normal(gen, (d, w), pd),
        "gate_proj": normal(gen, (d, w), pd),
        "conv_w": normal(gen, (cfg.conv_width, w), pd,
                         scale=cfg.conv_width ** -0.5),
        "conv_b": zeros((w,), pd, dev),
        "g_r": zeros((w,), f32, dev),
        "b_r": zeros((w,), f32, dev),
        "g_i": zeros((w,), f32, dev),
        "b_i": zeros((w,), f32, dev),
        "a_param": torch.log(torch.expm1(-torch.log(a) / _C)),
        "out_proj": normal(gen, (w, d), pd, scale=w ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv (no activation). x: (B, S, C), w: (W, C),
    state: (B, W-1, C) history (zeros when None)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


def _gates(p, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (..., w) -> fp32 (a, b) of the recurrence h' = a h + b."""
    u32 = u.float()
    r = torch.sigmoid(p["g_r"] * u32 + p["b_r"])
    i = torch.sigmoid(p["g_i"] * u32 + p["b_i"])
    log_a = -_C * F.softplus(p["a_param"]) * r
    a = torch.exp(log_a)
    # 1 - a^2 as -expm1(2 log a), the JAX version's 1 - a*a to fp32
    # precision: near a = 1 (the slow channels) 1 - a*a would magnify a's
    # rounding by 1 / (1 - a^2)
    b = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12)) * \
        (i * u32)
    return a, b


def _gate_branch(p, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ p["gate_proj"].to(x.dtype), approximate="tanh")


def rglru_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
                return_state: bool = False):
    """Full-sequence recurrent branch. x: (B, S, d) -> (B, S, d); with
    ``return_state`` also the decode cache after position S-1: ``conv``
    (B, W-1, w) = the last W-1 inputs of the conv (before it, left-padded
    with zeros when S < W-1) in ``cfg.dtype``, and ``h`` (B, w) fp32."""
    dt = x.dtype
    B, S, _ = x.shape
    u_pre = x @ p["in_proj"].to(dt)
    u = _causal_conv(u_pre, p["conv_w"], p["conv_b"])
    a, b = _gates(p, u)
    h, h_last = linear_scan(a, b)
    out = (h.to(dt) * _gate_branch(p, x)) @ p["out_proj"].to(dt)
    if not return_state:
        return out
    w = cfg.conv_width
    tail = u_pre[:, max(S - (w - 1), 0):]
    pad = torch.zeros((B, max(w - 1 - S, 0), cfg.lru_width),
                      dtype=u_pre.dtype, device=x.device)
    conv_tail = torch.cat([pad, tail], dim=1)
    return out, {"conv": conv_tail.to(torch_dtype(cfg.dtype)), "h": h_last}


def rglru_init_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }


def rglru_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (B, 1, d) -> (out (B, 1, d), new cache)."""
    dt = x.dtype
    u = x @ p["in_proj"].to(dt)
    new_conv = torch.cat([cache["conv"], u.to(cache["conv"].dtype)],
                         dim=1)[:, 1:]
    u = _causal_conv(u, p["conv_w"], p["conv_b"], state=cache["conv"])
    a, b = _gates(p, u[:, 0])
    h = linear_scan_decode_step(a, b, cache["h"])
    out = (h.to(dt)[:, None] * _gate_branch(p, x)) @ p["out_proj"].to(dt)
    return out, {"conv": new_conv, "h": h}
