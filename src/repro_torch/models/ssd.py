"""Mamba2 (SSD) block: in-proj, causal depthwise conv, SSD scan, gated norm.

Follows ``repro/models/ssd.py``: the input projection is kept as three
matrices (z gate | x, then B | C, then dt); x, B and C pass through a
width-``conv_width`` causal depthwise convolution with SiLU; the SSD scan
runs per head with head_dim P and state N.  dt is
``softplus(dt_raw + dt_bias)`` in fp32 and ``A = -exp(a_log)``, so the scan
takes x, B and C in the compute dtype and dt, A and D in fp32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_decode_step, ssd_scan
from repro_torch.models.common import normal, ones, rmsnorm, torch_dtype, zeros


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    return di, n, h, di + 2 * n         # conv_dim: x, B, C


def ssd_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    di, n, h, conv_dim = _dims(cfg)
    pd = torch_dtype(cfg.param_dtype)
    dev = gen.device
    return {
        "in_proj_zx": normal(gen, (d, 2 * di), pd),
        "in_proj_bc": normal(gen, (d, 2 * n), pd),
        "in_proj_dt": normal(gen, (d, h), pd),
        "conv_w": normal(gen, (cfg.conv_width, conv_dim), pd,
                         scale=cfg.conv_width ** -0.5),
        "conv_b": zeros((conv_dim,), pd, dev),
        "dt_bias": zeros((h,), torch.float32, dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, max(h, 1),
                                          dtype=torch.float32, device=dev)),
        "d_skip": ones((h,), torch.float32, dev),
        "gate_norm": ones((di,), pd, dev),
        "out_proj": normal(gen, (di, d), pd, scale=di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv with SiLU. x: (B,S,C), w: (W,C), state:
    (B,W-1,C) history (zeros when None)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return F.silu(out + b[None, None, :])


def _project(p, x: torch.Tensor, cfg: ModelConfig):
    """(z, conv_in = [x | B | C], dt_raw) of x (B, S, d)."""
    di = cfg.d_inner
    dt_ = x.dtype
    zx = x @ p["in_proj_zx"].to(dt_)
    bc = x @ p["in_proj_bc"].to(dt_)
    dt_raw = x @ p["in_proj_dt"].to(dt_)
    z, xin = zx[..., :di], zx[..., di:]
    return z, torch.cat([xin, bc], dim=-1), dt_raw


def _gate_out(p, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
              dtype: torch.dtype) -> torch.Tensor:
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(dtype)


def ssd_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              return_state: bool = False):
    """Full-sequence SSD block (training / prefill). x: (B,S,d) -> (B,S,d);
    with ``return_state`` also the decode cache {"conv", "ssm"} after the
    last position."""
    B_, S, _ = x.shape
    di, n, h, conv_dim = _dims(cfg)
    z, conv_in, dt_raw = _project(p, x, cfg)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xin, Bm, Cm = conv_out[..., :di], conv_out[..., di:di + n], \
        conv_out[..., di + n:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    xh = xin.reshape(B_, S, h, cfg.ssm_head_dim)
    y, final_state = ssd_scan(xh, dt, A, Bm, Cm, p["d_skip"],
                              chunk=cfg.ssd_chunk)
    out = _gate_out(p, y.reshape(B_, S, di), z, cfg, x.dtype)
    if return_state:
        w = cfg.conv_width
        pad = torch.zeros((B_, max(w - 1 - S, 0), conv_dim),
                          dtype=conv_in.dtype, device=x.device)
        conv_tail = torch.cat([pad, conv_in[:, -(w - 1):]], dim=1)
        return out, {"conv": conv_tail.to(torch_dtype(cfg.dtype)),
                     "ssm": final_state}
    return out


def ssd_init_cache(cfg: ModelConfig, batch: int,
                   device) -> Dict[str, torch.Tensor]:
    """Per-layer decode state: conv history and SSM state."""
    di, n, h, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
    }


def ssd_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (B,1,d) -> (out (B,1,d), new cache)."""
    B_ = x.shape[0]
    di, n, h, _ = _dims(cfg)
    z, conv_in, dt_raw = _project(p, x, cfg)                # conv_in (B,1,C)
    new_conv = torch.cat([cache["conv"], conv_in], dim=1)[:, 1:]
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                            state=cache["conv"])[:, 0]
    xin, Bm, Cm = conv_out[:, :di], conv_out[:, di:di + n], \
        conv_out[:, di + n:]

    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    xh = xin.reshape(B_, h, cfg.ssm_head_dim)
    y, new_ssm = ssd_decode_step(xh, dt, A, Bm, Cm, p["d_skip"],
                                 cache["ssm"])
    out = _gate_out(p, y.reshape(B_, 1, di), z, cfg, x.dtype)
    return out, {"conv": new_conv, "ssm": new_ssm}
