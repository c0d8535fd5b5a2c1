"""Plain PyTorch version of single-token GQA decode attention over a KV cache.

Follows ``repro/kernels/decode_attention/ref.py`` line by line, with one
difference: a row with ``lengths <= 0`` returns 0, as the kernels (Pallas
and CUDA) do, where the JAX reference averages masked entries uniformly.
The engine always attends over ``lengths + 1 >= 1`` entries.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_reference(
    q: torch.Tensor,          # (B, Hq, D) — one new token per sequence
    k: torch.Tensor,          # (B, T, Hkv, D) — KV cache (possibly padded)
    v: torch.Tensor,          # (B, T, Hkv, D)
    lengths: torch.Tensor,    # (B,) int32 — valid cache length per sequence
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale

    # products of two bf16 values are exact in fp32, so upcasting before the
    # einsum is the JAX reference's preferred_element_type=float32
    qr = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qr.float(), k.float()) * scale
    tpos = torch.arange(T, device=q.device)[None, :]        # (1, T)
    lens = lengths.to(torch.int64)[:, None]
    valid = tpos < lens                                     # (B, T)
    if window is not None:
        valid &= tpos >= (lens - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgt,bthd->bhgd", p.to(v.dtype).float(), v.float())
    out = out * (lengths > 0).to(out.dtype)[:, None, None, None]
    return out.reshape(B, Hq, D).to(q.dtype)
