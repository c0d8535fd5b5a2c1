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


def decode_attention_split_reference(
    q: torch.Tensor,          # (B, Hq, D)
    k: torch.Tensor,          # (B, T, Hkv, D)
    v: torch.Tensor,
    lengths: torch.Tensor,    # (B,) int32
    *,
    split_len: int,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernels' split-and-merge under a plan of ``split_len`` tokens a
    split: per split, (m, l, acc) over its valid tokens (m the max score,
    l the sum of p = exp(s - m), acc the sum of p rounded to the cache's
    type times v; a split with no valid token has m = -1e30 and l = 0),
    then the merge of the splits that saw a valid token, with weights
    exp(m - max m).  A row with no valid token yields 0."""
    B, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    n_splits = -(-T // split_len)
    pad = n_splits * split_len - T

    qr = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bthd->bhgt", qr, k.float()) * scale
    tpos = torch.arange(T, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    valid = tpos < lens
    if window is not None:
        valid &= tpos >= (lens - window)
    s = torch.nn.functional.pad(s, (0, pad)).reshape(
        B, Hkv, G, n_splits, split_len)
    valid = torch.nn.functional.pad(valid, (0, pad)).reshape(
        B, 1, 1, n_splits, split_len)
    vs = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        B, n_splits, split_len, Hkv, D)

    seen = valid.any(-1)                                    # (B,1,1,ns)
    m = torch.where(valid, s, -torch.inf).amax(-1)
    m = torch.where(seen, m, NEG_INF)                       # (B,Hkv,G,ns)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgsl,bslhd->bhgsd", p.to(v.dtype).float(),
                       vs.float())

    used = l > 0
    M = torch.where(used, m, -torch.inf).amax(-1, keepdim=True)
    w = torch.where(used, torch.exp(m - M), 0.0)
    den = (w * l).sum(-1)                                   # (B,Hkv,G)
    num = torch.einsum("bhgs,bhgsd->bhgd", w, acc)
    out = torch.where(den[..., None] > 0,
                      num / torch.where(den > 0, den, 1.0)[..., None], 0.0)
    return out.reshape(B, Hq, D).to(q.dtype)
