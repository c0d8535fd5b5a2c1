"""Plain PyTorch versions of GQA flash attention (causal / windowed / offset).

Follows ``repro/kernels/flash_attention/ref.py``: ``attention_reference`` is
the dense oracle (fp32 scores and softmax), ``attention_reference_chunked``
the online softmax over K blocks inside a loop over Q blocks, which never
holds the (Sq, Sk) scores.  Query head h reads KV head ``h // G`` through a
(Hkv, G) split of the query heads, so repeated K/V is never formed.  Masks
(causal, window, ``q_offset``) are applied before the softmax.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask(Sq: int, Sk: int, q_offset: int, causal: bool,
          window: Optional[int], device, k_start: int = 0,
          q_start: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: query ``q_offset + q_start + i`` sees key
    ``k_start + j``."""
    qpos = q_offset + q_start + torch.arange(Sq, device=device)[:, None]
    kpos = k_start + torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_reference(
    q: torch.Tensor,                # (B, Sq, Hq, D)
    k: torch.Tensor,                # (B, Sk, Hkv, D)
    v: torch.Tensor,                # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,   # local attention: attend to (q-window, q]
    q_offset: int = 0,              # global position of q[0] (prefill continuation)
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} KV heads")
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale

    qr = q.reshape(B, Sq, Hkv, G, D).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * scale
    mask = _mask(Sq, Sk, q_offset, causal, window, q.device)
    scores = torch.where(mask, scores, NEG_INF)

    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def attention_reference_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
    blk_q: int = 512,
    blk_k: int = 1024,
) -> torch.Tensor:
    """Online softmax over K blocks inside a loop over Q blocks; the (Sq, Sk)
    scores are never held.  Shapes that the blocks do not divide take the
    dense reference, as in the JAX version.  Blocks stay in the inputs'
    dtype and are upcast one block at a time (products of two bf16 values
    are exact in fp32, so this is the JAX einsums'
    ``preferred_element_type=float32``); p is rounded to v's dtype before
    the PV product, as there."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    blk_q = min(blk_q, Sq)
    blk_k = min(blk_k, Sk)
    if Sq % blk_q or Sk % blk_k:
        return attention_reference(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    outs = []
    for q0 in range(0, Sq, blk_q):
        qb = q[:, q0:q0 + blk_q].reshape(B, blk_q, Hkv, G, D).float()
        m = torch.full((B, Hkv, G, blk_q, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, blk_q, 1), device=q.device)
        acc = torch.zeros((B, Hkv, G, blk_q, D), device=q.device)
        for k0 in range(0, Sk, blk_k):
            kb = k[:, k0:k0 + blk_k].float()
            vb = v[:, k0:k0 + blk_k]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            mask = _mask(blk_q, blk_k, q_offset, causal, window, q.device,
                         k_start=k0, q_start=q0)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)               # (B,Hkv,G,blk_q,D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, blk_q, Hq, D))
    return torch.cat(outs, dim=1).to(q.dtype)
