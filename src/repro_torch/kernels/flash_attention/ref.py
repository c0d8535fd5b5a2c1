"""Plain PyTorch versions of GQA flash attention (causal / windowed / offset).

Follows ``repro/kernels/flash_attention/ref.py``: ``attention_reference`` is
the dense oracle (fp32 scores and softmax), ``attention_reference_chunked``
the online softmax over K blocks inside a loop over Q blocks, which never
holds the (Sq, Sk) scores; ``attention_reference_tiled`` walks the tiles as
the CUDA wgmma and fp32 kernels do (``tile_plan``: skipped, full and edge
tiles; the exp2-domain online softmax).  Query head h reads KV head ``h // G`` through a
(Hkv, G) split of the query heads, so repeated K/V is never formed.  Masks
(causal, window, ``q_offset``) are applied before the softmax.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.kernel import WGMMA_TILES

NEG_INF = -1e30
LOG2E = 1.4426950408889634


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


def tile_plan(q0: int, Sq: int, Sk: int, bm: int, bn: int, causal: bool,
              window: Optional[int], q_offset: int) -> List[Tuple[int, str]]:
    """The key tiles that a CUDA kernel's block of query rows
    ``[q0, min(q0 + bm, Sq))`` visits, in order, as ``(first key, kind)``.
    Tiles that no row sees are skipped; a tile is ``"full"`` when every
    (row, key) pair of it is visible and all its keys lie below Sk, else
    ``"edge"`` (masked per element)."""
    qmin = q_offset + q0
    qmax = q_offset + min(q0 + bm, Sq) - 1
    lo, hi = 0, Sk
    if causal:
        hi = min(hi, qmax + 1)
    if window is not None:
        lo = max(lo, qmin - window + 1)
    if hi <= lo:
        return []
    plan = []
    for t in range(lo // bn, -(-hi // bn)):
        k0 = t * bn
        full = (k0 + bn <= Sk and (not causal or k0 + bn - 1 <= qmin)
                and (window is None or k0 > qmax - window))
        plan.append((k0, "full" if full else "edge"))
    return plan


def attention_reference_tiled(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
    tiles: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """A CUDA kernel's algorithm in plain PyTorch: blocks of ``bm`` query
    rows walk the key tiles of :func:`tile_plan` (``bn`` keys each; ``tiles
    = (bm, bn)``, by default the wgmma kernel's at this head dim,
    :data:`WGMMA_TILES`; the fp32 kernel's are ``kernel.F32_TILES``) with
    an online softmax in the exp2 domain (scale * log2(e) folded into one
    multiply), masking only the edge tiles (-1e30; keys past Sk are absent
    and add exactly 0), p rounded to v's dtype before the PV product, fp32
    sums.  A row whose block visits no tile is 0."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    if tiles is None and D not in WGMMA_TILES:
        raise ValueError(f"attention_reference_tiled: no wgmma kernel at "
                         f"head_dim {D}")
    bm, bn = WGMMA_TILES[D] if tiles is None else tiles
    c = (D ** -0.5 if scale is None else scale) * LOG2E
    qf = q.reshape(B, Sq, Hkv, G, D).float()
    out = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
    for q0 in range(0, Sq, bm):
        n = min(bm, Sq - q0)
        qb = qf[:, q0:q0 + n]
        m = torch.full((B, Hkv, G, n, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, n, 1), device=q.device)
        acc = torch.zeros((B, Hkv, G, n, D), device=q.device)
        for k0, kind in tile_plan(q0, Sq, Sk, bm, bn, causal, window,
                                  q_offset):
            kb = k[:, k0:k0 + bn].float()
            vb = v[:, k0:k0 + bn]
            x = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * c
            if kind == "edge":
                mask = _mask(n, kb.shape[1], q_offset, causal, window,
                             q.device, k_start=k0, q_start=q0)
                x = torch.where(mask, x, NEG_INF)
            m_new = torch.maximum(m, torch.amax(x, dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        o = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
        out[:, q0:q0 + n] = o.permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
