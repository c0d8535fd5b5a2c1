"""Plain PyTorch version of paged decode attention: gather pages, then dense.

Follows ``repro/kernels/paged_attention/ref.py``; page ids are clipped to
[0, NP-1] before the gather, so FAIL (-1) ids and garbage past the length
address a real page and are masked by ``lengths``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_reference


def paged_decode_attention_reference(
    q: torch.Tensor,            # (B, Hq, D)
    k_pages: torch.Tensor,      # (NP, page, Hkv, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (B, MAXP) int32 page ids (garbage past length)
    lengths: torch.Tensor,      # (B,) int32
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B = q.shape[0]
    NP, page, Hkv, D = k_pages.shape
    maxp = page_table.shape[1]
    safe = torch.clamp(page_table.to(torch.int64), 0, NP - 1)
    k = k_pages[safe].reshape(B, maxp * page, Hkv, D)
    v = v_pages[safe].reshape(B, maxp * page, Hkv, D)
    return decode_attention_reference(q, k, v, lengths, window=window,
                                      scale=scale)
