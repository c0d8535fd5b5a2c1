"""Public paged decode-attention op, dispatched on the tensor's device."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import is_cpu
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_reference)


def paged_decode_attention(
    q: torch.Tensor,              # (B, Hq, D)
    k_pages: torch.Tensor,        # (NP, page, Hkv, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,     # (B, MAXP) int32
    lengths: torch.Tensor,        # (B,) int32
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if is_cpu(q):
        return paged_decode_attention_reference(
            q, k_pages, v_pages, page_table, lengths, window=window,
            scale=scale)
    return paged_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                window=window, scale=scale)
