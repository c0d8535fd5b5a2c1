"""Public paged decode-attention op: ``torch.ops.repro_torch.
paged_attention``.

Its CPU kernel is the plain version, its CUDA kernel the ctypes launch
(``kernel.py``), its fake kernel the output's shape and dtype (q's), so
``torch.export`` traces the engine's decode step, which launches it once a
layer."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import OPS_NAMESPACE, owned
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_reference)


@torch.library.custom_op(f"{OPS_NAMESPACE}::paged_attention",
                         mutates_args=(), device_types="cpu")
def _paged_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              page_table: torch.Tensor, lengths: torch.Tensor,
              window: Optional[int], scale: Optional[float]) -> torch.Tensor:
    return owned(paged_decode_attention_reference(
        q, k_pages, v_pages, page_table, lengths, window=window,
        scale=scale), q, k_pages, v_pages)


@_paged_op.register_kernel("cuda")
def _(q, k_pages, v_pages, page_table, lengths, window, scale):
    return paged_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                window=window, scale=scale)


@_paged_op.register_fake
def _(q, k_pages, v_pages, page_table, lengths, window, scale):
    return q.new_empty(q.shape)


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
    return _paged_op(q, k_pages, v_pages, page_table, lengths, window, scale)
