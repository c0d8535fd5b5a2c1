"""Public decode-attention op, dispatched on the tensor's device."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import is_cpu
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_reference


def decode_attention(
    q: torch.Tensor,            # (B, Hq, D)
    k: torch.Tensor,            # (B, T, Hkv, D)
    v: torch.Tensor,
    lengths: torch.Tensor,      # (B,) int32 valid cache length
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if is_cpu(q):
        return decode_attention_reference(q, k, v, lengths, window=window,
                                          scale=scale)
    return decode_attention_cuda(q, k, v, lengths, window=window, scale=scale)
