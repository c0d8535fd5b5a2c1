"""Public decode-attention op: ``torch.ops.repro_torch.decode_attention``.

Its CPU kernel is the plain version, its CUDA kernel the ctypes launch
(``kernel.py``), its fake kernel the output's shape and dtype (q's), so
``torch.export`` traces a step that launches it."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import OPS_NAMESPACE, owned
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_reference


@torch.library.custom_op(f"{OPS_NAMESPACE}::decode_attention",
                         mutates_args=(), device_types="cpu")
def _decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor, window: Optional[int],
               scale: Optional[float]) -> torch.Tensor:
    return owned(decode_attention_reference(q, k, v, lengths, window=window,
                                            scale=scale), q, k, v)


@_decode_op.register_kernel("cuda")
def _(q, k, v, lengths, window, scale):
    return decode_attention_cuda(q, k, v, lengths, window=window, scale=scale)


@_decode_op.register_fake
def _(q, k, v, lengths, window, scale):
    return q.new_empty(q.shape)


def decode_attention(
    q: torch.Tensor,            # (B, Hq, D)
    k: torch.Tensor,            # (B, T, Hkv, D)
    v: torch.Tensor,
    lengths: torch.Tensor,      # (B,) int32 valid cache length
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    return _decode_op(q, k, v, lengths, window, scale)
