"""Public flash-attention op: device dispatch forward, recompute backward.

Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  Backward: recompute through the plain version from the saved q, k
and v and take its gradients (the JAX package's ``_flash_bwd``), so no
(Sq, Sk) score tensor is saved between the passes.  Above
``_CHUNKED_THRESHOLD`` score elements the plain version is the chunked one,
in the backward and on the CPU alike.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import is_cpu
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (
    attention_reference, attention_reference_chunked)

# beyond this many score-matrix elements the plain path switches to the
# chunked online softmax (never materialises (Sq, Sk))
_CHUNKED_THRESHOLD = 1 << 22


def plain_attention(q, k, v, causal, window, q_offset, scale):
    if q.shape[1] * k.shape[1] > _CHUNKED_THRESHOLD:
        return attention_reference_chunked(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            scale=scale)
    return attention_reference(
        q, k, v, causal=causal, window=window, q_offset=q_offset, scale=scale)


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, q_offset, scale)
        if is_cpu(q):
            return plain_attention(q, k, v, causal, window, q_offset, scale)
        return flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, q_offset=q_offset, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = plain_attention(*qkv, *ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention. q: (B,Sq,Hq,D); k/v: (B,Sk,Hkv,D) with Hq % Hkv == 0."""
    return _Flash.apply(q, k, v, causal, window, q_offset, scale)
