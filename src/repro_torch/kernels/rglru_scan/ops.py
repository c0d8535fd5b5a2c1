"""Public linear-scan ops: device dispatch forward, recompute backward.

Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  Backward: recompute through the plain version from the saved a
and b and take its gradients (the JAX package's ``_lscan_bwd``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import is_cpu
from repro_torch.kernels.rglru_scan.kernel import linear_scan_cuda
from repro_torch.kernels.rglru_scan.ref import (
    linear_scan_decode_reference, linear_scan_reference)


class _LScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        ctx.set_materialize_grads(False)
        if is_cpu(b):
            return linear_scan_reference(a, b)
        return linear_scan_cuda(a.contiguous(), b.contiguous())

    @staticmethod
    def backward(ctx, gh, ghl):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in inputs]
            outs = linear_scan_reference(*args)
            pairs = [(o, g) for o, g in zip(outs, (gh, ghl)) if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], args,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        return grads


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t. Returns (h in b's dtype, h_last fp32).

    A non-zero ``h0`` (prefill continuation) folds into the first step,
    b_0' = b_0 + a_0 * h0, on a new tensor (the caller's ``b`` is left as
    it is), so the kernel always starts from zero."""
    if h0 is not None:
        b0 = b[:, :1] + (a[:, :1] * h0.to(b.dtype)[:, None]).to(b.dtype)
        b = torch.cat([b0, b[:, 1:]], dim=1)
    return _LScan.apply(a, b)


def linear_scan_decode_step(a: torch.Tensor, b: torch.Tensor,
                            h: torch.Tensor) -> torch.Tensor:
    """Single-token update h' = a h + b (all (B, W)) in fp32; plain on both
    devices, as the JAX package has no decode kernel."""
    return linear_scan_decode_reference(a, b, h)
