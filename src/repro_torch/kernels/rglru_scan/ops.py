"""Public linear-scan ops: ``torch.ops.repro_torch.rglru_scan`` forward,
recompute backward.

Forward: the op's CUDA kernel is the ctypes launch (``kernel.py``), its
CPU kernel the plain version, its fake kernel the outputs' shapes and
dtypes (h in b's, h_last fp32).  Backward (``register_autograd``):
recompute through the plain version from the saved a and b and take its
gradients (the JAX package's ``_lscan_bwd``); a gradient that is not
needed stays undefined (``None``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import OPS_NAMESPACE, owned
from repro_torch.kernels.rglru_scan.kernel import linear_scan_cuda
from repro_torch.kernels.rglru_scan.ref import (
    linear_scan_decode_reference, linear_scan_reference)


@torch.library.custom_op(f"{OPS_NAMESPACE}::rglru_scan", mutates_args=(),
                         device_types="cpu")
def _scan_op(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    h, h_last = linear_scan_reference(a, b)
    h = owned(h, a, b)
    return h, owned(h_last, h)


@_scan_op.register_kernel("cuda")
def _(a, b):
    return linear_scan_cuda(a.contiguous(), b.contiguous())


@_scan_op.register_fake
def _(a, b):
    return (b.new_empty(b.shape),
            b.new_empty((b.shape[0], b.shape[2]), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)
    ctx.set_materialize_grads(False)


def _backward(ctx, gh, ghl):
    inputs = ctx.saved_tensors
    with torch.enable_grad():
        args = [t.detach().requires_grad_() for t in inputs]
        outs = linear_scan_reference(*args)
        pairs = [(o, g) for o, g in zip(outs, (gh, ghl)) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], args,
                                    [g for _, g in pairs],
                                    allow_unused=True)
    return grads


_scan_op.register_autograd(_backward, setup_context=_setup_context)


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
    return _scan_op(a, b)


def linear_scan_decode_step(a: torch.Tensor, b: torch.Tensor,
                            h: torch.Tensor) -> torch.Tensor:
    """Single-token update h' = a h + b (all (B, W)) in fp32; plain on both
    devices, as the JAX package has no decode kernel."""
    return linear_scan_decode_reference(a, b, h)
