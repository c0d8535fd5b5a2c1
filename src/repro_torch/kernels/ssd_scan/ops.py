"""Public SSD ops: device dispatch forward, recompute backward.

Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  Backward: recompute through the plain version from the saved
inputs and take its gradients (the JAX package's ``_ssd_bwd``); JAX has no
backward kernel either.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import is_cpu
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import (
    ssd_decode_reference, ssd_scan_reference)


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        if is_cpu(x):
            return ssd_scan_reference(x, dt, A, B, C, D, chunk=chunk)
        return ssd_scan_cuda(*(t.contiguous() for t in (x, dt, A, B, C, D)),
                             chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gfs):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in inputs]
            outs = ssd_scan_reference(*args, chunk=ctx.chunk)
            pairs = [(o, g) for o, g in zip(outs, (gy, gfs)) if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], args,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        return (*grads, None)


def pad_to_chunk(x, dt, B, C, chunk: int):
    """(x, dt, B, C, Q): Q = min(chunk, S), and the four sequences
    zero-padded at the end to a multiple of Q (dt = 0 gives decay 1 and zero
    input: the final state is unaffected)."""
    S = x.shape[1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        def pad_s(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        x, dt, B, C = pad_s(x), pad_s(dt), pad_s(B), pad_s(C)
    return x, dt, B, C, Q


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y, final_state).

    Sequences that do not divide the chunk are zero-padded at the end
    (:func:`pad_to_chunk`) and y is sliced back.
    ``initial_state`` takes the plain version on both devices (prefill
    continuation), as in the JAX package; the training path always starts
    from a zero state.
    """
    S = x.shape[1]
    x, dt, B, C, Q = pad_to_chunk(x, dt, B, C, chunk)
    if initial_state is not None:
        y, fs = ssd_scan_reference(x, dt, A, B, C, D, chunk=Q,
                                   initial_state=initial_state)
    else:
        y, fs = _SSD.apply(x, dt, A, B, C, D, Q)
    return y[:, :S], fs


def ssd_decode_step(x, dt, A, B, C, D, state):
    """Single-token state update (O(1) per token; plain on both devices, as
    the JAX package has no decode kernel)."""
    return ssd_decode_reference(x, dt, A, B, C, D, state)
