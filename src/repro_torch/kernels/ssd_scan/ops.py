"""Public SSD ops: ``torch.ops.repro_torch.ssd_scan`` forward, recompute
backward.

Forward: the op's CUDA kernel is the ctypes launch (``kernel.py``), its
CPU kernel the plain version, its fake kernel the outputs' shapes and
dtypes (y in x's, the final state fp32).  Backward (``register_autograd``):
recompute through the plain version from the saved inputs and take its
gradients (the JAX package's ``_ssd_bwd``); JAX has no backward kernel
either.  A gradient that is not needed stays undefined (``None``), as
``set_materialize_grads(False)`` leaves it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import OPS_NAMESPACE, owned
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import (
    ssd_decode_reference, ssd_scan_reference)


@torch.library.custom_op(f"{OPS_NAMESPACE}::ssd_scan", mutates_args=(),
                         device_types="cpu")
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    y, fs = ssd_scan_reference(x, dt, A, B, C, D, chunk=chunk)
    return owned(y, x, dt, A, B, C, D), fs


@_ssd_op.register_kernel("cuda")
def _(x, dt, A, B, C, D, chunk):
    return ssd_scan_cuda(*(t.contiguous() for t in (x, dt, A, B, C, D)),
                         chunk=chunk)


@_ssd_op.register_fake
def _(x, dt, A, B, C, D, chunk):
    bsz, _, H, P = x.shape
    return (x.new_empty(x.shape),
            x.new_empty((bsz, H, P, B.shape[-1]), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    *tensors, chunk = inputs
    ctx.save_for_backward(*tensors)
    ctx.chunk = chunk
    ctx.set_materialize_grads(False)


def _backward(ctx, gy, gfs):
    inputs = ctx.saved_tensors
    with torch.enable_grad():
        args = [t.detach().requires_grad_() for t in inputs]
        outs = ssd_scan_reference(*args, chunk=ctx.chunk)
        pairs = [(o, g) for o, g in zip(outs, (gy, gfs)) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], args,
                                    [g for _, g in pairs],
                                    allow_unused=True)
    return (*grads, None)


_ssd_op.register_autograd(_backward, setup_context=_setup_context)


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
        y, fs = _ssd_op(x, dt, A, B, C, D, Q)
    return y[:, :S], fs


def ssd_decode_step(x, dt, A, B, C, D, state):
    """Single-token state update (O(1) per token; plain on both devices, as
    the JAX package has no decode kernel)."""
    return ssd_decode_reference(x, dt, A, B, C, D, state)
