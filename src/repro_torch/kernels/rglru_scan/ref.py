"""Plain PyTorch version of the diagonal linear recurrence (RG-LRU core).

  h_t = a_t * h_{t-1} + b_t        a, b: (B, S, W)

Follows ``repro/kernels/rglru_scan/ref.py``, which runs
``lax.associative_scan`` over the composition (a1, b1) . (a2, b2) =
(a1 a2, b1 a2 + b2).  Here the same composition runs as a log-step doubling
(Hillis-Steele) scan, as the Pallas kernel's ``_scan_block`` does: log2(S)
whole-tensor steps instead of S Python iterations, so the CPU tests and the
yardstick on the card stay quick at S in the thousands, and autograd records
a graph of log2(S) nodes.  It only multiplies the a's (no division by a
cumulative product, which would underflow).

``linear_scan_sequential_reference`` is the CUDA kernel's twin for the
bits: the recurrence one step at a time in fp32, a product and then a sum,
each rounded, in the kernel's chunk order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def linear_scan_reference(
    a: torch.Tensor,                      # (B, S, W), in (0, 1]
    b: torch.Tensor,                      # (B, S, W)
    h0: Optional[torch.Tensor] = None,    # (B, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h (B, S, W) in b's dtype, h_last (B, W) fp32); computes in
    fp32."""
    a_sc, b_sc = a.float(), b.float()
    S = a.shape[1]
    k = 1
    while k < S:
        b_sc = torch.cat(
            [b_sc[:, :k], b_sc[:, k:] + a_sc[:, k:] * b_sc[:, :-k]], dim=1)
        a_sc = torch.cat([a_sc[:, :k], a_sc[:, k:] * a_sc[:, :-k]], dim=1)
        k *= 2
    h = b_sc if h0 is None else b_sc + a_sc * h0.float()[:, None, :]
    return h.to(b.dtype), h[:, -1].float()


def linear_scan_sequential_reference(
    a: torch.Tensor,                      # (B, S, W)
    b: torch.Tensor,                      # (B, S, W)
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t step by step from h = 0, in fp32: a_t h
    rounded, then + b_t rounded (two eager ops, no fused multiply-add).
    With ``chunk`` = L, in the CUDA kernel's chunk order: the sequence in
    chunks of L steps; each chunk's aggregate from zero (A = the product of
    its a, H = its recurrence from 0), the carry into chunk k folded from
    chunk 0's onwards (c = A c + H), and the chunk's h step by step from
    its carry.  Returns (h (B, S, W) in b's dtype, h_last (B, W) fp32,
    never rounded to b's dtype).  S Python steps: for holding the kernel
    bit for bit, not for speed."""
    a_f, b_f = a.float(), b.float()
    B, S, W = a.shape
    L = S if chunk is None else chunk
    out = torch.empty((B, S, W), dtype=b.dtype, device=b.device)
    c = torch.zeros((B, W), dtype=torch.float32, device=b.device)
    h = c
    for t0 in range(0, S, L):
        h = c
        A = torch.ones_like(c)
        H = torch.zeros_like(c)
        for t in range(t0, min(t0 + L, S)):
            h = a_f[:, t] * h + b_f[:, t]
            out[:, t] = h
            if chunk is not None:
                A = A * a_f[:, t]
                H = a_f[:, t] * H + b_f[:, t]
        c = A * c + H
    return out, h


def linear_scan_decode_reference(a: torch.Tensor, b: torch.Tensor,
                                 h: torch.Tensor) -> torch.Tensor:
    """Single-token update: h' = a h + b (all (B, W)), in fp32."""
    return a.float() * h + b.float()
