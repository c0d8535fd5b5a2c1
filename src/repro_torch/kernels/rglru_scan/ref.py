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


def linear_scan_decode_reference(a: torch.Tensor, b: torch.Tensor,
                                 h: torch.Tensor) -> torch.Tensor:
    """Single-token update: h' = a h + b (all (B, W)), in fp32."""
    return a.float() * h + b.float()
