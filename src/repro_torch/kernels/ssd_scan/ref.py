"""Plain PyTorch versions of the mamba2 SSD (state-space duality) chunked scan.

Follows ``repro/kernels/ssd_scan/ref.py``.  Per head h, with state (P, N):

  state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * x_t (x) B_t
  y_t     = C_t . state_t + D_h * x_t

computed in chunks of Q steps: an intra-chunk masked quadratic term (the
"duality" with masked attention) plus a linear recurrence over the chunks'
states.  The JAX version runs that recurrence as an ``associative_scan``;
here it is a loop over the chunks, with the same semantics.  The arithmetic
is fp32 (fp64 when x is fp64, so that a check can hold fp32 against a
wider version).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _chunk(x: torch.Tensor, q: int) -> torch.Tensor:
    b, s = x.shape[:2]
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    return x.reshape((b, s // q, q) + tuple(x.shape[2:]))


def ssd_scan_reference(
    x: torch.Tensor,       # (B, S, H, P)
    dt: torch.Tensor,      # (B, S, H) positive
    A: torch.Tensor,       # (H,) negative
    B: torch.Tensor,       # (B, S, N)
    C: torch.Tensor,       # (B, S, N)
    D: torch.Tensor,       # (H,)
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32)."""
    return _scan(x, dt, A, B, C, D, chunk, initial_state, rounded=False)


def ssd_scan_reference_tc(x, dt, A, B, C, D, *, chunk: int = 256
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the kernel's tensor-core path (bf16 x, B and C):
    :func:`ssd_scan_reference` with the three operands that carry an fp32
    factor rounded where the kernel feeds them to the bf16 tensor cores, as
    two bf16 terms (hi = bf16(t), lo = bf16(t - hi): about 16 bits of
    mantissa; one bf16 term alone moves y by up to 10% of 1 + |y| at
    mamba2's widths, against a 3% tolerance): w x (w = exp(cs_end - cs) dt)
    in the chunk states, M = (C Bᵀ) exp(cs_i - cs_j) dt_j in the
    intra-chunk term, and the entering state in the inter-chunk term.  C Bᵀ
    and every product of two bf16 values are exact in fp32.  The carried
    state itself stays fp32."""
    return _scan(x, dt, A, B, C, D, chunk, None, rounded=True)


def _bf16(t: torch.Tensor, rounded: bool) -> torch.Tensor:
    """t, or where ``rounded`` the sum of its two bf16 terms as the kernel
    feeds them to the tensor cores: hi = bf16(t), lo = bf16(t - hi)."""
    if not rounded:
        return t
    hi = t.to(torch.bfloat16).to(t.dtype)
    return hi + (t - hi).to(torch.bfloat16).to(t.dtype)


def _scan(x, dt, A, B, C, D, chunk, initial_state, *, rounded):
    in_dtype = x.dtype
    cdt = torch.float64 if in_dtype == torch.float64 else torch.float32
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    x32, dt32 = x.to(cdt), dt.to(cdt)
    B32, C32, A32 = B.to(cdt), C.to(cdt), A.to(cdt)

    xc = _chunk(x32, Q)                      # (b, nc, Q, H, P)
    dtc = _chunk(dt32, Q)                    # (b, nc, Q, H)
    Bc = _chunk(B32, Q)                      # (b, nc, Q, N)
    Cc = _chunk(C32, Q)                      # (b, nc, Q, N)
    nc = xc.shape[1]

    da = dtc * A32                           # (b, nc, Q, H)
    cs = torch.cumsum(da, dim=2)             # inclusive cumsum within chunk

    # --- intra-chunk (masked quadratic / "attention" form) -------------------
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)            # (b, nc, Q, Q)
    # mask BEFORE exp: for j > i the argument is positive (cs decreases) and
    # can overflow; where(mask, exp(big), 0) would give 0 * inf = NaN in the
    # gradient
    arg = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (b,nc,Q,Q,H) i,j
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    arg = torch.where(mask[None, None, :, :, None], arg,
                      torch.full((), -1e30, dtype=cdt, device=x.device))
    seg = torch.exp(arg)
    M = G[..., None] * seg * dtc[:, :, None, :, :]        # weight j -> i
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", _bf16(M, rounded), xc)

    # --- chunk state contributions -------------------------------------------
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)       # (b, nc, Q, H)
    if rounded:
        xw = _bf16((decay_to_end * dtc)[..., None] * xc, True)
        S_c = torch.einsum("bcqhp,bcqn->bchpn", xw, Bc)
    else:
        S_c = torch.einsum("bcqh,bcqhp,bcqn->bchpn", decay_to_end * dtc, xc,
                           Bc)

    # --- inter-chunk linear recurrence over chunk states ----------------------
    T_c = torch.exp(cs[:, :, -1, :])                       # (b, nc, H)
    if initial_state is None:
        state = torch.zeros((bsz, H, P, N), dtype=cdt, device=x.device)
    else:
        state = initial_state.to(cdt)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = T_c[:, c, :, None, None] * state + S_c[:, c]
    s_excl = torch.stack(entering, dim=1)                  # (b, nc, H, P, N)

    cstate = torch.einsum("bcin,bchpn->bcihp", Cc, _bf16(s_excl, rounded))
    y_inter = torch.exp(cs)[..., None] * cstate

    y = (y_intra + y_inter).reshape(bsz, S, H, P)
    y = y + D.to(cdt)[None, None, :, None] * x32
    return y.to(in_dtype), state


def ssd_decode_reference(
    x: torch.Tensor,       # (B, H, P) one token
    dt: torch.Tensor,      # (B, H)
    A: torch.Tensor,       # (H,)
    B: torch.Tensor,       # (B, N)
    C: torch.Tensor,       # (B, N)
    D: torch.Tensor,       # (H,)
    state: torch.Tensor,   # (B, H, P, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence: (y (B,H,P) in x's dtype, new state)."""
    x32, dt32 = x.float(), dt.float()
    decay = torch.exp(dt32 * A.float())                     # (B, H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt32, x32, B.float())
    new_state = decay[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    y = y + D.float()[None, :, None] * x32
    return y.to(x.dtype), new_state
