"""ctypes wrapper of the CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/paged_attention/kernel.py::paged_decode_attention_pallas``.
The kernel reads K/V in place through the page table (no gathered copy of
the cache), is bound by device memory, and shares its design with the
contiguous decode kernel (``csrc/decode_common.cuh``).  Page ids are clipped
to [0, NP-1] inside the kernel before any address is formed, as
``paged_attention/kernel.py:128`` clips them.  The library builds at first
call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import (DTYPE_CODES, _build, arrival_counters,
                                 check_cuda, check_head_dim,
                                 decode_heads_per_block, decode_plan,
                                 stream_ptr)

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _P,  # dtype, q, k, v, table, lengths, out, ml, acc
             _I, _I, _I, _I, _I, _I, _I, _I,      # B, NP, page, maxp, Hkv, G, D, window
             _F, _I, _I, _P, _P]                  # scale, split_len, n_splits, stream, counters


def _entry():
    fn = _build.load("paged_attention").paged_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def paged_attention_cuda(
    q: torch.Tensor,              # (B, Hq, D)
    k_pages: torch.Tensor,        # (NP, page, Hkv, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,     # (B, MAXP) int32
    lengths: torch.Tensor,        # (B,) int32
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; output has q's dtype."""
    check_cuda("paged_attention", q.dtype, q=q, k_pages=k_pages,
               v_pages=v_pages, page_table_i32=page_table,
               lengths_i32=lengths)
    B, Hq, D = q.shape
    NP, page, Hkv, Dk = k_pages.shape
    maxp = page_table.shape[1] if page_table.dim() == 2 else -1
    if Dk != D or v_pages.shape != k_pages.shape or Hq % Hkv \
            or page_table.shape != (B, maxp) or lengths.shape != (B,):
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"page_table {tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not match")
    G = Hq // Hkv
    check_head_dim("paged_attention", q.dtype, D, G)
    if window is not None and window < 1:
        raise ValueError(f"paged_attention: window {window} must be >= 1")
    split_len, n_splits = decode_plan(q.device, q.dtype, B, Hkv, G, D,
                                      maxp * page)
    out = torch.empty_like(q)
    ml = torch.empty((B, Hkv, n_splits, G, 2), dtype=torch.float32,
                     device=q.device)
    acc = torch.empty((B, Hkv, n_splits, G, D), dtype=torch.float32,
                      device=q.device)
    counters = arrival_counters(
        q.device, B * Hkv * -(-G // decode_heads_per_block(q.dtype, D, G)))
    err = _entry()(
        DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ml.data_ptr(), acc.data_ptr(),
        B, NP, page, maxp, Hkv, G, D, 0 if window is None else int(window),
        D ** -0.5 if scale is None else float(scale), split_len, n_splits,
        stream_ptr(q.device), counters.data_ptr())
    if err:
        raise RuntimeError(f"paged_attention: launch failed with CUDA "
                           f"error {err}")
    paged_attention_cuda.launches += 1
    return out


#: Launches since the last reset (a plain count; set it to 0 to reset).
paged_attention_cuda.launches = 0
