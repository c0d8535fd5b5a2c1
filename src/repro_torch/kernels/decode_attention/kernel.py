"""ctypes wrapper of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``.  The
kernel is bound by device memory (it reads ``len x Hkv x D x 2`` cache
elements); its design — the T axis split over blocks under
``kernels.split_plan``, each block serving a KV group's query heads (bf16
at G > 8: 16 on the tensor cores, with a second kernel merging the splits;
bf16 at G <= 8: all G on the tensor cores, fp32: up to 8 on the CUDA
cores, more as head chunks, both in one launch whose last-arriving block
of each row merges the splits, counted in ``kernels.arrival_counters``) —
is described in ``csrc/decode_common.cuh``.
Its plain twin under a given plan is
``ref.py::decode_attention_split_reference``.  The library builds at first
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
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P,      # dtype, q, k, v, lengths, out, ml, acc
             _I, _I, _I, _I, _I, _I,              # B, T, Hkv, G, D, window
             _F, _I, _I, _P, _P]                  # scale, split_len, n_splits, stream, counters


def _entry():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(
    q: torch.Tensor,            # (B, Hq, D)
    k: torch.Tensor,            # (B, T, Hkv, D)
    v: torch.Tensor,
    lengths: torch.Tensor,      # (B,) int32
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; output has q's dtype."""
    check_cuda("decode_attention", q.dtype, q=q, k=k, v=v, lengths_i32=lengths)
    B, Hq, D = q.shape
    Bk, T, Hkv, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape or Hq % Hkv \
            or lengths.shape != (B,):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"lengths {tuple(lengths.shape)} do not match")
    G = Hq // Hkv
    check_head_dim("decode_attention", q.dtype, D, G)
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} must be >= 1")
    split_len, n_splits = decode_plan(q.device, q.dtype, B, Hkv, G, D,
                                      T)
    out = torch.empty_like(q)
    ml = torch.empty((B, Hkv, n_splits, G, 2), dtype=torch.float32,
                     device=q.device)
    acc = torch.empty((B, Hkv, n_splits, G, D), dtype=torch.float32,
                      device=q.device)
    counters = arrival_counters(
        q.device, B * Hkv * -(-G // decode_heads_per_block(q.dtype, D, G)))
    err = _entry()(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ml.data_ptr(), acc.data_ptr(),
        B, T, Hkv, G, D, 0 if window is None else int(window),
        D ** -0.5 if scale is None else float(scale), split_len, n_splits,
        stream_ptr(q.device), counters.data_ptr())
    if err:
        raise RuntimeError(f"decode_attention: launch failed with CUDA "
                           f"error {err}")
    decode_attention_cuda.launches += 1
    return out


#: Launches since the last reset (a plain count; set it to 0 to reset).
decode_attention_cuda.launches = 0
