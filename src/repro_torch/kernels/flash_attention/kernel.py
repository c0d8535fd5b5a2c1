"""ctypes wrapper of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.  At the
training shape the kernel is bound by operations (the two products); its
design (64 query rows per block, K/V tiles in shared memory, tiles that no
row sees skipped, mma.sync for bf16; at head_dim 256 the query tile in
shared memory too) is described in the source.  Head dims are those of
``kernels.HEAD_DIMS`` (16 to 256).  Unlike the Pallas kernel, any Sq and Sk
work.  The library builds at first call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import (DTYPE_CODES, HEAD_DIMS, _build, check_cuda,
                                 stream_ptr)

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGTYPES = [_I, _P, _P, _P, _P,                  # dtype, q, k, v, out
             _I, _I, _I, _I, _I, _I,              # B, Sq, Sk, Hq, Hkv, D
             _I, _I, _I, _F, _P]                  # causal, window, q_offset, scale, stream


def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(
    q: torch.Tensor,            # (B, Sq, Hq, D)
    k: torch.Tensor,            # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; output has q's shape and dtype."""
    check_cuda("flash_attention", q.dtype, q=q, k=k, v=v)
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape or Hq % Hkv or Sk < 1:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} must be >= 0")
    out = torch.empty_like(q)
    if Sq == 0:
        return out
    err = _entry()(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(bool(causal)),
        0 if window is None else int(window), int(q_offset),
        D ** -0.5 if scale is None else float(scale), stream_ptr(q.device))
    if err:
        raise RuntimeError(f"flash_attention: launch failed with CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return out


#: Launches since the last reset (a plain count; set it to 0 to reset).
flash_attention_cuda.launches = 0
