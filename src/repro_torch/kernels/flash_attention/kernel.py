"""ctypes wrapper of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.  At the
training shape the kernel is bound by operations (the two products).  Three
variants, chosen by (dtype, head_dim) alone (:func:`flash_variant`):

* ``wgmma``: bf16 at head_dim 64, 128 and 256, the Hopper kernel (TMA ring
  of K/V tiles, wgmma for both products, one producer and two consumer
  warpgroups; tiles :data:`WGMMA_TILES`);
* ``mma``: bf16 at head_dim 16 and 32, mma.sync m16n8k16;
* ``fp32``: float32 at every head dim, on the CUDA cores: register-tiled
  outer products for both products, a cp.async ring of K/V chunks
  (tiles :data:`F32_TILES`).

Each design is described in the source.  Head dims are those of
``kernels.HEAD_DIMS`` (16 to 256).  Unlike the Pallas kernel, any Sq and Sk
work.  The library builds at first call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import (DTYPE_CODES, HEAD_DIMS, _build, check_cuda,
                                 stream_ptr)

#: Head dims of the bf16 Hopper (wgmma) variant.
WGMMA_HEAD_DIMS = (64, 128, 256)
#: (query rows a block, keys a tile) of the wgmma variant, by head dim.
WGMMA_TILES = {64: (128, 128), 128: (128, 128), 256: (128, 64)}
#: (query rows a block, keys a tile) of the fp32 variant, by head dim.
F32_TILES = {16: (64, 64), 32: (64, 64), 64: (64, 64), 128: (64, 64),
             256: (32, 64)}
VARIANTS = ("wgmma", "mma", "fp32")

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SHAPE_ARGS = [_P, _P, _P, _P,                    # q, k, v, out
               _I, _I, _I, _I, _I, _I,            # B, Sq, Sk, Hq, Hkv, D
               _I, _I, _I, _F, _P]                # causal, window, q_offset, scale, stream
_ENTRIES = {"wgmma": ("flash_attention_fwd_wgmma", _SHAPE_ARGS),
            "mma": ("flash_attention_fwd", [_I] + _SHAPE_ARGS),
            "fp32": ("flash_attention_fwd", [_I] + _SHAPE_ARGS)}


def flash_variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that a CUDA launch at (dtype, head_dim) takes."""
    if dtype == torch.float32:
        return "fp32"
    if dtype == torch.bfloat16:
        return "wgmma" if D in WGMMA_HEAD_DIMS else "mma"
    raise ValueError(f"flash_attention: dtype {dtype} not supported "
                     "(float32 or bfloat16)")


def _entry(variant: str):
    name, argtypes = _ENTRIES[variant]
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = argtypes
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
    variant = flash_variant(q.dtype, D)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} must be >= 0")
    out = torch.empty_like(q)
    if Sq == 0:
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, Hq, Hkv, D, int(bool(causal)),
            0 if window is None else int(window), int(q_offset),
            D ** -0.5 if scale is None else float(scale),
            stream_ptr(q.device))
    if variant != "wgmma":
        args = (DTYPE_CODES[q.dtype],) + args
    err = _entry(variant)(*args)
    if err:
        raise RuntimeError(f"flash_attention: {variant} launch failed with "
                           f"CUDA error {err}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_variant[variant] += 1
    return out


#: Launches since the last reset (plain counts; set them to 0 to reset):
#: the total and, in ``launches_by_variant``, each variant's.
flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
