"""Hand-written CUDA kernels for the H100, one subpackage per Pallas kernel.

Each kernel subpackage follows the JAX package's layout:

  kernels/<name>/kernel.py  — ctypes wrapper around ``csrc/<name>.cu``
  kernels/<name>/ops.py     — public op, dispatched on the tensor's device
  kernels/<name>/ref.py     — plain PyTorch version of the same function

Dispatch is by device and nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises).  There is no
environment override and no fallback from a kernel to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

#: dtype codes of the C entry points.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Blocks per SM that a decode launch aims for (splits of the T axis).
_BLOCKS_PER_SM = 4


def is_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); False for a CUDA tensor
    (kernel).  Any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check_cuda(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous, on one CUDA device, 16-byte
    aligned, and of ``dtype`` (int32 for names ending in ``_i32``)."""
    device = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}; the kernel "
                             "takes CUDA tensors only")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        want = torch.int32 if key.endswith("_i32") else dtype
        if t.dtype != want:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


#: Head dims the decode and flash kernels take, in fp32 and bf16.
HEAD_DIMS = (16, 32, 64, 128, 256)


def check_head_dim(name: str, dtype: torch.dtype, D: int, G: int) -> None:
    """Raise unless the decode kernels take ``dtype``, head_dim ``D`` (in
    :data:`HEAD_DIMS`) and ``G`` >= 1 query heads per KV head."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if G < 1:
        raise ValueError(f"{name}: {G} query heads per KV head; the kernel "
                         "takes 1 or more")


def split_plan(device: torch.device, rows: int, cap: int) -> Tuple[int, int]:
    """(split_len, n_splits) for ``rows`` = B x Hkv blocks over a cache of
    ``cap`` tokens: enough splits for ~4 blocks per SM, each a multiple of
    32 tokens.  Depends only on shapes, so equal shapes split alike."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_row = max(1, (_BLOCKS_PER_SM * sms) // max(rows, 1))
    split = -(-cap // per_row)
    split = max(32, -(-split // 32) * 32)
    return split, -(-cap // split)


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
