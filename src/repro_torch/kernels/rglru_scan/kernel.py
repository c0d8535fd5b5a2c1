"""ctypes wrapper of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/rglru_scan/kernel.py::linear_scan_pallas``.  The kernel is
bound by device memory; its design (the sequence cut into chunks, three
launches: chunk aggregates, carries across chunks, the scan of each chunk
from its carry) is described in the source.  The wrapper picks the chunk
length and allocates the outputs and the fp32 scratch.  The library builds
at first call.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import DTYPE_CODES, _build, check_cuda, stream_ptr

_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_I, _I, _P, _P,                      # a dtype, b dtype, a, b
             _P, _P, _P, _P,                      # h, h_last, agg_a, agg_h
             _I, _I, _I, _I, _P]                  # B, S, W, L, stream

#: Threads (4 channels each) that a launch aims for: ~4 blocks of 128 per SM.
_THREADS_PER_SM = 512
_MIN_CHUNK = 16


def _entry():
    fn = _build.load("rglru_scan").rglru_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def chunk_len(device: torch.device, B: int, S: int, W: int) -> int:
    """Steps per chunk: enough chunks that B x chunks x W/4 threads reach
    ~4 blocks per SM, each chunk a multiple of 16 steps (at least 16).
    Depends only on shapes, so equal shapes chunk alike."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = max(1, -(-_THREADS_PER_SM * sms // max(B * W // 4, 1)))
    L = -(-S // chunks)
    return max(_MIN_CHUNK, -(-L // _MIN_CHUNK) * _MIN_CHUNK)


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the scan on CUDA tensors a, b (B, S, W), each fp32 or bf16,
    from a zero state: (h in b's dtype, h_last (B, W) fp32)."""
    if a.dtype not in DTYPE_CODES or b.dtype not in DTYPE_CODES:
        raise ValueError(f"rglru_scan: dtypes a {a.dtype}, b {b.dtype} not "
                         "supported (float32 or bfloat16)")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} must be one (B, S, W)")
    B, S, W = a.shape
    if W % 4:
        raise ValueError(f"rglru_scan: width {W} must be a multiple of 4")
    check_cuda("rglru_scan", a.dtype, a=a)
    check_cuda("rglru_scan", b.dtype, b=b)
    if a.device != b.device:
        raise ValueError("rglru_scan: a and b on different devices")
    h = torch.empty_like(b)
    h_last = torch.empty((B, W), dtype=torch.float32, device=b.device)
    if S == 0 or B == 0:
        return h, h_last.zero_()
    L = chunk_len(b.device, B, S, W)
    nagg = -(-S // L) - 1
    agg = torch.empty((2, B, max(nagg, 1), W), dtype=torch.float32,
                      device=b.device)
    err = _entry()(
        DTYPE_CODES[a.dtype], DTYPE_CODES[b.dtype], a.data_ptr(),
        b.data_ptr(), h.data_ptr(), h_last.data_ptr(), agg[0].data_ptr(),
        agg[1].data_ptr(), B, S, W, L, stream_ptr(b.device))
    if err:
        raise RuntimeError(f"rglru_scan: launch failed with CUDA error {err}")
    linear_scan_cuda.launches += 1
    return h, h_last


#: Launches since the last reset (a plain count; set it to 0 to reset).
linear_scan_cuda.launches = 0
