"""ctypes wrapper of the CUDA SSD chunked scan (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas``.  The Pallas grid
walks the chunks in order with the whole (H, P, N) state in VMEM; the CUDA
version splits the scan into launches that are each parallel over (batch,
chunk, head) or (batch, head, state element), described in the source:
four on the tensor cores for bf16 x, B and C at mamba2's widths (P 64,
N 128), five on the CUDA cores otherwise.  The wrapper allocates the
outputs and the fp32 scratch (the per-chunk cumsum, C Bᵀ per chunk, the
per-chunk states).  The library builds at first call.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import DTYPE_CODES, _build, check_cuda, stream_ptr

_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_I, _I,                              # x dtype, B/C dtype
             _P, _P, _P, _P, _P, _P,              # x, dt, A, B, C, D
             _P, _P,                              # y, final_state
             _P, _P, _P,                          # scratch: cs, G, states
             _I, _I, _I, _I, _I, _I,              # batch, S, H, P, N, Q
             _P]                                  # stream

HEAD_DIMS = (4, 8, 16, 64)        # P
STATE_DIMS = (8, 16, 128)         # N
MAX_CHUNK = 256


def tensor_core_path(x_dtype: torch.dtype, bc_dtype: torch.dtype, P: int,
                     N: int) -> bool:
    """Whether the kernel takes its tensor-core path (``run`` in
    ``csrc/ssd_scan.cu``): bf16 x, B and C at P 64 and N 128 (mamba2's
    widths).  Its plain twin is ``ref.py::ssd_scan_reference_tc``."""
    return x_dtype == bc_dtype == torch.bfloat16 and P == 64 and N == 128


def _entry():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(
    x: torch.Tensor,       # (B, S, H, P) fp32 or bf16
    dt: torch.Tensor,      # (B, S, H) fp32
    A: torch.Tensor,       # (H,) fp32
    B: torch.Tensor,       # (B, S, N) x's dtype, or fp32
    C: torch.Tensor,       # (B, S, N) B's dtype
    D: torch.Tensor,       # (H,) fp32
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the scan on CUDA tensors: (y in x's dtype, final state fp32).
    The chunk is Q = min(chunk, S), and S must be a multiple of it."""
    if x.dtype not in DTYPE_CODES or B.dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_scan: dtypes x {x.dtype}, B {B.dtype} not "
                         "supported (float32 or bfloat16)")
    if x.dtype == torch.float32 and B.dtype != torch.float32:
        raise ValueError("ssd_scan: bfloat16 B and C need bfloat16 x")
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    if (dt.shape != (bsz, S, H) or A.shape != (H,) or D.shape != (H,)
            or B.shape != (bsz, S, N) or C.shape != B.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)} do not match")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: head_dim {P} not in {HEAD_DIMS} or "
                         f"state {N} not in {STATE_DIMS}")
    Q = min(chunk, S)
    if not 1 <= Q <= MAX_CHUNK or S % Q:
        raise ValueError(f"ssd_scan: chunk {Q} must be in [1, {MAX_CHUNK}] "
                         f"and divide the sequence {S}")
    check_cuda("ssd_scan", x.dtype, x=x)
    check_cuda("ssd_scan", B.dtype, B=B, C=C)
    check_cuda("ssd_scan", torch.float32, dt=dt, A=A, D=D)
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError("ssd_scan: tensors on more than one device")
    y = torch.empty_like(x)
    final_state = torch.empty((bsz, H, P, N), dtype=torch.float32,
                              device=x.device)
    nc = S // Q
    f32 = dict(dtype=torch.float32, device=x.device)
    cs = torch.empty((bsz, S, H), **f32)
    # C Bᵀ per chunk; whole 64 x 64 tiles on the tensor-core path
    qg = -(-Q // 64) * 64 if tensor_core_path(x.dtype, B.dtype, P, N) else Q
    G = torch.empty((bsz, nc, qg, qg), **f32)
    states = torch.empty((bsz, nc, H, P, N), **f32)
    err = _entry()(
        DTYPE_CODES[x.dtype], DTYPE_CODES[B.dtype], x.data_ptr(),
        dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        y.data_ptr(), final_state.data_ptr(), cs.data_ptr(), G.data_ptr(),
        states.data_ptr(), bsz, S, H, P, N, Q, stream_ptr(x.device))
    if err:
        raise RuntimeError(f"ssd_scan: launch failed with CUDA error {err}")
    ssd_scan_cuda.launches += 1
    return y, final_state


#: Launches since the last reset (a plain count; set it to 0 to reset).
ssd_scan_cuda.launches = 0
