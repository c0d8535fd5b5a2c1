"""ctypes wrapper of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/rglru_scan/kernel.py::linear_scan_pallas``.  The kernel is
bound by device memory; its design (one launch; a block of 8 warps for
every 32 channels walks the sequence in rounds of 8 chunks, one a warp,
through a cp.async ring in shared memory, a and b read once; the carry
between rounds in registers) is described in the source.  The wrapper
picks the chunk length (:func:`scan_plan`) and allocates the outputs; the
kernel keeps no state between calls.  The library builds at first call.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import (DTYPE_CODES, _build, check_cuda, sm_count,
                                 stream_ptr)

_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_I, _I, _P, _P,                      # a dtype, b dtype, a, b
             _P, _P,                              # h, h_last
             _I, _I, _I, _I, _P]                  # B, S, W, steps, stream

#: Channels a block; warps a block (chunks a round); rounds in its ring
#: (``kLanes``, ``kWarps``, ``kRounds`` in the source).
LANES, WARPS, ROUNDS = 32, 8, 3
#: Chunk lengths the source instantiates, longest first.
STEP_CHOICES = (32, 16)
#: Shared memory of one SM (H100), and what the runtime keeps a block.
SM_SMEM, BLOCK_RESERVED = 228 << 10, 1 << 10


class ScanPlan(NamedTuple):
    blocks: int          # ceil(B W / 32), one a group of 32 channels
    blocks_per_sm: int   # ceil(blocks / SMs): the waves of the launch
    steps: int           # L, steps a chunk
    smem: int            # dynamic shared memory of a block, bytes


def smem_bytes(steps: int, a_size: int, b_size: int) -> int:
    """A block's shared memory: each warp's ring of a and b, and the chunk
    aggregates of two rounds (``smem_bytes`` in the source)."""
    return (WARPS * ROUNDS * steps * LANES * (a_size + b_size)
            + 2 * WARPS * LANES * 8)


def scan_plan(sms: int, B: int, S: int, W: int, a_size: int,
              b_size: int) -> ScanPlan:
    """The launch plan of the scan, a pure function of its arguments.

    One block for every 32 of the B x W channels; its 8 warps take the
    sequence in rounds of 8 chunks of ``steps`` steps.  ``steps`` is the
    longest of :data:`STEP_CHOICES` whose block still lets two blocks share
    an SM (one block's meeting at the end of a round overlaps the other's
    streaming, and a longer chunk meets less often): 16 in fp32, 32 in
    bf16.  Any S is covered by ``ceil(S / (8 steps))`` rounds."""
    blocks = max(1, -(-B * W // LANES))
    steps = next((k for k in STEP_CHOICES
                  if 2 * (smem_bytes(k, a_size, b_size) + BLOCK_RESERVED)
                  <= SM_SMEM), STEP_CHOICES[-1])
    return ScanPlan(blocks, -(-blocks // max(sms, 1)), steps,
                    smem_bytes(steps, a_size, b_size))


def _entry():
    fn = _build.load("rglru_scan").rglru_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
    plan = scan_plan(sm_count(b.device.index), B, S, W, a.element_size(),
                     b.element_size())
    err = _entry()(
        DTYPE_CODES[a.dtype], DTYPE_CODES[b.dtype], a.data_ptr(),
        b.data_ptr(), h.data_ptr(), h_last.data_ptr(), B, S, W, plan.steps,
        stream_ptr(b.device))
    if err:
        raise RuntimeError(f"rglru_scan: launch failed with CUDA error {err}")
    linear_scan_cuda.launches += 1
    return h, h_last


#: Launches since the last reset (a plain count; set it to 0 to reset).
linear_scan_cuda.launches = 0
