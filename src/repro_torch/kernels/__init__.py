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
import functools
from typing import Dict, Optional, Tuple

import torch

#: dtype codes of the C entry points.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Blocks per SM that a decode launch aims for (splits of the T axis).
_BLOCKS_PER_SM = 4
#: The fp32 partials of a decode launch stay within 1/_PARTIAL_SHARE of the
#: K/V bytes it reads (``split_plan``).
_PARTIAL_SHARE = 8
#: Shortest and longest split of a decode launch at G <= 8 (``split_plan``),
#: in tokens.
_MIN_SPLIT, _MAX_SPLIT = 64, 256


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


def decode_heads_per_block(dtype: torch.dtype, D: int, G: int) -> int:
    """Query heads one decode block serves, as ``launch_d`` in
    ``csrc/decode_common.cuh`` chooses them: 16 for bf16 at G > 8 (the
    tensor-core split kernel), else 4 for G <= 4 or fp32 at D 256, else 8
    (bf16 at G <= 8 serves all G heads in one block, which these also
    give).  A larger group runs as ``ceil(G / heads)`` head chunks."""
    if dtype == torch.bfloat16 and G > 8:
        return 16
    return 4 if G <= 4 or (dtype == torch.float32 and D > 128) else 8


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(sms: int, B: int, Hkv: int, G: int, cap: int,
               element_size: int, head_chunks: int = 1) -> Tuple[int, int]:
    """(split_len, n_splits) of a decode launch over a cache of ``cap``
    tokens: B x Hkv x ``head_chunks`` blocks before the T axis is split.

    The rule, a pure function of its arguments:

    * fill the card: enough splits for ~4 blocks per SM, so a split is
      ``cap / (4 sms / (B Hkv head_chunks))`` tokens;
    * at G <= 8 (one launch, whose last-arriving block merges the splits),
      between ``_MIN_SPLIT`` and ``_MAX_SPLIT`` tokens: at least 64, so
      that a short row takes few splits and few merges, and at most 256, so
      that a long row is spread over many blocks instead of holding the
      launch's end;
    * bound the partials: each split writes G x D fp32 values per row and
      the row reads ``2 D element_size`` bytes of K/V per token, so splits
      of at least ``16 G / element_size`` tokens keep the partials (written
      once, read once) to at most 1/8 of the K/V bytes (128 tokens at bf16
      and G 16);
    * a multiple of 32 tokens, at least 32.
    """
    per_row = max(1, (_BLOCKS_PER_SM * sms) // max(B * Hkv * head_chunks, 1))
    split = -(-cap // per_row)
    if G <= 8:
        split = min(max(split, _MIN_SPLIT), _MAX_SPLIT)
    split = max(split, -(-(_PARTIAL_SHARE * 2 * G) // element_size))
    split = max(32, -(-split // 32) * 32)
    return split, -(-cap // split)


def decode_arrivals(length: int, cap: int, window: Optional[int],
                    split_len: int) -> int:
    """The splits of a row that hold a valid token, as the one-launch decode
    kernels count their arrivals (``csrc/decode_common.cuh::Span``):
    the tokens ``[max(length - window, 0), min(length, cap))`` fall in the
    consecutive splits ``lo // split_len .. (hi - 1) // split_len``.  0 when
    no token is valid (``length <= 0``, or a length at least ``window``
    past ``cap``); then the row's output is 0.  1 means the one split
    writes the output itself."""
    hi = min(length, cap)
    lo = max(length - window, 0) if window else 0
    return (hi - 1) // split_len - lo // split_len + 1 if hi > lo else 0


#: Arrival counters of the one-launch decode kernel, one int32 buffer per
#: (device, stream).
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters for a decode launch on
    ``device``'s current stream, zero between launches.

    The kernel's last-arriving block of each row resets its counter, so the
    buffer is zeroed only when it is first allocated (or grown) and is then
    kept.  A launch's counters must not be in use by a concurrent launch:
    the buffer is keyed by stream, and the launches of one stream run one
    after another."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device.index, stream.cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=stream.device)
        _COUNTERS[key] = buf
    return buf


def decode_plan(device: torch.device, dtype: torch.dtype, B: int, Hkv: int,
                G: int, D: int, cap: int) -> Tuple[int, int]:
    """The split plan the decode kernels launch with on ``device``."""
    chunks = -(-G // decode_heads_per_block(dtype, D, G))
    return split_plan(sm_count(device.index if device.index is not None
                               else torch.cuda.current_device()),
                      B, Hkv, G, cap, dtype.itemsize, chunks)


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
