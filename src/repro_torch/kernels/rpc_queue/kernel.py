"""ctypes wrapper of the batched queue's enqueue (``csrc/rpc_queue.cu``).

Replaces no Pallas kernel: the JAX package's ``RpcQueue._enqueue``
(``repro/core/rpc.py``) is array updates that XLA fuses into the jitted
program, and :func:`rpc_enqueue` is their one-launch counterpart on the
card (its plain version is ``ref.py::enqueue_reference``).  Python numbers
ride as kernel arguments, 0-d tensors and payloads are read on the device,
and nothing is read back to the host; a sanitized queue's flag is a
kernel argument too.  The library builds at first use.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rpc_queue.ref import PAYLOAD, Record

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint

#: Arguments a record may have (``kMaxArgs``).
MAX_ARGS = 31

#: Source dtype codes of the kernel (the ``enum`` in the source).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3, torch.int32: 4, torch.int64: 5, torch.int16: 6,
          torch.int8: 7, torch.uint8: 8, torch.bool: 9}


class _QueueLanes(ctypes.Structure):
    _fields_ = [(n, _P) for n in (
        "callee", "nargs", "imask", "pmask", "ivals", "fvals", "plens",
        "pbuf", "head", "phead", "adrops", "rwant", "base", "arrivals",
        "ticket")] + [(n, _I) for n in (
            "capacity", "width", "payload_capacity", "sanitize")]


class _RecordArg(ctypes.Structure):
    _fields_ = [("src", _P), ("kind", _I), ("dtype", _I), ("is_int", _I),
                ("length", _I), ("offset", _I), ("word", _U)]


class _Record(ctypes.Structure):
    _fields_ = [(n, _I) for n in (
        "callee", "nargs", "imask", "pmask", "rwant", "npay", "where_mode",
        "where_const")] + [("where", _P), ("args", _RecordArg * MAX_ARGS)]


def _entry():
    lib = _build.load("rpc_queue")
    if not getattr(lib, "typed", False):
        if (lib.rpc_queue_max_args() != MAX_ARGS
                or lib.rpc_queue_arg_bytes() != ctypes.sizeof(_RecordArg)):
            raise RuntimeError("rpc_queue: the library's record layout "
                               "differs from kernel.py's")
        lib.rpc_enqueue_launch.argtypes = [ctypes.POINTER(_QueueLanes),
                                           ctypes.POINTER(_Record), _P]
        lib.rpc_enqueue_launch.restype = _I
        lib.typed = True
    return lib.rpc_enqueue_launch


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr() if t.numel() else 0


def rpc_enqueue(state: torch.Tensor, geometry, arrivals: torch.Tensor,
                rec: Record) -> torch.Tensor:
    """Append ``rec`` in one launch on the current stream to the CUDA queue
    whose int32 words are ``state``, its lanes where ``geometry`` places
    them (``ops.py::geometry``: the lanes' addresses are computed from the
    offsets, no views); returns the ticket, a 0-d int32 tensor the stream
    fills.  ``arrivals`` is the queue's int32 counter (zero between
    launches).  The lanes are updated in place; a failed build or launch
    raises."""
    dev = state.device
    if dev.type != "cuda" or state.dtype != torch.int32 or \
            not state.is_contiguous():
        raise ValueError(f"rpc_enqueue: a {state.dtype} state on {dev}; the "
                         "kernel takes a contiguous int32 CUDA state")
    N, W, PC, R = geometry[:4]
    base = state.data_ptr()
    sizes = (N, N, N, N, N * W, N * W, N * W, PC, 1, 1, 1, R, 1)
    lane_ptrs = [base + 4 * at if n else 0
                 for at, n in zip(geometry[4:], sizes)]
    if len(rec.args) > MAX_ARGS:
        raise ValueError(f"rpc_enqueue: {len(rec.args)} arguments, at most "
                         f"{MAX_ARGS}")
    ticket = torch.empty((), dtype=torch.int32, device=dev)
    lanes = _QueueLanes(*lane_ptrs, _ptr(arrivals), _ptr(ticket), N, W, PC,
                        int(rec.sanitize))
    r = _Record(rec.callee, len(rec.args), rec.imask, rec.pmask, rec.rwant,
                rec.npay)
    if rec.where is None:
        r.where_mode = 0
    elif isinstance(rec.where, bool):
        r.where_mode, r.where_const = 1, int(rec.where)
    else:
        if rec.where.device != dev or rec.where.dtype != torch.bool:
            raise ValueError("rpc_enqueue: where must be a bool tensor on "
                             f"{dev}")
        r.where_mode, r.where = 2, rec.where.data_ptr()
    for j, a in enumerate(rec.args):
        ra = r.args[j]
        ra.kind, ra.is_int, ra.word = a.kind, int(a.is_int), a.word
        if a.src is not None:
            src = a.src
            if src.device != dev or src.dtype not in DTYPES or (
                    a.kind == PAYLOAD and not src.is_contiguous()):
                raise ValueError(f"rpc_enqueue: argument {j} ({src.dtype} on "
                                 f"{src.device}) is not a contiguous tensor "
                                 f"of {sorted(map(str, DTYPES))} on {dev}")
            ra.src, ra.dtype = _ptr(src), DTYPES[src.dtype]
            ra.length, ra.offset = a.length, a.offset
    err = _entry()(ctypes.byref(lanes), ctypes.byref(r),
                   ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"rpc_enqueue: launch failed with CUDA error {err}")
    rpc_enqueue.launches += 1
    return ticket


#: Launches since the last reset (a plain count; set it to 0 to reset).
rpc_enqueue.launches = 0
