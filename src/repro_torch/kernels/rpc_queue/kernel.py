"""ctypes wrapper of the batched queue's enqueue (``csrc/rpc_queue.cu``).

Replaces no Pallas kernel: the JAX package's ``RpcQueue._enqueue``
(``repro/core/rpc.py``) is array updates that XLA fuses into the jitted
program, and ``rpc_enqueue`` is their one-launch counterpart on the card
(its plain version is ``ref.py::enqueue_reference``).  Python numbers
ride as kernel arguments, 0-d tensors and payloads are read on the device,
and nothing is read back to the host; a sanitized queue's flag is a
kernel argument too.  The library builds at first use.

Two routes reach the one kernel, and both count in
``rpc_enqueue.launches``: the op's CUDA kernel (:func:`rpc_enqueue`,
which packs the parameters from the op's lists on every call), and a
queue's enqueue plan in eager mode (:class:`QueueLaunch` and
:class:`EnqueuePlan`: the lanes packed once a queue, a record's static
fields once a signature, a call patching only its words, its sources,
``where`` and the ticket).  Both pack through :func:`pack_lanes`
and :func:`pack_record`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rpc_queue.ref import DEVICE, IMMEDIATE, PAYLOAD

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint

#: Arguments a record may have (``kMaxArgs``).
MAX_ARGS = 31

#: Source dtype codes of the kernel (the ``enum`` in the source).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3, torch.int32: 4, torch.int64: 5, torch.int16: 6,
          torch.int8: 7, torch.uint8: 8, torch.bool: 9}

#: Words of a record argument in the op's ``args``: kind, is_int, word,
#: offset, length.
ARG_WORDS = 5

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
        lib.rpc_enqueue_launch.argtypes = [_P, _P, _P]
        lib.rpc_enqueue_launch.restype = _I
        lib.typed = True
    return lib.rpc_enqueue_launch


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr() if t.numel() else 0


def pack_lanes(state: torch.Tensor, geometry: Sequence[int],
               arrivals: torch.Tensor) -> _QueueLanes:
    """The kernel's view of the CUDA queue whose int32 words are ``state``,
    its lanes where ``geometry`` places them (``ops.py::geometry``: the
    lanes' addresses are computed from the offsets, no views), with no
    ticket and ``sanitize`` off: a launch sets both from its record.
    ``arrivals`` is the queue's int32 counter (zero between launches)."""
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
    return _QueueLanes(*lane_ptrs, _ptr(arrivals), 0, N, W, PC, 0)


def pack_record(header: Sequence[int], args: Sequence[int],
                srcs: Sequence[Optional[torch.Tensor]],
                where: Optional[torch.Tensor],
                dev: torch.device) -> _Record:
    """The kernel's parameters of one record, from the op's ``header``,
    ``args``, ``srcs`` and ``where`` (``ops.py::flatten``); every tensor
    on ``dev``, a payload contiguous, ``where`` a bool."""
    callee, imask, pmask, rwant, npay, _, where_mode, const = header
    nargs = len(srcs)
    if nargs > MAX_ARGS:
        raise ValueError(f"rpc_enqueue: {nargs} arguments, at most "
                         f"{MAX_ARGS}")
    r = _Record(callee, nargs, imask, pmask, rwant, npay, where_mode)
    if where_mode == 1:
        r.where_const = const
    elif where_mode == 2:
        if where is None or where.device != dev or \
                where.dtype != torch.bool:
            raise ValueError("rpc_enqueue: where must be a bool tensor on "
                             f"{dev}")
        r.where = where.data_ptr()
    for j, src in enumerate(srcs):
        kind, is_int, word, offset, length = \
            args[ARG_WORDS * j:ARG_WORDS * (j + 1)]
        ra = r.args[j]
        ra.kind, ra.is_int, ra.word = kind, is_int, word
        if src is not None:
            if src.device != dev or src.dtype not in DTYPES or (
                    kind == PAYLOAD and not src.is_contiguous()):
                raise ValueError(f"rpc_enqueue: argument {j} ({src.dtype} on "
                                 f"{src.device}) is not a contiguous tensor "
                                 f"of {sorted(map(str, DTYPES))} on {dev}")
            ra.src, ra.dtype = _ptr(src), DTYPES[src.dtype]
            ra.length, ra.offset = length, offset
    return r


def _launched(err: int) -> None:
    if err:
        raise RuntimeError(f"rpc_enqueue: launch failed with CUDA error {err}")
    rpc_enqueue.launches += 1


def rpc_enqueue(state: torch.Tensor, geometry: Sequence[int],
                arrivals: torch.Tensor, header: Sequence[int],
                args: Sequence[int], srcs: Sequence[Optional[torch.Tensor]],
                where: Optional[torch.Tensor]) -> torch.Tensor:
    """Append the record that ``header``, ``args``, ``srcs`` and ``where``
    describe (the op's lists) in one launch on the current stream to the
    CUDA queue whose int32 words are ``state`` (see :func:`pack_lanes`);
    returns the ticket, a 0-d int32 tensor the stream fills.  The lanes
    are updated in place; a failed build or launch raises."""
    lanes = pack_lanes(state, geometry, arrivals)
    rec = pack_record(header, args, srcs, where, state.device)
    ticket = torch.empty((), dtype=torch.int32, device=state.device)
    lanes.sanitize, lanes.ticket = header[5], ticket.data_ptr()
    _launched(_entry()(ctypes.addressof(lanes), ctypes.addressof(rec),
                       torch._C._cuda_getCurrentRawStream(
                           state.device.index)))
    return ticket


#: Launches since the last reset (a plain count; set it to 0 to reset).
rpc_enqueue.launches = 0


class EnqueuePlan:
    """A card queue's enqueue of one record signature, made at its first
    call (``core/rpc.py::RpcQueue._enqueue_direct`` keys it by the
    callee, each argument's kind, lane, dtype and payload length, the
    ``where`` mode, the declared reply and ``sanitize``) and taken by
    every later one: the record's parameters packed once by
    :func:`pack_record` from the first call's lists (``record``, whose
    ``npay`` and ``rwant`` are the signature's), and the queue's
    ``sanitize`` that the record was made for (``header[5]``), which each
    launch writes into the lanes.  :meth:`fill` patches what a later call
    changes: each immediate's word, each tensor's address and ``where``
    (its constant, or its tensor's address)."""

    __slots__ = ("record", "address", "sanitize", "_words", "_srcs",
                 "_where_mode")

    def __init__(self, header, args, srcs, where, dev: torch.device):
        self.record = pack_record(header, args, srcs, where, dev)
        self.address = ctypes.addressof(self.record)
        self.sanitize = header[5]
        kinds = args[::ARG_WORDS]
        # the argument structs share the record's memory
        self._words = [(j, self.record.args[j])
                       for j, k in enumerate(kinds) if k == IMMEDIATE]
        self._srcs = [(j, self.record.args[j])
                      for j, (k, s) in enumerate(zip(kinds, srcs))
                      if k == DEVICE or (k == PAYLOAD and s.numel())]
        self._where_mode = header[6]

    def fill(self, values: Sequence, where) -> None:
        """Patch a call's ``values`` (an immediate's word, or a 0-d tensor
        or payload, a call's argument each) and ``where`` (a bool, or a
        0-d bool tensor; ignored for a record without one).  The tensors
        are the kernel's to read as they are: on the queue's device, a
        payload contiguous, of the signature's dtype and length."""
        for j, ra in self._words:
            ra.word = values[j]
        for j, ra in self._srcs:
            ra.src = values[j].data_ptr()
        if self._where_mode == 2:
            self.record.where = where.data_ptr()
        elif self._where_mode == 1:
            self.record.where_const = int(where)


class QueueLaunch:
    """The enqueue launches of one CUDA queue: its lanes packed once (the
    state never moves; :func:`pack_lanes`), patched each launch with the
    plan's ``sanitize`` (the queue's flag may be set after it is made)
    and the ticket's address, 0 for a record whose ticket nobody reads
    (the kernel then writes none).  Threads that share the queue patch
    and launch one at a time."""

    __slots__ = ("lanes", "_lanes_at", "_index", "_entry", "_stream",
                 "_lock")

    def __init__(self, state: torch.Tensor, geometry: Sequence[int],
                 arrivals: torch.Tensor):
        self.lanes = pack_lanes(state, geometry, arrivals)
        self._lanes_at = ctypes.addressof(self.lanes)
        self._index = state.device.index
        self._entry = _entry()
        # the current stream's raw handle, read every launch (callers
        # switch streams) without making a stream object (chip_smoke.py's
        # rpc_queue_time times both)
        self._stream = torch._C._cuda_getCurrentRawStream
        self._lock = threading.Lock()

    def run(self, plan: EnqueuePlan, values: Sequence, where,
            ticket: Optional[torch.Tensor]) -> None:
        """One launch of ``plan`` filled with ``values`` and ``where``
        (:meth:`EnqueuePlan.fill`) on the current stream; ``ticket`` a
        0-d int32 tensor on the queue's device, or None."""
        with self._lock:
            plan.fill(values, where)
            self.lanes.sanitize = plan.sanitize
            self.lanes.ticket = 0 if ticket is None else ticket.data_ptr()
            err = self._entry(self._lanes_at, plan.address,
                              self._stream(self._index))
        _launched(err)
