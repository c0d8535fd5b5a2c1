"""ctypes wrapper of the host RPC channel (``csrc/rpc_channel.cu``).

Replaces no Pallas kernel: the JAX package's transport is XLA's
``io_callback`` (``repro/core/rpc.py::rpc_call``).  A :class:`Channel`
belongs to one (device, stream).  It holds one record in pinned,
host-mapped memory, its host-only words (what a launch marked due,
whether the drain sleeps), a sequence counter in device memory, its
:class:`Stagings` (one :class:`Staging` region per landing pad and result
shape, or per queue geometry, each under a channel-local id that the
record carries), a :class:`Launch` descriptor per region, and a daemon
thread that drains the record: in one C call (``rpc_drain``, Python's
lock released) it answers the record it served and waits for the next,
then runs the ``serve`` callable of the record's staging id (numpy only,
on the staging region's views).  :func:`rpc_post` issues one round trip
on the channel's stream through its :class:`Launch`: one C call that
launches the ``rpc_post`` kernel, which copies every slot of at most
:data:`COPY_LIMIT` bytes itself (a larger slot takes a copy engine around
the launch); the host never waits for the device there.  The library
builds at the first channel.
"""
from __future__ import annotations

import atexit
import ctypes
import itertools
import threading
import time
import types
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

_P, _I, _U, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_size_t
_LL, _ULL = ctypes.c_longlong, ctypes.c_ulonglong

#: A posted record unanswered for this long makes the kernel trap: a lost
#: drain thread fails the run instead of hanging it.
TIMEOUT_S = 120.0
#: The drain thread spins this long (us) after each wait starts, then
#: sleeps between polls until a launch wakes it (``rpc_wait`` in the
#: source).
SPIN_US = 2000
#: A record that a launch marked due keeps the drain spinning for at most
#: this long (us) after the launch: a launch captured into a CUDA graph
#: marks a record that only a replay posts.
DUE_US = 2_000_000
#: Each wait of the drain thread ends after this long (us) to look at its
#: stop flag.
WAIT_US = 500_000
#: Scalar words a call can pass as kernel arguments (``kInlineWords``).
INLINE_WORDS = 16
#: The kernel's slot table (``kSlots``): a call with more kernel-copied
#: slots is refused (slots on the copy engines are not counted).
MAX_SLOTS = 1344
#: Alignment of the staging slots, bytes.
ALIGN = 256
#: The largest slot that the ``rpc_post`` kernel copies itself; a larger
#: one takes a copy engine (a ``cudaMemcpyAsync`` before or after the
#: launch).  Fixed by size: neither route stands in for the other.
#: Measured by ``chip_smoke.py``'s ``rpc_time`` line (``routes``: one slot
#: device -> host -> device behind a busy stream, median device ms,
#: kernel against copy engines; NVIDIA H100 80GB HBM3, 700 W, three runs
#: of ``python -m repro_torch.evaluation.rpc_ab``, whose runs PERF.md's
#: `rpc_post` row names): 4 KB 0.024-0.037 against 0.038-0.049, 256 KB
#: 0.037-0.043 against 0.053-0.054, 1 MB 0.067-0.073 against 0.076-0.088,
#: 4 MB 0.188-0.191 against 0.188-0.193 (a tie), 16 MB 0.672-0.678
#: against 0.643-0.655, 64 MB 2.65-2.88 against 2.48-2.56.  Up to 1 MB
#: the kernel is faster and saves the host two API calls; from 4 MB the
#: copy engines cost the same or less and keep the SMs free.
COPY_LIMIT = 1 << 20
#: Kernel-copied bytes a block of ``rpc_post`` takes, each way (the grid
#: is at most one block an SM).
BLOCK_BYTES = 16 << 10
#: The routes of :attr:`Launch.table`.
KERNEL, ENGINE = "kernel", "engine"


class _Slot(ctypes.Structure):
    _fields_ = [("dev", ctypes.c_uint64), ("host", ctypes.c_uint64),
                ("bytes", ctypes.c_uint32), ("out", ctypes.c_uint32)]


def _params_type(slots: int):
    """``csrc/rpc_channel.cu::Params`` with a table of ``slots``."""
    class _Params(ctypes.Structure):
        _fields_ = [("rec", ctypes.c_uint64), ("counter", ctypes.c_uint64),
                    ("inline_dst", ctypes.c_uint64),
                    ("staging", ctypes.c_uint64),
                    ("timeout_ns", ctypes.c_uint64),
                    ("ticket", ctypes.c_uint32), ("n_inline", ctypes.c_int32),
                    ("n_slots", ctypes.c_int32),
                    ("out_grid", ctypes.c_int32),
                    ("words", ctypes.c_uint32 * INLINE_WORDS),
                    ("slot", _Slot * slots)]
    return _Params


class _Copy(ctypes.Structure):
    _fields_ = [("dev", ctypes.c_uint64), ("host", ctypes.c_uint64),
                ("bytes", ctypes.c_uint64)]


class _Call(ctypes.Structure):
    _fields_ = [("params", ctypes.c_void_p), ("waker", ctypes.c_uint64),
                ("copy", ctypes.c_void_p), ("grid", ctypes.c_int32),
                ("n_copy_in", ctypes.c_int32), ("n_copy_out", ctypes.c_int32)]


class _Drain(ctypes.Structure):
    _fields_ = [("rec", ctypes.c_void_p), ("waker", ctypes.c_void_p),
                ("timeout_us", ctypes.c_int64), ("spin_us", ctypes.c_int64),
                ("due_us", ctypes.c_int64), ("staging", ctypes.c_uint64),
                ("seen_ns", ctypes.c_int64)]


def _lib() -> ctypes.CDLL:
    lib = _build.load("rpc_channel")
    if not getattr(lib, "typed", False):
        lib.rpc_host_alloc.argtypes = [_SZ, ctypes.POINTER(_P),
                                       ctypes.POINTER(_P)]
        lib.rpc_host_alloc.restype = _I
        for fn in ("rpc_record_bytes", "rpc_params_bytes", "rpc_table_slots",
                   "rpc_call_bytes"):
            getattr(lib, fn).restype = _I
        lib.rpc_waker_alloc.restype = _P
        lib.rpc_max_blocks.argtypes = [_I]
        lib.rpc_max_blocks.restype = _I
        lib.rpc_roundtrip.argtypes = [_P, _P]
        lib.rpc_roundtrip.restype = _I
        lib.rpc_api_calls.restype = _ULL
        lib.rpc_complete.argtypes = [_P, _P, _U]
        lib.rpc_complete.restype = None
        lib.rpc_drain.argtypes = [_P, _I]
        lib.rpc_drain.restype = _I
        lib.rpc_floor_serve.argtypes = [_P, _P, _I, _LL]
        lib.rpc_floor_serve.restype = _I
        lib.rpc_waited_ns.argtypes = [_P]
        lib.rpc_waited_ns.restype = _ULL
        lib.rpc_stream_sync.argtypes = [_P]
        lib.rpc_stream_sync.restype = _I
        # the table's length is the library's (a build may shorten it)
        lib.Params = _params_type(lib.rpc_table_slots())
        sizes = (lib.rpc_params_bytes(), lib.rpc_call_bytes())
        here = (ctypes.sizeof(lib.Params), ctypes.sizeof(_Call))
        if sizes != here:
            raise RuntimeError(f"rpc_channel: the descriptor is {sizes} "
                               f"bytes in C, {here} here")
        lib.typed = True
    return lib


def _host_alloc(nbytes: int) -> Tuple[int, int]:
    """Zeroed pinned host memory mapped for the device: (host, device)
    addresses.  It lives as long as the process."""
    host, dev = _P(), _P()
    err = _lib().rpc_host_alloc(max(nbytes, 1), ctypes.byref(host),
                                ctypes.byref(dev))
    if err:
        raise RuntimeError(f"rpc_channel: mapped host allocation of {nbytes} "
                           f"bytes failed with CUDA error {err}")
    return host.value, dev.value


class Staging:
    """A landing pad's region of mapped pinned memory: :data:`INLINE_WORDS`
    scalar words first, then one slot per size in ``slot_bytes`` (the
    pad's tensor operands and its result), each :data:`ALIGN`-aligned.
    A pad's operand shapes are fixed and a region is keyed by its result
    shapes too (:class:`Stagings`), so each region is sized once."""

    def __init__(self, slot_bytes: Sequence[int]):
        offsets, end = [], ALIGN
        for n in slot_bytes:
            offsets.append(end)
            end += -(-max(n, 1) // ALIGN) * ALIGN
        self.host, self.dev, self.buf = self._memory(end)
        self.offsets = offsets
        self.slot_bytes = list(slot_bytes)

    @staticmethod
    def _memory(nbytes: int) -> Tuple[int, Optional[int], np.ndarray]:
        host, dev = _host_alloc(nbytes)
        return host, dev, np.ctypeslib.as_array(
            (ctypes.c_uint8 * nbytes).from_address(host))

    def slot(self, i: int) -> np.ndarray:
        """Slot ``i`` as writable uint8 (a view of the pinned memory)."""
        return self.buf[self.offsets[i]:self.offsets[i] + self.slot_bytes[i]]

    def word(self, k: int) -> np.ndarray:
        """Scalar word ``k`` as 4 writable bytes."""
        return self.buf[4 * k:4 * k + 4]


class HostStaging(Staging):
    """:class:`Staging`'s layout in ordinary host memory: the region of a
    :class:`HostChannel` (no card, no mapped memory)."""

    @staticmethod
    def _memory(nbytes: int) -> Tuple[int, Optional[int], np.ndarray]:
        buf = np.zeros(nbytes, np.uint8)
        return buf.ctypes.data, None, buf


class Stagings:
    """A channel's staging regions by the id that its records carry.

    :meth:`get` gives the id and the region of ``key``, made by ``make()``
    (a ``(Staging, serve)`` pair) at the key's first use; ids are
    channel-local, 1, 2, ... in order of first use.  A key names what fixes
    a region's layout: a landing pad with its result shapes (so one callee
    can return another shape on the same channel), or a queue geometry.
    ``serve()`` runs the callee on the staged operands and writes the
    result into the region."""

    def __init__(self):
        self.ids: Dict[Hashable, int] = {}
        self.entries: Dict[int, Tuple[Staging, Callable[[], None]]] = {}

    def get(self, key: Hashable,
            make: Callable[[], Tuple[Staging, Callable[[], None]]]
            ) -> Tuple[int, Staging]:
        sid = self.ids.get(key)
        if sid is None:
            sid = len(self.entries) + 1
            self.entries[sid] = make()
            self.ids[key] = sid
        return sid, self.entries[sid][0]

    def serve(self, sid: int) -> None:
        self.entries[sid][1]()


class Launch:
    """The descriptor of one kind of round trip: the staging region
    ``staging_id`` with the slots its operands are copied into
    (``in_slots``) and its results and write-backs copied out of
    (``out_slots``).

    ``table`` has a row a slot, operands first: ``(slot, offset, bytes,
    route, out)``, the route :data:`KERNEL` (``rpc_post`` copies it) for
    at most ``limit`` (:data:`COPY_LIMIT`) bytes and :data:`ENGINE` (a
    ``cudaMemcpyAsync``) above.  Both channels copy by it.  On a card
    (``channel`` given) it also holds the C descriptor
    (``csrc/rpc_channel.cu::Call``) with everything but the tensors'
    addresses and the scalar words filled in: :meth:`run` fills those and
    makes one C call."""

    limit = COPY_LIMIT

    def __init__(self, staging_id: int, staging: Optional[Staging],
                 in_slots: Sequence[int], out_slots: Sequence[int],
                 channel=None):
        self.in_slots, self.out_slots = list(in_slots), list(out_slots)
        self.n_in, self.n_out = len(self.in_slots), len(self.out_slots)
        self.table = [(s, staging.offsets[s], staging.slot_bytes[s],
                       KERNEL if staging.slot_bytes[s] <= self.limit
                       else ENGINE, out)
                      for out, slots in ((False, in_slots), (True, out_slots))
                      for s in slots]
        n_kernel = sum(row[3] == KERNEL for row in self.table)
        if n_kernel > MAX_SLOTS:
            raise ValueError(f"rpc_post: {n_kernel} tensor slots of at most "
                             f"{self.limit} bytes, at most {MAX_SLOTS}")
        self.bytes = [row[2] for row in self.table]
        self.channel = channel
        if channel is not None:
            self._describe(staging_id, staging, channel)

    def _describe(self, staging_id, staging, channel) -> None:
        lib = _lib()
        p = self._params = lib.Params()
        p.rec, p.counter = channel.record_dev, channel.counter.data_ptr()
        p.inline_dst = staging.dev if staging is not None else 0
        p.staging, p.timeout_ns = staging_id, int(TIMEOUT_S * 1e9)
        kernel_rows = [r for r in self.table if r[3] == KERNEL]
        engine_rows = [r for r in self.table if r[3] == ENGINE]
        self._copies = (_Copy * max(len(engine_rows), 1))()
        targets = {}
        for k, (slot, off, nb, _, out) in enumerate(kernel_rows):
            s = p.slot[k]
            s.host, s.bytes, s.out = staging.dev + off, nb, out
            targets[slot, out] = s
        for k, (slot, off, nb, _, out) in enumerate(engine_rows):
            cp = self._copies[k]
            cp.host, cp.bytes = staging.host + off, nb
            targets[slot, out] = cp
        p.n_slots = len(kernel_rows)
        c = self.call = _Call()
        c.params, c.copy = ctypes.addressof(p), ctypes.addressof(self._copies)
        c.waker = channel.waker
        c.n_copy_in = sum(not r[4] for r in engine_rows)
        c.n_copy_out = len(engine_rows) - c.n_copy_in
        c.grid, p.out_grid = grids(kernel_rows, channel.max_blocks)
        # where each tensor's address goes, in the order run() takes them
        self._targets = [targets[r[0], r[4]] for r in self.table]
        self._words = p.words
        self._address = ctypes.addressof(c)
        self._roundtrip = lib.rpc_roundtrip
        self._index = channel.device.index
        # threads sharing a stream fill the descriptor one at a time
        self._lock = threading.Lock()

    def check(self, inputs: Sequence[torch.Tensor],
              outputs: Sequence[torch.Tensor]) -> None:
        """Refuse a call whose tensors do not match the table's slots."""
        if len(inputs) != self.n_in or len(outputs) != self.n_out:
            raise ValueError(f"rpc_post: {len(inputs)} inputs and "
                             f"{len(outputs)} outputs for a launch of "
                             f"{self.n_in} and {self.n_out}")

    def run(self, inputs: Sequence[torch.Tensor], words: Sequence[int],
            outputs: Sequence[torch.Tensor]) -> None:
        """One round trip on the channel's stream: ``inputs`` (one a slot of
        ``in_slots``) into the region, the kernel with the scalar ``words``,
        ``outputs`` out of it; every tensor contiguous on the channel's
        device, of its slot's size."""
        ch = self.channel
        self.check(inputs, outputs)
        with self._lock:
            for target, nb, t in zip(self._targets, self.bytes,
                                     itertools.chain(inputs, outputs)):
                if t.get_device() != self._index or not t.is_contiguous() \
                        or t.nbytes != nb:
                    raise ValueError(
                        f"rpc_post: a {t.device} tensor of {t.nbytes} bytes "
                        f"(contiguous {t.is_contiguous()}); its slot takes "
                        f"{nb} contiguous bytes on {ch.device}")
                target.dev = t.data_ptr()
            self._params.n_inline = len(words)
            for k, w in enumerate(words):
                self._words[k] = w
            err = self._roundtrip(self._address, ch.stream_handle)
        if err:
            raise RuntimeError(f"rpc_post: launch failed with CUDA error "
                               f"{err}")


def grids(rows, max_blocks: int) -> Tuple[int, int]:
    """The grid of a launch whose kernel-copied slots are ``rows`` (rows of
    :attr:`Launch.table`), and how many of its blocks copy the results
    back (0 when none does): a block a :data:`BLOCK_BYTES` each way, at
    most ``max_blocks``.  Only those blocks wait for the host's answer;
    the others exit when they have copied the operands."""
    in_bytes = sum(r[2] for r in rows if not r[4])
    outs = [r[2] for r in rows if r[4]]
    out_grid = max(1, -(-sum(outs) // BLOCK_BYTES)) if outs else 0
    grid = min(max_blocks, max(1, -(-in_bytes // BLOCK_BYTES), out_grid))
    return grid, min(grid, out_grid)


def _launch_with_limit(limit: int, *args, **kwargs) -> Launch:
    """A :class:`Launch` whose copy limit is ``limit`` instead of
    :data:`COPY_LIMIT`: ``chip_smoke.py`` times both routes with it."""
    launch = Launch.__new__(Launch)
    launch.limit = limit
    launch.__init__(*args, **kwargs)
    return launch


class _Regions:
    """What both channels hold: ``stagings``, their staging regions
    (:class:`Stagings`); ``plans``, the call plans that ``core/rpc.py``
    makes on the channel (each keeps its :class:`Launch`); ``launches``, a
    :class:`Launch` a staging id, which the op finds by the id it takes."""

    on_card = False

    def __init__(self):
        self.stagings = Stagings()
        self.plans: Dict[Hashable, object] = {}
        self.launches: Dict[int, Launch] = {}

    def launch_for(self, staging_id: int, in_slots: Sequence[int],
                   out_slots: Sequence[int]) -> Launch:
        """The :class:`Launch` of ``staging_id``, made with these slots at
        its first use (with its C descriptor on a card).  A region's slots
        are fixed by what keys it (a pad and its result shapes, or a queue
        geometry), so later uses take it as it is."""
        d = self.launches.get(staging_id)
        if d is None:
            d = self.launches[staging_id] = Launch(
                staging_id, self.stagings.entries[staging_id][0], in_slots,
                out_slots, channel=self if self.on_card else None)
        return d


class Channel(_Regions):
    """The RPC channel of one (device, stream): see the module docstring.

    The drain serves the region whose id the record carries.  A callee's
    exception is kept in ``error`` (the record is answered all the same)
    and raised by the port's ``effects_barrier()``.  ``last_serve_ns`` is
    the drain's time in Python for the last record, ``last_gil_ns`` its wait
    from seeing the record in C to running Python again (Python's lock)."""

    on_card = True

    def __init__(self, device: torch.device, stream: torch.cuda.Stream):
        super().__init__()
        self.device, self.stream = device, stream
        self.stream_handle = stream.cuda_stream
        lib = _lib()
        self.record_host, self.record_dev = _host_alloc(lib.rpc_record_bytes())
        self.waker = lib.rpc_waker_alloc()
        self.max_blocks = lib.rpc_max_blocks(device.index)
        if not self.waker or self.max_blocks < 1:
            raise RuntimeError("rpc_channel: no host words or no occupancy "
                               f"for rpc_post on {device}")
        # sequence, arrivals, release; a channel first used by a program
        # being exported is made under the trace's fake mode: its own
        # counters stay a real tensor
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            self.counter = torch.zeros(3, dtype=torch.int32, device=device)
        self.error: Optional[BaseException] = None
        self.last_serve_ns = 0
        self.last_gil_ns = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._drain, name=f"rpc-drain-{device}", daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        lib = _lib()
        d = _Drain(self.record_host, self.waker, WAIT_US, SPIN_US, DUE_US)
        address = ctypes.addressof(d)
        drain = lib.rpc_drain
        clock, mono = time.clock_gettime_ns, time.CLOCK_MONOTONIC
        status = -1              # the served record's, until it is answered
        try:
            while not self._stop.is_set():
                # answer the last record and wait for the next, in C
                got, status = drain(address, status), -1
                if not got:
                    continue
                t0 = clock(mono)
                self.last_gil_ns = t0 - d.seen_ns
                status = 1
                try:
                    self.stagings.serve(d.staging)
                    status = 0
                except Exception as e:  # answered all the same; raised later
                    if self.error is None:
                        self.error = e
                finally:
                    self.last_serve_ns = clock(mono) - t0
        finally:
            if status >= 0:
                lib.rpc_complete(self.record_host, self.waker, status)

    @staticmethod
    def new_staging(slot_bytes: Sequence[int]) -> Staging:
        """A region for the channel's :class:`Stagings` (mapped memory)."""
        return Staging(slot_bytes)

    def waited_ns(self) -> int:
        """The device's wait in the last call, post to reply (its clock)."""
        return _lib().rpc_waited_ns(self.record_host)

    def sync(self) -> None:
        """Wait for the channel's stream, with Python's lock released."""
        err = _lib().rpc_stream_sync(ctypes.c_void_p(self.stream_handle))
        if err:
            raise RuntimeError(f"rpc_channel: stream synchronise failed with "
                               f"CUDA error {err}")

    def take_error(self) -> Optional[BaseException]:
        err, self.error = self.error, None
        return err

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2 * WAIT_US * 1e-6)


_CHANNELS: Dict[Tuple[int, int], Channel] = {}
_LOCK = threading.Lock()


class HostChannel(_Regions):
    """The channel of CPU tensors: the same :class:`Stagings`, plans and
    :class:`Launch` tables, in host memory (:class:`HostStaging`), and no
    drain thread.  :meth:`post` is :func:`rpc_post`'s plain version: the
    operand copies into the region by the launch's table, the scalar
    words, the region's ``serve()`` (the drain's work) and the result
    copies, in that order on the calling thread.  Each thread has its own
    (:func:`host_channel`), and a call posted from inside a ``serve()``
    gets a channel of its own too."""

    @staticmethod
    def new_staging(slot_bytes: Sequence[int]) -> Staging:
        return HostStaging(slot_bytes)

    def post(self, staging_id: int, inputs: Sequence[torch.Tensor],
             in_slots: Sequence[int], words: Sequence[int],
             outputs: Sequence[torch.Tensor],
             out_slots: Sequence[int]) -> None:
        _check_call(inputs, in_slots, words, outputs, out_slots)
        launch = self.launch_for(staging_id, in_slots, out_slots)
        launch.check(inputs, outputs)
        table = launch.table
        buf = self.stagings.entries[staging_id][0].buf
        for (_, off, nb, _, _), t in zip(table, inputs):
            buf[off:off + nb] = _bytes(t, nb).numpy()
        for k, w in enumerate(words):
            buf[4 * k:4 * k + 4].view(np.uint32)[0] = w
        _HOST.depth += 1
        try:
            self.stagings.serve(staging_id)
        finally:
            _HOST.depth -= 1
        for (_, off, nb, _, _), t in zip(table[len(inputs):], outputs):
            _bytes(t, nb).copy_(torch.from_numpy(buf[off:off + nb]))


def _bytes(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous tensor's memory as uint8 (a view), ``nbytes`` long."""
    if not t.is_contiguous() or t.nbytes != nbytes:
        raise ValueError(f"rpc_post: a tensor of {t.nbytes} bytes "
                         f"(contiguous {t.is_contiguous()}); its slot takes "
                         f"{nbytes} contiguous bytes")
    return t.reshape(-1).view(torch.uint8)


def _check_call(inputs, in_slots, words, outputs, out_slots) -> None:
    if len(words) > INLINE_WORDS:
        raise ValueError(f"rpc_post: {len(words)} scalar words, at most "
                         f"{INLINE_WORDS}")
    if len(inputs) != len(in_slots) or len(outputs) != len(out_slots):
        raise ValueError(f"rpc_post: {len(inputs)} inputs for "
                         f"{len(in_slots)} slots, {len(outputs)} outputs for "
                         f"{len(out_slots)}")


class _HostChannels(threading.local):
    def __init__(self):
        self.depth = 0
        self.stack: List[HostChannel] = []


_HOST = _HostChannels()


def host_channel() -> HostChannel:
    """This thread's :class:`HostChannel` at the current nesting depth."""
    while len(_HOST.stack) <= _HOST.depth:
        _HOST.stack.append(HostChannel())
    return _HOST.stack[_HOST.depth]


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def channel_for(device: torch.device) -> Channel:
    """The channel of ``device``'s current stream, made at first use."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    raw = _raw_stream(index) if _raw_stream is not None else \
        torch.cuda.current_stream(index).cuda_stream
    ch = _CHANNELS.get((index, raw))
    if ch is not None:
        return ch
    device = torch.device("cuda", index)
    stream = torch.cuda.current_stream(device)
    key = (index, stream.cuda_stream)
    with _LOCK:
        ch = _CHANNELS.get(key)
        if ch is None:
            if not _CHANNELS:
                atexit.register(_shutdown)
            ch = _CHANNELS[key] = Channel(device, stream)
    return ch


def channels() -> List[Channel]:
    with _LOCK:
        return list(_CHANNELS.values())


def _shutdown() -> None:
    """At exit: let the devices finish (the drains answer what is still
    posted), then stop the drains."""
    for ch in channels():
        try:
            ch.sync()
        except RuntimeError:
            pass
        ch.stop()


def rpc_post(channel: Channel, staging_id: int,
             inputs: Sequence[torch.Tensor], in_slots: Sequence[int],
             words: Sequence[int], outputs: Sequence[torch.Tensor],
             out_slots: Sequence[int]) -> None:
    """One round trip on ``channel``'s stream through the :class:`Launch`
    of ``staging_id`` (the region's id in ``channel.stagings``, which the
    record carries): each of ``inputs`` into its slot of ``in_slots``, the
    scalar ``words`` (uint32 values), then each slot of ``out_slots`` into
    its tensor of ``outputs``.  Every tensor must be contiguous on the
    channel's device and of its slot's size; the caller keeps them alive
    (PyTorch's stream-ordered allocator does)."""
    _check_call(inputs, in_slots, words, outputs, out_slots)
    channel.launch_for(staging_id, in_slots, out_slots).run(
        inputs, words, outputs)
    rpc_post.launches += 1


#: Launches since the last reset (a plain count; set it to 0 to reset).
rpc_post.launches = 0


def api_calls() -> int:
    """CUDA API calls that the round trips of this process made (a launch
    or a copy-engine copy each)."""
    return _lib().rpc_api_calls()


def latency_floor(device: torch.device, n: int = 200) -> Dict[str, float]:
    """The round trip's floor on ``device``: ``n`` launches of ``rpc_post``
    with no slot and no word on a record of their own, queued behind a
    device sleep so they run back to back, each answered by
    ``rpc_floor_serve`` (a C loop on a thread of its own: no Python, no
    callee, no lock).  Returns the device ms a round trip (CUDA events
    around the ``n``) and the last kernel's wait, post to reply, in us.
    Its launches do not count in ``rpc_post.launches``."""
    lib = _lib()
    host, dev = _host_alloc(lib.rpc_record_bytes())
    device = torch.device("cuda", device.index or 0)
    stream = torch.cuda.Stream(device)
    bare = types.SimpleNamespace(      # what a Launch reads of a channel
        device=device, record_dev=dev, waker=lib.rpc_waker_alloc(),
        stream_handle=stream.cuda_stream, max_blocks=1,
        counter=torch.zeros(3, dtype=torch.int32, device=device))
    launch = Launch(0, None, [], [], channel=bare)
    warm = 10
    answered = []
    server = threading.Thread(target=lambda: answered.append(
        lib.rpc_floor_serve(host, bare.waker, warm + n, 60_000_000)))
    server.start()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        for _ in range(warm):
            launch.run([], [], [])
        stream.synchronize()
        torch.cuda._sleep(int(50e6))          # ~30 ms: the launches queue
        a.record(stream)
        for _ in range(n):
            launch.run([], [], [])
        b.record(stream)
    b.synchronize()
    server.join()
    if answered != [warm + n]:
        raise RuntimeError(f"rpc_channel: the floor's server answered "
                           f"{answered} of {warm + n}")
    return {"ms": a.elapsed_time(b) / n,
            "kernel_wait_us": lib.rpc_waited_ns(host) * 1e-3, "calls": n}
