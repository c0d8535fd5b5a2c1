"""ctypes wrapper of the async queue's epoch hand-off (``csrc/rpc_async.cu``).

Replaces no Pallas kernel: the JAX package's async flush is an ordered
``io_callback`` (``repro/core/rpc.py::RpcQueue.flush``, ``mode="async"``).
An :class:`AsyncRing` belongs to one async queue on a card, with a row
for each of its shards (one for a single queue): its records and its
staging regions in pinned, host-mapped memory (per epoch parity, an
``in`` region and an ``out`` region, each with a row a shard), an arrival
counter in device memory, and an ingest thread that waits in C for each
posted epoch (Python's lock released), copies every row's records out of
``in`` at once, acknowledges them (``consumed``) and hands them to
``on_posted``.  Each row's drain answers through :meth:`AsyncRing.complete`
(its ``out`` written, then its ``done`` released).

A flush is two launches, ``rpc_async_post`` then ``rpc_async_collect``,
whose one parameter block (:class:`_AsyncFlush`) :func:`pack_flush`
packs from the ring, the state and the epoch.  Two routes reach them,
and both count in ``rpc_async_post.launches`` and
``rpc_async_collect.launches``: the ops' CUDA kernels (:func:`rpc_async_post`
and :func:`rpc_async_collect`, each packing a block and making one C
call), and a queue's flush plan in eager mode (:class:`AsyncFlushPlan`:
the block packed once a queue, a flush patching its epoch, parity and
deadline, and one C call that issues both launches).  The plain versions
of their device work are ``ref.py``.  The library builds at the first
ring.  ``ops.py`` makes the two launches the custom ops
``torch.ops.repro_torch.rpc_async_post`` and ``rpc_async_collect``, which
name a ring by its :attr:`AsyncRing.id` (:func:`ring_by_id`).
"""
from __future__ import annotations

import ctypes
import itertools
import threading
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rpc_channel.kernel import (ALIGN, BLOCK_BYTES,
                                                    COPY_LIMIT, SPIN_US,
                                                    TIMEOUT_S, WAIT_US,
                                                    _host_alloc)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_LL, _ULL = ctypes.c_longlong, ctypes.c_ulonglong

#: A record's stages (the ``enum`` in the source).
POSTED, CONSUMED, DONE, ABANDONED = range(4)
#: Bytes of a record (``AsyncRecord``).
RECORD_BYTES = 64
#: The rows of a ring's regions start a multiple of this many words (16
#: bytes) apart: the kernels' 16-byte loads and stores.
ROW_WORDS = 4


class _AsyncFlush(ctypes.Structure):
    """``csrc/rpc_async.cu::AsyncFlush``: one flush's parameters."""
    _fields_ = ([(n, _ULL * 2) for n in ("rec", "in_", "in_host", "out")]
                + [(n, _ULL) for n in ("state", "live", "arrivals",
                                       "deadline_ns", "timeout_ns")]
                + [(n, _LL) for n in ("pitch", "in_bytes", "in_pitch",
                                      "out_pitch")]
                + [(n, _I) for n in ("rows", "out_start", "rslots", "rc",
                                     "has_reply", "grid", "engine")]
                + [(n, _U) for n in ("epoch", "prev")]
                + [(n, _I) for n in ("parity", "have_prev", "reserved")])


def _lib() -> ctypes.CDLL:
    lib = _build.load("rpc_async")
    if not getattr(lib, "typed", False):
        if (lib.rpc_async_record_bytes() != RECORD_BYTES
                or lib.rpc_async_flush_bytes()
                != ctypes.sizeof(_AsyncFlush)):
            raise RuntimeError("rpc_async: the library's layout differs "
                               "from kernel.py's")
        for fn in ("rpc_async_post_launch", "rpc_async_collect_launch",
                   "rpc_async_flush_launch", "rpc_async_floor_launch"):
            getattr(lib, fn).argtypes = [_P, _P]
            getattr(lib, fn).restype = _I
        lib.rpc_async_api_calls.restype = _ULL
        lib.rpc_async_wait.argtypes = [_P, _U, _LL, _LL]
        lib.rpc_async_wait.restype = _I
        lib.rpc_async_store.argtypes = [_P, _I, _U]
        lib.rpc_async_store.restype = None
        lib.rpc_async_load.argtypes = [_P, _I]
        lib.rpc_async_load.restype = _U
        lib.typed = True
    return lib


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _padded(words: int) -> int:
    return -(-words // ROW_WORDS) * ROW_WORDS


_RINGS: "Dict[int, weakref.ref]" = {}
_RING_IDS = itertools.count(1)


def ring_by_id(ring_id: int) -> "AsyncRing":
    """The live ring whose :attr:`AsyncRing.id` is ``ring_id``."""
    ref = _RINGS.get(ring_id)
    ring = ref() if ref is not None else None
    if ring is None:
        raise KeyError(f"rpc_async: no live ring {ring_id}")
    return ring


class AsyncRing:
    """The mapped memory and ingest thread of one async queue on a card
    (see the module docstring), ``rows`` rows (one a shard).  ``in_words``
    is a row's ``[0, in_end)``, ``out_words`` its words from ``cdepth``
    on; a region's rows lie ``in_pitch`` or ``out_pitch`` words apart (a
    multiple of :data:`ROW_WORDS`).  ``on_posted(epoch, words)`` runs on
    the ingest thread with a ``(rows, in_words)`` copy of the epoch's
    records and must hand the drains off (it must not run callees: the
    next epoch's records wait behind it).  If it raises, the epoch is
    answered with zeros and the exception kept in ``error``."""

    def __init__(self, device: torch.device, in_words: int, out_words: int,
                 on_posted: Callable[[int, np.ndarray], None],
                 rows: int = 1):
        _lib()        # built here, before the ingest thread loads it
        self.device, self.rows = device, rows
        self.in_words, self.out_words = in_words, out_words
        self.in_pitch, self.out_pitch = _padded(in_words), _padded(out_words)
        # a record a row for each parity, a live carried depth a row, then
        # the regions (in, in, out, out)
        sizes = ([4 * rows * self.in_pitch] * 2
                 + [4 * rows * self.out_pitch] * 2)
        offsets = []
        end = -(-(2 * rows * RECORD_BYTES + 4 * rows) // ALIGN) * ALIGN
        for n in sizes:
            offsets.append(end)
            end += -(-max(n, 4) // ALIGN) * ALIGN
        self.host, self.dev = _host_alloc(end)
        buf = np.ctypeslib.as_array((ctypes.c_uint8 * end).from_address(
            self.host))
        self._rec = [self.host, self.host + rows * RECORD_BYTES]
        self._rec_dev = [self.dev, self.dev + rows * RECORD_BYTES]
        live = 2 * rows * RECORD_BYTES
        self.live = buf[live:live + 4 * rows].view(np.int32)
        self._live_dev = self.dev + live

        def rows_of(o: int, n: int, pitch: int, words: int) -> np.ndarray:
            return buf[o:o + n].view(np.int32).reshape(rows, pitch)[:, :words]

        self._in = [rows_of(o, n, self.in_pitch, in_words)
                    for o, n in zip(offsets[:2], sizes[:2])]
        self._out = [rows_of(o, n, self.out_pitch, out_words)
                     for o, n in zip(offsets[2:], sizes[2:])]
        self._in_host = [self.host + o for o in offsets[:2]]
        self._in_dev = [self.dev + o for o in offsets[:2]]
        self._out_dev = [self.dev + o for o in offsets[2:]]
        # rpc_async_post's arrival counter (zero between launches) and the
        # card's SMs, which bound its grid
        self.arrivals = torch.zeros(1, dtype=torch.int32, device=device)
        self.sms = _sm_count(device)
        self.on_posted = on_posted
        self.id = next(_RING_IDS)
        _RINGS[self.id] = weakref.ref(self)
        self.issued = 0          # epochs flushed by the host
        self.ingested = 0        # epochs handed to the drain
        self.error: Optional[BaseException] = None
        self._cond = threading.Condition()
        self._closing = threading.Event()
        self._thread = threading.Thread(target=self._ingest, daemon=True,
                                        name=f"rpc-async-ingest-{device}")
        self._thread.start()

    # -- host side ---------------------------------------------------------

    def _ingest(self) -> None:
        lib = _lib()
        epoch = 1
        while not (self._closing.is_set() and self.ingested >= self.issued):
            p = epoch & 1
            if not lib.rpc_async_wait(self._rec[p], epoch, WAIT_US, SPIN_US):
                continue
            words = self._in[p].copy()
            lib.rpc_async_store(self._rec[p], CONSUMED, epoch)
            try:
                self.on_posted(epoch, words)
            except BaseException as exc:  # noqa: BLE001 (kept, answered)
                if self.error is None:
                    self.error = exc
                for row in range(self.rows):
                    self.complete(epoch, np.zeros(self.out_words, np.int32),
                                  row)
            with self._cond:
                self.ingested = epoch
                self._cond.notify_all()
            epoch += 1

    def issue(self) -> int:
        """The number of the epoch the host flushes next (from 1)."""
        with self._cond:
            self.issued += 1
            return self.issued

    def _row_rec(self, epoch: int, row: int) -> int:
        return self._rec[epoch & 1] + row * RECORD_BYTES

    def complete(self, epoch: int, words: np.ndarray, row: int = 0) -> None:
        """Answer ``epoch``'s row ``row``: its reply words into the row's
        ``out``, then the row's ``done``."""
        self._out[epoch & 1][row] = words
        _lib().rpc_async_store(self._row_rec(epoch, row), DONE, epoch)

    def abandoned(self, epoch: int, row: int = 0) -> bool:
        """True once the device gave up waiting for ``epoch``'s drain of
        row ``row``."""
        return _lib().rpc_async_load(self._row_rec(epoch, row),
                                     ABANDONED) == (epoch & 0xFFFFFFFF)

    def wait_ingested(self, timeout: Optional[float] = None) -> bool:
        """Wait until every flushed epoch has reached the drain."""
        with self._cond:
            return self._cond.wait_for(lambda: self.ingested >= self.issued,
                                       timeout)

    def close(self) -> None:
        """Let the ingest thread end once every issued epoch has reached
        the drain (it does not wait for that)."""
        self._closing.set()


def _pitch(state: torch.Tensor, ring: AsyncRing) -> int:
    """The words between two rows of ``state``: a 1-D state is one row,
    a 2-D one ``ring.rows`` rows."""
    rows = 1 if state.dim() == 1 else state.shape[0]
    if state.device != ring.device or not state.is_contiguous() or \
            state.dtype != torch.int32 or state.dim() > 2 or \
            rows != ring.rows:
        raise ValueError(f"rpc_async: a {state.device} {state.dtype} state "
                         f"of shape {tuple(state.shape)}; the ring takes "
                         f"contiguous int32 on {ring.device}, {ring.rows} "
                         "rows")
    return state.shape[-1] if state.dim() == 2 else 0


def _set_epoch(block: _AsyncFlush, epoch: int,
               deadline: Optional[float]) -> None:
    """What a flush changes in its block: the epoch it posts (and so the
    parity and the epoch it collects) and the deadline, in seconds or
    None."""
    block.epoch = epoch & 0xFFFFFFFF
    block.prev = (epoch - 1) & 0xFFFFFFFF
    block.parity = epoch & 1
    block.have_prev = int(epoch > 1)
    block.deadline_ns = int(deadline * 1e9) if deadline else 0


def pack_flush(ring: AsyncRing, state: torch.Tensor, epoch: int,
               out_start: int, has_reply: bool, rslots: int, rc: int,
               deadline: Optional[float]) -> _AsyncFlush:
    """The parameters of epoch ``epoch``'s flush of the queue whose words
    are ``state`` (``(words,)``, or ``(rows, words)`` for the ring's rows)
    through ``ring``: both parities' addresses, the state's geometry, the
    reply fields' sizes and the copy route, which is the copy engines'
    when the rows hold more than ``COPY_LIMIT`` bytes in all (then one
    block posts), else the kernel's (about a block per ``BLOCK_BYTES``, at
    least one a row, at most one an SM)."""
    pitch = _pitch(state, ring)
    rows, in_bytes = ring.rows, 4 * ring.in_words
    engine = rows * in_bytes > COPY_LIMIT
    b = _AsyncFlush()
    for p in (0, 1):
        b.rec[p], b.in_[p] = ring._rec_dev[p], ring._in_dev[p]
        b.in_host[p], b.out[p] = ring._in_host[p], ring._out_dev[p]
    b.state, b.live = state.data_ptr(), ring._live_dev
    b.arrivals = ring.arrivals.data_ptr()
    b.timeout_ns = int(TIMEOUT_S * 1e9)
    b.pitch, b.in_bytes = pitch, in_bytes
    b.in_pitch, b.out_pitch = 4 * ring.in_pitch, ring.out_pitch
    b.rows, b.out_start, b.rslots, b.rc = rows, out_start, rslots, rc
    b.has_reply, b.engine = int(has_reply), int(engine)
    b.grid = 1 if engine else min(
        max(-(-rows * in_bytes // BLOCK_BYTES), rows), ring.sms)
    _set_epoch(b, epoch, deadline)
    return b


def _launched(what: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{what}: launch failed with CUDA error {err}")


def rpc_async_post(ring: AsyncRing, epoch: int, state: torch.Tensor,
                   out_start: int, has_reply: bool) -> None:
    """Hand epoch ``epoch`` to the host on the current stream: one launch
    of ``rpc_async_post``, which copies each row's words ``[0,
    in_words)`` into the ring (or the copy engines do, before it) and
    moves the windows; nothing waits.  ``state`` is the queue's words,
    ``(words,)`` or ``(rows, words)``."""
    block = pack_flush(ring, state, epoch, out_start, has_reply, 0, 0, None)
    _launched("rpc_async_post", _lib().rpc_async_post_launch(
        ctypes.addressof(block),
        torch._C._cuda_getCurrentRawStream(ring.device.index)))
    rpc_async_post.launches += 1


def rpc_async_collect(ring: AsyncRing, epoch: int, state: torch.Tensor,
                      out_start: int, rslots: int, rc: int,
                      deadline: Optional[float]) -> None:
    """Install epoch ``epoch - 1``'s replies into each row of ``state``
    (the queue's words from ``cdepth`` on) once the row's drain answered,
    or the row's stamped window past ``deadline`` seconds (one budget for
    every row: they wait side by side); zeros at the first flush.  One
    launch of ``rpc_async_collect`` (a block a row) on the current
    stream."""
    block = pack_flush(ring, state, epoch, out_start, False, rslots, rc,
                       deadline)
    _launched("rpc_async_collect", _lib().rpc_async_collect_launch(
        ctypes.addressof(block),
        torch._C._cuda_getCurrentRawStream(ring.device.index)))
    rpc_async_collect.launches += 1


#: Launches since the last reset (plain counts; set them to 0 to reset).
rpc_async_post.launches = 0
rpc_async_collect.launches = 0


class AsyncFlushPlan:
    """A card queue's async flush in eager mode, made at its first flush
    (``core/rpc.py``'s ``_flush_async``) and taken by every later one: the
    block packed once by :func:`pack_flush` (the ring, the state and its
    geometry, the copy route never change), each :meth:`run` patching
    the epoch, the parity, ``have_prev`` and the deadline (read from the
    queue at every flush: a caller may change it after ``create``), then
    one C call, ``rpc_async_flush_launch``, that issues ``rpc_async_post``
    and ``rpc_async_collect`` on the current stream: two CUDA API calls up
    to ``COPY_LIMIT``.  Each launch counts as the ops' do.  Threads that
    share the queue patch and launch one at a time."""

    __slots__ = ("block", "address", "_index", "_entry", "_stream",
                 "_lock")

    def __init__(self, ring: AsyncRing, state: torch.Tensor, out_start: int,
                 has_reply: bool, rslots: int, rc: int):
        self.block = pack_flush(ring, state, 1, out_start, has_reply, rslots,
                                rc, None)
        self.address = ctypes.addressof(self.block)
        self._index = state.device.index
        self._lock = threading.Lock()
        self._bind()

    def _bind(self) -> None:
        """The C entry, and the current stream's raw handle, read every
        flush (callers switch streams) without making a stream object."""
        self._entry = _lib().rpc_async_flush_launch
        self._stream = torch._C._cuda_getCurrentRawStream

    def run(self, epoch: int, deadline: Optional[float]) -> None:
        """Epoch ``epoch``'s flush with ``deadline`` (seconds, or None)."""
        with self._lock:
            _set_epoch(self.block, epoch, deadline)
            err = self._entry(self.address, self._stream(self._index))
        _launched("rpc_async_flush", err)
        rpc_async_post.launches += 1
        rpc_async_collect.launches += 1


def floor_launch(word: Optional[int] = None) -> None:
    """The latency floor's launch on the current stream: an empty kernel,
    or one that makes one ``ld.acquire.sys`` round trip of the mapped
    word at device address ``word``."""
    _launched("rpc_async_floor", _lib().rpc_async_floor_launch(
        word, torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device())))


def api_calls() -> int:
    """CUDA API calls that the flush launches made in this process."""
    return _lib().rpc_async_api_calls()
