"""ctypes wrapper of the async queue's epoch hand-off (``csrc/rpc_async.cu``).

Replaces no Pallas kernel: the JAX package's async flush is an ordered
``io_callback`` (``repro/core/rpc.py::RpcQueue.flush``, ``mode="async"``).
An :class:`AsyncRing` belongs to one async queue on a card, with a row
for each of its shards (one for a single queue): its records and its
staging regions in pinned, host-mapped memory (per epoch parity, an
``in`` region holding every row and an ``out`` region a row), and an
ingest thread that waits in C for each posted epoch (Python's lock
released), copies every row's records out of ``in`` at once, acknowledges
them (``consumed``) and hands them to ``on_posted``.  Each row's drain
answers through :meth:`AsyncRing.complete` (its ``out`` written, then its
``done`` released).  :func:`rpc_async_post` and
:func:`rpc_async_collect` are the two launches of a flush; the plain
versions of their device work are ``ref.py``.  The library builds at the
first ring.  ``ops.py`` makes the two launches the custom ops
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
from repro_torch.kernels.rpc_channel.kernel import (ALIGN, SPIN_US,
                                                    TIMEOUT_S, WAIT_US,
                                                    _host_alloc)
from repro_torch.kernels.rpc_async.ref import H_CDEPTH

_P, _I, _U, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_size_t
_LL, _ULL = ctypes.c_longlong, ctypes.c_ulonglong

#: A record's stages (the ``enum`` in the source).
POSTED, CONSUMED, DONE, ABANDONED = range(4)


def _lib() -> ctypes.CDLL:
    lib = _build.load("rpc_async")
    if not getattr(lib, "typed", False):
        lib.rpc_async_record_bytes.restype = _I
        lib.rpc_async_post_launch.argtypes = [_P, _U, _P, _P, _SZ, _LL, _I,
                                              _P, _I, _P]
        lib.rpc_async_post_launch.restype = _I
        lib.rpc_async_collect_launch.argtypes = [_P, _U, _I, _ULL, _ULL, _P,
                                                 _LL, _P, _LL, _I, _I, _I,
                                                 _P, _P]
        lib.rpc_async_collect_launch.restype = _I
        lib.rpc_async_wait.argtypes = [_P, _U, _LL, _LL]
        lib.rpc_async_wait.restype = _I
        lib.rpc_async_store.argtypes = [_P, _I, _U]
        lib.rpc_async_store.restype = None
        lib.rpc_async_load.argtypes = [_P, _I]
        lib.rpc_async_load.restype = _U
        lib.typed = True
    return lib


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
    on.  ``on_posted(epoch, words)`` runs on the ingest thread with a
    ``(rows, in_words)`` copy of the epoch's records and must hand the
    drains off (it must not run callees: the next epoch's records wait
    behind it).  If it raises, the epoch is answered with zeros and the
    exception kept in ``error``."""

    def __init__(self, device: torch.device, in_words: int, out_words: int,
                 on_posted: Callable[[int, np.ndarray], None],
                 rows: int = 1):
        lib = _lib()
        rec = lib.rpc_async_record_bytes()
        self.device, self.rows = device, rows
        self.in_words, self.out_words = in_words, out_words
        # a record a row for each parity, a live carried depth a row, then
        # the regions (in, in, out, out)
        sizes = [4 * rows * in_words] * 2 + [4 * rows * out_words] * 2
        offsets = []
        end = -(-(2 * rows * rec + 4 * rows) // ALIGN) * ALIGN
        for n in sizes:
            offsets.append(end)
            end += -(-max(n, 4) // ALIGN) * ALIGN
        self.host, self.dev = _host_alloc(end)
        buf = np.ctypeslib.as_array((ctypes.c_uint8 * end).from_address(
            self.host))
        self._rec_bytes = rec
        self._rec = [self.host, self.host + rows * rec]
        self._rec_dev = [self.dev, self.dev + rows * rec]
        self._live_off = 2 * rows * rec
        self.live = buf[self._live_off:self._live_off + 4 * rows].view(
            np.int32)
        self._in = [buf[o:o + 4 * rows * in_words].view(np.int32).reshape(
            rows, in_words) for o in offsets[:2]]
        self._out = [buf[o:o + 4 * rows * out_words].view(np.int32).reshape(
            rows, out_words) for o in offsets[2:]]
        self._in_host = [self.host + o for o in offsets[:2]]
        self._out_dev = [self.dev + o for o in offsets[2:]]
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
        return self._rec[epoch & 1] + row * self._rec_bytes

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


def rpc_async_post(ring: AsyncRing, epoch: int, state: torch.Tensor,
                   out_start: int, has_reply: bool) -> None:
    """Hand epoch ``epoch`` to the host on the current stream: copy each
    row's words ``[0, in_words)`` into the ring, then launch
    ``rpc_async_post`` (the windows move on the device; nothing waits).
    ``state`` is the queue's words, ``(words,)`` or ``(rows, words)``."""
    pitch = _pitch(state, ring)
    stream = torch.cuda.current_stream(ring.device)
    p = epoch & 1
    err = _lib().rpc_async_post_launch(
        ring._rec_dev[p], epoch, ring._in_host[p], state.data_ptr(),
        4 * ring.in_words, pitch, ring.rows,
        state.data_ptr() + 4 * out_start, int(has_reply),
        ctypes.c_void_p(stream.cuda_stream))
    if err:
        raise RuntimeError(f"rpc_async_post: launch failed with CUDA error "
                           f"{err}")
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
    pitch = _pitch(state, ring)
    stream = torch.cuda.current_stream(ring.device)
    prev = epoch - 1
    p = prev & 1
    err = _lib().rpc_async_collect_launch(
        ring._rec_dev[p], prev & 0xFFFFFFFF, int(prev > 0),
        int(deadline * 1e9) if deadline else 0, int(TIMEOUT_S * 1e9),
        ring._out_dev[p], ring.out_words,
        state.data_ptr() + 4 * (out_start + H_CDEPTH), pitch, ring.rows,
        rslots, rc, ring.dev + ring._live_off,
        ctypes.c_void_p(stream.cuda_stream))
    if err:
        raise RuntimeError(f"rpc_async_collect: launch failed with CUDA "
                           f"error {err}")
    rpc_async_collect.launches += 1


#: Launches since the last reset (plain counts; set them to 0 to reset).
rpc_async_post.launches = 0
rpc_async_collect.launches = 0
