"""ctypes wrapper of the host RPC channel (``csrc/rpc_channel.cu``).

Replaces no Pallas kernel: the JAX package's transport is XLA's
``io_callback`` (``repro/core/rpc.py::rpc_call``).  A :class:`Channel`
belongs to one (device, stream).  It holds one record in pinned,
host-mapped memory, a sequence counter in device memory, its
:class:`Stagings` (one :class:`Staging` region per landing pad and result
shape, or per queue geometry, each under a channel-local id that the
record carries), and a daemon thread that drains the record: it waits in
C (``rpc_wait``, Python's lock released), runs the ``serve`` callable of
the record's staging id (numpy only, on the staging region's views) and
answers with ``rpc_complete``.  :func:`rpc_post` issues one round trip on
the channel's stream: the operand copies, the ``rpc_post`` kernel and the
result copies; the host never waits for the device there.  The library
builds at the first channel.
"""
from __future__ import annotations

import atexit
import ctypes
import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

_P, _I, _U, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_size_t
_LL, _ULL = ctypes.c_longlong, ctypes.c_ulonglong

#: A posted record unanswered for this long makes the kernel trap: a lost
#: drain thread fails the run instead of hanging it.
TIMEOUT_S = 120.0
#: The drain thread spins this long (us) after each wait starts, then naps
#: between polls (``rpc_wait`` in the source).
SPIN_US = 2000
#: Each wait of the drain thread ends after this long (us) to look at its
#: stop flag.
WAIT_US = 500_000
#: Scalar words a call can pass as kernel arguments (``kInlineWords``).
INLINE_WORDS = 16
#: Alignment of the staging slots, bytes.
ALIGN = 256


def _lib() -> ctypes.CDLL:
    lib = _build.load("rpc_channel")
    if not getattr(lib, "typed", False):
        lib.rpc_host_alloc.argtypes = [_SZ, ctypes.POINTER(_P),
                                       ctypes.POINTER(_P)]
        lib.rpc_host_alloc.restype = _I
        lib.rpc_record_bytes.restype = _I
        lib.rpc_roundtrip.argtypes = [_P, _P, _ULL, _ULL, _I, _P, _P, _P, _P,
                                      _I, _P, _I, _P, _P, _P, _P]
        lib.rpc_roundtrip.restype = _I
        lib.rpc_wait.argtypes = [_P, _LL, _LL, ctypes.POINTER(_ULL)]
        lib.rpc_wait.restype = _I
        lib.rpc_complete.argtypes = [_P, _U]
        lib.rpc_complete.restype = None
        lib.rpc_waited_ns.argtypes = [_P]
        lib.rpc_waited_ns.restype = _ULL
        lib.rpc_stream_sync.argtypes = [_P]
        lib.rpc_stream_sync.restype = _I
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

    def host_ptr(self, i: int) -> int:
        return self.host + self.offsets[i]


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


class Channel:
    """The RPC channel of one (device, stream): see the module docstring.

    ``stagings`` holds its staging regions (:class:`Stagings`); the drain
    serves the one whose id the record carries.  A callee's exception is
    kept in ``error`` (the record is answered all the same) and raised by
    the port's ``effects_barrier()``."""

    def __init__(self, device: torch.device, stream: torch.cuda.Stream):
        self.device, self.stream = device, stream
        lib = _lib()
        self.record_host, self.record_dev = _host_alloc(lib.rpc_record_bytes())
        # a channel first used by a program being exported is made under
        # the trace's fake mode: its own counter stays a real tensor
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.stagings = Stagings()
        self.error: Optional[BaseException] = None
        self.last_serve_ns = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._drain, name=f"rpc-drain-{device}", daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        lib = _lib()
        sid = _ULL()
        while not self._stop.is_set():
            if not lib.rpc_wait(self.record_host, WAIT_US, SPIN_US,
                                ctypes.byref(sid)):
                continue
            t0 = time.perf_counter_ns()
            status = 1
            try:
                self.stagings.serve(sid.value)
                status = 0
            except Exception as e:  # answered all the same; raised later
                if self.error is None:
                    self.error = e
            finally:
                self.last_serve_ns = time.perf_counter_ns() - t0
                lib.rpc_complete(self.record_host, status)

    @staticmethod
    def new_staging(slot_bytes: Sequence[int]) -> Staging:
        """A region for the channel's :class:`Stagings` (mapped memory)."""
        return Staging(slot_bytes)

    def waited_ns(self) -> int:
        """The device's wait in the last call, post to reply (its clock)."""
        return _lib().rpc_waited_ns(self.record_host)

    def sync(self) -> None:
        """Wait for the channel's stream, with Python's lock released."""
        err = _lib().rpc_stream_sync(ctypes.c_void_p(self.stream.cuda_stream))
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


class HostChannel:
    """The channel of CPU tensors: the same :class:`Stagings`, in host
    memory (:class:`HostStaging`), and no drain thread.  :meth:`post` is
    :func:`rpc_post`'s plain version: the operand copies into the region,
    the scalar words, the region's ``serve()`` (the drain's work) and the
    result copies, in that order on the calling thread.  Each thread has
    its own (:func:`host_channel`), and a call posted from inside a
    ``serve()`` gets a channel of its own too."""

    def __init__(self):
        self.stagings = Stagings()

    @staticmethod
    def new_staging(slot_bytes: Sequence[int]) -> Staging:
        return HostStaging(slot_bytes)

    def post(self, staging_id: int,
             inputs: Sequence[Tuple[int, torch.Tensor]],
             words: Sequence[int],
             outputs: Sequence[Tuple[int, torch.Tensor]]) -> None:
        if len(words) > INLINE_WORDS:
            raise ValueError(f"rpc_post: {len(words)} scalar words, at most "
                             f"{INLINE_WORDS}")
        staging = self.stagings.entries[staging_id][0]
        for slot, t in inputs:
            staging.slot(slot)[:] = _bytes(t).numpy()
        for k, w in enumerate(words):
            staging.word(k).view(np.uint32)[0] = w
        _HOST.depth += 1
        try:
            self.stagings.serve(staging_id)
        finally:
            _HOST.depth -= 1
        for slot, t in outputs:
            if not t.is_contiguous():
                raise ValueError("rpc_post: outputs must be contiguous")
            _bytes(t).copy_(torch.from_numpy(staging.slot(slot)))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's memory as uint8 (a view)."""
    return t.reshape(-1).view(torch.uint8)


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


def channel_for(device: torch.device) -> Channel:
    """The channel of ``device``'s current stream, made at first use."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
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


def rpc_post(channel: Channel, staging_id: int, staging: Staging,
             inputs: Sequence[Tuple[int, torch.Tensor]],
             words: Sequence[int],
             outputs: Sequence[Tuple[int, torch.Tensor]]) -> None:
    """One round trip on ``channel``'s stream: copy each ``(slot, tensor)``
    of ``inputs`` into the staging region, launch ``rpc_post`` with the
    scalar ``words`` (uint32 values) and ``staging_id`` (the region's id in
    ``channel.stagings``, which the record carries), then copy each
    ``(slot, tensor)`` of ``outputs`` out of the region into the tensor.
    Every tensor must be contiguous on the channel's device; the caller
    keeps them alive (PyTorch's stream-ordered allocator does)."""
    if len(words) > INLINE_WORDS:
        raise ValueError(f"rpc_post: {len(words)} scalar words, at most "
                         f"{INLINE_WORDS}")
    for _, t in list(inputs) + list(outputs):
        if t.device != channel.device or not t.is_contiguous():
            raise ValueError(f"rpc_post: a {t.device} tensor (contiguous "
                             f"{t.is_contiguous()}); the channel takes "
                             f"contiguous tensors on {channel.device}")

    def arrays(pairs, host_first):
        n = len(pairs)
        host = [staging.host_ptr(i) for i, _ in pairs]
        dev = [t.data_ptr() for _, t in pairs]
        dst, src = (host, dev) if host_first else (dev, host)
        return (n, (_P * n)(*dst), (_P * n)(*src),
                (_SZ * n)(*[t.numel() * t.element_size() for _, t in pairs]))

    n_in, in_dst, in_src, in_bytes = arrays(inputs, True)
    n_out, out_dst, out_src, out_bytes = arrays(outputs, False)
    err = _lib().rpc_roundtrip(
        channel.record_dev, channel.counter.data_ptr(), staging_id,
        int(TIMEOUT_S * 1e9), n_in, in_dst, in_src, in_bytes,
        (_U * INLINE_WORDS)(*words), len(words), staging.dev, n_out, out_dst,
        out_src, out_bytes, ctypes.c_void_p(channel.stream.cuda_stream))
    if err:
        raise RuntimeError(f"rpc_post: launch failed with CUDA error {err}")
    rpc_post.launches += 1


#: Launches since the last reset (a plain count; set it to 0 to reset).
rpc_post.launches = 0
