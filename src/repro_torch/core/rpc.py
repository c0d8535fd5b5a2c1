"""Generated host RPC (paper §3.2), immediate and batched, on the H100.

The port of ``repro/core/rpc.py``'s immediate calls and its synchronous,
single-device batched queue.  Device code calls a host-only function as
``fn.rpc(*args)`` (see :func:`host_rpc`) or ``rpc_call(name, *args,
result_shape=...)``.  Arguments may mix values
(tensors, Python numbers), :class:`Ref` (a pointer whose object ships to
the host and, unless ``access=READ``, back) and :class:`ArenaRef` (a heap
pointer whose object is found at run time through the allocator's
``find_obj``), in any order; the callee receives them in the same order.
Each distinct flattened argument signature of a callee gets one landing
pad, whose id is a content hash of (callee, signature): the same ids as
the JAX package's, since signatures are written as JAX writes them with
x64 off (a Python int is ``int32``, a Python float ``float32``, a 64-bit
tensor narrows to 32 bits; dtype names are numpy's, ``"bfloat16"``
included).

Transport, by the operands' device, as the kernels dispatch:

* **CUDA tensors** go through the port's channel
  (``kernels/rpc_channel``) in one launch of a CUDA kernel
  (``rpc_post``): it copies the operands into the pad's staging region in
  pinned, host-mapped memory (a slot above ``COPY_LIMIT`` takes a copy
  engine around the launch), posts the record, waits on a reply flag that
  a host thread sets after running the callee, and copies the result and
  the write-back refs out.  The first call of a (landing pad, result
  shapes, stream) makes a :class:`CallPlan`, which later calls take.  The
  Python thread never waits for the
  device: the call returns at once with tensors that the stream fills, as
  JAX's ordered ``io_callback`` never blocks the tracing thread.  Host
  effects are visible after :func:`effects_barrier`.  There is no
  fallback: a failed build, allocation or launch raises.
* **CPU tensors** (and calls with no tensor) take the same round trip
  on the thread's host channel (``kernels/rpc_channel``'s
  ``HostChannel``): the operands copied into a staging region of host
  memory, the same ``serve`` the card's drain runs, on the calling
  thread, and the result copied out.  :func:`rpc_call_reference` is the
  host-synchronous twin on any device (copy to the host, call the landing
  pad, copy back).

Each round trip is one call of the custom op ``torch.ops.repro_torch.
rpc_post``, each enqueue one of ``rpc_enqueue`` and each async flush one
of ``rpc_async_post`` and one of ``rpc_async_collect`` (``kernels/
rpc_*/ops.py``): the CUDA kernels are the launches named below, the CPU
kernels their plain versions, so ``torch.export`` of a program keeps its
transport as graph nodes (what ``analysis/walker.py`` reads).  A card
queue's enqueue in eager mode (no export, compile, dispatch or function
mode) launches the same kernel without the op's dispatch, through the
queue's cached enqueue plans (``kernels/rpc_queue/kernel.py::
EnqueuePlan``), and its async flush both launches of the flush in one C
call, through the queue's cached flush plan (``kernels/rpc_async/
kernel.py::AsyncFlushPlan``).

bf16 operands reach the callee as float32 and a bf16 write-back is rounded
back.  ``rpc_stats``' byte counts are JAX's: operands in, result and every
ref out (a READ ref too, as JAX returns it), each at its signature's
dtype.

**The batched transport** (:class:`RpcQueue`, ROADMAP queue 1, item 3.2):
a ring of records (callee id and up to W arguments: scalars in int32 or
float32 lanes, arrays in a payload arena) on the queue's device, JAX's
lanes, tickets, drops and statuses bit for bit.  On a card each
``enqueue`` is one launch of the ``rpc_enqueue`` kernel
(``kernels/rpc_queue``, no host contact; a fire-and-forget record writes
no ticket) and each ``flush`` one round trip
of the channel whose host side is the drain: it replays the records in
enqueue order, each callee isolated (an exception or a per-callee
``timeout`` fails only its record, with ``RetryPolicy`` retries of
``idempotent`` callees and the :func:`set_fault_injector` seam), and sends
back the reply arena, the per-slot offsets, lengths and statuses and the
reset heads.  A CPU queue runs the plain enqueue and calls the drain
directly.  Unlike JAX's value semantics, a queue's tensors are updated in
place, and ``enqueue``/``flush`` return the queue itself.

**The async transport** (``RpcQueue.create(mode="async")``): a flush
submits the closing epoch's drain to the queue's own single-thread
executor and installs the previous epoch's replies, so replies land one
epoch late and the drain overlaps the device's work; ``carry_budget``
redrives failed idempotent records in later epochs.  On a card a flush is
two launches (``kernels/rpc_async``): ``rpc_async_post`` hands the epoch
to the queue's ingest thread through mapped memory without waiting, and
``rpc_async_collect`` waits on the device for the previous epoch's answer
(or its deadline) and installs it.

**The sanitizer** (``RpcQueue.create(sanitize=True)``): each payload
reservation is ``[CANARY][words][CANARY]`` (written by the enqueue
kernel), and before each drain the host checks the canaries and scans the
payloads for :data:`POISON` (``analysis/sanitize.py::poison_free``
stamps it over a freed block), on the numpy words the drain already
holds.  :func:`sanitize_stats` has JAX's counters and per-epoch records.
``uaf_marshals`` counts ``ArenaRef`` marshals whose object was not found
(at the host, on any queue), ``stale_ticket_reads`` reads outside the
window in ``results_host``.  ``failed_ticket_reads`` counts failed reads
through ``result()`` on CPU queues only: a card queue's ``result()`` reads
nothing back.  The runtime emits :mod:`repro_torch.core.events` as JAX's
does (``queue_create``, ``rpc_enqueue``, ``rpc_flush``, ``rpc_result``,
``rpc_immediate``, ``arena_marshal``), none of them reading the device.

**The sharded transport** (:class:`ShardedRpcQueue`): D queue shards
stacked on one device, each enqueued through its ``local(d)`` view and
replayed in ``(device, slot)`` order; ``shard_deadline`` drains a sync
flush's shards concurrently (a late shard reads ``STATUS_TIMEOUT``).

**Durable identity** (:class:`RpcManifest`): every id is JAX's content
hash, and :func:`export_manifest` writes the pad, callee, format and
queue tables as the JAX package's JSON, byte for byte, which another
process (of either package) adopts with :func:`adopt_manifest`.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import json
import struct
import threading
import time
import traceback as traceback_mod
import warnings
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from queue import Empty as _QueueEmpty, SimpleQueue as _SimpleQueue
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._device import DeviceContext as _DeviceContext

from repro_torch.core import events
from repro_torch.core.allocator import I32, _concrete_int, as_i32, find_obj
from repro_torch.core.expand import in_region as _in_region
from repro_torch.distributed.collectives import (broadcast_from_first,
                                                 gather_blocks)
from repro_torch.kernels.rpc_async import (AsyncFlushPlan, AsyncRing,
                                           async_collect, async_post,
                                           collect_plain, post_plain)
from repro_torch.kernels.rpc_async.ref import H_CDEPTH
from repro_torch.kernels.rpc_channel import (channel_for, channels,
                                             host_channel, post)
from repro_torch.kernels.rpc_channel.kernel import (INLINE_WORDS, TIMEOUT_S,
                                                    Staging)
from repro_torch.kernels.rpc_queue import (Arg, Lanes, Record,
                                           enqueue as enqueue_op,
                                           geometry as lane_geometry)
from repro_torch.kernels.rpc_queue.kernel import EnqueuePlan, QueueLaunch
from repro_torch.kernels.rpc_queue.ops import flatten as flatten_record
from repro_torch.kernels.rpc_queue.ref import (CANARY as _CANARY, DEVICE,
                                               IMMEDIATE, PAYLOAD)
from repro_torch.tree import leaves, tree_map

READ, WRITE, READWRITE = "read", "write", "readwrite"

# marshalling kinds (also the first element of each signature entry)
VAL, REF, ARENA = "val", "ref", "arena"

# torch dtype -> (its name in a signature, the dtype it is staged in).
# 64-bit tensors narrow to 32 bits as JAX's with x64 off; numpy has no
# bfloat16, so bf16 travels as float32.
_DTYPES = {
    torch.float32: ("float32", torch.float32),
    torch.bfloat16: ("bfloat16", torch.float32),
    torch.float16: ("float16", torch.float16),
    torch.float64: ("float32", torch.float32),
    torch.int32: ("int32", torch.int32),
    torch.int64: ("int32", torch.int32),
    torch.int16: ("int16", torch.int16),
    torch.int8: ("int8", torch.int8),
    torch.uint8: ("uint8", torch.uint8),
    torch.bool: ("bool", torch.bool),
}
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
             "int16": 2, "int8": 1, "uint8": 1, "bool": 1}


# ---------------------------------------------------------------------------
# Sanitizer state (the transport side of the GPU First sanitizer)
# ---------------------------------------------------------------------------

#: Canary word written just before and after every payload reservation of
#: a ``sanitize=True`` queue; checked at the drain.
CANARY = np.int32(_CANARY)
#: Pattern ``analysis/sanitize.py::poison_free`` stamps over a freed heap
#: block's words; a sanitized drain scans the payloads for it.
POISON = np.int32(0x5A5A5A5A)


def _zero_san() -> Dict[str, Any]:
    return {"canary_stomps": 0,     # payload reservations with damaged canaries
            "poison_hits": 0,       # payloads carrying freed-block POISON words
            "uaf_marshals": 0,      # ArenaRef marshals whose lookup found no
            #                         live object (found == 0 at the pad)
            "stale_ticket_reads": 0,  # results_host reads outside the epoch
            #                           window on a sanitized queue
            "failed_ticket_reads": 0,  # result() consumed a failed ticket's
            #                            zeros (CPU queues)
            "epochs": []}           # one record a sanitized drain


_SAN: Dict[str, Any] = _zero_san()
_SAN_LOCK = threading.Lock()


def sanitize_stats() -> Dict[str, Any]:
    """Snapshot of the sanitizer's counters and its per-epoch records."""
    with _SAN_LOCK:
        out = dict(_SAN)
        out["epochs"] = list(out["epochs"])
        return out


def reset_sanitize_stats() -> None:
    with _SAN_LOCK:
        _SAN.clear()
        _SAN.update(_zero_san())


def _san_bump(key: str, n: int = 1) -> None:
    if n:
        with _SAN_LOCK:
            _SAN[key] += n


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy's dtype of ``dtype`` (no tensor made: this also runs under
    ``torch.export``'s fake tensors)."""
    return np.dtype(str(dtype).removeprefix("torch."))


@dataclasses.dataclass
class Ref:
    """A pointer-like argument: ships its underlying tensor to the host;
    ``WRITE`` and ``READWRITE`` refs come back with the callee's writes."""
    array: torch.Tensor
    access: str = READWRITE

    def __post_init__(self):
        if self.access not in (READ, WRITE, READWRITE):
            raise ValueError(f"Ref access {self.access!r}")


@dataclasses.dataclass
class ArenaRef:
    """A heap pointer whose underlying object is found at run time through
    the allocator's tracking table (the paper's dynamically identified
    objects): the callee receives ``ptr, base, size, found, arena``."""
    arena: torch.Tensor        # the 1-D heap
    ptr: Any                   # element offset returned by malloc
    state: Any                 # GenericState | BalancedState
    access: str = READWRITE

    def __post_init__(self):
        if self.access not in (READ, WRITE, READWRITE):
            raise ValueError(f"ArenaRef access {self.access!r}")


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of a call's result (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))


# ---------------------------------------------------------------------------
# Durable identity: content-hashed ids
# ---------------------------------------------------------------------------

def _stable_id(kind: str, key: str, bits: int) -> int:
    """Deterministic ``bits``-wide nonzero id for ``key`` (domain-separated
    by ``kind``): a sha256 prefix, stable across processes and platforms."""
    digest = hashlib.sha256(f"{kind}\x00{key}".encode("utf-8")).digest()
    v = int.from_bytes(digest[:8], "big") % (1 << bits)
    return v or 1


def _sig_to_json(sig: Tuple) -> list:
    """Canonical JSON form of a flattened signature (tuples -> lists)."""
    return [[e[0], list(e[1])] + list(e[2:]) for e in sig]


def stable_pad_id(name: str, sig: Tuple) -> int:
    """Content-hashed landing-pad id (63 bits)."""
    canon = json.dumps([name, _sig_to_json(sig)], separators=(",", ":"))
    return _stable_id("pad", canon, 63)


def stable_callee_id(name: str) -> int:
    """Content-hashed callee id (31 bits: it rides the batched queue's
    int32 ``callee`` lane)."""
    return _stable_id("callee", name, 31)


def stable_format_id(text: str) -> int:
    """Content-hashed interned-string id (fprintf formats, heap names),
    31 bits: it rides an int32 lane too."""
    return _stable_id("fmt", text, 31)


def stable_hook_id(key: str) -> int:
    """Content-hashed suffix of an auto-named ``device_run`` hook."""
    return _stable_id("hook", key, 31)


def _sig_from_json(obj) -> Tuple:
    """Inverse of :func:`_sig_to_json` (shapes back to int tuples)."""
    return tuple((e[0], tuple(int(d) for d in e[1])) + tuple(e[2:])
                 for e in obj)


#: Version of the manifest's JSON (JAX's): a manifest of another version
#: is refused.
MANIFEST_VERSION = 1

# libc registers these so that the manifest carries the interned format
# table without rpc importing libc: ``[export_fn, adopt_fn]`` once set,
# export returning ``{fid: string}`` and adopt restoring one.
_FORMAT_SECTION: List[Callable] = []


def register_format_section(export_fn: Callable[[], Dict[int, str]],
                            adopt_fn: Callable[[Dict[int, str]], None]
                            ) -> None:
    _FORMAT_SECTION[:] = [export_fn, adopt_fn]


def _refuse_in_region(what: str) -> None:
    """A queue flush inside an expanded region raises, as JAX's does
    (XLA cannot lower the drain inside a partitioned program): enqueue in
    the region and flush at the program boundary, as
    ``device_run(mesh=)`` does."""
    if _in_region():
        raise RuntimeError(
            f"{what} inside an expanded region: enqueue in the region and "
            "flush at the program boundary (device_run(mesh=) and "
            "ShardedRpcQueue.flush after expand do)")


def queue_geometry(q) -> Dict[str, int]:
    """The transport geometry of an :class:`RpcQueue` or a
    :class:`ShardedRpcQueue` as a plain dict: what another process needs
    to build a compatible queue."""
    shards = q.n_devices if isinstance(q, ShardedRpcQueue) else 1
    return {"capacity": int(q.capacity), "width": int(q.width),
            "payload_capacity": int(q.payload_capacity),
            "reply_capacity": int(q.reply_capacity),
            "shards": int(shards)}


@dataclasses.dataclass
class RpcManifest:
    """The table of every durable transport id, versioned and written as
    JSON byte for byte as the JAX package writes it: ``pads`` maps a pad
    id to ``{"callee": name, "signature": [...]}``, ``callees`` a batch
    callee id to its name, ``formats`` is the interned string table
    (fprintf formats and remote-heap names) and ``queues`` the geometries
    of the queues a program used.  A process that adopts it
    (:func:`adopt_manifest`) resolves the same ids without having made
    the calls."""
    version: int = MANIFEST_VERSION
    pads: Dict[int, dict] = dataclasses.field(default_factory=dict)
    callees: Dict[int, str] = dataclasses.field(default_factory=dict)
    formats: Dict[int, str] = dataclasses.field(default_factory=dict)
    queues: List[dict] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {"version": self.version,
             "pads": {str(k): {"callee": v["callee"],
                               "signature": v["signature"]}
                      for k, v in sorted(self.pads.items())},
             "callees": {str(k): v
                         for k, v in sorted(self.callees.items())},
             "formats": {str(k): v
                         for k, v in sorted(self.formats.items())},
             "queues": list(self.queues)},
            indent=2, sort_keys=True) + "\n"

    @staticmethod
    def from_json(text: str) -> "RpcManifest":
        obj = json.loads(text)
        version = int(obj.get("version", -1))
        if version != MANIFEST_VERSION:
            raise ValueError(
                f"RpcManifest version {version} is not supported "
                f"(this runtime speaks version {MANIFEST_VERSION})")
        return RpcManifest(
            version=version,
            pads={int(k): {"callee": v["callee"],
                           "signature": v["signature"]}
                  for k, v in obj.get("pads", {}).items()},
            callees={int(k): v for k, v in obj.get("callees", {}).items()},
            formats={int(k): v for k, v in obj.get("formats", {}).items()},
            queues=list(obj.get("queues", [])))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path) -> "RpcManifest":
        with open(path) as f:
            return RpcManifest.from_json(f.read())


# ---------------------------------------------------------------------------
# Registry: host functions, landing pads, stats
# ---------------------------------------------------------------------------

def _zero_stats() -> Dict[str, float]:
    return {"calls": 0, "bytes_in": 0, "bytes_out": 0}


class _Registry:
    """Host-function table, landing-pad table, batch-callee table and
    stats.  ``pads`` maps ``(callee,) + signature`` to a pad id,
    ``pad_wrappers`` holds the one host wrapper of each pad,
    ``pad_info``/``pad_stats`` its key and its counters, ``stats`` the
    counters of each callee; ``batch_ids``/``batch_names`` the queue's
    callee ids, ``idempotent`` which callees a retry may re-run, and the
    rest the flushes' drop and error counts."""

    def __init__(self):
        self.lock = threading.Lock()
        self.hosts: Dict[str, Callable] = {}
        self.pads: Dict[Tuple, int] = {}
        self.pad_wrappers: Dict[int, Callable] = {}
        self.pad_info: Dict[int, Tuple] = {}
        self.pad_stats: Dict[int, Dict[str, float]] = {}
        self.stats: Dict[str, Dict[str, float]] = {}
        self.batch_ids: Dict[str, int] = {}
        self.batch_names: Dict[int, str] = {}
        self.idempotent: Dict[str, bool] = {}
        self.queue_geoms: List[Dict[str, int]] = []
        self._zero_counts()

    def _zero_counts(self) -> None:
        self.queue_drops = self.arena_drops = self.reply_drops = 0
        self.callee_errors = self.retries = self.flushes = 0
        self.last_flush_drops = self.last_flush_arena_drops = 0
        self.last_flush_reply_drops = self.last_flush_callee_errors = 0

    def register(self, name: str, fn: Callable,
                 idempotent: bool = False) -> None:
        """(Re-)bind ``name`` to ``fn``; pads and stats survive, and pads
        already made dispatch to the new function.  ``idempotent=True``
        declares that re-running ``fn`` with the same arguments is safe:
        the gate for a queue's :class:`RetryPolicy`."""
        with self.lock:
            self.hosts[name] = fn
            self.idempotent[name] = bool(idempotent)
            self.stats.setdefault(name, dict(_zero_stats(), pads=0))

    def unregister(self, name: str) -> None:
        """Remove ``name``'s host binding, stats, landing pads and batch
        callee id; call it only after every posted call of ``name`` has
        run (:func:`effects_barrier`)."""
        with self.lock:
            self.hosts.pop(name, None)
            self.idempotent.pop(name, None)
            self.stats.pop(name, None)
            for key in [k for k in self.pads if k[0] == name]:
                pid = self.pads.pop(key)
                self.pad_wrappers.pop(pid, None)
                self.pad_info.pop(pid, None)
                self.pad_stats.pop(pid, None)
            cid = self.batch_ids.pop(name, None)
            if cid is not None:
                self.batch_names.pop(cid, None)

    def landing_pad(self, name: str, sig: Tuple) -> Tuple[int, Callable]:
        """The pad of (callee, flattened signature), made at its first
        call: ``(pad id, wrapper)``."""
        with self.lock:
            key = (name,) + sig
            pid = self.pads.get(key)
            if pid is None:
                pid = stable_pad_id(name, sig)
                other = self.pad_info.get(pid)
                if other is not None and other != key:
                    raise RuntimeError(
                        f"landing-pad id collision: {key!r} and {other!r} "
                        f"both hash to pad id {pid}; rename one callee")
                self.pads[key] = pid
                self.pad_info[pid] = key
                self.pad_stats[pid] = _zero_stats()
                self.pad_wrappers[pid] = _make_pad_wrapper(name, pid, sig)
                self.stats[name]["pads"] += 1
            return pid, self.pad_wrappers[pid]

    def batch_callee_id(self, name: str) -> int:
        """The id addressing ``name`` from queue records: the stable 31-bit
        content hash of the name (JAX's).  A collision between two
        registered names is an error."""
        with self.lock:
            if name not in self.hosts:
                raise KeyError(f"no host function registered for RPC {name!r}")
            cid = self.batch_ids.get(name)
            if cid is None:
                cid = stable_callee_id(name)
                other = self.batch_names.get(cid)
                if other is not None and other != name:
                    raise RuntimeError(
                        f"batch-callee id collision: {name!r} and {other!r} "
                        f"both hash to callee id {cid}; rename one callee")
                self.batch_names[cid] = name
                self.batch_ids[name] = cid
            return cid

    def note_queue_geometry(self, geom: Dict[str, int]) -> None:
        """Record one transport geometry (once) for the manifest's
        ``queues``: ``RpcQueue.create`` and ``ShardedRpcQueue.create``
        call it, so the manifest holds the queues that runtime layers
        (``device_run``'s hook queue, the engine's spill queue) made."""
        with self.lock:
            if geom not in self.queue_geoms:
                self.queue_geoms.append(dict(geom))

    def export_manifest(self, queues=()) -> RpcManifest:
        """The durable identity of everything registered so far: every
        landing pad (id, callee, signature), every batch callee id, the
        interned format table and the geometries of the queues noted here
        and of ``queues``."""
        with self.lock:
            pads = {pid: {"callee": key[0],
                          "signature": _sig_to_json(key[1:])}
                    for pid, key in self.pad_info.items()}
            callees = dict(self.batch_names)
            geoms = [dict(g) for g in self.queue_geoms]
        formats = _FORMAT_SECTION[0]() if _FORMAT_SECTION else {}
        for q in queues:
            g = queue_geometry(q)
            if g not in geoms:
                geoms.append(g)
        return RpcManifest(version=MANIFEST_VERSION, pads=pads,
                           callees=callees, formats=dict(formats),
                           queues=geoms)

    def adopt_manifest(self, manifest: RpcManifest,
                       require_hosts: bool = True) -> None:
        """Restore another process's id tables from ``manifest``.  Every
        entry is re-hashed first and must give its recorded id (a
        mismatched signature names its pad); ids bound here already must
        agree; with ``require_hosts`` every callee needs a host function
        registered before adoption.  Nothing changes unless all of it
        holds."""
        if manifest.version != MANIFEST_VERSION:
            raise ValueError(
                f"cannot adopt RpcManifest version {manifest.version}: this "
                f"runtime speaks version {MANIFEST_VERSION}")
        for pid, entry in sorted(manifest.pads.items()):
            name = entry["callee"]
            want = stable_pad_id(name, _sig_from_json(entry["signature"]))
            if want != pid:
                raise ValueError(
                    f"manifest pad {pid} ({name!r}) does not match its "
                    f"recorded signature: re-registration hashes to {want} "
                    "(mismatched signature for this pad)")
            if require_hosts and name not in self.hosts:
                raise ValueError(
                    f"manifest pad {pid} needs host function {name!r}, "
                    "which is not registered in this process; register "
                    "it (or import the module that does) before "
                    "adopt_manifest()")
        for cid, name in sorted(manifest.callees.items()):
            want = stable_callee_id(name)
            if want != cid:
                raise ValueError(
                    f"manifest callee id {cid} ({name!r}) does not match "
                    f"its content hash {want} (mismatched re-registration "
                    "for this pad)")
            if require_hosts and name not in self.hosts:
                raise ValueError(
                    f"manifest callee {name!r} (id {cid}) has no host "
                    "function registered in this process; register it "
                    "before adopt_manifest()")
        with self.lock:
            for cid, name in manifest.callees.items():
                local = self.batch_names.get(cid)
                if local is not None and local != name:
                    raise ValueError(
                        f"manifest callee id {cid} names {name!r} but is "
                        f"already bound to {local!r} in this process")
        if manifest.formats and not _FORMAT_SECTION:
            raise RuntimeError(
                "manifest carries interned format strings but no format "
                "section is registered (import repro_torch.core.libc "
                "before adopt_manifest())")
        with self.lock:
            for cid, name in manifest.callees.items():
                self.batch_names[cid] = name
                self.batch_ids[name] = cid
        for entry in manifest.pads.values():
            if entry["callee"] in self.hosts:
                self.landing_pad(entry["callee"],
                                 _sig_from_json(entry["signature"]))
        if manifest.formats:
            _FORMAT_SECTION[1](dict(manifest.formats))
        for g in manifest.queues:
            self.note_queue_geometry(dict(g))

    def bump(self, name: str, pad_id: Optional[int], bytes_in: int,
             bytes_out: int, calls: int = 1):
        with self.lock:
            for s in (self.stats[name],) + (
                    () if pad_id is None else (self.pad_stats[pad_id],)):
                s["calls"] += calls
                s["bytes_in"] += bytes_in
                s["bytes_out"] += bytes_out

    def bump_drops(self, n: int):
        with self.lock:
            self.queue_drops += n

    def bump_flush(self, drops: int, arena_drops: int = 0,
                   reply_drops: int = 0, callee_errors: int = 0,
                   retries: int = 0):
        with self.lock:
            self.flushes += 1
            self.last_flush_drops = drops
            self.arena_drops += arena_drops
            self.last_flush_arena_drops = arena_drops
            self.reply_drops += reply_drops
            self.last_flush_reply_drops = reply_drops
            self.callee_errors += callee_errors
            self.last_flush_callee_errors = callee_errors
            self.retries += retries


REGISTRY = _Registry()


def export_manifest(queues=()) -> RpcManifest:
    """:meth:`_Registry.export_manifest` of the process's registry."""
    return REGISTRY.export_manifest(queues=queues)


def adopt_manifest(manifest: RpcManifest, require_hosts: bool = True
                   ) -> None:
    """:meth:`_Registry.adopt_manifest` of the process's registry."""
    REGISTRY.adopt_manifest(manifest, require_hosts=require_hosts)


def rpc_stats(name: Optional[str] = None):
    """Per-callee stats (calls, bytes_in, bytes_out, pads); read them after
    :func:`effects_barrier`."""
    with REGISTRY.lock:
        if name is not None:
            return dict(REGISTRY.stats.get(name, {}))
        return {k: dict(v) for k, v in REGISTRY.stats.items()}


def pad_stats(pad_id: Optional[int] = None):
    """Per-landing-pad stats; ``pad_table()`` maps pad ids to signatures."""
    with REGISTRY.lock:
        if pad_id is not None:
            return dict(REGISTRY.pad_stats.get(pad_id, {}))
        return {k: dict(v) for k, v in REGISTRY.pad_stats.items()}


def pad_table():
    """Snapshot of the landing-pad table: pad id -> (callee, *signature)."""
    with REGISTRY.lock:
        return dict(REGISTRY.pad_info)


def queue_drops() -> int:
    """Total queue records overwritten before a flush could drain them."""
    with REGISTRY.lock:
        return REGISTRY.queue_drops


def flush_stats() -> Dict[str, int]:
    """Queue-flush accounting, JAX's keys: flushes; records lost to ring
    overwrite (``drops``), to a full payload arena (``arena_drops``,
    counted at enqueue) and to a full reply arena (``reply_drops``, callee
    not run); records whose callee raised or timed out after any retries
    (``callee_errors``) and the retries spent; each ``last_*`` for the
    latest flush alone.  Read it after :func:`effects_barrier`."""
    with REGISTRY.lock:
        return {"flushes": REGISTRY.flushes,
                "drops": REGISTRY.queue_drops,
                "last_drops": REGISTRY.last_flush_drops,
                "arena_drops": REGISTRY.arena_drops,
                "last_arena_drops": REGISTRY.last_flush_arena_drops,
                "reply_drops": REGISTRY.reply_drops,
                "last_reply_drops": REGISTRY.last_flush_reply_drops,
                "callee_errors": REGISTRY.callee_errors,
                "last_callee_errors": REGISTRY.last_flush_callee_errors,
                "retries": REGISTRY.retries}


def reset_rpc_stats() -> None:
    with REGISTRY.lock:
        for s in list(REGISTRY.stats.values()) + \
                list(REGISTRY.pad_stats.values()):
            for k in s:
                s[k] = 0
        REGISTRY._zero_counts()


# ---------------------------------------------------------------------------
# Landing pads and marshalling
# ---------------------------------------------------------------------------

def _entry_bytes(entry: Tuple) -> int:
    return int(np.prod(entry[1], dtype=np.int64)) * _ITEMSIZE[entry[2]]


def _make_pad_wrapper(name: str, pad_id: int, sig: Tuple):
    """The host landing pad (paper Fig. 3b): ``wrapper(flat)`` calls the
    callee on the flat operand arrays (an ``ArenaRef`` is five: ptr, base,
    size, found, arena), counts the call and returns the callee's result
    as it came (a pytree, one leaf per declared result).  The callee
    writes refs in place: the transport hands it buffers of its own and
    decides what comes back.  The callee is looked up at each call, so
    re-registering a name rebinds its pads."""
    bytes_in = sum(_entry_bytes(e) + (16 if e[0] == ARENA else 0)
                   for e in sig)
    bytes_refs = sum(_entry_bytes(e) for e in sig if e[0] != VAL)
    # where each ArenaRef's ``found`` operand sits in the callee's operands
    found_at, pos = [], 0
    for e in sig:
        if e[0] == ARENA:
            found_at.append(pos + 3)
        pos += 5 if e[0] == ARENA else 1

    def wrapper(flat: Sequence[np.ndarray]):
        # a freed (or wild) pointer marshalled: the lookup found no live
        # object.  Counted on every queue, at the host (JAX's pad does too)
        _san_bump("uaf_marshals", sum(int(flat[i]) == 0 for i in found_at))
        result = REGISTRY.hosts[name](*flat)
        out = sum(np.asarray(x).nbytes for x in leaves(result))
        REGISTRY.bump(name, pad_id, bytes_in, out + bytes_refs)
        return result

    wrapper.__name__ = f"rpc_pad_{pad_id}_{name}"
    return wrapper


def _flat(sig: Tuple, arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """The callee's operands from the marshalled ones: an ``ArenaRef``'s
    (4,) int32 (ptr, base, size, found) becomes four 0-d arrays."""
    flat, it = [], iter(arrays)
    for entry in sig:
        a = next(it)
        if entry[0] == ARENA:
            flat.extend(a[k:k + 1].reshape(()) for k in range(4))
            a = next(it)
        flat.append(a)
    return flat


def _scalar(a) -> np.ndarray:
    """A Python or numpy number as the 0-d array JAX makes of it (x64
    off: 64-bit narrows to 32)."""
    if isinstance(a, (bool, np.bool_)):
        return np.asarray(a, np.bool_)
    if isinstance(a, np.generic) and a.dtype.itemsize < 8:
        return np.asarray(a)
    if isinstance(a, (int, np.integer)):
        return np.asarray(np.int32(a))
    return np.asarray(np.float32(a))


def _stage(t: torch.Tensor) -> Tuple[torch.Tensor, str]:
    if t.dtype not in _DTYPES:
        raise TypeError(f"RPC operand of dtype {t.dtype} is not supported")
    name, staged = _DTYPES[t.dtype]
    if t.requires_grad:
        t = t.detach()
    if t.dtype is not staged:
        t = t.to(staged)
    return t.contiguous(), name


def _device_of(args, device) -> torch.device:
    """The operands' device; ``device`` for a call with no tensor operand
    (the host when it is None)."""
    found = set()
    for a in args:
        parts = ([a.array] if isinstance(a, Ref) else
                 [a.arena, a.ptr] if isinstance(a, ArenaRef) else [a])
        found.update(p.device for p in parts if isinstance(p, torch.Tensor))
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        found.add(device)
    if len(found) > 1:
        raise ValueError("RPC operands on several devices: "
                         f"{sorted(map(str, found))}")
    return found.pop() if found else torch.device("cpu")


def _marshal(args, device: torch.device):
    """Flatten call-site arguments in their order.  Returns ``(sig, ops,
    refs)``: the signature (the pad's key), the operands (a staged tensor,
    or a 0-d numpy array for a Python number) and, for each ref, ``(index
    in ops, access, original tensor)``."""
    sig, ops, refs = [], [], []
    for a in args:
        if isinstance(a, Ref):
            t, dname = _stage(a.array)
            sig.append((REF, tuple(a.array.shape), dname, a.access))
            refs.append((len(ops), a.access, a.array))
            ops.append(t)
        elif isinstance(a, ArenaRef):
            if events.active():
                events.emit("arena_marshal", _refs=(a.ptr,),
                            ptr_id=id(a.ptr), ptr=_concrete_int(a.ptr),
                            heap=getattr(a.state, "heap_size", None))
            found, base, size = find_obj(a.state, a.ptr)
            ops.append(torch.stack([as_i32(a.ptr, device), base.to(I32),
                                    size.to(I32), found.to(I32)]))
            t, dname = _stage(a.arena)
            sig.append((ARENA, tuple(a.arena.shape), dname, a.access))
            refs.append((len(ops), a.access, a.arena))
            ops.append(t)
        elif isinstance(a, torch.Tensor):
            t, dname = _stage(a)
            sig.append((VAL, tuple(a.shape), dname))
            ops.append(t)
        elif isinstance(a, (bool, int, float, np.generic)):
            v = _scalar(a)
            sig.append((VAL, (), v.dtype.name))
            ops.append(v)
        else:
            raise TypeError(f"RPC argument of type {type(a).__name__}: pass "
                            "a tensor, a number, a Ref or an ArenaRef")
    return tuple(sig), ops, refs


def _store(view: np.ndarray, out, name: str) -> None:
    out = np.asarray(out)
    if out.shape != view.shape:
        raise ValueError(f"RPC {name!r} returned shape {out.shape}; its "
                         f"result_shape is {view.shape}")
    view[...] = out


def _result_specs(result_shape):
    """``result_shape`` (any pytree of objects with ``shape`` and
    ``dtype``, as JAX takes it; ``()`` for no result) as the same tree of
    :class:`ShapeDtype`.  A :class:`ShapeDtype` or a tuple of them is
    looked up by value, its specs made once; any other tree (whose leaves
    may be tensors, kept by identity) is mapped at each call."""
    by_value = type(result_shape) is ShapeDtype or (
        type(result_shape) is tuple
        and all(type(s) is ShapeDtype for s in result_shape))
    if by_value and result_shape in _SPECS:
        return _SPECS[result_shape]

    def spec(s):
        if not (hasattr(s, "shape") and hasattr(s, "dtype")):
            raise TypeError(f"result_shape leaf {s!r} has no shape and dtype")
        return ShapeDtype(s.shape, _torch_dtype(s.dtype))

    specs = tree_map(spec, result_shape)
    if by_value:
        _SPECS[result_shape] = specs
    return specs


#: :func:`_result_specs` of each ShapeDtype result shape, by value.
_SPECS: Dict[Any, Any] = {}


def _result_leaves(specs, result, name: str) -> List[Any]:
    """The callee's ``result`` cut along the structure of ``specs``: one
    array-like per declared leaf (a leaf spec takes the whole result, so
    a list fills a 1-D result; ``None`` answers an empty tree)."""
    if specs is None or (isinstance(specs, (tuple, list, dict))
                         and not leaves(specs)):
        return []
    if isinstance(specs, ShapeDtype):
        return [result]
    if isinstance(specs, dict):
        if not isinstance(result, dict) or sorted(result) != sorted(specs):
            raise ValueError(f"RPC {name!r} returned {type(result).__name__}"
                             f"; its result_shape is a dict of "
                             f"{sorted(specs)}")
        return [x for k in sorted(specs)
                for x in _result_leaves(specs[k], result[k], name)]
    if not isinstance(result, (tuple, list)) or len(result) != len(specs):
        raise ValueError(f"RPC {name!r} returned {type(result).__name__}; "
                         f"its result_shape is a sequence of {len(specs)}")
    return [x for s, r in zip(specs, result)
            for x in _result_leaves(s, r, name)]


def _rebuild(specs, values: List[torch.Tensor]):
    """``values`` (one per leaf of ``specs``, in order) in the tree of
    ``specs``."""
    it = iter(values)
    return tree_map(lambda _: next(it), specs)


def _prepare(name: str, args, result_shape, pure: bool, device):
    if name not in REGISTRY.hosts:
        raise KeyError(f"no host function registered for RPC {name!r}")
    if result_shape is None:
        raise TypeError("rpc_call() missing required keyword argument "
                        "'result_shape'")
    specs = _result_specs(result_shape)
    device = _device_of(args, device)
    sig, ops, refs = _marshal(args, device)
    if pure and any(acc != READ for _, acc, _ in refs):
        raise ValueError(
            f"pure RPC {name!r} cannot take write/readwrite refs: a pure "
            "call may be elided or reordered, so host-side mutation has no "
            "defined meaning")
    pid, _ = REGISTRY.landing_pad(name, sig)
    return specs, device, sig, ops, refs, pid


def rpc_call(name: str, *args, result_shape=None, pure: bool = False,
             device=None, batched: bool = False, queue=None, where=None,
             returns=None):
    """Call host function ``name`` from device code.

    ``args`` may mix values, :class:`Ref` and :class:`ArenaRef` in any
    order.  Returns ``(result, updated)``: ``result`` a tensor of
    ``result_shape`` (a :class:`ShapeDtype`, or any object with ``shape``
    and ``dtype``) on the operands' device, ``updated`` one tensor for
    each ref in order, a new one for ``WRITE``/``READWRITE`` and the
    caller's own for ``READ``.  Dispatch is by the operands' device (see
    the module docstring); on a card the call returns before the host has
    run it.  ``device`` names the device of a call with no tensor operand
    (by default the host), and must agree with the operands' otherwise.
    ``pure=True`` refuses write-back refs.

    ``batched=True`` enqueues the call on ``queue`` (an :class:`RpcQueue`)
    instead: value arguments only (scalars and arrays), ``where`` makes it
    conditional, and the host sees it at the queue's flush.  It returns
    the queue, or ``(queue, ticket)`` with ``returns`` (the reply's shape
    and dtype, read after the flush with ``queue.result(ticket, returns)``);
    ``result_shape`` is ignored."""
    if name not in REGISTRY.hosts:
        raise KeyError(f"no host function registered for RPC {name!r}")
    if batched:
        if queue is None:
            raise ValueError(
                "rpc_call(batched=True) needs queue=<RpcQueue>: batched "
                "RPCs live in the on-device ring until flush")
        if pure:
            raise ValueError("batched RPCs are effectful records; "
                             "pure=True does not apply")
        for j, a in enumerate(args):
            if isinstance(a, (Ref, ArenaRef)):
                raise ValueError(
                    f"batched RPC {name!r} arg {j}: Ref/ArenaRef arguments "
                    "need a synchronous round trip (write-back / runtime "
                    "object lookup) that the batched transport does not "
                    "provide; pass value args (scalars or arrays) only; "
                    "host RESULTS do come back: use returns= for a ticket "
                    "readable via queue.result() after flush")
        if returns is not None:
            return queue.enqueue_ticketed(name, *args, returns=returns,
                                          where=where)
        return queue.enqueue(name, *args, where=where)
    if returns is not None:
        raise ValueError(
            "rpc_call(returns=...) is only meaningful with batched=True: "
            "immediate RPCs return results directly via result_shape")
    if where is not None:
        raise ValueError(
            "rpc_call(where=...) is only meaningful with batched=True: an "
            "immediate call has no conditional form; route it through a "
            "queue")
    if events.active():
        # every immediate call is ordered here
        events.emit("rpc_immediate", name=name, ordered=True, pure=pure,
                    in_mesh=_in_region())
    specs, device, sig, ops, refs, pid = _prepare(name, args, result_shape,
                                                  pure, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"RPC operands on {device}")
    return _call_channel(name, pid, sig, ops, refs, specs, device)


def rpc_call_reference(name: str, *args, result_shape=None,
                       pure: bool = False, device=None):
    """The transport's plain version, on any device: copy every operand to
    the host (for CUDA tensors this waits for the device), call the
    landing pad, copy the result and the write-backs back.  ``rpc_call``
    takes it for CPU operands."""
    specs, device, sig, ops, refs, pid = _prepare(name, args, result_shape,
                                                  pure, device)
    return _call_host(name, pid, sig, ops, refs, specs, device)


def _call_host(name, pid, sig, ops, refs, specs, device):
    ref_at = {i for i, _, _ in refs}
    arrays = []
    for i, op in enumerate(ops):
        if isinstance(op, torch.Tensor):
            a = op.cpu().numpy()
            if i in ref_at:
                a = a.copy()                 # the callee's own buffer
            else:
                a = a.view()
                a.flags.writeable = False
            op = a
        arrays.append(op)
    out = REGISTRY.pad_wrappers[pid](_flat(sig, arrays))
    results = []
    for spec, o in zip(leaves(specs), _result_leaves(specs, out, name)):
        res = np.empty(spec.shape, _np_dtype(_DTYPES[spec.dtype][1]))
        _store(res, o, name)
        results.append(torch.from_numpy(res).to(device=device,
                                                dtype=spec.dtype))
    updated = [orig if acc == READ else
               torch.from_numpy(arrays[i]).to(device=device, dtype=orig.dtype)
               for i, acc, orig in refs]
    return _rebuild(specs, results), updated


def staging_key(pid: int, specs) -> Tuple:
    """The key of an immediate call's staging region on a channel: its
    landing pad and its result shapes.  The pad fixes the operands' slots,
    the result shapes the result's (JAX's ``io_callback`` takes a result
    shape at each call site, so one callee may return 1, 64 or 1024
    elements); pad statistics stay keyed by the pad id."""
    return ("pad", pid, repr(specs))


def _pad_staging(channel, name, pid, sig, ops, specs) -> Tuple[int, Staging]:
    """``(staging id, region)`` of the pad at these result shapes on
    ``channel``, made at its first call there.  Tensor operands get a slot
    each, Python numbers a scalar word, each result leaf a slot after
    them."""
    def make():
        tensors = [op for op in ops if isinstance(op, torch.Tensor)]
        spec_leaves = leaves(specs)
        res_bytes = [int(np.prod(s.shape, dtype=np.int64))
                     * torch.empty((), dtype=_DTYPES[s.dtype][1])
                     .element_size() for s in spec_leaves]
        staging = channel.new_staging(
            [t.numel() * t.element_size() for t in tensors] + res_bytes)
        views, slot, word = [], 0, 0
        for op in ops:
            if isinstance(op, torch.Tensor):
                raw = staging.slot(slot)
                views.append(raw.view(_np_dtype(op.dtype)).reshape(op.shape))
                slot += 1
            else:
                views.append(staging.word(word)[:op.dtype.itemsize]
                             .view(op.dtype).reshape(()))
                word += 1
        res_views = [staging.slot(slot + i)
                     .view(_np_dtype(_DTYPES[s.dtype][1])).reshape(s.shape)
                     for i, s in enumerate(spec_leaves)]

        def serve():
            out = REGISTRY.pad_wrappers[pid](_flat(sig, views))
            for view, o in zip(res_views, _result_leaves(specs, out, name)):
                _store(view, o, name)

        return staging, serve

    return channel.stagings.get(staging_key(pid, specs), make)


class CallPlan:
    """An immediate call's plan on one channel, made at the first call of a
    (landing pad, result specs, channel) and taken by every later one:
    the staging id and region (:func:`_pad_staging`), the slot of each
    tensor operand (``tensor_ops``, in order, into slots 0, 1, ...) and
    the scalar word of each Python number (``word_ops``), the result leaves
    (``results``: shape, staged dtype, the spec's dtype) and the write-back
    refs (``back_ops``), and ``out_slots``: the results' slots, then the
    write-backs'; and ``launch``, the descriptor that the launch takes
    (``Launch``: each slot's offset, bytes and copy route), which the
    channel also keeps under the staging id, where the op finds it.  A
    later call fills in the tensors and the words and makes one call of
    the op."""

    __slots__ = ("sid", "staging", "tensor_ops", "in_slots", "word_ops",
                 "results", "back_ops", "out_slots", "single", "launch")

    def __init__(self, channel, name, pid, sig, ops, refs, specs):
        self.sid, self.staging = _pad_staging(channel, name, pid, sig, ops,
                                              specs)
        self.tensor_ops = [i for i, op in enumerate(ops)
                           if isinstance(op, torch.Tensor)]
        self.word_ops = [i for i, op in enumerate(ops)
                         if not isinstance(op, torch.Tensor)]
        if len(self.word_ops) > INLINE_WORDS:
            raise ValueError(f"RPC {name!r}: {len(self.word_ops)} "
                             f"Python-number operands, at most "
                             f"{INLINE_WORDS}; pass tensors")
        n = len(self.tensor_ops)
        self.in_slots = list(range(n))
        self.results = [(s.shape, _DTYPES[s.dtype][1], s.dtype)
                        for s in leaves(specs)]
        self.single = isinstance(specs, ShapeDtype)
        slot_of = {i: k for k, i in enumerate(self.tensor_ops)}
        self.back_ops = [i for i, acc, _ in refs if acc != READ]
        self.out_slots = [n + k for k in range(len(self.results))] + \
            [slot_of[i] for i in self.back_ops]
        self.launch = channel.launch_for(self.sid, self.in_slots,
                                         self.out_slots)

    def call(self, ops, refs, specs, device):
        """One round trip of ``ops``; returns ``(result, updated)``."""
        results = [torch.empty(shape, dtype=dt, device=device)
                   for shape, dt, _ in self.results]
        backs = [torch.empty_like(ops[i]) for i in self.back_ops]
        post(device, self.sid, [ops[i] for i in self.tensor_ops],
             self.in_slots,
             [int.from_bytes(ops[i].tobytes(), "little")
              for i in self.word_ops], results + backs, self.out_slots)
        results = [r if dt is want else r.to(want)
                   for r, (_, dt, want) in zip(results, self.results)]
        back = dict(zip(self.back_ops, backs))
        updated = [orig if acc == READ else back[i].to(orig.dtype)
                   for i, acc, orig in refs]
        return (results[0] if self.single else _rebuild(specs, results)), \
            updated


def plan_key(pid: int, specs) -> Tuple:
    """The key of a call plan on a channel: the landing pad and the result
    specs (their ``repr`` where they cannot be hashed)."""
    try:
        hash(specs)
    except TypeError:
        return pid, repr(specs)
    return pid, specs


def _call_channel(name, pid, sig, ops, refs, specs, device):
    channel = host_channel() if device.type == "cpu" else channel_for(device)
    key = plan_key(pid, specs)
    plan = channel.plans.get(key)
    if plan is None:
        plan = channel.plans[key] = CallPlan(channel, name, pid, sig, ops,
                                             refs, specs)
    return plan.call(ops, refs, specs, device)


def effects_barrier() -> None:
    """Wait until every host call posted so far has run (the counterpart
    of ``jax.effects_barrier()``): synchronise each channel's stream; a
    posted call's record is answered only after its callee returned.
    Raises the first exception a callee raised since the last barrier."""
    errors = []
    for ch in channels():
        ch.sync()
        err = ch.take_error()
        if err is not None:
            errors.append(err)
    if errors:
        raise RuntimeError(f"a host RPC callee raised: {errors[0]!r}") \
            from errors[0]


# ---------------------------------------------------------------------------
# Fault-tolerant host boundary: reply statuses, error log, retry, timeout
# ---------------------------------------------------------------------------
#
# Every record's callee is isolated: an exception or a wall-clock timeout
# fails only that record (traceback in ``error_log()``, count in
# ``flush_stats()['callee_errors']``) while the rest replay in order, and
# every ticketed reply carries a status that ``result_status`` reads.

#: Reply statuses (JAX's values).  The drain stamps one per serviced ring
#: slot; ``result_status`` adds DROPPED for a -1 ticket and STALE for a
#: ticket outside the last flush's window.
STATUS_OK = 0               # callee ran, reply (if declared) delivered
STATUS_CALLEE_RAISED = 1    # callee raised; traceback in error_log()
STATUS_TIMEOUT = 2          # callee exceeded the queue's per-callee timeout
STATUS_DROPPED = 3          # record dropped at enqueue (where=False / arena
#                             full), or its reply dropped by fault injection
STATUS_REPLY_OVERFLOW = 4   # reply arena full at drain: callee NOT run
STATUS_STALE = 5            # ticket from an epoch other than the last flush
STATUS_PENDING = 6          # async transport: the ticket's epoch is submitted
#                             but not collected, or its record is carried

STATUS_NAMES = {STATUS_OK: "OK", STATUS_CALLEE_RAISED: "CALLEE_RAISED",
                STATUS_TIMEOUT: "TIMEOUT", STATUS_DROPPED: "DROPPED",
                STATUS_REPLY_OVERFLOW: "REPLY_OVERFLOW",
                STATUS_STALE: "STALE", STATUS_PENDING: "PENDING"}

#: Bounded host-side error log (oldest entries evicted past the cap).
_ERROR_LOG_CAP = 256
_ERRORS: List[Dict[str, Any]] = []
_ERR_LOCK = threading.Lock()


def error_log() -> List[Dict[str, Any]]:
    """Captured callee failures, oldest first: ``{"callee", "ticket",
    "attempt", "error", "traceback"}`` with ``ticket`` the record's global
    sequence number and ``attempt`` the 1-based attempt that failed."""
    with _ERR_LOCK:
        return [dict(e) for e in _ERRORS]


def clear_error_log() -> None:
    with _ERR_LOCK:
        _ERRORS.clear()


def _log_callee_error(name: str, ticket: int, attempt: int,
                      exc: BaseException) -> None:
    entry = {"callee": name, "ticket": int(ticket), "attempt": int(attempt),
             "error": repr(exc),
             "traceback": "".join(traceback_mod.format_exception(
                 type(exc), exc, exc.__traceback__))}
    with _ERR_LOCK:
        _ERRORS.append(entry)
        if len(_ERRORS) > _ERROR_LOG_CAP:
            del _ERRORS[:len(_ERRORS) - _ERROR_LOG_CAP]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Host-side retry for transiently failing batched callees: a failed
    record re-runs up to ``max_attempts`` times in all within its drain,
    sleeping ``backoff * 2**(attempt-1)`` seconds between attempts;
    ``retryable`` (``exc -> bool``) filters the exceptions worth retrying.
    Only callees registered ``idempotent=True`` are re-run."""
    max_attempts: int = 2
    backoff: float = 0.0
    retryable: Optional[Callable[[BaseException], bool]] = None


class _CalleeTimeout(Exception):
    """A callee exceeded the queue's per-callee wall-clock timeout."""


class _PipelinedCall:
    """One record in flight on a :class:`_CalleeWorker`'s inbox.  The
    worker's ``claim()`` and the drain's ``cancel()`` race under the item's
    lock and exactly one wins, so a record redriven on a fresh worker
    after a timeout runs at most once."""

    __slots__ = ("fn", "args", "seq", "src", "_lk", "claimed", "cancelled")

    def __init__(self, fn, args, seq: int, src: "_CalleeWorker") -> None:
        self.fn = fn
        self.args = args
        self.seq = seq
        self.src = src          # the worker whose outbox holds the result
        self._lk = threading.Lock()
        self.claimed = False
        self.cancelled = False

    def claim(self) -> bool:
        with self._lk:
            if self.cancelled:
                return False
            self.claimed = True
            return True

    def cancel(self) -> bool:
        with self._lk:
            if self.claimed:
                return False
            self.cancelled = True
            return True


class _CalleeWorker:
    """A daemon thread that runs a serial stream of callee invocations for
    the ``timeout=`` path: a drain checks one out and streams its records
    through an inbox/outbox pair.  A timed-out callee wedges its worker
    (a thread cannot be killed), so the worker is abandoned and the next
    record gets a fresh one."""

    def __init__(self) -> None:
        self._inbox: _SimpleQueue = _SimpleQueue()
        self._outbox: _SimpleQueue = _SimpleQueue()
        self._seq = 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="rpc-callee-worker")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._inbox.get()
            if not item.claim():
                continue                 # cancelled before it ever ran
            try:
                out = (True, item.fn(*item.args), item.seq)
            except BaseException as exc:  # noqa: BLE001 (relayed)
                out = (False, exc, item.seq)
            self._outbox.put(out)

    def submit(self, fn, args) -> _PipelinedCall:
        self._seq += 1
        item = _PipelinedCall(fn, args, self._seq, self)
        self._inbox.put(item)
        return item

    def collect(self, seq: int, timeout: float):
        while True:
            try:
                ok, val, s = self._outbox.get_nowait()
            except _QueueEmpty:
                try:
                    ok, val, s = self._outbox.get(timeout=timeout)
                except _QueueEmpty:
                    raise _CalleeTimeout(
                        f"host callee exceeded the {timeout}s per-callee "
                        "timeout (still running in its worker thread; "
                        "record marked TIMEOUT)") from None
            if s != seq:
                continue   # stale result from an already-abandoned record
            if ok:
                return val
            raise val


_IDLE_WORKERS: List[_CalleeWorker] = []
_WORKER_LOCK = threading.Lock()


def _checkout_worker() -> _CalleeWorker:
    with _WORKER_LOCK:
        if _IDLE_WORKERS:
            return _IDLE_WORKERS.pop()
    return _CalleeWorker()


def _return_worker(w: _CalleeWorker) -> None:
    with _WORKER_LOCK:
        _IDLE_WORKERS.append(w)


class _WorkerLease:
    """A drain's handle on one checked-out :class:`_CalleeWorker`: checked
    out at first use, returned to the idle pool at ``release()``.
    ``submit``/``collect`` pipeline a fault-free epoch; ``call`` is the
    strict ping-pong that an injector or a retry policy needs.  A timeout
    abandons the wedged worker."""

    __slots__ = ("_w",)

    def __init__(self) -> None:
        self._w: Optional[_CalleeWorker] = None

    def submit(self, fn, args) -> _PipelinedCall:
        if self._w is None:
            self._w = _checkout_worker()
        return self._w.submit(fn, args)

    def collect(self, item: _PipelinedCall, timeout: float):
        return item.src.collect(item.seq, timeout)

    def call(self, fn, args, timeout: float):
        item = self.submit(fn, args)
        try:
            return item.src.collect(item.seq, timeout)
        except _CalleeTimeout:
            self._w = None           # wedged: abandon, never reuse
            raise

    def handle_timeout(self, pending: List[_PipelinedCall]
                       ) -> List[_PipelinedCall]:
        """After the oldest in-flight record timed out: if the worker has
        claimed the next one, the callee finished late and the worker is
        healthy; otherwise abandon it and resubmit, in order, every queued
        record whose cancel wins on a fresh worker."""
        if not pending:
            self._w = None
            return pending
        if not pending[0].cancel():
            return pending           # late completion: worker is healthy
        self._w = None
        out = [self.submit(pending[0].fn, pending[0].args)]
        for item in pending[1:]:
            out.append(self.submit(item.fn, item.args) if item.cancel()
                       else item)
        return out

    def drop(self) -> None:
        """Forget the worker without pooling it: a deadline-abandoned drain
        walks away while the worker may still run a record nobody reads."""
        self._w = None

    def release(self) -> None:
        if self._w is not None:
            _return_worker(self._w)
            self._w = None


def _call_with_timeout(fn, args, timeout: float, lease=None):
    """Run ``fn(*args)`` with a wall-clock deadline; a timed-out callee
    keeps running in its abandoned worker and its record fails TIMEOUT."""
    if lease is not None:
        return lease.call(fn, args, timeout)
    one_shot = _WorkerLease()
    try:
        return one_shot.call(fn, args, timeout)
    finally:
        one_shot.release()


# The deterministic fault-injection seam (repro_torch.testing.faults plugs
# in here), consulted at dispatch time inside the drain.  Protocol:
# ``on_call(name, attempt, index=None) -> Optional[delay_seconds]`` (may
# raise to fail the record before its callee runs) and ``on_reply(name,
# words, index=None) -> Optional[int32 words]`` (``None`` drops the reply;
# a changed array corrupts it).  A synchronous drain passes no occurrence
# index: the injector counts first attempts itself in replay order.  An
# async drain reserves the indices at its flush, in flush order
# (``reserve(names)``), and passes them, so a drain on another thread and
# an epoch-late carried redrive keep the serial numbering.
_FAULT_INJECTOR: List[Any] = []


def set_fault_injector(inj=None) -> None:
    """Install (or with ``None`` remove) the process-wide drain fault
    injector (see :mod:`repro_torch.testing.faults`)."""
    _FAULT_INJECTOR[:] = [] if inj is None else [inj]


def _invoke_record(name: str, fn, args, ticket: int, inj,
                   retry: Optional[RetryPolicy], timeout: Optional[float],
                   idempotent: bool, first_attempt: int = 1,
                   occ_index: Optional[int] = None, lease=None):
    """Run one record's callee with failure isolation, fault injection,
    timeout and (idempotent-gated) retry.  Returns ``(status, out,
    n_retries)``; ``out`` is None on failure.  ``first_attempt`` numbers
    the attempts for the injector and the budget (a carried record's
    redrive goes on where its drain stopped); ``occ_index`` is a reserved
    occurrence index."""
    attempts = (first_attempt - 1 + retry.max_attempts
                if (retry is not None and idempotent) else first_attempt)
    attempt = first_attempt
    while True:
        try:
            if inj is None:
                delay = None
            elif occ_index is None:
                delay = inj.on_call(name, attempt)
            else:
                delay = inj.on_call(name, attempt, index=occ_index)
            if delay:
                call = (lambda *a: (time.sleep(delay), fn(*a))[1])
            else:
                call = fn
            if timeout is not None:
                out = _call_with_timeout(call, args, timeout, lease=lease)
            else:
                out = call(*args)
            return STATUS_OK, out, attempt - first_attempt
        except Exception as exc:         # noqa: BLE001 (the isolation point)
            _log_callee_error(name, ticket, attempt, exc)
            timed_out = isinstance(exc, _CalleeTimeout)
            can_retry = (attempt < attempts
                         and (retry.retryable is None
                              or retry.retryable(exc)))
            if not can_retry:
                return (STATUS_TIMEOUT if timed_out
                        else STATUS_CALLEE_RAISED), None, \
                    attempt - first_attempt
            if retry.backoff:
                time.sleep(retry.backoff * (2.0 ** (attempt - 1)))
            attempt += 1


def _coerce_reply_words(name: str, out, want: int) -> Optional[np.ndarray]:
    """A callee's return as ``|want|`` int32 reply words (``+`` int32,
    ``-`` float32 bits; short results zero-padded, long ones truncated, a
    None or non-numeric return zeros); None when ``want == 0``."""
    if want == 0:
        return None
    nw = abs(want)
    dt = np.int32 if want > 0 else np.float32
    try:
        arr = (np.zeros((nw,), dt) if out is None
               else np.asarray(out).reshape(-1).astype(dt))
    except (TypeError, ValueError):
        warnings.warn(
            f"RPC reply from {name!r} ({type(out).__name__}) is not "
            f"coercible to {dt.__name__}; its reader sees zeros",
            RuntimeWarning, stacklevel=2)
        arr = np.zeros((nw,), dt)
    if arr.size < nw:
        arr = np.pad(arr, (0, nw - arr.size))
    return np.array(arr[:nw].view(np.int32))


# ---------------------------------------------------------------------------
# Batched transport: the drain (host side of a flush; numpy only)
# ---------------------------------------------------------------------------

def _replay_shard(callee, nargs, imask, pmask, ivals, fvals, plens, pbuf,
                  rwant, n, overrides, names, hosts, per_name_calls,
                  per_name_bytes, reply=None, base=0, idem=None,
                  retry=None, timeout=None, occ=None, carry=None,
                  abandoned=None) -> Tuple[int, int, int, int]:
    """Replay a queue's records in enqueue order; returns ``(records
    overwritten before this flush, replies dropped for a full reply arena,
    records whose callee failed after retries, retries spent)``.

    Scalars come out of the int/float lanes (Python ints and floats);
    payloads (``pmask`` bit set) are reattached from the arena through
    their descriptors as 1-D int32 or float32 arrays.  ``reply`` (``(rwords,
    roff, rlen, rstat)``, or None on a reply-less queue) collects each
    result-bearing record's return, coerced to its declared words, at the
    reply watermark, with its slot's offset, length and status.  A record
    whose reply cannot fit is dropped whole: callee not run,
    ``REPLY_OVERFLOW``.  Each callee is isolated; ``retry`` re-runs failed
    records of idempotent callees; ``timeout`` bounds each callee's wall
    time; ``base`` is the epoch's global ticket base.  The async drain
    adds ``occ`` (the occurrence indices reserved at its flush, one per
    surviving record), ``carry`` (a :class:`_CarrySink`: a failed
    idempotent record is carried into the next epoch and its slot reads
    ``PENDING``) and ``abandoned`` (a nullary callable: a drain whose
    deadline passed stops early)."""
    cap = callee.shape[0]
    lo = max(0, n - cap)
    fbuf = pbuf.view(np.float32)
    rhead = rdrops = cerrs = nretries = 0
    inj = _FAULT_INJECTOR[0] if _FAULT_INJECTOR else None
    fast = inj is None and retry is None and timeout is None
    lease = _WorkerLease() if timeout is not None else None
    # With a timeout but no injector or retry the drain pipelines the whole
    # epoch through one worker; either of those forces the ping-pong.
    pipelined = timeout is not None and inj is None and retry is None
    rsize = reply[0].shape[0] if reply is not None else 0
    # each entry: [call, j, k, name, args, want, occ_idx, is_idem, nbytes]
    inflight: List[list] = []
    ahead_words = 0    # reply words reserved by in-flight records

    def _post(j, k, name, args, want, occ_idx, is_idem, status, out, rr,
              nbytes):
        nonlocal rhead, cerrs, nretries
        nretries += rr
        if status != STATUS_OK:
            cerrs += 1
            if (carry is not None and is_idem
                    and status in (STATUS_CALLEE_RAISED, STATUS_TIMEOUT)
                    and carry.accept(name, args, int(base) + j,
                                     int(rwant[k]) if rwant is not None
                                     else 0, 1 + rr, occ_idx)):
                # redriven at the next epoch's drain; the final outcome
                # lands in the slot's outcome table
                status = STATUS_PENDING
        if reply is not None:
            rwords, roff, rlen, rstat = reply
            if want != 0 and status == STATUS_OK:
                words = _coerce_reply_words(name, out, want)
                if inj is not None:
                    words = (inj.on_reply(name, words) if occ_idx is None
                             else inj.on_reply(name, words, index=occ_idx))
                if words is None:
                    # injected reply drop: the callee ran, the reply never
                    # lands
                    status = STATUS_DROPPED
                else:
                    nw = abs(want)
                    rwords[rhead:rhead + nw] = words
                    roff[k] = rhead
                    rlen[k] = nw
                    rhead += nw
                    nbytes += 4 * nw
            rstat[k] = status
        per_name_calls[name] = per_name_calls.get(name, 0) + 1
        per_name_bytes[name] = per_name_bytes.get(name, 0) + nbytes

    def _settle_oldest():
        nonlocal ahead_words
        (call_obj, j, k, name, args, want, occ_idx, is_idem,
         nbytes) = inflight.pop(0)
        ahead_words -= abs(want)
        try:
            out = lease.collect(call_obj, timeout)
            status = STATUS_OK
        except _CalleeTimeout as exc:
            _log_callee_error(name, int(base) + j, 1, exc)
            status, out = STATUS_TIMEOUT, None
            redriven = lease.handle_timeout([r[0] for r in inflight])
            for r, c in zip(inflight, redriven):
                r[0] = c             # redriven on the replacement worker
        except Exception as exc:     # noqa: BLE001 (the isolation point)
            _log_callee_error(name, int(base) + j, 1, exc)
            status, out = STATUS_CALLEE_RAISED, None
        _post(j, k, name, args, want, occ_idx, is_idem, status, out, 0,
              nbytes)

    for j in range(lo, n):
        if abandoned is not None and abandoned():
            if inflight:
                # the worker may still run a record nobody will read
                lease.drop()
                inflight.clear()
            break
        k = j % cap
        cid = int(callee[k])
        name = names.get(cid) or _bind_callee_id(cid, names)
        if name is None:
            raise KeyError(
                f"RpcQueue record carries unknown callee id {cid}: this "
                "process never bound it")
        fn = (overrides or {}).get(name) or hosts[name]
        na = int(nargs[k])
        mask = int(imask[k])
        pm = int(pmask[k])
        args = []
        nbytes = 12 + 4 * na
        for t in range(na):
            if (pm >> t) & 1:
                off, ln = int(ivals[k, t]), int(plens[k, t])
                buf = pbuf if (mask >> t) & 1 else fbuf
                args.append(buf[off:off + ln])
                nbytes += 4 * ln
            elif (mask >> t) & 1:
                args.append(int(ivals[k, t]))
            else:
                args.append(float(fvals[k, t]))
        want = int(rwant[k]) if reply is not None else 0
        if want != 0 and rhead + ahead_words + abs(want) > rsize:
            # checked before the callee runs, so the drop is atomic; a
            # pipelined record ahead may still land its words, so settle
            # them first to learn the exact watermark
            while inflight:
                _settle_oldest()
            if rhead + abs(want) > rsize:
                rdrops += 1
                reply[3][k] = STATUS_REPLY_OVERFLOW
                continue
        occ_idx = occ[j - lo] if occ is not None else None
        is_idem = bool((idem or {}).get(name, False))
        if fast:
            try:
                out = fn(*args)
                status = STATUS_OK
            except Exception as exc:     # noqa: BLE001 (isolation point)
                _log_callee_error(name, int(base) + j, 1, exc)
                status, out = STATUS_CALLEE_RAISED, None
            _post(j, k, name, args, want, occ_idx, is_idem, status, out, 0,
                  nbytes)
        elif pipelined:
            inflight.append([lease.submit(fn, args), j, k, name, args, want,
                             occ_idx, is_idem, nbytes])
            ahead_words += abs(want)
        else:
            status, out, rr = _invoke_record(
                name, fn, args, int(base) + j, inj, retry, timeout, is_idem,
                occ_index=occ_idx, lease=lease)
            _post(j, k, name, args, want, occ_idx, is_idem, status, out, rr,
                  nbytes)
    while inflight:
        _settle_oldest()
    if lease is not None:
        lease.release()
    return lo, rdrops, cerrs, nretries


def _finish_flush(drops: int, arena_drops: int, per_name_calls,
                  per_name_bytes, reply_drops: int = 0,
                  callee_errors: int = 0, retries: int = 0):
    if drops:
        REGISTRY.bump_drops(drops)
        warnings.warn(
            f"RpcQueue flush dropped {drops} record(s): more records were "
            "enqueued than the queue capacity between flushes; the oldest "
            "were overwritten.  Flush more often or enlarge the queue.",
            RuntimeWarning, stacklevel=2)
    if arena_drops:
        warnings.warn(
            f"RpcQueue dropped {arena_drops} payload record(s) at enqueue: "
            "the payload arena was full (records dropped atomically, no "
            "partial payloads).  Flush more often or enlarge "
            "payload_capacity.", RuntimeWarning, stacklevel=2)
    if reply_drops:
        warnings.warn(
            f"RpcQueue flush dropped {reply_drops} result-bearing "
            "record(s): the reply arena was full (records dropped "
            "atomically: callee NOT run, readers see zeros).  Flush more "
            "often or enlarge reply_capacity.", RuntimeWarning,
            stacklevel=2)
    if callee_errors:
        warnings.warn(
            f"RpcQueue flush isolated {callee_errors} failing callee "
            "record(s): the callee raised or timed out, the record reads "
            "CALLEE_RAISED/TIMEOUT, and the rest of the flush completed; "
            "tracebacks in repro_torch.core.rpc.error_log().",
            RuntimeWarning, stacklevel=2)
    REGISTRY.bump_flush(drops, arena_drops, reply_drops,
                        callee_errors=callee_errors, retries=retries)
    for name, calls in per_name_calls.items():
        REGISTRY.bump(name, None, per_name_bytes[name], 0, calls=calls)


def _bind_callee_id(cid: int, names: Dict[int, str]) -> Optional[str]:
    """The registered callee whose stable id is ``cid``, bound now (into
    the registry and the drain's ``names``), or None: a record enqueued by
    another rank of a mesh names a callee that this process registered
    but never enqueued itself."""
    for name in list(REGISTRY.hosts):
        if stable_callee_id(name) == cid:
            names[cid] = name
            REGISTRY.batch_callee_id(name)
            return name
    return None


def _registry_snapshot():
    with REGISTRY.lock:                    # one snapshot, not per record
        return (dict(REGISTRY.batch_names), dict(REGISTRY.hosts),
                dict(REGISTRY.idempotent))


def _san_scan(n: int, pmask, ivals, plens, pbuf) -> Tuple[int, int, int]:
    """Check the surviving records' payload reservations (the last
    ``min(n, capacity)`` of ``n`` enqueued): canaries intact on both sides
    of every payload, no freed-block POISON word inside.  Returns
    ``(canary_stomps, poison_hits, payloads_checked)``, JAX's
    ``_san_scan_shard``'s counts, computed for all descriptors at once (a
    prefix count of POISON words answers each payload's scan)."""
    cap, w = ivals.shape
    slots = np.arange(max(0, n - cap), n) % cap
    bits = (pmask[slots][:, None] >> np.arange(w)) & 1
    off = ivals[slots][bits == 1].astype(np.int64)
    ln = plens[slots][bits == 1].astype(np.int64)
    pc = pbuf.shape[0]
    shaped = (off >= 1) & (off + ln < pc)
    off, ln = off[shaped], ln[shaped]
    # a descriptor outside [1, pc - 1) cannot hold both canaries: a stomp
    bad = ((pbuf[off - 1] != CANARY)
           | (np.take(pbuf, off + ln, mode="wrap") != CANARY))
    hits = np.concatenate([[0], np.cumsum(pbuf == POISON)])
    poisoned = hits[np.maximum(off + ln, off)] - hits[off] > 0
    return (int((~shaped).sum() + bad.sum()), int(poisoned.sum()),
            int(shaped.size))


def _san_precheck(vs: Sequence[Dict[str, np.ndarray]], rc: int,
                  sharded: bool = False) -> None:
    """The sanitizer's pass before a sanitized drain, on the queue words
    the drain holds (``vs``: the layout's views of each shard): counters
    and one epoch record for all of them (JAX's ``_san_precheck``)."""
    stomps = poisons = checked = records = declared = 0
    for v in vs:
        n, cap = int(v["head"]), v["callee"].shape[0]
        s, p, c = _san_scan(n, v["pmask"], v["ivals"], v["plens"],
                            v["pbuf"])
        stomps, poisons, checked = stomps + s, poisons + p, checked + c
        records += min(n, cap)
        if rc:
            slots = np.arange(max(0, n - cap), n) % cap
            declared += int((v["rwant"][slots] != 0).sum())
    with _SAN_LOCK:
        _SAN["canary_stomps"] += stomps
        _SAN["poison_hits"] += poisons
        _SAN["epochs"].append({
            "records": records, "declared_replies": declared,
            "canary_stomps": stomps, "poison_hits": poisons,
            "payloads_checked": checked, "sharded": sharded})


# ---------------------------------------------------------------------------
# The sync drains: records replay in (device, slot) order
# ---------------------------------------------------------------------------

#: The record lanes a drain replays, in ``_replay_shard``'s order.
_LANE_NAMES = ("callee", "nargs", "imask", "pmask", "ivals", "fvals",
               "plens", "pbuf")


def _drain(lanes, heads, overrides=None, retry=None, timeout=None) -> int:
    """Host side of a reply-less sync flush: each shard's records
    (``lanes[d]``, ``heads[d]`` = (head, phead, adrops, base); a single
    queue is one shard) replay in ``(device, slot)`` order, device 0's
    oldest surviving first, each to its registered callee (resolved at
    drain time) unless ``overrides`` maps its name to this flush's
    handler, each payload read from its own shard's arena; one flush in
    ``flush_stats``.  Returns the records enqueued."""
    pnc: Dict[str, int] = {}
    pnb: Dict[str, int] = {}
    names, hosts, idem = _registry_snapshot()
    drops = cerrs = nretries = 0
    for ln, (n, _, _, base) in zip(lanes, heads):
        sd, _, sc, sr = _replay_shard(
            *ln, None, n, overrides, names, hosts, pnc, pnb, base=base,
            idem=idem, retry=retry, timeout=timeout)
        drops, cerrs, nretries = drops + sd, cerrs + sc, nretries + sr
    _finish_flush(drops, sum(h[2] for h in heads), pnc, pnb,
                  callee_errors=cerrs, retries=nretries)
    return sum(h[0] for h in heads)


def _zero_quad(rc: int, cap: int) -> Tuple[np.ndarray, ...]:
    return (np.zeros((rc,), np.int32), np.zeros((cap,), np.int32),
            np.zeros((cap,), np.int32), np.zeros((cap,), np.int32))


def _drain_replies(lanes, rwants, heads, rc: int, overrides=None,
                   retry=None, timeout=None, shard_deadline=None
                   ) -> List[Tuple[np.ndarray, ...]]:
    """The two-phase flush (``reply_capacity > 0``): the replay of
    :func:`_drain` and each shard's reply quadruple ``(rbuf, roff, rlen,
    rstat)``: the flat int32 reply buffer, packed in replay order, and
    each ring slot's offset, length and status.  ``shard_deadline``
    drains the shards concurrently instead
    (:func:`_drain_replies_deadline`)."""
    if shard_deadline is not None:
        return _drain_replies_deadline(
            lanes, rwants, heads, rc, shard_deadline, overrides, retry,
            timeout)
    cap = lanes[0][0].shape[0]
    quads = [_zero_quad(rc, cap) for _ in lanes]
    pnc: Dict[str, int] = {}
    pnb: Dict[str, int] = {}
    names, hosts, idem = _registry_snapshot()
    drops = rdrops = cerrs = nretries = 0
    for ln, rw, (n, _, _, base), quad in zip(lanes, rwants, heads, quads):
        sd, srd, sc, sr = _replay_shard(
            *ln, rw, n, overrides, names, hosts, pnc, pnb, reply=quad,
            base=base, idem=idem, retry=retry, timeout=timeout)
        drops, rdrops = drops + sd, rdrops + srd
        cerrs, nretries = cerrs + sc, nretries + sr
    _finish_flush(drops, sum(h[2] for h in heads), pnc, pnb,
                  reply_drops=rdrops, callee_errors=cerrs, retries=nretries)
    return quads


def _split_occurrences(inj, per_dev_names) -> List[Optional[List[int]]]:
    """Occurrence indices reserved for every shard's surviving records in
    one sweep of canonical ``(device, slot)`` order, split by shard (None
    each without a reserving injector)."""
    flat = _reserve_occurrences(inj, [nm for row in per_dev_names
                                      for nm in row])
    occs: List[Optional[List[int]]] = [None] * len(per_dev_names)
    if flat is not None:
        pos = 0
        for d, row in enumerate(per_dev_names):
            occs[d] = flat[pos:pos + len(row)]
            pos += len(row)
    return occs


def _drain_replies_deadline(lanes, rwants, heads, rc: int,
                            shard_deadline: float, overrides, retry, timeout
                            ) -> List[Tuple[np.ndarray, ...]]:
    """The ``shard_deadline`` branch of a sharded two-phase flush: one
    thread a shard, all started together, sharing one wall-clock budget
    from the drain's start.  A shard done in time merges its private
    replies and counters; a late one is abandoned: its row reads
    ``STATUS_TIMEOUT``, its thread stops at its next record, and what its
    callees did stands.  Fault occurrences are reserved before any thread
    starts, in the serial drain's ``(device, slot)`` order.  The threads
    read copies of the records (a card's staging memory is reused by the
    next flush while a late thread may still run)."""
    D = len(lanes)
    lanes = [tuple(np.array(a) for a in ln) for ln in lanes]
    rwants = [np.array(r) for r in rwants]
    cap = lanes[0][0].shape[0]
    names, hosts, idem = _registry_snapshot()
    inj = _FAULT_INJECTOR[0] if _FAULT_INJECTOR else None
    occs = _split_occurrences(inj, [
        _surviving_names(lanes[d][0], names, heads[d][0]) for d in range(D)])
    shard_out = [_zero_quad(rc, cap) for _ in range(D)]
    quads = [_zero_quad(rc, cap) for _ in range(D)]
    results: List[Any] = [None] * D
    done = [threading.Event() for _ in range(D)]
    timed_out = [False] * D

    def run(d: int) -> None:
        pnc: Dict[str, int] = {}
        pnb: Dict[str, int] = {}
        try:
            counters = _replay_shard(
                *lanes[d], rwants[d], heads[d][0], overrides, names, hosts,
                pnc, pnb, reply=shard_out[d], base=heads[d][3], idem=idem,
                retry=retry, timeout=timeout, occ=occs[d],
                abandoned=(lambda: timed_out[d]))
            results[d] = (counters, pnc, pnb)
        except BaseException as exc:  # noqa: BLE001 (relayed below)
            results[d] = exc
        finally:
            done[d].set()

    for d in range(D):
        threading.Thread(target=run, args=(d,), daemon=True,
                         name=f"rpc-shard-drain-{d}").start()
    t0 = time.monotonic()
    drops = rdrops = cerrs = nretries = stalled = 0
    pnc_all: Dict[str, int] = {}
    pnb_all: Dict[str, int] = {}
    for d in range(D):
        remaining = shard_deadline - (time.monotonic() - t0)
        if done[d].wait(max(0.0, remaining)):
            res = results[d]
            if isinstance(res, BaseException):
                raise res
            (sd, srd, sc, sr), pnc, pnb = res
            quads[d] = shard_out[d]
            drops, rdrops = drops + sd, rdrops + srd
            cerrs, nretries = cerrs + sc, nretries + sr
            for nm, c in pnc.items():
                pnc_all[nm] = pnc_all.get(nm, 0) + c
                pnb_all[nm] = pnb_all.get(nm, 0) + pnb[nm]
        else:
            # partial-epoch completion: only this shard's records fail;
            # its private arrays are never merged (the late thread may
            # still write them) and its whole row reads TIMEOUT
            timed_out[d] = True
            stalled += 1
            quads[d][3][:] = STATUS_TIMEOUT
            cerrs += min(heads[d][0], cap)
    if stalled:
        warnings.warn(
            f"RpcQueue sharded flush abandoned {stalled} shard(s) past the "
            f"{shard_deadline}s per-shard drain deadline: their records "
            "read STATUS_TIMEOUT while sibling shards completed "
            "(partial-epoch completion).", RuntimeWarning, stacklevel=2)
    _finish_flush(drops, sum(h[2] for h in heads), pnc_all, pnb_all,
                  reply_drops=rdrops, callee_errors=cerrs, retries=nretries)
    return quads


# ---------------------------------------------------------------------------
# Async transport: double-buffered epochs and the cross-epoch carry
# ---------------------------------------------------------------------------
#
# An async flush submits the closing epoch's drain to its queue's slot (a
# single-thread executor: one queue's drains run FIFO, while the device
# computes) and installs the PREVIOUS epoch's replies, so replies land one
# epoch late and the submitted epoch's tickets read STATUS_PENDING.  A
# failing idempotent record of a queue with ``carry_budget`` is carried:
# redriven at the head of each later drain, oldest first, one attempt a
# round, until it succeeds or the budget runs out, and finalized into the
# slot's outcome table that the host reads fold in.

def _reserve_occurrences(inj, names_in_order):
    """Reserve per-callee occurrence indices for an async drain, in its
    replay order; None without an injector or one without ``reserve``."""
    if inj is None or not names_in_order:
        return None
    reserve = getattr(inj, "reserve", None)
    if reserve is None:
        return None
    return list(reserve(names_in_order))


def _surviving_names(callee_row, names, n: int) -> List[Optional[str]]:
    """Callee names of an epoch's surviving records, in replay order."""
    cap = callee_row.shape[0]
    lo = max(0, n - cap)
    return [names.get(int(callee_row[j % cap])) for j in range(lo, n)]


class _CarryRec:
    """One record carried across epochs: its arguments (copied out of the
    epoch's arena), global ticket, reply declaration, the attempts spent,
    its reserved occurrence index and the carry rounds left."""

    __slots__ = ("name", "args", "ticket", "want", "attempts_done",
                 "occ_index", "tries_left")

    def __init__(self, name, args, ticket, want, attempts_done, occ_index,
                 tries_left):
        self.name = name
        self.args = [np.array(a) if isinstance(a, np.ndarray) else a
                     for a in args]
        self.ticket = int(ticket)
        self.want = int(want)
        self.attempts_done = int(attempts_done)
        self.occ_index = occ_index
        self.tries_left = int(tries_left)


class _CarrySink:
    """The records of one drain that failed and may carry into the next
    epoch (idempotent callees, ``carry_budget > 0``)."""

    def __init__(self, budget: int):
        self.budget = int(budget)
        self.records: List[_CarryRec] = []

    def accept(self, name, args, ticket, want, attempts_done, occ_index
               ) -> bool:
        if self.budget <= 0:
            return False
        self.records.append(_CarryRec(name, args, ticket, want,
                                      attempts_done, occ_index, self.budget))
        return True


#: Finalized carry outcomes kept per queue slot for host reads.
_OUTCOME_CAP = 4096


class _EpochJob:
    """One submitted epoch drain: its reply quadruple once drained, the
    carried depth after it, and a done event.  ``abandoned`` turns true
    when the collect's deadline passed (set here by a CPU queue, read from
    the device's flag through ``probe`` on a card): the late drain stops
    early and carries nothing."""

    __slots__ = ("base", "out", "cdepth", "done", "_abandoned", "probe")

    def __init__(self, base: int, probe: Optional[Callable[[], bool]] = None):
        self.base = int(base)
        self.out = None
        self.cdepth = 0
        self.done = threading.Event()
        self._abandoned = False
        self.probe = probe

    @property
    def abandoned(self) -> bool:
        return self._abandoned or (self.probe is not None and self.probe())

    @abandoned.setter
    def abandoned(self, value: bool) -> None:
        self._abandoned = bool(value)


class _QueueSlot:
    """Host-side state of one async queue: its single-thread executor
    (the FIFO epoch sequence that makes drains replayable), the epochs
    in flight, the carry list, the finalized carry outcomes and, on a
    card, the queue's :class:`~repro_torch.kernels.rpc_async.AsyncRing`
    and the queue's row in it (whose live carried-depth word mirrors the
    carry list)."""

    def __init__(self, sid: int):
        self.id = sid
        self.lock = threading.Lock()
        self.executor: Optional[ThreadPoolExecutor] = None
        self.pending: deque = deque()
        self.carry: List[_CarryRec] = []
        self.outcomes: Dict[int, Tuple[int, Optional[np.ndarray]]] = {}
        self.ring, self.row = None, 0
        self.ctxs: Dict[int, "_FlushCtx"] = {}   # a card's flushes, by epoch

    def submit(self, job: _EpochJob, runner: Callable
               ) -> Optional[_EpochJob]:
        """Queue ``runner`` on the executor; returns the epoch job it runs
        behind (the previous uncollected one, if any)."""
        with self.lock:
            if self.executor is None:
                self.executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=f"rpc-async-{self.id}")
            if self.ring is not None:
                # a card's collects run on the device: forget what is done
                while self.pending and self.pending[0].done.is_set():
                    self.pending.popleft()
            prev = self.pending[-1] if self.pending else None
            self.pending.append(job)
            ex = self.executor
        ex.submit(runner)
        return prev

    def collect(self, prev: Optional[_EpochJob], deadline: Optional[float],
                cap: int, rc: int) -> Tuple[Tuple[np.ndarray, ...], int]:
        """Wait for the previous epoch's drain and return its reply
        quadruple and the carried depth; zeros (and depth 0) at the first
        flush.  Past
        ``deadline`` the job is abandoned and a TIMEOUT-stamped window
        returned (never the job's arrays, which may still be written)."""
        zeros = (np.zeros((rc,), np.int32), np.zeros((cap,), np.int32),
                 np.zeros((cap,), np.int32), np.zeros((cap,), np.int32))
        if prev is None:
            # the first flush: nothing has been drained, so nothing is
            # carried (read before this epoch's drain can carry any)
            return zeros, 0
        ok = prev.done.wait(deadline) if deadline is not None else (
            prev.done.wait() or True)
        with self.lock:
            if self.pending and self.pending[0] is prev:
                self.pending.popleft()
            cd = prev.cdepth if ok else len(self.carry)
        if not ok:
            prev.abandoned = True
            return (zeros[0], zeros[1], zeros[2],
                    np.full((cap,), STATUS_TIMEOUT, np.int32)), cd
        return (prev.out if prev.out is not None else zeros), cd

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted drain has finished; False on
        ``timeout``.  Installs nothing: the next flush does.  Raises what
        a card's ingest thread caught handing an epoch over (the epoch
        was answered with zeros)."""
        t0 = time.monotonic()
        if self.ring is not None:
            ingested = self.ring.wait_ingested(timeout)
            err, self.ring.error = self.ring.error, None
            if err is not None:
                raise RuntimeError(f"async RpcQueue hand-off failed: "
                                   f"{err!r}") from err
            if not ingested:
                return False
        with self.lock:
            jobs = list(self.pending)
        for j in jobs:
            left = (None if timeout is None
                    else max(0.0, timeout - (time.monotonic() - t0)))
            if not j.done.wait(left):
                return False
        return True

    def take_carry(self) -> List[_CarryRec]:
        with self.lock:
            recs, self.carry = self.carry, []
            self._mirror_depth()
            return recs

    def put_carry(self, recs: List[_CarryRec]) -> None:
        if not recs:
            return
        with self.lock:
            self.carry.extend(recs)
            self._mirror_depth()

    def _mirror_depth(self) -> None:
        if self.ring is not None:
            self.ring.live[self.row] = len(self.carry)

    def finalize(self, ticket: int, status: int,
                 words: Optional[np.ndarray]) -> None:
        with self.lock:
            self.outcomes[ticket] = (int(status), words)
            while len(self.outcomes) > _OUTCOME_CAP:
                self.outcomes.pop(next(iter(self.outcomes)))

    def carried_tickets(self) -> List[int]:
        with self.lock:
            return [r.ticket for r in self.carry]


_SLOTS: Dict[int, _QueueSlot] = {}
_SLOT_LOCK = threading.Lock()
_SLOT_IDS = itertools.count()


def _new_slot() -> int:
    with _SLOT_LOCK:
        sid = next(_SLOT_IDS)
        _SLOTS[sid] = _QueueSlot(sid)
        return sid


def _slot(sid: int) -> _QueueSlot:
    with _SLOT_LOCK:
        return _SLOTS[sid]


def _replay_carry(slot: _QueueSlot, hosts, idem, overrides, timeout
                  ) -> Tuple[int, int]:
    """Redrive the records carried into this drain, oldest first, one
    attempt each.  A success (or a spent budget, or an injected reply
    drop) finalizes into the outcome table; a failure with budget left
    carries on.  Returns ``(callee errors, records finalized)``."""
    recs = slot.take_carry()
    if not recs:
        return 0, 0
    inj = _FAULT_INJECTOR[0] if _FAULT_INJECTOR else None
    cerrs = finalized = 0
    survivors: List[_CarryRec] = []
    for rec in recs:
        fn = (overrides or {}).get(rec.name) or hosts.get(rec.name)
        if fn is None:
            slot.finalize(rec.ticket, STATUS_CALLEE_RAISED, None)
            finalized += 1
            continue
        status, out, _ = _invoke_record(
            rec.name, fn, rec.args, rec.ticket, inj, None, timeout,
            bool((idem or {}).get(rec.name, False)),
            first_attempt=rec.attempts_done + 1, occ_index=rec.occ_index)
        if status == STATUS_OK:
            words = _coerce_reply_words(rec.name, out, rec.want)
            if inj is not None and words is not None:
                words = (inj.on_reply(rec.name, words)
                         if rec.occ_index is None
                         else inj.on_reply(rec.name, words,
                                           index=rec.occ_index))
                if words is None:
                    status = STATUS_DROPPED
            slot.finalize(rec.ticket, status, words)
            finalized += 1
            continue
        cerrs += 1
        rec.attempts_done += 1
        rec.tries_left -= 1
        if rec.tries_left <= 0:
            slot.finalize(rec.ticket, status, None)
            finalized += 1
        else:
            survivors.append(rec)
    slot.put_carry(survivors)
    return cerrs, finalized


def _run_async_epoch(slot: _QueueSlot, job: _EpochJob, arrs, rwant, n: int,
                     adrops: int, base: int, rc: int, cap: int,
                     carry_budget: int, occ, ctx: _FlushCtx,
                     on_done: Optional[Callable[[_EpochJob], None]] = None
                     ) -> None:
    """The background body of one epoch's drain, on the slot's executor
    (strictly after the previous epoch's): carried redrives first, then
    the epoch's records, into a reply quadruple published on the job
    (and through ``on_done`` to a card's ring)."""
    callee, nargs, imask, pmask, ivals, fvals, plens, pbuf = arrs
    pnc: Dict[str, int] = {}
    pnb: Dict[str, int] = {}
    try:
        names, hosts, idem = _registry_snapshot()
        ccerrs, _ = _replay_carry(slot, hosts, idem, ctx.handlers,
                                  ctx.timeout)
        reply = None
        if rc:
            reply = (np.zeros((rc,), np.int32), np.zeros((cap,), np.int32),
                     np.zeros((cap,), np.int32), np.zeros((cap,), np.int32))
        sink = (_CarrySink(carry_budget)
                if (carry_budget and rc and not job.abandoned) else None)
        drops, rdrops, cerrs, nretries = _replay_shard(
            callee, nargs, imask, pmask, ivals, fvals, plens, pbuf,
            rwant, n, ctx.handlers, names, hosts, pnc, pnb, reply=reply,
            base=base, idem=idem, retry=ctx.retry, timeout=ctx.timeout,
            occ=occ, carry=sink, abandoned=(lambda: job.abandoned))
        if sink is not None and not job.abandoned:
            slot.put_carry(sink.records)
        job.out = reply
        _finish_flush(drops, adrops, pnc, pnb, reply_drops=rdrops,
                      callee_errors=cerrs + ccerrs, retries=nretries)
    except BaseException as exc:  # noqa: BLE001 (background isolation)
        _log_callee_error("<async-drain>", base, 1, exc)
        warnings.warn(
            f"async RpcQueue drain failed wholesale: {exc!r} (traceback in "
            "repro_torch.core.rpc.error_log(); the epoch's records read "
            "status 0/zeros)", RuntimeWarning, stacklevel=2)
    finally:
        with slot.lock:
            job.cdepth = len(slot.carry)
        if on_done is not None:
            on_done(job)
        job.done.set()


def _reserve_epochs(layout: "_Layout", srcs: Sequence[np.ndarray]
                    ) -> List[Optional[List[int]]]:
    """The fault occurrences of the epochs whose queue words are
    ``srcs`` (one a shard), reserved at their flush in one sweep of
    ``(device, slot)`` order."""
    names, _, _ = _registry_snapshot()
    inj = _FAULT_INJECTOR[0] if _FAULT_INJECTOR else None
    views = [layout.views(src) for src in srcs]
    return _split_occurrences(inj, [
        _surviving_names(v["callee"], names, int(v["head"]))
        for v in views])


def _install_epoch(state: torch.Tensor, layout: "_Layout",
                   words: torch.Tensor) -> None:
    """The device side of a host-collected async flush: the windows move
    (``rpc_async_post``) and each row's reply words (``words``, a row a
    row of ``state``) are installed (``rpc_async_collect``).  A CPU queue
    goes through the two ops, whose CPU kernels are the plain versions; a
    card queue's host twin (``RpcQueue.flush_reference``) calls the plain
    versions themselves, which the kernels are held against."""
    L, rc = layout, layout.reply_capacity
    if state.device.type == "cpu":
        async_post(state, 0, 0, L.out_start, bool(rc))
        async_collect(state, 0, 0, L.out_start, L.rslots, rc, None, words)
    else:
        post_plain(state, L.out_start, bool(rc))
        collect_plain(state, L.out_start, words)


def _submit_epoch(slot: _QueueSlot, layout: "_Layout", src: np.ndarray,
                  ctx: _FlushCtx, carry_budget: int, occ, probe=None,
                  on_done=None) -> Optional[_EpochJob]:
    """Submit the epoch whose queue words ``[0, in_end)`` are ``src`` (a
    copy the drain owns), with its fault occurrences ``occ`` reserved at
    its flush (:func:`_reserve_epochs`).  Returns the job it runs
    behind."""
    v = layout.views(src)
    arrs = tuple(v[k] for k in _LANE_NAMES)
    rc = layout.reply_capacity
    n, adrops, base = int(v["head"]), int(v["adrops"]), int(v["base"])
    if ctx.sanitize:
        _san_precheck([v], rc)
    job = _EpochJob(base, probe)
    runner = (lambda: _run_async_epoch(
        slot, job, arrs, v["rwant"] if rc else None, n, adrops, base, rc,
        layout.capacity, carry_budget if rc else 0, occ, ctx, on_done))
    return slot.submit(job, runner)


def _async_ring(device: torch.device, layout: "_Layout", sids: Sequence[int],
                carry_budget: int) -> AsyncRing:
    """The mapped ring of an async queue on a card, a row for each shard
    whose slot is in ``sids`` (one for a single queue), made at the first
    flush.  Each posted epoch is handed over from the ring's ingest
    thread, in flush order: the fault occurrences of all its rows
    reserved in one ``(device, slot)`` sweep, then each row's drain
    submitted to its shard's slot, answering into its row.  It holds the
    slots, not the queue, so the thread keeps no queue alive; the flush
    puts its context in the first slot's ``ctxs``."""
    L, rc = layout, layout.reply_capacity
    slots = [_slot(sid) for sid in sids]

    def on_posted(epoch: int, words: np.ndarray) -> None:
        ring = slots[0].ring
        with slots[0].lock:
            ctx = slots[0].ctxs.pop(epoch)
        occs = _reserve_epochs(L, list(words))
        for d, slot in enumerate(slots):
            def on_done(job: _EpochJob, d=d) -> None:
                quad = job.out if job.out is not None else (
                    np.zeros((rc,), np.int32),
                    *(np.zeros((L.rslots,), np.int32) for _ in range(3)))
                ring.complete(epoch, _reply_words(quad, job.cdepth, rc), d)

            _submit_epoch(slot, L, words[d], ctx, carry_budget, occs[d],
                          probe=lambda d=d: ring.abandoned(epoch, d),
                          on_done=on_done)

    ring = AsyncRing(device, L.in_end, L.words - L.out_start - H_CDEPTH,
                     on_posted, rows=len(slots))
    for d, slot in enumerate(slots):
        with slot.lock:
            slot.ring, slot.row = ring, d
            slot._mirror_depth()
    return ring


def _launch_flush(queue, ring: AsyncRing, epoch: int, direct: bool,
                  deadline: Optional[float]) -> None:
    """Epoch ``epoch``'s two launches for ``queue`` (an async
    :class:`RpcQueue` or :class:`ShardedRpcQueue` on a card, or one given
    a card's launch, ``direct``) through ``ring``: in eager mode one C
    call through the queue's flush plan, made here at its first flush;
    else the two ops, which ``torch.export``, the walker and op counters
    see.  ``deadline`` is read at every flush."""
    L = queue.layout
    rc = L.reply_capacity
    if direct and _eager():
        if queue._async_plan is None:
            queue._async_plan = AsyncFlushPlan(
                ring, queue.state, L.out_start, bool(rc), L.rslots, rc)
        queue._async_plan.run(epoch, deadline)
    else:
        async_post(queue.state, ring.id, epoch, L.out_start, bool(rc))
        async_collect(queue.state, ring.id, epoch, L.out_start, L.rslots, rc,
                      deadline)


# ---------------------------------------------------------------------------
# Batched transport: the queue
# ---------------------------------------------------------------------------

def _wrap_i32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where each field of a queue lives in its one int32 state buffer.
    A flush ships ``[0, in_end)`` to the host (the records, the arena, the
    heads and the reply window) and receives ``[out_start, words)`` (the
    heads, the window and the replies), each in one copy."""
    capacity: int
    width: int
    payload_capacity: int
    reply_capacity: int

    @property
    def rslots(self) -> int:
        return self.capacity if self.reply_capacity else 0

    def offsets(self) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
        return _layout_offsets(self)

    @property
    def in_end(self) -> int:
        return self.offsets()["rbase"][0] + len(_WINDOW)

    @property
    def out_start(self) -> int:
        return self.offsets()["head"][0]

    @property
    def words(self) -> int:
        return self.offsets()["words"][0]

    @property
    def lanes(self) -> Tuple[int, ...]:
        """The ``geometry`` argument of the ``rpc_enqueue`` op."""
        return _lane_words(self)

    def views(self, buf, base: int = 0) -> Dict[str, Any]:
        """Each field held in ``buf`` as a view (``buf`` a torch tensor or
        a numpy array holding the layout's words from ``base`` on);
        ``fvals`` as float32."""
        out = {}
        for name, (at, shape) in self.offsets().items():
            n = int(np.prod(shape, dtype=np.int64))
            if name == "words" or at < base or at + n > base + len(buf):
                continue
            v = buf[at - base:at - base + n]
            if name == "fvals":
                v = v.view(torch.float32 if isinstance(v, torch.Tensor)
                           else np.float32)
            out[name] = v.reshape(shape)
        return out


@functools.lru_cache(maxsize=None)
def _layout_offsets(layout: "_Layout"
                    ) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    N, W = layout.capacity, layout.width
    rslots = layout.rslots
    fields = [("callee", (N,)), ("nargs", (N,)), ("imask", (N,)),
              ("pmask", (N,)), ("ivals", (N, W)), ("fvals", (N, W)),
              ("plens", (N, W)), ("rwant", (rslots,)),
              ("pbuf", (layout.payload_capacity,))]
    fields += [(n, ()) for n in _HEADS + _WINDOW]
    fields += [("roff", (rslots,)), ("rlen", (rslots,)),
               ("rstat", (rslots,)), ("rbuf", (layout.reply_capacity,))]
    out, at = {}, 0
    for name, shape in fields:
        out[name] = (at, shape)
        at += int(np.prod(shape, dtype=np.int64))
    out["words"] = (at, ())
    return out


@functools.lru_cache(maxsize=None)
def _lane_words(layout: "_Layout") -> Tuple[int, ...]:
    return tuple(lane_geometry(layout.capacity, layout.width,
                               layout.payload_capacity, layout.rslots,
                               {k: at for k, (at, _) in
                                _layout_offsets(layout).items()}))


#: The heads a flush reads and resets, and the reply window it stamps.
_HEADS = ("head", "phead", "adrops", "base")
_WINDOW = ("rbase", "rcount", "fonce", "pbase", "pcount", "cdepth")
# the async kernels and their plain versions address the words from
# ``head`` on in this order (``kernels/rpc_async/ref.py``)
assert (_HEADS + _WINDOW).index("cdepth") == H_CDEPTH


class _FlushCtx:
    """One flush's handlers, fault policy, sanitizer flag and (a sharded
    sync flush) shard deadline, for its drain."""
    __slots__ = ("handlers", "retry", "timeout", "sanitize",
                 "shard_deadline")

    def __init__(self, handlers, retry, timeout, sanitize=False,
                 shard_deadline=None):
        self.handlers, self.retry, self.timeout = handlers, retry, timeout
        self.sanitize = sanitize
        self.shard_deadline = shard_deadline


def _serve_flush(layout: _Layout, ctx: _FlushCtx,
                 srcs: Sequence[np.ndarray], dsts: Sequence[np.ndarray],
                 sharded: bool = False) -> None:
    """The landing pad of a sync flush: drain the records of each shard's
    ``srcs[d]`` (the layout's ``[0, in_end)``; a single queue is one
    shard) in ``(device, slot)`` order, and write each shard's reset
    heads, reply window and replies into its ``dsts[d]`` (``[out_start,
    words)``)."""
    vs = [layout.views(src) for src in srcs]
    os_ = [layout.views(dst, layout.out_start) for dst in dsts]
    rc = layout.reply_capacity
    if ctx.sanitize:
        _san_precheck(vs, rc, sharded)
    lanes = [tuple(v[k] for k in _LANE_NAMES) for v in vs]
    heads = [tuple(int(v[n]) for n in _HEADS) for v in vs]
    for v, o in zip(vs, os_):
        for name in _WINDOW:
            o[name][...] = v[name]
    if rc:
        quads = _drain_replies(
            lanes, [v["rwant"] for v in vs], heads, rc,
            overrides=ctx.handlers, retry=ctx.retry, timeout=ctx.timeout,
            shard_deadline=ctx.shard_deadline)
        for o, quad, (head, _, _, base) in zip(os_, quads, heads):
            for name, arr in zip(("rbuf", "roff", "rlen", "rstat"), quad):
                o[name][...] = arr
            o["rbase"][...] = base
            o["rcount"][...] = head
    else:
        _drain(lanes, heads, overrides=ctx.handlers, retry=ctx.retry,
               timeout=ctx.timeout)
    for o, (head, _, _, base) in zip(os_, heads):
        o["head"][...] = 0
        o["phead"][...] = 0
        o["adrops"][...] = 0
        o["base"][...] = _wrap_i32(base + head)
        o["fonce"][...] = 1


#: Flush contexts posted on a channel, by the id their record carries.
_FLUSHES: Dict[int, _FlushCtx] = {}
_FLUSH_IDS = itertools.count(1)
_FLUSH_LOCK = threading.Lock()


def _post_flush(ctx: _FlushCtx) -> int:
    """The id under which a flush's context waits for its drain (the
    record's first scalar word)."""
    with _FLUSH_LOCK:
        fid = next(_FLUSH_IDS) % (1 << 32)
        _FLUSHES[fid] = ctx
    return fid


def _queue_staging(channel, layout: _Layout) -> Tuple[int, Staging]:
    """``(staging id, region)`` of ``channel`` for queues of ``layout``'s
    geometry (one for all of them: a channel's round trips are serial),
    made at the first flush; its ``serve`` drains the flush whose id the
    record's first scalar word carries."""
    def make():
        staging = channel.new_staging([4 * layout.in_end,
                                       4 * (layout.words - layout.out_start)])
        src = staging.slot(0).view(np.int32)
        dst = staging.slot(1).view(np.int32)

        def serve():
            fid = int(staging.word(0).view(np.uint32)[0])
            with _FLUSH_LOCK:
                ctx = _FLUSHES.pop(fid)
            _serve_flush(layout, ctx, [src], [dst])

        return staging, serve

    return channel.stagings.get(("queue", layout), make)


def _sharded_staging(channel, layout: _Layout, D: int
                     ) -> Tuple[int, Staging]:
    """:func:`_queue_staging` for ``D`` stacked shards of ``layout``: a
    slot for each shard's ``[0, in_end)`` and one for each shard's words
    from ``out_start`` on; its ``serve`` drains the sharded flush whose id
    the record carries."""
    def make():
        staging = channel.new_staging(
            [4 * layout.in_end] * D
            + [4 * (layout.words - layout.out_start)] * D)
        srcs = [staging.slot(d).view(np.int32) for d in range(D)]
        dsts = [staging.slot(D + d).view(np.int32) for d in range(D)]

        def serve():
            fid = int(staging.word(0).view(np.uint32)[0])
            with _FLUSH_LOCK:
                ctx = _FLUSHES.pop(fid)
            _serve_flush(layout, ctx, srcs, dsts, sharded=True)

        return staging, serve

    return channel.stagings.get(("sharded", layout, D), make)


def _reply_words(quad, cdepth: int, rc: int) -> np.ndarray:
    """A drain's reply quadruple ``(rbuf, roff, rlen, rstat)`` and the
    carried depth as the queue's words from ``cdepth`` on."""
    if not rc:
        return np.array([cdepth], np.int32)
    rbuf, roff, rlen, rstat = quad
    return np.concatenate([np.array([cdepth], np.int32), roff, rlen, rstat,
                           rbuf]).astype(np.int32)


def _decode_words(words: np.ndarray, np_dtype) -> np.ndarray:
    """Reply words (int32) as ``np_dtype`` (float replies travel as
    float32 bits)."""
    if np.issubdtype(np_dtype, np.floating):
        return words.view(np.float32).astype(np_dtype)
    return words.astype(np_dtype)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def _is_int_dtype(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex)


_F32, _U32 = struct.Struct("<f"), struct.Struct("<I")


def _immediate(a) -> Tuple[bool, int]:
    """A Python or numpy number as a lane value known to the host: whether
    it rides the int lane (integers and bools) and its 32 bits in JAX's
    dtype for it (x64 off).  A Python bool, an int in int32's range and a
    float go without numpy: the float's C cast to float32, which is
    numpy's (past float32's range numpy's inf is taken)."""
    tp = type(a)
    if tp is int and -0x80000000 <= a <= 0x7FFFFFFF:
        return True, a & 0xFFFFFFFF
    if tp is bool:
        return True, int(a)
    if tp is float:
        try:
            return False, _U32.unpack(_F32.pack(a))[0]
        except OverflowError:
            pass
    v = _scalar(a)
    is_int = v.dtype.kind in "biu"
    bits = np.asarray(v, np.int32 if is_int else np.float32).view(np.uint32)
    return is_int, int(bits)


def _classify(name: str, j: int, a, dev: torch.device):
    """Argument ``j`` of an enqueue of ``name`` as ``(tag, value)``: its
    part of an enqueue plan's key, ``(kind, is_int[, dtype[, length]])``,
    and what the record holds of it.  A Python or numpy number (or a 0-d
    tensor on another device, its ``item()``) is an immediate, its word;
    a 0-d tensor on ``dev`` is read there; an array is a payload, flat and
    contiguous on ``dev``.  :meth:`RpcQueue.record` and a plan's key both
    come from here."""
    if isinstance(a, (int, float, np.generic)):         # a bool is an int
        is_int, word = _immediate(a)
        return (IMMEDIATE, is_int), word
    if isinstance(a, torch.Tensor):
        t = a.detach() if a.requires_grad else a
    else:
        t = torch.as_tensor(np.asarray(a))
    dt = t.dtype
    if dt.is_complex:
        raise TypeError(f"RPC record arg {j} for {name!r}: complex "
                        f"dtype {dt}")
    if t.dim() == 0:
        if t.device != dev:
            is_int, word = _immediate(t.item())
            return (IMMEDIATE, is_int), word
        return (DEVICE, _is_int_dtype(dt), dt), t
    if t.dim() != 1 or t.device != dev or not t.is_contiguous():
        t = t.to(dev).contiguous().reshape(-1)
    return (PAYLOAD, _is_int_dtype(dt), dt, t.shape[0]), t


def _where(where, dev: torch.device):
    """``where`` as a record holds it: None, a Python bool, or a 0-d bool
    tensor on ``dev``."""
    if isinstance(where, torch.Tensor):
        if where.dim() != 0:
            raise ValueError("where must be a scalar")
        if where.dtype is not torch.bool or where.device != dev:
            where = where.detach().to(device=dev, dtype=torch.bool)
        return where
    return None if where is None else bool(where)


def _call_signature(name: str, args, where, dev: torch.device):
    """One enqueue's arguments and ``where`` classified as a record takes
    them (:func:`_classify`, :func:`_where`): ``(tags, values, mode,
    where)``, ``mode`` 0 for no ``where``, 1 a constant, 2 a tensor."""
    tags, values = [], []
    for j, a in enumerate(args):
        tag, v = _classify(name, j, a, dev)
        tags.append(tag)
        values.append(v)
    where = _where(where, dev)
    mode = 0 if where is None else 1 if type(where) is bool else 2
    return tuple(tags), values, mode, where


def _eager() -> bool:
    """Whether an enqueue or an async flush may launch directly: no
    ``torch.export``, dynamo or compile traces, and no dispatch mode (fake
    tensors, a proxy, an op counter) or function mode would see the op.  A
    ``DeviceContext`` (``with torch.device(...)``, ``set_default_device``)
    only sets factory calls' default device, so it does not count."""
    if (torch._C._len_torch_dispatch_stack()
            or torch.compiler.is_compiling()
            or torch.compiler.is_exporting()):
        return False
    if torch._C._is_torch_function_mode_enabled():
        return all(type(torch._C._get_function_stack_at(i)) is _DeviceContext
                   for i in range(torch._C._len_torch_function_stack()))
    return True


class RpcQueue:
    """A ring of pending RPC records on one device (the batched transport).

    Each record is ``(callee id, up to W args)``: scalar integer and bool
    args in int32 lanes, scalar floats in float32 lanes, ``imask`` bit j
    saying which lane argument j used; array args ride the payload arena
    ``pbuf`` (one watermark bump reserves all of a record's payloads at
    static prefix offsets) with descriptors in their lanes (offset in
    ``ivals``, length in ``plens``, presence in ``pmask`` bit j, int vs
    float32 words in ``imask`` bit j).  The oldest records are overwritten
    past ``capacity``; a record whose payloads do not fit is dropped
    atomically (``adrops``).  With ``reply_capacity > 0`` a flush also
    brings back each ticketed record's reply (``rwant`` declares it,
    ``rbuf``/``roff``/``rlen``/``rstat`` hold the last flush's replies and
    statuses); tickets are global sequence numbers (``base`` + the order
    within the epoch) and the reply table answers only tickets in its
    ``(rbase, rcount)`` window.

    The fields are JAX's, as views of one int32 state buffer on the
    queue's device (``fvals`` a float32 view), so a flush moves the state
    in one copy each way.  Deliberately unlike JAX's value semantics the
    tensors are updated in place, and ``enqueue`` and ``flush`` return the
    queue itself.

    ``mode="async"`` double-buffers the epochs: a flush submits the
    closing epoch's drain to the queue's slot and installs the previous
    epoch's replies, so the reply window trails one epoch, ``pbase`` and
    ``pcount`` hold the submitted epoch (its tickets read
    ``STATUS_PENDING``) and ``cdepth`` the carried-record depth that
    ``pressure()`` counts.  A sync queue keeps the three at 0."""

    def __init__(self, layout: _Layout, state: torch.Tensor,
                 retry: Optional[RetryPolicy] = None,
                 timeout: Optional[float] = None, mode: str = "sync",
                 carry_budget: int = 0,
                 shard_deadline: Optional[float] = None,
                 sanitize: bool = False):
        self.layout, self.state = layout, state
        self.sanitize = bool(sanitize)
        self.retry, self.timeout = retry, timeout
        self.mode, self.carry_budget = mode, int(carry_budget)
        self.shard_deadline = shard_deadline
        self.qslot = _new_slot() if mode == "async" else None
        self.arrivals = torch.zeros(1, dtype=torch.int32,
                                    device=state.device)
        for name, view in layout.views(state).items():
            setattr(self, name, view)
        # a card queue's launches (its lanes packed once) and enqueue plans,
        # by signature (see _enqueue_direct)
        self._dev = state.device
        self._direct = state.is_cuda and type(state) is torch.Tensor
        self._launch = QueueLaunch(state, layout.lanes, self.arrivals) \
            if self._direct else None
        self._plans: Dict[Tuple, EnqueuePlan] = {}
        # an async card queue's flush plan, made at its first flush
        self._async_plan: Optional[AsyncFlushPlan] = None
        self._failed_read_warned = False
        # on a ShardedRpcQueue's shard: (a weak reference to that queue,
        # the row, the number of rows)
        self._owner: Optional[Tuple[Any, int, int]] = None

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def capacity(self) -> int:
        return self.layout.capacity

    @property
    def width(self) -> int:
        return self.layout.width

    @property
    def payload_capacity(self) -> int:
        return self.layout.payload_capacity

    @property
    def reply_capacity(self) -> int:
        return self.layout.reply_capacity

    @staticmethod
    def create(capacity: int = 1024, width: int = 4,
               payload_capacity: int = 1024, reply_capacity: int = 0,
               sanitize: bool = False,
               retry: Optional[RetryPolicy] = None,
               timeout: Optional[float] = None, mode: str = "sync",
               carry_budget: int = 0,
               shard_deadline: Optional[float] = None, *,
               device="cuda") -> "RpcQueue":
        """A queue of ``capacity`` records of ``width`` args, a
        ``payload_capacity``-word arena (0: scalar-only) and a
        ``reply_capacity``-word reply arena (0: fire-and-forget), on
        ``device`` (the card unless the caller asks for the CPU).
        ``retry`` re-runs failing records of ``idempotent`` callees at the
        drain; ``timeout`` (seconds) bounds every callee's wall time
        (overrun: ``STATUS_TIMEOUT``, the drain goes on).

        ``mode="async"`` double-buffers the epochs: a flush submits the
        closing epoch's drain and installs the previous epoch's replies
        (see the class docstring).  ``carry_budget`` (async, reply-carrying
        queues) gives failed idempotent records that many more rounds,
        one a later drain; ``shard_deadline`` (seconds; async here) bounds
        the collect's wait for the previous drain, past which the window
        reads ``STATUS_TIMEOUT`` and the late drain carries nothing.

        ``sanitize=True`` turns on the sanitizer (see the module
        docstring): 2 more arena words a payload; deliveries, replies and
        statuses are bit-equal to an unsanitized queue's while nothing
        stomps the arena."""
        if not 0 < width <= 31:
            raise ValueError(
                f"width must be in [1, 31] to fit the int32 interleave "
                f"mask; got {width}")
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async'; got {mode!r}")
        if carry_budget:
            if mode != "async":
                raise ValueError(
                    "carry_budget requires mode='async' (the carry list "
                    "lives on the async slot; a sync drain has nowhere to "
                    "redrive from)")
            if not reply_capacity:
                raise ValueError(
                    "carry_budget requires reply_capacity > 0: a carried "
                    "record's PENDING stamp and final outcome need the "
                    "status lane")
        if shard_deadline is not None and not reply_capacity:
            raise ValueError(
                "shard_deadline requires reply_capacity > 0: a stalled "
                "drain's records are stamped STATUS_TIMEOUT in the status "
                "lane")
        if capacity < 1 or payload_capacity < 0 or reply_capacity < 0:
            raise ValueError(
                f"capacity {capacity}, payload_capacity {payload_capacity}, "
                f"reply_capacity {reply_capacity}: capacity must be >= 1, "
                "the arenas >= 0")
        layout = _Layout(int(capacity), int(width), int(payload_capacity),
                         int(reply_capacity))
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        state = torch.zeros(layout.words, dtype=torch.int32, device=device)
        q = RpcQueue(layout, state, retry=retry, timeout=timeout, mode=mode,
                     carry_budget=carry_budget, shard_deadline=shard_deadline,
                     sanitize=sanitize)
        events.emit("queue_create", _refs=(q,), qid=id(q),
                    capacity=capacity, width=width,
                    payload_capacity=payload_capacity,
                    reply_capacity=reply_capacity, sanitize=bool(sanitize),
                    retry=retry is not None, mode=mode)
        REGISTRY.note_queue_geometry(
            {"capacity": int(capacity), "width": int(width),
             "payload_capacity": int(payload_capacity),
             "reply_capacity": int(reply_capacity), "shards": 1})
        return q

    def lanes(self) -> Lanes:
        """The views an enqueue reads and writes."""
        return Lanes(self.callee, self.nargs, self.imask, self.pmask,
                     self.ivals, self.fvals, self.plens, self.pbuf,
                     self.head, self.phead, self.adrops, self.rwant,
                     self.base)

    def enqueue(self, name: str, *args, where=None) -> "RpcQueue":
        """Queue one fire-and-forget RPC to host function ``name``; see
        :meth:`enqueue_ticketed`.  Returns the queue; on a card no ticket
        is made (nor written)."""
        return self._enqueue(name, args, None, where, ticketed=False)[0]

    def enqueue_ticketed(self, name: str, *args, returns=None, where=None
                         ) -> Tuple["RpcQueue", torch.Tensor]:
        """Queue one RPC and return ``(queue, ticket)``.

        ``args`` are scalars (Python numbers, or 0-d tensors read on the
        device; the dtype picks the lane) and arrays (any shape: flattened
        into the payload arena and delivered to the host as 1-D int32 or
        float32 numpy arrays).  ``returns`` (shape and dtype, 32 bits or
        narrower) declares a reply, read after the next flush with
        ``queue.result(ticket, returns)``; it needs ``reply_capacity >
        0``.  The ticket is a 0-d int32 tensor on the queue's device: the
        record's global sequence number, or -1 when it was dropped
        (``where`` false or a full arena).  ``where`` (a Python bool or a
        0-d bool tensor) makes the append conditional.  On a card this is
        one ``rpc_enqueue`` launch and reads nothing back."""
        return self._enqueue(name, args, returns, where, ticketed=True)

    def _reply_words(self, name: str, returns) -> int:
        rc = self.reply_capacity
        rshape = tuple(returns.shape)
        rdtype = _torch_dtype(returns.dtype)
        nw = int(np.prod(rshape)) if rshape else 1
        if torch.empty((), dtype=rdtype).element_size() > 4:
            raise TypeError(
                f"RPC record for {name!r}: reply dtype {rdtype} is "
                "wider than the 32-bit reply arena words (a 64-bit "
                "reply would be silently truncated); use int32/float32")
        if rc == 0:
            raise ValueError(
                f"RPC record for {name!r} declares returns= but the "
                "queue has no reply arena; create the queue with "
                "reply_capacity > 0")
        if nw > rc:
            raise ValueError(
                f"RPC record for {name!r} expects {nw} reply words but "
                f"the reply arena only holds {rc}; enlarge "
                "reply_capacity")
        if rdtype.is_complex:
            raise TypeError(
                f"RPC record for {name!r}: unsupported reply dtype "
                f"{rdtype} (int, bool and float replies ride the i32 "
                "reply arena)")
        return -nw if rdtype.is_floating_point else nw

    def record(self, name: str, args, returns=None, where=None) -> Record:
        """The record an enqueue of ``name(*args)`` appends, with JAX's
        checks: the input of the ``rpc_enqueue`` kernel and of its plain
        version (``kernels/rpc_queue/ref.py::enqueue_reference``)."""
        cid = REGISTRY.batch_callee_id(name)
        w, pc, dev = self.width, self.payload_capacity, self.device
        if len(args) > w:
            raise ValueError(
                f"RPC record for {name!r} has {len(args)} args; queue "
                f"width is {w}")
        rw = self._reply_words(name, returns) if returns is not None else 0
        mask = pm = npay = 0
        rargs = []
        for j, a in enumerate(args):
            (kind, is_int, *_), v = _classify(name, j, a, dev)
            if kind == PAYLOAD:
                if pc == 0:
                    raise ValueError(
                        f"RPC record arg {j} for {name!r} is an array but "
                        "the queue has no payload arena; create the queue "
                        "with payload_capacity > 0")
                arg = Arg(PAYLOAD, is_int, src=v, offset=npay,
                          length=v.shape[0])
                pm |= 1 << j
                # a sanitized reservation is [CANARY][words][CANARY]
                npay += arg.length + (2 if self.sanitize else 0)
            elif kind == DEVICE:
                arg = Arg(DEVICE, is_int, src=v)
            else:
                arg = Arg(IMMEDIATE, is_int, word=v)
            if is_int:
                mask |= 1 << j
            rargs.append(arg)
        if npay > pc:
            raise ValueError(
                f"RPC record for {name!r} carries {npay} payload words but "
                f"the arena only holds {pc}; enlarge payload_capacity")
        return Record(cid, mask, pm, rw, npay, rargs, _where(where, dev),
                      self.sanitize)

    def _enqueue_direct(self, name: str, args, returns, where,
                        ticketed: bool):
        """One launch of the ``rpc_enqueue`` kernel through the call's
        enqueue plan (``kernels/rpc_queue/kernel.py::EnqueuePlan``), made
        at its signature's first call with every check of :meth:`record`.
        The key holds the callee, each argument's kind, lane, dtype and
        payload length (:func:`_call_signature`), the ``where`` mode, the
        declared ``returns`` and ``sanitize``: all that those checks read
        but the callee's registration, which every call checks.  Returns
        the plan's record (its ``npay`` and ``rwant``) and the ticket,
        None unless ``ticketed``."""
        try:
            sig, values, mode, bound = _call_signature(name, args, where,
                                                       self._dev)
        except Exception:
            # record() raises it, or one that its checks meet first
            self.record(name, args, returns, where)
            raise
        key = (name, sig, mode, returns, self.sanitize) \
            if returns is None or type(returns) is ShapeDtype else None
        plan = self._plans.get(key) if key is not None else None
        if plan is None:
            plan = EnqueuePlan(*flatten_record(
                self.record(name, args, returns, where)), self._dev)
            if key is not None:
                self._plans[key] = plan
        elif name not in REGISTRY.batch_ids or name not in REGISTRY.hosts:
            REGISTRY.batch_callee_id(name)       # raises, or binds it again
        ticket = torch.empty((), dtype=torch.int32, device=self._dev) \
            if ticketed else None
        self._launch.run(plan, values, bound, ticket)
        return plan.record, ticket

    def _enqueue(self, name: str, args, returns, where, ticketed: bool
                 ) -> Tuple["RpcQueue", Optional[torch.Tensor]]:
        """Append one record: on a card in eager mode through
        :meth:`_enqueue_direct` (the event stream's record needs a
        ticket), else through the ``rpc_enqueue`` op, whose ticket is
        always made."""
        emit = events.active()
        if self._direct and _eager():
            rec, ticket = self._enqueue_direct(name, args, returns, where,
                                               ticketed or emit)
        else:
            rec = self.record(name, args, returns, where)
            ticket = enqueue_op(self.state, self.arrivals, self.layout.lanes,
                                rec)
        if emit:
            # the queue is updated in place: qid_out is the queue itself
            events.emit("rpc_enqueue", _refs=(self, ticket), qid=id(self),
                        qid_out=id(self), name=name, payload_words=rec.npay,
                        reply_words=abs(rec.rwant),
                        ticketed=returns is not None, ticket_id=id(ticket),
                        conditional=where is not None,
                        capacity=self.capacity,
                        payload_capacity=self.payload_capacity,
                        reply_capacity=self.reply_capacity,
                        retry=self.retry is not None,
                        idempotent=REGISTRY.idempotent.get(name, False))
        return self, ticket

    def flush(self, handlers: Optional[Dict[str, Callable]] = None
              ) -> "RpcQueue":
        """Drain every queued record and the arena to the host, replayed in
        enqueue order, and start the next epoch: heads zeroed, ``base``
        advanced, and on a reply-carrying queue the replies and statuses
        installed for :meth:`result`.  ``handlers`` maps callee names to
        this flush's own handlers.  On a card the flush is one round trip
        of the RPC channel (one ``rpc_post``): the host returns at once
        and the stream carries the drain; on the CPU the drain runs here.
        An async queue hands the epoch over instead (see
        :meth:`create`).  Returns the queue.  Refused inside an expanded
        region (:func:`_refuse_in_region`)."""
        _refuse_in_region("RpcQueue.flush()")
        ctx = _FlushCtx(dict(handlers) if handlers else None, self.retry,
                        self.timeout, self.sanitize)
        if self.mode == "async":
            self._check_own_epochs()
            self._flush_async(ctx)
        else:
            self._flush_sync(ctx)
        if events.active():
            events.emit("rpc_flush", _refs=(self,), qid=id(self),
                        qid_out=id(self), capacity=self.capacity,
                        payload_capacity=self.payload_capacity,
                        reply_capacity=self.reply_capacity, mode=self.mode)
        return self

    def _check_own_epochs(self) -> None:
        """Refuse an async flush of one shard of a sharded queue of
        several: its epochs are the sharded queue's, handed over for all
        rows at once (on a card through one ring), so the row alone has
        none to flush."""
        if self._owner is not None and self._owner[2] > 1:
            raise ValueError(
                f"async flush of shard {self._owner[1]} of a "
                f"{self._owner[2]}-shard ShardedRpcQueue: its epochs are "
                "the sharded queue's; flush the ShardedRpcQueue")

    def _flush_sync(self, ctx: _FlushCtx) -> None:
        L = self.layout
        if self.device.type == "cpu":
            channel = host_channel()
        else:
            self._check_policy()
            channel = channel_for(self.device)
        sid, _ = _queue_staging(channel, L)
        post(self.device, sid, [self.state[:L.in_end]], [0],
             [_post_flush(ctx)], [self.state[L.out_start:]], [1])

    def _flush_async(self, ctx: _FlushCtx) -> "RpcQueue":
        """The double-buffered hand-off: submit this epoch's drain, install
        the previous epoch's replies ((rbase, rcount) <- (pbase, pcount))
        and make this epoch the pending window.  On the CPU the collect
        waits here; on a card it is the ``rpc_async_collect`` launch, and
        the host never waits (:func:`_launch_flush`: one C call through
        the queue's flush plan in eager mode, else the two ops)."""
        slot = _slot(self.qslot)
        # a CPU queue with a card's launch (``_direct``) takes the card's
        # route
        if self.device.type == "cpu" and not self._direct:
            return self._flush_async_host(ctx)
        self._check_policy()
        ring = self._ring(slot)
        epoch = ring.issue()
        with slot.lock:
            slot.ctxs[epoch] = ctx
        _launch_flush(self, ring, epoch, self._direct, self.shard_deadline)
        return self

    def _flush_async_host(self, ctx: _FlushCtx) -> "RpcQueue":
        """The async flush through the plain versions of its kernels, the
        collect waiting on the host (a CPU queue's flush)."""
        L, slot = self.layout, _slot(self.qslot)
        rc = L.reply_capacity
        src = self.state[:L.in_end].cpu().numpy().copy()
        prev = _submit_epoch(slot, L, src, ctx, self.carry_budget,
                             _reserve_epochs(L, [src])[0])
        quad, cd = slot.collect(prev, self.shard_deadline, L.capacity, rc)
        _install_epoch(self.state, L, torch.from_numpy(
            _reply_words(quad, cd, rc)))
        return self

    def flush_reference(self, handlers: Optional[Dict[str, Callable]] = None
                        ) -> "RpcQueue":
        """An async queue's flush through the plain versions of its two
        kernels (``kernels/rpc_async/ref.py``) on any device: the records
        are copied to the host and the previous epoch is collected there
        (this waits for the device and for the drain).  What a CPU queue's
        flush runs; on a card, the twin ``rpc_async_post`` and
        ``rpc_async_collect`` are held against."""
        if self.mode != "async":
            raise ValueError("flush_reference() is the async flush's plain "
                             "version; this queue is sync")
        self._check_own_epochs()
        return self._flush_async_host(_FlushCtx(
            dict(handlers) if handlers else None, self.retry, self.timeout,
            self.sanitize))

    def _ring(self, slot: _QueueSlot) -> AsyncRing:
        """The queue's ring on its card (:func:`_async_ring`, one row),
        made at the first flush."""
        if slot.ring is None:
            ring = _async_ring(self.device, self.layout, [self.qslot],
                               self.carry_budget)
            # the ring's thread ends with the queue, once it has handed
            # every flushed epoch to the drain
            weakref.finalize(self, ring.close)
        return slot.ring

    def _check_policy(self, records: Optional[int] = None) -> None:
        """Refuse a policy whose worst case outlasts the channel's wait on
        a card (the posted kernel would trap): a sync flush's retries and
        timeouts over a full ring (or ``records`` of them); an async
        collect's wait for a drain that also redrives up to
        ``carry_budget`` carried rounds of a ring, unless a deadline
        shorter than the wait bounds it."""
        if self.mode == "async" and self.shard_deadline is not None:
            if self.shard_deadline >= TIMEOUT_S:
                raise ValueError(
                    f"RpcQueue flush on a card: shard_deadline "
                    f"{self.shard_deadline}s is not below the channel's "
                    f"{TIMEOUT_S}s wait")
            return
        if self.timeout is None:
            return
        records = self.capacity if records is None else records
        tries = self.retry.max_attempts if self.retry is not None else 1
        backoff = (self.retry.backoff * (2.0 ** (tries - 1) - 1.0)
                   if self.retry is not None else 0.0)
        worst = records * (tries * self.timeout + backoff
                           + self.carry_budget * self.timeout)
        if worst > TIMEOUT_S:
            raise ValueError(
                f"RpcQueue flush on a card: {records} records x "
                f"({tries} attempts x {self.timeout}s timeout + {backoff}s "
                f"backoff + {self.carry_budget} carried rounds x "
                f"{self.timeout}s) = {worst:.1f}s may outlast the channel's "
                f"{TIMEOUT_S}s wait; lower the timeout, the retries, the "
                "carry budget or the capacity")

    def join(self, timeout: Optional[float] = None) -> bool:
        """Async queues: wait until every submitted epoch's drain has
        finished on the host (on a card, after the device has handed it
        over); True, or False on ``timeout``.  It installs no replies:
        flush an empty epoch to collect.  A synchronous queue's flushes
        drain inline: True at once."""
        if self.qslot is None:
            return True
        return _slot(self.qslot).join(timeout)

    def carry_outcomes(self, dev: int = 0) -> Dict[int, Tuple[int, Any]]:
        """Final outcomes of records carried across epochs: ``{ticket:
        (status, words or None)}``, the newest 4096 (async queues with
        ``carry_budget``; run :meth:`join` after the last flush for a
        settled view).  ``dev`` is 0: one device a queue."""
        if self.qslot is None:
            return {}
        slot = _slot(self.qslot)
        with slot.lock:
            return dict(slot.outcomes)

    def _carried(self) -> Tuple[Dict[int, Any], set]:
        """Finalized outcomes and still-carried tickets (host reads)."""
        if self.qslot is None or not self.carry_budget:
            return {}, set()
        return self.carry_outcomes(), set(
            _slot(self.qslot).carried_tickets())

    def _ticket(self, ticket) -> torch.Tensor:
        if isinstance(ticket, torch.Tensor):
            return ticket.to(device=self.device, dtype=torch.int32)
        return torch.full((), int(ticket), dtype=torch.int32,
                          device=self.device)

    def _slot(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        local = t - self.rbase
        slot = torch.remainder(torch.where(local >= 0, local, 0),
                               self.capacity).long().view(1)
        return local, slot

    def result(self, ticket, shape=(), dtype=None) -> torch.Tensor:
        """Read ``ticket``'s reply from the last flush, as ``shape`` and
        ``dtype`` (or a ShapeDtype): zeros for a dropped, overflowed,
        failed or stale ticket (see :meth:`result_ok`)."""
        return self.result_ok(ticket, shape, dtype, _via_result=True)[0]

    def result_ok(self, ticket, shape=(), dtype=None, *, _via_result=False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`result` and its validity: ``ok`` (a 0-d bool tensor) is
        True iff the ticket's slot holds a ``STATUS_OK`` reply of exactly
        the expected length from the last flush.  Device ops only; the
        warnings JAX gives on a concrete read are given for CPU queues
        (on a card they would read the device)."""
        shape, dtype, nw = self._reply_spec(shape, dtype)
        on_cpu = self.device.type == "cpu"
        never_flushed = not bool(self.fonce) if on_cpu else None
        if events.active():
            events.emit("rpc_result", _refs=(self, ticket), qid=id(self),
                        ticket_id=id(ticket), via_result=_via_result,
                        never_flushed=never_flushed)
        if never_flushed:
            warnings.warn(
                "RpcQueue.result() on a queue that has NEVER flushed: the "
                "reply table has never been written, so this read returns "
                "all-zeros indistinguishable from a real zero reply.  "
                "Flush the queue before reading tickets.",
                RuntimeWarning, stacklevel=3)
        rc = self.reply_capacity
        t = self._ticket(ticket)
        local, slot = self._slot(t)
        rlen = self.rlen.index_select(0, slot).view(())
        ok = (t >= 0) & (local >= 0) & (local < self.rcount) & (rlen == nw)
        ok = ok & (self.rstat.index_select(0, slot).view(()) == STATUS_OK)
        off = self.roff.index_select(0, slot).clamp(0, rc - nw)
        idx = off.long() + torch.arange(nw, device=self.device)
        words = self.rbuf.index_select(0, idx)
        if dtype.is_floating_point:
            vals = words.view(torch.float32).to(dtype)
        else:
            vals = words.to(dtype)
        vals = torch.where(ok, vals, torch.zeros_like(vals))
        if _via_result and on_cpu and not bool(ok):
            # a failed ticket's zeros consumed as a reply; on a card this
            # would read the device, so only CPU queues count it
            if self.sanitize:
                _san_bump("failed_ticket_reads")
            if not self._failed_read_warned:
                self._failed_read_warned = True
                warnings.warn(
                    f"RpcQueue.result() on failed/dropped ticket "
                    f"{int(t)}: the read returns zeros indistinguishable "
                    "from a real zero reply; consult result_status() or "
                    "use result_ok() (warning once per queue).",
                    RuntimeWarning, stacklevel=3)
        return vals.reshape(shape), ok

    def result_status(self, ticket) -> torch.Tensor:
        """The status of ``ticket`` against the last flush (a 0-d int32
        tensor): OK, CALLEE_RAISED, TIMEOUT, REPLY_OVERFLOW, DROPPED (a -1
        ticket, or an injected reply drop) or STALE (outside the last
        flush's window).  Device ops only."""
        if self.reply_capacity == 0:
            raise ValueError(
                "result_status() on a queue with no reply arena; create "
                "the queue with reply_capacity > 0")
        if events.active():
            # a status consult counts as a guard
            events.emit("rpc_result", _refs=(self, ticket), qid=id(self),
                        ticket_id=id(ticket), via_result=False,
                        never_flushed=None)
        t = self._ticket(ticket)
        local, slot = self._slot(t)
        st = self.rstat.index_select(0, slot).view(())
        in_window = (local >= 0) & (local < self.rcount)
        plocal = t - self.pbase
        pend = (plocal >= 0) & (plocal < self.pcount)

        def const(v):
            return torch.full((), v, dtype=torch.int32, device=self.device)

        return torch.where(
            t < 0, const(STATUS_DROPPED),
            torch.where(in_window, st,
                        torch.where(pend, const(STATUS_PENDING),
                                    const(STATUS_STALE))))

    def pressure(self) -> torch.Tensor:
        """Occupancy of the current epoch in ``[0, 1+)`` (a 0-d float32
        tensor): the max of ring, payload-arena and declared-reply
        occupancy; ``>= 1`` means the next enqueue or the drain drops."""
        cap = self.capacity
        p = self.head.to(torch.float32) / cap
        if self.payload_capacity:
            p = torch.maximum(p, self.phead.to(torch.float32)
                              / self.payload_capacity)
        if self.reply_capacity:
            live = (torch.arange(cap, dtype=torch.int32, device=self.device)
                    < torch.minimum(self.head, torch.full_like(self.head,
                                                               cap)))
            declared = (self.rwant.abs() * live).sum()
            p = torch.maximum(p, declared.to(torch.float32)
                              / self.reply_capacity)
        return torch.maximum(p, self.cdepth.to(torch.float32) / cap)

    def _reply_spec(self, shape, dtype):
        """A reply read's ``(shape, dtype, words)``, checked against the
        reply arena and the 32-bit words."""
        if hasattr(shape, "shape") and hasattr(shape, "dtype"):
            dtype = shape.dtype
            shape = tuple(shape.shape)
        shape = tuple(shape)
        dtype = _torch_dtype(dtype if dtype is not None else torch.int32)
        nw = int(np.prod(shape)) if shape else 1
        rc = self.reply_capacity
        if rc == 0:
            raise ValueError(
                "result() on a queue with no reply arena; create the queue "
                "with reply_capacity > 0 and enqueue with returns=")
        if nw > rc:
            raise ValueError(
                f"result() reads {nw} words but the reply arena only holds "
                f"{rc}")
        if torch.empty((), dtype=dtype).element_size() > 4:
            raise TypeError(
                f"result() dtype {dtype} is wider than the 32-bit reply "
                "arena words; use int32/float32")
        return shape, dtype, nw

    def results_host(self, tickets, shape=(), dtype=None):
        """Host-side batch read, ``[(numpy value, ok), ...]``, with one
        device-to-host copy of the reply table (this waits for the
        device); the semantics of :meth:`result_ok`, ticket for ticket."""
        shape, dtype, nw = self._reply_spec(shape, dtype)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype \
            if dtype != torch.bfloat16 else np.dtype(np.float32)
        L = self.layout
        v = L.views(self.state[L.out_start:].cpu().numpy(), L.out_start)
        rbuf, roff, rlen, rstat = v["rbuf"], v["roff"], v["rlen"], v["rstat"]
        rbase, rcount = int(v["rbase"]), int(v["rcount"])
        outcomes, _ = self._carried()
        out = []
        for t in tickets:
            t = int(t)
            oc = outcomes.get(t)
            if oc is not None:
                # a carried record resolves through the outcome table
                st, words = oc
                ok = st == STATUS_OK and words is not None and \
                    words.size == nw
                vals = (_decode_words(words, np_dtype) if ok
                        else np.zeros((nw,), np_dtype))
                out.append((vals.reshape(shape), ok))
                continue
            local = t - rbase
            slot = local % self.capacity if local >= 0 else 0
            ok = (t >= 0 and 0 <= local < rcount and int(rlen[slot]) == nw
                  and int(rstat[slot]) == STATUS_OK)
            if self.sanitize and t >= 0 and not 0 <= local < rcount:
                # a live ticket read outside the serviced epoch's window
                _san_bump("stale_ticket_reads")
            if ok:
                vals = _decode_words(rbuf[int(roff[slot]):int(roff[slot])
                                          + nw], np_dtype)
            else:
                vals = np.zeros((nw,), np_dtype)
            out.append((vals.reshape(shape), ok))
        return out

    def statuses_host(self, tickets) -> List[int]:
        """Host-side batch :meth:`result_status`, one int per ticket, with
        one device-to-host copy of the status lane (this waits)."""
        if self.reply_capacity == 0:
            raise ValueError(
                "statuses_host() on a queue with no reply arena; create "
                "the queue with reply_capacity > 0")
        L = self.layout
        v = L.views(self.state[L.out_start:].cpu().numpy(), L.out_start)
        rstat = v["rstat"]
        rbase, rcount = int(v["rbase"]), int(v["rcount"])
        pbase, pcount = int(v["pbase"]), int(v["pcount"])
        # a finalized carry outcome wins over an older window's stamp; a
        # still-carried ticket reads PENDING
        outcomes, carried = self._carried()
        out = []
        for t in tickets:
            t = int(t)
            if t < 0:
                out.append(STATUS_DROPPED)
                continue
            if t in outcomes:
                out.append(int(outcomes[t][0]))
                continue
            if t in carried:
                out.append(STATUS_PENDING)
                continue
            local = t - rbase
            if not 0 <= local < rcount:
                out.append(STATUS_PENDING if 0 <= t - pbase < pcount
                           else STATUS_STALE)
                continue
            out.append(int(rstat[local % self.capacity]))
        return out


# ---------------------------------------------------------------------------
# Sharded batched transport: one queue shard per device
# ---------------------------------------------------------------------------

class ShardedRpcQueue:
    """Per-device RPC queues (one shard a device or team), the port of
    JAX's ``ShardedRpcQueue``.

    The shards are stacked along a leading axis of one int32 state
    ``(D, words)`` on one device.  In an expanded region
    (``core/expand.py``) each team of the mesh enqueues on a copy of its
    row (:meth:`team_local`), and :meth:`gathered` writes every team's
    row back after the region and ties the queue to the mesh: its flushes
    then drain on the mesh's first rank alone, which broadcasts the
    state, replies and statuses included, to the others (host effects
    happen once).  Deliberately unlike JAX's functional shards, :meth:`local`
    returns an :class:`RpcQueue` that is a view of row ``d``: an enqueue
    through it lands in the stacked state (on a card it is one
    ``rpc_enqueue`` on the row's storage), and the same view is returned
    every time.  :meth:`stack` restacks a list of them.  An async flush
    is the sharded queue's alone: a shard of several refuses one.

    A sync flush replays every shard's records in ``(device, slot)``
    order and writes each shard's replies and statuses to its own row: on
    a card one ``rpc_post`` round trip carries all D rows.  With
    ``shard_deadline`` the shards drain concurrently and a shard past the
    deadline reads ``STATUS_TIMEOUT`` (partial-epoch completion).  An
    async flush drains each shard's epochs independently, on the shard's
    own slot; on a card one mapped ring, with a row a shard, carries them
    all, so a flush is one ``rpc_async_post`` and one
    ``rpc_async_collect`` (a block a shard) whatever D (a deliberate
    difference from JAX's one callback a device)."""

    def __init__(self, layout: _Layout, state: torch.Tensor, *,
                 retry: Optional[RetryPolicy] = None,
                 timeout: Optional[float] = None, mode: str = "sync",
                 carry_budget: int = 0,
                 shard_deadline: Optional[float] = None,
                 sanitize: bool = False):
        self.layout, self.state = layout, state
        self.shards = [RpcQueue(layout, state[d], retry=retry,
                                timeout=timeout, mode=mode,
                                carry_budget=carry_budget,
                                shard_deadline=shard_deadline,
                                sanitize=sanitize)
                       for d in range(state.shape[0])]
        for d, q in enumerate(self.shards):
            q._owner = (weakref.ref(self), d, len(self.shards))
        #: The DeviceMesh whose teams filled the rows, once
        #: :meth:`gathered`; its flushes drain on the first rank.
        self.mesh = None
        # an async card queue's flush plan, made at its first flush
        self._async_plan: Optional[AsyncFlushPlan] = None

    @property
    def n_devices(self) -> int:
        return len(self.shards)

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def capacity(self) -> int:
        return self.layout.capacity

    @property
    def width(self) -> int:
        return self.layout.width

    @property
    def payload_capacity(self) -> int:
        return self.layout.payload_capacity

    @property
    def reply_capacity(self) -> int:
        return self.layout.reply_capacity

    @property
    def mode(self) -> str:
        return self.shards[0].mode

    @staticmethod
    def create(n_devices: int, capacity: int = 1024, width: int = 4,
               payload_capacity: int = 1024, reply_capacity: int = 0,
               sanitize: bool = False,
               retry: Optional[RetryPolicy] = None,
               timeout: Optional[float] = None, mode: str = "sync",
               carry_budget: int = 0,
               shard_deadline: Optional[float] = None, *,
               device="cuda") -> "ShardedRpcQueue":
        """``n_devices`` shards of ``RpcQueue.create``'s queue (every
        option of it) on ``device`` (the card unless the caller asks for
        the CPU).  ``shard_deadline`` (seconds, reply-carrying queues)
        bounds a sync flush's concurrent drain of the shards, or an async
        flush's collect of each shard's previous epoch."""
        proto = RpcQueue.create(capacity, width, payload_capacity,
                                reply_capacity, sanitize=sanitize,
                                retry=retry, timeout=timeout, mode=mode,
                                carry_budget=carry_budget,
                                shard_deadline=shard_deadline,
                                device=device)
        state = proto.state.unsqueeze(0).repeat(int(n_devices), 1)
        sq = ShardedRpcQueue(proto.layout, state, retry=retry,
                             timeout=timeout, mode=mode,
                             carry_budget=carry_budget,
                             shard_deadline=shard_deadline,
                             sanitize=sanitize)
        REGISTRY.note_queue_geometry(queue_geometry(sq))
        return sq

    @staticmethod
    def stack(locals_: Sequence[RpcQueue]) -> "ShardedRpcQueue":
        """The sharded queue whose shard ``d`` is ``locals_[d]`` (JAX's
        ``ShardedRpcQueue(jax.tree.map(stack, *locals_))``): since the
        locals are views, the queue they are the shards of, in order.
        Anything else raises."""
        owner = locals_[0]._owner[0]() if locals_ and \
            locals_[0]._owner else None
        if owner is None or len(locals_) != owner.n_devices or any(
                q is not owner.local(d) for d, q in enumerate(locals_)):
            raise ValueError(
                "ShardedRpcQueue.stack() takes the locals of one sharded "
                "queue, every shard in order (local(0), ..., local(D-1))")
        return owner

    def local(self, dev: int) -> RpcQueue:
        """Device ``dev``'s shard: a view of its row (see the class
        docstring)."""
        return self.shards[int(dev)]

    def local_view(self) -> RpcQueue:
        """The one shard of a one-row sharded queue: a view of its
        row."""
        assert self.n_devices == 1, \
            "local_view() needs a one-row queue (a team's block); use " \
            "local(dev) outside a region"
        view = self.local(0)
        if events.active():
            events.emit("queue_view", _refs=(view,), qid=id(view),
                        capacity=view.capacity, width=view.width,
                        payload_capacity=view.payload_capacity,
                        reply_capacity=view.reply_capacity,
                        sanitize=view.sanitize, mode=view.mode)
        return view

    def with_local(self, local: RpcQueue) -> "ShardedRpcQueue":
        """Inverse of :meth:`local_view`."""
        return ShardedRpcQueue.stack([local])

    def team_local(self, dev: int) -> RpcQueue:
        """Team ``dev``'s queue in an expanded region: a view of a copy of
        row ``dev``, with this queue's options, so its enqueues do not
        touch this queue.  It reports this queue's mode, and has no
        epochs of its own (a region never flushes)."""
        q0 = self.shards[0]
        block = ShardedRpcQueue(
            self.layout, self.state[dev:dev + 1].clone(), retry=q0.retry,
            timeout=q0.timeout, carry_budget=q0.carry_budget,
            shard_deadline=q0.shard_deadline, sanitize=q0.sanitize)
        block.shards[0].mode = self.mode
        return block.local_view()

    def gathered(self, local: RpcQueue, mesh) -> "ShardedRpcQueue":
        """Write every team's ``local`` queue of ``mesh`` into this
        queue's rows (in team order) and tie the queue to ``mesh``, in
        place, as every queue op is.  Returns the queue."""
        self.state.copy_(gather_blocks(local.state.unsqueeze(0), mesh))
        self.mesh = mesh
        return self

    def flush(self, handlers: Optional[Dict[str, Callable]] = None
              ) -> "ShardedRpcQueue":
        """Drain every shard to the host, records replayed in ``(device,
        slot)`` order (see the class docstring); each shard's replies land
        in its row, read with :meth:`result` or ``local(d).result``.  On a
        queue gathered over a mesh, only the mesh's first rank drains and
        every rank gets its state.  Returns the queue."""
        _refuse_in_region("ShardedRpcQueue.flush()")
        q0 = self.shards[0]
        ctx = _FlushCtx(dict(handlers) if handlers else None, q0.retry,
                        q0.timeout, q0.sanitize, q0.shard_deadline)
        first = self.mesh is None or not any(self.mesh.get_coordinate())
        if first and self.mode == "async":
            self._flush_async(ctx)
        elif first:
            self._flush_sync(ctx)
        if self.mesh is not None:
            broadcast_from_first(self.state, self.mesh)
        if events.active():
            events.emit("rpc_flush", _refs=(self,), qid=id(self),
                        qid_out=id(self), capacity=self.capacity,
                        payload_capacity=self.payload_capacity,
                        reply_capacity=self.reply_capacity, sharded=True,
                        mode=self.mode)
        return self

    def _flush_sync(self, ctx: _FlushCtx) -> None:
        L, D = self.layout, self.n_devices
        if self.device.type == "cpu":
            channel = host_channel()
        else:
            self._check_policy()
            channel = channel_for(self.device)
        sid, _ = _sharded_staging(channel, L, D)
        post(self.device, sid, [self.state[d, :L.in_end] for d in range(D)],
             list(range(D)), [_post_flush(ctx)],
             [self.state[d, L.out_start:] for d in range(D)],
             list(range(D, 2 * D)))

    def _check_policy(self) -> None:
        """A card flush's worst case must stay within the channel's wait:
        the deadline when there is one; else a sync flush's records of
        every shard, an async collect's of one shard."""
        q0 = self.shards[0]
        dl = q0.shard_deadline
        if dl is not None:
            if dl >= TIMEOUT_S:
                raise ValueError(
                    f"ShardedRpcQueue flush on a card: shard_deadline {dl}s "
                    f"is not below the channel's {TIMEOUT_S}s wait")
            return
        q0._check_policy(None if self.mode == "async"
                         else self.capacity * self.n_devices)

    def _flush_async(self, ctx: _FlushCtx) -> None:
        """Each shard's epoch submitted to its own slot, the occurrences
        of all of them reserved first in ``(device, slot)`` order, then
        each shard's previous epoch collected, the deadline's budget
        shared from the first collect (JAX's).  On a card: one
        ``rpc_async_post`` hands every row over through the queue's ring
        (:func:`_async_ring`), one ``rpc_async_collect`` installs every
        row's previous epoch, the rows waiting side by side up to the
        deadline (the first shard's, read at every flush), both launches
        through :func:`_launch_flush`, as a single queue's."""
        L, q0 = self.layout, self.shards[0]
        if self.device.type == "cpu" and not q0._direct:
            self._flush_async_host(ctx)
            return
        self._check_policy()
        slot = _slot(q0.qslot)
        if slot.ring is None:
            ring = _async_ring(self.device, L,
                               [q.qslot for q in self.shards],
                               q0.carry_budget)
            weakref.finalize(self, ring.close)
        ring = slot.ring
        epoch = ring.issue()
        with slot.lock:
            slot.ctxs[epoch] = ctx
        _launch_flush(self, ring, epoch, q0._direct, q0.shard_deadline)

    def _flush_async_host(self, ctx: _FlushCtx) -> None:
        L, rc = self.layout, self.reply_capacity
        srcs = [q.state[:L.in_end].cpu().numpy().copy()
                for q in self.shards]
        prevs = [_submit_epoch(_slot(q.qslot), L, w, ctx, q.carry_budget,
                               occ)
                 for q, w, occ in zip(self.shards, srcs,
                                      _reserve_epochs(L, srcs))]
        deadline = self.shards[0].shard_deadline
        t0 = time.monotonic()
        words = []
        for q, prev in zip(self.shards, prevs):
            left = (None if deadline is None
                    else max(0.0, deadline - (time.monotonic() - t0)))
            quad, cd = _slot(q.qslot).collect(prev, left, L.capacity, rc)
            words.append(torch.from_numpy(_reply_words(quad, cd, rc)))
        _install_epoch(self.state, L, torch.stack(words))

    def join(self, timeout: Optional[float] = None) -> bool:
        """Async queues: wait until every shard's submitted drains have
        finished; True, or False on ``timeout``.  Sync queues: True at
        once."""
        if self.mode != "async":
            return True
        t0 = time.monotonic()
        return all(_slot(q.qslot).join(
            None if timeout is None
            else max(0.0, timeout - (time.monotonic() - t0)))
            for q in self.shards)

    def carry_outcomes(self, dev: int = 0) -> Dict[int, Tuple[int, Any]]:
        """Device ``dev``'s finalized cross-epoch carry outcomes (see
        :meth:`RpcQueue.carry_outcomes`)."""
        return self.shards[int(dev)].carry_outcomes()

    def result(self, dev, ticket, shape=(), dtype=None) -> torch.Tensor:
        """Device ``dev``'s reply for ``ticket`` from the last flush."""
        return self.local(dev).result(ticket, shape, dtype)

    def result_status(self, dev, ticket) -> torch.Tensor:
        """Device ``dev``'s status for ``ticket``."""
        return self.local(dev).result_status(ticket)

    def pressure(self) -> torch.Tensor:
        """Each shard's :meth:`RpcQueue.pressure`, a (D,) float32 tensor."""
        return torch.stack([q.pressure() for q in self.shards])


# ---------------------------------------------------------------------------
# Decorator: register + generate a device stub
# ---------------------------------------------------------------------------

def host_rpc(name: Optional[str] = None, *, result_shape,
             pure: bool = False):
    """Register ``fn`` as host-only and give it a device stub ``fn.rpc``.

    >>> @host_rpc(result_shape=ShapeDtype((), torch.int32))
    ... def fetch_seed(epoch):           # runs on the HOST
    ...     return np.int32(lookup(epoch))
    ...
    >>> seed, _ = fetch_seed.rpc(epoch)  # from device code

    The callee receives numpy arrays.  On a card they are views of the
    transport's staging memory, valid during the call only (copy what you
    keep), and the callee runs on the channel's drain thread while the
    device waits for it: it must not launch CUDA work or wait for the
    device (``torch`` CUDA calls, ``.cpu()``), or the stream it would wait
    for is the one that waits for it.  ``pure=True`` refuses write-back
    refs."""
    def deco(fn):
        rpc_name = name or fn.__name__
        REGISTRY.register(rpc_name, fn)

        def stub(*args, device=None):
            return rpc_call(rpc_name, *args, result_shape=result_shape,
                            pure=pure, device=device)

        fn.rpc = stub
        fn.rpc_name = rpc_name
        return fn

    return deco
