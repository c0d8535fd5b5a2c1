"""Generated host RPC (paper §3.2), immediate calls, on the H100.

The port of ``repro/core/rpc.py``'s immediate-call subset.  Device code
calls a host-only function as ``fn.rpc(*args)`` (see :func:`host_rpc`) or
``rpc_call(name, *args, result_shape=...)``.  Arguments may mix values
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
  (``kernels/rpc_channel``): in stream order the operands are copied into
  the pad's staging region in pinned, host-mapped memory, a CUDA kernel
  (``rpc_post``) posts the record and waits on a reply flag that a host
  thread sets after running the callee, and the result and the
  write-back refs are copied out.  The Python thread never waits for the
  device: the call returns at once with tensors that the stream fills, as
  JAX's ordered ``io_callback`` never blocks the tracing thread.  Host
  effects are visible after :func:`effects_barrier`.  There is no
  fallback: a failed build, allocation or launch raises.
* **CPU tensors** (and calls with no tensor) call the landing pad
  directly: :func:`rpc_call_reference`, the transport's plain version,
  which on CUDA tensors is the host-synchronous path (copy to the host,
  call, copy back).

bf16 operands reach the callee as float32 and a bf16 write-back is rounded
back.  ``rpc_stats``' byte counts are JAX's: operands in, result and every
ref out (a READ ref too, as JAX returns it), each at its signature's
dtype.  Not in this slice (ROADMAP queue 1, item 3.2 and later): the
batched ``RpcQueue`` and ``ShardedRpcQueue`` (``batched=``, ``returns=``,
``where=`` raise), ``mode="async"``, ``RetryPolicy``, ``RpcManifest``,
``events`` and the sanitizer counters.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.allocator import I32, as_i32, find_obj
from repro_torch.kernels.rpc_channel import (channel_for, channels,
                                             rpc_post)
from repro_torch.kernels.rpc_channel.kernel import INLINE_WORDS, Staging

_QUEUE = "ROADMAP queue 1, item 3.2 (RpcQueue, the batched transport)"

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


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


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
    """Content-hashed callee id (31 bits: it rides an int32 lane of the
    batched queue, item 3.2)."""
    return _stable_id("callee", name, 31)


def stable_hook_id(key: str) -> int:
    """Content-hashed suffix of an auto-named ``device_run`` hook."""
    return _stable_id("hook", key, 31)


# ---------------------------------------------------------------------------
# Registry: host functions, landing pads, stats
# ---------------------------------------------------------------------------

def _zero_stats() -> Dict[str, float]:
    return {"calls": 0, "bytes_in": 0, "bytes_out": 0}


class _Registry:
    """Host-function table, landing-pad table and stats.  ``pads`` maps
    ``(callee,) + signature`` to a pad id, ``pad_wrappers`` holds the one
    host wrapper of each pad, ``pad_info``/``pad_stats`` its key and its
    counters, ``stats`` the counters of each callee."""

    def __init__(self):
        self.lock = threading.Lock()
        self.hosts: Dict[str, Callable] = {}
        self.pads: Dict[Tuple, int] = {}
        self.pad_wrappers: Dict[int, Callable] = {}
        self.pad_info: Dict[int, Tuple] = {}
        self.pad_stats: Dict[int, Dict[str, float]] = {}
        self.stats: Dict[str, Dict[str, float]] = {}

    def register(self, name: str, fn: Callable) -> None:
        """(Re-)bind ``name`` to ``fn``; pads and stats survive, and pads
        already made dispatch to the new function."""
        with self.lock:
            self.hosts[name] = fn
            self.stats.setdefault(name, dict(_zero_stats(), pads=0))

    def unregister(self, name: str) -> None:
        """Remove ``name``'s host binding, stats and landing pads; call it
        only after every posted call of ``name`` has run
        (:func:`effects_barrier`)."""
        with self.lock:
            self.hosts.pop(name, None)
            self.stats.pop(name, None)
            for key in [k for k in self.pads if k[0] == name]:
                pid = self.pads.pop(key)
                self.pad_wrappers.pop(pid, None)
                self.pad_info.pop(pid, None)
                self.pad_stats.pop(pid, None)

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

    def bump(self, name: str, pad_id: int, bytes_in: int, bytes_out: int):
        with self.lock:
            for s in (self.stats[name], self.pad_stats[pad_id]):
                s["calls"] += 1
                s["bytes_in"] += bytes_in
                s["bytes_out"] += bytes_out


REGISTRY = _Registry()


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


def reset_rpc_stats() -> None:
    with REGISTRY.lock:
        for s in list(REGISTRY.stats.values()) + \
                list(REGISTRY.pad_stats.values()):
            for k in s:
                s[k] = 0


# ---------------------------------------------------------------------------
# Landing pads and marshalling
# ---------------------------------------------------------------------------

def _entry_bytes(entry: Tuple) -> int:
    return int(np.prod(entry[1], dtype=np.int64)) * _ITEMSIZE[entry[2]]


def _make_pad_wrapper(name: str, pad_id: int, sig: Tuple):
    """The host landing pad (paper Fig. 3b): ``wrapper(flat)`` calls the
    callee on the flat operand arrays (an ``ArenaRef`` is five: ptr, base,
    size, found, arena), counts the call and returns the result as an
    array.  The callee writes refs in place: the transport hands it
    buffers of its own and decides what comes back.  The callee is looked
    up at each call, so re-registering a name rebinds its pads."""
    bytes_in = sum(_entry_bytes(e) + (16 if e[0] == ARENA else 0)
                   for e in sig)
    bytes_refs = sum(_entry_bytes(e) for e in sig if e[0] != VAL)

    def wrapper(flat: Sequence[np.ndarray]) -> np.ndarray:
        result = np.asarray(REGISTRY.hosts[name](*flat))
        REGISTRY.bump(name, pad_id, bytes_in, result.nbytes + bytes_refs)
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
    return t.detach().to(staged).contiguous(), name


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


def _store(view: np.ndarray, out: np.ndarray, name: str) -> None:
    if out.shape != view.shape:
        raise ValueError(f"RPC {name!r} returned shape {out.shape}; its "
                         f"result_shape is {view.shape}")
    view[...] = out


def _prepare(name: str, args, result_shape, pure: bool, device):
    if name not in REGISTRY.hosts:
        raise KeyError(f"no host function registered for RPC {name!r}")
    if result_shape is None:
        raise TypeError("rpc_call() missing required keyword argument "
                        "'result_shape'")
    spec = ShapeDtype(result_shape.shape, result_shape.dtype)
    device = _device_of(args, device)
    sig, ops, refs = _marshal(args, device)
    if pure and any(acc != READ for _, acc, _ in refs):
        raise ValueError(
            f"pure RPC {name!r} cannot take write/readwrite refs: a pure "
            "call may be elided or reordered, so host-side mutation has no "
            "defined meaning")
    pid, _ = REGISTRY.landing_pad(name, sig)
    return spec, device, sig, ops, refs, pid


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
    ``pure=True`` refuses write-back refs.  ``batched``,
    ``queue``, ``where`` and ``returns`` belong to the batched transport,
    not ported yet."""
    if batched or queue is not None or where is not None \
            or returns is not None:
        raise NotImplementedError(
            f"rpc_call(batched=, queue=, where=, returns=) needs {_QUEUE}")
    spec, device, sig, ops, refs, pid = _prepare(name, args, result_shape,
                                                 pure, device)
    if device.type == "cpu":
        return _call_host(name, pid, sig, ops, refs, spec, device)
    if device.type != "cuda":
        raise ValueError(f"RPC operands on {device}")
    return _call_channel(name, pid, sig, ops, refs, spec, device)


def rpc_call_reference(name: str, *args, result_shape=None,
                       pure: bool = False, device=None):
    """The transport's plain version, on any device: copy every operand to
    the host (for CUDA tensors this waits for the device), call the
    landing pad, copy the result and the write-backs back.  ``rpc_call``
    takes it for CPU operands."""
    spec, device, sig, ops, refs, pid = _prepare(name, args, result_shape,
                                                 pure, device)
    return _call_host(name, pid, sig, ops, refs, spec, device)


def _call_host(name, pid, sig, ops, refs, spec, device):
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
    staged = _DTYPES[spec.dtype][1]
    res = np.empty(spec.shape, _np_dtype(staged))
    _store(res, out, name)
    result = torch.from_numpy(res).to(device=device, dtype=spec.dtype)
    updated = [orig if acc == READ else
               torch.from_numpy(arrays[i]).to(device=device, dtype=orig.dtype)
               for i, acc, orig in refs]
    return result, updated


def _pad_staging(channel, name, pid, sig, ops, spec):
    """The pad's staging region on ``channel`` and its ``serve`` callable,
    made at the pad's first call there.  Tensor operands get a slot each,
    Python numbers a scalar word, the result the last slot."""
    entry = channel.pads.get(pid)
    if entry is not None:
        if entry[2] != spec:
            raise ValueError(f"RPC {name!r}: result_shape {spec} differs from "
                             f"{entry[2]}, this landing pad's first")
        return entry[0]
    tensors = [op for op in ops if isinstance(op, torch.Tensor)]
    staged = _DTYPES[spec.dtype][1]
    res_bytes = int(np.prod(spec.shape, dtype=np.int64)) * \
        torch.empty((), dtype=staged).element_size()
    staging = Staging([t.numel() * t.element_size() for t in tensors]
                      + [res_bytes])
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
    res_view = staging.slot(slot).view(_np_dtype(staged)).reshape(spec.shape)

    def serve():
        out = REGISTRY.pad_wrappers[pid](_flat(sig, views))
        _store(res_view, out, name)

    channel.pads[pid] = (staging, serve, spec)
    return staging


def _call_channel(name, pid, sig, ops, refs, spec, device):
    channel = channel_for(device)
    staging = _pad_staging(channel, name, pid, sig, ops, spec)
    slots, inputs, words = {}, [], []
    for i, op in enumerate(ops):
        if isinstance(op, torch.Tensor):
            slots[i] = len(inputs)
            inputs.append((slots[i], op))
        else:
            word = np.zeros(4, np.uint8)
            word[:op.dtype.itemsize] = np.frombuffer(op.tobytes(), np.uint8)
            words.append(int(word.view(np.uint32)[0]))
    if len(words) > INLINE_WORDS:
        raise ValueError(f"RPC {name!r}: {len(words)} Python-number operands, "
                         f"at most {INLINE_WORDS}; pass tensors")
    staged = _DTYPES[spec.dtype][1]
    result = torch.empty(spec.shape, dtype=staged, device=device)
    outputs = [(len(inputs), result)]
    backs = {}
    for i, acc, _ in refs:
        if acc != READ:
            backs[i] = torch.empty_like(ops[i])
            outputs.append((slots[i], backs[i]))
    rpc_post(channel, pid, staging, inputs, words, outputs)
    updated = [orig if acc == READ else backs[i].to(orig.dtype)
               for i, acc, orig in refs]
    return result.to(spec.dtype), updated


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
