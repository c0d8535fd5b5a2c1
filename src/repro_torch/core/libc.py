"""Partial device libc (paper §3.4), ported so far: ``rand``, ``atoi``,
``strtod`` and ``realloc``.

``rand_*`` is the counter-based threefry generator of the JAX package's
``core/libc.py``: stateless, splittable, the same numbers wherever it runs.
It is bit-exact with JAX 0.9's ``threefry2x32``, ``random.fold_in``,
``random.bits`` and ``random.uniform`` under ``jax_threefry_partitionable =
True`` (the installed default), the mode that fixes how the bits of a shape
are laid out: element i of a shape (row-major) hashes the 64-bit counter i,
split into (hi, lo) words, and its bits are the XOR of the two output words.

The state is an int64 tensor of shape (3,) holding three uint32 values
(key low word, key high word, counter), since torch has no full uint32
arithmetic; every operation is integer tensor arithmetic masked to 32 bits,
so it runs on the card as well as on the CPU, without a host sync.

``atoi`` and ``strtod`` parse a uint8 code buffer on the device, and
``realloc`` moves a heap object through the allocator that the state's
type names; none of them reads a value back to the host.

Buffered I/O rides the batched queue (:class:`~repro_torch.core.rpc.
RpcQueue`), as in JAX: ``LogRing`` (records ``(tag, value[, payload])`` to
a sink), ``fprintf`` (an interned format id and its arguments, formatted
on the host at flush), ``fwrite`` (an array appended to a host stream),
``fread``/``fgets`` (a ticketed request whose reply carries the data) and
remote malloc (a size vector whose reply is the pointers, allocated at the
flush from a registered host-side heap).  On a card each call is one
``rpc_enqueue`` launch and the host sees it at the queue's flush.  The
format table's ids are JAX's (the same content hash), and the table
travels in the transport's ``RpcManifest``.  ``LogRing.create_sharded``
rides the sharded queue: a ring shard per device, logged through each
shard's ``local(d)`` and drained in ``(device, slot)`` order.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.allocator import (BalancedState, ShardedHeap,
                                        allocator_for, as_i32)
from repro_torch.core.rpc import (REGISTRY, RpcQueue, ShapeDtype,
                                  ShardedRpcQueue, register_format_section,
                                  stable_format_id)

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: Word, k2: Word, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) on int64
    tensors of uint32 values; the key words broadcast against the counts."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    y0 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y0) & _M32
            y0 = _rotl(y0, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        y0 = (y0 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, y0


def fold_in(k1: Word, k2: Word, data: Word
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``random.fold_in``: the key hashed with the count pair (0, data)."""
    zero = torch.zeros_like(data) if isinstance(data, torch.Tensor) else 0
    return threefry2x32(k1, k2, torch.as_tensor(zero), torch.as_tensor(data))


def random_bits(k1: torch.Tensor, k2: torch.Tensor,
                shape: Sequence[int]) -> torch.Tensor:
    """``random.bits(key, shape, uint32)`` in the partitionable layout:
    int64 values in [0, 2**32)."""
    n = 1
    for s in shape:
        n *= int(s)
    if n >= 1 << 32:
        raise ValueError("random_bits: more than 2**32 elements")
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(tuple(shape))


def rand_init(seed: int, *, device) -> torch.Tensor:
    """RNG state: (key low, key high, counter) as an int64 (3,) tensor."""
    return torch.tensor([seed & _M32, (seed >> 32) & _M32, 0],
                        dtype=torch.int64, device=device)


def _advance(state: torch.Tensor) -> torch.Tensor:
    out = state.clone()
    out[2] = (out[2] + 1) & _M32
    return out


def rand_u32(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """C ``rand()``: returns (state', a uniform uint32 as an int64 0-d
    tensor)."""
    k1, k2 = fold_in(state[0], state[1], state[2])
    return _advance(state), random_bits(k1, k2, ())


def rand_uniform(state: torch.Tensor, shape: Sequence[int] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``random.uniform`` in [0, 1) as float32: the top 23 bits of each
    word become the mantissa of a float in [1, 2), less 1."""
    k1, k2 = fold_in(state[0], state[1], state[2])
    bits = random_bits(k1, k2, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return _advance(state), f - 1.0


def _key(seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.PRNGKey(seed)``'s words: the seed's high and low
    halves."""
    return (torch.tensor((seed >> 32) & _M32, dtype=torch.int64,
                         device=device),
            torch.tensor(seed & _M32, dtype=torch.int64, device=device))


def key_uniform(seed: int, shape: Sequence[int], *, device) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape)``: float32 in
    [0, 1), bit-exact."""
    bits = random_bits(*_key(seed, device), shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def key_randint(seed: int, shape: Sequence[int], minval: int, maxval: int,
                *, device) -> torch.Tensor:
    """``jax.random.randint(jax.random.PRNGKey(seed), shape, minval,
    maxval)`` (int32), bit-exact: the key splits in two (the partitionable
    split: the key hashed with the counts (0, 0) and (0, 1)), each half
    draws 32 bits an element, and the pair folds into [minval, maxval)
    through JAX's uint32 remainders."""
    k1, k2 = _key(seed, device)
    zero = torch.zeros(2, dtype=torch.int64, device=device)
    s1, s2 = threefry2x32(k1, k2, zero, torch.arange(2, device=device))
    higher = random_bits(s1[0], s2[0], shape)
    lower = random_bits(s1[1], s2[1], shape)
    span = max(int(maxval) - int(minval), 1) & _M32
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    offset = (((higher % span) * mult) & _M32) + lower % span
    offset = (offset & _M32) % span
    return (offset + int(minval)).to(torch.int32)


#: XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"):
#: polynomial coefficients in w = -log1p(-x^2), for w < 5 and w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.erfinv`` in float32 as XLA computes it (its
    polynomial, within 2 ulps of XLA's result: log1p and the order of
    rounding differ), not torch's more exact ``erfinv``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def key_normal(seed: int, shape: Sequence[int], dtype=torch.float32, *,
               device) -> torch.Tensor:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)`` for
    float32 and bfloat16: JAX's uniform draw in (-1, 1) bit for bit, then
    ``sqrt(2) * erfinv(u)`` through XLA's polynomial (float32 within a few
    ulps of JAX's; bf16 draws 8 bits an element, as JAX's does, and rounds
    to bf16 after each operation)."""
    bits = random_bits(*_key(seed, device), shape)
    f32, bf = torch.float32, torch.bfloat16
    sqrt2 = torch.tensor(2.0 ** 0.5, dtype=f32, device=device)
    if dtype == f32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(f32)
        lo = torch.tensor(-1.0, device=device).nextafter(
            torch.tensor(0.0, device=device))
        u = torch.maximum((f - 1.0) * (1.0 - lo) + lo, lo)
        return _erfinv_f32(u) * sqrt2
    if dtype != bf:
        raise TypeError(f"key_normal: {dtype} (float32 or bfloat16)")

    def r(x):                         # round to bf16, go on in fp32
        return x.to(bf).to(f32)

    f = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(bf).to(f32)
    lo = r(torch.tensor(-1.0, dtype=bf, device=device).nextafter(
        torch.tensor(0.0, dtype=bf, device=device)).to(f32))
    u = torch.maximum(r(r(r(f - 1.0) * r(1.0 - lo)) + lo), lo)
    return (r(_erfinv_f32(u)) * r(sqrt2)).to(bf)


# ---------------------------------------------------------------------------
# atoi / strtod: numeric parsing on the device
# ---------------------------------------------------------------------------

_ZERO, _NINE, _MINUS, _PLUS, _DOT, _E, _EU = 48, 57, 45, 43, 46, 101, 69


def _is_digit(c: torch.Tensor) -> torch.Tensor:
    return (c >= _ZERO) & (c <= _NINE)


def _sign(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(negative, index of the first character after the sign)."""
    neg = buf[0] == _MINUS
    return neg, (neg | (buf[0] == _PLUS)).to(torch.int64)


def atoi(buf: torch.Tensor) -> torch.Tensor:
    """Parse an int from a uint8 code buffer (an optional sign, then
    digits up to the first non-digit; no leading white space).  Returns
    int32, wrapping as the JAX version's int32 scan does.

    Vectorised: digit d at place p (counted from the last digit taken)
    contributes ``d * (10**p mod 2**32)``, and the sum mod 2**32 is the
    scan's wrapped int32, since the scan's Horner steps are exact mod 2**32
    too."""
    buf = buf.to(torch.int64)
    n = buf.shape[0]
    neg, start = _sign(buf)
    i = torch.arange(n, device=buf.device)
    after = i >= start
    stopped = torch.cumsum((after & ~_is_digit(buf)).to(torch.int64), 0) > 0
    taken = after & ~stopped
    place = taken.sum() - torch.cumsum(taken.to(torch.int64), 0)
    pow10 = torch.tensor([pow(10, p, 1 << 32) for p in range(n)],
                         dtype=torch.int64, device=buf.device)
    terms = torch.where(taken, (buf - _ZERO) * pow10[place.clamp(0, n - 1)],
                        0)
    val = terms.sum() & _M32
    val = torch.where(neg, (-val) & _M32, val)
    return torch.where(val >= 1 << 31, val - (1 << 32), val).to(torch.int32)


def strtod(buf: torch.Tensor) -> torch.Tensor:
    """Parse a decimal float (optional sign, fraction, e-exponent) from a
    uint8 code buffer.  Returns float32.

    The mantissa accumulates in float32 in character order, ``m * 10 + d``
    rounded after each product and each sum, and the result is ``m *
    10**exp`` in float32, as the JAX version computes it (its XLA ``pow``
    may round 10**exp one ulp apart from torch's).  One step of tensor ops
    per character: the buffer is short and the chain is sequential."""
    buf = buf.to(torch.int32)
    n = buf.shape[0]
    dev = buf.device
    neg, start = _sign(buf)

    def flag():
        return torch.zeros((), dtype=torch.bool, device=dev)

    mant = torch.zeros((), dtype=torch.float32, device=dev)
    frac_digits = torch.zeros((), dtype=torch.int32, device=dev)
    exp_val = torch.zeros((), dtype=torch.int32, device=dev)
    in_frac, in_exp, exp_neg, done = flag(), flag(), flag(), flag()
    for i in range(n):
        c = buf[i]
        active = ~done & (start <= i)
        is_d = _is_digit(c)
        is_e = (c == _E) | (c == _EU)
        is_sign = (c == _MINUS) | (c == _PLUS)
        take_mant = active & is_d & ~in_exp
        mant = torch.where(take_mant, mant * 10.0 + (c - _ZERO), mant)
        frac_digits = frac_digits + (take_mant & in_frac).to(torch.int32)
        exp_val = torch.where(active & is_d & in_exp,
                              exp_val * 10 + (c - _ZERO), exp_val)
        in_frac = in_frac | (active & (c == _DOT) & ~in_frac & ~in_exp)
        in_exp = in_exp | (active & is_e)
        exp_neg = exp_neg | (active & in_exp & (c == _MINUS))
        done = done | (active & ~(is_d | (c == _DOT) | is_e
                                  | (is_sign & in_exp)))
    exp = torch.where(exp_neg, -exp_val, exp_val) - frac_digits
    ten = torch.full((), 10.0, dtype=torch.float32, device=dev)
    val = mant * torch.pow(ten, exp.to(torch.float32))
    return torch.where(neg, -val, val)


# ---------------------------------------------------------------------------
# realloc: allocator-integrated
# ---------------------------------------------------------------------------

def realloc(state, arena: torch.Tensor, ptr, new_size, *, tid=0, team=0):
    """malloc new, copy min(old, new) elements, free old.  Returns
    ``(state, arena, ptr')``.

    The allocator comes from the state's type (``allocator_for``); a
    balanced heap allocates from ``chunk_of(tid, team)``.  Where the old
    object is not found or the new allocation fails, the arena and the old
    object stay as they were (``ptr'`` is then the malloc's result).
    Elements past the old size are whatever the new region held (as in
    C)."""
    A = allocator_for(state)
    dev = arena.device
    ptr = as_i32(ptr, dev)
    new_size = as_i32(new_size, dev)
    found, _, old_size = A.find_obj(state, ptr)
    if isinstance(state, BalancedState):
        grown, new_ptr = A.malloc(state, tid, team, new_size)
    else:
        grown, new_ptr = A.malloc(state, new_size)
    ok = found & (new_ptr >= 0)
    n = arena.shape[0]
    idx = torch.arange(n, device=dev)
    off = idx - new_ptr
    moved = (off >= 0) & (off < torch.minimum(old_size, new_size))
    src = (ptr + off).clamp(0, n - 1).long()
    arena = torch.where(ok & moved, arena[src], arena)
    freed = A.free(grown, ptr)
    fields = [f.name for f in dataclasses.fields(state)
              if isinstance(getattr(state, f.name), torch.Tensor)]
    state = dataclasses.replace(grown, **{
        f: torch.where(ok, getattr(freed, f), getattr(grown, f))
        for f in fields})
    return state, arena, new_ptr


# ---------------------------------------------------------------------------
# LogRing: buffered device-side logging, flushed by one RPC
# ---------------------------------------------------------------------------

_LOG_SINK = "logring.sink"


@dataclasses.dataclass
class LogRing:
    """Buffered device-side logging on the batched queue: records ``(tag
    int32, value float32[, payload array])`` addressed to the ring's sink
    callee ``name``; ``log()`` is an enqueue, ``flush()`` the queue's flush
    (records replayed in order).  A ``sink`` passed to ``flush`` serves
    that flush alone.  The queue is updated in place."""
    q: RpcQueue
    name: str = _LOG_SINK

    @property
    def tags(self) -> torch.Tensor:
        return self.q.ivals[..., 0]

    @property
    def values(self) -> torch.Tensor:
        return self.q.fvals[..., 1]

    @property
    def head(self) -> torch.Tensor:
        return self.q.head

    @staticmethod
    def create(capacity: int = 1024, name: str = _LOG_SINK,
               payload_capacity: int = 1024, retry=None,
               timeout: Optional[float] = None, *,
               device="cuda") -> "LogRing":
        if name not in REGISTRY.hosts:
            # log delivery is retry-safe: at-least-once may duplicate a
            # line, never corrupt state
            REGISTRY.register(name, _default_sink, idempotent=True)
        return LogRing(RpcQueue.create(capacity, width=3,
                                       payload_capacity=payload_capacity,
                                       retry=retry, timeout=timeout,
                                       device=device), name)

    @staticmethod
    def create_sharded(n_devices: int, capacity: int = 1024,
                       name: str = _LOG_SINK, payload_capacity: int = 1024,
                       retry=None, timeout: Optional[float] = None, *,
                       device="cuda") -> "LogRing":
        """One ring shard a device, on the sharded queue: log through a
        shard's ring (``LogRing(ring.q.local(d), ring.name)`` or, for one
        device, :meth:`local_view`); :meth:`flush` drains every shard in
        ``(device, slot)`` order."""
        if name not in REGISTRY.hosts:
            REGISTRY.register(name, _default_sink, idempotent=True)
        return LogRing(ShardedRpcQueue.create(
            n_devices, capacity, width=3, payload_capacity=payload_capacity,
            retry=retry, timeout=timeout, device=device), name)

    @property
    def device(self) -> torch.device:
        return self.q.device

    def local_view(self) -> "LogRing":
        """The ring of a one-row sharded ring's shard (a team's block in an
        expanded region)."""
        return LogRing(self.q.local_view(), self.name)

    def with_local(self, local: "LogRing") -> "LogRing":
        """Inverse of :meth:`local_view`."""
        return LogRing(self.q.with_local(local.q), self.name)

    def team_local(self, dev: int) -> "LogRing":
        """Team ``dev``'s ring of a sharded ring (see
        ``ShardedRpcQueue.team_local``)."""
        return LogRing(self.q.team_local(dev), self.name)

    def gathered(self, local: "LogRing", mesh) -> "LogRing":
        """Every team's ``local`` ring written back (see
        ``ShardedRpcQueue.gathered``); returns the ring."""
        self.q.gathered(local.q, mesh)
        return self

    def log(self, tag, value, payload=None, where=None) -> "LogRing":
        """Append one record (the oldest is overwritten when the ring is
        full); ``payload`` (any shape) reaches the sink as a third
        argument, 1-D; ``where`` makes the append conditional."""
        args = (_as_lane(tag, torch.int32), _as_lane(value, torch.float32))
        if payload is not None:
            args += (payload,)
        self.q.enqueue(self.name, *args, where=where)
        return self

    def flush(self, sink: Optional[Callable] = None) -> "LogRing":
        """One round trip drains the ring to the host, in enqueue order;
        ``sink`` serves this flush alone (by default the registry's
        binding of ``name``)."""
        self.q.flush({self.name: sink} if sink is not None else None)
        return self


def _as_lane(x, dtype: torch.dtype):
    """``x`` as JAX's ``jnp.asarray(x, dtype)``: a tensor cast on its
    device, a number as the Python number of that lane."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    if dtype == torch.int32:
        return int(np.asarray(x).astype(np.int32))
    return float(np.float32(x))


_LOG_LINES: List[tuple] = []


def _default_sink(tag: int, value: float, payload=None):
    if payload is None:
        _LOG_LINES.append((int(tag), float(value)))
    else:
        _LOG_LINES.append((int(tag), float(value), np.asarray(payload)))


REGISTRY.register(_LOG_SINK, _default_sink, idempotent=True)


def drain_log_lines():
    out = list(_LOG_LINES)
    _LOG_LINES.clear()
    return out


# ---------------------------------------------------------------------------
# fprintf / fwrite: buffered formatted and binary output
# ---------------------------------------------------------------------------

#: Interned format strings (and remote-heap names): a record carries only
#: the id, the stable 31-bit content hash of the string (JAX's).
_FMT_TABLE: Dict[int, str] = {}
_FMT_IDS: Dict[str, int] = {}

_PRINTF_LINES: List[str] = []
_WRITE_STREAMS: Dict[int, List[np.ndarray]] = {}


def _intern_fmt(fmt: str) -> int:
    fid = _FMT_IDS.get(fmt)
    if fid is None:
        fid = stable_format_id(fmt)
        other = _FMT_TABLE.get(fid)
        if other is not None and other != fmt:
            raise RuntimeError(
                f"interned-string id collision: {fmt!r} and {other!r} both "
                f"hash to {fid}; reword one of them")
        _FMT_TABLE[fid] = fmt
        _FMT_IDS[fmt] = fid
    return fid


def _resolve_fmt(fid: int) -> str:
    fmt = _FMT_TABLE.get(int(fid))
    if fmt is None:
        raise KeyError(
            f"unknown interned-string id {int(fid)}: this process never "
            "interned it; a program issued elsewhere must ship its "
            "RpcManifest (carrying the format table) and the server must "
            "adopt_manifest() it before draining")
    return fmt


def _export_fmt_table() -> Dict[int, str]:
    return dict(_FMT_TABLE)


def _adopt_fmt_table(table: Dict[int, str]) -> None:
    """Restore a manifest's format table: every id must be its string's
    content hash and agree with what this process interned."""
    for fid, fmt in table.items():
        fid = int(fid)
        want = stable_format_id(fmt)
        if want != fid:
            raise ValueError(
                f"manifest format id {fid} ({fmt!r}) does not match its "
                f"content hash {want}")
        other = _FMT_TABLE.get(fid)
        if other is not None and other != fmt:
            raise ValueError(
                f"manifest format id {fid} ({fmt!r}) is already interned "
                f"as {other!r} in this process")
    for fid, fmt in table.items():
        _FMT_TABLE[int(fid)] = fmt
        _FMT_IDS[fmt] = int(fid)


register_format_section(_export_fmt_table, _adopt_fmt_table)


def _fprintf_sink(fid, *args):
    fmt = _resolve_fmt(fid)
    coerced = tuple(a if isinstance(a, (int, float)) else np.asarray(a)
                    for a in args)
    _PRINTF_LINES.append(fmt % coerced)      # zero args still resolves %%


def _fwrite_sink(stream, data):
    _WRITE_STREAMS.setdefault(int(stream), []).append(np.asarray(data))


# output sinks are retry-safe as the log sink is: a redriven record appends
# a duplicate line or chunk
REGISTRY.register("libc.fprintf", _fprintf_sink, idempotent=True)
REGISTRY.register("libc.fwrite", _fwrite_sink, idempotent=True)


def fprintf(q: RpcQueue, fmt: str, *args, where=None) -> RpcQueue:
    """Buffered ``fprintf`` from device code: one enqueue, no host contact
    until the queue flushes.  ``fmt`` is a Python ``%``-format string
    (interned; the record ships its id); ``args`` are scalars and arrays
    (arrays ride the payload arena and format via ``%s``).  Read the lines
    with :func:`drain_printf` after the flush (on a card after
    ``effects_barrier()``)."""
    return q.enqueue("libc.fprintf", _intern_fmt(fmt), *args, where=where)


def fwrite(q: RpcQueue, data, stream: int = 0, where=None) -> RpcQueue:
    """Buffered binary write: ``data`` (any shape; delivered as 1-D int32
    or float32) rides the payload arena and is appended to host stream
    ``stream`` at the flush.  Read back with :func:`drain_fwrite`."""
    return q.enqueue("libc.fwrite", int(stream), data, where=where)


def drain_printf() -> List[str]:
    """Formatted lines of the flushed ``fprintf`` records."""
    out = list(_PRINTF_LINES)
    _PRINTF_LINES.clear()
    return out


def drain_fwrite(stream: int = 0) -> np.ndarray:
    """Every chunk written to ``stream``, concatenated (empty int32 when
    nothing was); a stream that mixes int and float chunks raises and
    keeps its data."""
    chunks = _WRITE_STREAMS.get(stream, [])
    if not chunks:
        return np.zeros((0,), np.int32)
    dtypes = {c.dtype for c in chunks}
    if len(dtypes) > 1:
        raise ValueError(
            f"fwrite stream {stream} mixes dtypes {sorted(map(str, dtypes))};"
            " write int and float data to separate streams")
    _WRITE_STREAMS.pop(stream, None)
    return np.concatenate(chunks)


# ---------------------------------------------------------------------------
# fread / fgets: buffered input through the reply arena
# ---------------------------------------------------------------------------

#: Host input streams: id -> {"buf": 1-D numpy array, "pos"}; text as
#: uint8 codes widened to int32, numbers as int32 or float32.
_READ_STREAMS: Dict[int, Dict] = {}


def fread_feed(stream: int, data, reset: bool = False) -> None:
    """Bind host input for :func:`fread`/:func:`fgets` on ``stream``:
    ``bytes``/``str`` (character codes, which :func:`atoi`/:func:`strtod`
    parse) or an array (ints as int32, floats as float32); appended unless
    ``reset``.  One dtype a stream."""
    if isinstance(data, str):
        data = data.encode()
    if isinstance(data, (bytes, bytearray)):
        arr = np.frombuffer(bytes(data), np.uint8).astype(np.int32)
    else:
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu()
            data = (data.float() if data.is_floating_point() else data).numpy()
        arr = np.asarray(data).reshape(-1)
        arr = (arr.astype(np.float32)
               if np.issubdtype(arr.dtype, np.floating)
               else arr.astype(np.int32))
    st = _READ_STREAMS.get(int(stream))
    if st is None or reset:
        _READ_STREAMS[int(stream)] = {"buf": arr, "pos": 0}
        return
    if st["buf"].dtype != arr.dtype:
        raise ValueError(
            f"fread stream {int(stream)} holds {st['buf'].dtype}; feeding "
            f"{arr.dtype} would mix dtypes; use one stream per dtype")
    st["buf"] = np.concatenate([st["buf"][st["pos"]:], arr])
    st["pos"] = 0


def _fread_sink(stream, n):
    st = _READ_STREAMS.get(int(stream))
    if st is None:
        return None                       # unknown stream: reads as zeros
    take = st["buf"][st["pos"]:st["pos"] + int(n)]
    st["pos"] += len(take)
    return take                           # short read: the drain zero-pads


def _fgets_sink(stream, n):
    st = _READ_STREAMS.get(int(stream))
    if st is None:
        return None
    window = st["buf"][st["pos"]:st["pos"] + int(n)]
    nl = np.nonzero(window == 10)[0]      # stop after the first newline
    k = int(nl[0]) + 1 if len(nl) else len(window)
    st["pos"] += k
    return window[:k]


# not retry-safe: each call advances the stream's cursor
REGISTRY.register("libc.fread", _fread_sink)
REGISTRY.register("libc.fgets", _fgets_sink)


def fread(q: RpcQueue, n: int, stream: int = 0, dtype=torch.int32,
          where=None) -> Tuple[RpcQueue, torch.Tensor]:
    """Buffered ``fread``: enqueue a request for ``n`` elements of host
    stream ``stream`` (fed by :func:`fread_feed`); returns ``(queue,
    ticket)``.  After the flush ``q.result(ticket, (n,), dtype)`` holds
    them, zero-padded when the stream ran short.  Needs ``reply_capacity
    >= n``."""
    n = int(n)
    return q.enqueue_ticketed("libc.fread", int(stream), n,
                              returns=ShapeDtype((n,), dtype), where=where)


def fgets(q: RpcQueue, n: int, stream: int = 0, where=None
          ) -> Tuple[RpcQueue, torch.Tensor]:
    """Buffered ``fgets``: up to ``n`` character codes of ``stream``
    through the first newline (kept), zero-padded; returns ``(queue,
    ticket)``, read as ``q.result(ticket, (n,), torch.int32)``."""
    n = int(n)
    return q.enqueue_ticketed("libc.fgets", int(stream), n,
                              returns=ShapeDtype((n,), torch.int32),
                              where=where)


# ---------------------------------------------------------------------------
# Remote malloc: bulk size vectors ride the payload arena
# ---------------------------------------------------------------------------

#: Host-side heaps serving remote-malloc records: name -> allocator state
#: (on the host), and the pointer vectors each flush returned.
_REMOTE_HEAPS: Dict[str, object] = {}
_REMOTE_PTRS: Dict[str, List[np.ndarray]] = {}


def _remote_malloc_sink(name_id, dev, sizes):
    """Serve one remote-malloc record: bulk-allocate ``sizes`` from heap
    ``name_id`` (``malloc_many``) and return the pointers (the reply).  A
    :class:`ShardedHeap`'s record allocates from shard ``dev`` and returns
    global pointers; a ``dev`` outside the heap fails only its record
    (all FAIL, with a warning), as JAX's does."""
    name = _resolve_fmt(name_id)
    state = _REMOTE_HEAPS[name]
    sizes = torch.as_tensor(np.array(sizes, np.int32))
    if isinstance(state, ShardedHeap):
        d = int(dev)
        if not 0 <= d < state.n_devices:
            warnings.warn(
                f"remote malloc on heap {name!r}: device {d} out of range "
                f"for a {state.n_devices}-shard heap; returning FAIL "
                "pointers for this record", RuntimeWarning, stacklevel=2)
            out = np.full((sizes.shape[0],), -1, np.int32)
            _REMOTE_PTRS.setdefault(name, []).append(out)
            return out
        # the one shard's bulk path, written back in place of row d
        shard, local = allocator_for(state.shards).malloc_many(
            state.local(d), sizes)
        for f in dataclasses.fields(shard):
            v = getattr(shard, f.name)
            if isinstance(v, torch.Tensor):
                getattr(state.shards, f.name)[d] = v
        ptrs = ShardedHeap.global_ptr(d, local, state.span)
    else:
        state, ptrs = allocator_for(state).malloc_many(state, sizes)
    _REMOTE_HEAPS[name] = state
    out = ptrs.numpy().astype(np.int32)
    _REMOTE_PTRS.setdefault(name, []).append(out)
    return out


# not retry-safe: a redriven allocation leaks the first block
REGISTRY.register("libc.remote_malloc", _remote_malloc_sink)


def remote_heap_register(name: str, state) -> None:
    """Bind a host-side allocator state (its tensors on the CPU: the drain
    runs it on the host) to serve remote mallocs addressed to ``name``.
    Its allocator must have ``malloc_many`` (generic, size-class or
    sharded)."""
    if not hasattr(allocator_for(state), "malloc_many"):
        raise TypeError(
            f"remote heap {name!r}: {type(state).__name__} has no bulk "
            "malloc_many path; use a Generic/SizeClass/Sharded state")
    inner = state.shards if isinstance(state, ShardedHeap) else state
    for f in dataclasses.fields(inner):
        v = getattr(inner, f.name)
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            raise ValueError(
                f"remote heap {name!r}: {f.name} is on {v.device}; the "
                "heap is served on the host, give it CPU tensors")
    _REMOTE_HEAPS[name] = state


def remote_malloc_enqueue(q: RpcQueue, name: str, sizes, *, device=0,
                          where=None) -> Tuple[RpcQueue, torch.Tensor]:
    """Enqueue one record asking the host to bulk-allocate ``sizes`` (an
    int array, in the payload arena) from the registered heap ``name``;
    returns ``(queue, ticket)``.  On a reply-carrying queue the ticket's
    reply is the pointer vector (``q.result(ticket, (k,), torch.int32)``,
    FAIL pointers -1); otherwise read them with
    :func:`remote_malloc_results`.  Needs ``width >= 3``."""
    if name not in _REMOTE_HEAPS:
        raise KeyError(f"no remote heap registered under {name!r}; call "
                       "remote_heap_register first")
    nid = _intern_fmt(name)
    if not isinstance(sizes, torch.Tensor):
        sizes = torch.as_tensor(np.asarray(sizes, np.int32))
    sizes = sizes.reshape(-1).to(torch.int32)
    returns = (ShapeDtype((sizes.shape[0],), torch.int32)
               if q.reply_capacity else None)
    return q.enqueue_ticketed("libc.remote_malloc", nid,
                              _as_lane(device, torch.int32), sizes,
                              returns=returns, where=where)


def remote_malloc_results(name: str):
    """``(state, [pointer arrays in flush order])`` of heap ``name``;
    clears the pointer log."""
    ptrs = _REMOTE_PTRS.pop(name, [])
    return _REMOTE_HEAPS.get(name), ptrs
