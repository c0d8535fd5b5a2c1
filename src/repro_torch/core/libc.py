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
type names; none of them reads a value back to the host.  The rest of the
JAX libc (``LogRing``, ``fprintf``, ``fwrite``, ``fread``, ``fgets``,
remote malloc) rides the batched RPC queue (ROADMAP queue 1, item 3.2).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

from repro_torch.core.allocator import BalancedState, allocator_for, as_i32

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


def key_uniform(seed: int, shape: Sequence[int], *, device) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape)``: float32 in
    [0, 1), bit-exact (the key's words are the seed's high and low
    halves)."""
    k1 = torch.tensor((seed >> 32) & _M32, dtype=torch.int64, device=device)
    k2 = torch.tensor(seed & _M32, dtype=torch.int64, device=device)
    bits = random_bits(k1, k2, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


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
