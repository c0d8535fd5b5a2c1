"""Partial device libc (paper §3.4), ported so far: ``rand``.

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
The rest of the JAX libc (``strtod``, ``LogRing``, ``fprintf``, ``fread``,
remote malloc) comes with the RPC transport (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

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
