"""The port's device libc (``atoi``, ``strtod``, ``realloc``) against the
JAX package's, on the CPU: ``atoi`` exact (int32 overflow wraps as JAX's
scan does), ``strtod`` within 2 ulp of JAX's (XLA's float32 ``pow`` and
torch's round 10**e apart by an ulp) and within JAX's own bounds of the
true value, ``realloc``'s state field by field and its arena bit for bit."""
import random

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import libc as jlibc  # noqa: E402
from repro.core.allocator import BalancedAllocator as JBA  # noqa: E402
from repro.core.allocator import GenericAllocator as JGA  # noqa: E402
from repro_torch.core import libc as tlibc  # noqa: E402
from repro_torch.core.allocator import (  # noqa: E402
    GENERIC_FIELDS, STATE_FIELDS, BalancedAllocator as TBA,
    GenericAllocator as TGA)

_jatoi = jax.jit(jlibc.atoi)
_jstrtod = jax.jit(jlibc.strtod)


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8).copy()


@pytest.mark.parametrize("s", ["123", "-456x", "0", "+77", "2147483647",
                               "2147483648", "-2147483648", "99999999999",
                               "-98765432109876", "12a34", "x12", "-", "+",
                               "007", "1" * 25])
def test_atoi_exact(s):
    want = int(_jatoi(jnp.asarray(_codes(s))))
    got = tlibc.atoi(torch.from_numpy(_codes(s)))
    assert got.dtype == torch.int32 and int(got) == want


def _ulps(a: np.float32, b: np.float32) -> int:
    ia, ib = (np.array([v], np.float32).view(np.int32)[0].astype(np.int64)
              for v in (a, b))
    ia = ia if ia >= 0 else -(ia & 0x7FFFFFFF)
    ib = ib if ib >= 0 else -(ib & 0x7FFFFFFF)
    return abs(int(ia) - int(ib))


def _check_strtod(s: str, rel: float):
    want = np.float32(_jstrtod(jnp.asarray(_codes(s))))
    got = tlibc.strtod(torch.from_numpy(_codes(s)))
    assert got.dtype == torch.float32
    got = np.float32(got)
    assert _ulps(got, want) <= 2, (s, got, want)
    assert abs(float(got) - float(s)) <= rel * max(abs(float(s)), 1.0)


@pytest.mark.parametrize("s", ["3.14159", "-12.5e-2", "1e3", "0.001",
                               "-7", "2.5E2", "6.02e23", "1.5e-22"])
def test_strtod_within_two_ulp_of_jax(s):
    _check_strtod(s, 1e-4)


@pytest.mark.parametrize("seed", range(12))
def test_strtod_property_within_two_ulp_of_jax(seed):
    rng = random.Random(seed)
    for _ in range(4):
        _check_strtod(f"{rng.uniform(-1e4, 1e4):.4f}", 2e-3)


def _same(jst, tst, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      getattr(tst, f).numpy(), err_msg=f)


def test_realloc_grows_and_preserves_like_jax():
    """tests/test_core.py's case: grow 4 -> 8, the data moves, the old
    region is freed and the next malloc of 4 reuses it."""
    jst, jp = JGA.malloc(JGA.init(64, cap=8), 4)
    tst, tp = TGA.malloc(TGA.init(64, cap=8, device="cpu"), 4)
    arena = np.zeros(64, np.float32)
    arena[:4] = np.arange(4) + 1
    jst, jarena, jp2 = jlibc.realloc(jst, jnp.asarray(arena), jp, 8)
    tst, tarena, tp2 = tlibc.realloc(tst, torch.from_numpy(arena), tp, 8)
    _same(jst, tst, GENERIC_FIELDS)
    np.testing.assert_array_equal(tarena.numpy(), np.asarray(jarena))
    assert int(tp2) == int(jp2) != int(tp)
    np.testing.assert_array_equal(tarena.numpy()[int(tp2):int(tp2) + 4],
                                  [1, 2, 3, 4])
    jst, jp3 = JGA.malloc(jst, 4)
    tst, tp3 = TGA.malloc(tst, 4)
    assert int(tp3) == int(jp3) == int(tp)


@pytest.mark.parametrize("seed", range(4))
def test_realloc_sequences_match_jax(seed):
    """Shrink, grow, wild pointers and exhaustion (malloc fails: nothing
    moves) on the generic heap and on a balanced one."""
    rng = np.random.default_rng(seed)
    heaps = [
        (JGA.init(48, cap=6), TGA.init(48, cap=6, device="cpu"),
         GENERIC_FIELDS, JGA.malloc, TGA.malloc),
        (JBA.init(96, 2, 2, cap=4, first_chunk_ratio=2.0),
         TBA.init(96, 2, 2, cap=4, first_chunk_ratio=2.0, device="cpu"),
         STATE_FIELDS, lambda s, n: JBA.malloc(s, 1, 0, n),
         lambda s, n: TBA.malloc(s, 1, 0, n)),
    ]
    for jst, tst, fields, jmalloc, tmalloc in heaps:
        arena = rng.standard_normal(96).astype(np.float32)
        jarena, tarena = jnp.asarray(arena), torch.from_numpy(arena)
        live = []
        for _ in range(12):
            if not live or rng.random() < 0.3:
                size = int(rng.integers(1, 10))
                jst, jp = jmalloc(jst, size)
                tst, tp = tmalloc(tst, size)
                assert int(jp) == int(tp)
                if int(tp) >= 0:
                    live.append(int(tp))
                continue
            ptr = int(rng.choice(live)) if rng.random() < 0.8 else 95
            new = int(rng.integers(1, 14))
            jst, jarena, jp = jlibc.realloc(jst, jarena, ptr, new, tid=1)
            tst, tarena, tp = tlibc.realloc(tst, tarena, ptr, new, tid=1)
            assert int(jp) == int(tp)
            _same(jst, tst, fields)
            np.testing.assert_array_equal(tarena.numpy(), np.asarray(jarena))
            if ptr in live and int(tp) >= 0:
                live.remove(ptr)
                live.append(int(tp))


def test_key_uniform_is_jax_random_uniform():
    for seed in (0, 1, 42):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (5, 7)))
        got = tlibc.key_uniform(seed, (5, 7), device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
