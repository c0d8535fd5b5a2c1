"""Port's balanced allocator against the JAX package's, bit for bit: every
state field and every returned pointer, over sequences of grid allocations
(with size-0 skips, negative sizes and exhaustion) and bulk chunk resets."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.allocator import BalancedAllocator as JaxBalanced  # noqa: E402
from repro_torch.core.allocator import (  # noqa: E402
    DEAD, FAIL, STATE_FIELDS, BalancedAllocator)

_jax_malloc_grid = jax.jit(JaxBalanced.malloc_grid, static_argnums=(1, 2))
_jax_reset_chunks = jax.jit(JaxBalanced.reset_chunks)


def _same_state(jst, tst):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      getattr(tst, f).numpy(), err_msg=f)
    assert (jst.n_slots, jst.m_slots) == (tst.n_slots, tst.m_slots)


@pytest.mark.parametrize("heap,N,M,cap,ratio", [
    (1000, 4, 2, 16, 4.0),
    (64, 4, 1, 8, 1.0),          # the engine's page heap (one chunk per slot)
    (37, 3, 3, 5, 2.5),          # uneven split, rounding absorbed by the last
])
def test_init_matches_jax(heap, N, M, cap, ratio):
    jst = JaxBalanced.init(heap, N, M, cap=cap, first_chunk_ratio=ratio)
    tst = BalancedAllocator.init(heap, N, M, cap=cap,
                                 first_chunk_ratio=ratio, device="cpu")
    _same_state(jst, tst)
    assert FAIL == -1 and DEAD == np.iinfo(np.int32).max


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("heap,N,M,cap,T,G", [
    (200, 4, 2, 6, 8, 4),        # 4 requests per chunk
    (48, 4, 1, 12, 4, 1),        # engine grid (B, 1): one request per chunk
    (30, 2, 2, 3, 6, 2),         # small chunks: exhaustion by bytes and count
])
def test_malloc_grid_and_reset_sequence_matches_jax(seed, heap, N, M, cap,
                                                    T, G):
    rng = np.random.default_rng(seed)
    jst = JaxBalanced.init(heap, N, M, cap=cap, first_chunk_ratio=2.0)
    tst = BalancedAllocator.init(heap, N, M, cap=cap, first_chunk_ratio=2.0,
                                 device="cpu")
    saw_fail = False
    for _ in range(8):
        if rng.random() < 0.25:
            mask = rng.random(N * M) < 0.5
            jst = _jax_reset_chunks(jst, jnp.asarray(mask))
            tst = BalancedAllocator.reset_chunks(tst, torch.from_numpy(mask))
        else:
            sizes = rng.integers(-1, 9, size=(T, G)).astype(np.int32)
            sizes[rng.random((T, G)) < 0.2] = 0          # size-0 skips
            jst, jp = _jax_malloc_grid(jst, T, G, jnp.asarray(sizes))
            tst, tp = BalancedAllocator.malloc_grid(tst, T, G,
                                                    torch.from_numpy(sizes))
            np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
            saw_fail |= bool(np.any((np.asarray(jp) == FAIL) & (sizes > 0)))
        _same_state(jst, tst)
    assert saw_fail or seed > 0     # seed 0 exhausts some chunk


def test_chunk_of_matches_jax():
    jst = JaxBalanced.init(100, 4, 3, cap=4)
    tst = BalancedAllocator.init(100, 4, 3, cap=4, device="cpu")
    tid = np.arange(-3, 10, dtype=np.int32)
    team = np.arange(13, dtype=np.int32) * 5 - 7
    np.testing.assert_array_equal(
        np.asarray(JaxBalanced.chunk_of(jst, jnp.asarray(tid),
                                        jnp.asarray(team))),
        BalancedAllocator.chunk_of(tst, torch.from_numpy(tid),
                                   torch.from_numpy(team)).numpy())
