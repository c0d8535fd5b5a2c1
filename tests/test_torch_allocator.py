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


# ---------------------------------------------------------------------------
# Single-request ops: the generic heap and the balanced page heap
# ---------------------------------------------------------------------------

from repro.core.allocator import GenericAllocator as JaxGeneric  # noqa: E402
from repro_torch.core.allocator import (  # noqa: E402
    GENERIC_FIELDS, GenericAllocator, allocator_for, find_obj)

_jg_malloc = jax.jit(JaxGeneric.malloc)
_jg_free = jax.jit(JaxGeneric.free)
_jg_find = jax.jit(JaxGeneric.find_obj)
_jg_many = jax.jit(JaxGeneric.malloc_many)
_jb_malloc = jax.jit(JaxBalanced.malloc)
_jb_free = jax.jit(JaxBalanced.free)
_jb_find = jax.jit(JaxBalanced.find_obj)


def _same_generic(jst, tst):
    for f in GENERIC_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      getattr(tst, f).numpy(), err_msg=f)
    assert jst.heap_size == tst.heap_size


def _same_found(jout, tout):
    jf, jb, js = (np.asarray(x) for x in jout)
    tf, tb, ts = (x.numpy() for x in tout)
    np.testing.assert_array_equal(jf, tf)
    # base and size mean something only where found
    if jf:
        assert (jb, js) == (tb, ts)


def _pick_ptr(rng, live, heap):
    """A pointer to free or look up: live bases, interiors, freed and
    wild pointers (negative, past the heap, FAIL)."""
    r = rng.random()
    if live and r < 0.5:
        return int(rng.choice(live)) + (int(rng.integers(0, 3))
                                         if r < 0.15 else 0)
    return int(rng.choice([-1, -7, heap, heap + 5, rng.integers(0, heap)]))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("heap,cap", [(64, 8), (40, 4), (200, 16)])
def test_generic_sequence_matches_jax(seed, heap, cap):
    """malloc / free / find_obj / malloc_many in a seeded order, with
    exhaustion (bytes and entries), first-fit reuse of freed entries, size
    0 and negative requests, double and wild frees: every state field and
    every returned pointer bit for bit."""
    rng = np.random.default_rng(seed)
    jst = JaxGeneric.init(heap, cap=cap)
    tst = GenericAllocator.init(heap, cap=cap, device="cpu")
    _same_generic(jst, tst)
    live, saw = [], {"fail": False, "reuse": False}
    for _ in range(40):
        op = rng.random()
        if op < 0.45:
            size = int(rng.integers(-1, 13))
            wm = int(tst.watermark)
            jst, jp = _jg_malloc(jst, np.int32(size))
            tst, tp = GenericAllocator.malloc(tst, size)
            assert int(jp) == int(tp)
            if int(jp) >= 0:
                saw["reuse"] |= int(jp) < wm
                live.append(int(jp))
            saw["fail"] |= int(jp) == FAIL and size > 0
        elif op < 0.75:
            p = _pick_ptr(rng, live, heap)
            jst = _jg_free(jst, np.int32(p))
            tst = GenericAllocator.free(tst, torch.tensor(p, dtype=torch.int32))
            if p in live:
                live.remove(p)
        elif op < 0.9:
            p = _pick_ptr(rng, live, heap)
            _same_found(_jg_find(jst, np.int32(p)),
                        GenericAllocator.find_obj(tst, p))
        else:
            sizes = rng.integers(-1, 9, size=int(rng.integers(1, 6))
                                 ).astype(np.int32)
            jst, jp = _jg_many(jst, jnp.asarray(sizes))
            tst, tp = GenericAllocator.malloc_many(tst,
                                                   torch.from_numpy(sizes))
            np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
            live.extend(int(p) for p in np.asarray(jp) if p >= 0)
        _same_generic(jst, tst)
    assert saw["reuse"] and (saw["fail"] or heap == 200), saw


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("heap,N,M,cap", [(120, 2, 2, 4), (64, 4, 1, 8)])
def test_balanced_single_ops_match_jax(seed, heap, N, M, cap):
    """The page heap's single-request malloc (stack top, else first freed
    entry large enough), free (with the suffix reclaim of the stack top)
    and find_obj, against JAX's, bit for bit."""
    rng = np.random.default_rng(100 + seed)
    jst = JaxBalanced.init(heap, N, M, cap=cap, first_chunk_ratio=2.0)
    tst = BalancedAllocator.init(heap, N, M, cap=cap, first_chunk_ratio=2.0,
                                 device="cpu")
    live = []
    for _ in range(40):
        op = rng.random()
        if op < 0.5:
            tid, team = int(rng.integers(0, 2 * N)), int(rng.integers(0, 3))
            size = int(rng.integers(-1, 14))
            jst, jp = _jb_malloc(jst, np.int32(tid), np.int32(team),
                                 np.int32(size))
            tst, tp = BalancedAllocator.malloc(tst, tid, team, size)
            assert int(jp) == int(tp)
            if int(jp) >= 0:
                live.append(int(jp))
        elif op < 0.8:
            p = _pick_ptr(rng, live, heap)
            jst = _jb_free(jst, np.int32(p))
            tst = BalancedAllocator.free(tst, p)
            if p in live:
                live.remove(p)
        else:
            p = _pick_ptr(rng, live, heap)
            _same_found(_jb_find(jst, np.int32(p)),
                        BalancedAllocator.find_obj(tst, p))
        _same_state(jst, tst)


def test_allocator_for_dispatches_by_state_type():
    g = GenericAllocator.init(32, cap=4, device="cpu")
    b = BalancedAllocator.init(32, 2, 1, cap=4, device="cpu")
    assert allocator_for(g) is GenericAllocator
    assert allocator_for(b) is BalancedAllocator
    g, p = GenericAllocator.malloc(g, 5)
    found, base, size = find_obj(g, p + 2)
    assert (bool(found), int(base), int(size)) == (True, int(p), 5)
    with pytest.raises(TypeError):
        allocator_for(object())
    from repro_torch.core.allocator import (
        ShardedAllocator, SizeClassAllocator, shard_heap)
    s = SizeClassAllocator.init(32, cap=4, device="cpu")
    assert allocator_for(s) is SizeClassAllocator     # item 3.6 is ported
    assert allocator_for(shard_heap(g, 2)) is ShardedAllocator
