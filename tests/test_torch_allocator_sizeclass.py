"""Port's size-class heap, bulk frees, serial and grid-scan paths and the
linear lookup, against the JAX package's, bit for bit.

Every operation runs on both packages' states (CPU tensors on the port's
side) and every state field and returned pointer is compared after it:
the cases of tests/test_allocator.py and the seeded size-class properties
of tests/test_allocator_properties.py, plus seeded churns.  The class
bins are JAX's uint32 words, held in int64 by the port."""
import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import allocator as J  # noqa: E402
from repro_torch.core import allocator as T  # noqa: E402

HEAP = 512


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_state(js, ts):
    for f in T._tensor_fields(ts):
        a = np.asarray(getattr(js, f))
        if f == "free_bits":
            a = a.astype(np.int64)
        np.testing.assert_array_equal(a, _np(getattr(ts, f)), err_msg=f)
    for f in ("heap_size", "n_slots", "m_slots"):
        assert getattr(js, f, None) == getattr(ts, f, None)


class Both:
    """One allocator in both packages; each call runs in both, compares
    the states and the results, and returns the port's result."""

    def __init__(self, name, *init_args, **init_kw):
        self.J, self.T = getattr(J, name), getattr(T, name)
        self.js = self.J.init(*init_args, **init_kw)
        self.ts = self.T.init(*init_args, device="cpu", **init_kw)
        _same_state(self.js, self.ts)

    def __getattr__(self, op):
        jf, tf = getattr(self.J, op), getattr(self.T, op)

        def call(*args):
            jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                     for a in args]
            targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                     for a in args]
            jo, to = jf(self.js, *jargs), tf(self.ts, *targs)
            jr = tr = None
            if dataclasses.is_dataclass(to):             # a state
                self.js, self.ts = jo, to
            elif dataclasses.is_dataclass(to[0]):        # (state, ptrs)
                (self.js, jr), (self.ts, tr) = jo, to
            else:                                        # a lookup
                jr, tr = jo, to
            _same_state(self.js, self.ts)
            if jr is None:
                return None
            if op == "find_obj":
                assert bool(jr[0]) == bool(tr[0])
                if bool(jr[0]):
                    assert [int(x) for x in jr] == [int(x) for x in tr]
                return tr
            np.testing.assert_array_equal(np.asarray(jr), _np(tr))
            return tr

        return call


def _find_linear_both(both, ptr):
    jf = J.find_obj_linear(both.js, jnp.int32(ptr))
    tf = T.find_obj_linear(both.ts, ptr)
    assert bool(jf[0]) == bool(tf[0])
    if bool(jf[0]):
        assert [int(x) for x in jf[1:]] == [int(x) for x in tf[1:]]
    return tf


# ---------------------------------------------------------------------------
# tests/test_allocator.py: size class, bulk frees, serial and scan paths
# ---------------------------------------------------------------------------

def test_sizeclass_basic_and_bin_reuse():
    a = Both("SizeClassAllocator", 1000, cap=64)
    assert int(a.malloc(100)) == 0 and int(a.malloc(50)) == 100
    found, base, size = a.find_obj(149)
    assert bool(found) and (int(base), int(size)) == (100, 50)
    a.free(0)
    assert not bool(a.find_obj(0)[0])
    wm = int(a.ts.watermark)
    assert int(a.malloc(60)) == 0 and int(a.ts.watermark) == wm
    assert int(a.find_obj(0)[2]) == 60


def test_sizeclass_class_guarantee():
    a = Both("SizeClassAllocator", 1000, cap=64)
    small = int(a.malloc(5))
    a.malloc(1)
    a.free(small)
    p = int(a.malloc(6))
    assert p != small and int(a.find_obj(p)[2]) == 6


def test_sizeclass_invalid_ops_noop():
    a = Both("SizeClassAllocator", 100, cap=16)
    a.malloc(10)
    before = {f: getattr(a.ts, f).clone() for f in T.SIZECLASS_FIELDS}
    for bad in (-1, 100, 7777):
        a.free(bad)
        assert not bool(a.find_obj(bad)[0])
    assert int(a.malloc(0)) == -1
    for f, v in before.items():
        assert torch.equal(getattr(a.ts, f), v), f


def test_sizeclass_bulk_roundtrip():
    a = Both("SizeClassAllocator", 4096, cap=256)
    ptrs = a.malloc_many(np.full((100,), 8, np.int32))
    arr = ptrs.numpy()
    assert (arr >= 0).all() and len(np.unique(arr)) == arr.size
    a.free_many(arr)
    wm = int(a.ts.watermark)
    for _ in range(4):
        assert int(a.malloc(8)) >= 0
    assert int(a.ts.watermark) == wm


def test_generic_free_many_and_serial_paths():
    """free_many (FAIL and wild entries ignored); the serial paths equal
    JAX's scans and the bulk path on fresh space, failures included."""
    a = Both("GenericAllocator", 1000, cap=32)
    ptrs = a.malloc_many(np.full((6,), 10, np.int32)).numpy()
    a.free_many(ptrs[::2].copy())
    for i, p in enumerate(ptrs):
        assert bool(a.find_obj(int(p))[0]) == (i % 2 == 1)
    a.free_many(np.array([-1, 999], np.int32))
    sizes = np.array([30, 30, 50, 20, 15, 90, 5], np.int32)
    bulk = Both("GenericAllocator", 100, cap=16)
    serial = Both("GenericAllocator", 100, cap=16)
    pb = bulk.malloc_many(sizes)
    ps = serial.malloc_many_serial(sizes)
    assert pb.tolist() == ps.tolist()
    for f in T.GENERIC_FIELDS:
        assert torch.equal(getattr(bulk.ts, f), getattr(serial.ts, f))
    serial.free_many_serial(np.array([ps[1], -1, ps[0], 77], np.int32))
    serial.malloc_many_serial(np.array([8, 0, 8, -2, 8], np.int32))


@pytest.mark.parametrize("seed", range(3))
def test_balanced_grid_bulk_matches_scan(seed):
    """The grid paths and their per-chunk scans (hole reuse and the
    serial reclaim's masked steps) against JAX's, on fresh and churned
    chunks."""
    rng = np.random.default_rng(seed)
    bulk = Both("BalancedAllocator", 4000, 4, 2, cap=16)
    scan = Both("BalancedAllocator", 4000, 4, 2, cap=16)
    sizes = np.arange(1, 33, dtype=np.int32).reshape(8, 4)
    p1, p2 = bulk.malloc_grid(8, 4, sizes), scan.malloc_grid_scan(8, 4, sizes)
    assert torch.equal(p1, p2)
    bulk.free_grid(8, 4, p1.numpy())
    scan.free_grid_scan(8, 4, p2.numpy())
    assert int(bulk.ts.watermark.max()) == int(scan.ts.watermark.max()) == 0
    for _ in range(4):
        sizes = rng.integers(-1, 120, size=(8, 4)).astype(np.int32)
        ptrs = scan.malloc_grid_scan(8, 4, sizes).numpy().copy()
        ptrs[rng.random(ptrs.shape) < 0.5] = -1
        scan.free_grid_scan(8, 4, ptrs)
        bulk.malloc_grid(8, 4, sizes)
        bulk.free_grid(8, 4, ptrs)
    scan.reset_chunk(3)


def test_find_obj_matches_linear_reference():
    g = Both("GenericAllocator", 500, cap=32)
    ptrs = g.malloc_many(np.array([7, 13, 1, 40, 9], np.int32)).numpy()
    g.free(int(ptrs[1]))
    b = Both("BalancedAllocator", 1024, 4, 2, cap=16)
    for tid, team, size in [(0, 0, 9), (0, 0, 4), (3, 1, 30), (2, 0, 5)]:
        b.malloc(tid, team, size)
    s = Both("SizeClassAllocator", 500, cap=32)
    for size in (7, 13, 1, 40):
        s.malloc(size)
    s.free(7)
    probes = list(range(0, 120, 3)) + [500, 1023, -1]
    for both in (g, b, s):
        for ptr in probes:
            f1 = both.find_obj(ptr)
            f2 = _find_linear_both(both, ptr)
            assert bool(f1[0]) == bool(f2[0]), (type(both.ts), ptr)
            if bool(f1[0]):
                assert int(f1[1]) == int(f2[1]) and int(f1[2]) == int(f2[2])


# ---------------------------------------------------------------------------
# tests/test_allocator_properties.py: seeded size-class properties
# ---------------------------------------------------------------------------

def _random_flat_ops(seed):
    rng = random.Random(seed)
    return [(rng.choice(["malloc", "free"]), rng.randint(1, 40),
             rng.randint(0, 7)) for _ in range(rng.randint(1, 30))]


def _check_lookup(both, live, probes):
    for ptr in probes:
        f1, f2 = both.find_obj(ptr), _find_linear_both(both, ptr)
        assert bool(f1[0]) == bool(f2[0])
        if bool(f1[0]):
            assert int(f1[1]) in live
    for p, sz in live.items():
        for probe in (p, p + sz - 1):
            f = both.find_obj(probe)
            assert bool(f[0]) and (int(f[1]), int(f[2])) == (p, sz)


def _check_split_bound(ts, live):
    count = int(ts.count)
    offsets, caps = ts.offsets[:count].numpy(), ts.caps[:count].numpy()
    sizes, in_use = ts.sizes[:count].numpy(), ts.in_use[:count].numpy()
    assert ((offsets + caps)[:-1] <= offsets[1:]).all()
    for e in range(count):
        if in_use[e]:
            assert caps[e] <= 1 << max(int(sizes[e]) - 1, 0).bit_length()
    assert sorted(live) == [int(offsets[e]) for e in range(count)
                            if in_use[e]]


@pytest.mark.parametrize("seed", range(10))
def test_sizeclass_invariants_and_splitting_property(seed):
    """Seeded malloc/free (every third malloc through malloc_many): JAX's
    states after every op, no overlap, the one-class split bound, lookups
    against the linear scan, and free(malloc(p)) handing p back."""
    a = Both("SizeClassAllocator", HEAP, cap=64)
    live, n = {}, 0
    for kind, size, idx in _random_flat_ops(seed):
        if kind == "malloc":
            n += 1
            p = int(a.malloc_many(np.array([size], np.int32))[0]
                    if n % 3 == 0 else a.malloc(size))
            if p >= 0:
                assert p not in live
                live[p] = size
        elif live:
            victim = sorted(live)[idx % len(live)]
            a.free(victim)
            del live[victim]
        if n % 3:
            _check_split_bound(a.ts, live)
    spans = sorted((p, p + s) for p, s in live.items())
    assert all(x[1] <= y[0] for x, y in zip(spans, spans[1:]))
    _check_lookup(a, live, list(range(0, HEAP, 7)))
    p = int(a.malloc(16))
    if p >= 0:
        a.free(p)
        assert int(a.malloc(16)) == p


@pytest.mark.parametrize("seed", range(4))
def test_sizeclass_full_free_coalesce_restores_fresh_arena(seed):
    rng = random.Random(seed)
    a = Both("SizeClassAllocator", HEAP, cap=64)
    live = []
    while True:
        p = int(a.malloc(rng.randint(1, 60)))
        if p < 0:
            break
        live.append(p)
    rng.shuffle(live)
    for p in live:
        a.free(p)
    a.coalesce()
    assert int(a.ts.count) == 0 and int(a.ts.watermark) == 0
    assert int(a.ts.free_bits.abs().sum()) == 0
    assert int(a.malloc(HEAP)) == 0


@pytest.mark.parametrize("seed", range(4))
def test_sizeclass_fragmented_malloc_recovers(seed):
    """A request that fits only in coalesced adjacent holes succeeds
    through malloc's retry (on the port a select, run every call)."""
    rng = random.Random(100 + seed)
    a = Both("SizeClassAllocator", HEAP, cap=64)
    ptrs = []
    while True:
        p = int(a.malloc(8))
        if p < 0:
            break
        ptrs.append(p)
    k = rng.randint(3, 8)
    start = rng.randint(0, len(ptrs) - k)
    freed = ptrs[start:start + k]
    for p in rng.sample(freed, len(freed)):
        a.free(p)
    assert int(a.malloc(8 * k)) == freed[0]


def test_sizeclass_split_chain_and_coalesce_edges():
    """The deterministic split chain, coalesce of a full arena (a
    no-op) and of a single top hole (watermark reclaim)."""
    a = Both("SizeClassAllocator", HEAP, cap=64)
    big, guard = int(a.malloc(60)), int(a.malloc(8))
    a.free(big)
    assert int(a.malloc(5)) == 0
    assert (int(a.ts.caps[0]), int(a.ts.offsets[1]), int(a.ts.caps[1])) \
        == (8, 8, 52)
    assert int(a.malloc(30)) == 8 and int(a.ts.caps[1]) == 32
    for p in (0, 8, guard):
        a.free(p)
    a.coalesce()
    assert int(a.malloc(HEAP)) == 0
    full = Both("SizeClassAllocator", HEAP, cap=64)
    while int(full.ts.watermark) < HEAP:
        full.malloc(min(16, HEAP - int(full.ts.watermark)))
    before = {f: getattr(full.ts, f).clone() for f in T.SIZECLASS_FIELDS}
    full.coalesce()
    for f, v in before.items():
        assert torch.equal(getattr(full.ts, f), v), f
    top = Both("SizeClassAllocator", HEAP, cap=64)
    top.malloc(32)
    top.free(int(top.malloc(16)))
    top.coalesce()
    assert (int(top.ts.watermark), int(top.ts.count)) == (32, 1)


@pytest.mark.parametrize("seed", range(3))
def test_sizeclass_coalesce_interleaved_with_bulk_malloc(seed):
    rng = random.Random(300 + seed)
    a = Both("SizeClassAllocator", HEAP, cap=64)
    live = {}
    for _ in range(5):
        sizes = [rng.randint(1, 24) for _ in range(rng.randint(1, 5))]
        ptrs = a.malloc_many(np.array(sizes, np.int32)).tolist()
        live.update({p: s for p, s in zip(ptrs, sizes) if p >= 0})
        for victim in [p for p in sorted(live) if rng.random() < 0.4]:
            a.free(victim)
            del live[victim]
        a.coalesce()
        _check_lookup(a, live, list(range(0, HEAP, 13)))
    a.free_many(np.array(sorted(live), np.int32))
    a.coalesce()
    assert int(a.ts.count) == 0 and int(a.ts.watermark) == 0


@pytest.mark.parametrize("seed", range(3))
def test_sizeclass_seeded_churn(seed):
    """Bulk malloc_many/free_many, single mallocs and frees, coalesce
    and realloc-sized requests past the arena, in a seeded order."""
    rng = random.Random(seed)
    a = Both("SizeClassAllocator", 300, cap=32)
    live = []
    for _ in range(30):
        r = rng.random()
        if r < 0.35:
            p = int(a.malloc(rng.randint(-1, 90)))
            live += [p] if p >= 0 else []
        elif r < 0.55 and live:
            a.free(live.pop(rng.randrange(len(live))))
        elif r < 0.7:
            a.coalesce()
        elif r < 0.85:
            sizes = np.array([rng.randint(0, 30) for _ in range(4)], np.int32)
            live += [p for p in a.malloc_many(sizes).tolist() if p >= 0]
        else:
            k = rng.randint(0, len(live))
            a.free_many(np.array(live[:k] + [-1, 5000], np.int32))
            live = live[k:]


def test_bit_helpers_are_exact():
    """floor/ceil log2 and the lowest set bit, against Python's ints at
    every power of two and its neighbours (no float log2)."""
    xs = sorted({v for k in range(32) for v in (2 ** k - 1, 2 ** k,
                                                2 ** k + 1)
                 if 0 <= v < 2 ** 31})
    t = torch.tensor(xs, dtype=torch.int32)
    assert T._floor_log2(t).tolist() == [max(x, 1).bit_length() - 1
                                         for x in xs]
    assert T._ceil_log2(t).tolist() == [(max(x, 1) - 1).bit_length()
                                        for x in xs]
    words = torch.tensor([1 << k | 1 << 31 for k in range(32)],
                         dtype=torch.int64)
    assert [int(T._low_bit(w)) for w in words] == list(range(32))
