"""Port's sharded heap (shards stacked on one device) against the JAX
package's: tests/test_sharded_runtime.py's heap cases, mesh-free, with
every shard's state and every global pointer compared after each op."""
import random

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import allocator as J  # noqa: E402
from repro_torch.core import allocator as T  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402

D, SPAN, CAP = 4, 128, 16


def _same(jsh, tsh):
    assert (jsh.n_devices, jsh.span) == (tsh.n_devices, tsh.span)
    for f in T._tensor_fields(tsh.shards):
        a = np.asarray(getattr(jsh.shards, f))
        if f == "free_bits":
            a = a.astype(np.int64)
        np.testing.assert_array_equal(a, getattr(tsh.shards, f).numpy(),
                                      err_msg=f)


def _drive(seed, inner="GenericAllocator"):
    """tests/test_sharded_runtime.py's ``_drive_sharded`` in both
    packages: random rounds of one malloc per device or one free per
    device (FAIL where a device frees nothing)."""
    rng = random.Random(seed)
    jsh = J.shard_heap(getattr(J, inner).init(SPAN, cap=CAP), D)
    tsh = T.shard_heap(getattr(T, inner).init(SPAN, cap=CAP, device="cpu"),
                       D)
    live = [dict() for _ in range(D)]
    for _ in range(12):
        if rng.random() < 0.6:
            sizes = np.array([rng.randint(1, 24) for _ in range(D)], np.int32)
            jsh, jp = J.ShardedAllocator.malloc(jsh, jnp.asarray(sizes))
            tsh, tp = T.ShardedAllocator.malloc(tsh, torch.from_numpy(sizes))
            np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
            for d, (p, s) in enumerate(zip(tp.tolist(), sizes)):
                if p >= 0:
                    assert p not in live[d]
                    live[d][p] = int(s)
        else:
            victims = []
            for d in range(D):
                if live[d] and rng.random() < 0.8:
                    v = rng.choice(sorted(live[d]))
                    del live[d][v]
                    victims.append(v)
                else:
                    victims.append(-1)
            v = np.array(victims, np.int32)[:, None]
            jsh = J.ShardedAllocator.free(jsh, jnp.asarray(v))
            tsh = T.ShardedAllocator.free(tsh, torch.from_numpy(v))
        _same(jsh, tsh)
    return jsh, tsh, live


@pytest.mark.parametrize("seed", range(5))
def test_sharded_heap_per_device_nonoverlap(seed):
    _, _, live = _drive(seed)
    for d in range(D):
        blocks = sorted(live[d].items())
        for p, s in blocks:
            assert d * SPAN <= p and p + s <= (d + 1) * SPAN
        for (p1, s1), (p2, _) in zip(blocks, blocks[1:]):
            assert p1 + s1 <= p2


@pytest.mark.parametrize("seed", range(5))
def test_sharded_heap_watermark_monotone(seed):
    _, tsh, live = _drive(seed)
    wm = tsh.shards.watermark.tolist()
    for d in range(D):
        top = max((p - d * SPAN + s for p, s in live[d].items()), default=0)
        assert wm[d] >= top


@pytest.mark.parametrize("seed", range(5))
def test_sharded_find_obj_matches_linear_and_jax(seed):
    jsh, tsh, live = _drive(seed, "SizeClassAllocator" if seed % 2
                            else "GenericAllocator")
    probes = [-1, -7, D * SPAN, D * SPAN + 3]
    for d in range(D):
        probes += [d * SPAN, (d + 1) * SPAN - 1]
        for p, s in live[d].items():
            probes += [p, p + s - 1, p + s]
    for ptr in probes:
        tf = [int(x) for x in T.find_obj(tsh, ptr)]
        tl = [int(x) for x in T.find_obj_linear(tsh, ptr)]
        jf = [int(x) for x in J.find_obj(jsh, jnp.int32(ptr))]
        assert tf[0] == tl[0] == jf[0], ptr
        if tf[0]:
            assert tf == tl == jf
            assert live[ptr // SPAN][tf[1]] == tf[2]


def test_sharded_heap_one_device_bit_identical():
    """A one-device sharded heap is the single heap: the same pointer
    streams, for the generic and the balanced grid paths."""
    single = T.GenericAllocator.init(SPAN, cap=CAP, device="cpu")
    sh = T.shard_heap(T.GenericAllocator.init(SPAN, cap=CAP, device="cpu"),
                      1)
    for s in (5, 9, 3, 2, 7, 1):
        single, p1 = T.GenericAllocator.malloc(single, s)
        sh, p2 = T.ShardedAllocator.malloc(sh, torch.tensor([s]))
        assert int(p1) == int(p2[0])
    bsing = T.BalancedAllocator.init(256, 2, 2, cap=16, device="cpu")
    bsh = T.shard_heap(T.BalancedAllocator.init(256, 2, 2, cap=16,
                                                device="cpu"), 1)
    sizes = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    bsing, g1 = T.BalancedAllocator.malloc_grid(bsing, 2, 4, sizes)
    bsh, g2 = T.ShardedAllocator.malloc_grid(bsh, 2, 4, sizes[None])
    assert torch.equal(g1, g2[0])


@pytest.mark.parametrize("seed", range(3))
def test_sharded_balanced_grid_ops_match_jax(seed):
    """malloc_grid, free_grid (foreign and FAIL pointers among them),
    reset_chunks and malloc_many over D x NC chunks dispatched flat."""
    rng = np.random.default_rng(seed)
    jsh = J.shard_heap(J.BalancedAllocator.init(256, 2, 2, cap=8), 3)
    tsh = T.shard_heap(T.BalancedAllocator.init(256, 2, 2, cap=8,
                                                device="cpu"), 3)
    for _ in range(5):
        sizes = rng.integers(-1, 40, size=(3, 4, 2)).astype(np.int32)
        jsh, jp = J.ShardedAllocator.malloc_grid(jsh, 4, 2, jnp.asarray(sizes))
        tsh, tp = T.ShardedAllocator.malloc_grid(tsh, 4, 2,
                                                 torch.from_numpy(sizes))
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        _same(jsh, tsh)
        p = tp.numpy().copy()
        p[rng.random(p.shape) < 0.3] = -1
        p[0, 0, 0] = int(p[1, 0, 0])               # another device's ptr
        jsh = J.ShardedAllocator.free_grid(jsh, 4, 2, jnp.asarray(p))
        tsh = T.ShardedAllocator.free_grid(tsh, 4, 2, torch.from_numpy(p))
        _same(jsh, tsh)
        mask = rng.random((3, 4)) < 0.3
        jsh = J.ShardedAllocator.reset_chunks(jsh, jnp.asarray(mask))
        tsh = T.ShardedAllocator.reset_chunks(tsh, torch.from_numpy(mask))
        _same(jsh, tsh)
    g = T.shard_heap(T.GenericAllocator.init(64, cap=8, device="cpu"), 2)
    jg = J.shard_heap(J.GenericAllocator.init(64, cap=8), 2)
    sizes = np.array([[5, 70, 3], [0, 9, 9]], np.int32)
    g, tp = T.ShardedAllocator.malloc_many(g, torch.from_numpy(sizes))
    jg, jp = J.ShardedAllocator.malloc_many(jg, jnp.asarray(sizes))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    _same(jg, g)


def test_shard_heap_span_of_a_card_balanced_heap_must_be_given():
    """Inferring a balanced heap's span reads its end; for CPU tensors
    that is free, and ``span=`` skips it (what a card heap needs)."""
    b = T.BalancedAllocator.init(100, 2, 1, cap=4, device="cpu")
    assert T.shard_heap(b, 2).span == 100
    assert T.shard_heap(b, 2, span=128).span == 128


def test_arena_ref_marshals_sharded_global_ptr():
    """ArenaRef(ptr into shard d) ships the global (base, size)."""
    sh = T.shard_heap(T.GenericAllocator.init(SPAN, cap=CAP, device="cpu"),
                      2)
    sh, ptrs = T.ShardedAllocator.malloc(sh, torch.tensor([8, 12]))
    gp = int(ptrs[1])
    seen = {}
    trpc.REGISTRY.register(
        "tshard.probe",
        lambda ptr, base, size, found, arena: seen.update(
            ptr=int(ptr), base=int(base), size=int(size), found=int(found))
        or np.int32(0))
    trpc.rpc_call("tshard.probe", trpc.ArenaRef(
        torch.zeros(2 * SPAN), gp + 5, sh, access=trpc.READ),
        result_shape=trpc.ShapeDtype((), torch.int32))
    assert seen == {"ptr": gp + 5, "base": gp, "size": 12, "found": 1}


def test_remote_malloc_on_a_sharded_heap_matches_jax():
    """libc's remote malloc served from a sharded host heap: the record's
    device picks the shard, pointers come back global, a device outside
    the heap fails only its record; the heaps and pointers equal JAX's."""
    import warnings
    from repro.core import libc as jlibc
    from repro.core import rpc as jrpc
    from repro_torch.core import libc as tlibc
    jlibc.remote_heap_register("heap.tshard", J.shard_heap(
        J.GenericAllocator.init(SPAN, cap=CAP), 3))
    tlibc.remote_heap_register("heap.tshard", T.shard_heap(
        T.GenericAllocator.init(SPAN, cap=CAP, device="cpu"), 3))
    jq = jrpc.RpcQueue.create(8, 3, 64)
    tq = trpc.RpcQueue.create(8, 3, 64, device="cpu")
    for dev, sizes in ((1, [8, 16]), (0, [4]), (5, [2, 2]), (1, [30])):
        jq, _ = jlibc.remote_malloc_enqueue(jq, "heap.tshard",
                                            jnp.asarray(sizes), device=dev)
        tlibc.remote_malloc_enqueue(tq, "heap.tshard", torch.tensor(sizes),
                                    device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jq.flush()
        tq.flush()
    jst, jptrs = jlibc.remote_malloc_results("heap.tshard")
    tst, tptrs = tlibc.remote_malloc_results("heap.tshard")
    assert [p.tolist() for p in tptrs] == [np.asarray(p).tolist()
                                           for p in jptrs]
    assert tptrs[0].tolist() == [SPAN, SPAN + 8] and tptrs[2].tolist() == \
        [-1, -1]
    _same(jst, tst)
