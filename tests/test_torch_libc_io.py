"""The port's buffered libc I/O against the JAX package's, on the CPU:
``LogRing`` (scalar and payload records, per-flush sinks, named rings),
``fprintf``/``fwrite`` (the same formatted lines and streams, one flush),
``fread``/``fgets`` through the reply arena (the same codes, short reads
zero-padded, ``atoi`` over the reply) and remote malloc on the generic
heap (the same pointers through the reply arena and the same heap state,
the pointer marshalled as an ``ArenaRef`` afterwards), each the mirror of
its case in ``tests/test_rpc_transport.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import libc as jlibc  # noqa: E402
from repro.core import rpc as jrpc  # noqa: E402
from repro.core.allocator import GenericAllocator as JGA  # noqa: E402
from repro_torch.core import libc as tlibc  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.core.allocator import GenericAllocator as TGA  # noqa: E402
from repro_torch.core.allocator import find_obj  # noqa: E402


def _tq(*a, **kw):
    return trpc.RpcQueue.create(*a, device="cpu", **kw)


def test_logring_records_equal_jax():
    jlibc.drain_log_lines()
    tlibc.drain_log_lines()
    jr = jlibc.LogRing.create(8, payload_capacity=16)
    tr = tlibc.LogRing.create(8, payload_capacity=16, device="cpu")
    for tag, val, pay in ((1, 0.5, None), (2, 1.5, [9.0, 8.0]),
                          (3, -2.25, [1, 2, 3])):
        jr = jr.log(tag, val, payload=None if pay is None
                    else jnp.asarray(pay))
        assert tr.log(torch.tensor(tag), val, payload=None if pay is None
                      else torch.tensor(pay)) is tr
    jr = jr.log(4, 4.0, where=jnp.bool_(False))
    tr.log(4, 4.0, where=torch.tensor(False))
    assert np.array_equal(np.asarray(jr.tags), tr.tags.numpy())
    assert np.array_equal(np.asarray(jr.values), tr.values.numpy())
    assert int(jr.head) == int(tr.head) == 3
    jr.flush()
    jax.effects_barrier()
    tr.flush()
    jl, tl = jlibc.drain_log_lines(), tlibc.drain_log_lines()
    assert len(jl) == len(tl) == 3
    for a, b in zip(jl, tl):
        assert a[:2] == b[:2]
        if len(a) == 3:
            assert a[2].dtype == b[2].dtype and a[2].tolist() == b[2].tolist()
    # item 3.4 is ported: a sharded ring is one ring shard a device
    sharded = tlibc.LogRing.create_sharded(2, 4, device="cpu")
    assert sharded.q.n_devices == 2 and sharded.q.capacity == 4


def test_logring_sinks_per_flush_and_per_name():
    a, b = [], []
    r = tlibc.LogRing.create(4, device="cpu")
    r.log(1, 1.0).flush(sink=lambda t, v: a.append((t, v)))
    r.log(2, 2.0).flush(sink=lambda t, v: b.append((t, v)))
    r.log(1, 1.0).flush(sink=lambda t, v: a.append((t, v)))
    assert a == [(1, 1.0), (1, 1.0)] and b == [(2, 2.0)]
    la, lb = [], []
    ra = tlibc.LogRing.create(4, name="torch_sink.a", device="cpu")
    rb = tlibc.LogRing.create(4, name="torch_sink.b", device="cpu")
    ra.log(1, 1.0).flush(sink=lambda t, v: la.append((t, v)))
    rb.log(2, 2.0).flush(sink=lambda t, v: lb.append((t, v)))
    assert la == [(1, 1.0)] and lb == [(2, 2.0)]


def test_fprintf_fwrite_equal_jax():
    for lib in (jlibc, tlibc):
        lib.drain_printf()
        for s in (0, 7, 99):
            lib._WRITE_STREAMS.pop(s, None)
    jrpc.reset_rpc_stats()
    trpc.reset_rpc_stats()
    jq = jrpc.RpcQueue.create(16, width=4, payload_capacity=64)
    jq = jlibc.fprintf(jq, "step %d loss %.2f", jnp.int32(3),
                       jnp.float32(0.125))
    jq = jlibc.fwrite(jq, jnp.asarray([10, 20, 30], jnp.int32))
    jq = jlibc.fprintf(jq, "hist %s", jnp.asarray([1, 2, 3], jnp.int32))
    jq = jlibc.fwrite(jq, jnp.asarray([40], jnp.int32))
    jq = jlibc.fwrite(jq, jnp.asarray([0.5, 1.5], jnp.float32), stream=7)
    jq = jlibc.fprintf(jq, "100%% of %d", jnp.int32(5),
                       where=jnp.bool_(True))
    jq.flush()
    jax.effects_barrier()
    tq = _tq(16, width=4, payload_capacity=64)
    tlibc.fprintf(tq, "step %d loss %.2f", torch.tensor(3, dtype=torch.int32),
                  0.125)
    tlibc.fwrite(tq, torch.tensor([10, 20, 30], dtype=torch.int32))
    tlibc.fprintf(tq, "hist %s", torch.tensor([1, 2, 3], dtype=torch.int32))
    tlibc.fwrite(tq, torch.tensor([40], dtype=torch.int32))
    tlibc.fwrite(tq, torch.tensor([0.5, 1.5]), stream=7)
    tlibc.fprintf(tq, "100%% of %d", 5, where=torch.tensor(True))
    tq.flush()
    assert trpc.flush_stats()["flushes"] == jrpc.flush_stats()["flushes"] == 1
    lines = tlibc.drain_printf()
    assert lines == jlibc.drain_printf() == \
        ["step 3 loss 0.12", "hist [1 2 3]", "100% of 5"]
    for stream in (0, 7, 99):
        a, b = jlibc.drain_fwrite(stream), tlibc.drain_fwrite(stream)
        assert a.dtype == b.dtype and a.tolist() == b.tolist()
    assert tlibc._intern_fmt("hist %s") == jlibc._intern_fmt("hist %s")
    tlibc.fwrite(tq, torch.tensor([1], dtype=torch.int32), stream=5)
    tlibc.fwrite(tq, torch.tensor([1.0]), stream=5)
    tq.flush()
    with pytest.raises(ValueError, match="mixes dtypes"):
        tlibc.drain_fwrite(5)
    tlibc._WRITE_STREAMS.pop(5)


def test_fread_fgets_equal_jax():
    for lib in (jlibc, tlibc):
        lib.fread_feed(61, "42 x\nrest", reset=True)
        lib.fread_feed(62, np.asarray([1.5, -2.5, 3.0], np.float32),
                       reset=True)
    jq = jrpc.RpcQueue.create(16, width=2, reply_capacity=64)
    tq = _tq(16, width=2, reply_capacity=64)
    jt, tt = [], []
    for op, n, stream, dt in (("gets", 8, 61, None), ("gets", 8, 61, None),
                              ("read", 2, 62, "f"), ("read", 4, 62, "f"),
                              ("gets", 4, 61, None), ("read", 3, 60, "i")):
        if op == "gets":
            jq, t = jlibc.fgets(jq, n, stream=stream)
            _, u = tlibc.fgets(tq, n, stream=stream)
        else:
            jq, t = jlibc.fread(jq, n, stream=stream, dtype=jnp.float32
                                if dt == "f" else jnp.int32)
            _, u = tlibc.fread(tq, n, stream=stream, dtype=torch.float32
                               if dt == "f" else torch.int32)
        jt.append((t, n, dt))
        tt.append((u, n, dt))
    jq = jq.flush()
    jax.effects_barrier()
    tq.flush()
    for (t, n, dt), (u, _, _) in zip(jt, tt):
        a = np.asarray(jq.result(t, (n,), jnp.float32 if dt == "f"
                                 else jnp.int32))
        b = tq.result(u, (n,), torch.float32 if dt == "f"
                      else torch.int32).numpy()
        assert a.tolist() == b.tolist()
        assert int(jq.result_status(t)) == int(tq.result_status(u)) == 0
    line = tq.result(tt[0][0], (8,), torch.int32)
    assert bytes(line.numpy().astype(np.uint8)) == b"42 x\n\0\0\0"
    assert int(tlibc.atoi(line.to(torch.uint8))) == 42
    assert tq.result(tt[3][0], (4,), torch.float32).tolist() == \
        [3.0, 0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="one stream per dtype"):
        tlibc.fread_feed(62, np.asarray([1, 2], np.int32))


def test_remote_malloc_equals_jax_and_marshals_as_arena_ref():
    jlibc.remote_heap_register("heap.torch_rt", JGA.init(128, cap=16))
    tlibc.remote_heap_register("heap.torch_rt",
                               TGA.init(128, cap=16, device="cpu"))
    jq = jrpc.RpcQueue.create(8, width=3, payload_capacity=32,
                              reply_capacity=16)
    tq = _tq(8, width=3, payload_capacity=32, reply_capacity=16)
    jq, j0 = jlibc.remote_malloc_enqueue(jq, "heap.torch_rt",
                                         jnp.asarray([24, 8], jnp.int32))
    jq, j1 = jlibc.remote_malloc_enqueue(jq, "heap.torch_rt",
                                         jnp.asarray([4], jnp.int32))
    _, t0 = tlibc.remote_malloc_enqueue(tq, "heap.torch_rt",
                                        torch.tensor([24, 8]))
    _, t1 = tlibc.remote_malloc_enqueue(tq, "heap.torch_rt", [4])
    jq = jq.flush()
    jax.effects_barrier()
    tq.flush()
    ptrs = tq.result(t0, (2,), torch.int32)
    assert ptrs.tolist() == np.asarray(jq.result(j0, (2,), jnp.int32)
                                       ).tolist() == [0, 24]
    assert tq.result(t1, (1,), torch.int32).tolist() == [32]
    jstate, jb = jlibc.remote_malloc_results("heap.torch_rt")
    tstate, tb = tlibc.remote_malloc_results("heap.torch_rt")
    assert [p.tolist() for p in tb] == [p.tolist() for p in jb]
    for f in dataclasses.fields(tstate):
        v = getattr(tstate, f.name)
        if isinstance(v, torch.Tensor):
            assert v.tolist() == np.asarray(getattr(jstate, f.name)).tolist()
    found, base, size = find_obj(tstate, ptrs[0] + 5)
    assert (int(found), int(base), int(size)) == (1, 0, 24)
    seen = {}
    trpc.REGISTRY.register(
        "torch_rt.probe",
        lambda ptr, base, size, found, arena: seen.update(
            ptr=int(ptr), base=int(base), size=int(size), found=int(found))
        or np.int32(0))
    trpc.rpc_call("torch_rt.probe",
                  trpc.ArenaRef(torch.zeros(128), ptrs[1] + 3, tstate,
                                access=trpc.READ),
                  result_shape=trpc.ShapeDtype((), torch.int32))
    assert seen == {"ptr": 27, "base": 24, "size": 8, "found": 1}


def test_remote_malloc_reply_less_and_refusals():
    tlibc.remote_heap_register("heap.torch_t",
                               TGA.init(256, cap=32, device="cpu"))
    q = _tq(8, width=3, payload_capacity=32)
    tlibc.remote_malloc_enqueue(q, "heap.torch_t", torch.tensor([8, 16, 8]))
    tlibc.remote_malloc_enqueue(q, "heap.torch_t", torch.tensor([4]))
    q.flush()
    state, batches = tlibc.remote_malloc_results("heap.torch_t")
    assert [p.tolist() for p in batches] == [[0, 8, 24], [32]]
    assert int(state.watermark) == 36
    with pytest.raises(KeyError, match="remote heap"):
        tlibc.remote_malloc_enqueue(q, "heap.torch_unknown", [1])
    from repro_torch.core.allocator import BalancedAllocator
    with pytest.raises(TypeError, match="malloc_many"):
        tlibc.remote_heap_register(
            "heap.torch_b", BalancedAllocator.init(64, 2, 1, device="cpu"))
