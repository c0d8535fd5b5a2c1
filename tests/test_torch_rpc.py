"""The port's immediate host RPC against the JAX package's, on the CPU
(the transport's plain version; the card's channel is held to it by
chip_smoke.py): the four cases of tests/test_core.py with results,
write-backs, ``rpc_stats`` and landing-pad ids equal, the ArenaRef case
also over the balanced page heap, and the refusals of this slice."""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rpc as jrpc  # noqa: E402
from repro.core.allocator import BalancedAllocator as JBA  # noqa: E402
from repro.core.allocator import GenericAllocator as JGA  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.core.allocator import BalancedAllocator as TBA  # noqa: E402
from repro_torch.core.allocator import GenericAllocator as TGA  # noqa: E402

_ids = itertools.count()
_J = {"int32": jnp.int32, "float32": jnp.float32}
_T = {"int32": torch.int32, "float32": torch.float32}


def _register(fn, dtype="int32"):
    """Register ``fn`` in both packages under a name no other test uses
    (pad counters count pads made since the name's registration), and
    return ``(name, jax_call, port_call)``."""
    name = f"torch_parity_{fn.__name__}_{next(_ids)}"
    jrpc.REGISTRY.register(name, fn)
    trpc.REGISTRY.register(name, fn)
    jshape = jax.ShapeDtypeStruct((), _J[dtype])
    tshape = trpc.ShapeDtype((), _T[dtype])

    def jcall(*args):
        return jrpc.rpc_call(name, *args, result_shape=jshape)

    def tcall(*args, **kw):
        return trpc.rpc_call(name, *args, result_shape=tshape, **kw)

    return name, jcall, tcall


def _same_bookkeeping(name):
    jax.effects_barrier()
    trpc.effects_barrier()
    js, ts = jrpc.rpc_stats(name), trpc.rpc_stats(name)
    for k in ("calls", "pads", "bytes_in", "bytes_out"):
        assert js[k] == ts[k], (k, js, ts)
    jpads = {k: v for k, v in jrpc.pad_table().items() if v[0] == name}
    tpads = {k: v for k, v in trpc.pad_table().items() if v[0] == name}
    assert jpads == tpads and jpads
    for pid in jpads:
        assert jrpc.pad_stats(pid) == trpc.pad_stats(pid)
    return ts


def test_rpc_value_and_ref_args_match_jax():
    def scanf_like(scale, buf):
        buf[:] = np.arange(len(buf), dtype=np.float32) * float(scale)
        return np.int32(len(buf))

    name, jcall, tcall = _register(scanf_like)
    jr, (jbuf,) = jax.jit(lambda x: jcall(3, jrpc.Ref(x)))(
        jnp.zeros(4, jnp.float32))
    x = torch.zeros(4)
    tr, (tbuf,) = tcall(3, trpc.Ref(x, access=trpc.READWRITE))
    assert int(tr) == int(jr) == 4 and tr.dtype == torch.int32
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tbuf.numpy(), [0, 3, 6, 9])
    np.testing.assert_array_equal(x.numpy(), 0.0)     # functional, as JAX
    st = _same_bookkeeping(name)
    assert st["calls"] == 1 and st["pads"] == 1
    assert (st["bytes_in"], st["bytes_out"]) == (20, 20)


def test_rpc_read_only_ref_not_written_back_matches_jax():
    def summer(buf):
        total = float(buf.sum())
        buf[:] = -1.0                      # host-side mutation of a READ ref
        return np.float32(total)

    name, jcall, tcall = _register(summer, "float32")
    jr, (jbuf,) = jax.jit(lambda x: jcall(jrpc.Ref(x, access=jrpc.READ)))(
        jnp.ones(3, jnp.float32))
    x = torch.ones(3)
    tr, (tbuf,) = tcall(trpc.Ref(x, access=trpc.READ))
    assert float(tr) == float(jr) == 3.0
    assert tbuf is x
    np.testing.assert_array_equal(x.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(x.numpy(), 1.0)
    _same_bookkeeping(name)


def test_rpc_landing_pads_monomorphize_like_jax():
    def vararg_like(*args):
        return np.int32(len(args))

    name, jcall, tcall = _register(vararg_like)

    def jprog():
        a, _ = jcall(jnp.int32(1))
        b, _ = jcall(jnp.int32(1), jnp.float32(2.0))
        c, _ = jcall(3, 2.5, True)           # Python numbers: int32, f32
        return a + b + c

    assert int(jax.jit(jprog)()) == 6
    a, _ = tcall(torch.tensor(1, dtype=torch.int32))
    b, _ = tcall(torch.tensor(1, dtype=torch.int32), torch.tensor(2.0))
    c, _ = tcall(3, 2.5, True)
    assert int(a + b + c) == 6
    st = _same_bookkeeping(name)
    # three call-site signatures -> three landing pads (variadic
    # monomorphisation, Fig. 3), with JAX's content-hashed ids
    assert st["pads"] == 3
    sigs = {v[1:] for v in trpc.pad_table().values() if v[0] == name}
    assert (("val", (), "int32"), ("val", (), "float32"),
            ("val", (), "bool")) in sigs


def test_rpc_narrow_and_bf16_operands_match_jax():
    """64-bit tensors narrow to 32 bits as JAX's do with x64 off; bf16
    reaches the port's callee as float32 and its write-back is rounded."""
    def fill(idx, buf):
        buf[:] = np.float32(1.0 / 3.0) * (1 + np.asarray(idx, np.float32))
        return np.int32(idx.sum())

    name, jcall, tcall = _register(fill)
    idx = np.arange(3, dtype=np.int64)
    jr, (jbuf,) = jax.jit(lambda i, b: jcall(i, jrpc.Ref(b)))(
        idx, jnp.zeros(3, jnp.bfloat16))    # int64 arrives as int32
    tr, (tbuf,) = tcall(torch.from_numpy(idx),
                        trpc.Ref(torch.zeros(3, dtype=torch.bfloat16)))
    assert int(tr) == int(jr) == 3 and tbuf.dtype == torch.bfloat16
    np.testing.assert_array_equal(tbuf.float().numpy(),
                                  np.asarray(jbuf, np.float32))
    _same_bookkeeping(name)


def _arena_callee(fill):
    def host_fill(ptr_v, base, size, found, arena):
        assert int(found) == 1 and int(size) == 8
        assert int(base) <= int(ptr_v) < int(base) + int(size)
        arena[int(base):int(base) + int(size)] = fill
        return np.int32(0)
    return host_fill


def test_rpc_arena_ref_generic_heap_matches_jax():
    name, jcall, tcall = _register(_arena_callee(7.0))
    jst, jptr = JGA.malloc(JGA.init(64, cap=8), 8)
    tst, tptr = TGA.malloc(TGA.init(64, cap=8, device="cpu"), 8)
    assert int(jptr) == int(tptr)

    @jax.jit
    def jprog(state, arena, ptr):
        _, (arena,) = jcall(jrpc.ArenaRef(arena, ptr, state))
        return arena

    jarena = jprog(jst, jnp.zeros(64, jnp.float32), jptr + 3)
    _, (tarena,) = tcall(trpc.ArenaRef(torch.zeros(64), tptr + 3, tst))
    np.testing.assert_array_equal(tarena.numpy(), np.asarray(jarena))
    np.testing.assert_array_equal(tarena.numpy()[:8], 7.0)
    np.testing.assert_array_equal(tarena.numpy()[8:], 0.0)
    _same_bookkeeping(name)


def test_rpc_arena_ref_balanced_heap_matches_jax():
    """The page heap: the object is found through the chunk bases."""
    name, jcall, tcall = _register(_arena_callee(5.0))
    jst = JBA.init(96, 2, 2, cap=4, first_chunk_ratio=2.0)
    tst = TBA.init(96, 2, 2, cap=4, first_chunk_ratio=2.0, device="cpu")
    jst, _ = JBA.malloc(jst, 1, 1, 4)
    tst, _ = TBA.malloc(tst, 1, 1, 4)
    jst, jptr = JBA.malloc(jst, 1, 1, 8)
    tst, tptr = TBA.malloc(tst, 1, 1, 8)
    assert int(jptr) == int(tptr) > 0
    jarena = jax.jit(lambda s, a, p: jcall(jrpc.ArenaRef(a, p, s))[1][0])(
        jst, jnp.zeros(96, jnp.float32), jptr)
    _, (tarena,) = tcall(trpc.ArenaRef(torch.zeros(96), int(tptr), tst))
    np.testing.assert_array_equal(tarena.numpy(), np.asarray(jarena))
    assert float(tarena.sum()) == 40.0
    _same_bookkeeping(name)


def test_rpc_host_rpc_stub_and_reference_path():
    """``host_rpc`` registers and stubs; ``rpc_call_reference`` (the
    host-synchronous version) gives what ``rpc_call`` gives."""
    @trpc.host_rpc(result_shape=trpc.ShapeDtype((2,), torch.float32))
    def torch_parity_twice(x):
        return (2 * x).astype(np.float32)

    x = torch.tensor([1.5, -2.0])
    r, upd = torch_parity_twice.rpc(x)
    assert upd == [] and r.tolist() == [3.0, -4.0]
    r2, _ = trpc.rpc_call_reference(
        "torch_parity_twice", x,
        result_shape=trpc.ShapeDtype((2,), torch.float32))
    assert torch.equal(r, r2)
    assert trpc.rpc_stats("torch_parity_twice")["calls"] == 2


def test_rpc_refusals():
    name, _, tcall = _register(lambda *a: np.int32(0))
    with pytest.raises(ValueError, match="pure"):
        tcall(trpc.Ref(torch.zeros(2)), pure=True)
    tcall(trpc.Ref(torch.zeros(2), access=trpc.READ), pure=True)
    for kw, what in (({"batched": True}, "queue"), ({"returns": 1}, "batched"),
                     ({"where": True}, "batched")):
        with pytest.raises(ValueError, match=what):
            tcall(1, **kw)
    with pytest.raises(KeyError):
        trpc.rpc_call("torch_parity_nobody",
                      result_shape=trpc.ShapeDtype((), torch.int32))
    with pytest.raises(ValueError, match="shape"):
        trpc.rpc_call(name, result_shape=trpc.ShapeDtype((3,), torch.int32))
    with pytest.raises(ValueError):
        trpc.Ref(torch.zeros(1), access="rw")


# -- result_shape as a pytree (JAX's contract): no result, several results --

def _two_results(x):
    return (5, 8.0)


def test_rpc_empty_and_tuple_result_shapes_match_jax():
    """``result_shape=()`` returns ``()`` (no result slot) and a tuple of
    shapes returns a tuple of results, as JAX's ``rpc_call`` does; the
    bookkeeping (bytes out of the callee's result leaves) agrees."""
    name = f"torch_parity_tuple_{next(_ids)}"
    jrpc.REGISTRY.register(name, _two_results)
    trpc.REGISTRY.register(name, _two_results)
    jshape = (jax.ShapeDtypeStruct((), jnp.int32),
              jax.ShapeDtypeStruct((), jnp.float32))
    tshape = (trpc.ShapeDtype((), torch.int32),
              trpc.ShapeDtype((), torch.float32))
    jr, _ = jax.jit(lambda: jrpc.rpc_call(name, jnp.int32(1),
                                          result_shape=jshape))()
    tr, _ = trpc.rpc_call(name, 1, result_shape=tshape)
    assert isinstance(tr, tuple) and len(tr) == 2
    assert [t.dtype for t in tr] == [torch.int32, torch.float32]
    assert [t.item() for t in tr] == [np.asarray(j).item() for j in jr] \
        == [5, 8.0]
    _same_bookkeeping(name)

    seen = []
    empty = f"torch_parity_empty_{next(_ids)}"

    def sink(x):
        seen.append(int(x))

    jrpc.REGISTRY.register(empty, sink)
    trpc.REGISTRY.register(empty, sink)
    jout = jax.jit(lambda: jrpc.rpc_call(empty, jnp.int32(7),
                                         result_shape=())[0])()
    jax.effects_barrier()
    tout, upd = trpc.rpc_call(empty, 7, result_shape=())
    assert tout == () == jout and upd == [] and seen == [7, 7]
    _same_bookkeeping(empty)
    # host_rpc goes through the same path
    deco = trpc.host_rpc(f"torch_parity_deco_{next(_ids)}",
                         result_shape=tshape)(_two_results)
    out, _ = deco.rpc(3)
    assert [t.item() for t in out] == [5, 8.0]


def _issue_conformance(pkg, call):
    """tests/test_rpc_transport.py's conformance issuers of
    ``libc.fprintf``/``libc.fwrite`` (``result_shape=()``) and remote
    malloc, through one package and one transport (immediate, batched or
    a 2-shard sharded queue, one call a shard): returns the host effect
    and the device's results (the reply arena's pointers)."""
    if pkg == "jax":
        from repro.core import libc
        from repro.core.allocator import GenericAllocator as GA
        from repro.core.rpc import RpcQueue, ShardedRpcQueue, rpc_call
        i32 = lambda v: jnp.int32(v)       # noqa: E731
        f32 = lambda v: jnp.float32(v)     # noqa: E731
        arr = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
        run = lambda f: (jax.jit(f)(), jax.effects_barrier())[0]  # noqa
        queue = lambda **kw: RpcQueue.create(8, **kw)  # noqa: E731
        sharded = lambda **kw: ShardedRpcQueue.create(2, 8, **kw)  # noqa
        spec = lambda k: jax.ShapeDtypeStruct((k,), jnp.int32)  # noqa
        restack = lambda ls: ShardedRpcQueue(jax.tree.map(  # noqa: E731
            lambda *xs: jnp.stack(xs), *ls))
        heap = GA.init(256, cap=16)
    else:
        from repro_torch.core import libc
        from repro_torch.core.allocator import GenericAllocator as GA
        from repro_torch.core.rpc import (RpcQueue, ShardedRpcQueue,
                                          rpc_call)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        arr = i32
        run = lambda f: (f(), trpc.effects_barrier())[0]  # noqa: E731
        queue = lambda **kw: RpcQueue.create(8, device="cpu", **kw)  # noqa
        sharded = lambda **kw: ShardedRpcQueue.create(  # noqa: E731
            2, 8, device="cpu", **kw)
        spec = lambda k: trpc.ShapeDtype((k,), torch.int32)  # noqa: E731
        restack = ShardedRpcQueue.stack
        heap = GA.init(256, cap=16, device="cpu")
    transport, what = call
    stream = {"immediate": 31, "batched": 32, "sharded": 33}[transport]
    libc.drain_printf()                  # what earlier tests left
    libc.drain_fwrite(stream)
    if what == "fprintf":
        fmt = "conf %d %.1f"
        fid = libc._intern_fmt(fmt)
        calls = [(3, 1.5), (4, -0.5)]
        if transport == "immediate":
            def prog():
                for a, b in calls:
                    rpc_call("libc.fprintf", i32(fid), i32(a), f32(b),
                             result_shape=())
                return i32(0)
            run(prog)
        elif transport == "batched":
            def prog():
                q = queue(width=4, payload_capacity=16)
                for a, b in calls:
                    q = libc.fprintf(q, fmt, i32(a), f32(b))
                return q.flush().head
            run(prog)
        else:
            q = sharded(width=4, payload_capacity=16)
            locals_ = [q.local(d) for d in range(2)]
            for d, (a, b) in enumerate(calls):      # one call per device
                locals_[d] = libc.fprintf(locals_[d], fmt, i32(a), f32(b))
            run(lambda: restack(locals_).flush())
        return libc.drain_printf(), None
    if what == "fwrite":
        chunks = [[10, 20, 30], [40]]
        if transport == "immediate":
            def prog():
                for c in chunks:
                    rpc_call("libc.fwrite", i32(stream), arr(c),
                             result_shape=())
                return i32(0)
            run(prog)
        elif transport == "batched":
            def prog():
                q = queue(width=2, payload_capacity=16)
                for c in chunks:
                    q = libc.fwrite(q, arr(c), stream=stream)
                return q.flush().head
            run(prog)
        else:
            q = sharded(width=2, payload_capacity=16)
            locals_ = [q.local(d) for d in range(2)]
            for d, c in enumerate(chunks):
                locals_[d] = libc.fwrite(locals_[d], arr(c), stream=stream)
            run(lambda: restack(locals_).flush())
        return libc.drain_fwrite(stream).tolist(), None
    name = f"heap.conf.{transport}"
    libc.remote_heap_register(name, heap)
    batches = [[8, 16], [4]]
    nid = libc._intern_fmt(name)
    if transport == "immediate":
        def prog():
            return [rpc_call("libc.remote_malloc", i32(nid), i32(0),
                             arr(sizes), result_shape=spec(len(sizes)))[0]
                    for sizes in batches]
    elif transport == "batched":
        def prog():
            q = queue(width=3, payload_capacity=16, reply_capacity=8)
            tks = []
            for sizes in batches:
                q, t = libc.remote_malloc_enqueue(q, name, arr(sizes))
                tks.append((t, len(sizes)))
            q = q.flush()
            return [q.result(t, (k,), spec(k).dtype) for t, k in tks]
    else:
        def prog():
            q = sharded(width=3, payload_capacity=16, reply_capacity=8)
            locals_ = [q.local(d) for d in range(2)]
            tks = []
            for d, sizes in enumerate(batches):
                locals_[d], t = libc.remote_malloc_enqueue(
                    locals_[d], name, arr(sizes))
                tks.append((d, t, len(sizes)))
            sq = restack(locals_).flush()
            return [sq.result(d, t, (k,), spec(k).dtype)
                    for d, t, k in tks]
    device_ptrs = [np.asarray(o).tolist() for o in run(prog)]
    state, host_ptrs = libc.remote_malloc_results(name)
    return ([p.tolist() for p in host_ptrs], int(state.watermark)), \
        device_ptrs


@pytest.mark.parametrize("transport", ["immediate", "batched", "sharded"])
@pytest.mark.parametrize("what", ["fprintf", "fwrite", "remote_malloc"])
def test_cross_transport_conformance_matches_jax(transport, what):
    """JAX's ``test_cross_transport_conformance``, each transport of it:
    the same host effect and device results from both packages, and (for
    the output calls) the same from every transport."""
    got = {pkg: _issue_conformance(pkg, (transport, what))
           for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    if what != "remote_malloc":
        want = (["conf 3 1.5", "conf 4 -0.5"] if what == "fprintf"
                else [10, 20, 30, 40])
        assert got["port"][0] == want


def test_remote_malloc_conformance_across_transports():
    """The three transports give the port identical host effects and
    device results (JAX's sweep, on the port alone)."""
    runs = [_issue_conformance("port", (t, "remote_malloc"))
            for t in ("immediate", "batched", "sharded")]
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][1] == [[0, 8], [24]]


def _reply(i, p):
    return np.arange(int(p), dtype=np.int32) + int(i)


def test_channel_staging_is_keyed_by_pad_and_result_shape():
    """F6: one callee returns 1, 64 and 1024 elements (then 1 again) on one
    channel.  Its one landing pad gets a staging region a result shape, each
    under its own channel-local id, and serving a region's id (what the
    drain does with the id the record carries) writes that call's result
    in that call's shape.  The channel here is a ``HostChannel`` (the CPU's:
    the same regions in host memory); the card's channel is held to this
    by chip_smoke.py's ``rpc`` case."""
    from repro_torch.kernels.rpc_channel import HostChannel

    name = f"torch_parity_reply_{next(_ids)}"
    trpc.REGISTRY.register(name, _reply)
    channel = HostChannel()
    sids, pids = {}, set()
    for i, P in enumerate((1, 64, 1024, 1)):
        spec = trpc.ShapeDtype((P,), torch.int32)
        specs, _, sig, ops, _, pid = trpc._prepare(
            name, (torch.tensor(i, dtype=torch.int32), P), spec, False, None)
        sid, staging = trpc._pad_staging(channel, name, pid, sig, ops, specs)
        # what rpc_post's copies and kernel write before the drain serves
        staging.slot(0).view(np.int32)[:] = i
        number = ops[1]
        staging.word(0)[:number.dtype.itemsize].view(number.dtype)[0] = P
        channel.stagings.serve(sid)
        np.testing.assert_array_equal(staging.slot(1).view(np.int32),
                                      _reply(i, P))
        assert sids.setdefault(P, sid) == sid
        assert channel.stagings.ids[trpc.staging_key(pid, spec)] == sid
        pids.add(pid)
    assert len(pids) == 1
    assert sorted(sids.values()) == [1, 2, 3]
    assert len(channel.stagings.entries) == 3


def test_one_callee_at_three_result_sizes_keeps_pad_stats_per_pad():
    """JAX's ``bench.reply`` pattern (benchmarks/rpc_bench.py): one callee
    at 1, 64 and 1024 elements.  The results are JAX's; the callee has one
    landing pad, whose statistics count every call, as JAX's."""
    name = f"torch_parity_reply_{next(_ids)}"
    jrpc.REGISTRY.register(name, _reply)
    trpc.REGISTRY.register(name, _reply)
    for i, P in enumerate((1, 64, 1024)):
        j, _ = jrpc.rpc_call(name, jnp.int32(i), P,
                             result_shape=jax.ShapeDtypeStruct((P,),
                                                               jnp.int32))
        t, _ = trpc.rpc_call(name, torch.tensor(i, dtype=torch.int32), P,
                             result_shape=trpc.ShapeDtype((P,), torch.int32))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    st = _same_bookkeeping(name)
    assert st["pads"] == 1 and st["calls"] == 3
    (pid,) = [k for k, v in trpc.pad_table().items() if v[0] == name]
    assert trpc.pad_stats(pid)["calls"] == 3
