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


# -- the call plan: made once a (landing pad, result specs, channel) --------

def _plan_of(name, pid_sig, result_shape):
    """This thread's host channel's plan and launch descriptor of
    ``name`` at the signature ``pid_sig`` and ``result_shape``."""
    from repro_torch.kernels.rpc_channel import host_channel
    pid = trpc.REGISTRY.pads[(name,) + pid_sig]
    channel = host_channel()
    plan = channel.plans[trpc.plan_key(pid, trpc._result_specs(result_shape))]
    assert plan.launch is channel.launches[plan.sid]
    return plan, plan.launch, channel


def _plan_cases():
    """The cases of test_rpc_value_and_ref_args_match_jax,
    test_rpc_narrow_and_bf16_operands_match_jax and
    test_rpc_empty_and_tuple_result_shapes_match_jax: ``(callee, JAX args,
    port args, JAX result shape, port result shape)``; the port's args
    are made anew at each call."""
    def scanf_like(scale, buf):
        buf[:] = np.arange(len(buf), dtype=np.float32) * float(scale)
        return np.int32(len(buf))

    def fill(idx, buf):
        buf[:] = np.float32(1.0 / 3.0) * (1 + np.asarray(idx, np.float32))
        return np.int32(idx.sum())

    i32 = (jax.ShapeDtypeStruct((), jnp.int32),
           trpc.ShapeDtype((), torch.int32))
    pair = ((jax.ShapeDtypeStruct((), jnp.int32),
             jax.ShapeDtypeStruct((), jnp.float32)),
            (trpc.ShapeDtype((), torch.int32),
             trpc.ShapeDtype((), torch.float32)))
    idx = np.arange(3, dtype=np.int64)
    return {
        "value_and_ref": (
            scanf_like, lambda: (3, jrpc.Ref(jnp.zeros(4, jnp.float32))),
            lambda: (3, trpc.Ref(torch.zeros(4))), *i32),
        "narrow_and_bf16": (
            fill, lambda: (idx, jrpc.Ref(jnp.zeros(3, jnp.bfloat16))),
            lambda: (torch.from_numpy(idx),
                     trpc.Ref(torch.zeros(3, dtype=torch.bfloat16))), *i32),
        "tuple_result": (
            _two_results, lambda: (jnp.int32(1),), lambda: (1,), *pair),
        "empty_result": (
            lambda x: None, lambda: (jnp.int32(7),), lambda: (7,), (), ()),
    }


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_call_plan_slot_table_matches_staging_layout(case):
    """The plan's slot table against its ``Staging`` region: tensor
    operands in slots 0, 1, ... in order, Python numbers in the scalar
    words in order, the result leaves after the operands, the write-backs
    back into their operand's slot; each row's offset and bytes the
    region's, its route by size (every slot here is under the limit)."""
    from repro_torch.kernels.rpc_channel import COPY_LIMIT, KERNEL
    fn, _, targs, _, tshape = _plan_cases()[case]
    name = f"torch_plan_{case}_{next(_ids)}"
    trpc.REGISTRY.register(name, fn)
    args = targs()
    trpc.rpc_call(name, *args, result_shape=tshape)
    specs, _, sig, ops, refs, _ = trpc._prepare(name, args, tshape, False,
                                                 None)
    plan, launch, _ = _plan_of(name, sig, tshape)
    staging = plan.staging
    tensors = [i for i, op in enumerate(ops) if isinstance(op, torch.Tensor)]
    assert plan.tensor_ops == tensors and plan.in_slots == list(
        range(len(tensors)))
    assert plan.word_ops == [i for i in range(len(ops)) if i not in tensors]
    n_res = len(trpc.leaves(specs))
    backs = [tensors.index(i) for i, acc, _ in refs if acc != trpc.READ]
    assert plan.out_slots == [len(tensors) + k for k in range(n_res)] + backs
    assert len(staging.slot_bytes) == len(tensors) + n_res
    assert [row[0] for row in launch.table] == plan.in_slots + plan.out_slots
    for slot, offset, nbytes, route, out in launch.table:
        assert offset == staging.offsets[slot] and offset % 256 == 0
        assert nbytes == staging.slot_bytes[slot]
        assert route == KERNEL and nbytes <= COPY_LIMIT
    assert [row[4] for row in launch.table] == \
        [False] * len(plan.in_slots) + [True] * len(plan.out_slots)
    for slot, i in zip(plan.in_slots, plan.tensor_ops):
        assert staging.slot_bytes[slot] == ops[i].numel() * \
            ops[i].element_size()


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_call_plan_round_trip_is_jax_bit_for_bit(case):
    """Two calls of each case through the plan (made at the first, taken
    at the second) give JAX's results and write-backs bit for bit."""
    fn, jargs, targs, jshape, tshape = _plan_cases()[case]
    name = f"torch_plan_rt_{case}_{next(_ids)}"
    jrpc.REGISTRY.register(name, fn)
    trpc.REGISTRY.register(name, fn)
    for _ in range(2):
        jr, jup = jrpc.rpc_call(name, *jargs(), result_shape=jshape)
        jax.effects_barrier()
        tr, tup = trpc.rpc_call(name, *targs(), result_shape=tshape)
        jl, tl = jax.tree.leaves(jr), trpc.leaves(tr)
        assert len(jl) == len(tl) and len(jup) == len(tup)
        for j, t in zip(jl + list(jup), tl + list(tup)):
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))
    from repro_torch.kernels.rpc_channel import host_channel
    plans = [k for k in host_channel().plans
             if trpc.REGISTRY.pad_info[k[0]][0] == name]
    assert len(plans) == 1
    _same_bookkeeping(name)


def test_call_plan_is_made_once_and_a_new_result_shape_makes_another():
    """The plan and its launch descriptor are made at the first call and
    taken by later ones; a new result shape of the same landing pad makes
    a new plan and a new staging id (F6), and the old shape's plan is
    taken again after it."""
    from repro_torch.kernels.rpc_channel import host_channel
    name = f"torch_plan_reply_{next(_ids)}"
    trpc.REGISTRY.register(name, _reply)
    channel = host_channel()
    seen = {}
    for i, P in enumerate((4, 4, 16, 4)):
        spec = trpc.ShapeDtype((P,), torch.int32)
        out, _ = trpc.rpc_call(name, torch.tensor(i, dtype=torch.int32), P,
                               result_shape=spec)
        np.testing.assert_array_equal(out.numpy(), _reply(i, P))
        pid = trpc.REGISTRY.pads[(name, ("val", (), "int32"),
                                  ("val", (), "int32"))]
        plan = channel.plans[trpc.plan_key(pid, spec)]
        launch = plan.launch
        assert launch is channel.launches[plan.sid]
        if P in seen:
            assert seen[P] == (plan, launch)
        seen[P] = (plan, launch)
    assert seen[4][0] is not seen[16][0]
    assert seen[4][0].sid != seen[16][0].sid
    assert channel.stagings.ids[trpc.staging_key(
        pid, trpc.ShapeDtype((16,), torch.int32))] == seen[16][0].sid
    assert trpc.rpc_stats(name)["pads"] == 1


def test_call_plan_rebinds_a_reregistered_callee():
    """A callee registered again under its name is the one a cached plan
    calls (the landing pad looks the name up at each call)."""
    from repro_torch.kernels.rpc_channel import host_channel
    name = f"torch_plan_rebind_{next(_ids)}"
    trpc.REGISTRY.register(name, lambda x: np.int32(x + 1))
    spec = trpc.ShapeDtype((), torch.int32)
    a, _ = trpc.rpc_call(name, 5, result_shape=spec)
    n_plans = len(host_channel().plans)
    trpc.REGISTRY.register(name, lambda x: np.int32(x * 10))
    b, _ = trpc.rpc_call(name, 5, result_shape=spec)
    assert (int(a), int(b)) == (6, 50)
    assert len(host_channel().plans) == n_plans
    assert trpc.rpc_stats(name)["calls"] == 2


def test_call_plan_routes_by_size_and_stays_bit_equal():
    """A READWRITE ref above ``COPY_LIMIT`` beside one below: the table
    gives the copy engines the large slot (operand and write-back) and
    the kernel the rest, and the round trip through the plan equals the
    host-synchronous version's and JAX's."""
    from repro_torch.kernels.rpc_channel import COPY_LIMIT, ENGINE, KERNEL

    def bump(small, big):
        small[:] = small * 3 + 1
        big[::4097] += 1.5
        return np.int32(small.size + big.size)

    name = f"torch_plan_routes_{next(_ids)}"
    jrpc.REGISTRY.register(name, bump)
    trpc.REGISTRY.register(name, bump)
    small = np.arange(1024, dtype=np.float32)
    big = np.linspace(0, 1, 2 * COPY_LIMIT // 4, dtype=np.float32)
    jr, (js, jb) = jrpc.rpc_call(name, jrpc.Ref(jnp.asarray(small)),
                                 jrpc.Ref(jnp.asarray(big)),
                                 result_shape=jax.ShapeDtypeStruct(
                                     (), jnp.int32))
    spec = trpc.ShapeDtype((), torch.int32)
    args = (trpc.Ref(torch.from_numpy(small.copy())),
            trpc.Ref(torch.from_numpy(big.copy())))
    tr, (ts, tb) = trpc.rpc_call(name, *args, result_shape=spec)
    pr, (ps, pb) = trpc.rpc_call_reference(name, *args, result_shape=spec)
    for t, p, j in ((tr, pr, jr), (ts, ps, js), (tb, pb, jb)):
        assert torch.equal(t, p)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    sig = (("ref", (1024,), "float32", "readwrite"),
           ("ref", (big.size,), "float32", "readwrite"))
    _, launch, _ = _plan_of(name, sig, spec)
    assert [(row[0], row[3], row[4]) for row in launch.table] == [
        (0, KERNEL, False), (1, ENGINE, False), (2, KERNEL, True),
        (0, KERNEL, True), (1, ENGINE, True)]
    assert [row[2] for row in launch.table] == [
        4096, 2 * COPY_LIMIT, 4, 4096, 2 * COPY_LIMIT]


def test_call_plan_refuses_more_kernel_slots_than_the_table_holds():
    """``MAX_SLOTS`` tensor slots under the limit fit the descriptor (the
    host channel takes the same table); one more is refused before the
    callee runs."""
    from repro_torch.kernels.rpc_channel import MAX_SLOTS
    runs = []

    def count(*arrays):
        runs.append(len(arrays))
        return np.int32(sum(int(a.sum()) for a in arrays))

    name = f"torch_plan_slots_{next(_ids)}"
    trpc.REGISTRY.register(name, count)
    spec = trpc.ShapeDtype((), torch.int32)
    args = [torch.full((2,), k, dtype=torch.int32) for k in range(MAX_SLOTS)]
    out, _ = trpc.rpc_call(name, *args[:-1], result_shape=spec)
    assert int(out) == 2 * sum(range(MAX_SLOTS - 1))
    with pytest.raises(ValueError, match="tensor slots"):
        trpc.rpc_call(name, *args, result_shape=spec)
    assert runs == [MAX_SLOTS - 1]


def test_result_specs_are_kept_by_value_only():
    """Result specs made from ShapeDtypes (alone or in a tuple) are made
    once and looked up by value; a tree of tensors is mapped at each call
    and none of its tensors is kept."""
    import weakref
    a = trpc._result_specs(trpc.ShapeDtype((3,), torch.int32))
    b = trpc._result_specs(trpc.ShapeDtype((3,), torch.int32))
    assert a is b and a == trpc.ShapeDtype((3,), torch.int32)
    pair = (trpc.ShapeDtype((), torch.int32),
            trpc.ShapeDtype((2,), torch.float32))
    assert trpc._result_specs(pair) is trpc._result_specs(tuple(pair))
    like = torch.zeros(2, 5, dtype=torch.bfloat16)
    gone = weakref.ref(like)
    specs = trpc._result_specs((like,))
    assert specs == (trpc.ShapeDtype((2, 5), torch.bfloat16),)
    name = f"torch_specs_{next(_ids)}"
    trpc.REGISTRY.register(name, lambda: np.ones((2, 5), np.float32))
    out, _ = trpc.rpc_call(name, result_shape=like)
    assert out.shape == (2, 5) and out.dtype == torch.bfloat16
    del like
    assert gone() is None


@pytest.mark.parametrize("rows, want", [
    ([], (1, 0)),                                   # an empty call
    ([(0, 256, 4, "kernel", True)], (1, 1)),        # an int32 result
    ([(0, 256, 1 << 20, "kernel", False),
      (1, 0, 4, "kernel", True)], (64, 1)),          # 1 MB in, 4 B back
    ([(0, 256, 4096, "kernel", False),
      (0, 256, 4096, "kernel", True)], (1, 1)),      # a 4 KB ref
    ([(0, 256, 1 << 20, "kernel", False),
      (0, 256, 1 << 20, "kernel", True)], (64, 64)),  # a 1 MB ref
    ([(k, 0, 1 << 20, "kernel", False) for k in range(200)] +
     [(k, 0, 1 << 20, "kernel", True) for k in range(200)], (132, 132)),
    ([(0, 256, 64, "kernel", False)] * 5, (1, 0)),   # operands only
])
def test_launch_grid_holds_one_block_an_sm_and_waits_only_for_results(
        rows, want):
    """A launch's grid: a block a 16 KB each way, at most one an SM (132
    on the H100); the blocks that wait for the host are those that copy
    results back, the rest exit after the operands."""
    from repro_torch.kernels.rpc_channel.kernel import BLOCK_BYTES, grids
    assert BLOCK_BYTES == 16 << 10
    grid, out_grid = grids(rows, 132)
    assert (grid, out_grid) == want and 0 <= out_grid <= grid <= 132


def test_launch_refuses_a_call_that_does_not_match_its_slots():
    """A staging id's launch is made once, with its slots; a later post
    with another number of tensors is refused before the callee runs."""
    from repro_torch.kernels.rpc_channel import host_channel
    runs = []
    name = f"torch_plan_count_{next(_ids)}"
    trpc.REGISTRY.register(name, lambda x: runs.append(1) or np.int32(x))
    spec = trpc.ShapeDtype((), torch.int32)
    x = torch.tensor(3, dtype=torch.int32)
    out, _ = trpc.rpc_call(name, x, result_shape=spec)
    assert int(out) == 3 and runs == [1]
    sig = (("val", (), "int32"),)
    plan, launch, channel = _plan_of(name, sig, spec)
    with pytest.raises(ValueError, match="inputs and"):
        channel.post(plan.sid, [x, x], [0, 0], [], [torch.empty_like(x)],
                     plan.out_slots)
    assert runs == [1]
