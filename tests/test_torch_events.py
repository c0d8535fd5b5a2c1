"""Port's runtime events against the JAX package's.

The same eager program (heap operations, a sanitized queue's enqueues,
flush and reads, an immediate call with an ArenaRef, nested scopes) runs
in both packages under ``events.record``: the streams must agree in
kinds, order, scopes and data, leaving out object ids and call sites.
The port's sites must point at this file, not into the runtime."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import allocator as JA  # noqa: E402
from repro.core import device_main as jdm  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import rpc as jrpc  # noqa: E402
from repro_torch.core import allocator as TA  # noqa: E402
from repro_torch.core import device_main as tdm  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402

IDS = ("site", "_refs", "qid", "qid_out", "ptr_id", "ticket_id")

for _reg in (jrpc.REGISTRY, trpc.REGISTRY):
    _reg.register("tev.rec", lambda *a: None)
    _reg.register("tev.echo", lambda x: np.int32(x), idempotent=True)
    _reg.register("tev.probe",
                  lambda ptr, base, size, found, arena: np.int32(found))


def _strip(stream):
    """Events without ids and sites; scope frames as (kind, value) with
    their uids renumbered in order of first appearance."""
    uids, out = {}, []
    for ev in stream:
        d = {k: v for k, v in ev.items() if k not in IDS}
        d["scopes"] = tuple((k, uids.setdefault(u, len(uids)), v)
                            for k, u, v in ev["scopes"])
        out.append(d)
    return out


def _jax_program():
    st = JA.GenericAllocator.init(64, cap=8)
    st, p1 = JA.GenericAllocator.malloc(st, 8)
    st, p2 = JA.GenericAllocator.malloc(st, 4)
    st = JA.GenericAllocator.free(st, p1)
    JA.find_obj(st, p2)
    sc = JA.SizeClassAllocator.init(128, cap=8)
    sc, p3 = JA.SizeClassAllocator.malloc(sc, 5)
    sc = JA.SizeClassAllocator.free(sc, p3)
    q = jrpc.RpcQueue.create(8, 4, 64, reply_capacity=8, sanitize=True)
    with jev.loop_scope(3):
        q = q.enqueue("tev.rec", jnp.int32(3), jnp.arange(4))
        with jev.cond_scope(2):
            q, t = q.enqueue_ticketed("tev.echo", jnp.int32(5),
                                      returns=jax.ShapeDtypeStruct(
                                          (), jnp.int32))
    q = q.flush()
    q.result_ok(t)
    q.result_status(t)
    jrpc.rpc_call("tev.probe", jrpc.ArenaRef(
        jnp.zeros((64,), jnp.int32), p2, st, access=jrpc.READ),
        result_shape=jax.ShapeDtypeStruct((), jnp.int32))
    jax.effects_barrier()


def _port_program():
    st = TA.GenericAllocator.init(64, cap=8, device="cpu")
    st, p1 = TA.GenericAllocator.malloc(st, 8)
    st, p2 = TA.GenericAllocator.malloc(st, 4)
    st = TA.GenericAllocator.free(st, p1)
    TA.find_obj(st, p2)
    sc = TA.SizeClassAllocator.init(128, cap=8, device="cpu")
    sc, p3 = TA.SizeClassAllocator.malloc(sc, 5)
    sc = TA.SizeClassAllocator.free(sc, p3)
    q = trpc.RpcQueue.create(8, 4, 64, reply_capacity=8, sanitize=True,
                             device="cpu")
    with tev.loop_scope(3):
        q.enqueue("tev.rec", 3, torch.arange(4))
        with tev.cond_scope(2):
            _, t = q.enqueue_ticketed("tev.echo", 5,
                                      returns=trpc.ShapeDtype((),
                                                              torch.int32))
    q.flush()
    q.result_ok(t)
    q.result_status(t)
    trpc.rpc_call("tev.probe", trpc.ArenaRef(
        torch.zeros(64, dtype=torch.int32), p2, st, access=trpc.READ),
        result_shape=trpc.ShapeDtype((), torch.int32))


def test_event_stream_matches_jax():
    jstream, tstream = [], []
    with jev.record(jstream):
        _jax_program()
    with tev.record(tstream):
        _port_program()
    assert not tev.active() and tev.scopes() == ()
    j, t = _strip(jstream), _strip(tstream)
    assert [e["kind"] for e in t] == [e["kind"] for e in j]
    assert t == j
    kinds = {e["kind"] for e in t}
    assert kinds >= {"heap_malloc", "heap_free", "ptr_lookup",
                     "queue_create", "rpc_enqueue", "rpc_flush",
                     "rpc_result", "rpc_immediate", "arena_marshal"}


def test_port_sites_point_at_the_caller():
    stream = []
    with tev.record(stream):
        _port_program()
    assert stream
    for ev in stream:
        assert ev["site"].split(":")[0].endswith("test_torch_events.py"), ev


def test_no_subscriber_records_nothing():
    stream = []
    _port_program()
    with tev.record(stream):
        pass
    assert stream == [] and not tev.active()


def test_cuda_pointer_is_never_read():
    """A heap event's ptr reads no device: None for a CUDA tensor (as
    JAX's for a tracer); a CPU tensor's value is given."""
    assert TA._concrete_int(torch.tensor(7, dtype=torch.int32)) == 7
    assert TA._concrete_int(5) == 5
    assert TA._concrete_int(torch.arange(3)) is None
    if torch.cuda.is_available():       # pragma: no cover (the card)
        assert TA._concrete_int(torch.tensor(7, device="cuda")) is None


def test_device_run_events_match_jax_scopes():
    """device_run's hook_decl events, the step loop's loop_scope and each
    hook's cond_scope.  JAX traces the loop body once; the eager port
    emits at each firing, so the port's stream, repeats dropped, is
    JAX's.  A silent step of a batched hook enqueues nothing on the port,
    so its firing's record is unconditional (``conditional`` differs)."""
    hooks = dict(
        jax=[jdm.HostHook(every=2, extract=lambda s, st: st,
                          host_fn=lambda s, x: None, name="tev.h",
                          batched=True),
             jdm.HostHook(every=3, extract=lambda s, st: st[0],
                          host_fn=lambda s, x: None, name="tev.i")],
        port=[tdm.HostHook(every=2, extract=lambda s, st: st,
                           host_fn=lambda s, x: None, name="tev.h",
                           batched=True),
              tdm.HostHook(every=3, extract=lambda s, st: st[0],
                           host_fn=lambda s, x: None, name="tev.i")])
    jstream, tstream = [], []
    with jev.record(jstream):
        jdm.device_run(lambda s, st: st + 1, jnp.zeros(3), 4,
                       hooks=hooks["jax"])
        jax.effects_barrier()
    with tev.record(tstream):
        tdm.device_run(lambda s, st: st + 1, torch.zeros(3), 4,
                       hooks=hooks["port"])

    def key(ev):
        d = {k: v for k, v in ev.items()
             if k not in IDS + ("conditional",)}
        d["scopes"] = tuple((k, v) for k, _, v in ev["scopes"])
        return d

    port, seen = [], []
    for ev in map(key, tstream):
        if ev not in seen:
            seen.append(ev)
            port.append(ev)
    assert port == [key(e) for e in jstream]
    firings = [(e["kind"], e["name"]) for e in tstream
               if e["kind"] in ("rpc_enqueue", "rpc_immediate")]
    assert firings == [("rpc_enqueue", "tev.h"), ("rpc_immediate", "tev.i"),
                       ("rpc_enqueue", "tev.h")]
