"""Port's transport sanitizer against the JAX package's (CPU queues).

Each case of tests/test_sanitizer.py (all but the ``expand`` one, which
needs a ShardedRpcQueue and a mesh) runs in both packages on the same
records: ``sanitize_stats()`` (its epoch records included) and the records
delivered must be equal, and so must the payload arena word for word,
canaries at the same offsets.  The arena of a plain queue stays as it
was: no canaries.  An async sanitized queue is held the same way."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis.sanitize import poison_free as j_poison_free  # noqa: E402
from repro.core import rpc as jrpc  # noqa: E402
from repro.core.allocator import GenericAllocator as JGA  # noqa: E402
from repro_torch.analysis import (CANARY, POISON, poison_free,  # noqa: E402
                                  reset_sanitize_stats, sanitize_stats)
from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.core.allocator import GenericAllocator as TGA  # noqa: E402

JI32 = jax.ShapeDtypeStruct((), jnp.int32)
TI32 = trpc.ShapeDtype((), torch.int32)
RECS = {"jax": [], "port": []}


def _rec(key):
    def rec(*args):
        RECS[key].append(tuple(np.asarray(a).tolist() for a in args))
    return rec


for _key, _reg in (("jax", jrpc.REGISTRY), ("port", trpc.REGISTRY)):
    _reg.register("tsan.rec", _rec(_key))
    _reg.register("tsan.probe",
                  lambda ptr, base, size, found, arena: np.int32(found))
    _reg.register("tsan.echo", lambda x: np.int32(x))
    _reg.register("tsan.boom", lambda x: 1 // 0)


@pytest.fixture(autouse=True)
def _fresh():
    for v in RECS.values():
        v.clear()
    jrpc.reset_sanitize_stats()
    reset_sanitize_stats()
    yield


def _same_stats():
    j, t = jrpc.sanitize_stats(), sanitize_stats()
    assert t == j
    return t


def _tq(*a, **kw):
    return trpc.RpcQueue.create(*a, device="cpu", **kw)


def _same_pbuf(jq, tq):
    np.testing.assert_array_equal(np.asarray(jq.pbuf), tq.pbuf.numpy())


def test_constants_are_jax_s():
    assert int(CANARY) == int(jrpc.CANARY) == 0x7FC0FFEE
    assert int(POISON) == int(jrpc.POISON) == 0x5A5A5A5A


@pytest.mark.parametrize("sanitize", [False, True])
def test_flush_clean_and_transparent(sanitize):
    """A hazard-free program: the records a plain and a sanitized queue
    deliver are identical, the counters stay zero and a sanitized flush
    leaves one epoch record; the arena matches JAX's word for word."""
    jq = jrpc.RpcQueue.create(8, 4, 64, sanitize=sanitize)
    jq = jq.enqueue("tsan.rec", jnp.int32(3), jnp.arange(5))
    jq = jq.enqueue("tsan.rec", jnp.float32(1.5))
    jq = jq.enqueue("tsan.rec", jnp.arange(3.0), 7, jnp.arange(2))
    tq = _tq(8, 4, 64, sanitize=sanitize)
    tq.enqueue("tsan.rec", torch.tensor(3, dtype=torch.int32),
               torch.arange(5))
    tq.enqueue("tsan.rec", torch.tensor(1.5))
    tq.enqueue("tsan.rec", torch.arange(3.0), 7, torch.arange(2))
    _same_pbuf(jq, tq)
    np.testing.assert_array_equal(np.asarray(jq.ivals), tq.ivals.numpy())
    np.testing.assert_array_equal(np.asarray(jq.plens), tq.plens.numpy())
    pbuf = tq.pbuf.numpy()
    canaries = np.flatnonzero(pbuf == int(CANARY)).tolist()
    assert canaries == ([0, 6, 7, 11, 12, 15] if sanitize else [])
    assert int(tq.phead) == (16 if sanitize else 10)
    jq.flush()
    tq.flush()
    assert RECS["port"] == RECS["jax"] and len(RECS["jax"]) == 3
    st = _same_stats()
    assert st["canary_stomps"] == st["poison_hits"] == 0
    assert len(st["epochs"]) == (1 if sanitize else 0)
    if sanitize:
        assert st["epochs"][0]["records"] == 3
        assert st["epochs"][0]["payloads_checked"] == 3


@pytest.mark.parametrize("word,value", [(0, 0), (5, 7), (1, 9)])
def test_canary_stomp_detected_at_flush(word, value):
    """Word 0 is the leading canary of a 4-word payload, word 5 its
    trailing one (an overrun); word 1 is payload, no stomp."""
    jq = jrpc.RpcQueue.create(8, 4, 64, sanitize=True)
    jq = jq.enqueue("tsan.rec", jnp.arange(4))
    jq = dataclasses.replace(jq, pbuf=jq.pbuf.at[word].set(jnp.int32(value)))
    tq = _tq(8, 4, 64, sanitize=True)
    tq.enqueue("tsan.rec", torch.arange(4))
    tq.pbuf[word] = value
    _same_pbuf(jq, tq)
    jq.flush()
    tq.flush()
    st = _same_stats()
    assert st["canary_stomps"] == (0 if word == 1 else 1)
    assert RECS["port"] == RECS["jax"]


def test_bad_descriptor_counts_as_stomp():
    """A descriptor that leaves no room for both canaries is a stomp."""
    jq = jrpc.RpcQueue.create(8, 4, 16, sanitize=True)
    jq = jq.enqueue("tsan.rec", jnp.arange(3))
    jq = dataclasses.replace(jq, ivals=jq.ivals.at[0, 0].set(0))
    tq = _tq(8, 4, 16, sanitize=True)
    tq.enqueue("tsan.rec", torch.arange(3))
    tq.ivals[0, 0] = 0
    jq.flush()
    tq.flush()
    assert _same_stats()["canary_stomps"] == 1


def test_poison_free_uaf_hits_at_flush():
    """The seeded use-after-free: free a block with poison_free, then
    marshal its stale words; the same program on a live block is
    silent."""
    jst, tst = JGA.init(64), TGA.init(64, device="cpu")
    jbuf = jnp.arange(64, dtype=jnp.int32)
    tbuf = torch.arange(64, dtype=torch.int32)
    jst, jp = JGA.malloc(jst, 8)
    tst, tp = TGA.malloc(tst, 8)
    jst, jbuf = j_poison_free(JGA, jst, jbuf, jp)
    tst, tbuf = poison_free(TGA, tst, tbuf, tp)
    np.testing.assert_array_equal(np.asarray(jbuf), tbuf.numpy())
    np.testing.assert_array_equal(np.asarray(jst.in_use), tst.in_use.numpy())
    jq = jrpc.RpcQueue.create(8, 4, 64, sanitize=True)
    jq = jq.enqueue("tsan.rec", jax.lax.dynamic_slice(jbuf, (jp,), (8,)))
    jq.flush()
    tq = _tq(8, 4, 64, sanitize=True)
    tq.enqueue("tsan.rec", tbuf.narrow(0, int(tp), 8))
    tq.flush()
    assert _same_stats()["poison_hits"] == 1
    # an unknown pointer poisons nothing
    _, tbuf2 = poison_free(TGA, tst, tbuf, 40)
    assert torch.equal(tbuf2, tbuf)
    jrpc.reset_sanitize_stats()
    reset_sanitize_stats()
    jq = jrpc.RpcQueue.create(8, 4, 64, sanitize=True)
    jq.enqueue("tsan.rec", jnp.zeros((8,), jnp.int32)).flush()
    tq = _tq(8, 4, 64, sanitize=True)
    tq.enqueue("tsan.rec", torch.zeros(8, dtype=torch.int32)).flush()
    assert _same_stats()["poison_hits"] == 0
    assert RECS["port"] == RECS["jax"]


def test_uaf_marshal_counter_on_freed_arena_ref():
    jst, tst = JGA.init(64), TGA.init(64, device="cpu")
    jst, jp = JGA.malloc(jst, 8)
    tst, tp = TGA.malloc(tst, 8)
    jst, tst = JGA.free(jst, jp), TGA.free(tst, tp)
    jr, _ = jrpc.rpc_call("tsan.probe", jrpc.ArenaRef(
        jnp.zeros((64,), jnp.int32), jp, jst, access=jrpc.READ),
        result_shape=JI32)
    tr, _ = trpc.rpc_call("tsan.probe", trpc.ArenaRef(
        torch.zeros(64, dtype=torch.int32), tp, tst, access=trpc.READ),
        result_shape=TI32)
    jax.effects_barrier()
    assert int(jr) == int(tr) == 0
    assert _same_stats()["uaf_marshals"] == 1
    # a live block marshals without a count
    tst, tp = TGA.malloc(tst, 8)
    trpc.rpc_call("tsan.probe", trpc.ArenaRef(
        torch.zeros(64, dtype=torch.int32), tp, tst, access=trpc.READ),
        result_shape=TI32)
    assert sanitize_stats()["uaf_marshals"] == 1


def test_stale_ticket_read_counter():
    jq = jrpc.RpcQueue.create(8, 4, 64, reply_capacity=8, sanitize=True)
    tq = _tq(8, 4, 64, reply_capacity=8, sanitize=True)
    jq, jt = jq.enqueue_ticketed("tsan.echo", jnp.int32(5), returns=JI32)
    _, tt = tq.enqueue_ticketed("tsan.echo", 5, returns=TI32)
    jq, tq = jq.flush(), tq.flush()
    (jv, jok), = jq.results_host([int(jt)], JI32)
    (tv, tok), = tq.results_host([int(tt)], TI32)
    assert jok and tok and int(jv) == int(tv) == 5
    jq = jq.enqueue("tsan.rec", jnp.int32(0)).flush()
    tq.enqueue("tsan.rec", 0).flush()
    (_, jok), = jq.results_host([int(jt)], JI32)
    (_, tok), = tq.results_host([int(tt)], TI32)
    assert not jok and not tok
    st = _same_stats()
    assert st["stale_ticket_reads"] == 1
    assert [e["declared_replies"] for e in st["epochs"]] == [1, 0]


def test_failed_ticket_read_counter_on_cpu_queue():
    """result() of a failed ticket consumes zeros: counted on a sanitized
    CPU queue (a card queue's result() reads nothing back)."""
    import warnings
    jq = jrpc.RpcQueue.create(8, 4, 64, reply_capacity=2, sanitize=True)
    tq = _tq(8, 4, 64, reply_capacity=2, sanitize=True)
    jq, jt = jq.enqueue_ticketed("tsan.boom", jnp.int32(5), returns=JI32)
    _, tt = tq.enqueue_ticketed("tsan.boom", 5, returns=TI32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jq, tq = jq.flush(), tq.flush()
        assert int(jq.result(jt)) == int(tq.result(tt)) == 0
    assert _same_stats()["failed_ticket_reads"] == 1


def test_plain_queue_records_no_epochs():
    jq = jrpc.RpcQueue.create(8, 4, 64)
    jq.enqueue("tsan.rec", jnp.arange(3)).flush()
    _tq(8, 4, 64).enqueue("tsan.rec", torch.arange(3)).flush()
    assert _same_stats()["epochs"] == []
    assert RECS["port"] == RECS["jax"]


def test_async_sanitized_queue_matches_jax():
    """An async sanitized queue: one epoch record per submitted epoch,
    the stomp counted when its epoch is submitted, replies one epoch
    late, as JAX's."""
    jq = jrpc.RpcQueue.create(8, 4, 64, reply_capacity=8, sanitize=True,
                              mode="async")
    tq = _tq(8, 4, 64, reply_capacity=8, sanitize=True, mode="async")
    jq, jt = jq.enqueue_ticketed("tsan.echo", jnp.int32(9), returns=JI32)
    _, tt = tq.enqueue_ticketed("tsan.echo", 9, returns=TI32)
    jq = jq.enqueue("tsan.rec", jnp.arange(4))
    tq.enqueue("tsan.rec", torch.arange(4))
    _same_pbuf(jq, tq)
    jq = dataclasses.replace(jq, pbuf=jq.pbuf.at[5].set(jnp.int32(1)))
    tq.pbuf[5] = 1
    jq, tq = jq.flush(), tq.flush()
    jq = jq.enqueue("tsan.rec", jnp.arange(2)).flush()
    tq.enqueue("tsan.rec", torch.arange(2)).flush()
    jq.join()
    tq.join()
    (jv, jok), = jq.results_host([int(jt)], JI32)
    (tv, tok), = tq.results_host([int(tt)], TI32)
    assert jok and tok and int(jv) == int(tv) == 9
    st = _same_stats()
    assert st["canary_stomps"] == 1 and len(st["epochs"]) == 2
    assert RECS["port"] == RECS["jax"]
