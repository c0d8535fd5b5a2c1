"""The port's async queue (``RpcQueue(mode="async")``) against the JAX
package's, on the CPU, bit for bit.

Seeded and directed plans of enqueues and flushes (JAX's differential
geometry: capacity 5, width 3, a 14-word arena and a 9-word reply arena)
run through the JAX async queue, the port's CPU async queue and the
pure-Python ``RefAsyncQueue`` of ``tests/test_rpc_differential.py``
(imported from there, with its callees, plans and payload rule).  After
every flush both queues are joined; then every lane (the window's
``pbase``/``pcount``/``cdepth`` included), every ticket's host status and
reply, and the carry outcomes must be equal, and at the end the callees'
replay logs, ``flush_stats`` and the fired faults.  The same plans run
under ``FaultPlan.generate(seed)`` with ``carry_budget`` 0..2 (occurrences
reserved at the flush, in flush order).  Then the async cases of
``tests/test_rpc_transport.py`` (pipelining, carry redrive, budget
exhaustion, create validations, ``device_run(queue_async=True)``'s
boundary) and a deadline overrun (``STATUS_TIMEOUT`` across the window,
the late drain abandoned before it carries anything), each through both
packages.

One lane is compared from the second flush on: ``cdepth`` after the
first flush (and ``pressure()``, which reads it).  JAX reads it right
after submitting the first epoch, racing that epoch's drain (0, or what
the drain has carried by then, by the scheduler's choice); the port
reads 0 there (no epoch has been collected, so nothing is carried yet),
which the tests check."""
import dataclasses
import random
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_rpc_differential as jdiff  # noqa: E402
from repro.core import device_main as jdm  # noqa: E402
from repro.core import rpc as jrpc  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.core import device_main as tdm  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402

_PORT_SEEN = []   # the port's callees' replay log, jdiff._SEEN's format


def _port_callee(kind):
    model = jdiff._MODEL_HOSTS[kind]

    def fn(tag, nrep, arr=None):
        _PORT_SEEN.append((kind, int(tag),
                           None if arr is None else np.asarray(arr).tolist()))
        reply = model(int(tag), int(nrep),
                      None if arr is None else np.asarray(arr).tolist())
        return np.asarray(reply, np.int32 if kind == "i" else np.float32)

    return fn


@pytest.fixture(autouse=True)
def _port_callees():
    """The port's ``diff.*`` callees for each test, and whatever another
    test module bound under those names restored afterwards."""
    reg = trpc.REGISTRY
    saved = {n: (reg.hosts.get(n), reg.idempotent.get(n, False))
             for n in ("diff.int", "diff.float")}
    reg.register("diff.int", _port_callee("i"), idempotent=True)
    reg.register("diff.float", _port_callee("f"))
    yield
    for name, (fn, idem) in saved.items():
        if fn is not None:
            reg.register(name, fn, idempotent=idem)


def _port_enqueue(q, kind, tag, nrep, payload, where):
    """The port's twin of ``jdiff._dev_enqueue``."""
    name = "diff.int" if kind == "i" else "diff.float"
    args = [torch.tensor(tag, dtype=torch.int32), nrep]
    if payload is not None:
        args.append(torch.tensor(
            payload, dtype=torch.int32 if kind == "i" else torch.float32))
    returns = (trpc.ShapeDtype(
        (nrep,), torch.int32 if kind == "i" else torch.float32)
        if nrep > 0 else None)
    w = None if where is None else torch.tensor(where)
    _, t = q.enqueue_ticketed(name, *args, returns=returns, where=w)
    return int(t)


_LANES = ("callee", "nargs", "imask", "pmask", "ivals", "fvals", "plens",
          "pbuf", "head", "phead", "adrops", "rwant", "base", "rbuf",
          "roff", "rlen", "rstat", "rbase", "rcount", "fonce", "pbase",
          "pcount", "cdepth")


def _same_lanes(jq, tq, first_flush=False):
    """Every lane equal; right after the first flush ``cdepth`` is the
    port's 0 (JAX's races its first drain; see the module docstring)."""
    if first_flush:
        assert int(tq.cdepth) == 0
    for name in _LANES:
        if first_flush and name == "cdepth":
            continue
        a = np.asarray(getattr(jq, name))
        b = getattr(tq, name).numpy()
        if name == "fvals":
            a, b = a.view(np.int32), b.view(np.int32)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _outcomes(q):
    return {t: (st, None if w is None else np.asarray(w).tolist())
            for t, (st, w) in q.carry_outcomes().items()}


def _plans(faults, fault_seed):
    if faults is not None:
        return (jfaults.FaultPlan(faults), tfaults.FaultPlan(
            [tfaults.Fault(*dataclasses.astuple(f)) for f in faults]),
            jfaults.FaultPlan(faults))
    if fault_seed is not None:
        jp = jfaults.FaultPlan.generate(fault_seed, ["diff.int",
                                                     "diff.float"])
        tp = tfaults.FaultPlan.generate(fault_seed, ["diff.int",
                                                     "diff.float"])
        return jp, tp, jfaults.FaultPlan(jp.faults)
    return None, None, None


def _check_async(plan, fault_seed=None, faults=None, carry_budget=0):
    """One plan through JAX's async queue, the port's and the model, with
    the tail of ``jdiff._check_single_async`` (submit, collect and
    ``carry_budget`` more flushes)."""
    jrpc.reset_rpc_stats()
    trpc.reset_rpc_stats()
    jdiff._SEEN.clear()
    _PORT_SEEN.clear()
    jplan, tplan, rplan = _plans(faults, fault_seed)
    jq = jrpc.RpcQueue.create(jdiff.CAP, width=jdiff.WIDTH,
                              payload_capacity=jdiff.PC,
                              reply_capacity=jdiff.RC, mode="async",
                              carry_budget=carry_budget)
    tq = trpc.RpcQueue.create(jdiff.CAP, width=jdiff.WIDTH,
                              payload_capacity=jdiff.PC,
                              reply_capacity=jdiff.RC, mode="async",
                              carry_budget=carry_budget, device="cpu")
    ref = jdiff.RefAsyncQueue(carry_budget=carry_budget)
    tickets, expect_seen, nflush = [], [], [0]

    def flush(jq):
        _same_lanes(jq, tq, first_flush=nflush[0] == 1)
        assert (int(tq.head), int(tq.phead), int(tq.adrops)) == \
            (ref.head, ref.phead, ref.adrops)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jrpc.set_fault_injector(jplan)
            try:
                jq = jq.flush()
                assert jq.join()
                jax.effects_barrier()
            finally:
                jrpc.set_fault_injector(None)
            trpc.set_fault_injector(tplan)
            try:
                tq.flush()
                assert tq.join()
            finally:
                trpc.set_fault_injector(None)
        seen, *_ = ref.flush(rplan)
        expect_seen.extend(seen)
        nflush[0] += 1
        _same_lanes(jq, tq, first_flush=nflush[0] == 1)
        tix = [t for t, _, _ in tickets]
        want = [ref.result_status(t) for t in tix]
        assert tq.statuses_host(tix) == jq.statuses_host(tix) == want
        for t, nrep, kind in tickets:
            if nrep:
                (tv, tok), = tq.results_host(
                    [t], (nrep,), torch.int32 if kind == "i"
                    else torch.float32)
                (jv, jok), = jq.results_host(
                    [t], (nrep,), jnp.int32 if kind == "i" else jnp.float32)
                assert tv.tolist() == np.asarray(jv).tolist() == \
                    ref.result(t, nrep, kind), (t, nrep, kind)
                assert tok == jok
        assert _outcomes(tq) == _outcomes(jq)
        return jq

    for op in plan:
        if op[0] == "flush":
            jq = flush(jq)
            continue
        _, kind, tag, plen, nrep, where = op
        payload = jdiff._payload_for(kind, plen, tag)
        jq, tj = jdiff._dev_enqueue(jq, kind, tag, nrep, payload, where)
        tt = _port_enqueue(tq, kind, tag, nrep, payload, where)
        assert tj == tt == ref.enqueue(kind, tag, nrep, payload, where)
        tickets.append((tj, nrep, kind))
    jq = flush(jq)                      # submit the tail epoch
    jq = flush(jq)                      # collect it
    for _ in range(carry_budget):
        jq = flush(jq)                  # retire carried records
    assert _PORT_SEEN == jdiff._SEEN == expect_seen
    assert trpc.flush_stats() == jrpc.flush_stats()
    assert float(tq.pressure()) == float(jq.pressure())
    if jplan is not None:
        assert tplan.fired == jplan.fired == rplan.fired


def test_directed_async_epoch_late_and_stale():
    _check_async([("enq", "i", 1, -1, 2, None), ("flush",),
                  ("enq", "f", 2, -1, 1, None), ("enq", "i", 3, 2, 2, None),
                  ("flush",), ("flush",)])


def test_directed_async_overflow_and_conditional():
    plan = [("enq", "i", t, -1, 2, None) for t in range(jdiff.CAP + 2)] + \
        [("flush",), ("enq", "i", 9, 7, 4, None), ("enq", "f", 8, 7, 4, None),
         ("enq", "i", 7, 5, 2, None), ("enq", "i", 6, -1, 4, None),
         ("enq", "i", 5, 3, 1, False), ("flush",)]
    _check_async(plan)


def test_directed_async_carry_matches_jax():
    plan = [("enq", "i", 1, -1, 2, None), ("enq", "i", 2, 3, 2, None),
            ("enq", "f", 3, -1, 1, None), ("flush",),
            ("enq", "i", 4, -1, 1, None), ("flush",)]
    _check_async(plan, faults=(jfaults.Fault("raise", "diff.int", 1),),
                 carry_budget=2)


def test_directed_async_carry_budget_exhaustion():
    faults = tuple(jfaults.Fault("raise", "diff.int", 0, attempt=a)
                   for a in (1, 2, 3))
    _check_async([("enq", "i", 1, -1, 2, None), ("enq", "f", 2, -1, 1, None),
                  ("flush",)], faults=faults, carry_budget=2)


@pytest.mark.parametrize("seed", range(8))
def test_seeded_async_plans_equal_jax(seed):
    _check_async(jdiff._random_plan(random.Random(5000 + seed)))


@pytest.mark.parametrize("seed", range(8))
def test_seeded_async_fault_plans_equal_jax(seed):
    _check_async(jdiff._random_plan(random.Random(6000 + seed)),
                 fault_seed=seed, carry_budget=seed % 3)


# -- tests/test_rpc_transport.py's async cases, through both packages --------

_JI32 = jax.ShapeDtypeStruct((), jnp.int32)
_TI32 = trpc.ShapeDtype((), torch.int32)


def _both(name, fn, idempotent=False):
    jrpc.REGISTRY.register(name, fn, idempotent=idempotent)
    trpc.REGISTRY.register(name, fn, idempotent=idempotent)


def test_async_flush_pipelines_epochs():
    """The first flush submits (the ticket reads PENDING), the next one
    collects the reply."""
    _both("as.echo", lambda x: np.int32(x) + 1)
    reads = []
    for mod, q, arg, i32 in (
            (jrpc, jrpc.RpcQueue.create(8, width=2, reply_capacity=8,
                                        mode="async"), jnp.int32(41), _JI32),
            (trpc, trpc.RpcQueue.create(8, width=2, reply_capacity=8,
                                        mode="async", device="cpu"),
             torch.tensor(41, dtype=torch.int32), _TI32)):
        q, t = q.enqueue_ticketed("as.echo", arg, returns=i32)
        q = q.flush()
        got = [int(q.result_status(t)), q.statuses_host([t])]
        q = q.flush()
        (val, ok), = q.results_host([t])
        got += [int(q.result_status(t)), int(q.result(t)), int(val), ok,
                q.join()]
        reads.append(got)
    assert reads[0] == reads[1] == [
        trpc.STATUS_PENDING, [trpc.STATUS_PENDING], trpc.STATUS_OK, 42, 42,
        True, True]


def _flaky(fail_first):
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if fail_first is None or calls["n"] <= fail_first:
            raise RuntimeError("transient")
        return np.int32(x)

    return flaky, calls


def _carry_run(mod, queue, arg, i32, name, budget, flushes):
    q = queue(8, width=2, reply_capacity=8, mode="async",
              carry_budget=budget)
    q, t = q.enqueue_ticketed(name, arg, returns=i32)
    trail = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for k in range(flushes):
            q = q.flush()
            assert q.join()
            # pressure() reads cdepth: from the second flush on (see the
            # module docstring)
            trail.append((q.statuses_host([t]),
                          float(q.pressure()) if k else None))
    (val, ok), = q.results_host([t])
    oc = {k: (s, None if w is None else w.tolist())
          for k, (s, w) in q.carry_outcomes().items()}
    return trail, oc, int(val), bool(ok)


def test_async_carry_redrives_across_epochs():
    """A failing idempotent record reads PENDING while it is redriven
    (pressure counts it), once per later drain, and finalizes OK."""
    runs = []
    for mod, queue, arg, i32 in (
            (jrpc, jrpc.RpcQueue.create, jnp.int32(7), _JI32),
            (trpc, lambda *a, **k: trpc.RpcQueue.create(*a, **k,
                                                        device="cpu"),
             torch.tensor(7, dtype=torch.int32), _TI32)):
        fn, calls = _flaky(2)
        mod.REGISTRY.register("as.flaky", fn, idempotent=True)
        runs.append(_carry_run(mod, queue, arg, i32, "as.flaky", 3, 3)
                    + (calls["n"],))
    assert runs[0] == runs[1]
    trail, oc, val, ok, n = runs[1]
    assert trail[1][0] == [trpc.STATUS_PENDING] and trail[1][1] > 0.0
    assert oc == {0: (trpc.STATUS_OK, [7])} and (val, ok, n) == (7, True, 3)


def test_async_carry_budget_exhaustion_finalizes_failure():
    runs = []
    for mod, queue, arg, i32 in (
            (jrpc, jrpc.RpcQueue.create, jnp.int32(1), _JI32),
            (trpc, lambda *a, **k: trpc.RpcQueue.create(*a, **k,
                                                        device="cpu"),
             torch.tensor(1, dtype=torch.int32), _TI32)):
        fn, _ = _flaky(None)
        mod.REGISTRY.register("as.perma", fn, idempotent=True)
        runs.append(_carry_run(mod, queue, arg, i32, "as.perma", 2, 3))
    assert runs[0] == runs[1]
    assert runs[1][1] == {0: (trpc.STATUS_CALLEE_RAISED, None)}
    assert runs[1][0][-1][0] == [trpc.STATUS_CALLEE_RAISED]


@pytest.mark.parametrize("kw,match", [
    ({"mode": "turbo"}, "mode"),
    ({"reply_capacity": 8, "carry_budget": 2}, "carry_budget requires mode"),
    ({"mode": "async", "carry_budget": 2}, "carry_budget requires reply"),
    ({"shard_deadline": 0.1}, "shard_deadline requires reply")])
def test_async_create_validations(kw, match):
    with pytest.raises(ValueError, match=match):
        jrpc.RpcQueue.create(8, width=2, **kw)
    with pytest.raises(ValueError, match=match):
        trpc.RpcQueue.create(8, width=2, **kw, device="cpu")


def test_deadline_stamps_timeout_and_abandons_the_late_drain():
    """A collect whose previous drain overruns ``shard_deadline`` installs
    TIMEOUT across the window; the late drain stops at its next record, so
    the failing idempotent record behind the slow one never runs and is
    never carried.  Same statuses, window, calls and carry as JAX."""
    results = []
    for mod, queue, mk in (
            (jrpc, jrpc.RpcQueue.create, jnp.int32),
            (trpc, lambda *a, **k: trpc.RpcQueue.create(*a, **k,
                                                        device="cpu"),
             lambda v: torch.tensor(v, dtype=torch.int32))):
        calls = []

        def slow(x, calls=calls):
            calls.append(("slow", int(x)))
            time.sleep(1.0)
            return np.int32(x) * 2

        def bad(x, calls=calls):
            calls.append(("bad", int(x)))
            raise RuntimeError("carried if reached")

        mod.REGISTRY.register("dl.slow", slow)
        mod.REGISTRY.register("dl.bad", bad, idempotent=True)
        i32 = _JI32 if mod is jrpc else _TI32
        q = queue(4, width=1, reply_capacity=8, mode="async",
                  carry_budget=1, shard_deadline=0.2)
        q, t0 = q.enqueue_ticketed("dl.slow", mk(3), returns=i32)
        q, t1 = q.enqueue_ticketed("dl.bad", mk(4), returns=i32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            q = q.flush()                  # submit
            q = q.flush()                  # collect: past the deadline
            window = (np.asarray(q.rstat).tolist(), int(q.rbase),
                      int(q.rcount), int(q.cdepth))
            st = q.statuses_host([t0, t1])
            assert q.join()
            q = q.flush()
            assert q.join()
        results.append((window, st, list(calls), q.carry_outcomes(),
                        q.statuses_host([t0, t1])))
    assert results[0] == results[1]
    window, st, calls, outcomes, after = results[1]
    assert window == ([trpc.STATUS_TIMEOUT] * 4, 0, 2, 0)
    assert st == [trpc.STATUS_TIMEOUT] * 2
    assert calls == [("slow", 3)] and outcomes == {}
    assert after == [trpc.STATUS_STALE] * 2


def test_device_run_queue_async_boundary():
    """device_run(queue_async=True) delivers as the sync queue does and
    every host effect has retired when it returns; returning hooks are
    refused, as in JAX."""
    seen = {"jax": [], "port": []}
    jhook = jdm.HostHook(every=2, extract=lambda i, s: s,
                         host_fn=lambda i, v: seen["jax"].append(
                             (int(i), float(v))),
                         name="hook.async_test", batched=True)
    thook = tdm.HostHook(every=2, extract=lambda i, s: s,
                         host_fn=lambda i, v: seen["port"].append(
                             (int(i), float(v))),
                         name="hook.async_test", batched=True)
    jfinal = jdm.device_run(lambda i, s: s + 1.0, jnp.float32(0.0), 6,
                            hooks=[jhook], donate=False, queue_async=True)
    tfinal = tdm.device_run(lambda i, s: s + 1.0, torch.tensor(0.0), 6,
                            hooks=[thook], queue_async=True)
    assert float(jfinal) == float(tfinal) == 6.0
    assert seen["port"] == seen["jax"] == [(2, 2.0), (4, 4.0), (6, 6.0)]
    ret = tdm.HostHook(every=1, extract=lambda i, s: s,
                       host_fn=lambda i, v: v, batched=True,
                       returns=trpc.ShapeDtype((), torch.float32),
                       consume=lambda i, s, v, ok: s)
    with pytest.raises(ValueError, match="queue_async"):
        tdm.device_run(lambda i, s: s, torch.tensor(0.0), 1, hooks=[ret],
                       queue_async=True)


def test_device_run_async_thread_queue_replies_one_epoch_late():
    """A step that enqueues and flushes through the threaded async queue
    reads the previous step's reply (its own still reads PENDING), exactly
    as JAX's; the boundary's two flushes leave every ticket STALE."""
    _both("as.twice", lambda x: np.int32(x) * 2)

    def jstep(i, s, q):
        acc, prev = s
        q, t = q.enqueue_ticketed("as.twice", i + 1, returns=_JI32)
        q = q.flush()
        pend = q.result_status(t) == jrpc.STATUS_PENDING
        return (acc + q.result(prev).astype(jnp.float32) + pend, t), q

    def tstep(i, s, q):
        acc, prev = s
        _, t = q.enqueue_ticketed("as.twice", i + 1, returns=_TI32)
        q.flush()
        pend = q.result_status(t) == trpc.STATUS_PENDING
        return (acc + q.result(prev).to(torch.float32) + pend, t), q

    (jacc, _), jq = jdm.device_run(
        jstep, (jnp.float32(0.0), jnp.int32(-1)), 4, thread_queue=True,
        return_queue=True, queue_reply=8, queue_async=True, donate=False)
    (tacc, _), tq = tdm.device_run(
        tstep, (torch.tensor(0.0), torch.tensor(-1, dtype=torch.int32)), 4,
        thread_queue=True, return_queue=True, queue_reply=8,
        queue_async=True)
    assert float(jacc) == float(tacc) == 2.0 * (1 + 2 + 3) + 4
    _same_lanes(jq, tq)
    assert tq.statuses_host(range(4)) == jq.statuses_host(range(4)) == \
        [trpc.STATUS_STALE] * 4
