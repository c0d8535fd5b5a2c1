"""The port's batched RPC queue against the JAX package's, on the CPU.

Seeded plans of enqueues and flushes (capacity 8, so the ring wraps; a
20-word arena and a 12-word reply arena, so records drop at enqueue and at
the drain; ``where`` masks as 0-d bool tensors) run through the JAX
``RpcQueue``, the port's CPU queue (the plain enqueue and the drain's
landing pad called directly) and the pure-Python ``RefQueue`` of
``tests/test_rpc_differential.py`` (imported from there, not copied, with
its callees and its payload rule).  Every lane after each epoch's enqueues
(float lanes as int32 bits), every ticket and head, the host's call log
(argument values and types, payload arrays), the reply buffer, offsets,
lengths and statuses, ``flush_stats``/``queue_drops`` and every ticket's
``result``/``result_ok``/``result_status`` must be equal.  The same plans
run under ``FaultPlan.generate(seed)`` (JAX's plan on JAX's drain, the
port's copy on the port's, a twin on the model), without and with
``RetryPolicy(max_attempts=3)`` and a ``timeout``: statuses and the error
log's ``(callee, ticket, attempt)`` must be equal.  Then the directed
cases of ``tests/test_rpc_differential.py`` and
``tests/test_rpc_transport.py`` on the port, and its refusals (each names
its ROADMAP item)."""
import dataclasses
import random
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_rpc_differential as jdiff  # noqa: E402
from repro.core import rpc as jrpc  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402

CAP, WIDTH, PC, RC = 8, 3, 20, 12
NAMES = ("diff.int", "diff.float")
_LOG = {"jax": [], "port": []}


def _typed(args):
    """A callee's arguments as (type, value) pairs, arrays with dtype."""
    return tuple((type(a).__name__, a.dtype.str, a.tolist())
                 if isinstance(a, np.ndarray) else (type(a).__name__, a)
                 for a in args)


def _port_callee(kind):
    model = jdiff._MODEL_HOSTS[kind]

    def fn(tag, nrep, arr=None):
        _LOG["port"].append((kind,) + _typed(
            (tag, nrep) + (() if arr is None else (arr,))))
        reply = model(int(tag), int(nrep),
                      None if arr is None else np.asarray(arr).tolist())
        return np.asarray(reply, np.int32 if kind == "i" else np.float32)

    return fn


trpc.REGISTRY.register("diff.int", _port_callee("i"), idempotent=True)
trpc.REGISTRY.register("diff.float", _port_callee("f"))


@pytest.fixture
def jax_logged():
    """Wrap the JAX suite's callees to log argument types too; restore
    them (and their idempotent flags) afterwards."""
    def wrap(kind, inner):
        def fn(*args):
            _LOG["jax"].append((kind,) + _typed(args))
            return inner(*args)
        return fn

    jrpc.REGISTRY.register("diff.int", wrap("i", jdiff._echo_int),
                           idempotent=True)
    jrpc.REGISTRY.register("diff.float", wrap("f", jdiff._echo_float))
    _LOG["jax"].clear()
    _LOG["port"].clear()
    yield
    jrpc.REGISTRY.register("diff.int", jdiff._echo_int, idempotent=True)
    jrpc.REGISTRY.register("diff.float", jdiff._echo_float)


def _plan(rng: random.Random, n_ops: int = 28):
    """Enqueues and flushes; a flush is rare enough that the 8-slot ring
    wraps and the arenas fill (``jdiff._random_plan``'s choices)."""
    plan = []
    for _ in range(n_ops):
        if rng.random() < 0.1:
            plan.append(("flush",))
        else:
            plan.append(("enq", rng.choice("if"), rng.randint(0, 99),
                         rng.choice([-1, 0, 1, 2, 3, 5, 7]),
                         rng.choice([0, 0, 1, 2, 3, 4]),
                         rng.choice([None, None, True, False])))
    return plan


def _port_enqueue(q, kind, tag, nrep, payload, where):
    """The port's twin of ``jdiff._dev_enqueue``: the tag alternates
    between a 0-d tensor (read on the device) and a Python int (an
    immediate), ``where`` is a 0-d bool tensor."""
    name = "diff.int" if kind == "i" else "diff.float"
    args = [torch.tensor(tag, dtype=torch.int32) if tag % 2 else tag, nrep]
    if payload is not None:
        args.append(torch.tensor(
            payload, dtype=torch.int32 if kind == "i" else torch.float32))
    returns = (trpc.ShapeDtype(
        (nrep,), torch.int32 if kind == "i" else torch.float32)
        if nrep > 0 else None)
    w = None if where is None else torch.tensor(where)
    q, t = q.enqueue_ticketed(name, *args, returns=returns, where=w)
    return int(t)


_LANES = ("callee", "nargs", "imask", "pmask", "ivals", "fvals", "plens",
          "pbuf", "head", "phead", "adrops", "rwant", "base", "rbuf",
          "roff", "rlen", "rstat", "rbase", "rcount", "fonce")


def _same_lanes(jq, tq):
    for name in _LANES:
        a = np.asarray(getattr(jq, name))
        b = getattr(tq, name).numpy()
        if name == "fvals":
            a, b = a.view(np.int32), b.view(np.int32)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _reads(q, tickets, port):
    """Every ticket's status, reply and ok, as plain Python values."""
    out = []
    for t, nrep, kind in tickets:
        st = int(q.result_status(t))
        if nrep == 0:
            out.append((st,))
            continue
        dt = (torch if port else jnp).int32 if kind == "i" else \
            (torch if port else jnp).float32
        v, ok = q.result_ok(t, (nrep,), dt)
        out.append((st, np.asarray(v).tolist(), bool(ok)))
    return out


def _run(plan, fault_seed=None, retry=False, timeout=None):
    """One plan through JAX's queue, the port's and the model; compare
    after every epoch and at the end."""
    jrpc.reset_rpc_stats()
    trpc.reset_rpc_stats()
    jrpc.clear_error_log()
    trpc.clear_error_log()
    jplan = tplan = rplan = None
    if fault_seed is not None:
        jplan = jfaults.FaultPlan.generate(fault_seed, list(NAMES))
        tplan = tfaults.FaultPlan.generate(fault_seed, list(NAMES))
        rplan = jfaults.FaultPlan(jplan.faults)
        assert [dataclasses.astuple(f) for f in tplan.faults] == \
            [dataclasses.astuple(f) for f in jplan.faults]
    attempts = 3 if retry else 1
    jq = jrpc.RpcQueue.create(
        CAP, width=WIDTH, payload_capacity=PC, reply_capacity=RC,
        retry=jrpc.RetryPolicy(max_attempts=3) if retry else None,
        timeout=timeout)
    tq = trpc.RpcQueue.create(
        CAP, width=WIDTH, payload_capacity=PC, reply_capacity=RC,
        retry=trpc.RetryPolicy(max_attempts=3) if retry else None,
        timeout=timeout, device="cpu")
    ref = jdiff.RefQueue(CAP, PC, RC)
    issued = []
    for op in plan + [("flush",)]:
        if op[0] == "enq":
            _, kind, tag, plen, nrep, where = op
            payload = jdiff._payload_for(kind, plen, tag)
            jq, tj = jdiff._dev_enqueue(jq, kind, tag, nrep, payload, where)
            tt = _port_enqueue(tq, kind, tag, nrep, payload, where)
            tr = ref.enqueue(kind, tag, nrep, payload, where)
            assert tj == tt == tr, (tj, tt, tr)
            issued.append((tj, nrep, kind))
            continue
        _same_lanes(jq, tq)
        assert (int(tq.head), int(tq.phead), int(tq.adrops)) == \
            (ref.head, ref.phead, ref.adrops)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jrpc.set_fault_injector(jplan)
            trpc.set_fault_injector(tplan)
            try:
                jq = jq.flush()
                jax.effects_barrier()
                tq.flush()
            finally:
                jrpc.set_fault_injector(None)
                trpc.set_fault_injector(None)
        ref.flush(rplan, attempts, jdiff._IDEM)
        _same_lanes(jq, tq)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jr, tr_ = _reads(jq, issued, False), _reads(tq, issued, True)
        assert jr == tr_
        for (t, nrep, kind), got in zip(issued, tr_):
            assert got[0] == ref.result_status(t), (t, got)
            if nrep:
                assert got[1] == ref.result(t, nrep, kind), (t, got)
    assert _LOG["port"] == _LOG["jax"] and _LOG["jax"]
    assert trpc.flush_stats() == jrpc.flush_stats()
    assert trpc.queue_drops() == jrpc.queue_drops()
    for name in NAMES:
        assert trpc.rpc_stats(name)["calls"] == jrpc.rpc_stats(name)["calls"]
        assert trpc.rpc_stats(name)["bytes_in"] == \
            jrpc.rpc_stats(name)["bytes_in"]

    def attributions(log):
        return [(e["callee"], e["ticket"], e["attempt"]) for e in log]

    assert attributions(trpc.error_log()) == attributions(jrpc.error_log())
    if jplan is not None:
        assert tplan.fired == jplan.fired == rplan.fired


SEEDS = range(8)


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_equals_jax_and_model(jax_logged, seed):
    _run(_plan(random.Random(5000 + seed)))


@pytest.mark.parametrize("retry", [False, True], ids=["no_retry", "retry3"])
@pytest.mark.parametrize("seed", SEEDS)
def test_plan_under_faults_equals_jax(jax_logged, seed, retry):
    _run(_plan(random.Random(6000 + seed)), fault_seed=seed, retry=retry)


@pytest.mark.parametrize("retry", [False, True], ids=["no_retry", "retry3"])
@pytest.mark.parametrize("seed", range(3))
def test_plan_with_timeout_equals_jax(jax_logged, seed, retry):
    """A 1 s per-callee timeout that no injected delay (at most 10 ms)
    reaches: the drain goes through the worker threads, pipelined when
    nothing forces the ping-pong."""
    _run(_plan(random.Random(7000 + seed)),
         fault_seed=seed if retry else None, retry=retry, timeout=1.0)


def test_timeouts_and_retried_timeouts_equal_jax(jax_logged):
    """A delay past a 0.1 s timeout reads TIMEOUT on both; the idempotent
    callee's second attempt succeeds under a retry policy."""
    faults = (jfaults.Fault("delay", "diff.float", 1, delay=0.4),
              jfaults.Fault("delay", "diff.int", 0, delay=0.4))
    tfs = tuple(tfaults.Fault(*dataclasses.astuple(f)) for f in faults)
    plan = [("enq", "i", 1, -1, 2, None), ("enq", "f", 2, 2, 1, None),
            ("enq", "f", 3, -1, 1, None), ("enq", "i", 4, 1, 1, None)]
    for retry in (False, True):
        jrpc.clear_error_log()
        trpc.clear_error_log()
        out = {}
        for pkg, rpc, fmod, fs in (("jax", jrpc, jfaults, faults),
                                   ("port", trpc, tfaults, tfs)):
            kw = {} if pkg == "jax" else {"device": "cpu"}
            q = rpc.RpcQueue.create(
                CAP, width=WIDTH, payload_capacity=PC, reply_capacity=RC,
                retry=rpc.RetryPolicy(max_attempts=2) if retry else None,
                timeout=0.1, **kw)
            tix = []
            for _, kind, tag, plen, nrep, where in plan:
                payload = jdiff._payload_for(kind, plen, tag)
                if pkg == "jax":
                    q, t = jdiff._dev_enqueue(q, kind, tag, nrep, payload,
                                              where)
                else:
                    t = _port_enqueue(q, kind, tag, nrep, payload, where)
                tix.append(t)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                with fmod.FaultPlan(fs):
                    q = q.flush()
                    jax.effects_barrier()
            out[pkg] = ([int(q.result_status(t)) for t in tix],
                        [(e["callee"], e["ticket"], e["attempt"])
                         for e in rpc.error_log()])
        assert out["port"] == out["jax"]
        sts = out["port"][0]
        assert sts[2] == trpc.STATUS_TIMEOUT     # diff.float's second call
        assert sts[0] == (trpc.STATUS_OK if retry else trpc.STATUS_TIMEOUT)


def test_fault_plans_generate_alike():
    for seed in range(20):
        a = jfaults.FaultPlan.generate(seed, ["x", "y", "z"], n_faults=5)
        b = tfaults.FaultPlan.generate(seed, ["x", "y", "z"], n_faults=5)
        assert [dataclasses.astuple(f) for f in a.faults] == \
            [dataclasses.astuple(f) for f in b.faults]
    with pytest.raises(ValueError):
        tfaults.Fault("explode", "x", 0)


def test_bf16_and_mixed_scalars_equal_jax_lanes():
    """bf16 and f16 payloads travel as float32 words, int16/uint8/bool
    payloads as int32, and scalars of every kind land in JAX's lanes."""
    jrpc.REGISTRY.register("tq.mixed", lambda *a: None)
    trpc.REGISTRY.register("tq.mixed", lambda *a: None)
    rng = np.random.default_rng(0)
    f = rng.standard_normal(5).astype(np.float32)
    i16 = rng.integers(-300, 300, 4).astype(np.int16)
    u8 = rng.integers(0, 255, 3).astype(np.uint8)
    b = np.array([True, False, True])
    jq = jrpc.RpcQueue.create(4, width=6, payload_capacity=64)
    tq = trpc.RpcQueue.create(4, width=6, payload_capacity=64, device="cpu")
    jq = jq.enqueue("tq.mixed", jnp.asarray(f, jnp.bfloat16),
                    jnp.asarray(i16), jnp.asarray(u8), jnp.asarray(b),
                    jnp.asarray(f, jnp.float16), jnp.bfloat16(1.7))
    tq.enqueue("tq.mixed", torch.tensor(f).to(torch.bfloat16),
               torch.tensor(i16), torch.tensor(u8), torch.tensor(b),
               torch.tensor(f).to(torch.float16),
               torch.tensor(1.7, dtype=torch.bfloat16))
    jq = jq.enqueue("tq.mixed", True, 3, -2.5, np.int16(-7), np.float64(0.1),
                    jnp.int32(-9))
    tq.enqueue("tq.mixed", True, 3, -2.5, np.int16(-7), np.float64(0.1),
               torch.tensor(-9, dtype=torch.int64))
    _same_lanes(jq, tq)


# ---------------------------------------------------------------------------
# Directed cases of tests/test_rpc_differential.py on the port
# ---------------------------------------------------------------------------

def _directed(plan, faults=None, retry=False):
    """``plan`` on the port's queue and the model (CAP 5, JAX's geometry):
    statuses and replies of every ticket equal."""
    trpc.reset_rpc_stats()
    _LOG["port"].clear()
    q = trpc.RpcQueue.create(jdiff.CAP, width=jdiff.WIDTH,
                             payload_capacity=jdiff.PC,
                             reply_capacity=jdiff.RC,
                             retry=trpc.RetryPolicy(max_attempts=2)
                             if retry else None, device="cpu")
    ref = jdiff.RefQueue()
    tix = []

    def flush():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            trpc.set_fault_injector(tfaults.FaultPlan(faults or ()))
            try:
                q.flush()
            finally:
                trpc.set_fault_injector(None)
        ref.flush(jfaults.FaultPlan(tuple(
            jfaults.Fault(*dataclasses.astuple(f)) for f in faults or ())),
            2 if retry else 1, jdiff._IDEM)
        for t, nrep, kind in tix:
            assert int(q.result_status(t)) == ref.result_status(t)
            if nrep:
                dt = torch.int32 if kind == "i" else torch.float32
                assert q.result_ok(t, (nrep,), dt)[0].tolist() == \
                    ref.result(t, nrep, kind)

    for op in plan:
        if op[0] == "flush":
            flush()
            continue
        _, kind, tag, plen, nrep, where = op
        payload = jdiff._payload_for(kind, plen, tag)
        t = _port_enqueue(q, kind, tag, nrep, payload, where)
        assert t == ref.enqueue(kind, tag, nrep, payload, where)
        tix.append((t, nrep, kind))
    flush()
    return q, [int(q.result_status(t)) for t, _, _ in tix]


def test_directed_ring_overwrite_aliases_survivor():
    _directed([("enq", "i", t, -1, 2, None) for t in range(jdiff.CAP + 2)])
    assert trpc.flush_stats()["drops"] == 2


def test_directed_arena_and_reply_overflow():
    _directed([("enq", "i", 1, 7, 4, None), ("enq", "f", 2, 7, 4, None),
               ("enq", "i", 3, 5, 2, None), ("enq", "i", 4, -1, 4, None),
               ("flush",), ("enq", "i", 5, 3, 1, False),
               ("enq", "f", 6, 3, 1, None)])
    st = trpc.flush_stats()
    assert st["arena_drops"] == 1 and st["reply_drops"] == 1


def test_directed_stale_ticket_never_reads_next_epoch():
    q = trpc.RpcQueue.create(jdiff.CAP, width=jdiff.WIDTH,
                             payload_capacity=jdiff.PC,
                             reply_capacity=jdiff.RC, device="cpu")
    i32 = trpc.ShapeDtype((2,), torch.int32)
    _, t_old = q.enqueue_ticketed("diff.int", 111, 2, returns=i32)
    q.flush()
    assert q.result(t_old, (2,), torch.int32).tolist() == [111, 114]
    _, t_new = q.enqueue_ticketed("diff.int", 222, 2, returns=i32)
    q.flush()
    assert int(t_new) == int(t_old) + 1
    assert q.result(t_new, (2,), torch.int32).tolist() == [222, 225]
    v, ok = q.result_ok(int(t_old), (2,), torch.int32)
    assert not bool(ok) and v.tolist() == [0, 0]
    assert int(q.result_status(t_old)) == trpc.STATUS_STALE


def test_directed_fault_isolation_and_retry():
    plan = [("enq", "i", 1, -1, 2, None), ("enq", "i", 2, 3, 2, None),
            ("enq", "f", 3, -1, 1, None), ("enq", "i", 4, -1, 1, None)]
    for retry in (False, True):
        _, sts = _directed(plan, (tfaults.Fault("raise", "diff.int", 1),),
                           retry)
        assert sts[1] == (trpc.STATUS_OK if retry
                          else trpc.STATUS_CALLEE_RAISED)


def test_directed_fault_drop_and_corrupt_reply():
    q, sts = _directed(
        [("enq", "i", 5, -1, 2, None), ("enq", "i", 6, -1, 3, None)],
        (tfaults.Fault("drop_reply", "diff.int", 0),
         tfaults.Fault("corrupt", "diff.int", 1, word=1, value=-77)))
    assert sts == [trpc.STATUS_DROPPED, trpc.STATUS_OK]
    assert q.result_ok(1, (3,), torch.int32)[0].tolist()[1] == -77
    assert len(_LOG["port"]) == 2          # the dropped reply's callee ran


# ---------------------------------------------------------------------------
# Directed cases of tests/test_rpc_transport.py on the port
# ---------------------------------------------------------------------------

def _q(*a, **kw):
    return trpc.RpcQueue.create(*a, device="cpu", **kw)


def test_queue_flush_preserves_order_and_types():
    trpc.reset_rpc_stats()
    seen = []
    trpc.REGISTRY.register("q.alpha", lambda i, x: seen.append(("a", i, x)))
    trpc.REGISTRY.register("q.beta",
                           lambda flag, y: seen.append(("b", flag, y)))
    q = _q(capacity=8, width=2)
    q.enqueue("q.alpha", torch.tensor(1, dtype=torch.int32), 0.5)
    q.enqueue("q.beta", torch.tensor(True), torch.tensor(-2.0))
    q.enqueue("q.alpha", 2, torch.tensor(1.5))
    assert q.flush() is q and int(q.head) == 0
    assert seen == [("a", 1, 0.5), ("b", 1, -2.0), ("a", 2, 1.5)]
    assert all(isinstance(r[1], int) and isinstance(r[2], float)
               for r in seen)
    assert trpc.rpc_stats("q.alpha")["calls"] == 2
    assert trpc.rpc_stats("q.beta")["calls"] == 1


def test_queue_overflow_surfaced_at_flush():
    trpc.reset_rpc_stats()
    seen = []
    trpc.REGISTRY.register("q.wrap", seen.append)
    k, cap = 3, 4
    q = _q(capacity=cap, width=1)
    for i in range(cap + k):
        q.enqueue("q.wrap", i)
    with pytest.warns(RuntimeWarning, match="overwritten"):
        q.flush()
    assert seen == list(range(k, cap + k)) and trpc.queue_drops() == k
    zero = {"arena_drops": 0, "last_arena_drops": 0, "reply_drops": 0,
            "last_reply_drops": 0, "callee_errors": 0,
            "last_callee_errors": 0, "retries": 0}
    assert trpc.flush_stats() == dict(zero, flushes=1, drops=k, last_drops=k)
    q.enqueue("q.wrap", 99)
    q.flush()
    assert trpc.flush_stats() == dict(zero, flushes=2, drops=k, last_drops=0)


def test_queue_rejects_overwidth_unregistered_and_armless_arrays():
    trpc.REGISTRY.register("q.bad", lambda *a: None)
    q = _q(capacity=2, width=1)
    with pytest.raises(ValueError, match="width"):
        q.enqueue("q.bad", 0, 1)
    with pytest.raises(KeyError):
        q.enqueue("q.unregistered", 0)
    with pytest.raises(ValueError, match="payload"):
        _q(capacity=2, width=1, payload_capacity=0).enqueue(
            "q.bad", torch.zeros(3))
    with pytest.raises(ValueError, match="arena only holds"):
        _q(capacity=2, width=1, payload_capacity=4).enqueue(
            "q.bad", torch.zeros(5))
    with pytest.raises(ValueError, match="width"):
        _q(capacity=2, width=32)


def test_queue_conditional_enqueue():
    seen = []
    trpc.REGISTRY.register("q.cond", seen.append)
    q = _q(4, width=1)
    tickets = [int(q.enqueue_ticketed("q.cond", i,
                                      where=torch.tensor(i % 2 == 1))[1])
               for i in range(4)]
    assert tickets == [-1, 0, -1, 1] and int(q.head) == 2
    q.enqueue("q.cond", 7, where=False)
    q.flush()
    assert seen == [1, 3]


def test_flush_handlers_are_per_flush():
    a, b = [], []
    trpc.REGISTRY.register("q.sink", lambda t: None)
    q = _q(4, width=1)
    q.enqueue("q.sink", 1).flush({"q.sink": a.append})
    q.enqueue("q.sink", 2).flush({"q.sink": b.append})
    q.enqueue("q.sink", 3).flush({"q.sink": a.append})
    assert a == [1, 3] and b == [2]


def test_payload_roundtrip_dtypes_and_order():
    seen = []
    trpc.REGISTRY.register(
        "p.mix", lambda i, ints, f, floats: seen.append(
            (i, ints.copy(), f, floats.copy())))
    q = _q(8, width=4, payload_capacity=64)
    q.enqueue("p.mix", 7, torch.tensor([3, -1, 12], dtype=torch.int32), 2.5,
              torch.tensor([0.5, -1.25]))
    q.enqueue("p.mix", 8, torch.tensor([[9, 9]], dtype=torch.int32), 0.5,
              torch.zeros(3))
    q.flush()
    assert int(q.head) == 0 and int(q.phead) == 0
    i0, ints0, f0, floats0 = seen[0]
    assert (i0, f0) == (7, 2.5)
    assert ints0.dtype == np.int32 and ints0.tolist() == [3, -1, 12]
    assert floats0.dtype == np.float32 and floats0.tolist() == [0.5, -1.25]
    assert seen[1][1].tolist() == [9, 9]
    assert seen[1][3].tolist() == [0.0, 0.0, 0.0]


def test_payload_order_across_mixed_records():
    rng = random.Random(7)
    seen = []
    trpc.REGISTRY.register("p.scalar", lambda i: seen.append(("s", i)))
    trpc.REGISTRY.register("p.arr",
                           lambda i, a: seen.append(("a", i, a.tolist())))
    plan = [("s", i, None) if rng.random() < 0.5 else
            ("a", i, [rng.randint(-99, 99)
                      for _ in range(rng.randint(1, 5))])
            for i in range(20)]
    q = _q(32, width=2, payload_capacity=128)
    for kind, i, data in plan:
        if kind == "s":
            q.enqueue("p.scalar", i)
        else:
            q.enqueue("p.arr", i, torch.tensor(data, dtype=torch.int32))
    q.flush()
    assert seen == [("s", i) if kind == "s" else ("a", i, data)
                    for kind, i, data in plan]


def test_payload_arena_overflow_drops_atomically():
    trpc.reset_rpc_stats()
    seen = []
    trpc.REGISTRY.register("p.over",
                           lambda i, a: seen.append((i, a.tolist())))
    q = _q(8, width=2, payload_capacity=10)
    ar = torch.arange(6, dtype=torch.int32)
    assert int(q.enqueue_ticketed("p.over", 0, ar)[1]) == 0
    assert int(q.enqueue_ticketed("p.over", 1, ar + 100)[1]) == -1
    assert int(q.enqueue_ticketed("p.over", 2, ar[:4] + 50)[1]) == 1
    with pytest.warns(RuntimeWarning, match="payload"):
        q.flush()
    assert seen == [(0, [0, 1, 2, 3, 4, 5]), (2, [50, 51, 52, 53])]
    st = trpc.flush_stats()
    assert st["arena_drops"] == 1 and st["last_arena_drops"] == 1
    assert st["drops"] == 0


def test_payload_conditional_enqueue_reserves_nothing():
    seen = []
    trpc.REGISTRY.register("p.cond",
                           lambda i, a: seen.append((i, a.tolist())))
    q = _q(8, width=2, payload_capacity=4)
    q.enqueue("p.cond", 0, torch.tensor([1, 2]), where=torch.tensor(False))
    q.enqueue("p.cond", 1, torch.tensor([7, 8, 9, 10]))
    q.flush()
    assert seen == [(1, [7, 8, 9, 10])]
    assert trpc.flush_stats()["last_arena_drops"] == 0


def test_rpc_call_batched_path():
    seen = []
    trpc.REGISTRY.register("p.batched",
                           lambda i, a: seen.append((i, a.tolist())))
    q = _q(8, width=2, payload_capacity=32, reply_capacity=4)
    assert trpc.rpc_call("p.batched", 3, torch.tensor([4.0, 5.0]),
                         batched=True, queue=q) is q
    q2, t = trpc.rpc_call("p.batched", 4, torch.tensor([1.0]), batched=True,
                          queue=q, returns=trpc.ShapeDtype((), torch.int32))
    assert q2 is q and int(t) == 1
    q.flush()
    assert seen == [(3, [4.0, 5.0]), (4, [1.0])]
    with pytest.raises(ValueError, match="value args"):
        trpc.rpc_call("p.batched", 0, trpc.Ref(torch.zeros(2)),
                      batched=True, queue=q)
    with pytest.raises(ValueError, match="queue"):
        trpc.rpc_call("p.batched", 0, batched=True)
    with pytest.raises(TypeError, match="result_shape"):
        trpc.rpc_call("p.batched", 0)


def test_reply_roundtrip_dtypes_and_validity():
    trpc.REGISTRY.register("r.int", lambda k: np.arange(int(k),
                                                        dtype=np.int32))
    trpc.REGISTRY.register("r.flt", lambda x: np.float32(x) * 0.5)
    q = _q(8, width=2, reply_capacity=16)
    f32 = trpc.ShapeDtype((), torch.float32)
    _, t0 = q.enqueue_ticketed("r.int", 3,
                               returns=trpc.ShapeDtype((3,), torch.int32))
    _, t1 = q.enqueue_ticketed("r.flt", 7.0, returns=f32)
    _, t2 = q.enqueue_ticketed("r.flt", 1.0, returns=f32, where=False)
    with pytest.warns(RuntimeWarning, match="NEVER flushed"):
        q.result(t0, (3,), torch.int32)
    q.flush()
    v0, ok0 = q.result_ok(t0, (3,), torch.int32)
    v1, ok1 = q.result_ok(t1, f32)
    v2, ok2 = q.result_ok(t2, f32)
    assert v0.tolist() == [0, 1, 2] and bool(ok0)
    assert float(v1) == 3.5 and bool(ok1)
    assert float(v2) == 0.0 and not bool(ok2)
    assert q.results_host([t0, t2], (3,), torch.int32)[0][0].tolist() == \
        [0, 1, 2]
    assert q.statuses_host([t0, t1, t2]) == [0, 0, trpc.STATUS_DROPPED]
    q.flush()
    v0b, ok0b = q.result_ok(t0, (3,), torch.int32)
    assert v0b.tolist() == [0, 0, 0] and not bool(ok0b)
    assert q.statuses_host([t0]) == [trpc.STATUS_STALE]
    assert q.join() is True and q.carry_outcomes() == {}


def test_reply_arena_overflow_drops_whole_reply():
    trpc.reset_rpc_stats()
    ran = []
    trpc.REGISTRY.register(
        "r.fill",
        lambda k: (ran.append(int(k)), np.full(int(k), int(k), np.int32))[1])
    q = _q(8, width=2, reply_capacity=6)
    ts = [q.enqueue_ticketed("r.fill", k, returns=trpc.ShapeDtype(
        (k,), torch.int32))[1] for k in (4, 3, 2)]
    assert float(q.pressure()) == 1.5          # 9 reply words declared
    with pytest.warns(RuntimeWarning, match="reply"):
        q.flush()
    assert q.result(ts[0], (4,), torch.int32).tolist() == [4, 4, 4, 4]
    assert not bool(q.result_ok(ts[1], (3,), torch.int32)[1])
    assert int(q.result_status(ts[1])) == trpc.STATUS_REPLY_OVERFLOW
    assert q.result(ts[2], (2,), torch.int32).tolist() == [2, 2]
    assert ran == [4, 2]
    st = trpc.flush_stats()
    assert st["reply_drops"] == 1 and st["last_reply_drops"] == 1


def test_reply_rejected_without_reply_arena():
    trpc.REGISTRY.register("r.none", lambda: np.int32(0))
    q = _q(4, width=1)
    i32 = trpc.ShapeDtype((), torch.int32)
    with pytest.raises(ValueError, match="reply arena"):
        q.enqueue_ticketed("r.none", returns=i32)
    with pytest.raises(ValueError, match="result"):
        q.result(0)
    with pytest.raises(ValueError, match="reply words"):
        _q(4, width=1, reply_capacity=2).enqueue_ticketed(
            "r.none", returns=trpc.ShapeDtype((3,), torch.int32))
    with pytest.raises(TypeError, match="32-bit"):
        _q(4, width=1, reply_capacity=2).enqueue_ticketed(
            "r.none", returns=trpc.ShapeDtype((), torch.int64))
    with pytest.raises(ValueError, match="returns"):
        trpc.rpc_call("r.none", result_shape=i32, returns=i32)
    with pytest.raises(ValueError, match="where"):
        trpc.rpc_call("r.none", result_shape=i32, where=True)


def test_later_items_are_refused_by_name():
    # items 3.4 and 3.7 are ported: a sync queue takes shard_deadline (it
    # bounds a sharded flush's drain; JAX's single sync queue ignores it)
    assert _q(4, shard_deadline=1.0, reply_capacity=4).shard_deadline == 1.0
    with pytest.raises(ValueError, match="shard_deadline requires reply"):
        _q(4, shard_deadline=1.0)
    assert _q(4, sanitize=True).sanitize
    with pytest.raises(ValueError, match="carry_budget requires mode"):
        _q(4, carry_budget=1)
    with pytest.raises(ValueError, match="mode"):
        _q(4, mode="later")


def test_card_flush_refuses_a_policy_past_the_channel_wait():
    """A worst case (capacity x attempts x timeout) beyond the channel's
    wait would trap the posted kernel; the check itself reads no device."""
    q = _q(1024, retry=trpc.RetryPolicy(max_attempts=3), timeout=1.0)
    with pytest.raises(ValueError, match="outlast"):
        q._check_policy()
    _q(16, retry=trpc.RetryPolicy(max_attempts=3), timeout=1.0)._check_policy()
