"""The port's ShardedRpcQueue against the JAX package's, on the CPU.

Per-device plans of ``tests/test_rpc_differential.py`` (its seeds, its
geometry and its ``_random_plan``) run through JAX's ``ShardedRpcQueue``
(enqueues on ``local(d)``, restacked before each flush as JAX's tests
restack), the port's (enqueues on its ``local(d)`` views, which land in
the stacked state) and one ``RefQueue`` a shard, the model's flush taken
in ``(device, slot)`` order.  Each shard's lanes before and after every
flush, the tickets, the replay log (argument types and values), every
ticket's status and reply, ``flush_stats``, the error log's attributions
and the fired faults must be equal; the sanitized runs also
``sanitize_stats``.  Then the deadline's partial epoch, the async
sharded queue's independent drains (and a seeded async plan under
faults), the sharded ``LogRing`` and the sharded queue's refusals.  The
port's callees are those of ``tests/test_torch_rpc_queue.py`` (imported
with its helpers)."""
import random
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_rpc_differential as jdiff  # noqa: E402
import test_torch_rpc_queue as tq  # noqa: E402
from test_torch_rpc_queue import jax_logged  # noqa: E402,F401
from repro.core import libc as jlibc  # noqa: E402
from repro.core import rpc as jrpc  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.core import libc as tlibc  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402

CAP, WIDTH, PC, RC = jdiff.CAP, jdiff.WIDTH, jdiff.PC, jdiff.RC
NAMES = ("diff.int", "diff.float")
N_SEEDS = 30          # JAX's seeded corpus (RPC_DIFF_EXAMPLES' default)


def _jax_stack(locals_):
    return jrpc.ShardedRpcQueue(jax.tree.map(lambda *xs: jnp.stack(xs),
                                             *locals_))


def _run_sharded(plans, fault_seed=None, retry=False, sanitize=False):
    """The plans (one a device, interleaved op by op; a flush op flushes
    every shard) through JAX's sharded queue, the port's and (unsanitized)
    the model; compare after every flush and at the end."""
    D = len(plans)
    for rpc in (jrpc, trpc):
        rpc.reset_rpc_stats()
        rpc.clear_error_log()
        rpc.reset_sanitize_stats()
    jplan = tplan = rplan = None
    if fault_seed is not None:
        jplan = jfaults.FaultPlan.generate(fault_seed, list(NAMES))
        tplan = tfaults.FaultPlan.generate(fault_seed, list(NAMES))
        rplan = jfaults.FaultPlan(jplan.faults)
    attempts = 2 if retry else 1
    kw = dict(width=WIDTH, payload_capacity=PC, reply_capacity=RC,
              sanitize=sanitize)
    jsq = jrpc.ShardedRpcQueue.create(
        D, CAP, retry=jrpc.RetryPolicy(max_attempts=2) if retry else None,
        **kw)
    tsq = trpc.ShardedRpcQueue.create(
        D, CAP, retry=trpc.RetryPolicy(max_attempts=2) if retry else None,
        device="cpu", **kw)
    jlocals = [jsq.local(d) for d in range(D)]
    refs = [jdiff.RefQueue() for _ in range(D)]
    issued = [[] for _ in range(D)]

    def flush():
        nonlocal jlocals
        jst = _jax_stack(jlocals)
        assert trpc.ShardedRpcQueue.stack(
            [tsq.local(d) for d in range(D)]) is tsq
        for d in range(D):
            tq._same_lanes(jst.local(d), tsq.local(d))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jrpc.set_fault_injector(jplan)
            trpc.set_fault_injector(tplan)
            try:
                jst = jst.flush()
                jax.effects_barrier()
                tsq.flush()
            finally:
                jrpc.set_fault_injector(None)
                trpc.set_fault_injector(None)
        if not sanitize:
            for ref in refs:              # (device, slot): device-major
                ref.flush(rplan, attempts, jdiff._IDEM)
        jlocals = [jst.local(d) for d in range(D)]
        for d in range(D):
            tq._same_lanes(jlocals[d], tsq.local(d))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                jr = tq._reads(jlocals[d], issued[d], False)
                tr_ = tq._reads(tsq.local(d), issued[d], True)
            assert jr == tr_, d
            if not sanitize:
                for (t, nrep, kind), got in zip(issued[d], tr_):
                    assert got[0] == refs[d].result_status(t), (d, t, got)
                    if nrep:
                        assert got[1] == refs[d].result(t, nrep, kind)
            issued[d].clear()

    for i in range(max(len(p) for p in plans)):
        flush_now = False
        for d, plan in enumerate(plans):
            if i >= len(plan):
                continue
            if plan[i][0] == "flush":
                flush_now = True
                continue
            _, kind, tag, plen, nrep, where = plan[i]
            payload = jdiff._payload_for(kind, plen, tag)
            jlocals[d], tj = jdiff._dev_enqueue(jlocals[d], kind, tag, nrep,
                                                payload, where)
            tt = tq._port_enqueue(tsq.local(d), kind, tag, nrep, payload,
                                  where)
            assert tj == tt, (d, tj, tt)
            if not sanitize:
                assert refs[d].enqueue(kind, tag, nrep, payload, where) == tt
            issued[d].append((tj, nrep, kind))
        if flush_now:
            flush()
    flush()
    assert tq._LOG["port"] == tq._LOG["jax"]
    assert trpc.flush_stats() == jrpc.flush_stats()
    for name in NAMES:
        js, ts = jrpc.rpc_stats(name), trpc.rpc_stats(name)
        assert (ts["calls"], ts["bytes_in"]) == (js["calls"], js["bytes_in"])

    def attributions(log):
        return [(e["callee"], e["ticket"], e["attempt"]) for e in log]

    assert attributions(trpc.error_log()) == attributions(jrpc.error_log())
    assert trpc.sanitize_stats() == jrpc.sanitize_stats()
    if sanitize:
        assert all(e["sharded"] for e in trpc.sanitize_stats()["epochs"])
    if jplan is not None:
        assert tplan.fired == jplan.fired
        assert sanitize or rplan.fired == jplan.fired


def test_directed_sharded_minimal(jax_logged):
    _run_sharded([[("enq", "i", 1, 2, 2, None), ("flush",),
                   ("enq", "f", 2, -1, 1, None)],
                  [("enq", "f", 3, 0, 3, None),
                   ("enq", "i", 4, 9, 2, None)]])


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_differential_sharded_queue(jax_logged, seed):
    rng = random.Random(2000 + seed)
    _run_sharded([jdiff._random_plan(rng, 10), jdiff._random_plan(rng, 10)])


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_differential_sharded_queue_faults(jax_logged, seed):
    rng = random.Random(4000 + seed)
    _run_sharded([jdiff._random_plan(rng, 10), jdiff._random_plan(rng, 10)],
                 fault_seed=seed, retry=bool(seed % 2))


@pytest.mark.parametrize("seed", range(4))
def test_sanitized_sharded_queue(jax_logged, seed):
    """Sanitized shards: the arenas hold ``[CANARY][words][CANARY]``
    reservations, one sharded epoch record a flush; four shards."""
    rng = random.Random(8000 + seed)
    _run_sharded([jdiff._random_plan(rng, 10) for _ in range(4)],
                 fault_seed=seed if seed % 2 else None, sanitize=True)


def _deadline_case(rpc, fmod, kw):
    rpc.REGISTRY.register("as.sd", lambda x: np.int32(x) * 2)
    q = rpc.ShardedRpcQueue.create(2, 8, width=2, reply_capacity=8,
                                   shard_deadline=0.25, **kw)
    i32 = (jax.ShapeDtypeStruct((), jnp.int32) if rpc is jrpc
           else trpc.ShapeDtype((), torch.int32))
    locals_ = [q.local(d) for d in range(2)]
    tks = []
    for d in range(2):
        tag = jnp.int32(10 + d) if rpc is jrpc else 10 + d
        locals_[d], t = locals_[d].enqueue_ticketed("as.sd", tag,
                                                    returns=i32)
        tks.append(int(t))
    sq = (_jax_stack(locals_) if rpc is jrpc
          else trpc.ShardedRpcQueue.stack(locals_))
    # occurrence 1 in canonical (device, slot) order = device 1's record
    plan = fmod.FaultPlan([fmod.Fault("delay", "as.sd", call_index=1,
                                      delay=2.0)])
    with plan, pytest.warns(RuntimeWarning, match="partial-epoch"):
        sq = sq.flush()
    return ([int(sq.result_status(d, tks[d])) for d in range(2)],
            int(sq.result(0, tks[0])), plan.fired)


def test_sharded_deadline_partial_epoch():
    """One hung shard does not stall its sibling: the shards drain
    concurrently, the stalled shard's records read TIMEOUT and the rest
    of the epoch completes, in both packages."""
    got = _deadline_case(trpc, tfaults, {"device": "cpu"})
    assert got == _deadline_case(jrpc, jfaults, {})
    assert got[0] == [trpc.STATUS_OK, trpc.STATUS_TIMEOUT]
    assert got[1] == 20


def _async_independent(rpc, kw):
    rpc.REGISTRY.register("as.sh", lambda x: np.int32(x) + 5)
    q = rpc.ShardedRpcQueue.create(2, 8, width=2, reply_capacity=8,
                                   mode="async", **kw)
    i32 = (jax.ShapeDtypeStruct((), jnp.int32) if rpc is jrpc
           else trpc.ShapeDtype((), torch.int32))
    locals_ = [q.local(d) for d in range(2)]
    tks = []
    for d in range(2):
        tag = jnp.int32(100 * (d + 1)) if rpc is jrpc else 100 * (d + 1)
        locals_[d], t = locals_[d].enqueue_ticketed("as.sh", tag,
                                                    returns=i32)
        tks.append(int(t))
    sq = (_jax_stack(locals_) if rpc is jrpc
          else trpc.ShardedRpcQueue.stack(locals_))
    sq = sq.flush()                                # submit per device
    pending = [int(sq.result_status(d, tks[d])) for d in range(2)]
    sq = sq.flush()                                # collect per device
    assert sq.join()
    return pending, [(int(sq.result_status(d, tks[d])),
                      int(sq.result(d, tks[d]))) for d in range(2)]


def test_sharded_async_independent_drains():
    """Each device's epochs drain on its own slot; the collect flush
    publishes every device's replies."""
    got = _async_independent(trpc, {"device": "cpu"})
    assert got == _async_independent(jrpc, {})
    assert got[0] == [trpc.STATUS_PENDING] * 2
    assert got[1] == [(trpc.STATUS_OK, 105), (trpc.STATUS_OK, 205)]


def _async_plan(rpc, fmod, seed, kw, sanitize):
    """A seeded plan on a 2-shard async queue with a carry budget under
    a seeded fault plan: every ticket's host status after each joined
    flush, the carry outcomes, the fired faults and the flush stats."""
    rpc.reset_rpc_stats()
    rpc.clear_error_log()
    rpc.reset_sanitize_stats()
    fplan = fmod.FaultPlan.generate(seed, list(NAMES))
    q = rpc.ShardedRpcQueue.create(2, CAP, width=WIDTH, payload_capacity=PC,
                                   reply_capacity=RC, mode="async",
                                   carry_budget=2, sanitize=sanitize, **kw)
    rng = random.Random(9000 + seed)
    plans = [jdiff._random_plan(rng, 8), jdiff._random_plan(rng, 8)]
    locals_ = [q.local(d) for d in range(2)]
    issued = [[], []]
    seen = []

    def flush():
        nonlocal q, locals_
        q = (_jax_stack(locals_) if rpc is jrpc
             else trpc.ShardedRpcQueue.stack(locals_))
        rpc.set_fault_injector(fplan)
        try:
            q = q.flush()
            assert q.join()
            if rpc is jrpc:
                jax.effects_barrier()
        finally:
            rpc.set_fault_injector(None)
        locals_ = [q.local(d) for d in range(2)]
        seen.append([locals_[d].statuses_host(issued[d]) for d in range(2)])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(max(len(p) for p in plans)):
            flush_now = False
            for d, plan in enumerate(plans):
                if i >= len(plan):
                    continue
                if plan[i][0] == "flush":
                    flush_now = True
                    continue
                _, kind, tag, plen, nrep, where = plan[i]
                payload = jdiff._payload_for(kind, plen, tag)
                if rpc is jrpc:
                    locals_[d], t = jdiff._dev_enqueue(
                        locals_[d], kind, tag, nrep, payload, where)
                else:
                    t = tq._port_enqueue(locals_[d], kind, tag, nrep,
                                         payload, where)
                issued[d].append(t)
            if flush_now:
                flush()
        for _ in range(3):          # collect, then let the carry settle
            flush()
    stats = rpc.flush_stats()
    return (seen, [q.carry_outcomes(d) for d in range(2)], fplan.fired,
            {k: stats[k] for k in ("drops", "arena_drops", "reply_drops",
                                   "callee_errors", "retries")},
            rpc.sanitize_stats())


@pytest.mark.parametrize("sanitize", [False, True],
                         ids=["plain", "sanitized"])
@pytest.mark.parametrize("seed", range(3))
def test_async_sharded_plan_under_faults_equals_jax(jax_logged, seed,
                                                    sanitize):
    """Occurrences reserved over both shards in (device, slot) order at
    each flush, each shard's epochs and carry on its own slot: statuses,
    outcomes, fired faults and stats equal JAX's."""
    got = _async_plan(trpc, tfaults, seed, {"device": "cpu"}, sanitize)
    want = _async_plan(jrpc, jfaults, seed, {}, sanitize)

    def words(outcomes):
        return [{t: (st, None if w is None else np.asarray(w).tolist())
                 for t, (st, w) in o.items()} for o in outcomes]

    assert got[0] == want[0]
    assert words(got[1]) == words(want[1])
    assert got[2:] == want[2:]
    assert tq._LOG["port"] == tq._LOG["jax"]


def _logring_run(lib, kw):
    lib.drain_log_lines()
    ring = lib.LogRing.create_sharded(4, 8, payload_capacity=16, **kw)
    locals_ = [ring.q.local(d) for d in range(4)]
    for d in range(4):
        for k in range(d + 1):
            pay = None if k % 2 else [float(d), float(k)]
            if lib is jlibc:
                r = lib.LogRing(locals_[d], ring.name).log(
                    10 * d + k, 0.5 * k,
                    payload=None if pay is None else jnp.asarray(pay))
                locals_[d] = r.q
            else:
                lib.LogRing(locals_[d], ring.name).log(
                    10 * d + k, 0.5 * k,
                    payload=None if pay is None else torch.tensor(pay))
    q = (_jax_stack(locals_) if lib is jlibc
         else trpc.ShardedRpcQueue.stack(locals_))
    lib.LogRing(q, ring.name).flush()
    if lib is jlibc:
        jax.effects_barrier()
    return [(a, b) + tuple(np.asarray(c).tolist() for c in rest)
            for a, b, *rest in lib.drain_log_lines()]


def test_sharded_logring_delivers_in_device_slot_order():
    got = _logring_run(tlibc, {"device": "cpu"})
    assert got == _logring_run(jlibc, {})
    assert [t for t, *_ in got] == [10 * d + k for d in range(4)
                                    for k in range(d + 1)]


def test_sharded_local_view_and_refusals():
    one = trpc.ShardedRpcQueue.create(1, 4, width=2, device="cpu")
    view = one.local_view()
    assert view is one.local(0) and one.with_local(view) is one
    ring = tlibc.LogRing.create_sharded(1, 4, device="cpu")
    assert ring.with_local(ring.local_view()).q is ring.q
    two = trpc.ShardedRpcQueue.create(2, 4, width=2, device="cpu")
    with pytest.raises(AssertionError, match="local_view"):
        two.local_view()
    # a restack takes one queue's locals, every shard in order
    assert trpc.ShardedRpcQueue.stack([two.local(0), two.local(1)]) is two
    other = trpc.ShardedRpcQueue.create(2, 4, width=2, device="cpu")
    for locals_ in ([two.local(1), two.local(0)], [two.local(0)],
                    [two.local(0), other.local(1)]):
        with pytest.raises(ValueError, match="every shard in order"):
            trpc.ShardedRpcQueue.stack(locals_)
    with pytest.raises(ValueError, match="shard_deadline requires reply"):
        trpc.ShardedRpcQueue.create(2, 4, shard_deadline=0.1, device="cpu")
    q = trpc.ShardedRpcQueue.create(2, 4, reply_capacity=4,
                                    shard_deadline=trpc.TIMEOUT_S,
                                    device="cpu")
    with pytest.raises(ValueError, match="not below the channel"):
        q._check_policy()
    assert trpc.queue_geometry(two) == jrpc.queue_geometry(
        jrpc.ShardedRpcQueue.create(2, 4, width=2))


def test_async_flush_of_one_shard_is_refused():
    """An async sharded queue's epochs belong to the sharded queue: one
    shard of several refuses its own flush (and its plain version), and
    nothing moves; a sync shard flushes alone, and the one shard of a
    single-device queue flushes as the queue."""
    sq = trpc.ShardedRpcQueue.create(2, 4, width=2, reply_capacity=8,
                                     mode="async", device="cpu")
    view = sq.local(1)
    view.enqueue("diff.int", torch.tensor(7, dtype=torch.int32),
                 torch.tensor(0, dtype=torch.int32))
    before = sq.state.clone()
    for flush in (view.flush, view.flush_reference):
        with pytest.raises(ValueError, match="flush the ShardedRpcQueue"):
            flush()
    assert torch.equal(sq.state, before)
    sq.flush()
    assert sq.join(timeout=10)
    sync = trpc.ShardedRpcQueue.create(2, 4, width=2, device="cpu")
    sync.local(1).flush()
    one = trpc.ShardedRpcQueue.create(1, 4, width=2, reply_capacity=8,
                                      mode="async", device="cpu")
    one.local_view().flush().flush()
    assert one.join(timeout=10)
