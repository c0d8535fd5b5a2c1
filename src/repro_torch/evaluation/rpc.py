"""Paper Fig. 7: the RPC round trip and where its time goes (the JAX
package's ``benchmarks/rpc_bench.py``; none of it needs a mesh).

The paper calls ``fprintf(stderr, "...", buffer[128])`` 1000 times by RPC
and finds 975 us a call, ~89% of it the device waiting on the host.  Here:
a host function shipping a 128-byte read-write buffer, called from a loop
of device work, against (a) the same loop without the RPC (device only),
(b) the host function alone, and (c) the device libc's ``LogRing``, which
buffers on the device and flushes once.  Then the batched transport's
contrasts: per-call against batched records (64), array payloads and
device-consumed replies at 1, 64 and 1024 elements, the sharded queue, the
fault-free cost of a retry policy and of a per-callee timeout, and the
sync against the async flush behind a ~200 us host callee.

JAX asserts its ratios (``PAYLOAD_TARGET`` and the rest), set on its CPU
container; this prints each ratio beside its target and raises on none,
since the host's speed varies between calls.  What it checks instead is
what the host received: every section returns its evidence (records,
replies, buffers), which is bit-equal on every device.  JAX's cross-run
check against a committed ``BENCH_rpc.json`` is not ported: the port
writes no artifact.
"""
from __future__ import annotations

import inspect
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.libc import LogRing, drain_log_lines
from repro_torch.core.rpc import (READWRITE, REGISTRY, Ref, RetryPolicy,
                                  RpcQueue, ShapeDtype, effects_barrier,
                                  host_rpc, rpc_call)
from repro_torch.evaluation.common import (contrast_best_of, emit,
                                           sharded_queue_contrast,
                                           time_drained)

N_CALLS = 200
N_QUEUED = 64
N_SHARDS = 4
PAYLOAD_ELEMS = (1, 64, 1024)
PAYLOAD_TARGET = 5.0
REPLY_ELEMS = (1, 64, 1024)
REPLY_TARGET = 2.0
FAULT_OVERHEAD_TARGET = 1.10
TIMEOUT_HOP_TARGET = 1.5
#: The timeout leg's per-callee timeout.  JAX's is 5 s; a card queue
#: refuses a flush whose worst case (64 records x 5 s) outlasts the
#: channel's 120 s wait, so the port's is 1 s.
TIMEOUT_S = 1.0
ASYNC_OVERLAP_TARGET = 2.0
ASYNC_SLEEP_S = 200e-6

_I32 = ShapeDtype((), torch.int32)
_SINK: List[Tuple[int, float]] = []


@host_rpc(result_shape=_I32)
def fprintf_like(tag, buf):
    """The host wrapper: unpack, "print" (buffered), return."""
    _SINK.append((int(tag), float(buf[0])))
    buf[:] = buf + 1.0
    return np.int32(128)


def _zeros(device):
    return torch.zeros((), device=device)


def roundtrip_section(device, *, warmup: int = 1, iters: int = 3
        ) -> Tuple[Dict, Dict]:
    """The per-call round trip, the host body alone and the buffered
    ``LogRing``, ``N_CALLS`` each."""
    def rpc_loop(x):
        for i in range(N_CALLS):
            _, (x,) = fprintf_like.rpc(i, Ref(x, access=READWRITE))
        return x

    def device_only_loop(x):
        for _ in range(N_CALLS):
            x = x + 1.0
        return x

    def buffered_loop(x):
        ring = LogRing.create(N_CALLS, device=device)
        for i in range(N_CALLS):
            x = x + 1.0
            ring.log(i, x[0])
        ring.flush()
        return x

    x = torch.zeros((32,), device=device)     # 128 bytes, as in the paper
    t_rpc = time_drained(rpc_loop, x, warmup=warmup, iters=iters)
    t_dev = time_drained(device_only_loop, x, warmup=warmup, iters=iters)
    t_buf = time_drained(buffered_loop, x, warmup=warmup, iters=iters)
    host_buf = np.zeros(32, np.float32)
    t0 = time.perf_counter()
    for i in range(N_CALLS):
        fprintf_like(i, host_buf)
    t_host = time.perf_counter() - t0

    per_call = (t_rpc - t_dev) / N_CALLS
    buffered = (t_buf - t_dev) / N_CALLS
    wait_frac = 1.0 - min(t_host / max(t_rpc - t_dev, 1e-12), 1.0)
    emit("fig7/rpc_roundtrip", per_call * 1e6,
         f"wait_fraction={wait_frac:.3f}")
    emit("fig7/host_body", t_host / N_CALLS * 1e6, "")
    emit("fig7/buffered_logring", buffered * 1e6,
         f"rpc_vs_buffered={per_call / max(buffered, 1e-12):.1f}x")

    effects_barrier()
    _SINK.clear()
    drain_log_lines()
    out = rpc_loop(x)
    effects_barrier()
    sink = list(_SINK)
    out_b = buffered_loop(x)
    effects_barrier()
    evidence = {"sink": sink, "buf": out.cpu(), "log": drain_log_lines(),
                "buffered_buf": out_b.cpu()}
    return ({"rpc_roundtrip_us": per_call * 1e6, "wait_fraction": wait_frac,
             "host_body_us": t_host / N_CALLS * 1e6,
             "buffered_logring_us": buffered * 1e6,
             "device_only_us": t_dev / N_CALLS * 1e6}, evidence)


def batched_section(device, *, warmup: int = 1, iters: int = 5
        ) -> Tuple[Dict, Dict]:
    """``N_QUEUED`` scalar records: a round trip each against one flush."""
    tally: List[Tuple[int, float]] = []

    def record(i, x):
        tally.append((int(i), float(x)))
        return np.int32(0)

    REGISTRY.register("bench.record", record)

    def percall_loop(s):
        for i in range(N_QUEUED):
            rpc_call("bench.record", i, s, result_shape=_I32)
            s = s + 1.0
        return s

    def batched_loop(s):
        q = RpcQueue.create(N_QUEUED, width=2, device=device)
        for i in range(N_QUEUED):
            q.enqueue("bench.record", i, s)
            s = s + 1.0
        q.flush()
        return s

    def device_only(s):
        for _ in range(N_QUEUED):
            s = s + 1.0
        return s

    s0 = _zeros(device)
    t_percall = time_drained(percall_loop, s0, warmup=warmup, iters=iters)
    t_batched = time_drained(batched_loop, s0, warmup=warmup, iters=iters)
    t_dev = time_drained(device_only, s0, warmup=warmup, iters=iters)
    per_call = max(t_percall - t_dev, 1e-12) / N_QUEUED
    batched = max(t_batched - t_dev, 1e-12) / N_QUEUED
    amort = per_call / batched
    emit(f"fig7/percall_io_callback_{N_QUEUED}", per_call * 1e6, "")
    emit(f"fig7/batched_flush_{N_QUEUED}", batched * 1e6,
         f"amortization={amort:.1f}x target>=5x")
    evidence = {}
    for name, fn in (("percall", percall_loop), ("batched", batched_loop)):
        effects_barrier()
        tally.clear()
        fn(s0)
        effects_barrier()
        evidence[name] = list(tally)
    return ({"records": N_QUEUED, "percall_us_per_record": per_call * 1e6,
             "scalar_batched_us_per_record": batched * 1e6,
             "amortization": amort}, evidence)


def payload_section(device, *, warmup: int = 2, iters: int = 9
        ) -> Tuple[Dict, Dict]:
    """``N_QUEUED`` records carrying a P-element float array: a round trip
    each against the payload arena and one flush."""
    got: List[Tuple[int, int, float]] = []

    def payload_sink(i, arr):
        got.append((int(i), len(arr), float(np.asarray(arr).sum())))
        return np.int32(0)

    REGISTRY.register("bench.payload", payload_sink)
    recs, evidence = {}, {}
    for P in PAYLOAD_ELEMS:
        ramp = torch.arange(P, dtype=torch.float32, device=device)

        def percall_loop(s):
            for i in range(N_QUEUED):
                rpc_call("bench.payload", i, s + ramp, result_shape=_I32)
                s = s + 1.0
            return s

        def batched_loop(s):
            q = RpcQueue.create(N_QUEUED, width=2,
                                payload_capacity=N_QUEUED * P, device=device)
            for i in range(N_QUEUED):
                q.enqueue("bench.payload", i, s + ramp)
                s = s + 1.0
            q.flush()
            return s

        s0 = _zeros(device)
        t_percall = time_drained(percall_loop, s0, warmup=warmup, iters=iters)
        t_batched = time_drained(batched_loop, s0, warmup=warmup, iters=iters)
        per_call, batched = t_percall / N_QUEUED, t_batched / N_QUEUED
        amort = per_call / batched
        emit(f"fig7/payload{P}/percall", per_call * 1e6, "")
        emit(f"fig7/payload{P}/arena_batched", batched * 1e6,
             f"amortization={amort:.1f}x"
             + (f" target>={PAYLOAD_TARGET:.0f}x" if P == 64 else ""))
        recs[f"elems{P}"] = {"records": N_QUEUED, "payload_elems": P,
                             "percall_us_per_record": per_call * 1e6,
                             "arena_batched_us_per_record": batched * 1e6,
                             "amortization": amort}
        for name, fn in (("percall", percall_loop),
                         ("batched", batched_loop)):
            effects_barrier()
            got.clear()
            fn(s0)
            effects_barrier()
            evidence[f"elems{P}/{name}"] = list(got)
    return recs, evidence


def reply_section(device, *, rounds: int = 3, warmup: int = 2,
                  iters: int = 9
                  ) -> Tuple[Dict, Dict]:
    """``N_QUEUED`` calls whose P-element int reply is consumed on the
    device: a round trip each against ticketed records, one flush and the
    reply arena's reads.  The per-call RPC names the device: its operands
    are Python numbers, and a call without a tensor operand otherwise
    runs on the host.  One callee, ``bench.reply``, answers every size, as
    in ``benchmarks/rpc_bench.py``: one landing pad, whose result shape is
    given at each call (on a card, a staging region a shape)."""
    def reply_host(i, p):
        return np.arange(int(p), dtype=np.int32) + int(i)

    name = "bench.reply"
    REGISTRY.register(name, reply_host)
    recs, evidence = {}, {}
    for P in REPLY_ELEMS:
        shape = ShapeDtype((P,), torch.int32)

        def percall_loop(s):
            for i in range(N_QUEUED):
                r, _ = rpc_call(name, i, P, result_shape=shape,
                                device=device)
                s = s + r[0]
            return s

        def batched_loop(s):
            q = RpcQueue.create(N_QUEUED, width=2,
                                reply_capacity=N_QUEUED * P, device=device)
            for i in range(N_QUEUED):
                # no drops here, so ticket i is loop index i
                q.enqueue_ticketed(name, i, P, returns=shape)
            q.flush()
            for i in range(N_QUEUED):
                s = s + q.result(i, (P,), torch.int32)[0]
            return s

        s0 = torch.zeros((), dtype=torch.int32, device=device)
        t_percall, t_batched = contrast_best_of(
            percall_loop, batched_loop, s0, rounds=rounds, drained=True,
            warmup=warmup, iters=iters)
        per_call, batched = t_percall / N_QUEUED, t_batched / N_QUEUED
        amort = per_call / max(batched, 1e-12)
        emit(f"fig7/reply{P}/percall", per_call * 1e6, "")
        emit(f"fig7/reply{P}/arena_batched", batched * 1e6,
             f"amortization={amort:.1f}x"
             + (f" target>={REPLY_TARGET:.0f}x" if P == 64 else ""))
        recs[f"elems{P}"] = {"records": N_QUEUED, "reply_elems": P,
                             "percall_us_per_record": per_call * 1e6,
                             "reply_batched_us_per_record": batched * 1e6,
                             "amortization": amort}
        evidence[f"elems{P}"] = (int(percall_loop(s0).cpu()),
                                 int(batched_loop(s0).cpu()))
        effects_barrier()
    return recs, evidence


def sharded_section(device, *, warmup: int = 1, iters: int = 5
        ) -> Tuple[Dict, Dict]:
    """Funneled (one queue for every shard's records) against sharded (a
    queue shard a logical device, one ``(device, slot)``-ordered
    flush)."""
    D, K = N_SHARDS, N_QUEUED
    t = sharded_queue_contrast(D, K, device=device, warmup=warmup,
                               iters=iters)
    per_fun, per_sh = t["funneled"] / (D * K), t["sharded"] / (D * K)
    emit(f"fig7/sharded_queue_{D}x{K}/funneled", per_fun * 1e6, "")
    emit(f"fig7/sharded_queue_{D}x{K}/sharded", per_sh * 1e6,
         f"speedup_vs_funneled={per_fun / max(per_sh, 1e-12):.2f}x")
    return ({"devices": D, "records": D * K,
             "funneled_us_per_record": per_fun * 1e6,
             "sharded_us_per_record": per_sh * 1e6,
             "sharded_speedup": per_fun / max(per_sh, 1e-12)},
            t["records"])


def fault_overhead_section(device, *, rounds: int = 3, warmup: int = 2,
                           iters: int = 9
                           ) -> Tuple[Dict, Dict]:
    """The fault-free cost of the fault-tolerant drain on one ticketed
    batched program (``N_QUEUED`` records, 1-word replies read on the
    device): ``fast`` (no policy), ``guarded`` (a ``RetryPolicy``) and
    ``timeout`` (every callee on a worker thread)."""
    REGISTRY.register("bench.fault_overhead", lambda i: np.int32(i),
                      idempotent=True)

    def make_loop(retry, timeout):
        def loop(s):
            q = RpcQueue.create(N_QUEUED, width=2, reply_capacity=N_QUEUED,
                                retry=retry, timeout=timeout, device=device)
            for i in range(N_QUEUED):
                q.enqueue_ticketed("bench.fault_overhead", i, returns=_I32)
            q.flush()
            for i in range(N_QUEUED):
                s = s + q.result(i, (), torch.int32)
            return s
        return loop

    s0 = torch.zeros((), dtype=torch.int32, device=device)
    loops = {"fast": make_loop(None, None),
             "guarded": make_loop(RetryPolicy(max_attempts=2), None),
             "timeout": make_loop(None, TIMEOUT_S)}
    t_fast, t_guarded = contrast_best_of(
        loops["fast"], loops["guarded"], s0, rounds=rounds, drained=True,
        warmup=warmup, iters=iters)
    t_timeout = time_drained(loops["timeout"], s0, warmup=warmup,
                             iters=iters)
    fast, guarded = t_fast / N_QUEUED, t_guarded / N_QUEUED
    timed = t_timeout / N_QUEUED
    overhead, hop = guarded / max(fast, 1e-12), timed / max(fast, 1e-12)
    emit("fig7/fault_overhead/fast", fast * 1e6, "")
    emit("fig7/fault_overhead/guarded", guarded * 1e6,
         f"overhead={overhead:.3f}x target<={FAULT_OVERHEAD_TARGET:.2f}x")
    emit("fig7/fault_overhead/timeout", timed * 1e6,
         f"thread_hop={hop:.2f}x target<={TIMEOUT_HOP_TARGET:.1f}x")
    evidence = {k: int(fn(s0).cpu()) for k, fn in loops.items()}
    effects_barrier()
    return ({"records": N_QUEUED, "fast_us_per_record": fast * 1e6,
             "guarded_us_per_record": guarded * 1e6,
             "timeout_us_per_record": timed * 1e6, "overhead": overhead,
             "thread_hop": hop}, evidence)


def async_section(device, *, iters: int = 5) -> Tuple[Dict, Dict]:
    """``N_QUEUED`` records whose callee sleeps ~200 us: the sync drain
    pays the host's time inside the flush, the async flush only submits
    the epoch and collects the previous one.  Each timed iteration is the
    enqueues, the flush and the drain barrier; the async leg joins its
    drain outside the timed window (a well-paced consumer's steady
    state).  ``overlap`` is sync over async."""
    calls: List[int] = []

    def sleep_host(i):
        time.sleep(ASYNC_SLEEP_S)
        calls.append(int(i))
        return np.int32(i)

    REGISTRY.register("bench.async_sleep", sleep_host)

    def make_loop(mode):
        def loop(s):
            q = RpcQueue.create(N_QUEUED, width=2, reply_capacity=N_QUEUED,
                                mode=mode, device=device)
            for i in range(N_QUEUED):
                q.enqueue_ticketed("bench.async_sleep", i, returns=_I32)
            return s + 1.0, q.flush()
        return loop

    def time_leg(fn, is_async):
        s0 = _zeros(device)
        _, q = fn(s0)                       # warm the slot
        effects_barrier()
        if is_async:
            q.join()
        total = 0.0
        for _ in range(iters):
            t0 = time.perf_counter()
            s, q = fn(s0)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            effects_barrier()
            total += time.perf_counter() - t0
            if is_async:
                q.join()                    # untimed: settle the epoch
        return total / iters

    device = torch.device(device)
    calls.clear()
    t_sync = time_leg(make_loop("sync"), False)
    sync_calls = len(calls)
    t_async = time_leg(make_loop("async"), True)
    overlap = t_sync / max(t_async, 1e-12)
    emit(f"fig7/async_{N_QUEUED}/sync_flush", t_sync * 1e6, "")
    emit(f"fig7/async_{N_QUEUED}/async_flush", t_async * 1e6,
         f"overlap={overlap:.1f}x target>={ASYNC_OVERLAP_TARGET:.0f}x")
    return ({"records": N_QUEUED, "callee_sleep_us": ASYNC_SLEEP_S * 1e6,
             "sync_flush_us": t_sync * 1e6, "async_flush_us": t_async * 1e6,
             "overlap": overlap},
            {"sync_callee_calls": sync_calls,
             "async_callee_calls": len(calls) - sync_calls})


SECTIONS = {"fig7": roundtrip_section, "batched": batched_section,
            "payload": payload_section, "reply": reply_section,
            "sharded": sharded_section,
            "fault_overhead": fault_overhead_section,
            "async": async_section}


def run(device, **timing) -> Tuple[Dict, Dict]:
    """Every section of Fig. 7: ``(records, evidence)`` keyed by section.
    ``timing`` (``warmup``, ``iters``, ``rounds``) overrides JAX's counts
    in each section that takes them; the async section's evidence counts
    its callee's calls, so runs to compare take the same ``iters``."""
    recs, evidence = {}, {}
    for name, fn in SECTIONS.items():
        params = inspect.signature(fn).parameters
        kw = {k: v for k, v in timing.items() if k in params}
        recs[name], evidence[name] = fn(torch.device(device),
                                        **kw)
    return recs, evidence
