"""Measurement for the paper's evaluation: the port of the parts of the
JAX package's ``benchmarks/common.py`` that measure (no artifact is
written).

Columns follow the paper's evaluation design (§5.3): every parallel region
is measured three ways, ``serial`` (the single-team loop), ``gpu_first``
(the expanded loop, ``core/expand.py``) and ``manual`` (the hand-written
vectorised port).  On a card the serial column is a Python loop that
enqueues every iteration's kernels, so its time is the host's launch time
(JAX's ``lax.map`` is one program).  A region may therefore time the
serial column on a prefix of its loop and scale the time to the whole
loop; :func:`region` says so in its record.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.device_main import _device_of
from repro_torch.core.rpc import effects_barrier


def time_region(fn: Callable, *args, warmup: int = 2, iters: int = 5,
                device=None) -> float:
    """Median seconds of ``fn(*args)``: on a card CUDA events around each
    call, recorded after the host has caught up with the device, so an
    iteration's time is the device's or, where the host cannot keep the
    device busy, the host's; on the CPU a wall clock.  ``device`` defaults
    to the first tensor argument's (the CPU without one)."""
    device = _device_of(args) if device is None else torch.device(device)
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        if cuda:
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def time_drained(fn: Callable, *args, warmup: int = 2, iters: int = 5,
                 device=None) -> float:
    """:func:`time_region` with :func:`~repro_torch.core.effects_barrier`
    inside the timed window (JAX's ``time_fn_drained``): a host call's
    cost never leaks into the next iteration.  Anything that calls the
    host must be timed through this."""
    def drained(*a):
        out = fn(*a)
        effects_barrier()
        return out

    effects_barrier()
    return time_region(drained, *args, warmup=warmup, iters=iters,
                       device=device)


def contrast_best_of(fn_a: Callable, fn_b: Callable, *args, rounds: int = 3,
                     drained: bool = False, warmup: int = 2, iters: int = 9,
                     device=None) -> Tuple[float, float]:
    """Interleaved A/B timing (A, B, A, B, ...): each contestant's best
    median of ``rounds``, so that a burst of load hits both."""
    timer = time_drained if drained else time_region
    ta = tb = float("inf")
    for _ in range(rounds):
        ta = min(ta, timer(fn_a, *args, warmup=warmup, iters=iters,
                           device=device))
        tb = min(tb, timer(fn_b, *args, warmup=warmup, iters=iters,
                           device=device))
    return ta, tb


def emit(name: str, us_per_call: float, derived: str = "") -> str:
    """Print one CSV row ``name,us_per_call,derived`` (JAX's format)."""
    row = f"{name},{us_per_call:.2f},{derived}"
    print(row, flush=True)
    return row


def region(name: str, serial_s: float, gpu_first_s: float, manual_s: float,
           *, n_serial: int, n: int) -> Dict:
    """The three columns of one region, with JAX's two ratios.
    ``serial_s`` is the time of the serial column over the first
    ``n_serial`` of ``n`` iterations; the record's ``serial_s`` is scaled
    to all ``n`` (``serial_scaled`` says whether it was)."""
    whole = serial_s * n / n_serial
    return {"name": name, "n": n, "n_serial": n_serial,
            "serial_scaled": n_serial != n, "serial_run_s": serial_s,
            "serial_s": whole, "gpu_first_s": gpu_first_s,
            "manual_s": manual_s, "speedup_vs_serial": whole / gpu_first_s,
            "gpu_first_vs_manual": gpu_first_s / manual_s}


def emit_region(rec: Dict) -> None:
    """JAX's three rows of a region (``emit_region``); the serial row
    notes a prefix."""
    prefix = (f"serial_prefix={rec['n_serial']}/{rec['n']}"
              if rec["serial_scaled"] else "")
    emit(f"{rec['name']}/serial", rec["serial_s"] * 1e6, prefix)
    emit(f"{rec['name']}/gpu_first", rec["gpu_first_s"] * 1e6,
         f"speedup_vs_serial={rec['speedup_vs_serial']:.2f}x")
    emit(f"{rec['name']}/manual", rec["manual_s"] * 1e6,
         f"gpu_first_vs_manual={rec['gpu_first_vs_manual']:.3f}")


@dataclasses.dataclass
class Region:
    """One parallel region of Figs. 8-10 and its three columns.

    ``serial(m)`` runs the single-team loop over the first ``m`` of the
    ``n`` iterations and returns their results stacked; ``gpu_first()``
    and ``manual()`` run the whole loop.  ``n_serial`` is the prefix the
    serial column is timed on.  ``kind`` is the body's tolerance class:
    ``elementwise``, ``chained``, ``stencil``, ``inverse`` or
    ``integer``.  ``manual_agrees`` is False where JAX's manual
    column computes another function than its serial and gpu_first
    columns (hypterm and botsspar; the port keeps each column equal to
    JAX's).  ``magnitude(m)``, where given, is the sum of the absolute
    terms behind each of the first ``m`` results, and
    ``manual_magnitude()`` that behind the manual column's, for results
    that cancel (hypterm's sums).  ``gate()``, where given, builds the
    variant of the region that the card's gates hold the columns on,
    because this one's columns part by more than any tolerance between
    two correct implementations; ``gate_note`` says how it differs."""
    name: str
    n: int
    serial: Callable[[int], torch.Tensor]
    gpu_first: Callable[[], torch.Tensor]
    manual: Callable[[], torch.Tensor]
    n_serial: int
    kind: str = "elementwise"
    manual_agrees: bool = True
    magnitude: Optional[Callable[[int], torch.Tensor]] = None
    manual_magnitude: Optional[Callable[[], torch.Tensor]] = None
    gate: Optional[Callable[[], "Region"]] = None
    gate_note: str = ""

    def gate_region(self) -> "Region":
        """The region the gates hold: ``gate()``'s, else this one."""
        return self.gate() if self.gate is not None else self

    def measure(self, *, warmup: int = 2, iters: int = 5, device=None
                ) -> Dict:
        """Time the three columns (each result summed, as JAX's) and
        return :func:`region`'s record."""
        ts = time_region(lambda: self.serial(self.n_serial).sum(),
                         warmup=warmup, iters=iters, device=device)
        tg = time_region(lambda: self.gpu_first().sum(), warmup=warmup,
                         iters=iters, device=device)
        tm = time_region(lambda: self.manual().sum(), warmup=warmup,
                         iters=iters, device=device)
        return region(self.name, ts, tg, tm, n_serial=self.n_serial,
                      n=self.n)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def aten_ops(fn: Callable) -> int:
    """The ATen operators one call of ``fn`` runs, views not counted
    (under ``torch.vmap``, those its batching rules run).  On a card each
    is at least one launch, some (an ``einsum``, a batched gather) a
    few."""
    with _OpCount() as count:
        fn()
    return count.n


def sharded_queue_contrast(n_shards: int, per_shard: int, *, device,
                           callee: str = "bench.queue_rec",
                           **time_kwargs) -> Dict:
    """Funneled against sharded batched transport (JAX's
    ``sharded_queue_contrast``, shared by Figs. 6 and 7): ``n_shards *
    per_shard`` records through ONE :class:`RpcQueue` and its flush,
    against ``per_shard`` records into each of ``n_shards`` shards of a
    :class:`ShardedRpcQueue` and one ``(device, slot)``-ordered flush.
    Returns the median seconds of each (``"funneled"``, ``"sharded"``)
    and, under ``"records"``, what each delivered to the host in one
    untimed run: ``(i, x)`` in delivery order."""
    import numpy as np
    from repro_torch.core.rpc import REGISTRY, RpcQueue, ShardedRpcQueue

    seen: List[Tuple[int, float]] = []

    def rec(i, x):
        seen.append((int(i), float(x)))
        return np.int32(0)

    REGISTRY.register(callee, rec)
    D, K = n_shards, per_shard

    def funneled():
        q = RpcQueue.create(D * K, width=2, device=device)
        for i in range(D * K):
            q.enqueue(callee, i, 0.5)
        return q.flush().head

    def sharded():
        q = ShardedRpcQueue.create(D, K, width=2, device=device)
        for dev in range(D):
            lq = q.local(dev)
            for i in range(K):
                lq.enqueue(callee, dev * K + i, 0.5)
        return q.flush().local(0).head

    records = {}
    for name, fn in (("funneled", funneled), ("sharded", sharded)):
        effects_barrier()
        seen.clear()
        fn()
        effects_barrier()
        records[name] = list(seen)
    return {"funneled": time_drained(funneled, device=device, **time_kwargs),
            "sharded": time_drained(sharded, device=device, **time_kwargs),
            "records": records}
