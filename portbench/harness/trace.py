"""Traced windows: ``torch.profiler`` over a few steps, reduced to what the
per-layer metrics read.

The profiler's Chrome trace is written to a temporary file and read back.
The profiler runs a few steps before the window it keeps (its own start
costs a step several fold).  Two kinds of window: one that records the device's operations alone
(kernels, copies, fills) as intervals, whose busy time is their union (so
operations that overlap count once) from the first to the last; recording
the host's operations too slows a host-bound step several fold, so a
second, shorter window records both, inside a ``record_function`` span,
and labels each idle gap of the device by the host operation (ATen op,
CUDA runtime call) open during it.
"""
from __future__ import annotations

import heapq
from contextlib import nullcontext
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

WINDOW_SPAN = "portbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
#: The label of an idle gap during which no host operation was open: the
#: harness's or the program's own Python.
NO_OP = "host Python (no op open)"


def profile(step: Callable[[], None], warm: int, active: int, host: bool,
            on_open: Callable[[], None] = lambda: None,
            on_close: Callable[[], None] = lambda: None) -> Dict:
    """Run ``step`` ``warm + active`` times under the profiler, which keeps
    only the last ``active`` (the first ones warm it up); return their raw
    trace events.  With ``host`` the host's operations are recorded too
    and a span covers the active steps; without, only the device's
    operations are (the host runs at its own pace), and ``on_open`` and
    ``on_close``, run before the first active step and after the last,
    should each launch one device operation, so that
    :func:`device_window` takes the window from the first to the last."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    got: Dict = {"traceEvents": []}

    def ready(prof):
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                got.update(json.load(f))
        finally:
            os.remove(path)

    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    span = record_function(WINDOW_SPAN)
    sched = torch.profiler.schedule(wait=0, warmup=warm, active=active)
    with torch.profiler.profile(activities=acts, schedule=sched,
                                on_trace_ready=ready) if acts \
            else nullcontext() as prof:
        for i in range(warm + active):
            if i == warm:
                sync()
                span.__enter__() if host else on_open()
            step()
            if i == warm + active - 1:
                if host:
                    sync()
                    span.__exit__(None, None, None)
                else:
                    on_close()
                    sync()
            if prof is not None:
                prof.step()
    return got


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge intervals ``(start, end)`` into disjoint ones, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The parts of ``[lo, hi]`` that the disjoint, ordered ``busy``
    intervals leave uncovered."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def label_gaps(gs: List[Tuple[float, float]],
               host: List[Tuple[float, float, str]]) -> List[str]:
    """For each gap, the innermost host operation open at its midpoint
    (the open one that started last), or :data:`NO_OP`."""
    order = sorted(range(len(gs)), key=lambda i: gs[i][0] + gs[i][1])
    ops = sorted(host)
    heap: List[Tuple[float, float, str]] = []
    labels = [NO_OP] * len(gs)
    j = 0
    for i in order:
        mid = (gs[i][0] + gs[i][1]) / 2
        while j < len(ops) and ops[j][0] <= mid:
            s, e, name = ops[j]
            heapq.heappush(heap, (-s, e, name))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        if heap:
            labels[i] = heap[0][2]
    return labels


def _events(trace: Dict) -> List[Dict]:
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]


def _device(ev: List[Dict], lo: float, hi: float):
    """Device intervals clipped to ``[lo, hi]``, and seconds by name."""
    dev, by_name = [], defaultdict(float)
    for e in ev:
        if e.get("cat") in DEVICE_CATS:
            s = max(float(e["ts"]), lo)
            t = min(float(e["ts"]) + float(e["dur"]), hi)
            if t > s:
                dev.append((s, t))
                by_name[e["name"]] += (t - s) * 1e-6
    return union(dev), by_name


def _rank(d: Dict[str, float], top: int) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def device_window(trace: Dict, top: int = 10) -> Dict:
    """A device-only trace from its first device operation to its last:
    the window's seconds, the busy seconds (the union of device
    intervals), the top ``top`` operations by seconds, and the seconds of
    every operation by name (for the kernels' readers).  None when the
    trace holds no device operation."""
    ev = [e for e in _events(trace) if e.get("cat") in DEVICE_CATS]
    if not ev:
        return None
    lo = min(float(e["ts"]) for e in ev)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in ev)
    busy, by_name = _device(ev, lo, hi)
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "device_ops": _rank(by_name, top),
            "device_seconds_by_name": dict(by_name)}


def idle_by_host_op(trace: Dict, top: int = 10) -> List[list]:
    """A trace of host and device inside the window span: the device's
    idle seconds by the host operation open at each gap's midpoint, the
    top ``top``."""
    ev = _events(trace)
    win = [e for e in ev if e.get("name") == WINDOW_SPAN]
    if not win:
        raise RuntimeError("trace: the window span is missing")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    busy, _ = _device(ev, lo, hi)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in ev if e.get("cat") in HOST_CATS]
    idle = gaps(busy, lo, hi)
    idle_by = defaultdict(float)
    for (s, t), name in zip(idle, label_gaps(idle, host)):
        idle_by[name] += (t - s) * 1e-6
    return _rank(idle_by, top)


def seconds_of(summary: Dict, names) -> float:
    """Device seconds of the operations whose name contains one of
    ``names``."""
    return sum(v for k, v in summary["device_seconds_by_name"].items()
               if any(n in k for n in names))
