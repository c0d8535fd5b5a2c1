"""The host RPC of two or more builds, in turns on one card.

    python -m repro_torch.evaluation.rpc_ab ROOT[:FLAG,...] ... \\
        [--out chiprun_out/rpc_ab.jsonl]

Each variant is a checkout's root (its ``chip_smoke.py`` and ``src/``),
with extra ``nvcc`` flags for its kernels after a colon: ``.`` is this
tree, ``build/parent`` a parent commit unpacked there with ``git
archive``, ``.:-DRPC_SLOTS=32`` this tree with ``rpc_post``'s slot table
cut to 32 slots (the library is built apart, its name hashed with the
flags).  Each variant runs in a child process of its
own, in the order given, so give them in turns (A B B A).  A child
measures with its own tree's code: ``chip_smoke.py``'s ``rpc_time`` phase
(the empty round trip and its parts, READWRITE refs of 4 KB to 64 MB, and
whatever else that tree's phase measures), its ``rpc_queue_time`` phase
(the batched queue's enqueue, host and device us a record, and whatever
else that tree's phase measures), its ``device_run_hooks`` phase, Fig.
7's round trip (``evaluation/rpc.py::roundtrip_section``), Fig. 6's
funneled against sharded queue contrast
(``evaluation/common.py::sharded_queue_contrast`` at Fig. 6's sizes) and
an async card queue's loop, through API that every tree since the async
queue has (``RpcQueue.create(mode="async")``, ``enqueue``, ``flush``,
CUDA events): :data:`ASYNC_FLUSHES` flushes of
:data:`ASYNC_RECORDS` fire-and-forget records each, synchronised every
:data:`ASYNC_CHUNK` flushes, the host us of each ``flush`` call and the
device ms of the loop.
Every JSON line a child prints goes to ``--out`` (one object a variant);
a summary line a variant goes to standard output.  It needs a card and
the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List

# The child: argv is the variant's root, its nvcc flags (comma-joined), the
# seconds after which it prints every thread's stack and exits, and the
# async loop's flushes, records a flush and flushes a synchronisation.
_CHILD = r"""
import faulthandler, json, sys
faulthandler.dump_traceback_later(float(sys.argv[3]), exit=True)
root, flags = sys.argv[1], [f for f in sys.argv[2].split(",") if f]
sys.path[:0] = [root + "/src", root]
from repro_torch.kernels import _build
_build.NVCC_FLAGS.extend(flags)
# built before any phase: a phase's warm-up would otherwise time the build
_build.build_all(["rpc_channel", "rpc_queue", "rpc_async"])
import torch
import chip_smoke
from repro_torch.evaluation import allocator, common, rpc as fig
card = chip_smoke.nvidia_smi()
chip_smoke.rpc_time_phase(card)
chip_smoke.rpc_queue_time_phase(card)
chip_smoke.device_run_hooks_phase()
dev = torch.device("cuda", 0)
stats, _ = fig.roundtrip_section(dev)
print(json.dumps({"fig7": stats}), flush=True)
D, K = allocator.SHARD_DEVICES, allocator.QUEUE_PER_SHARD
tq = common.sharded_queue_contrast(D, K, device=dev, warmup=2,
                                   iters=allocator.QUEUE_ITERS)
print(json.dumps({"fig6_queue": {
    "records": D * K, "funneled_us_per_record": tq["funneled"] / (D * K) * 1e6,
    "sharded_us_per_record": tq["sharded"] / (D * K) * 1e6}}), flush=True)
import time, numpy as np
from repro_torch.core import RpcQueue
from repro_torch.core.rpc import REGISTRY
REGISTRY.register("ab.async_sink", lambda i: None)
flushes, records, chunk = (int(a) for a in sys.argv[4:7])
q = RpcQueue.create(**chip_smoke.QUEUE_GEOMETRY, mode="async", device=dev)
def loop(n):
    host = []
    for i in range(n):
        for r in range(records):
            q.enqueue("ab.async_sink", i * records + r)
        t0 = time.perf_counter()
        q.flush()
        host.append((time.perf_counter() - t0) * 1e6)
        if (i + 1) % chunk == 0:
            torch.cuda.synchronize()
    return host
loop(20)
torch.cuda.synchronize()
a = torch.cuda.Event(enable_timing=True)
b = torch.cuda.Event(enable_timing=True)
t0 = time.perf_counter()
a.record()
host = loop(flushes)
b.record()
torch.cuda.synchronize()
loop_ms = (time.perf_counter() - t0) * 1e3
assert q.join(timeout=60)
print(json.dumps({"async_flush": {
    "flushes": flushes, "records_per_flush": records, "chunk": chunk,
    "host_us_per_flush": float(np.mean(host)),
    "host_us_per_flush_median": float(np.median(host)),
    "loop_device_ms": a.elapsed_time(b), "loop_host_ms": loop_ms}}),
    flush=True)
"""

#: The async loop of the child: flushes, records enqueued before each, and
#: the flushes between two synchronisations.  The loop's device work is
#: bound by the host's drain (a collect waits for the previous epoch's
#: answer), so unpaced the host would fill CUDA's launch queue (~1,000
#: launches) and then time its own blocking, not its work.
ASYNC_FLUSHES, ASYNC_RECORDS, ASYNC_CHUNK = 500, 4, 25


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def _enqueue(case: dict) -> Dict[str, float]:
    """One ``rpc_queue_time`` case's ``RpcQueue.enqueue`` host and device
    us: the plan route's where the tree has one, else the op's (a tree
    whose enqueue was the op)."""
    route = "plan" if "plan_host_us" in case else "op"
    out = {"host_us": _mean(case.get(f"{route}_host_us", [])),
           "device_us": _mean(case.get(f"{route}_device_us", []))}
    if out["device_us"] is None and "kernel" in case:
        out["device_us"] = case["kernel"].get("device_us")
    if route == "plan":
        out["ticketed_host_us"] = _mean(case.get("ticketed_host_us", []))
        out["op_host_us"] = _mean(case.get("op_host_us", []))
    return out


def _lines(text: str) -> Dict[str, dict]:
    """The child's one-key JSON lines, by key."""
    out = {}
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and len(obj) == 1:
                out.update(obj)
    return out


def summary(lines: Dict[str, dict]) -> Dict[str, float]:
    """The readings compared between variants (absent ones left out)."""
    t = lines.get("rpc_time", {})
    empty, refs = t.get("empty", {}), t.get("readwrite", {})
    hooks, fig7 = lines.get("device_run_hooks", {}), lines.get("fig7", {})
    queue = lines.get("rpc_queue_time", {}).get("enqueue", {})
    fig6 = lines.get("fig6_queue", {})
    flush = lines.get("async_flush", {})
    picks = {
        "empty_ms": empty.get("ms"),
        "empty_enqueue_us": empty.get("enqueue_us"),
        "empty_kernel_wait_us": empty.get("kernel_wait_us"),
        "empty_busy_ms": empty.get("behind_busy_stream_ms"),
        "isolated_ms": empty.get("isolated", {}).get("ms"),
        "latency_floor_ms": empty.get("latency_floor", {}).get("ms"),
        "cuda_api_calls_per_call": empty.get("cuda_api_calls_per_call"),
        "plain_ms": empty.get("plain_ms"),
        "fig7_roundtrip_us": fig7.get("rpc_roundtrip_us"),
        "fig6_funneled_us_per_record": fig6.get("funneled_us_per_record"),
        "fig6_sharded_us_per_record": fig6.get("sharded_us_per_record"),
        "async_flush_host_us": flush.get("host_us_per_flush"),
        "async_flush_host_us_median": flush.get("host_us_per_flush_median"),
        "async_flush_loop_device_ms": flush.get("loop_device_ms"),
    }
    for label, case in queue.items():
        for key, v in _enqueue(case).items():
            picks[f"enqueue_{label}_{key}"] = v
    for label in ("4KB", "1MB", "64MB"):
        picks[f"ref_{label}_ms"] = refs.get(label, {}).get("ms")
    for key in ("every_1", "every_100", "batched_every_1"):
        picks[f"hooks_{key}_device_ms"] = hooks.get(key, {}).get("device_ms")
    picks["hooks_batched_every_1_loop_ms"] = hooks.get(
        "batched_every_1", {}).get("python_loop_ms")
    return {k: v for k, v in picks.items() if v is not None}


def run_variant(spec: str, timeout: float) -> dict:
    root, _, flags = spec.partition(":")
    root = os.path.abspath(root)
    proc = subprocess.run([sys.executable, "-c", _CHILD, root, flags,
                           str(timeout), str(ASYNC_FLUSHES),
                           str(ASYNC_RECORDS), str(ASYNC_CHUNK)], cwd=root,
                          capture_output=True, text=True,
                          timeout=timeout + 60)
    if proc.returncode != 0:
        raise RuntimeError(f"rpc_ab: {spec} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = _lines(proc.stdout)
    return {"variant": spec, "summary": summary(lines), "lines": lines}


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+",
                    help="ROOT[:NVCC_FLAG,...], in the order to run")
    ap.add_argument("--out", default=None, help="JSON lines, one a variant")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a variant may take (then its threads' "
                    "stacks are printed)")
    args = ap.parse_args(argv)
    out = open(args.out, "w") if args.out else None
    try:
        for spec in args.variants:
            rec = run_variant(spec, args.timeout)
            if out is not None:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            print(json.dumps({"rpc_ab": {"variant": spec,
                                         **rec["summary"]}}), flush=True)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
