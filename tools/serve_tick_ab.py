#!/usr/bin/env python3
"""Time the serving engine's tick of this tree against another tree's on
one card, in turns (other, this, this, other, ...): llama3.2-3b at full
width and depth (28 layers, bf16, random weights from seed 0) behind
``ServingEngine(batch_slots=4, page_size=16, max_len=512)`` on
``chip_smoke.py``'s ``serve`` traffic (a 200-token prompt and 8 short
ones, 16 new tokens each), and the paged-attention call alone at that
tick's shape (4 slots, 32 heads over 8 KV heads of 128, 512-token page
table) back to back, where the host's cost of each call shows.

  python3 tools/serve_tick_ab.py OTHER_ROOT [--rounds 1]

OTHER_ROOT is the root of another checkout (for instance the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each run is a fresh process that imports only its tree's ``repro_torch``;
both load the kernels from this tree's build directory (a source that is
the same in both trees builds once).  Prints one JSON line a run (ms/tick
over the whole drain, us a paged-attention call, the streams' digest) and
a summary line: each tree's median, the change in percent, and whether the
two trees' streams are equal.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One run in a fresh process: argv[1] the tree's root, argv[2] this tree's
# build directory.
_RUN = r"""
import hashlib, json, os, sys, time
root, build = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.join(root, "src"))
import numpy as np
import torch
from repro_torch.kernels import _build
_build.BUILD_DIR = type(_build.BUILD_DIR)(build)
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine

cfg = get_config("llama3.2-3b")
model = build_model(cfg, device="cuda")
params = model.init(seed=0)
rng = np.random.default_rng(7)
prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, 200)]] + [
    [int(t) for t in rng.integers(1, cfg.vocab_size, 4 + i % 9)]
    for i in range(8)]


def serve():
    engine = ServingEngine(model, params, batch_slots=4, page_size=16,
                           max_len=512, device="cuda")
    rids = [engine.submit(p, max_new=16) for p in prompts]
    ticks = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.queue or any(s.request_id >= 0 for s in engine.slots):
        engine.step()
        ticks += 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ticks * 1e3, \
        [engine.finished[r] for r in rids]


serve()                                   # warm: kernels, allocator
ms, streams = serve()
g = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn(4, 32, 128, generator=g, device="cuda", dtype=torch.bfloat16)
pages = torch.randn(128, 16, 8, 128, generator=g, device="cuda",
                    dtype=torch.bfloat16)
table = torch.arange(128, dtype=torch.int32, device="cuda").reshape(4, 32)
lengths = torch.tensor([216, 20, 12, 9], dtype=torch.int32, device="cuda")
calls = 2000
for _ in range(100):
    paged_decode_attention(q, pages, pages, table, lengths)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(calls):
    paged_decode_attention(q, pages, pages, table, lengths)
torch.cuda.synchronize()
op_us = (time.perf_counter() - t0) / calls * 1e6
print(json.dumps({"ms_per_tick": ms, "paged_call_us": op_us,
                  "streams": hashlib.sha256(
                      json.dumps(streams).encode()).hexdigest()[:16]}))
"""


def _run(root: str) -> dict:
    build = os.path.join(ROOT, "build", "repro_torch")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _RUN, root, build],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"run of {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    _build.build_all(["paged_attention"])
    runs = {"other": [], "this": []}
    for r in range(args.rounds):
        order = ("other", "this") if r % 2 == 0 else ("this", "other")
        for tree in order + order[::-1]:
            rec = _run(other if tree == "other" else ROOT)
            runs[tree].append(rec)
            print(json.dumps({"round": r, "tree": tree, **rec}), flush=True)
    med = {t: {k: statistics.median(x[k] for x in rs)
               for k in ("ms_per_tick", "paged_call_us")}
           for t, rs in runs.items()}
    print(json.dumps({"summary": med, "tick_change_pct": 100 * (
        med["this"]["ms_per_tick"] / med["other"]["ms_per_tick"] - 1),
        "call_change_pct": 100 * (med["this"]["paged_call_us"]
                                  / med["other"]["paged_call_us"] - 1),
        "streams_equal": len({x["streams"] for rs in runs.values()
                              for x in rs}) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
