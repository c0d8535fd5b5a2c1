#!/usr/bin/env python3
"""Time the Hopper flash-attention kernel of this tree (``flash_fwd_hopper``
in ``src/repro_torch/csrc/flash_attention.cu``) against two other
schedules of the same kernel, in turns on one card:

* ``same_order``: the persistent grid walks the work items in the same
  order every round instead of the snake order;
* ``block_per_item``: one block for each (query tile, head, batch) item
  instead of one block per SM.

Each is the source with one line replaced; the arithmetic is the same, so
the outputs must equal this tree's bit for bit.  Shapes (bf16): llama's
training shape (B 2, S 1024, 32 heads over 8, D 128, causal),
recurrentgemma-9b's prefill shape (B 2, S 3072, 16 over 1, D 256, causal,
window 2048), seamless's width (B 2, S 1024, 16 over 16, D 64, causal),
llama's heads without a mask and at a ragged S 1000.

  python3 tools/flash_schedule_ab.py [--rounds 10]

Prints one JSON line per round and a summary with each schedule's median
ms per shape (CUDA events, L2 flushed, as ``chip_smoke.py`` times) and
whether its outputs equal this tree's; needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SNAKE = "(r & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x)"
GRID = "const int blocks = static_cast<int>(items < sms ? items : sms);"
SCHEDULES = {
    "this": [],
    "same_order": [(SNAKE, "blockIdx.x")],
    "block_per_item": [(GRID, "const int blocks = static_cast<int>(items);")],
}
SHAPES = {
    "train": ((2, 1024, 1024, 32, 8, 128), dict(causal=True)),
    "hybrid": ((2, 3072, 3072, 16, 1, 256), dict(causal=True, window=2048)),
    "d64": ((2, 1024, 1024, 16, 16, 64), dict(causal=True)),
    "noncausal": ((2, 1024, 1024, 32, 8, 128), dict(causal=False)),
    "ragged1000": ((1, 1000, 1000, 32, 8, 128), dict(causal=True)),
}


def _build_schedules() -> dict:
    """One library per schedule, built in parallel into build/schedule_ab."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out_dir = os.path.join(ROOT, "build", "schedule_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in SCHEDULES.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the line {old!r} is not in the "
                                   "source exactly once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_schedule_ab: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import Timer, nvidia_smi
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    libs = _build_schedules()
    gen = torch.Generator(device="cuda").manual_seed(99)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def run(name, q, k, v, kw):
        _build._loaded["flash_attention"] = libs[name]
        return flash_attention_cuda(q, k, v, **kw)

    inputs = {s: (rnd((B, Sq, Hq, D)), rnd((B, Sk, Hkv, D)),
                  rnd((B, Sk, Hkv, D)), kw)
              for s, ((B, Sq, Sk, Hq, Hkv, D), kw) in SHAPES.items()}
    ref = {s: run("this", *a) for s, a in inputs.items()}
    timer = Timer(iters=30)
    names = list(SCHEDULES)
    times = {n: {s: [] for s in SHAPES} for n in names}
    equal = dict.fromkeys(names, True)
    for r in range(args.rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        if r % 2:
            order = order[::-1]
        for n in order:
            for s, a in inputs.items():
                equal[n] &= bool(torch.equal(run(n, *a), ref[s]))
                times[n][s].append(timer(lambda: run(n, *a)))
        print(json.dumps({"round": r, "order": order,
                          "ms": {n: {s: t[-1] for s, t in times[n].items()}
                                 for n in names}}), flush=True)
    print(json.dumps({"flash_schedule_ab": {
        "card": nvidia_smi(), "rounds": args.rounds,
        "median_ms": {n: {s: statistics.median(t) for s, t in d.items()}
                      for n, d in times.items()},
        "outputs_equal_this": equal}}), flush=True)
    _build._loaded.pop("flash_attention", None)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
