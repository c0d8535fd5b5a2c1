#!/usr/bin/env python3
"""Time the attention kernels of this tree against those of another tree
on one card, in turns (other, this, this, other, ...): the decode kernels
at the llama3.2-3b serve shape (B 4 slots, 32 padded heads over 8 KV
heads, D 128, bf16, lengths 216/20/12/9), flash at llama's training shape
(B 2, S 1024, 32 heads over 8, D 128, causal, bf16) and flash at
recurrentgemma-9b's prefill shape (B 2, S 3072, 16 heads over 1, D 256,
causal, window 2048, bf16), as ``chip_smoke.py`` times them.

  python3 tools/ab_kernels.py OTHER_ROOT [--rounds 4]

OTHER_ROOT is the root of another checkout (for instance the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists);
its ``src/repro_torch/csrc`` must keep the C entry points of this tree,
except that a flash library without the wgmma entry
(``flash_attention_fwd_wgmma``, before it existed) is called through its
one entry ``flash_attention_fwd``.  Both libraries are built with this
tree's flags and called through this tree's wrappers; the registers of
the kernel entries these shapes launch are printed for both.  Prints one
JSON line per round and a summary line with the medians and, for each
kernel, whether the two trees' outputs are equal and whether they are
within the bf16 tolerance of each other (3e-2, as ``chip_smoke.py``);
needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _build_tree(root: str, name: str, tag: str):
    """Build ``csrc/<name>.cu`` of the tree at ``root`` with this tree's
    flags; returns (library, {kernel entry: registers})."""
    from repro_torch.kernels import _build
    src = os.path.join(root, "src", "repro_torch", "csrc", f"{name}.cu")
    out = os.path.join(ROOT, "build", "ab", f"{name}-{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                         check=True, capture_output=True, text=True)
    regs, entry = {}, None
    for line in (log.stdout + log.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
    return ctypes.CDLL(out), regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import Timer, nvidia_smi
    from repro_torch.kernels import _build, stream_ptr
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda)

    names = ("decode_attention", "paged_attention", "flash_attention")
    built = {tag: {n: _build_tree(root, n, tag) for n in names}
             for tag, root in (("this", ROOT), ("other", args.other))}
    libs = {tag: {n: lib for n, (lib, _) in b.items()}
            for tag, b in built.items()}
    # registers of the entries that the shapes launch
    launched = ("Li128ELi4E", "flash_fwd_bf16ILi128E",
                "flash_fwd_bf16ILi256E", "flash_fwd_hopper",
                "combine_kernelI13")
    print(json.dumps({"registers": {
        tag: {e[-120:]: r for n, (_, regs) in b.items()
              for e, r in regs.items()
              if "bfloat16" in e and any(k in e for k in launched)}
        for tag, b in built.items()}}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    dt = torch.bfloat16

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    B, Hq, Hkv, D, page, maxp = 4, 32, 8, 128, 16, 32
    q = rnd((B, Hq, D))
    k, v = rnd((B, 512, Hkv, D)), rnd((B, 512, Hkv, D))
    kp, vp = rnd((B * maxp, page, Hkv, D)), rnd((B * maxp, page, Hkv, D))
    table = torch.arange(B * maxp, dtype=torch.int32,
                         device="cuda").reshape(B, maxp)
    lengths = torch.tensor([216, 20, 12, 9], dtype=torch.int32,
                           device="cuda")
    fq, fk, fv = rnd((2, 1024, 32, D)), rnd((2, 1024, 8, D)), \
        rnd((2, 1024, 8, D))
    hq, hk, hv = rnd((2, 3072, 16, 256)), rnd((2, 3072, 1, 256)), \
        rnd((2, 3072, 1, 256))

    def flash(lib, q, k, v, **kw):
        """Through this tree's wrapper, or the one entry of a library that
        predates the wgmma entry."""
        if hasattr(lib, "flash_attention_fwd_wgmma"):
            return flash_kernel.flash_attention_cuda(q, k, v, **kw)
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_int] + flash_kernel._SHAPE_ARGS
        out = torch.empty_like(q)
        (B, Sq, Hq, Dq), (Sk, Hkv) = q.shape, k.shape[1:3]
        err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, Dq, int(kw.get("causal", True)),
                 kw.get("window") or 0, 0, Dq ** -0.5, stream_ptr(q.device))
        if err:
            raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")
        return out

    calls = {"decode_attention": lambda lib: decode_attention_cuda(
                 q, k, v, lengths),
             "paged_attention": lambda lib: paged_attention_cuda(
                 q, kp, vp, table, lengths),
             "flash_attention": lambda lib: flash(lib, fq, fk, fv),
             "flash_attention_hybrid": lambda lib: flash(
                 lib, hq, hk, hv, causal=True, window=2048)}
    source = {n: n.replace("_hybrid", "") for n in calls}
    timer = Timer(iters=30)
    times = {tree: {n: [] for n in calls} for tree in libs}
    outs = {}
    order = ["other", "this", "this", "other"]
    for r in range(args.rounds):
        for tree in order if r % 2 == 0 else order[::-1]:
            for n, call in calls.items():
                lib = libs[tree][source[n]]
                _build._loaded[source[n]] = lib
                outs[(tree, n)] = call(lib).float()
                times[tree][n].append(timer(lambda: call(lib)))
        print(json.dumps({"round": r, "ms": {t: {n: times[t][n][-2:]
                                                 for n in calls}
                                             for t in times}}), flush=True)
    same, close = {}, {}
    for n in calls:
        a, b = outs[("this", n)], outs[("other", n)]
        same[n] = bool(torch.equal(a, b))
        close[n] = {"max_abs_diff": float((a - b).abs().max()),
                    "within_3e-2": bool(torch.all(
                        (a - b).abs() <= 3e-2 * (1 + b.abs())))}
    print(json.dumps({"ab_kernels": {
        "card": nvidia_smi(), "rounds": args.rounds,
        "median_ms": {t: {n: statistics.median(times[t][n]) for n in calls}
                      for t in times},
        "outputs_equal": same, "outputs_close": close}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
