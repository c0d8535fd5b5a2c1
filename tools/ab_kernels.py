#!/usr/bin/env python3
"""Time the port's kernels of this tree against those of another tree on
one card, in turns (other, this, this, other, ...), at the shapes
``chip_smoke.py`` times them: the decode kernels at the llama3.2-3b serve
shape (B 4 slots, 32 padded heads over 8 KV heads, D 128, bf16, lengths
216/20/12/9) and at the long shape (B 8, T 4096, lengths 4096..1), paged
also at ``long_b32`` (32 slots of 512..8192 tokens, page 16), decode at
recurrentgemma-9b's decode shape (B 2, a full
2048-slot ring, 16 heads over 1 KV head, D 256, bf16), flash at llama's
training shape (B 2, S 1024, 32 heads over 8, D 128, causal, bf16) and at
recurrentgemma-9b's prefill shape (B 2, S 3072, 16 heads over 1, D 256,
causal, window 2048, bf16), fp32 flash at the training shape, at 16
heads over 16 with D 64 and at recurrentgemma-9b's prefill shape, the SSD
scan at mamba2-130m's prefill and training shapes (B 4 and 8, S 2048, 24
heads, P 64, N 128, chunk 256, bf16 x, B and C), and the RG-LRU scan at
recurrentgemma-9b's prefill shapes (B 2, S 3072, W 4096 in fp32 and
bf16; B 1, S 1000 in fp32).

  python3 tools/ab_kernels.py OTHER_ROOT [--rounds 4]

OTHER_ROOT is the root of another checkout (for instance the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists);
its ``src/repro_torch/csrc`` must keep the C entry points of this tree,
except that a flash library without the wgmma entry
(``flash_attention_fwd_wgmma``, before it existed) is called through its
one entry ``flash_attention_fwd``, and that the RG-LRU scan is called
through each tree's own wrapper (``kernels/rglru_scan/kernel.py``), whose
C entry changed.  Both libraries are built with this tree's flags and
called through this tree's wrappers, each decode kernel under its own
tree's split plan (``decode_plan`` in its ``kernels/__init__.py``, or the
older ``split_plan(device, B x Hkv, cap)``); the registers of the kernel
entries these shapes launch are printed for both.  Each time is of the
wrapper call alone (outputs are joined only for the comparison).  Prints
one JSON line per round and a summary line with the medians, how many
rounds this tree was faster in, and, for each kernel, whether the two trees' outputs are equal (bit for bit) and their
largest difference, within the bf16 tolerance of each other or not (3e-2,
as ``chip_smoke.py``); needs a CUDA card and ``nvcc``.
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


def _module_of(root: str, rel: str):
    """The module ``src/repro_torch/<rel>`` of the tree at ``root``, loaded
    from its file (its imports resolve in this tree's package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_{rel.replace('/', '_')[:-3]}_{abs(hash(root))}",
        os.path.join(root, "src", "repro_torch", rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plan_of(root: str):
    """The decode split plan of the tree at ``root``, as its wrappers call
    it: ``(device, dtype, B, Hkv, G, D, cap) -> (split_len, n_splits)``."""
    mod = _module_of(root, "kernels/__init__.py")
    if hasattr(mod, "decode_plan"):
        return mod.decode_plan
    return lambda device, dtype, B, Hkv, G, D, cap: mod.split_plan(
        device, B * Hkv, cap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import Timer, _long_b32_lengths, _ssd_inputs, nvidia_smi
    from repro_torch.kernels import _build, stream_ptr
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    names = ("decode_attention", "paged_attention", "flash_attention",
             "ssd_scan", "rglru_scan")
    roots = {"this": ROOT, "other": args.other}
    built = {tag: {n: _build_tree(root, n, tag) for n in names}
             for tag, root in roots.items()}
    libs = {tag: {n: lib for n, (lib, _) in b.items()}
            for tag, b in built.items()}
    plans = {tag: _plan_of(root) for tag, root in roots.items()}
    scans = {tag: _module_of(root, "kernels/rglru_scan/kernel.py")
             for tag, root in roots.items()}
    # registers of the entries that the shapes launch
    launched = ("Li128ELi4E", "Li256ELi4E", "flash_fwd_bf16ILi128E",
                "flash_fwd_bf16ILi256E", "flash_fwd_hopper",
                "combine_kernelI13", "split_mmaILi256E", "merge_kernelI13",
                "decode_fused_mmaILi128E",
                "ssd_", "Li64ELi128E")
    launched_any = ("flash_fwd_f32ILi64E", "flash_fwd_f32ILi128E",
                    "flash_fwd_f32ILi256E", "rglru_stream", "chunk_")
    print(json.dumps({"registers": {
        tag: {e[-120:]: r for n, (_, regs) in b.items()
              for e, r in regs.items()
              if (("bfloat16" in e or "ssd_" in e)
                  and any(k in e for k in launched))
              or any(k in e for k in launched_any)}
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
    # the long shape (contiguous and paged) and long_b32 (paged)
    lk, lv = rnd((8, 4096, Hkv, D)), rnd((8, 4096, Hkv, D))
    lq = rnd((8, Hq, D))
    long_lengths = torch.tensor([4096, 3000, 2049, 1500, 777, 300, 64, 1],
                                dtype=torch.int32, device="cuda")
    long_table = torch.arange(8 * 256, dtype=torch.int32,
                              device="cuda").reshape(8, 256)
    bq = rnd((32, Hq, D))
    bkp, bvp = rnd((32 * 512, page, Hkv, D)), rnd((32 * 512, page, Hkv, D))
    b_table = torch.randperm(32 * 512, generator=gen, device="cuda").to(
        torch.int32).reshape(32, 512)
    b_lengths = torch.tensor(_long_b32_lengths(), dtype=torch.int32,
                             device="cuda")
    fq, fk, fv = rnd((2, 1024, 32, D)), rnd((2, 1024, 8, D)), \
        rnd((2, 1024, 8, D))
    hq, hk, hv = rnd((2, 3072, 16, 256)), rnd((2, 3072, 1, 256)), \
        rnd((2, 3072, 1, 256))
    dq, dk, dv = rnd((2, 16, 256)), rnd((2, 2048, 1, 256)), \
        rnd((2, 2048, 1, 256))
    ring = torch.tensor([2048, 2048], dtype=torch.int32, device="cuda")
    ssd_in = {n: _ssd_inputs(gen, b, 2048, 24, 64, 128, dt, dt)
              for n, b in (("prefill", 4), ("train", 8))}
    f32 = {n: [torch.randn(shape, generator=gen, device="cuda")
               for shape in shapes]
           for n, shapes in (
               ("train", ((2, 1024, 32, 128), (2, 1024, 8, 128),
                          (2, 1024, 8, 128))),
               ("d64", ((2, 1024, 16, 64), (2, 1024, 16, 64),
                        (2, 1024, 16, 64))),
               ("hybrid", ((2, 3072, 16, 256), (2, 3072, 1, 256),
                           (2, 3072, 1, 256))))}
    scan_in = {n: (torch.sigmoid(torch.randn(shape, generator=gen,
                                             device="cuda")).to(sdt),
                   torch.randn(shape, generator=gen, device="cuda").to(sdt))
               for n, shape, sdt in (
                   ("f32", (2, 3072, 4096), torch.float32),
                   ("bf16", (2, 3072, 4096), torch.bfloat16),
                   ("f32_s1000", (1, 1000, 4096), torch.float32))}
    tree_now = {"tag": "this"}

    def scan(case):
        """(h, h_last) through the tree's own wrapper."""
        return scans[tree_now["tag"]].linear_scan_cuda(*scan_in[case])

    def flash(lib, q, k, v, **kw):
        """Through this tree's wrapper, or the one entry of a library that
        predates the wgmma entry."""
        if hasattr(lib, "flash_attention_fwd_wgmma"):
            return flash_kernel.flash_attention_cuda(q, k, v, **kw)
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_int] + flash_kernel._SHAPE_ARGS
        out = torch.empty_like(q)
        (B, Sq, Hq, Dq), (Sk, Hkv) = q.shape, k.shape[1:3]
        err = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, Dq, int(kw.get("causal", True)),
                 kw.get("window") or 0, 0, Dq ** -0.5, stream_ptr(q.device))
        if err:
            raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")
        return out

    def ssd(case):
        """y and the final state of the scan."""
        return ssd_scan_cuda(*ssd_in[case], chunk=256)

    calls = {"decode_attention": lambda lib: decode_kernel.
             decode_attention_cuda(q, k, v, lengths),
             "decode_attention_hybrid": lambda lib: decode_kernel.
             decode_attention_cuda(dq, dk, dv, ring),
             "decode_attention_long": lambda lib: decode_kernel.
             decode_attention_cuda(lq, lk, lv, long_lengths),
             "paged_attention": lambda lib: paged_kernel.paged_attention_cuda(
                 q, kp, vp, table, lengths),
             "paged_attention_long": lambda lib: paged_kernel.
             paged_attention_cuda(lq, lk.reshape(8 * 256, page, Hkv, D),
                                  lv.reshape(8 * 256, page, Hkv, D),
                                  long_table, long_lengths),
             "paged_attention_long_b32": lambda lib: paged_kernel.
             paged_attention_cuda(bq, bkp, bvp, b_table, b_lengths),
             "flash_attention": lambda lib: flash(lib, fq, fk, fv),
             "flash_attention_hybrid": lambda lib: flash(
                 lib, hq, hk, hv, causal=True, window=2048),
             "flash_attention_f32": lambda lib: flash(lib, *f32["train"]),
             "flash_attention_f32_d64": lambda lib: flash(lib, *f32["d64"]),
             "flash_attention_f32_hybrid": lambda lib: flash(
                 lib, *f32["hybrid"], causal=True, window=2048),
             "ssd_scan_prefill": lambda lib: ssd("prefill"),
             "ssd_scan_train": lambda lib: ssd("train"),
             "rglru_scan_f32": lambda lib: scan("f32"),
             "rglru_scan_bf16": lambda lib: scan("bf16"),
             "rglru_scan_f32_s1000": lambda lib: scan("f32_s1000")}
    source = {n: next(s for s in names if n.startswith(s)) for n in calls}
    timer = Timer(iters=30)
    times = {tree: {n: [] for n in calls} for tree in libs}
    outs = {}
    order = ["other", "this", "this", "other"]
    for r in range(args.rounds):
        for tree in order if r % 2 == 0 else order[::-1]:
            decode_kernel.decode_plan = paged_kernel.decode_plan = \
                plans[tree]
            tree_now["tag"] = tree
            for n, call in calls.items():
                lib = libs[tree][source[n]]
                _build._loaded[source[n]] = lib
                out = call(lib)   # a tensor, or a tuple of them
                outs[(tree, n)] = torch.cat([
                    t.flatten().float()
                    for t in (out if isinstance(out, tuple) else (out,))])
                times[tree][n].append(timer(lambda: call(lib)))
        print(json.dumps({"round": r, "ms": {t: {n: times[t][n][-2:]
                                                 for n in calls}
                                             for t in times}}), flush=True)
    same, close, wins = {}, {}, {}
    for n in calls:
        a, b = outs[("this", n)], outs[("other", n)]
        same[n] = bool(torch.equal(a, b))
        close[n] = {"max_abs_diff": float((a - b).abs().max()),
                    "within_3e-2": bool(torch.all(
                        (a - b).abs() <= 3e-2 * (1 + b.abs())))}
        # pairs of one round: this tree's and the other's times in turn
        wins[n] = sum(t < o for t, o in zip(times["this"][n],
                                             times["other"][n]))
    print(json.dumps({"ab_kernels": {
        "card": nvidia_smi(), "rounds": args.rounds,
        "median_ms": {t: {n: statistics.median(times[t][n]) for n in calls}
                      for t in times},
        "this_faster_pairs": {n: [w, len(times["this"][n])]
                              for n, w in wins.items()},
        "outputs_equal": same, "outputs_close": close}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
