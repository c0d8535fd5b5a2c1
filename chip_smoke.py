#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

  python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, all started together) and runs, in order:

1. the environment line (``nvidia-smi`` name and power limit, torch and CUDA
   versions, kernel build time);
2. ``kernels``: each decode kernel against its plain PyTorch version and
   against its split twin under the kernel's own plan on the card, in fp32
   and bf16, at the serving engine's full-width shapes, at the long shape
   (8 rows up to 4096 tokens), at ``long_b32`` (32 slots of 512..8192
   tokens, ~1.1 GB of bf16 K/V), at qwen2.5-14b's grouping (48 padded
   heads over 8, G=6, D=128: rows 0..5 of the 16-row mma tile) and at
   edge cases (page size 8, G=2/D=16, G=16/D=256 paged, a window, FAIL
   page ids), with kernel,
   plain and library (SDPA on pre-gathered KV, timed only) times beside
   the memory bound (the kernel also after an L2 flush that leaves clean
   lines, ``kernel_ms_clean_l2``; see ``Timer``; ``timer_floor_ms`` is a
   one-element fill timed the same ways); then ``decode_reuse``: the
   one-launch kernels 60 calls back to back with lengths and windows
   changing every call (rows of length 0 and below, single-split and
   multi-split rows), every output against the plain version and the
   arrival counters all zero afterwards; and
   ``decode_launches_per_call``: ``torch.profiler`` sees exactly one
   device kernel (``decode_fused_mma`` or ``decode_fused``) a call, and
   ``rglru_launches_per_call``: one device kernel (``rglru_stream``) a
   call of the RG-LRU scan at recurrentgemma's prefill shape;
3. ``serve``: llama3.2-3b at full width and depth (28 layers, bf16, random
   weights from a seed) behind ``ServingEngine(batch_slots=4,
   page_size=16, max_len=512)``, then the contiguous-cache decode
   (``Model.decode_step``) teacher-forced on the first four requests and
   held to the engine's logits and argmax; then the same traffic again on
   a fresh engine, with ``torch.profiler`` over a window of ticks in which
   all four slots are busy (device busy share, kernels per tick, the top
   device kernels and host operators);
4. ``identity``: fp32, full width, 4 layers; the engine's greedy streams
   must equal the contiguous decode's token for token;
5. ``flash``: the flash kernel against its plain version, fp32 and bf16, at
   the training shape (B 2, S 1024, 32 heads over 8 KV heads, D 128,
   causal), a ragged shape (Sq = Sk = 1000), a window of 128, a q_offset
   with Sq < Sk, G = 1 with D = 16 (bf16: the mma.sync variant) and
   seamless's width (16 heads over 16, D 64); bf16 rows that see no key
   (``blind_rows_d*``, the wgmma variant at D 64, 128 and 256 against
   its tiled plain twin), and fp32 ones (the CUDA-core variant at D 64,
   128 and 256 against its twin at its own tiles); the q/k/v gradients
   through the op against autograd through the plain version at the
   training shape; kernel (also ``kernel_ms_clean_l2``), plain and SDPA
   (timed only) times beside the flops bound at the training and D 64
   shapes, where the fp32 kernel must beat SDPA;
6. ``prefill``: fp32, full width, 4 layers, TF32 off: the logits of
   ``Model.forward`` against the contiguous ``decode_step`` teacher-forced
   over the same prompt (every position within 1e-3, the same argmax),
   and ``Model.prefill`` followed by 8 greedy decode steps against pure
   decode (the same stream); the serve phase adds the bf16 full-depth
   forward-vs-decode difference, printed without a gate;
7. ``train``: ``launch/train.run`` trains llama3.2-3b at full width and
   depth (28 layers, bf16, remat "full", batch 2 x 1024 tokens from
   ``SyntheticLM``) for 4 steps through ``device_run`` with one immediate
   hook that logs the loss through the RPC channel: losses, ms/step,
   tokens/s, train_mfu, the flash kernel's launches (all of the bf16
   wgmma variant), ``rpc_post``'s (one a firing) and the peak device
   memory;
8. ``train_profile``: outside the counted path, one llama step timed in
   halves (forward + backward, AdamW) and one under ``torch.profiler``
   (device time by kernel kind, top kernels);
9. ``ssd_kernel``: the SSD scan kernel against its plain version, fp32 and
   bf16, y and the final state, at mamba2's prefill shape (B 4, S 2048,
   24 heads, P 64, N 128, chunk 256), at its training shape (B 8), at
   S = 1000 through the op (padded), at S = 100 (chunk = S) and at the
   shapes of tests/test_kernels.py; the bf16 tensor-core path also
   against its rounding twin; kernel and plain times beside the bound at
   the prefill and training shapes (no single PyTorch call computes SSD,
   so no library time);
10. ``ssm_serve``: mamba2-130m at full width and depth (24 layers, bf16,
    random weights from a seed), served through ``Model.prefill`` and
    greedy ``Model.decode_step`` (the ssm family's serving path): one
    batch of 4 prompts x 2048 tokens and 64 steps, then one 1000-token
    prompt and 16 steps; prefill ms and tokens/s, decode ms/step and
    tok/s, ssd_scan launches (24 per prefill); then ``torch.profiler``
    over 8 decode steps at batch 4 and over the 1000-token prefill
    (``ssm_profile`` lines: host and device time, kernels, top operators);
    then the bf16 full-depth forward-vs-decode difference, printed
    without a gate;
11. ``ssm_prefill``: fp32, full width, 4 layers, TF32 off: mamba2's
    ``Model.forward`` logits against the teacher-forced ``decode_step``
    over 300 tokens (within 1e-3, the same argmax), and ``Model.prefill``
    plus 8 greedy steps against pure decode (the same stream);
12. ``ssm_train``: ``launch/train.run("mamba2-130m", preset="full")`` for
    4 steps of batch 8 x 2048 through ``device_run``: losses (finite;
    whether they fall), ms/step, tokens/s, ssd_scan launches (48 a step:
    forward and remat recompute), peak memory;
13. ``ssm_train_profile``: phase 8 for the mamba2 step;
14. ``rglru_scan``: the RG-LRU scan kernel against its plain version, fp32
    and bf16, h and h_last, bit for bit against its twin in the kernel's
    chunk order and (fp32) within 2e-6 of the step-by-step recurrence, at
    recurrentgemma-9b's prefill shapes (B 2, S 3072, W 4096; B 1, S 1000)
    and at the shapes of tests/test_kernels.py; kernel (also
    ``kernel_ms_clean_l2``) and plain times at both prefill shapes beside
    the bytes bound (no single PyTorch call computes the recurrence);
    ``rglru_reuse``: 60 calls back to back over six shapes and dtypes,
    each output bit-equal to the first call's on the same inputs;
15. ``hybrid_*`` kernel lines: flash at head_dim 256 (16 heads over 1 KV
    head, causal, window 2048; B 2 x S 3072, 1 x 1000, and 777 queries at
    q_offset 1023 over 1800 keys) and decode at
    G = 16, D = 256 (a full 2048-slot ring, and ragged lengths), each
    against its plain version in fp32 and bf16 (decode also against its
    split twin under the kernel's own plan), with SDPA under the same
    mask timed beside them (flash also ``kernel_ms_clean_l2``; in fp32 it
    must beat SDPA and the plain version at the serve shape);
16. ``hybrid_serve``: recurrentgemma-9b at full width and depth (38
    layers, 26 RG-LRU and 12 local attention, bf16, random weights from a
    seed) through ``Model.prefill`` and greedy ``Model.decode_step``: 2
    prompts x 3072 tokens with max_len 4096 and 32 steps, then 1 x 1000
    and 16 steps; prefill ms and tokens/s, decode ms/step and tok/s, peak
    memory, and the exact launches (rglru_scan 26 and flash 12 a prefill,
    all of flash's of the wgmma variant, decode 12 a step); then
    ``hybrid_profile`` (decode and the 1000-token prefill under
    ``torch.profiler``) and the bf16 full-depth forward-vs-decode
    difference, printed without a gate;
17. ``hybrid_prefill``: fp32, full width, 3 layers, TF32 off:
    ``Model.forward`` over 2064 tokens against ``Model.prefill`` of 2040
    and 24 teacher-forced decode steps that wrap the 2048-slot ring
    (within 1e-3, the same argmax), and prefill plus 8 greedy steps
    against pure decode (the same stream);
18. ``rpc``: the host RPC channel (``csrc/rpc_channel.cu``, the
    ``rpc_post`` kernel) on the four cases of tests/test_core.py and a
    bf16 ref, each call bit-equal to the host-synchronous version
    (``rpc_call_reference``) on the same inputs, one launch a call;
19. ``rpc_gil``: a posted call whose callee sleeps, followed at once by
    ``.item()``, ``.cpu()``, ``torch.cuda.synchronize()``,
    ``Event.synchronize()`` and 4096 launches, each under a 60 s
    ``faulthandler`` watchdog (a deadlock ends the run, it never hangs);
20. ``rpc_time``: the empty round trip (CUDA events, median of 200; the
    kernel's wait and the host thread's time beside it) and READWRITE refs
    of 4 KB, 1 MB and 64 MB against the host link's rate
    (``nvidia-smi`` PCIe generation and width), each beside the
    host-synchronous version's wall time;
21. ``rpc_queue``: the batched queue's ``rpc_enqueue`` kernel
    (``csrc/rpc_queue.cu``) against its plain version on the card and a
    CPU queue, three seeded plans of 250 records (ring overwrite, arena
    and reply-arena drops, device ``where``, int/fp32/bf16 scalars and
    payloads) under ``set_sync_debug_mode("error")``: the queue state
    bit-equal before each flush, the flush's replay log, replies,
    statuses and heads bit-equal to the CPU queue's, one ``rpc_enqueue``
    a record and one ``rpc_post`` a flush;
22. ``rpc_queue_faults``: seeded ``FaultPlan``s with a 0.1 s timeout,
    with and without ``RetryPolicy(max_attempts=3)``: statuses, replies
    and error-log attributions on the card equal the CPU's;
23. ``rpc_queue_time``: host and device us per ``rpc_enqueue`` and per
    plain enqueue (behind a device sleep that hides the host) for a
    scalar record at W 4, a 1 KB and a 64 KB payload, beside the bytes
    bound; the flush of a full 1024-record ring (events, host, the
    drain's Python) beside the link's bound;
24. ``libc_io``: ``fprintf``, ``fwrite``, ``fgets``, ``fread``, remote
    malloc and ``LogRing`` on a card queue equal to a CPU queue (11
    ``rpc_enqueue`` launches, 2 ``rpc_post``);
25. ``device_run_hooks``: 1000 steps with a hook every 100 steps, then
    every step, then every 100 steps of a 64M-float state, then a
    batched hook every step and a returning hook every 100 steps, under
    ``set_sync_debug_mode("error")``: exactly one host call and one
    ``rpc_post`` a firing of an immediate hook, one ``rpc_enqueue`` a
    firing and one host call in all for the batched hook, 11 for the
    returning one, values in order, the final state exact, the Python
    loop's wall time against the device time;
26. ``gpu_first``: ``examples/gpu_first_port_torch.py``'s program at its
    own size and at XSBench's "small" geometry (68 nuclides x 11,303
    points, 2**20 lookups; ``serial_for`` on the first 2048):
    ``serial_for``, ``parallel_for`` (vmap's fallback warning an error)
    and the manual port within rtol 1e-5, ``write_results`` through the
    channel, times and verdict; then the allocator ops under
    ``set_sync_debug_mode("error")``, bit-equal to the CPU's.

Between ``identity`` and ``flash`` runs
``dense_serve``: qwen2.5-14b at full width and depth (48 layers, 40
heads padded to 48 over 8 KV heads of 128, QKV bias, bf16, ~15.3e9
random parameters from seed 0 built on the card) through the engine as
``serve`` runs llama: ms/tick, tok/s, init time, peak memory, the
logits gate against the teacher-forced contiguous decode and exact
launches (paged 48 a tick, decode 48 a step), and ``dense_profile`` (8
busy ticks under ``torch.profiler``).  Between
``device_run_hooks`` and ``gpu_first`` run:
``rpc_queue_async``: ``rpc_queue``'s three plans on async queues
(``carry_budget`` 2, a flaky idempotent callee) on the card (the
``rpc_async_post`` and ``rpc_async_collect`` kernels of
``csrc/rpc_async.cu``, under ``set_sync_debug_mode("error")``), through
the kernels' plain versions on the card, and on a CPU queue: the queue
state bit-equal after every flush, the replay logs, statuses, replies,
carry outcomes and ``flush_stats`` equal after the last join, one launch
of each kernel a flush; ``rpc_async_time``: each kernel alone (CUDA
events behind a device sleep) beside its plain version and the bytes
bound, and a deadline overrun on the card (TIMEOUT stamped by the
device, the late drain abandoned) equal to a CPU queue;
``device_run_async``: 1000 steps with a batched hook every step, then
a 64M-float state whose step flushes the threaded queue every 100
steps, each with the sync and the async queue under
``set_sync_debug_mode("error")`` (loop and device ms side by side); and
``host_pipeline``: ``device_run`` over 16 batches fetched through
``make_host_pipeline`` (one ``rpc_post`` a fetch).  Inside ``serve``,
on its model, runs ``serve_spill``: the same traffic through an engine
with a page-spill sink on its async queue (streams equal to ``serve``'s,
each spill's pages the page-table prefix and its ``n_tokens`` prompt +
generated - 1, acks the page counts, exact launches; a flaky and a dead
sink on five short requests; ms/tick and tok/s beside an engine without
a sink).  After ``host_pipeline`` run ``sanitizer`` (``rpc_queue``'s
plans on sanitized sync and async queues: the arena bit-equal to
``enqueue_reference``'s after every enqueue, deliveries, replies and
statuses equal to unsanitized and CPU runs, the epoch records equal to
the CPU's; three seeded faults counted once each; sanitized against
plain enqueue times and the pre-check's host time), ``allocators``
(size-class churns at ``cap`` 4096 and 65536 on a 2**24-word heap, the
page heap's grid and scan paths, a 4-shard heap stacked on the card:
bit-equal to the CPU with no device read; each operation's host and
device us) and ``events`` (the card's event kinds and counts equal the
CPU's, nothing waiting for the device).

Every phase raises on failure.  The kernels' launch counts are reset just
before each counted path (phases 3, 7, 10, 12, 16, 21, 24, 25 and 26,
``dense_serve``, ``rpc_queue_async``, ``device_run_async``,
``host_pipeline``, ``serve_spill`` and ``sanitizer``) and read just after it; each path's count must be the exact number its depth
and steps give (``rpc_post``: one a firing of a hook, a call or a flush;
``rpc_enqueue``: one a record; ``rpc_async_post`` and
``rpc_async_collect``: one each an async flush).
The ``env`` line carries each source's ``ptxas -v`` summary (registers and
spills), under ``tensor_cores``, for each head dim of flash's wgmma
variant, the tensor-core decode (G > 8) and its merge, and the SSD
tensor-core kernels: registers, spills, shared memory and HMMA / HGMMA
counts in their SASS; under ``decode_fused`` the one-launch decode
kernels' registers, spills and shared memory at D 128; and under
``cuda_cores`` those of ``flash_fwd_f32`` at every head dim and of
``rglru_stream`` at the chunk lengths the timed shapes take (none may
spill).  The last lines
are the ``kernels`` line (with the launches of each path, for flash and
decode their numbers at the hybrid shapes and for the SSD scan at the
training shape),
the ``nvidia-smi`` line and ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits with code 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, data sheet
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# The RG-LRU kernel against the fp32 step-by-step recurrence: its chunk
# boundaries fold (A, H) aggregates, which round apart from the walk.
SEQ_TOL = 2e-6
LOGIT_ATOL_BF16 = 0.05           # engine vs contiguous decode, bf16 logits
LOGIT_ATOL_FP32 = 1e-3           # forward vs contiguous decode, fp32 logits
SERVE_LAYERS = 28
DENSE_LAYERS = 48                # qwen2.5-14b, the dense_serve phase
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 1024
SSM_LAYERS = 24
SSM_TRAIN_STEPS, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 4, 8, 2048
HYBRID_LAYERS, HYBRID_REC, HYBRID_ATTN = 38, 26, 12
HYBRID_MAX_LEN = 4096
# (name, batch, prompt tokens, greedy steps) of the hybrid serve phase
HYBRID_RUNS = (("batch2_3072", 2, 3072, 32), ("single_1000", 1, 1000, 16))
# The fp32 SSD kernel at mamba2's prefill shape, against a float64 plain
# version: within this multiple of the fp32 plain version's own distance
# from float64.  Both distances come from fp32 rounding (the chunk cumsum
# of dt * A among it), whose size depends on the order of the sums, not on
# the kernel's correctness; 4x leaves room for another order.
SSD_FP64_MULT = 4.0


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def reset_launches(*fns) -> None:
    """Set each wrapper's launch counts to 0 (flash's per variant too)."""
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_by_variant"):
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def sync_errors():
    """``torch.cuda.set_sync_debug_mode("error")`` for the block: an
    operation that waits for the device raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of ``fn`` in ms: CUDA events around each call, with
    the 50 MB L2 flushed before each call (the engine reaches each layer's
    attention after streaming that layer's weights, so its KV is cold).
    The flush writes 512 MB, which keeps the card busy for longer than the
    host needs to enqueue the call, so the events time the device work and
    not the host's launch overhead.  The median drops the rare call that
    the host reaches late (after the flush has drained), whose events would
    also time the host.

    ``flush="read"`` flushes by reading the 512 MB instead.  The write
    flush leaves L2 full of dirty lines, whose write-back the timed
    kernel's first ~50 MB of reads pay; the read flush leaves clean lines,
    as the engine's weight reads before attention do."""

    def __init__(self, iters=30, flush="write"):
        self.iters = iters
        self.flush = torch.zeros(512 << 20, dtype=torch.uint8, device="cuda")
        words = self.flush.view(torch.float32)
        self.flush_fn = self.flush.zero_ if flush == "write" else words.amax

    def __call__(self, fn) -> float:
        for _ in range(3):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(self.iters)]
        for a, b in ev:
            self.flush_fn()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in ev)
        return times[len(times) // 2]


def _bound(dtype_name, es, B, Hq, Hkv, D, kv_tokens, extra_bytes):
    """Least time for the work: each input read once, each output written
    once (q, out, the K/V rows this run's lengths need, lengths, page ids),
    against the flops of QK and PV at the dtype's peak."""
    bytes_ = 2 * B * Hq * D * es + 2 * kv_tokens * Hkv * D * es \
        + 4 * B + extra_bytes
    flops = 4 * kv_tokens * Hq * D
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _valid_tokens(lengths, cap, window):
    total = 0
    for n in lengths:
        hi = min(n, cap)
        lo = max(n - window, 0) if window else 0
        total += max(hi - lo, 0)
    return total


def _close(out, ref, dtn):
    """(largest difference, within TOL[dtn] x (1 + |ref|) and finite)."""
    e = (out.float() - ref.float()).abs()
    return float(e.max()), bool(
        torch.all(e <= TOL[dtn] * (1 + ref.float().abs()))
        and torch.isfinite(out).all())


def _long_b32_lengths():
    """32 slot lengths in 512..8192, drawn from a seed."""
    gen = torch.Generator().manual_seed(3232)
    return torch.randint(512, 8193, (32,), generator=gen).tolist()


def kernel_phase(card):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_plan
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference, decode_attention_split_reference)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda)
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    timer, clean = Timer(), Timer(flush="read")
    # the Timer's floor: a one-element fill between the same events
    tiny = torch.zeros(1, device="cuda")
    log({"timer_floor_ms": {"write_flush": timer(tiny.zero_),
                            "read_flush": clean(tiny.zero_), "card": card}})
    serve_lengths = [216, 20, 12, 9]
    long_lengths = [4096, 3000, 2049, 1500, 777, 300, 64, 1]
    b32_lengths = _long_b32_lengths()
    summary = {}

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def sdpa_ms(q, k, v, lengths, window):
        """SDPA on K/V already gathered to (B, Hkv, T, D): the yardstick."""
        B, Hq, D = q.shape
        T = k.shape[2]
        t = torch.arange(T, device="cuda")[None, :]
        mask = t < lengths[:, None]
        if window:
            mask &= t >= lengths[:, None] - window
        q4, m4 = q[:, :, None, :], mask[:, None, None, :]
        return timer(lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=m4, enable_gqa=True))

    def check(name, case, dt, out, ref, twin, plan, times=None, bound=None):
        """out against the plain version and against the split twin under
        the kernel's own plan, both within the dtype's tolerance."""
        dtn = str(dt).split(".")[-1]
        err, ok = _close(out, ref, dtn)
        terr, tok = _close(out, twin, dtn)
        rec = {"kernel": name, "case": case, "dtype": dtn,
               "split_plan": list(plan), "max_abs_err": err,
               "max_abs_err_vs_split_twin": terr, "tol": TOL[dtn],
               "ok": ok and tok}
        if times:
            rec.update(times)
            rec.update(bound_ms=bound[0], bound_by=bound[1], card=card)
        log(rec)
        if not rec["ok"]:
            raise AssertionError(f"{name} {case} {dtn} disagrees with its "
                                 f"plain version or its split twin: {rec}")
        return rec

    for dt in (torch.float32, torch.bfloat16):
        dtn = str(dt).split(".")[-1]
        es = torch.tensor([], dtype=dt).element_size()
        # -- contiguous decode --------------------------------------------
        for case, (B, T, Hq, Hkv, D, lens, window, timed) in {
            "serve": (4, 512, 32, 8, 128, serve_lengths, None, True),
            "long": (8, 4096, 32, 8, 128, long_lengths, None, True),
            # 32 slots of 512..8192 tokens: 256 (row, KV head) pairs
            "long_b32": (32, 8192, 32, 8, 128, b32_lengths, None, True),
            "window": (4, 512, 32, 8, 128, serve_lengths, 64, False),
            "g2_d16": (3, 256, 4, 2, 16, [256, 85, 7], None, False),
            # qwen2.5-14b's grouping: 48 padded heads over 8 (G 6)
            "g6_d128": (4, 512, 48, 8, 128, serve_lengths, None, True),
        }.items():
            q, k, v = rnd((B, Hq, D), dt), rnd((B, T, Hkv, D), dt), \
                rnd((B, T, Hkv, D), dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = decode_attention_cuda(q, k, v, lengths, window=window)
            ref = decode_attention_reference(q, k, v, lengths, window=window)
            plan = decode_plan(q.device, dt, B, Hkv, Hq // Hkv, D, T)
            twin = decode_attention_split_reference(
                q, k, v, lengths, split_len=plan[0], window=window)
            torch.cuda.synchronize()
            times = bound = None
            if timed:
                kt, vt = k.transpose(1, 2).contiguous(), \
                    v.transpose(1, 2).contiguous()
                times = {
                    "kernel_ms": timer(lambda: decode_attention_cuda(
                        q, k, v, lengths, window=window)),
                    "kernel_ms_clean_l2": clean(lambda: decode_attention_cuda(
                        q, k, v, lengths, window=window)),
                    "plain_ms": timer(lambda: decode_attention_reference(
                        q, k, v, lengths, window=window)),
                    "library_ms": sdpa_ms(q, kt, vt, lengths, window)}
                bound = _bound(dtn, es, B, Hq, Hkv, D,
                               _valid_tokens(lens, T, window), 0)
                del kt, vt
            rec = check("decode_attention", case, dt, out, ref, twin, plan,
                        times, bound)
            if dtn == "bfloat16" and case in ("serve", "g6_d128"):
                summary["decode_attention" + (
                    "" if case == "serve" else "@g6")] = rec
            del q, k, v, out, ref, twin
        # -- paged decode ------------------------------------------------
        for case, (B, page, maxp, Hq, Hkv, D, lens, window, timed) in {
            "serve": (4, 16, 32, 32, 8, 128, serve_lengths, None, True),
            "long": (8, 16, 256, 32, 8, 128, long_lengths, None, True),
            "long_b32": (32, 16, 512, 32, 8, 128, b32_lengths, None, True),
            "page8": (4, 8, 64, 32, 8, 128, [512, 100, 9, 1], None, False),
            "window": (4, 16, 32, 32, 8, 128, serve_lengths, 64, False),
            "g2_d16": (3, 16, 6, 4, 2, 16, [96, 17, 64], None, False),
            # 16 heads over 1 (bf16: the tensor-core split kernel)
            "g16_d256": (2, 16, 128, 16, 1, 256, [2048, 700], None, False),
            # qwen2.5-14b's grouping: 48 padded heads over 8 (G 6)
            "g6_d128": (4, 16, 32, 48, 8, 128, serve_lengths, None, True),
        }.items():
            NP = B * maxp
            q = rnd((B, Hq, D), dt)
            kp, vp = rnd((NP, page, Hkv, D), dt), rnd((NP, page, Hkv, D), dt)
            # the engine's layout: slot b owns pages [b*maxp, (b+1)*maxp),
            # shuffled here; FAIL (-1) ids inside and past the length
            table = torch.stack([b * maxp + torch.randperm(
                maxp, generator=gen, device="cuda") for b in range(B)]
            ).to(torch.int32)
            table[0, -1] = -1
            table[-1, -1] = -1
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = paged_attention_cuda(q, kp, vp, table, lengths,
                                       window=window)
            ref = paged_decode_attention_reference(q, kp, vp, table, lengths,
                                                   window=window)
            plan = decode_plan(q.device, dt, B, Hkv, Hq // Hkv, D, maxp * page)
            safe = table.clamp(0, NP - 1).long()
            twin = decode_attention_split_reference(
                q, kp[safe].reshape(B, maxp * page, Hkv, D),
                vp[safe].reshape(B, maxp * page, Hkv, D), lengths,
                split_len=plan[0], window=window)
            torch.cuda.synchronize()
            times = bound = None
            if timed:
                kg = kp[safe].reshape(B, maxp * page, Hkv, D).transpose(
                    1, 2).contiguous()
                vg = vp[safe].reshape(B, maxp * page, Hkv, D).transpose(
                    1, 2).contiguous()
                times = {
                    "kernel_ms": timer(lambda: paged_attention_cuda(
                        q, kp, vp, table, lengths, window=window)),
                    "kernel_ms_clean_l2": clean(lambda: paged_attention_cuda(
                        q, kp, vp, table, lengths, window=window)),
                    "plain_ms": timer(lambda: paged_decode_attention_reference(
                        q, kp, vp, table, lengths, window=window)),
                    "library_ms": sdpa_ms(q, kg, vg, lengths, window)}
                pages = sum(-(-min(n, maxp * page) // page) for n in lens)
                bound = _bound(dtn, es, B, Hq, Hkv, D,
                               _valid_tokens(lens, maxp * page, window),
                               4 * pages)
                del kg, vg
            rec = check("paged_attention", case, dt, out, ref, twin, plan,
                        times, bound)
            if dtn == "bfloat16" and case in ("serve", "g6_d128"):
                summary["paged_attention" + (
                    "" if case == "serve" else "@g6")] = rec
            del q, kp, vp, out, ref, twin
        torch.cuda.empty_cache()
    del timer, clean
    torch.cuda.empty_cache()
    return summary


def _reuse_lengths(rng, B, cap, split_len, window):
    """B lengths of one call: a row of 0, one below 0, one of 1, one within
    the first split, and the rest anywhere up to cap (past it by less than
    the window's reach when there is none: every row the plain version
    computes alike)."""
    hi = cap + 40 if window is None else cap
    fixed = [0, -3, 1, int(rng.integers(2, split_len + 1))]
    return fixed + [int(x) for x in rng.integers(2, hi + 1, B - len(fixed))]


def decode_reuse_phase():
    """The one-launch decode kernels called back to back, 60 calls each,
    with lengths and windows that change every call: every output against
    the plain version, and the arrival counters all zero afterwards (a
    counter that a call did not reset fails the run).  Rows of length 0 and
    below (no live split), single-split rows, multi-split rows and windows
    (None, 1, 64, 200) all occur; the log line counts them."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda)
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rng = np.random.default_rng(4321)
    calls, windows = 60, (None, 1, 64, 200)
    # (kernel, dtype, B, Hq, Hkv, D, cap); paged with page 16
    cases = [("decode_attention", torch.bfloat16, 8, 32, 8, 128, 512),
             ("paged_attention", torch.bfloat16, 8, 32, 8, 128, 512),
             ("decode_attention", torch.float32, 8, 32, 8, 128, 512),
             ("paged_attention", torch.float32, 8, 32, 8, 128, 512),
             # fp32 at 16 heads over 1, D 256: four head chunks a row
             ("decode_attention", torch.float32, 6, 16, 1, 256, 2048)]
    for name, dt, B, Hq, Hkv, D, cap in cases:
        dtn = str(dt).split(".")[-1]
        q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dt)
        if name == "decode_attention":
            k, v = (torch.randn((B, cap, Hkv, D), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            run = lambda n, w: decode_attention_cuda(q, k, v, n, window=w)
            plain = lambda n, w: decode_attention_reference(q, k, v, n,
                                                            window=w)
        else:
            page, maxp = 16, cap // 16
            kp, vp = (torch.randn((B * maxp, page, Hkv, D), generator=gen,
                                  device="cuda").to(dt) for _ in range(2))
            table = torch.randperm(B * maxp, generator=gen, device="cuda"
                                   ).to(torch.int32).reshape(B, maxp)
            run = lambda n, w: paged_attention_cuda(q, kp, vp, table, n,
                                                    window=w)
            plain = lambda n, w: paged_decode_attention_reference(
                q, kp, vp, table, n, window=w)
        split_len = kernels.decode_plan(q.device, dt, B, Hkv, Hq // Hkv, D,
                                        cap)[0]
        args, live = [], {"none": 0, "one": 0, "several": 0}
        for i in range(calls):
            w = windows[i % len(windows)]
            lens = _reuse_lengths(rng, B, cap, split_len, w)
            for n in lens:
                a = kernels.decode_arrivals(n, cap, w, split_len)
                live["none" if a == 0 else "one" if a == 1
                     else "several"] += 1
            args.append((torch.tensor(lens, dtype=torch.int32,
                                      device="cuda"), w))
        torch.cuda.synchronize()
        outs = [run(n, w) for n, w in args]       # back to back
        torch.cuda.synchronize()
        worst, bad = 0.0, 0
        for (n, w), out in zip(args, outs):
            err, ok = _close(out, plain(n, w), dtn)
            worst, bad = max(worst, err), bad + (not ok)
        dirty = sum(int(torch.count_nonzero(c))
                    for c in kernels._COUNTERS.values())
        rec = {"decode_reuse": {"kernel": name, "dtype": dtn,
                                "shape": [B, Hq, Hkv, D, cap],
                                "split_len": split_len, "calls": calls,
                                "rows_by_live_splits": live,
                                "max_abs_err": worst, "tol": TOL[dtn],
                                "calls_out_of_tol": bad,
                                "nonzero_counters": dirty}}
        log(rec)
        if bad or dirty or not all(live.values()):
            raise AssertionError(f"decode reuse run failed: {rec}")
    torch.cuda.empty_cache()


def decode_launch_phase():
    """torch.profiler over 5 calls of each one-launch path (decode and paged
    at llama's serve shape in bf16 and fp32, fp32 decode at 16 heads over 1
    and D 256): exactly one device kernel a call, decode_fused (fp32) or
    decode_fused_mma (bf16)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda)

    gen = torch.Generator(device="cuda").manual_seed(99)
    lengths = torch.tensor([216, 20, 12, 9], dtype=torch.int32, device="cuda")
    table = torch.arange(4 * 32, dtype=torch.int32, device="cuda").reshape(
        4, 32)
    calls, seen = 5, {}
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((4, 32, 128), generator=gen, device="cuda").to(dt)
        k = torch.randn((4, 512, 8, 128), generator=gen, device="cuda").to(dt)
        pages = k.reshape(4 * 32, 16, 8, 128)
        hq = torch.randn((2, 16, 256), generator=gen, device="cuda").to(dt)
        hk = torch.randn((2, 2048, 1, 256), generator=gen,
                         device="cuda").to(dt)
        paths = {"decode_attention": lambda: decode_attention_cuda(
                     q, k, k, lengths),
                 "paged_attention": lambda: paged_attention_cuda(
                     q, pages, pages, table, lengths)}
        if dt == torch.float32:
            paths["decode_attention_g16_d256"] = lambda: \
                decode_attention_cuda(hq, hk, hk, lengths[:2])
        for name, fn in paths.items():
            fn()                       # the counters exist before the window
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            dev = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            kernels_ = {e.key[:60]: e.count for e in dev}
            key = f"{name}_{str(dt).split('.')[-1]}"
            seen[key] = kernels_
            if sum(kernels_.values()) != calls or not all(
                    "decode_fused" in k_ for k_ in kernels_):
                raise AssertionError(f"{key}: {kernels_} in {calls} calls, "
                                     "not one decode_fused launch a call")
    log({"decode_launches_per_call": {"calls": calls, "device_kernels": seen}})


# ---------------------------------------------------------------------------
# Phase 3: serve llama3.2-3b at full width and depth
# ---------------------------------------------------------------------------

def _prompts(vocab, n_short, long_len, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    long = [int(t) for t in rng.integers(1, vocab, long_len)]
    short = [[int(t) for t in rng.integers(1, vocab, 4 + i % 9)]
             for i in range(n_short)]
    return [long] + short


def _run_recording(engine, check_rids):
    """Run the engine to the end; record, for the requests in
    ``check_rids``, the logits row behind every token they emit."""
    seen = {rid: [] for rid in check_rids}
    ticks = 0
    while engine.queue or any(s.request_id >= 0 for s in engine.slots):
        slots = list(engine.slots)         # refill mutates these in place
        engine.step()
        ticks += 1
        for i, s in enumerate(slots):
            if s.request_id in seen and len(s.out) > len(seen[s.request_id]):
                seen[s.request_id].append(engine.last_logits[i].clone())
    return ticks, {rid: torch.stack(rows) for rid, rows in seen.items()}


def _teacher_forced(model, params, seqs, prompt_lens, n_out, max_len):
    """Contiguous-cache decode of the sequences in one batch; returns per
    sequence the logits at its n_out output positions."""
    B = len(seqs)
    cache = model.init_cache(B, max_len)
    steps = max(len(s) for s in seqs)
    rows = [[] for _ in range(B)]
    for j in range(steps):
        tok = torch.tensor([s[j] if j < len(s) else 0 for s in seqs],
                           device=model.device)
        logits, cache = model.decode_step(params, cache, tok)
        for b in range(B):
            if prompt_lens[b] - 1 <= j < prompt_lens[b] - 1 + n_out:
                rows[b].append(logits[b].clone())
    return [torch.stack(r) for r in rows]


def _engine_serve(tag, cfg, n_short, long_len, seed):
    """``cfg`` at full width and depth (bf16, random weights from seed 0,
    built on the card) behind ``ServingEngine(batch_slots=4,
    page_size=16, max_len=512)``: a ``long_len``-token prompt and
    ``n_short`` short ones, 16 new tokens each.  The counts are reset just
    before the engine runs and read after the contiguous check: paged
    attention exactly once a layer a tick, decode once a layer a step of
    the contiguous decode (``Model.decode_step``) that is teacher-forced on
    the first four requests and held to the engine's logits (within
    ``LOGIT_ATOL_BF16``) and argmax.  Returns (launches, model, params,
    prompts, max_new, max_len, the greedy streams)."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda)
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    layers = cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[{tag}] {cfg.name}: {layers} layers, d_model {cfg.d_model}, "
        f"{cfg.padded_heads} padded heads ({cfg.num_heads} real) over "
        f"{cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, qkv_bias "
        f"{cfg.qkv_bias}, {n_params} parameters ({cfg.param_dtype}), init "
        f"{init_s:.1f}s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    max_new, max_len = 16, 512
    engine = ServingEngine(model, params, batch_slots=4, page_size=16,
                           max_len=max_len, device="cuda")
    prompts = _prompts(cfg.vocab_size, n_short, long_len, seed=seed)
    rids = [engine.submit(p, max_new=max_new) for p in prompts]
    check_rids = rids[:4]                # the four that start at tick 0

    # main path: counts from 0 just before, read just after
    decode_attention_cuda.launches = 0
    paged_attention_cuda.launches = 0
    t0 = time.perf_counter()
    ticks, engine_logits = _run_recording(engine, check_rids)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results = engine.finished
    n_tok = sum(len(v) for v in results.values())
    for rid in rids:
        log(f"[{tag}] request {rid} (prompt {len(prompts[rid])}): "
            f"{results[rid]}")
    log({tag: {"model": cfg.name, "layers": layers, "requests": len(rids),
               "generated_tokens": n_tok, "ticks": ticks, "seconds": dt,
               "tok_per_s": n_tok / dt, "ms_per_tick": dt / ticks * 1e3,
               "init_s": init_s, "parameters": n_params,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}})
    assert len(results) == len(rids)
    assert all(len(results[r]) == max_new for r in rids)
    assert all(0 <= t < cfg.vocab_size for r in rids for t in results[r])

    seqs = [prompts[r] + results[r][:-1] for r in check_rids]
    plen = [len(prompts[r]) for r in check_rids]
    cont = _teacher_forced(model, params, seqs, plen, max_new, max_len)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention_cuda.launches,
                "decode_attention": decode_attention_cuda.launches}
    log({"kernels_main_path": launches, "path": tag,
         "expected_paged": ticks * layers,
         "expected_decode": max(len(s) for s in seqs) * layers})
    if launches["paged_attention"] != ticks * layers:
        raise AssertionError(f"{tag}: paged_attention launched "
                             f"{launches['paged_attention']} times in "
                             f"{ticks} ticks x {layers} layers")
    if launches["decode_attention"] != max(len(s) for s in seqs) * layers:
        raise AssertionError(f"{tag}: decode_attention did not run once per "
                             "layer and step of the contiguous check")

    for rid, c in zip(check_rids, cont):
        e = engine_logits[rid]
        if not (torch.isfinite(e).all() and torch.isfinite(c).all()):
            raise AssertionError(f"{tag} request {rid}: non-finite logits")
        real = slice(0, cfg.vocab_size)
        diff = float((e[:, real] - c[:, real]).abs().max())
        same = torch.equal(e.argmax(-1), c.argmax(-1))
        tokens = e.argmax(-1).tolist() == results[rid]
        log({"contiguous_check": {"path": tag, "request": rid,
                                  "steps": e.shape[0],
                                  "max_abs_logit_diff": diff,
                                  "tol": LOGIT_ATOL_BF16,
                                  "same_argmax": same,
                                  "argmax_is_stream": tokens}})
        if diff > LOGIT_ATOL_BF16 or not same or not tokens:
            raise AssertionError(f"{tag} request {rid}: engine and "
                                 "contiguous decode disagree")
    streams = dict(results)
    del engine, cont, engine_logits
    torch.cuda.empty_cache()
    return launches, model, params, prompts, max_new, max_len, streams


def serve_phase():
    from repro_torch.configs import get_config

    cfg = get_config("llama3.2-3b")
    assert cfg.num_layers == SERVE_LAYERS and cfg.padded_heads == 32
    launches, model, params, prompts, max_new, max_len, streams = \
        _engine_serve("serve", cfg, 8, 200, 7)
    spill = serve_spill_phase(model, params, prompts, max_new, max_len,
                              streams)
    profile_window(model, params, prompts, max_new, max_len)
    tokens = torch.tensor([prompts[0][:64]], device="cuda")
    fwd, dec = _forward_vs_decode(model, params, tokens)
    real = slice(0, cfg.vocab_size)
    log({"forward_vs_decode_bf16": {
        "layers": cfg.num_layers, "positions": tokens.shape[1],
        "max_abs_logit_diff": float((fwd[..., real] - dec[..., real]).abs()
                                    .max()),
        "same_argmax_share": float((fwd.argmax(-1) == dec.argmax(-1))
                                   .float().mean())}})
    del params, model, fwd, dec
    torch.cuda.empty_cache()
    return launches, spill


def dense_serve_phase():
    """qwen2.5-14b at full width and depth on one card: 48 layers, d_model
    5120, 40 query heads padded to 48 over 8 KV heads of 128 (G 6), QKV
    bias, bf16, random weights from seed 0 built on the card, through the
    engine as ``serve`` runs llama (9 prompts, one of 200 tokens, 16 new
    tokens each) with the same logits gate and exact launch counts, then
    ``torch.profiler`` over 8 ticks (``dense_profile``).  Returns the
    launches."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-14b")
    assert (cfg.num_layers, cfg.d_model, cfg.padded_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.qkv_bias) == \
        (DENSE_LAYERS, 5120, 48, 8, 128, True)
    launches, model, params, prompts, max_new, max_len, _ = _engine_serve(
        "dense_serve", cfg, 8, 200, 14)
    profile_window(model, params, prompts, max_new, max_len,
                   tag="dense_profile")
    del model, params
    torch.cuda.empty_cache()
    return launches


def _dev_us(evt) -> float:
    """Self device time (us) of a profiler entry, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_window(model, params, prompts, max_new, max_len,
                   warm=10, ticks=8, tag="profile"):
    """Serve ``prompts`` again on a fresh engine: ``warm`` ticks, then
    ``ticks`` ticks timed on the host clock, then ``ticks`` more under
    ``torch.profiler``.  All four slots stay busy over both windows (the
    queue still holds requests).  The device busy share is the profiled
    kernel time per tick over the unprofiled tick time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServingEngine

    engine = ServingEngine(model, params, batch_slots=4, page_size=16,
                           max_len=max_len, device="cuda")
    for p in prompts:
        engine.submit(p, max_new=max_new)
    for _ in range(warm):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    torch.cuda.synchronize()
    tick_us = (time.perf_counter() - t0) / ticks * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        profiled_us = (time.perf_counter() - t0) / ticks * 1e6
    assert engine.queue and all(s.request_id >= 0 for s in engine.slots)
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    busy_us = sum(_dev_us(e) for e in dev) / ticks
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time in the serve "
                             "window")
    log({tag: {
        "ticks": ticks, "after_ticks": warm + ticks,
        "tick_us": tick_us, "profiled_tick_us": profiled_us,
        "device_busy_us_per_tick": busy_us,
        "device_busy_share": busy_us / tick_us,
        "kernels_per_tick": sum(e.count for e in dev) / ticks,
        "top_device_us_per_tick": [
            [e.key[:70], _dev_us(e) / ticks, e.count / ticks]
            for e in sorted(dev, key=_dev_us, reverse=True)[:10]],
        "top_host_self_us_per_tick": [
            [e.key[:50], e.self_cpu_time_total / ticks, e.count / ticks]
            for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                            reverse=True)[:10]]}})
    del engine


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 4: fp32 identity at full width, 4 layers
# ---------------------------------------------------------------------------

def identity_phase():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    # full fp32 products on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=4,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=1)
    engine = ServingEngine(model, params, batch_slots=4, page_size=16,
                           max_len=128, device="cuda")
    prompts = _prompts(cfg.vocab_size, 5, 40, seed=11)
    rids = [engine.submit(p, max_new=8) for p in prompts]
    results = engine.run_until_drained()
    for rid, prompt in zip(rids, prompts):
        cache = model.init_cache(1, 128)
        for t in prompt[:-1]:
            _, cache = model.decode_step(params, cache,
                                         torch.tensor([t], device="cuda"))
        out, cur = [], prompt[-1]
        for _ in range(8):
            lg, cache = model.decode_step(params, cache,
                                          torch.tensor([cur], device="cuda"))
            cur = int(torch.argmax(lg[0]))
            out.append(cur)
        log({"identity": {"request": rid, "engine": results[rid],
                          "contiguous": out}})
        if out != results[rid]:
            raise AssertionError(f"fp32 request {rid}: engine {results[rid]}"
                                 f" != contiguous {out}")
    del engine, params, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: the flash kernel against its plain version
# ---------------------------------------------------------------------------

def _visible_pairs(Sq, Sk, causal, window, q_offset):
    """(query, key) pairs that the masks leave visible."""
    total = 0
    for i in range(Sq):
        qpos = q_offset + i
        hi = min(Sk, qpos + 1) if causal else Sk
        lo = max(0, qpos - window + 1) if window else 0
        total += max(hi - lo, 0)
    return total


def _flash_bound(dtype_name, es, B, Sq, Sk, Hq, Hkv, D, causal, window,
                 q_offset):
    """Least time: q, k, v read once and out written once at the memory
    rate, against 4 * D flops per visible pair and query head (QK and PV)
    at the dtype's peak."""
    bytes_ = (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) * es
    flops = 4 * D * Hq * B * _visible_pairs(Sq, Sk, causal, window, q_offset)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _blind_rows_cases(rnd, dt):
    """The wgmma (bf16) or fp32 variant where query rows see no key
    (q_offset past Sk by more than the window), at head dims 64, 128 and
    256: held against its plain twin ``attention_reference_tiled`` at the
    variant's tiles at every row (a blind row in a block that runs tiles
    averages the V of those tiles, as the Pallas kernel's rows do over its
    blocks), against the dense plain version at the rows that see a key,
    and 0 at the rows of blocks that run no tile."""
    from repro_torch.kernels.flash_attention.kernel import (
        F32_TILES, WGMMA_TILES, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import plain_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_reference_tiled, tile_plan)

    dtn = str(dt).split(".")[-1]
    tol = TOL[dtn]
    for D, (B, Sq, Sk, Hq, Hkv, causal, window, q_offset) in (
            (64, (1, 300, 200, 4, 2, True, 64, 250)),
            (128, (2, 333, 517, 4, 2, False, 70, 400)),
            (256, (1, 300, 200, 2, 1, True, 64, 250))):
        q, k, v = rnd((B, Sq, Hq, D), dt), rnd((B, Sk, Hkv, D), dt), \
            rnd((B, Sk, Hkv, D), dt)
        bm, bn = (F32_TILES if dt == torch.float32 else WGMMA_TILES)[D]
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out = flash_attention_cuda(q, k, v, **kw).float()
        tiled = attention_reference_tiled(q, k, v, tiles=(bm, bn),
                                          **kw).float()
        dense = plain_attention(q, k, v, causal, window, q_offset,
                                None).float()
        sees = torch.tensor([q_offset + i - window + 1 <= Sk - 1
                             for i in range(Sq)], device="cuda")
        runs = torch.tensor([bool(tile_plan(i - i % bm, Sq, Sk, bm, bn,
                                            causal, window, q_offset))
                             for i in range(Sq)], device="cuda")
        e_t, e_d = (out - tiled).abs(), (out - dense).abs()[:, sees]
        rec = {"kernel": "flash_attention", "case": f"blind_rows_d{D}",
               "dtype": dtn, "tiles": [bm, bn],
               "shape": [B, Sq, Sk, Hq, Hkv, D],
               "causal": causal, "window": window, "q_offset": q_offset,
               "blind_rows_in_running_blocks": int((~sees & runs).sum()),
               "blind_rows_in_idle_blocks": int((~sees & ~runs).sum()),
               "max_abs_err_vs_tiled": float(e_t.max()),
               "max_abs_err_vs_dense_seeing_rows": float(e_d.max()),
               "tol": tol}
        rec["ok"] = bool(
            torch.all(e_t <= tol * (1 + tiled.abs()))
            and torch.all(e_d <= tol * (1 + dense.abs()[:, sees]))
            and torch.all(out[:, ~sees & ~runs] == 0)
            and torch.isfinite(out).all()
            and (~sees & runs).any() and (~sees & ~runs).any())
        log(rec)
        if not rec["ok"]:
            raise AssertionError(f"flash_attention blind_rows_d{D} {dtn} "
                                 f"disagrees with its plain versions: {rec}")


def flash_phase(card_line):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, flash_variant)
    from repro_torch.kernels.flash_attention.ops import plain_attention

    gen = torch.Generator(device="cuda").manual_seed(4321)
    timer, clean = Timer(iters=20), Timer(iters=20, flush="read")
    summary = {}

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    for dt in (torch.float32, torch.bfloat16):
        dtn = str(dt).split(".")[-1]
        es = torch.tensor([], dtype=dt).element_size()
        for case, (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, timed) in {
            "train": (2, 1024, 1024, 32, 8, 128, True, None, 0, True),
            "ragged": (1, 1000, 1000, 32, 8, 128, True, None, 0, False),
            "window": (2, 1024, 1024, 32, 8, 128, True, 128, 0, False),
            "q_offset": (2, 200, 712, 32, 8, 128, True, None, 512, False),
            "g1_d16": (2, 333, 333, 4, 4, 16, False, None, 0, False),
            "d64": (2, 1024, 1024, 16, 16, 64, True, None, 0, True),
        }.items():
            q, k, v = rnd((B, Sq, Hq, D), dt), rnd((B, Sk, Hkv, D), dt), \
                rnd((B, Sk, Hkv, D), dt)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            out = flash_attention_cuda(q, k, v, **kw)
            ref = plain_attention(q, k, v, causal, window, q_offset, None)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            ok = bool(torch.all(err <= TOL[dtn] * (1 + ref.float().abs()))) \
                and bool(torch.isfinite(out).all())
            rec = {"kernel": "flash_attention", "case": case, "dtype": dtn,
                   "shape": [B, Sq, Sk, Hq, Hkv, D], "causal": causal,
                   "window": window, "q_offset": q_offset,
                   "max_abs_err": float(err.max()), "tol": TOL[dtn],
                   "ok": ok}
            if timed:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                rec.update(
                    variant=flash_variant(dt, D),
                    kernel_ms=timer(lambda: flash_attention_cuda(q, k, v,
                                                                 **kw)),
                    kernel_ms_clean_l2=clean(lambda: flash_attention_cuda(
                        q, k, v, **kw)),
                    plain_ms=timer(lambda: plain_attention(
                        q, k, v, causal, window, q_offset, None)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)))
                bound = _flash_bound(dtn, es, B, Sq, Sk, Hq, Hkv, D, causal,
                                     window, q_offset)
                rec.update(bound_ms=bound[0], bound_by=bound[1],
                           card=card_line)
                if dt == torch.float32:
                    rec["faster_than_library"] = \
                        rec["kernel_ms"] < rec["library_ms"]
                    ok = ok and rec["faster_than_library"]
                    rec["ok"] = ok
            log(rec)
            if not ok:
                raise AssertionError(f"flash_attention {case} {dtn} disagrees "
                                     f"with its plain version or is not "
                                     f"faster than SDPA: {rec}")
            if case == "train" and dtn == "bfloat16":
                summary = rec
        _blind_rows_cases(rnd, dt)
        # gradients through the op against autograd through the plain version
        B, S, Hq, Hkv, D = 2, 1024, 32, 8, 128
        qkv = [rnd(shape, dt) for shape in ((B, S, Hq, D), (B, S, Hkv, D),
                                            (B, S, Hkv, D))]
        g = rnd((B, S, Hq, D), dt)
        a = [t.clone().requires_grad_() for t in qkv]
        b = [t.clone().requires_grad_() for t in qkv]
        ga = torch.autograd.grad(flash_attention(*a), a, g)
        gb = torch.autograd.grad(
            plain_attention(*b, True, None, 0, None), b, g)
        errs = [float((x.float() - y.float()).abs().max())
                for x, y in zip(ga, gb)]
        ok = all(bool(torch.all((x.float() - y.float()).abs()
                                <= TOL[dtn] * (1 + y.float().abs())))
                 and bool(torch.isfinite(x).all()) for x, y in zip(ga, gb))
        # forward + backward of one layer's attention, as training runs it
        op_ms = timer(lambda: torch.autograd.grad(flash_attention(*a), a, g))
        plain_ms = timer(lambda: torch.autograd.grad(
            plain_attention(*b, True, None, 0, None), b, g))
        log({"kernel": "flash_attention", "case": "train_grads", "dtype": dtn,
             "max_abs_err_dq_dk_dv": errs, "tol": TOL[dtn], "ok": ok,
             "op_fwd_bwd_ms": op_ms, "plain_fwd_bwd_ms": plain_ms,
             "card": card_line})
        if not ok:
            raise AssertionError(f"flash_attention gradients {dtn} disagree")
        del a, b, ga, gb, qkv, g
    del timer, clean
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# Phase 6: prefill and forward against decode, fp32 at full width
# ---------------------------------------------------------------------------

@torch.no_grad()
def _forward_vs_decode(model, params, tokens):
    """Logits (B, S, V) of ``Model.forward`` and of the contiguous
    ``decode_step`` teacher-forced over the same tokens."""
    B, S = tokens.shape
    fwd, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(B, S)
    rows = []
    for j in range(S):
        logits, cache = model.decode_step(params, cache, tokens[:, j])
        rows.append(logits)
    return fwd, torch.stack(rows, dim=1)


@torch.no_grad()
def _greedy_streams(model, params, prompt, n):
    """Greedy continuations of ``prompt`` (B, S): ``Model.prefill`` then
    ``n`` decode steps, and ``decode_step`` alone over the prompt then the
    same ``n`` steps.  Each stream has n + 1 tokens."""
    B, S = prompt.shape
    max_len = S + n + 1
    streams = []
    for use_prefill in (True, False):
        if use_prefill:
            logits, cache = model.prefill(params, {"tokens": prompt}, max_len)
        else:
            cache = model.init_cache(B, max_len)
            for j in range(S):
                logits, cache = model.decode_step(params, cache, prompt[:, j])
        out = [logits.argmax(-1)]
        for _ in range(n):
            logits, cache = model.decode_step(params, cache, out[-1])
            out.append(logits.argmax(-1))
        streams.append(torch.stack(out, dim=1).tolist())
    return streams


def prefill_phase():
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=4,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=2)
    rng = np.random.default_rng(13)
    prompt = torch.tensor(rng.integers(1, cfg.vocab_size, (2, 48)),
                          device="cuda")
    fwd, dec = _forward_vs_decode(model, params, prompt)
    diff = float((fwd - dec).abs().max())
    same = bool(torch.equal(fwd.argmax(-1), dec.argmax(-1)))
    log({"forward_vs_decode_fp32": {"layers": cfg.num_layers,
                                    "shape": list(prompt.shape),
                                    "max_abs_logit_diff": diff,
                                    "tol": LOGIT_ATOL_FP32,
                                    "same_argmax": same}})
    if not (diff <= LOGIT_ATOL_FP32 and same
            and bool(torch.isfinite(fwd).all())):
        raise AssertionError("fp32 forward and contiguous decode disagree")
    with_prefill, pure = _greedy_streams(model, params, prompt[:, :40], 8)
    log({"prefill_vs_decode_fp32": {"prefill": with_prefill,
                                    "decode": pure}})
    if with_prefill != pure:
        raise AssertionError("prefill + decode stream != pure decode stream")
    del model, params, fwd, dec
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 7: train llama3.2-3b at full width and depth
# ---------------------------------------------------------------------------

def train_phase():
    import math
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda)
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.launch.train import run

    cfg = get_config("llama3.2-3b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # main path: counts from 0 just before, read just after
    reset_launches(flash_attention_cuda, decode_attention_cuda,
                   paged_attention_cuda, rpc_post)
    out = run("llama3.2-3b", preset="full", steps=TRAIN_STEPS,
              batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=1,
              device="cuda")
    torch.cuda.synchronize()
    launches = flash_attention_cuda.launches
    hook_launches = rpc_post.launches
    by_variant = dict(flash_attention_cuda.launches_by_variant)
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in out["losses"]]
    times = out["log_times"]
    steady = [b - a for a, b in zip(times, times[1:])]   # steps 2..n
    step_s = sum(steady) / len(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # model flops: 6 N per token for the matmul parameters (all but the
    # input embedding), and the attention products over the visible
    # (causal) pairs of the real heads, 3x the forward for fwd + bwd
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.d_model
    attn = 3 * 4 * cfg.resolved_head_dim * cfg.num_heads * TRAIN_BATCH * \
        cfg.num_layers * _visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True, None, 0)
    flops = 6 * n_matmul * tokens + attn
    rec = {"layers": cfg.num_layers, "steps": TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "losses": losses,
           "first_step_s": times[0], "ms_per_step": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "model_flops_per_step": flops,
           "train_mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
           "flash_launches": launches, "flash_launches_by_variant": by_variant,
           "expected_launches_fwd_plus_remat": 2 * cfg.num_layers *
           TRAIN_STEPS, "peak_mem_gb": peak / 1e9, "seconds": out["seconds"],
           "loss_hook_firings": len(losses), "rpc_post_launches": hook_launches}
    log({"train": rec})
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(l)
                                             for l in losses):
        raise AssertionError(f"training losses not finite: {losses}")
    if hook_launches != len(losses):
        raise AssertionError(f"the loss hook fired {len(losses)} times and "
                             f"rpc_post launched {hook_launches} times")
    if launches != 2 * cfg.num_layers * TRAIN_STEPS:
        raise AssertionError(f"flash_attention launched {launches} times in "
                             f"{TRAIN_STEPS} steps x {cfg.num_layers} "
                             "layers, forward and remat recompute")
    if by_variant["wgmma"] != launches:
        raise AssertionError(f"training's flash launches were not all of "
                             f"the wgmma variant: {by_variant}")
    torch.cuda.empty_cache()
    return {"flash_attention": launches, "rpc_post": hook_launches}


def _kernel_kind(name: str) -> str:
    if "flash_fwd" in name:
        return "flash"
    if "ssd_" in name:
        return "ssd_scan"
    if "rglru_stream" in name:
        return "rglru_scan"
    if any(k in name for k in ("decode_fused", "split_mma", "merge_kernel")):
        return "decode_attention"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma",
                               "cublas")):
        return "gemm"
    return "other"


def _profile_summary(prof, calls, wall_ms):
    """Per-call host and device time of a ``torch.profiler`` window over
    ``calls`` calls whose unprofiled time was ``wall_ms`` a call."""
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    kinds = {}
    for e in dev:
        k = _kernel_kind(e.key)
        kinds[k] = kinds.get(k, 0.0) + _dev_us(e) / 1e3 / calls
    busy_ms = sum(kinds.values())
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return {
        "calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_ms_by_kind": kinds,
        "kernels": sum(e.count for e in dev) / calls,
        "host_op_self_ms": sum(e.self_cpu_time_total for e in host)
        / 1e3 / calls,
        "top_device_ms": [[e.key[:70], _dev_us(e) / 1e3 / calls,
                           e.count / calls]
                          for e in sorted(dev, key=_dev_us,
                                          reverse=True)[:8]],
        "top_host_self_ms": [[e.key[:50], e.self_cpu_time_total / 1e3
                              / calls, e.count / calls]
                             for e in sorted(host,
                                             key=lambda e:
                                             e.self_cpu_time_total,
                                             reverse=True)[:10]]}


def train_profile(arch="llama3.2-3b", rows=TRAIN_BATCH, seq=TRAIN_SEQ):
    """Where a full-width training step's time goes: one warm step, then
    one step timed in two synchronised halves (forward + backward, then
    the AdamW update), then one step under ``torch.profiler`` (device time
    by kernel kind and the top kernels).  Not part of the counted path."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.libc import rand_init
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import (OptConfig, adamw_init,
                                             adamw_update)
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves, tree_map

    cfg = get_config(arch)
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    opt = adamw_init(params)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    step_fn = make_train_step(model, opt_cfg)
    data = SyntheticLM(cfg.vocab_size, seq, rows)
    _, batch = data.batch_at(rand_init(1234, device="cuda"), 0)
    params, opt, _ = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(vals, batch)
    grads = torch.autograd.grad(loss, leaves(vals))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, opt, _ = adamw_update(grads, opt, opt_cfg, params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del vals, loss, grads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    log({"train_profile": {
        "arch": arch, "batch": rows, "seq_len": seq,
        "fwd_bwd_ms": (t1 - t0) * 1e3, "adamw_ms": (t2 - t1) * 1e3,
        "profiled_step_ms": (t4 - t3) * 1e3,
        **_profile_summary(prof, 1, (t2 - t0) * 1e3)}})
    del params, opt, model, step_fn
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 9: the SSD scan kernel against its plain version
# ---------------------------------------------------------------------------

def _ssd_inputs(gen, B, S, H, P, N, dt_x, dt_bc):
    """Drawn as tests/test_kernels.py draws them: x and B, C normal in their
    dtypes, dt = softplus(normal), A = -exp(normal), D normal (fp32)."""
    def rnd(shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    x = rnd((B, S, H, P), dt_x)
    dt = torch.nn.functional.softplus(rnd((B, S, H)))
    A = -torch.exp(rnd((H,)))
    return x, dt, A, rnd((B, S, N), dt_bc), rnd((B, S, N), dt_bc), rnd((H,))


def _ssd_bound(x, B_, chunk):
    """Least time: x, dt, B, C read once, y and the final state written
    once at the memory rate, against 2Q^2 N + H (2Q^2 P + 4QPN) flops per
    (batch, chunk) at the peak of x's dtype.  Returns (ms, bound_by)."""
    bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    es, es_bc = x.element_size(), B_.element_size()
    bytes_ = 2 * bsz * S * H * P * es + 4 * bsz * S * H + \
        2 * bsz * S * N * es_bc + 4 * bsz * H * P * N + 8 * H
    flops = bsz * nc * (2 * Q * Q * N + H * (2 * Q * Q * P + 4 * Q * P * N))
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_kernel_phase(card_line):
    """The SSD kernel against its plain version in fp32 and bf16, for y and
    the final state: at the prefill shape of mamba2 (B 4, S 2048, H 24,
    P 64, N 128, chunk 256; bf16 B and C as the model gives them), at its
    training shape (B 8), at S = 1000 through the op (padded to 1024), at
    S = 100 (Q = S), and at the shapes of tests/test_kernels.py (bf16 x
    with fp32 B and C, as that test draws them).  The tolerances are the
    repo's (fp32 2e-5, bf16 3e-2, atol and rtol).  Where the kernel takes
    its tensor-core path (bf16 x, B and C at P 64) it is also held within
    3e-2 of its rounding twin ``ssd_scan_reference_tc``.  At the prefill
    shape the fp32 kernel is also held against a float64 plain version: no
    further from it than ``SSD_FP64_MULT`` times the fp32 plain version
    is.  Kernel and plain times (CUDA events, L2 flushed) at the prefill
    and training shapes.  Then the op's gradients (backward recomputed
    through the plain version) against autograd through the plain version
    at the training shape, with the forward + backward times of both.
    Returns the bf16 records at the prefill and training shapes."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_cuda,
                                                     tensor_core_path)
    from repro_torch.kernels.ssd_scan.ops import pad_to_chunk
    from repro_torch.kernels.ssd_scan.ref import (ssd_scan_reference,
                                                  ssd_scan_reference_tc)

    gen = torch.Generator(device="cuda").manual_seed(2468)
    timer = Timer(iters=20)
    summary = {}

    def plain_op(args, chunk, fn=ssd_scan_reference):
        """The op's plain path (or its twin): zero-pad S to the chunk as
        the op does, scan, slice."""
        x, dt_, A, B_, C_, D = args
        S = x.shape[1]
        x, dt_, B_, C_, Q = pad_to_chunk(x, dt_, B_, C_, chunk)
        y, fs = fn(x, dt_, A, B_, C_, D, chunk=Q)
        return y[:, :S], fs

    for dt in (torch.float32, torch.bfloat16):
        dtn = str(dt).split(".")[-1]
        for case, (B, S, H, P, N, chunk, bc_model, via_op, timed) in {
            "prefill": (4, 2048, 24, 64, 128, 256, True, False, True),
            "train": (8, 2048, 24, 64, 128, 256, True, False, True),
            "s1000_op": (1, 1000, 24, 64, 128, 256, True, True, False),
            "s100": (4, 100, 24, 64, 128, 256, True, False, False),
            "tk_64": (2, 64, 3, 8, 16, 16, False, False, False),
            "tk_32": (1, 32, 2, 4, 8, 8, False, False, False),
        }.items():
            args = _ssd_inputs(gen, B, S, H, P, N, dt,
                               dt if bc_model else torch.float32)
            if via_op:
                y, fs = ssd_scan(*args, chunk=chunk)
            else:
                y, fs = ssd_scan_cuda(*args, chunk=chunk)
            ry, rfs = plain_op(args, chunk)
            torch.cuda.synchronize()
            tol = TOL[dtn]
            errs, ok = [], bool(torch.isfinite(y).all()
                                and torch.isfinite(fs).all())
            for out, ref in ((y, ry), (fs, rfs)):
                e = (out.float() - ref.float()).abs()
                errs.append(float(e.max()))
                ok = ok and bool(torch.all(e <= tol * (1 + ref.float()
                                                       .abs())))
            rec = {"kernel": "ssd_scan", "case": case, "dtype": dtn,
                   "shape": [B, S, H, P, N], "chunk": min(chunk, S),
                   "bc_dtype": str(args[3].dtype).split(".")[-1],
                   "max_abs_err_y_state": errs, "max_abs_err": max(errs),
                   "tol": tol, "ok": ok}
            if tensor_core_path(dt, args[3].dtype, P, N):
                # the rounding twin: the same rounding as the tensor cores
                ty, tfs = plain_op(args, chunk, ssd_scan_reference_tc)
                terrs = []
                for out, ref in ((y, ty), (fs, tfs)):
                    e = (out.float() - ref.float()).abs()
                    terrs.append(float(e.max()))
                    ok = ok and bool(torch.all(e <= tol * (1 + ref.float()
                                                           .abs())))
                rec.update(path="tensor_cores",
                           max_abs_err_vs_twin_y_state=terrs, ok=ok)
                del ty, tfs
            if case == "prefill" and dtn == "float32":
                # Against float64: the fp32 kernel may be no further from
                # it than SSD_FP64_MULT times the fp32 plain version is.
                y64, fs64 = ssd_scan_reference(
                    *[a.double() for a in args], chunk=chunk)
                k64 = [float((y.double() - y64).abs().max()),
                       float((fs.double() - fs64).abs().max())]
                p64 = [float((ry.double() - y64).abs().max()),
                       float((rfs.double() - fs64).abs().max())]
                rec.update(kernel_vs_fp64_max_abs_err_y_state=k64,
                           plain_vs_fp64_max_abs_err_y_state=p64,
                           fp64_mult=SSD_FP64_MULT)
                ok = ok and all(k <= SSD_FP64_MULT * q
                                for k, q in zip(k64, p64))
                rec["ok"] = ok
                del y64, fs64
            if timed:
                bound = _ssd_bound(args[0], args[3], chunk)
                rec.update(
                    kernel_ms=timer(lambda: ssd_scan_cuda(*args,
                                                          chunk=chunk)),
                    plain_ms=timer(lambda: ssd_scan_reference(*args,
                                                              chunk=chunk)),
                    library_ms=None, bound_ms=bound[0], bound_by=bound[1],
                    card=card_line)
            log(rec)
            if not ok:
                raise AssertionError(f"ssd_scan {case} {dtn} disagrees with "
                                     f"its plain version: {rec}")
            if case in ("prefill", "train") and dtn == "bfloat16":
                summary[case] = rec
            del args, y, fs, ry, rfs
        # gradients through the op against autograd through the plain
        # version, at the training shape (B 8, S 2048), y's cotangent only
        args = _ssd_inputs(gen, 8, 2048, 24, 64, 128, dt, dt)
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(dt)
        a = [t.clone().requires_grad_() for t in args]
        b = [t.clone().requires_grad_() for t in args]
        ga = torch.autograd.grad(ssd_scan(*a, chunk=256)[0], a, g)
        gb = torch.autograd.grad(ssd_scan_reference(*b, chunk=256)[0], b, g)
        errs = [float((x.float() - y.float()).abs().max())
                for x, y in zip(ga, gb)]
        ok = all(bool(torch.all((x.float() - y.float()).abs()
                                <= TOL[dtn] * (1 + y.float().abs())))
                 and bool(torch.isfinite(x).all()) for x, y in zip(ga, gb))
        # forward + backward of one layer's scan, as training runs it
        op_ms = timer(lambda: torch.autograd.grad(
            ssd_scan(*a, chunk=256)[0], a, g))
        plain_ms = timer(lambda: torch.autograd.grad(
            ssd_scan_reference(*b, chunk=256)[0], b, g))
        log({"kernel": "ssd_scan", "case": "train_grads", "dtype": dtn,
             "shape": [8, 2048, 24, 64, 128],
             "max_abs_err_dx_ddt_dA_dB_dC_dD": errs, "tol": TOL[dtn],
             "ok": ok, "op_fwd_bwd_ms": op_ms, "plain_fwd_bwd_ms": plain_ms,
             "card": card_line})
        if not ok:
            raise AssertionError(f"ssd_scan gradients {dtn} disagree")
        del args, g, a, b, ga, gb
    del timer
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# Phase 10: serve mamba2-130m at full width and depth (prefill + decode)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _prefill_and_greedy(model, params, prompt, n, max_len=None):
    """``Model.prefill`` of ``prompt`` (B, S) with ``max_len`` (S + n + 1 by
    default), then ``n`` greedy decode steps.  Returns (tokens (B, n + 1),
    prefill s, decode s, last logits); both times end in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompt},
                                  max_len or prompt.shape[1] + n + 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [logits.argmax(-1)]
    for _ in range(n):
        logits, cache = model.decode_step(params, cache, out[-1])
        out.append(logits.argmax(-1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return torch.stack(out, dim=1), t1 - t0, t2 - t1, logits


def ssm_serve_phase():
    """mamba2-130m at full width and depth (24 layers, bf16, random weights
    from seed 0), served as the JAX package serves the ssm family: one
    ``Model.prefill`` of 4 prompts x 2048 tokens (8 chunks each) and 64
    greedy ``decode_step``s, then one 1000-token prompt (padded to 1024 by
    the op) and 16 steps.  The ssd_scan count is reset just before and read
    just after (24 launches a prefill).  Then the bf16 full-depth
    forward-vs-decode difference, printed without a gate."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.models import build_model

    cfg = get_config("mamba2-130m")
    assert cfg.num_layers == SSM_LAYERS and cfg.d_inner == 1536
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[ssm_serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads "
        f"of P {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
        f"{cfg.ssd_chunk}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}, tied), {n_params} parameters "
        f"({cfg.param_dtype})")
    rng = np.random.default_rng(17)
    batch = torch.tensor(rng.integers(1, cfg.vocab_size, (4, 2048)),
                         device="cuda")
    single = torch.tensor(rng.integers(1, cfg.vocab_size, (1, 1000)),
                          device="cuda")
    _prefill_and_greedy(model, params, batch[:1, :256], 2)   # warm-up

    # main path: counts from 0 just before, read just after
    ssd_scan_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, prompt, n in (("batch4_2048", batch, 64),
                            ("single_1000", single, 16)):
        toks, t_pre, t_dec, logits = _prefill_and_greedy(model, params,
                                                          prompt, n)
        B, S = prompt.shape
        runs[name] = {"batch": B, "prompt": S, "new_tokens": n + 1,
                      "prefill_ms": t_pre * 1e3,
                      "prefill_tok_per_s": B * S / t_pre,
                      "decode_ms_per_step": t_dec / n * 1e3,
                      "decode_tok_per_s": B * n / t_dec,
                      "stream_head": toks[0, :8].tolist()}
        if not (torch.isfinite(logits[:, :cfg.vocab_size]).all()
                and bool((toks < cfg.vocab_size).all())):
            raise AssertionError(f"ssm serve {name}: non-finite logits or "
                                 "a pad token")
    torch.cuda.synchronize()
    launches = ssd_scan_cuda.launches
    log({"ssm_serve": {"runs": runs, "ssd_scan_launches": launches,
                       "expected": 2 * cfg.num_layers,
                       "peak_mem_gb": torch.cuda.max_memory_allocated()
                       / 1e9}})
    if launches != 2 * cfg.num_layers:
        raise AssertionError(f"ssd_scan launched {launches} times in two "
                             f"prefills of {cfg.num_layers} layers")
    ssm_serve_profile(model, params, batch, single)
    fwd, dec = _forward_vs_decode(model, params, batch[:1, :64])
    real = slice(0, cfg.vocab_size)
    log({"ssm_forward_vs_decode_bf16": {
        "layers": cfg.num_layers, "positions": 64,
        "max_abs_logit_diff": float((fwd[..., real] - dec[..., real]).abs()
                                    .max()),
        "same_argmax_share": float((fwd.argmax(-1) == dec.argmax(-1))
                                   .float().mean())}})
    del params, model, fwd, dec
    torch.cuda.empty_cache()
    return launches


@torch.no_grad()
def ssm_serve_profile(model, params, batch, single, steps=8,
                      tag="ssm_profile"):
    """Where a recurrent model's serving time goes, outside the counted
    path: greedy decode after a prefill of ``batch`` (4 warm steps,
    ``steps`` steps timed, ``steps`` more under ``torch.profiler``), then
    the prefill of ``single`` (once timed, once profiled); logged as
    ``tag`` lines."""
    from torch.profiler import ProfilerActivity, profile

    def decode(cache, tok, n):
        for _ in range(n):
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits.argmax(-1)
        return cache, tok

    logits, cache = model.prefill(params, {"tokens": batch},
                                  batch.shape[1] + 4 + 2 * steps + 1)
    cache, tok = decode(cache, logits.argmax(-1), 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, tok = decode(cache, tok, steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cache, tok = decode(cache, tok, steps)
        torch.cuda.synchronize()
    log({tag: {"what": "decode_step", "batch": batch.shape[0],
               **_profile_summary(prof, steps, wall)}})
    del cache
    prompt = {"tokens": single}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, prompt, single.shape[1] + 1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(params, prompt, single.shape[1] + 1)
        torch.cuda.synchronize()
    log({tag: {"what": "prefill", "batch": 1, "prompt": single.shape[1],
               **_profile_summary(prof, 1, wall)}})


def ssm_prefill_phase():
    """fp32, full width, 4 layers, TF32 off: ``Model.forward`` logits of
    mamba2 against the teacher-forced ``decode_step`` over the same 300
    tokens (2 chunks through the kernel; every position within 1e-3, the
    same argmax), and ``Model.prefill`` of 280 tokens followed by 8 greedy
    steps against pure decode (the same stream)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=4,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=3)
    rng = np.random.default_rng(19)
    prompt = torch.tensor(rng.integers(1, cfg.vocab_size, (2, 300)),
                          device="cuda")
    fwd, dec = _forward_vs_decode(model, params, prompt)
    diff = float((fwd - dec).abs().max())
    same = bool(torch.equal(fwd.argmax(-1), dec.argmax(-1)))
    log({"ssm_forward_vs_decode_fp32": {"layers": cfg.num_layers,
                                        "shape": list(prompt.shape),
                                        "max_abs_logit_diff": diff,
                                        "tol": LOGIT_ATOL_FP32,
                                        "same_argmax": same}})
    if not (diff <= LOGIT_ATOL_FP32 and same
            and bool(torch.isfinite(fwd).all())):
        raise AssertionError("ssm fp32 forward and decode disagree")
    with_prefill, pure = _greedy_streams(model, params, prompt[:, :280], 8)
    log({"ssm_prefill_vs_decode_fp32": {"prefill": with_prefill,
                                        "decode": pure}})
    if with_prefill != pure:
        raise AssertionError("ssm prefill + decode stream != pure decode")
    del model, params, fwd, dec
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 12: train mamba2-130m at full width and depth
# ---------------------------------------------------------------------------

def ssm_train_phase():
    """``launch/train.run("mamba2-130m", preset="full", steps=4, batch=8,
    seq_len=2048)`` through ``device_run``: losses finite (and whether they
    fall), ms/step over steps 2-4, tokens/s, ssd_scan launches (48 a step:
    the forward and the remat recompute of 24 layers), peak memory."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.launch.train import run

    cfg = get_config("mamba2-130m")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # main path: counts from 0 just before, read just after
    reset_launches(ssd_scan_cuda, rpc_post)
    out = run("mamba2-130m", preset="full", steps=SSM_TRAIN_STEPS,
              batch=SSM_TRAIN_BATCH, seq_len=SSM_TRAIN_SEQ, log_every=1,
              device="cuda")
    torch.cuda.synchronize()
    launches = ssd_scan_cuda.launches
    hook_launches = rpc_post.launches
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in out["losses"]]
    times = out["log_times"]
    steady = [b - a for a, b in zip(times, times[1:])]   # steps 2..n
    step_s = sum(steady) / len(steady)
    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "steps": SSM_TRAIN_STEPS, "batch": SSM_TRAIN_BATCH,
           "seq_len": SSM_TRAIN_SEQ, "losses": losses,
           "losses_fall": losses[-1] < losses[0],
           "first_step_s": times[0], "ms_per_step": step_s * 1e3,
           "tokens_per_s": SSM_TRAIN_BATCH * SSM_TRAIN_SEQ / step_s,
           "ssd_scan_launches": launches,
           "expected_launches_fwd_plus_remat": 2 * cfg.num_layers *
           SSM_TRAIN_STEPS, "peak_mem_gb": peak / 1e9,
           "seconds": out["seconds"], "loss_hook_firings": len(losses),
           "rpc_post_launches": hook_launches}
    log({"ssm_train": rec})
    if len(losses) != SSM_TRAIN_STEPS or not all(math.isfinite(l)
                                                 for l in losses):
        raise AssertionError(f"ssm training losses not finite: {losses}")
    if hook_launches != len(losses):
        raise AssertionError(f"the loss hook fired {len(losses)} times and "
                             f"rpc_post launched {hook_launches} times")
    if launches != 2 * cfg.num_layers * SSM_TRAIN_STEPS:
        raise AssertionError(f"ssd_scan launched {launches} times in "
                             f"{SSM_TRAIN_STEPS} steps x {cfg.num_layers} "
                             "layers, forward and remat recompute")
    torch.cuda.empty_cache()
    return launches, hook_launches


# ---------------------------------------------------------------------------
# Phase 14: the RG-LRU scan kernel against its plain version
# ---------------------------------------------------------------------------

def _rglru_bound(a, b):
    """Least time: a and b read once, h (b's dtype) and h_last (fp32)
    written once at the memory rate, against one multiply and one add per
    element at the fp32 peak of the CUDA cores.  Returns (ms, bound_by)."""
    B, S, W = a.shape
    bytes_ = B * S * W * (a.element_size() + 2 * b.element_size()) + 4 * B * W
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * B * S * W / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _scan_chunk(a, b) -> int:
    """The chunk length of the RG-LRU kernel's plan for a and b."""
    from repro_torch.kernels import sm_count
    from repro_torch.kernels.rglru_scan.kernel import scan_plan
    return scan_plan(sm_count(a.device.index), *a.shape, a.element_size(),
                     b.element_size()).steps


def rglru_kernel_phase(card_line):
    """The RG-LRU scan kernel in fp32 and bf16, h and h_last: bit for bit
    against its twin in the kernel's chunk order
    (``linear_scan_sequential_reference`` with the plan's chunk: the
    recurrence step by step in fp32, a product then a sum, each rounded),
    in fp32 within 2e-6 of the step-by-step walk (the chunk boundaries
    round apart), and within fp32 2e-5 / bf16 3e-2 (atol and rtol) of the
    plain doubling scan, at the serve shape of recurrentgemma-9b's prefill (B 2, S 3072,
    W 4096), at its second prefill (B 1, S 1000; no multiple of 256) and
    at the shapes of tests/test_kernels.py; a = sigmoid(normal), b =
    normal, as that test draws them.  Kernel times at the two prefill
    shapes (CUDA events, L2 flushed by writing, median of 20, and
    ``kernel_ms_clean_l2`` after a read flush) and the plain version's
    beside the bytes bound; no single PyTorch call computes the
    recurrence (a cumprod/cumsum rewrite divides by underflowing
    products), so no library time.  Then ``rglru_reuse``.  Returns the
    fp32 serve record (the model's a and b) and the fp32 s1000 one."""
    from repro_torch.kernels.rglru_scan.kernel import linear_scan_cuda
    from repro_torch.kernels.rglru_scan.ref import (
        linear_scan_reference, linear_scan_sequential_reference)

    gen = torch.Generator(device="cuda").manual_seed(1357)
    timer, clean = Timer(iters=20), Timer(iters=20, flush="read")
    summary = {}
    for dt in (torch.float32, torch.bfloat16):
        dtn = str(dt).split(".")[-1]
        for case, (B, S, W, timed) in {
            "serve": (2, 3072, 4096, True),
            "s1000": (1, 1000, 4096, True),
            "tk_128": (2, 128, 64, False),
            "tk_64": (1, 64, 16, False),
            "tk_96": (3, 96, 32, False),
        }.items():
            a = torch.sigmoid(torch.randn((B, S, W), generator=gen,
                                          device="cuda")).to(dt)
            b = torch.randn((B, S, W), generator=gen, device="cuda").to(dt)
            h, hl = linear_scan_cuda(a, b)
            rh, rhl = linear_scan_reference(a, b)
            chunk = _scan_chunk(a, b)
            th, thl = linear_scan_sequential_reference(a, b, chunk=chunk)
            sh, shl = linear_scan_sequential_reference(a, b)
            torch.cuda.synchronize()
            tol = TOL[dtn]
            errs, ok = [], bool(torch.isfinite(h).all()
                                and torch.isfinite(hl).all())
            for out, ref in ((h, rh), (hl, rhl)):
                e = (out.float() - ref.float()).abs()
                errs.append(float(e.max()))
                ok = ok and bool(torch.all(e <= tol * (1 + ref.float()
                                                       .abs())))
            bits = bool(torch.equal(h, th) and torch.equal(hl, thl))
            # against the step-by-step walk: the chunk boundaries round
            # apart; fp32 within 2e-6 (atol and rtol), bf16 only reported
            e_seq = [float((x.float() - y.float()).abs().max())
                     for x, y in ((h, sh), (hl, shl))]
            seq_ok = dtn != "float32" or all(
                bool(torch.all((x.float() - y.float()).abs()
                               <= SEQ_TOL * (1 + y.float().abs())))
                for x, y in ((h, sh), (hl, shl)))
            rec = {"kernel": "rglru_scan", "case": case, "dtype": dtn,
                   "shape": [B, S, W], "chunk": chunk,
                   "max_abs_err_h_hlast": errs,
                   "max_abs_err": max(errs), "tol": tol,
                   "bit_equal_to_chunk_order_twin": bits,
                   "max_abs_err_vs_step_by_step_h_hlast": e_seq,
                   "step_by_step_tol": SEQ_TOL if dtn == "float32" else None,
                   "ok": ok and bits and seq_ok}
            if timed:
                bound = _rglru_bound(a, b)
                rec.update(
                    kernel_ms=timer(lambda: linear_scan_cuda(a, b)),
                    kernel_ms_clean_l2=clean(lambda: linear_scan_cuda(a, b)),
                    plain_ms=timer(lambda: linear_scan_reference(a, b)),
                    library_ms=None, bound_ms=bound[0], bound_by=bound[1],
                    card=card_line)
            log(rec)
            if not rec["ok"]:
                raise AssertionError(f"rglru_scan {case} {dtn} disagrees "
                                     f"with its plain version or its "
                                     f"sequential twin: {rec}")
            if timed and dtn == "float32":   # the model's a and b
                summary[case] = rec
            del a, b, h, hl, rh, rhl, th, thl, sh, shl
    del timer, clean
    torch.cuda.empty_cache()
    rglru_reuse_phase()
    return summary


def rglru_reuse_phase():
    """The RG-LRU kernel 60 times back to back on six inputs whose (B, S,
    W) and dtypes change every call (the serve and s1000 shapes among
    them): every output bit-equal to the first call's on the same inputs
    and to the chunk-order twin.  The kernel keeps no state between calls
    (no status buffer: each block carries its channels' h in registers),
    so there is none to check for zeros."""
    from repro_torch.kernels.rglru_scan.kernel import linear_scan_cuda
    from repro_torch.kernels.rglru_scan.ref import (
        linear_scan_sequential_reference)

    gen = torch.Generator(device="cuda").manual_seed(2468)
    shapes = [((2, 3072, 4096), torch.float32, torch.float32),
              ((1, 1000, 4096), torch.float32, torch.float32),
              ((3, 77, 36), torch.bfloat16, torch.bfloat16),
              ((2, 515, 1028), torch.float32, torch.bfloat16),
              ((1, 1, 8), torch.bfloat16, torch.float32),
              ((4, 333, 2052), torch.bfloat16, torch.bfloat16)]
    inputs = [(torch.sigmoid(torch.randn(sh, generator=gen, device="cuda"))
               .to(da), torch.randn(sh, generator=gen, device="cuda").to(db))
              for sh, da, db in shapes]
    calls = 60
    outs = [linear_scan_cuda(*inputs[i % len(inputs)]) for i in range(calls)]
    torch.cuda.synchronize()
    differ = sum(not (torch.equal(h, outs[i % len(inputs)][0])
                      and torch.equal(hl, outs[i % len(inputs)][1]))
                 for i, (h, hl) in enumerate(outs))
    twin = [linear_scan_sequential_reference(a, b, chunk=_scan_chunk(a, b))
            for a, b in inputs]
    off_twin = sum(not (torch.equal(outs[i][0], twin[i][0])
                        and torch.equal(outs[i][1], twin[i][1]))
                   for i in range(len(inputs)))
    rec = {"rglru_reuse": {"calls": calls,
                           "shapes": [[list(sh), str(da).split(".")[-1],
                                       str(db).split(".")[-1]]
                                      for sh, da, db in shapes],
                           "calls_unequal_to_first": differ,
                           "inputs_unequal_to_twin": off_twin,
                           "status_buffer": None}}
    log(rec)
    if differ or off_twin:
        raise AssertionError(f"rglru reuse run failed: {rec}")
    del inputs, outs, twin
    torch.cuda.empty_cache()


def rglru_launch_phase():
    """torch.profiler over 5 calls at the serve shape in fp32 and bf16:
    exactly one device kernel a call, ``rglru_stream``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.rglru_scan.kernel import linear_scan_cuda

    gen = torch.Generator(device="cuda").manual_seed(77)
    calls, seen = 5, {}
    for dt in (torch.float32, torch.bfloat16):
        a = torch.rand((2, 3072, 4096), generator=gen, device="cuda").to(dt)
        b = torch.randn((2, 3072, 4096), generator=gen, device="cuda").to(dt)
        linear_scan_cuda(a, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                linear_scan_cuda(a, b)
            torch.cuda.synchronize()
        dev = {e.key[:60]: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        key = str(dt).split(".")[-1]
        seen[key] = dev
        if sum(dev.values()) != calls or not all("rglru_stream" in k
                                                 for k in dev):
            raise AssertionError(f"rglru_scan {key}: {dev} in {calls} "
                                 "calls, not one rglru_stream launch a call")
        del a, b
    log({"rglru_launches_per_call": {"calls": calls, "device_kernels": seen}})


# ---------------------------------------------------------------------------
# Phase 15: flash at D = 256 and decode at G = 16, D = 256
# ---------------------------------------------------------------------------

def hybrid_attn_kernel_phase(card_line):
    """The attention kernels at recurrentgemma-9b's widths (16 query heads
    over 1 KV head, head_dim 256), each against its plain version in fp32
    and bf16: flash at the prefill shape (B 2, S 3072, causal, window
    2048; and B 1, S 1000), decode over a full 2048-slot ring (B 2) and
    over ragged lengths, decode also against its split twin under the
    kernel's own split plan.  Times at the serve shapes beside the bound,
    with SDPA under the same mask as the library time."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels import decode_plan
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference, decode_attention_split_reference)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, flash_variant)
    from repro_torch.kernels.flash_attention.ops import plain_attention

    gen = torch.Generator(device="cuda").manual_seed(8642)
    timer, clean = Timer(iters=20), Timer(iters=20, flush="read")
    summary = {}

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    for dt in (torch.float32, torch.bfloat16):
        dtn = str(dt).split(".")[-1]
        es = torch.tensor([], dtype=dt).element_size()
        for case, (B, Sq, Sk, q_offset, timed) in {
            "serve": (2, 3072, 3072, 0, True),
            "s1000": (1, 1000, 1000, 0, False),
            # a continued prefill: ragged Sq and Sk, the window's lower
            # edge inside the cache
            "ragged_q_offset": (1, 777, 1800, 1023, False),
        }.items():
            Hq, Hkv, D, window = 16, 1, 256, 2048
            q, k, v = rnd((B, Sq, Hq, D), dt), rnd((B, Sk, Hkv, D), dt), \
                rnd((B, Sk, Hkv, D), dt)
            kw = dict(causal=True, window=window, q_offset=q_offset)
            out = flash_attention_cuda(q, k, v, **kw)
            ref = plain_attention(q, k, v, True, window, q_offset, None)
            torch.cuda.synchronize()
            err, ok = _close(out, ref, dtn)
            rec = {"kernel": "flash_attention", "case": f"hybrid_{case}",
                   "dtype": dtn, "shape": [B, Sq, Sk, Hq, Hkv, D],
                   "causal": True, "window": window, "q_offset": q_offset,
                   "max_abs_err": err, "tol": TOL[dtn], "ok": ok}
            if timed:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                qpos = q_offset + torch.arange(Sq, device="cuda")[:, None]
                kpos = torch.arange(Sk, device="cuda")[None, :]
                mask = (kpos <= qpos) & (kpos > qpos - window)
                bound = _flash_bound(dtn, es, B, Sq, Sk, Hq, Hkv, D, True,
                                     window, q_offset)
                rec.update(
                    variant=flash_variant(dt, D),
                    kernel_ms=timer(lambda: flash_attention_cuda(q, k, v,
                                                                 **kw)),
                    kernel_ms_clean_l2=clean(lambda: flash_attention_cuda(
                        q, k, v, **kw)),
                    plain_ms=timer(lambda: plain_attention(
                        q, k, v, True, window, q_offset, None)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True)),
                    bound_ms=bound[0], bound_by=bound[1], card=card_line)
                if dt == torch.float32:
                    rec["faster_than_library_and_plain"] = \
                        rec["kernel_ms"] < min(rec["library_ms"],
                                               rec["plain_ms"])
                    ok = ok and rec["faster_than_library_and_plain"]
                    rec["ok"] = ok
                del qt, kt, vt, mask
            log(rec)
            if not ok:
                raise AssertionError(f"flash_attention hybrid_{case} {dtn} "
                                     f"disagrees with its plain version or "
                                     f"is not faster than SDPA and it: {rec}")
            if case == "serve" and dtn == "bfloat16":
                summary["flash_attention"] = rec
            del q, k, v, out, ref
        for case, (B, T, lens, timed) in {
            "serve": (2, 2048, [2048, 2048], True),
            "ragged": (3, 2048, [2048, 700, 1], False),
        }.items():
            Hq, Hkv, D = 16, 1, 256
            q, k, v = rnd((B, Hq, D), dt), rnd((B, T, Hkv, D), dt), \
                rnd((B, T, Hkv, D), dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = decode_attention_cuda(q, k, v, lengths)
            ref = decode_attention_reference(q, k, v, lengths)
            # the split twin under the kernel's own plan
            plan = decode_plan(q.device, dt, B, Hkv, Hq // Hkv, D, T)
            twin = decode_attention_split_reference(q, k, v, lengths,
                                                    split_len=plan[0])
            torch.cuda.synchronize()
            err, ok = _close(out, ref, dtn)
            terr, tok = _close(out, twin, dtn)
            rec = {"kernel": "decode_attention", "case": f"hybrid_{case}",
                   "dtype": dtn, "shape": [B, T, Hq, Hkv, D],
                   "lengths": lens, "split_plan": list(plan),
                   "max_abs_err": err, "max_abs_err_vs_split_twin": terr,
                   "tol": TOL[dtn], "ok": ok and tok}
            if timed:
                kt, vt = k.transpose(1, 2).contiguous(), \
                    v.transpose(1, 2).contiguous()
                mask = (torch.arange(T, device="cuda")[None, :]
                        < lengths[:, None])[:, None, None, :]
                bound = _bound(dtn, es, B, Hq, Hkv, D,
                               _valid_tokens(lens, T, None), 0)
                rec.update(
                    kernel_ms=timer(lambda: decode_attention_cuda(
                        q, k, v, lengths)),
                    plain_ms=timer(lambda: decode_attention_reference(
                        q, k, v, lengths)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        q[:, :, None, :], kt, vt, attn_mask=mask,
                        enable_gqa=True)),
                    bound_ms=bound[0], bound_by=bound[1], card=card_line)
            log(rec)
            if not rec["ok"]:
                raise AssertionError(f"decode_attention hybrid_{case} {dtn} "
                                     "disagrees with its plain version or "
                                     "its split twin")
            if case == "serve" and dtn == "bfloat16":
                summary["decode_attention"] = rec
    del timer, clean
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# Phase 16: serve recurrentgemma-9b at full width and depth
# ---------------------------------------------------------------------------

def hybrid_serve_phase():
    """recurrentgemma-9b at full width and depth (38 layers: 26 RG-LRU and
    12 local-attention layers, bf16, random weights from seed 0), served as
    the JAX package serves the hybrid family: ``Model.prefill`` of 2
    prompts x 3072 tokens (past the 2048 window: the ring wraps and flash
    skips key tiles before the window) with max_len 4096 and 32 greedy
    ``decode_step``s, then one 1000-token prompt and 16 steps.  The counts
    are reset just before and read just after: rglru_scan 26 and flash 12
    a prefill, decode 12 a step.  Then ``torch.profiler`` over decode and
    the 1000-token prefill (``hybrid_profile`` lines) and the bf16
    full-depth forward-vs-decode difference, printed without a gate."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rglru_scan.kernel import linear_scan_cuda
    from repro_torch.models import build_model
    from repro_torch.models.transformer import hybrid_layer_kinds

    cfg = get_config("recurrentgemma-9b")
    kinds = hybrid_layer_kinds(cfg)
    assert (cfg.num_layers, kinds.count("rec"), kinds.count("attn"),
            cfg.padded_heads) == (HYBRID_LAYERS, HYBRID_REC, HYBRID_ATTN, 16)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[hybrid_serve] {cfg.name}: {cfg.num_layers} layers ({HYBRID_REC} "
        f"rec, {HYBRID_ATTN} attn), d_model {cfg.d_model}, lru_width "
        f"{cfg.lru_width}, {cfg.num_heads} heads of {cfg.resolved_head_dim} "
        f"over {cfg.num_kv_heads} KV head, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, window {cfg.local_window}, {n_params} parameters "
        f"({cfg.param_dtype}), init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    rng = np.random.default_rng(23)
    prompts = {name: torch.tensor(rng.integers(1, cfg.vocab_size, (B, S)),
                                  device="cuda")
               for name, B, S, _ in HYBRID_RUNS}
    _prefill_and_greedy(model, params, prompts["batch2_3072"][:1, :256], 2)

    # main path: counts from 0 just before, read just after
    reset_launches(linear_scan_cuda, flash_attention_cuda,
                   decode_attention_cuda)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, B, S, n in HYBRID_RUNS:
        toks, t_pre, t_dec, logits = _prefill_and_greedy(
            model, params, prompts[name], n, HYBRID_MAX_LEN)
        runs[name] = {"batch": B, "prompt": S, "max_len": HYBRID_MAX_LEN,
                      "new_tokens": n + 1, "prefill_ms": t_pre * 1e3,
                      "prefill_tok_per_s": B * S / t_pre,
                      "decode_ms_per_step": t_dec / n * 1e3,
                      "decode_tok_per_s": B * n / t_dec,
                      "stream_head": toks[0, :8].tolist()}
        if not (torch.isfinite(logits[:, :cfg.vocab_size]).all()
                and bool((toks < cfg.vocab_size).all())):
            raise AssertionError(f"hybrid serve {name}: non-finite logits "
                                 "or a pad token")
    torch.cuda.synchronize()
    launches = {"rglru_scan": linear_scan_cuda.launches,
                "flash_attention": flash_attention_cuda.launches,
                "decode_attention": decode_attention_cuda.launches}
    steps = sum(n for *_, n in HYBRID_RUNS)
    expected = {"rglru_scan": len(HYBRID_RUNS) * HYBRID_REC,
                "flash_attention": len(HYBRID_RUNS) * HYBRID_ATTN,
                "decode_attention": steps * HYBRID_ATTN}
    flash_by_variant = dict(flash_attention_cuda.launches_by_variant)
    log({"hybrid_serve": {"runs": runs, "launches": launches,
                          "flash_launches_by_variant": flash_by_variant,
                          "expected": expected,
                          "peak_mem_gb": torch.cuda.max_memory_allocated()
                          / 1e9}})
    if launches != expected:
        raise AssertionError(f"hybrid serve launches {launches}, expected "
                             f"{expected}")
    if flash_by_variant["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"the hybrid prefills' flash launches were not "
                             f"all of the wgmma variant: {flash_by_variant}")
    ssm_serve_profile(model, params, prompts["batch2_3072"],
                      prompts["single_1000"], tag="hybrid_profile")
    fwd, dec = _forward_vs_decode(model, params,
                                  prompts["batch2_3072"][:1, :64])
    real = slice(0, cfg.vocab_size)
    log({"hybrid_forward_vs_decode_bf16": {
        "layers": cfg.num_layers, "positions": 64,
        "max_abs_logit_diff": float((fwd[..., real] - dec[..., real]).abs()
                                    .max()),
        "same_argmax_share": float((fwd.argmax(-1) == dec.argmax(-1))
                                   .float().mean())}})
    del params, model, fwd, dec
    torch.cuda.empty_cache()
    return launches


def hybrid_prefill_phase():
    """fp32, full width, 3 layers (one rec, rec, attn group), TF32 off:
    ``Model.forward`` logits over 2064 tokens against ``Model.prefill`` of
    the first 2040 (max_len 4096: a 2048-slot ring) followed by 24
    teacher-forced ``decode_step``s, which write past slot 2047 and wrap
    (every position within 1e-3, the same argmax); then ``Model.prefill``
    of 40 tokens plus 8 greedy steps against pure decode (the same
    stream)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=4)
    rng = np.random.default_rng(29)
    S, pre = 2064, 2040
    tokens = torch.tensor(rng.integers(1, cfg.vocab_size, (2, S)),
                          device="cuda")
    with torch.no_grad():
        fwd, _ = model.forward(params, {"tokens": tokens})
        fwd = fwd[:, pre - 1:]
        logits, cache = model.prefill(params, {"tokens": tokens[:, :pre]},
                                      HYBRID_MAX_LEN)
        rows = [logits]
        for j in range(pre, S):
            logits, cache = model.decode_step(params, cache, tokens[:, j])
            rows.append(logits)
    dec = torch.stack(rows, dim=1)
    diff = float((fwd - dec).abs().max())
    same = bool(torch.equal(fwd.argmax(-1), dec.argmax(-1)))
    log({"hybrid_forward_vs_decode_fp32": {
        "layers": cfg.num_layers, "shape": [2, S], "prefill": pre,
        "ring": int(cache["k"].shape[2]), "max_abs_logit_diff": diff,
        "tol": LOGIT_ATOL_FP32, "same_argmax": same}})
    if not (diff <= LOGIT_ATOL_FP32 and same
            and bool(torch.isfinite(fwd).all())):
        raise AssertionError("hybrid fp32 forward and prefill + decode "
                             "across the ring disagree")
    del fwd, dec, cache, rows
    with_prefill, pure = _greedy_streams(model, params, tokens[:, :40], 8)
    log({"hybrid_prefill_vs_decode_fp32": {"prefill": with_prefill,
                                           "decode": pure}})
    if with_prefill != pure:
        raise AssertionError("hybrid prefill + decode stream != pure decode")
    del model, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 18-22: the GPU First runtime (host RPC, device_run, expansion)
# ---------------------------------------------------------------------------

#: PCIe rate per lane and direction after line coding, GB/s, by generation.
PCIE_LANE_GB_S = {1: 0.25, 2: 0.5, 3: 0.985, 4: 1.969, 5: 3.938, 6: 7.563}
#: The H100 SXM's host link by its data sheet (PCIe Gen5 x16), taken where
#: ``nvidia-smi`` reports the link as [N/A].
DATASHEET_LINK = {"gen": 5, "width": 16}
#: Watchdog of each rpc_gil case: a deadlock between Python's lock and a
#: spinning rpc_post ends the run with every thread's traceback.
GIL_WATCHDOG_S = 60
#: Launches queued behind a posted call in rpc_gil: more than CUDA's
#: launch queue holds (about a thousand), so a launch blocks.
GIL_FLOOD = 4096
#: The gpu_first phase's sizes: the example's own, and XSBench's "small"
#: problem (68 nuclides x 11,303 energy points each) at 2**20 of its
#: default 15,000,000 lookups, the single-team loop on the first 2048.
GPU_FIRST_SIZES = {
    "example": dict(n_lookups=2048, n_grid=512, n_nuclides=32,
                    serial_lookups=None),
    "xsbench_small": dict(n_lookups=1 << 20, n_grid=11303, n_nuclides=68,
                          serial_lookups=2048),
}


def pcie_link() -> dict:
    """The host link as ``nvidia-smi`` reports it now, with its rate each
    way (None where it reports no number)."""
    fields = ("pcie.link.gen.current", "pcie.link.width.current",
              "pcie.link.gen.max", "pcie.link.width.max")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + ",".join(fields),
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    vals = [v.strip() for v in out.split(",")]
    rec = {"nvidia_smi": out, "source": "nvidia-smi"}
    try:
        gen, width = int(vals[0]), int(vals[1])
    except (ValueError, IndexError):
        gen, width = DATASHEET_LINK["gen"], DATASHEET_LINK["width"]
        rec["source"] = "data sheet (nvidia-smi reports no link)"
    rec.update(gen=gen, width=width,
               bytes_per_s=PCIE_LANE_GB_S[gen] * width * 1e9)
    return rec


def _same_tensor(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        bool(torch.equal(a.cpu(), b.cpu()))


def rpc_phase():
    """The four RPC cases of tests/test_core.py on CUDA tensors through the
    channel (value and Ref arguments; a READ ref not written back; two
    landing pads for two signatures of one callee; an ArenaRef over a
    GenericAllocator heap and over the BalancedAllocator page heap), and
    a bf16 ref: each call against the host-synchronous version on the same
    inputs, bit-equal (both only move bytes), with one rpc_post launch a
    channel call.  Returns the largest difference seen (0.0)."""
    import numpy as np
    from repro_torch.core import (READ, ArenaRef, BalancedAllocator,
                                  GenericAllocator, Ref, ShapeDtype,
                                  effects_barrier, rpc_call,
                                  rpc_call_reference, rpc_stats)
    from repro_torch.core.rpc import REGISTRY
    from repro_torch.kernels.rpc_channel import rpc_post

    dev = torch.device("cuda", 0)
    i32, f32 = ShapeDtype((), torch.int32), ShapeDtype((), torch.float32)

    def scanf_like(scale, buf):
        buf[:] = np.arange(len(buf), dtype=np.float32) * float(scale)
        return np.int32(len(buf))

    def summer(buf):
        total = float(buf.sum())
        buf[:] = -1.0                    # host-side mutation of a READ ref
        return np.float32(total)

    def vararg_like(*args):
        return np.int32(len(args))

    def host_fill(ptr, base, size, found, arena):
        if int(found) != 1 or int(size) != 8:
            raise AssertionError(f"ArenaRef lookup: found {found} size {size}")
        arena[int(base):int(base) + int(size)] = 7.0
        return np.int32(0)

    def third(buf):
        buf[:] = np.float32(1.0 / 3.0)
        return np.int32(buf.dtype.itemsize)

    for fn in (scanf_like, summer, vararg_like, host_fill, third):
        REGISTRY.register("smoke." + fn.__name__, fn)
    generic, gptr = GenericAllocator.malloc(
        GenericAllocator.init(64, cap=8, device=dev), 8)
    pages = BalancedAllocator.init(256, 4, 1, cap=4, device=dev)
    pages, _ = BalancedAllocator.malloc(pages, 2, 0, 4)
    pages, pptr = BalancedAllocator.malloc(pages, 2, 0, 8)
    one = torch.ones((), dtype=torch.int32, device=dev)
    cases = {
        "value_and_ref": ("scanf_like", i32,
                          (3, Ref(torch.zeros(4, device=dev)))),
        "read_only_ref": ("summer", f32,
                          (Ref(torch.ones(3, device=dev), access=READ),)),
        "pad_int32": ("vararg_like", i32, (one,)),
        "pad_int32_float32": ("vararg_like", i32,
                              (one, torch.full((), 2.0, device=dev))),
        "arena_generic": ("host_fill", i32,
                          (ArenaRef(torch.zeros(64, device=dev), gptr + 3,
                                    generic),)),
        "arena_balanced": ("host_fill", i32,
                           (ArenaRef(torch.zeros(256, device=dev), pptr,
                                     pages),)),
        "bf16_ref": ("third", i32,
                     (Ref(torch.zeros(5, dtype=torch.bfloat16,
                                      device=dev)),)),
    }
    rec, outs = {}, {}
    for case, (name, spec, args) in cases.items():
        rpc_post.launches = 0
        chan = rpc_call("smoke." + name, *args, result_shape=spec)
        launches = rpc_post.launches
        plain = rpc_call_reference("smoke." + name, *args, result_shape=spec)
        effects_barrier()
        equal = _same_tensor(chan[0], plain[0]) and all(
            _same_tensor(a, b) for a, b in zip(chan[1], plain[1]))
        rec[case] = {"result": chan[0].item(), "bit_equal": equal,
                     "launches": launches}
        outs[case] = chan
        if not equal or launches != 1:
            raise AssertionError(f"rpc {case}: channel {chan} vs host "
                                 f"{plain}, {launches} rpc_post launches")
    checks = {
        "value_and_ref": outs["value_and_ref"][1][0].tolist() == [0, 3, 6, 9]
        and rec["value_and_ref"]["result"] == 4,
        "read_only_ref": rec["read_only_ref"]["result"] == 3.0
        and outs["read_only_ref"][1][0] is cases["read_only_ref"][2][0].array
        and bool((outs["read_only_ref"][1][0] == 1).all()),
        "two_pads": rpc_stats("smoke.vararg_like")["pads"] == 2,
        "arena_generic": outs["arena_generic"][1][0].tolist()
        == [7.0] * 8 + [0.0] * 56,
        "arena_balanced": float(outs["arena_balanced"][1][0].sum()) == 56.0,
        "bf16_ref": outs["bf16_ref"][1][0].dtype == torch.bfloat16
        and rec["bf16_ref"]["result"] == 4,
        "calls": all(rpc_stats("smoke." + n)["calls"] ==
                     2 * sum(c[0] == n for c in cases.values())
                     for n in ("scanf_like", "summer", "vararg_like",
                               "host_fill", "third")),
    }
    log({"rpc": {"cases": rec, "checks": checks}})
    if not all(checks.values()):
        raise AssertionError(f"rpc checks failed: {checks}")
    return 0.0


def rpc_gil_phase():
    """A posted call whose callee sleeps, followed at once by each of
    ``.item()``, ``.cpu()``, ``torch.cuda.synchronize()``,
    ``Event.synchronize()`` and a flood of launches longer than CUDA's
    launch queue, each under a 60 s ``faulthandler`` watchdog that ends
    the run on a deadlock between Python's lock and the spinning kernel.
    Records each case's wall time."""
    import faulthandler
    import numpy as np
    from repro_torch.core import ShapeDtype, effects_barrier, rpc_call
    from repro_torch.core.rpc import REGISTRY

    sleep_s = 0.2

    def slow(x):
        time.sleep(sleep_s)
        return np.float32(x.sum())

    REGISTRY.register("smoke.slow", slow)
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev)
    flood = torch.zeros(256, device=dev)

    def event_sync(r):
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()

    cases = {
        "item": lambda r: r.item(),
        "cpu": lambda r: r.cpu(),
        "cuda_synchronize": lambda r: torch.cuda.synchronize(),
        "event_synchronize": event_sync,
        "launch_flood": lambda r: [flood.add_(1.0) for _ in range(GIL_FLOOD)],
    }
    rec = {}
    for case, then in cases.items():
        faulthandler.dump_traceback_later(GIL_WATCHDOG_S, exit=True)
        try:
            t0 = time.perf_counter()
            r, _ = rpc_call("smoke.slow", x,
                            result_shape=ShapeDtype((), torch.float32))
            then(r)
            torch.cuda.synchronize()
            rec[case + "_s"] = time.perf_counter() - t0
        finally:
            faulthandler.cancel_dump_traceback_later()
        if r.item() != 28.0:
            raise AssertionError(f"rpc_gil {case}: result {r.item()}")
    effects_barrier()
    rec.update(callee_sleep_s=sleep_s, flood=GIL_FLOOD,
               watchdog_s=GIL_WATCHDOG_S)
    log({"rpc_gil": rec})
    if not bool((flood == GIL_FLOOD).all()):
        raise AssertionError("rpc_gil: the launch flood lost launches")


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def rpc_time_phase(card_line):
    """Round trips through the channel beside the host-synchronous version:
    an empty call (an int32 result; CUDA events around the three stream
    operations on an idle stream, median of 200, so the host's enqueue is
    inside; with the host's time in ``rpc_call``, the kernel's own wait,
    post to reply, the drain thread's time in Python, and the events'
    time when a 1 GB add ahead on the stream hides the enqueue), and
    READWRITE refs of 4 KB, 1 MB and 64 MB (GB/s both ways against the
    host link's rate from ``nvidia-smi``, or the data sheet's where it
    reports none).  The host-synchronous times are wall times (that
    version waits for the device by design).  Returns the empty call's
    numbers for the kernels line."""
    import numpy as np
    from repro_torch.core import (Ref, ShapeDtype, effects_barrier, rpc_call,
                                  rpc_call_reference)
    from repro_torch.core.rpc import REGISTRY
    from repro_torch.kernels.rpc_channel import channel_for

    dev = torch.device("cuda", 0)
    i32 = ShapeDtype((), torch.int32)

    def empty():
        return np.int32(0)

    def touch(buf):
        buf[0] += 1.0
        return np.int32(0)

    REGISTRY.register("smoke.empty", empty)
    REGISTRY.register("smoke.touch", touch)
    chan = channel_for(dev)

    def on_channel(fn, n, ahead=None):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        dev_ms, wall_ms, enq_us, waited_us, serve_us = [], [], [], [], []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if ahead is not None:
                ahead()
            t0 = time.perf_counter()
            a.record()
            fn()
            enq_us.append((time.perf_counter() - t0) * 1e6)
            b.record()
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(a.elapsed_time(b))
            waited_us.append(chan.waited_ns() * 1e-3)
            serve_us.append(chan.last_serve_ns * 1e-3)
        return {"ms": _median(dev_ms), "wall_ms": _median(wall_ms),
                "enqueue_us": _median(enq_us),
                "kernel_wait_us": _median(waited_us),
                "host_serve_us": _median(serve_us), "calls": n}

    def host_sync(fn, n):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        return _median(wall)

    def call_empty():
        return rpc_call("smoke.empty", result_shape=i32, device=dev)

    empty_rec = on_channel(call_empty, 200)
    ahead = torch.zeros(128 << 20, device=dev)   # 1 GB moved, ~0.3 ms
    busy = on_channel(call_empty, 100, ahead=lambda: ahead.add_(1.0))
    empty_rec.update(behind_busy_stream_ms=busy["ms"],
                     behind_busy_stream_kernel_wait_us=busy["kernel_wait_us"])
    del ahead
    empty_rec["plain_ms"] = host_sync(
        lambda: rpc_call_reference("smoke.empty", result_shape=i32,
                                   device=dev), 200)
    refs = {}
    for label, nbytes, n in (("4KB", 4 << 10, 100), ("1MB", 1 << 20, 50),
                             ("64MB", 64 << 20, 10)):
        buf = torch.zeros(nbytes // 4, device=dev)
        r = on_channel(lambda: rpc_call("smoke.touch", Ref(buf),
                                        result_shape=i32), n)
        r["plain_ms"] = host_sync(
            lambda: rpc_call_reference("smoke.touch", Ref(buf),
                                       result_shape=i32), n)
        r["bytes_each_way"] = nbytes
        refs[label] = r
        del buf
    effects_barrier()
    link = pcie_link()                   # read just after the 64 MB calls
    rate = link["bytes_per_s"]
    for r in [empty_rec] + list(refs.values()):
        moved = 2 * r.get("bytes_each_way", 0) + 4
        r["bound_ms"] = moved / rate * 1e3 if rate else None
        r["gb_per_s"] = moved / (r["ms"] * 1e-3) / 1e9
        r["plain_gb_per_s"] = moved / (r["plain_ms"] * 1e-3) / 1e9
    log({"rpc_time": {"card": card_line, "link": link, "empty": empty_rec,
                      "readwrite": refs}})
    return empty_rec


def device_run_hooks_phase():
    """``device_run`` on the card, each run under
    ``torch.cuda.set_sync_debug_mode("error")`` (a step that synchronises
    raises): 1000 steps of a (256,) state with a named immediate hook
    every 100 steps, then every step, then every 100 steps of a 64M-float
    state (a step of ~0.16 ms on the device, so the host can run ahead):
    exactly one host call and one rpc_post launch a firing; then a batched
    hook every step (one ``rpc_enqueue`` a step, one flush after the loop:
    one host call) and a returning hook every 100 steps (an enqueue, a
    flush and the reply folded into the state a firing, and the final
    flush: 11 host calls), the hooks' values in order and the final state
    exact; the Python loop's wall time against the device's time for the
    same steps.  Returns the rpc_post and rpc_enqueue launches."""
    import numpy as np
    from repro_torch.core import (HostHook, ShapeDtype, device_run,
                                  effects_barrier, reset_rpc_stats,
                                  rpc_stats)
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.rpc_queue import rpc_enqueue

    dev = torch.device("cuda", 0)
    steps, posts, enqueues, rec = 1000, 0, 0, {}
    cases = (("every_100", 100, 256, "immediate"),
             ("every_1", 1, 256, "immediate"),
             ("every_100_state_64M", 100, 64 << 20, "immediate"),
             ("batched_every_1", 1, 256, "batched"),
             ("returning_every_100", 100, 256, "returning"))
    for key, every, width, mode in cases:
        seen = []
        name = "smoke.hook_" + key
        if mode == "returning":
            def host_fn(i, v, seen=seen):
                seen.append((i, float(v)))
                return np.float32(1.0)

            hook = HostHook(every=every, extract=lambda i, s: s[:256].sum(),
                            host_fn=host_fn, name=name, batched=True,
                            returns=ShapeDtype((), torch.float32),
                            consume=lambda i, s, v, ok: s + torch.where(
                                ok, v, 0.0))
            # state after step 100k, before its firing: 100k + (k - 1)
            want = [(s, 256.0 * (s + s // every - 1))
                    for s in range(every, steps + 1, every)]
            final_want, host_calls = steps + steps // every, \
                steps // every + 1
        else:
            hook = HostHook(every=every, extract=lambda i, s: s[:256].sum(),
                            host_fn=lambda i, v, seen=seen: seen.append(
                                (i, float(v))),
                            name=name, batched=mode == "batched")
            want = [(s, 256.0 * s) for s in range(every, steps + 1, every)]
            final_want = steps
            host_calls = 1 if mode == "batched" else len(want)
        state = torch.zeros(width, device=dev)
        effects_barrier()
        reset_rpc_stats()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        # main path: counts from 0 just before, read just after
        rpc_post.launches = rpc_enqueue.launches = 0
        t0 = time.perf_counter()
        a.record()
        with sync_errors():
            final = device_run(lambda i, s: s + 1.0, state, steps,
                               hooks=[hook])
        loop_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        effects_barrier()
        wall_ms = (time.perf_counter() - t0) * 1e3
        n_post, n_enq = rpc_post.launches, rpc_enqueue.launches
        calls = rpc_stats(name)["calls"]
        rec[key] = {
            "steps": steps, "state_floats": width, "hook": mode,
            "host_calls": n_post, "callee_calls": calls,
            "rpc_post_launches": n_post, "rpc_enqueue_launches": n_enq,
            "values_in_order": seen == want,
            "python_loop_ms": loop_ms, "device_ms": a.elapsed_time(b),
            "wall_ms": wall_ms,
            "final_ok": bool((final == final_want).all())}
        posts += n_post
        enqueues += n_enq
        del state, final
        if not (calls == len(want) and n_post == host_calls
                and n_enq == (0 if mode == "immediate" else len(want))
                and seen == want and rec[key]["final_ok"]):
            raise AssertionError(f"device_run hooks {key}: {rec[key]}")
    log({"device_run_hooks": rec})
    return posts, enqueues


def _allocator_ops(dev):
    """malloc, free, find_obj and realloc on a generic and a balanced heap
    on ``dev`` (on a card under ``set_sync_debug_mode("error")``): the
    states and results as CPU tensors."""
    from repro_torch.core import BalancedAllocator, GenericAllocator, realloc
    g = GenericAllocator.init(1024, cap=64, device=dev)
    b = BalancedAllocator.init(1024, 4, 1, cap=16, device=dev)
    arena = torch.arange(1024.0, device=dev)
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        g, p = GenericAllocator.malloc(g, 16)
        g, q = GenericAllocator.malloc(g, 8)
        g = GenericAllocator.free(g, p)
        found = GenericAllocator.find_obj(g, q + 3)
        g, arena, q2 = realloc(g, arena, q, 24)
        g, p3 = GenericAllocator.malloc(g, 12)
        b, bp = BalancedAllocator.malloc(b, 1, 0, 16)
        b, bq = BalancedAllocator.malloc(b, 1, 0, 4)
        b = BalancedAllocator.free(b, bq)
        bfound = BalancedAllocator.find_obj(b, bp + 15)
        b, arena, bp2 = realloc(b, arena, bp, 40, tid=1)
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    tensors = [p, q, q2, p3, bp, bq, bp2, arena, *found, *bfound]
    for st in (g, b):
        tensors += [getattr(st, f.name) for f in dataclasses.fields(st)
                    if isinstance(getattr(st, f.name), torch.Tensor)]
    return [t.cpu() for t in tensors]


def gpu_first_phase():
    """The GPU First example's program (``examples/gpu_first_port_torch.py``)
    through ``repro_torch.core`` at the example's size and at XSBench's
    "small" geometry (2**20 lookups): the single-team loop
    (``serial_for``), the expanded one (``parallel_for``, with vmap's
    fallback warning an error) and the hand-vectorised manual port agree
    within rtol 1e-5, and ``write_results`` receives every result through
    the channel; the three times, the prediction error and the verdict.
    Then the allocator ops once under ``set_sync_debug_mode("error")``,
    bit-equal to the same ops on the CPU.  Returns the rpc_post launches
    of the two runs."""
    import warnings
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import gpu_first_port_torch as ex
    from repro_torch.kernels.rpc_channel import rpc_post

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())

    dev = torch.device("cuda", 0)
    rec, launches = {}, 0
    for key, size in GPU_FIRST_SIZES.items():
        # main path: counts from 0 just before, read just after
        rpc_post.launches = 0
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            torch._C._functorch._set_vmap_fallback_warning_enabled(True)
            try:
                out = ex.run(device=dev, **size)
            finally:
                torch._C._functorch._set_vmap_fallback_warning_enabled(False)
        n_rpc = rpc_post.launches
        launches += n_rpc
        r1, r2, r3 = out["serial"], out["expanded"], out["manual"]
        ns = out["n_serial"]
        t_legacy, t_exp, t_man = (out[k] for k in
                                  ("t_legacy", "t_expanded", "t_manual"))
        rec[key] = {
            **size, "serial_ms": out["t_serial_run"] * 1e3,
            "serial_us_per_lookup": out["t_serial_run"] / ns * 1e6,
            "legacy_ms": t_legacy * 1e3, "expanded_ms": t_exp * 1e3,
            "manual_ms": t_man * 1e3, "speedup": t_legacy / t_exp,
            "prediction_error": abs(t_exp - t_man) / t_man,
            "verdict": "PORT" if t_exp < t_legacy * 0.8 else "DON'T PORT",
            "rel_serial_vs_expanded": rel(r1, r2[:ns]),
            "rel_manual_vs_expanded": rel(r3, r2),
            "rpc_wrote": out["rpc_wrote"], "rpc_post_launches": n_rpc}
        if not (rec[key]["rel_serial_vs_expanded"] <= 1e-5
                and rec[key]["rel_manual_vs_expanded"] <= 1e-5
                and out["rpc_wrote"] == size["n_lookups"] and n_rpc == 1
                and bool(torch.isfinite(r2).all())):
            raise AssertionError(f"gpu_first {key}: {rec[key]}")
    card, plain = _allocator_ops(dev), _allocator_ops(torch.device("cpu"))
    rec["allocator_ops_bit_equal_to_cpu"] = all(
        torch.equal(a, b) for a, b in zip(card, plain))
    log({"gpu_first": rec})
    if not rec["allocator_ops_bit_equal_to_cpu"]:
        raise AssertionError("allocator ops on the card differ from the CPU")
    return launches


#: The rpc_queue plans: 250 records a plan, a flush every 100, so the
#: 64-slot ring wraps, and both arenas fill.
QUEUE_GEOMETRY = dict(capacity=64, width=4, payload_capacity=512,
                      reply_capacity=96)
QUEUE_RECORDS, QUEUE_FLUSH_EVERY, QUEUE_SEEDS = 250, 100, (0, 1, 2)


def _queue_callees():
    """The plans' callees (an int and a float reply, each a function of
    every argument) and ``logged(log)``: handlers for one flush that log
    each call's argument types and values first."""
    import numpy as np
    from repro_torch.core.rpc import REGISTRY

    def q_int(tag, x, *pay):
        bump = sum(int(np.asarray(p, np.int64).sum()) for p in pay) % 17
        return np.arange(4, dtype=np.int32) * 3 + tag + bump

    def q_float(tag, x, *pay):
        return np.arange(4, dtype=np.float32) * np.float32(0.5) + \
            np.float32(x) + np.float32(tag)

    fns = {"smoke.q_int": q_int, "smoke.q_float": q_float}
    REGISTRY.register("smoke.q_int", q_int, idempotent=True)
    REGISTRY.register("smoke.q_float", q_float)

    def logged(log):
        def wrap(name, fn):
            def call(*args):
                log.append((name,) + tuple(
                    (a.dtype.str, a.tobytes()) if isinstance(a, np.ndarray)
                    else (type(a).__name__, a) for a in args))
                return fn(*args)
            return call
        return {n: wrap(n, f) for n, f in fns.items()}

    return logged


def _queue_plan(dev, seed, n):
    """``n`` seeded records: (name, args on the card, the same args on the
    host, returns, where on the card, where on the host).  Tags are Python
    ints or 0-d int32 tensors, x Python floats or 0-d fp32 or bf16
    tensors, payloads int32, fp32 or bf16 arrays of 1-40 words; a third of
    the records carry a device-computed ``where``."""
    import numpy as np
    from repro_torch.core import ShapeDtype
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wmask = torch.rand(n, generator=gen, device=dev) < 0.75
    wmask_cpu = wmask.cpu()
    plan = []
    for k in range(n):
        name = ("smoke.q_int", "smoke.q_float")[rng.integers(2)]
        tag = int(rng.integers(0, 1000))
        x = float(rng.standard_normal())
        card, cpu = [], []
        kind = rng.integers(3)
        if kind == 0:
            card.append(tag)
            cpu.append(tag)
        else:
            t = torch.tensor(tag, dtype=torch.int32)
            card.append(t.to(dev))
            cpu.append(t)
        kind = rng.integers(3)
        if kind == 0:
            card.append(x)
            cpu.append(x)
        else:
            t = torch.tensor(x, dtype=torch.float32 if kind == 1
                             else torch.bfloat16)
            card.append(t.to(dev))
            cpu.append(t)
        if rng.random() < 0.5:
            length = int(rng.integers(1, 41))
            dt = (torch.int32, torch.float32, torch.bfloat16)[
                rng.integers(3)]
            vals = rng.standard_normal(length) * 100
            t = torch.tensor(vals).to(dt)
            card.append(t.to(dev))
            cpu.append(t)
        nrep = int(rng.integers(0, 5))
        returns = None if nrep == 0 else ShapeDtype(
            (nrep,), torch.int32 if name == "smoke.q_int" else torch.float32)
        if rng.random() < 0.33:
            plan.append((name, card, cpu, returns, wmask[k], wmask_cpu[k]))
        else:
            plan.append((name, card, cpu, returns, None, None))
    return plan


def _equal_states(a, b) -> bool:
    return bool(torch.equal(a.cpu(), b.cpu()))


def rpc_queue_phase():
    """``rpc_enqueue`` against its plain version on the card and against a
    CPU queue, on three seeded plans of 250 records (64-slot ring, a
    512-word arena and a 96-word reply arena, so records are overwritten
    and dropped at both arenas; mixed int, fp32 and bf16 scalars and
    payloads; device-computed ``where``), all under
    ``set_sync_debug_mode("error")``: the whole queue state (lanes, heads,
    arenas) bit-equal to the plain version's and the CPU's before each
    flush, tickets equal, the flush's replay log (argument types and
    bytes), replies, statuses and heads bit-equal to the CPU queue's after
    it, the last epoch's ``result_ok``/``result_status`` on the card equal
    to the CPU's; exactly one ``rpc_enqueue`` a record and one
    ``rpc_post`` a flush.  Returns the ``rpc_enqueue`` and ``rpc_post``
    launches."""
    from repro_torch.core import (RpcQueue, effects_barrier, flush_stats,
                                  reset_rpc_stats)
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.rpc_queue import enqueue_reference, rpc_enqueue

    dev = torch.device("cuda", 0)
    logged = _queue_callees()
    rec, launches, posts = {}, 0, 0
    for seed in QUEUE_SEEDS:
        plan = _queue_plan(dev, seed, QUEUE_RECORDS)
        qk = RpcQueue.create(**QUEUE_GEOMETRY, device=dev)
        qp = RpcQueue.create(**QUEUE_GEOMETRY, device=dev)
        qc = RpcQueue.create(**QUEUE_GEOMETRY, device="cpu")
        logs = {"card": [], "cpu": []}
        before, after, tickets = [], [], []
        last = []
        effects_barrier()
        reset_rpc_stats()
        # main path: counts from 0 just before, read just after
        rpc_enqueue.launches = rpc_post.launches = 0
        flushes = 0
        # the plans drop records by design: the flushes' warnings say so
        with warnings.catch_warnings(), sync_errors():
            warnings.simplefilter("ignore", RuntimeWarning)
            for k, (name, card, cpu, returns, wcard, wcpu) in \
                    enumerate(plan):
                _, tk = qk.enqueue_ticketed(name, *card, returns=returns,
                                            where=wcard)
                tp = enqueue_reference(qp.lanes(), qp.record(
                    name, card, returns, wcard))
                _, tc = qc.enqueue_ticketed(name, *cpu, returns=returns,
                                            where=wcpu)
                tickets.append((tk, tp, tc))
                last.append((k, returns))
                if (k + 1) % QUEUE_FLUSH_EVERY and k + 1 != len(plan):
                    continue
                before.append((qk.state.clone(), qp.state.clone(),
                               qc.state.clone()))
                qk.flush(logged(logs["card"]))
                qc.flush(logged(logs["cpu"]))
                flushes += 1
                qp.state.copy_(qk.state)
                after.append((qk.state.clone(), qc.state.clone()))
                if k + 1 != len(plan):
                    last = []
            reads = []
            for k, returns in last:
                tk, _, tc = tickets[k]
                card_read = [qk.result_status(tk)]
                cpu_read = [qc.result_status(tc)]
                if returns is not None:
                    card_read += list(qk.result_ok(tk, returns))
                    cpu_read += list(qc.result_ok(tc, returns))
                reads.append((card_read, cpu_read))
            n_enq, n_post = rpc_enqueue.launches, rpc_post.launches
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            effects_barrier()
        checks = {
            "lanes_vs_plain": all(_equal_states(a, b) for a, b, _ in before),
            "lanes_vs_cpu": all(_equal_states(a, c) for a, _, c in before),
            "tickets": all(int(a) == int(b) == int(c) for a, b, c in tickets),
            "replay_log": logs["card"] == logs["cpu"] and bool(logs["cpu"]),
            "replies_statuses_heads": all(_equal_states(a, c)
                                          for a, c in after),
            "last_epoch_reads": all(
                all(_equal_states(x, y) for x, y in zip(a, b))
                for a, b in reads),
            "one_enqueue_launch_a_record": n_enq == len(plan),
            "one_rpc_post_a_flush": n_post == flushes,
        }
        both = flush_stats()              # the card's and the CPU's queue
        checks["overwrite_and_both_arenas_dropped"] = (
            both["drops"] > 0 and both["arena_drops"] > 0
            and both["reply_drops"] > 0)
        rec[f"seed_{seed}"] = {
            "checks": checks, "records": len(plan), "flushes": flushes,
            "dropped_tickets": sum(int(c) < 0 for _, _, c in tickets),
            "records_replayed": len(logs["cpu"]),
            "flush_stats_card_plus_cpu": both,
            "rpc_enqueue_launches": n_enq, "rpc_post_launches": n_post}
        launches += n_enq
        posts += n_post
        if not all(checks.values()):
            raise AssertionError(f"rpc_queue seed {seed}: {rec}")
    log({"rpc_queue": rec})
    return launches, posts


def rpc_queue_faults_phase():
    """The same seeded ``FaultPlan``s (four generated faults and a delay
    past the 0.1 s timeout) on a card queue and a CPU queue, with and
    without ``RetryPolicy(max_attempts=3)``: equal statuses, replies,
    error-log attributions ``(callee, ticket, attempt)`` and fired
    faults."""
    _queue_callees()
    names = ["smoke.q_int", "smoke.q_float"]
    dev = torch.device("cuda", 0)
    rec = {}
    with warnings.catch_warnings():
        _faults_runs(names, dev, rec)
    log({"rpc_queue_faults": rec})


def _faults_runs(names, dev, rec):
    """The runs of :func:`rpc_queue_faults_phase`, recorded in ``rec``."""
    import numpy as np
    from repro_torch.core import (RetryPolicy, RpcQueue, ShapeDtype,
                                  clear_error_log, effects_barrier,
                                  error_log, set_fault_injector)
    from repro_torch.testing.faults import Fault, FaultPlan

    for seed in QUEUE_SEEDS:
        rng = np.random.default_rng(100 + seed)
        recs = [(names[rng.integers(2)], int(rng.integers(0, 500)),
                 float(rng.standard_normal()), int(rng.integers(1, 4)))
                for _ in range(40)]
        for retry in (None, RetryPolicy(max_attempts=3)):
            out = {}
            for where in ("card", "cpu"):
                clear_error_log()
                d = dev if where == "card" else torch.device("cpu")
                faults = FaultPlan.generate(seed, names, n_faults=4,
                                            max_index=20).faults
                # a delay past the timeout on the callee that is never
                # retried (not idempotent), so every plan has a TIMEOUT
                plan = FaultPlan(faults + (Fault("delay", names[1],
                                                 3 + seed, delay=0.25),))
                q = RpcQueue.create(48, width=3, payload_capacity=0,
                                    reply_capacity=128, retry=retry,
                                    timeout=0.1, device=d)
                tix = []
                warnings.simplefilter("ignore", RuntimeWarning)
                with sync_errors() if where == "card" else \
                        contextlib.nullcontext():
                    for name, tag, x, nrep in recs:
                        dt = torch.int32 if name == names[0] \
                            else torch.float32
                        tix.append(q.enqueue_ticketed(
                            name, tag, x, returns=ShapeDtype((nrep,), dt))[1])
                    set_fault_injector(plan)
                    q.flush()
                try:
                    effects_barrier()
                finally:
                    set_fault_injector(None)
                tickets = [int(t) for t in tix]
                out[where] = {
                    "statuses": q.statuses_host(tickets),
                    "replies": [q.results_host([t], (n,), torch.float32 if
                                               nm == names[1]
                                               else torch.int32)[0][0]
                                .tobytes() for t, (nm, _, _, n) in
                                zip(tickets, recs)],
                    "errors": [(e["callee"], e["ticket"], e["attempt"])
                               for e in error_log()],
                    "fired": list(plan.fired)}
            key = f"seed_{seed}_" + ("retry3" if retry else "no_retry")
            equal = out["card"] == out["cpu"]
            sts = out["card"]["statuses"]
            rec[key] = {"equal": equal,
                        "statuses": {s: sts.count(s) for s in set(sts)},
                        "errors": len(out["card"]["errors"]),
                        "fired": len(out["card"]["fired"])}
            if not equal or 2 not in sts:
                raise AssertionError(f"rpc_queue_faults {key}: {rec[key]}")


#: Plain enqueues timed behind one device sleep (see rpc_queue_time_phase).
PLAIN_TIMED_CALLS = 5


def _busy_cycles(ms: float) -> int:
    """``torch.cuda._sleep`` cycles that keep the card busy ``ms``."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    torch.cuda.synchronize()
    return int(10_000_000 * ms / a.elapsed_time(b))


def _behind_busy(fn, n):
    """Host us and device us per call of ``fn`` over ``n`` calls: the
    calls are enqueued behind a device sleep longer than the host needs
    to enqueue them all (sized from the warm-up calls' host time, and
    doubled up to twice when the host was slower), so the events time the
    device's own work."""
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    for attempt in range(3):
        cycles = _busy_cycles((2.0 * warm_ms * n + 5.0) * 2 ** attempt)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        c = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        c.record()
        torch.cuda.synchronize()
        busy_ms = a.elapsed_time(b)
        if host_ms < busy_ms:
            break
    return {"host_us": host_ms / n * 1e3,
            "device_us": b.elapsed_time(c) / n * 1e3,
            "calls": n, "hidden_behind_ms": busy_ms,
            "host_hidden": host_ms < busy_ms, "attempts": attempt + 1}


def rpc_queue_time_phase(card_line):
    """Host and device microseconds per ``rpc_enqueue`` and per plain
    enqueue on the card (behind a device sleep that hides the host) for a
    scalar record at W 4, a 1 KB and a 64 KB payload, beside the bound
    (the record's bytes at 3.35 TB/s); then the flush of a full ring of
    1024 records with a 4096-word arena (CUDA events around the round
    trip, the host's time in ``flush``, the drain's Python; median of 5).
    Returns the scalar record's numbers for the kernels line."""
    import numpy as np
    from repro_torch.core import RpcQueue, effects_barrier
    from repro_torch.core.rpc import REGISTRY
    from repro_torch.kernels.rpc_channel import channel_for
    from repro_torch.kernels.rpc_queue import enqueue_reference

    REGISTRY.register("smoke.q_sink", lambda *a: None)
    dev = torch.device("cuda", 0)
    width = 4
    cases = {}
    for label, words in (("scalar_w4", 0), ("payload_1KB", 256),
                         ("payload_64KB", 16384)):
        n = 200 if words <= 256 else 50
        args = ([1, 2.5, torch.tensor(3, dtype=torch.int32, device=dev),
                 torch.tensor(0.25, device=dev)] if not words else
                [7, torch.randn(words, device=dev)])
        # room for the warm-up calls and three attempts: nothing dropped
        arena = max(1, (3 + 3 * n) * words)
        q = RpcQueue.create(max(n, 64), width, arena, device=dev)
        qp = RpcQueue.create(max(n, 64), width, arena, device=dev)
        kernel = _behind_busy(lambda: q.enqueue("smoke.q_sink", *args), n)
        # the plain version is ~100 small launches a record: five stay
        # within CUDA's launch queue behind the sleep (more would block
        # the host on the sleeping device)
        plain = _behind_busy(lambda: enqueue_reference(
            qp.lanes(), qp.record("smoke.q_sink", args)), PLAIN_TIMED_CALLS)
        equal = int(q.head) == 3 + kernel["attempts"] * n and \
            int(q.adrops) == 0
        lanes = 4 + 3 * width
        nbytes = 4 * lanes + 8 * words + 4 * 6 + 4
        cases[label] = {
            "payload_words": words, "kernel": kernel, "plain": plain,
            "ms": kernel["device_us"] * 1e-3,
            "plain_ms": plain["device_us"] * 1e-3,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
            "all_kept": equal}
        if not (kernel["host_hidden"] and plain["host_hidden"] and equal):
            raise AssertionError(f"rpc_queue_time {label}: {cases[label]}")
        del q, qp
    # flush of a full ring
    REGISTRY.register("smoke.q_full", lambda i, x, p: None)
    q = RpcQueue.create(1024, width, 4096, device=dev)
    payload = torch.arange(4, dtype=torch.int32, device=dev)
    chan = channel_for(dev)
    ev_ms, host_us, serve_us = [], [], []
    for _ in range(6):
        for i in range(1024):
            q.enqueue("smoke.q_full", i, 0.5, payload)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        q.flush()
        host_us.append((time.perf_counter() - t0) * 1e6)
        b.record()
        effects_barrier()
        ev_ms.append(a.elapsed_time(b))
        serve_us.append(chan.last_serve_ns * 1e-3)
    link = pcie_link()
    moved = 4 * (q.layout.in_end + q.layout.words - q.layout.out_start)
    flush = {"records": 1024, "arena_words": 4096,
             "ms": _median(ev_ms[1:]), "host_us": _median(host_us[1:]),
             "drain_python_us": _median(serve_us[1:]),
             "bytes_moved": moved,
             "link_bound_ms": moved / link["bytes_per_s"] * 1e3,
             "flushes_timed": len(ev_ms) - 1}
    log({"rpc_queue_time": {"card": card_line, "enqueue": cases,
                            "flush_full_ring": flush}})
    return cases["scalar_w4"]


def _libc_io_run(dev, heap_name):
    """fprintf, fwrite, fgets, fread, remote malloc and LogRing on a queue
    on ``dev`` (on a card under ``set_sync_debug_mode("error")``): the
    host's output as plain values, and the launches on a card."""
    import numpy as np
    from repro_torch.core import (GenericAllocator, LogRing, RpcQueue,
                                  atoi, drain_fwrite, drain_log_lines,
                                  drain_printf, effects_barrier, fgets,
                                  fprintf, fread, fread_feed, fwrite,
                                  remote_heap_register, remote_malloc_enqueue,
                                  remote_malloc_results)
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.rpc_queue import rpc_enqueue

    fread_feed(71, "12 apples\n-3.5e2 pears\nrest", reset=True)
    fread_feed(72, np.arange(6, dtype=np.float32) * 1.5, reset=True)
    remote_heap_register(heap_name,
                         GenericAllocator.init(4096, cap=64, device="cpu"))
    drain_printf()
    drain_log_lines()
    q = RpcQueue.create(64, width=4, payload_capacity=1024,
                        reply_capacity=256, device=dev)
    ring = LogRing.create(16, payload_capacity=64, device=dev)
    step = torch.tensor(7, dtype=torch.int32, device=dev)
    loss = torch.tensor(0.3125, device=dev)
    hist = torch.arange(5, dtype=torch.int32, device=dev) * 3
    data_i = torch.arange(10, dtype=torch.int32, device=dev) - 4
    data_f = torch.linspace(-1, 1, 7, device=dev)
    sizes = torch.tensor([24, 8, 100], dtype=torch.int32, device=dev)
    vec = torch.tensor([1.5, -2.0], device=dev)
    rpc_enqueue.launches = rpc_post.launches = 0
    with sync_errors() if dev.type == "cuda" else contextlib.nullcontext():
        fprintf(q, "step %d loss %.4f", step, loss)
        fprintf(q, "hist %s", hist)
        fwrite(q, data_i, stream=3)
        fwrite(q, data_f, stream=4)
        _, t_line = fgets(q, 16, stream=71)
        _, t_line2 = fgets(q, 16, stream=71)
        _, t_f = fread(q, 4, stream=72, dtype=torch.float32)
        _, t_short = fread(q, 4, stream=72, dtype=torch.float32)
        _, t_m = remote_malloc_enqueue(q, heap_name, sizes)
        ring.log(step, loss, payload=vec)
        ring.log(2, 0.5)
        q.flush()
        ring.flush()
        reads = [q.result(t_line, (16,), torch.int32),
                 q.result(t_line2, (16,), torch.int32),
                 q.result(t_f, (4,), torch.float32),
                 q.result(t_short, (4,), torch.float32),
                 q.result(t_m, (3,), torch.int32)]
    launches = (rpc_enqueue.launches, rpc_post.launches)
    effects_barrier()
    state, ptrs = remote_malloc_results(heap_name)
    return {"printf": drain_printf(),
            "fwrite": [drain_fwrite(3).tolist(), drain_fwrite(4).tolist()],
            "reads": [r.cpu().tolist() for r in reads],
            "atoi": int(atoi(reads[0].cpu().to(torch.uint8))),
            "log": [tuple(np.asarray(x).tolist() for x in line)
                    for line in drain_log_lines()],
            "ptrs": [p.tolist() for p in ptrs],
            "watermark": int(state.watermark)}, launches


def libc_io_phase():
    """The buffered libc on a card queue and on a CPU queue: the same
    printf lines, fwrite streams, fgets/fread replies (and ``atoi`` of a
    line), remote-malloc pointers and heap watermark, and LogRing lines;
    11 ``rpc_enqueue`` launches and 2 ``rpc_post``s on the card.  Returns
    both counts."""
    card, (n_enq, n_post) = _libc_io_run(torch.device("cuda", 0),
                                         "smoke.heap_card")
    cpu, _ = _libc_io_run(torch.device("cpu"), "smoke.heap_cpu")
    rec = {"card_equals_cpu": card == cpu, "printf": card["printf"],
           "atoi": card["atoi"], "ptrs": card["ptrs"],
           "rpc_enqueue_launches": n_enq, "rpc_post_launches": n_post}
    log({"libc_io": rec})
    if not (rec["card_equals_cpu"] and n_enq == 11 and n_post == 2
            and card["atoi"] == 12 and card["ptrs"] == [[0, 24, 32]]):
        raise AssertionError(f"libc_io: {rec}; card {card}; cpu {cpu}")
    return n_enq, n_post


# ---------------------------------------------------------------------------
# The async queue (csrc/rpc_async.cu) and the host data feed
# ---------------------------------------------------------------------------

ASYNC_CARRY_BUDGET = 2


def _flaky(handlers, counts):
    """``handlers`` with ``smoke.q_int`` (idempotent) made flaky: a record
    whose tag is an odd multiple of 5 fails its first attempt, one whose
    tag is a multiple of 10 every attempt (so it exhausts the carry
    budget).
    Attempts are counted per argument list in ``counts``; every attempt is
    logged by the wrapped handler first."""
    import numpy as np
    inner = handlers["smoke.q_int"]

    def call(tag, *rest):
        key = (tag,) + tuple(a.tobytes() if isinstance(a, np.ndarray) else a
                             for a in rest)
        n = counts[key] = counts.get(key, 0) + 1
        out = inner(tag, *rest)
        if tag % 5 == 0 and (n == 1 or tag % 10 == 0):
            raise RuntimeError(f"flaky q_int tag {tag} attempt {n}")
        return out

    return dict(handlers, **{"smoke.q_int": call})


def _async_plan_run(plan, q, logs, counts, flush):
    """Enqueue ``plan`` (``(name, args, returns, where)``) on ``q``,
    flushing through ``flush(q, handlers)`` every QUEUE_FLUSH_EVERY
    records and at the end, then once to collect the tail and
    ASYNC_CARRY_BUDGET more times to retire carried records.  Returns the
    tickets and the queue state after each flush (clones)."""
    logged = _queue_callees()
    tickets, states = [], []
    n = len(plan)
    for k, (name, args, returns, where) in enumerate(plan):
        _, t = q.enqueue_ticketed(name, *args, returns=returns, where=where)
        tickets.append(t)
        if (k + 1) % QUEUE_FLUSH_EVERY == 0 or k + 1 == n:
            flush(q, _flaky(logged(logs), counts))
            states.append(q.state.clone())
    for _ in range(1 + ASYNC_CARRY_BUDGET):
        flush(q, _flaky(logged(logs), counts))
        states.append(q.state.clone())
    return tickets, states


def rpc_queue_async_phase():
    """The three plans of ``rpc_queue`` on async queues (``carry_budget``
    2, ``smoke.q_int`` made flaky: some records are carried and redriven,
    some exhaust the budget): a card queue (the ``rpc_async_post`` and
    ``rpc_async_collect`` kernels) under ``set_sync_debug_mode("error")``,
    then the same plan on a card queue through the kernels' plain versions
    (``RpcQueue.flush_reference``) and on a CPU queue.  After every flush
    the whole queue state is bit-equal across the three, and after the
    final join the replay logs (every attempt's argument types and
    bytes), every ticket's host status and reply, the carry outcomes and
    ``flush_stats`` are equal; exactly one launch of each kernel a flush
    and no ``rpc_post``.  Returns the launches of each kernel."""
    from repro_torch.core import (RpcQueue, effects_barrier, flush_stats,
                                  reset_rpc_stats)
    from repro_torch.kernels.rpc_async import (rpc_async_collect,
                                               rpc_async_post)
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.rpc_queue import rpc_enqueue

    dev = torch.device("cuda", 0)
    geo = dict(QUEUE_GEOMETRY, mode="async", carry_budget=ASYNC_CARRY_BUDGET)
    rec, launches = {}, {"rpc_async_post": 0, "rpc_async_collect": 0}
    for seed in QUEUE_SEEDS:
        plan = _queue_plan(dev, seed, QUEUE_RECORDS)
        runs = {}
        for label in ("card", "plain", "cpu"):
            on_card = label != "cpu"
            q = RpcQueue.create(**geo, device=dev if on_card else "cpu")
            sub = [(n, card if on_card else cpu, r, wk if on_card else wc)
                   for n, card, cpu, r, wk, wc in plan]
            logs, counts = [], {}
            effects_barrier()
            reset_rpc_stats()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                if label == "card":
                    # main path: counts from 0 just before, read just after
                    rpc_async_post.launches = rpc_async_collect.launches = 0
                    rpc_post.launches = rpc_enqueue.launches = 0
                    with sync_errors():
                        tickets, states = _async_plan_run(
                            sub, q, logs, counts,
                            lambda q, h: q.flush(h))
                    n_post, n_coll = (rpc_async_post.launches,
                                      rpc_async_collect.launches)
                    n_chan, n_enq = rpc_post.launches, rpc_enqueue.launches
                else:
                    tickets, states = _async_plan_run(
                        sub, q, logs, counts,
                        lambda q, h: q.flush_reference(h))
                assert q.join(timeout=60)
            effects_barrier()
            tix = [int(t) for t in tickets]
            live = [t for t in tix if t >= 0]
            outcomes = {t: (st, None if w is None else w.tolist())
                        for t, (st, w) in q.carry_outcomes().items()}
            reads = []
            for t, (_, _, r, _) in zip(tix, sub):
                if t >= 0 and r is not None:
                    (v, ok), = q.results_host([t], r)
                    reads.append((t, v.tolist(), ok))
            runs[label] = {"tickets": tix, "states": states, "logs": logs,
                           "statuses": q.statuses_host(live),
                           "reads": reads, "outcomes": outcomes,
                           "stats": flush_stats()}
            del q
        flushes = len(runs["card"]["states"])
        card, plain, cpu = runs["card"], runs["plain"], runs["cpu"]
        checks = {
            "states_vs_plain_and_cpu": all(
                _equal_states(a, b) and _equal_states(a, c)
                for a, b, c in zip(card["states"], plain["states"],
                                   cpu["states"])),
            "tickets": card["tickets"] == plain["tickets"] == cpu["tickets"],
            "replay_log": card["logs"] == plain["logs"] == cpu["logs"]
            and bool(cpu["logs"]),
            "statuses": card["statuses"] == plain["statuses"]
            == cpu["statuses"],
            "replies": card["reads"] == plain["reads"] == cpu["reads"],
            "carry_outcomes": card["outcomes"] == plain["outcomes"]
            == cpu["outcomes"],
            "flush_stats": card["stats"] == plain["stats"] == cpu["stats"],
            "carried_ok_and_exhausted": any(
                st == 0 for st, _ in cpu["outcomes"].values()) and any(
                st == 1 for st, _ in cpu["outcomes"].values()),
            "one_post_and_one_collect_a_flush": n_post == n_coll == flushes,
            "no_rpc_post": n_chan == 0,
            "one_enqueue_launch_a_record": n_enq == len(plan),
        }
        rec[f"seed_{seed}"] = {
            "checks": checks, "records": len(plan), "flushes": flushes,
            "carried_outcomes": len(cpu["outcomes"]),
            "attempts_replayed": len(cpu["logs"]),
            "flush_stats": cpu["stats"],
            "rpc_async_post_launches": n_post,
            "rpc_async_collect_launches": n_coll}
        launches["rpc_async_post"] += n_post
        launches["rpc_async_collect"] += n_coll
        if not all(checks.values()):
            raise AssertionError(f"rpc_queue_async seed {seed}: {rec}")
    log({"rpc_queue_async": rec})
    return launches


def _deadline_case(dev):
    """A collect past ``shard_deadline`` on the card: the device stamps
    TIMEOUT across the window and raises the abandon flag, and the late
    drain stops before the failing idempotent record behind the slow one
    (never run, never carried), as on a CPU queue."""
    import numpy as np
    from repro_torch.core import RpcQueue, ShapeDtype
    from repro_torch.core.rpc import REGISTRY

    out = {}
    for label, device in (("card", dev), ("cpu", "cpu")):
        calls = []

        def slow(x, calls=calls):
            calls.append(("slow", int(x)))
            time.sleep(1.0)
            return np.int32(x) * 2

        def bad(x, calls=calls):
            calls.append(("bad", int(x)))
            raise RuntimeError("carried if reached")

        REGISTRY.register("smoke.dl_slow", slow)
        REGISTRY.register("smoke.dl_bad", bad, idempotent=True)
        i32 = ShapeDtype((), torch.int32)
        q = RpcQueue.create(4, width=1, reply_capacity=8, mode="async",
                            carry_budget=1, shard_deadline=0.2,
                            device=device)
        _, t0 = q.enqueue_ticketed("smoke.dl_slow", 3, returns=i32)
        _, t1 = q.enqueue_ticketed("smoke.dl_bad", 4, returns=i32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            q.flush()
            q.flush()
            state = q.state.cpu().clone()
            assert q.join(timeout=30)
            q.flush()
            assert q.join(timeout=30)
        out[label] = {"state": state, "calls": list(calls),
                      "outcomes": q.carry_outcomes(),
                      "statuses": q.statuses_host([int(t0), int(t1)])}
    ok = (torch.equal(out["card"]["state"], out["cpu"]["state"])
          and out["card"]["calls"] == out["cpu"]["calls"] == [("slow", 3)]
          and out["card"]["outcomes"] == out["cpu"]["outcomes"] == {}
          and out["card"]["statuses"] == out["cpu"]["statuses"])
    return {"window_stamped_timeout_equal_to_cpu": ok,
            "calls": out["card"]["calls"]}


def rpc_async_time_phase(card_line):
    """The two kernels alone on a ring of the ``rpc_queue`` geometry whose
    host side answers each epoch at once: device time of ``rpc_async_post``
    (the state's copy into the ring and the kernel) and of
    ``rpc_async_collect`` with the previous epoch already answered, each
    between CUDA events behind a device sleep (median of 50), beside their
    plain versions on the card (``post_reference``; ``collect_reference``
    with its host-to-device copy) and the bytes bound; then a deadline
    overrun on the card against a CPU queue.  Returns the two kernels'
    numbers for the kernels line."""
    import numpy as np
    from repro_torch.core import RpcQueue
    from repro_torch.kernels.rpc_async import (AsyncRing, collect_reference,
                                               post_reference,
                                               rpc_async_collect,
                                               rpc_async_post)
    from repro_torch.kernels.rpc_async.ref import H_CDEPTH

    dev = torch.device("cuda", 0)
    q = RpcQueue.create(**QUEUE_GEOMETRY, device=dev)
    L = q.layout
    out_words = L.words - L.out_start - H_CDEPTH
    answer = np.arange(out_words, dtype=np.int32)
    holder = {}

    def on_posted(epoch, words):
        holder["ring"].complete(epoch, answer)

    ring = holder["ring"] = AsyncRing(dev, L.in_end, out_words, on_posted)
    cycles = _busy_cycles(0.5)
    post_ms, coll_ms = [], []
    saved = (rpc_async_post.launches, rpc_async_collect.launches)
    for _ in range(51):
        epoch = ring.issue()
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(cycles)
        a.record()
        rpc_async_post(ring, epoch, q.state, L.out_start, True)
        b.record()
        rpc_async_collect(ring, epoch, q.state, L.out_start, L.rslots,
                          L.reply_capacity, None)
        c.record()
        torch.cuda.synchronize()
        assert ring.wait_ingested(timeout=10)
        if epoch > 1:                    # the first collect waits for none
            post_ms.append(a.elapsed_time(b))
            coll_ms.append(b.elapsed_time(c))
    installed = q.state[L.out_start + H_CDEPTH:].cpu().numpy()
    ring.close()
    rpc_async_post.launches, rpc_async_collect.launches = saved
    # the plain versions on the card
    h = q.state[L.out_start:]
    timer = Timer(iters=50)
    plain_post = timer(lambda: post_reference(h, True))
    plain_coll = timer(lambda: collect_reference(
        h, torch.from_numpy(answer).to(dev)))
    link = pcie_link()
    in_bytes, out_bytes = 4 * L.in_end, 4 * out_words
    post_bytes = 2 * in_bytes + 2 * 4 * H_CDEPTH
    coll_bytes = 2 * out_bytes
    rec = {
        "card": card_line, "geometry": QUEUE_GEOMETRY,
        "installed_equals_answer": bool(np.array_equal(installed, answer)),
        "rpc_async_post": {
            "ms": _median(post_ms), "plain_ms": plain_post,
            "bound_ms": post_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_bytes": post_bytes,
            "link_bound_ms": in_bytes / link["bytes_per_s"] * 1e3},
        "rpc_async_collect": {
            "ms": _median(coll_ms), "plain_ms": plain_coll,
            "bound_ms": coll_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_bytes": coll_bytes,
            "link_bound_ms": out_bytes / link["bytes_per_s"] * 1e3},
        "deadline": _deadline_case(dev)}
    log({"rpc_async_time": rec})
    if not (rec["installed_equals_answer"]
            and rec["deadline"]["window_stamped_timeout_equal_to_cpu"]):
        raise AssertionError(f"rpc_async_time: {rec}")
    return {k: dict(rec[k], max_abs_err=0.0, bound_by="bytes",
                    library_ms=None)
            for k in ("rpc_async_post", "rpc_async_collect")}


def device_run_async_phase():
    """``device_run`` with an async queue against the sync one in the same
    run, each under ``set_sync_debug_mode("error")``: 1000 steps of a
    (256,) state with a batched hook every step (one epoch, flushed at the
    boundary: the async run's two boundary flushes are one launch of each
    kernel each), then 1000 steps of a 64M-float state whose step flushes
    the threaded queue every 100 steps (a sync flush holds the stream for
    its drain; an async one hands it over).  Values in order, final state
    exact, launches exact, loop and device ms.  Returns the launches of
    each async kernel."""
    from repro_torch.core import HostHook, device_run, effects_barrier
    from repro_torch.core.rpc import REGISTRY
    from repro_torch.kernels.rpc_async import (rpc_async_collect,
                                               rpc_async_post)
    from repro_torch.kernels.rpc_channel import rpc_post

    dev = torch.device("cuda", 0)
    steps, rec = 1000, {}
    launches = {"rpc_async_post": 0, "rpc_async_collect": 0}
    for case, width in (("batched_every_1", 256),
                        ("thread_flush_every_100", 64 << 20)):
        for mode in ("sync", "async"):
            seen = []
            name = f"smoke.async_{case}_{mode}"
            kw = {}
            if case == "batched_every_1":
                kw["hooks"] = [HostHook(
                    every=1, extract=lambda i, s: s[:256].sum(),
                    host_fn=lambda i, v, seen=seen: seen.append(
                        (i, float(v))), name=name, batched=True)]
                step = (lambda i, s: s + 1.0)
                want = [(i, 256.0 * i) for i in range(1, steps + 1)]
                flushes = 2 if mode == "async" else 1
            else:
                REGISTRY.register(name, lambda i, v, seen=seen: seen.append(
                    (i, float(v))))

                def step(i, s, q, name=name):
                    s = s + 1.0
                    q.enqueue(name, i, s[:256].sum())
                    if (i + 1) % 100 == 0:
                        q.flush()
                    return s, q

                kw["thread_queue"] = True
                want = [(i, 256.0 * (i + 1)) for i in range(steps)]
                flushes = steps // 100 + (2 if mode == "async" else 1)
            state = torch.zeros(width, device=dev)
            effects_barrier()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            # main path: counts from 0 just before, read just after
            rpc_async_post.launches = rpc_async_collect.launches = 0
            rpc_post.launches = 0
            t0 = time.perf_counter()
            a.record()
            with sync_errors():
                final = device_run(step, state, steps,
                                   queue_async=mode == "async", **kw)
            loop_ms = (time.perf_counter() - t0) * 1e3
            b.record()
            effects_barrier()
            torch.cuda.synchronize()
            n = (rpc_async_post.launches, rpc_async_collect.launches,
                 rpc_post.launches)
            expect = (flushes, flushes, 0) if mode == "async" else \
                (0, 0, flushes)
            r = rec.setdefault(case, {})[mode] = {
                "steps": steps, "state_floats": width, "flushes": flushes,
                "launches_post_collect_rpc_post": list(n),
                "values_in_order": seen == want,
                "final_ok": bool((final == steps).all()),
                "python_loop_ms": loop_ms, "device_ms": a.elapsed_time(b)}
            if mode == "async":
                launches["rpc_async_post"] += n[0]
                launches["rpc_async_collect"] += n[1]
            del state, final
            if not (n == expect and r["values_in_order"] and r["final_ok"]):
                raise AssertionError(f"device_run async {case} {mode}: {r}")
    rec["immediate_beside_async"] = beside = _immediate_beside_async(dev)
    launches["rpc_async_post"] += beside["rpc_async_post_launches"]
    launches["rpc_async_collect"] += beside["rpc_async_collect_launches"]
    log({"device_run_async": rec})
    return launches


def _immediate_beside_async(dev):
    """200 steps whose step enqueues a record on the async queue and
    flushes it every 10 steps (a callee that sleeps 0.5 ms a record, so
    each epoch's drain runs for 5 ms on the queue's thread), with an
    immediate hook every 10 steps on the RPC channel's thread, under a
    ``faulthandler`` watchdog (a deadlock between the two drains ends the
    run) and ``set_sync_debug_mode("error")``: both callees' values in
    order, one ``rpc_post`` a firing, one launch of each async kernel a
    flush (20 in the loop and 2 at the boundary)."""
    import faulthandler
    from repro_torch.core import HostHook, device_run, effects_barrier
    from repro_torch.core.rpc import REGISTRY
    from repro_torch.kernels.rpc_async import (rpc_async_collect,
                                               rpc_async_post)
    from repro_torch.kernels.rpc_channel import rpc_post

    steps, every = 200, 10
    drained, fired = [], []

    def slow_sink(i, v):
        time.sleep(0.0005)
        drained.append((i, float(v)))

    REGISTRY.register("smoke.beside_sink", slow_sink)
    hook = HostHook(every=every, extract=lambda i, s: s[:256].sum(),
                    host_fn=lambda i, v: fired.append((i, float(v))),
                    name="smoke.beside_hook")

    def step(i, s, q):
        s = s + 1.0
        q.enqueue("smoke.beside_sink", i, s[:256].sum())
        if (i + 1) % every == 0:
            q.flush()
        return s, q

    state = torch.zeros(256, device=dev)
    effects_barrier()
    torch.cuda.synchronize()
    # main path: counts from 0 just before, read just after
    rpc_async_post.launches = rpc_async_collect.launches = 0
    rpc_post.launches = 0
    faulthandler.dump_traceback_later(GIL_WATCHDOG_S, exit=True)
    try:
        t0 = time.perf_counter()
        with sync_errors():
            final = device_run(step, state, steps, hooks=[hook],
                               thread_queue=True, queue_async=True)
        effects_barrier()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        faulthandler.cancel_dump_traceback_later()
    flushes = steps // every + 2
    rec = {"steps": steps, "wall_ms": wall_ms,
           "rpc_post_launches": rpc_post.launches,
           "rpc_async_post_launches": rpc_async_post.launches,
           "rpc_async_collect_launches": rpc_async_collect.launches,
           "async_values_in_order": drained == [
               (i, 256.0 * (i + 1)) for i in range(steps)],
           "immediate_values_in_order": fired == [
               (s, 256.0 * s) for s in range(every, steps + 1, every)],
           "final_ok": bool((final == steps).all())}
    if not (rec["async_values_in_order"] and rec["immediate_values_in_order"]
            and rec["final_ok"] and rpc_post.launches == steps // every
            and rpc_async_post.launches == rpc_async_collect.launches
            == flushes):
        raise AssertionError(f"immediate beside async: {rec}")
    return rec


def host_pipeline_phase():
    """``make_host_pipeline`` on the card: ``device_run`` over 16 batches
    (an (8, 512) int32 token block and a (1024,) fp32 vector each) fetched
    from a host iterator through the RPC channel (one ``rpc_post`` a
    fetch, a prefetch thread staging 4) under
    ``set_sync_debug_mode("error")``; the device's sums equal the host's.
    Returns the rpc_post launches."""
    import numpy as np
    from repro_torch.core import ShapeDtype, device_run, effects_barrier
    from repro_torch.data.pipeline import make_host_pipeline
    from repro_torch.kernels.rpc_channel import rpc_post

    dev = torch.device("cuda", 0)
    n = 16

    def batches():
        rng = np.random.default_rng(16)
        while True:
            yield {"tokens": rng.integers(0, 152064, (8, 512)),
                   "x": rng.standard_normal(1024).astype(np.float32)}

    ref = batches()
    want_tok = want_x = 0.0
    for _ in range(n):
        b = next(ref)
        want_tok += int(b["tokens"].sum())
        want_x += float(b["x"].astype(np.float64).sum())
    fetch = make_host_pipeline(
        batches(), {"tokens": ShapeDtype((8, 512), torch.int32),
                    "x": ShapeDtype((1024,), torch.float32)},
        prefetch=4, device=dev)

    def step(i, s):
        b = fetch(i)
        return {"tok": s["tok"] + b["tokens"].sum(dtype=torch.int64),
                "x": s["x"] + b["x"].sum(dtype=torch.float64)}

    state = {"tok": torch.zeros((), dtype=torch.int64, device=dev),
             "x": torch.zeros((), dtype=torch.float64, device=dev)}
    effects_barrier()
    torch.cuda.synchronize()
    # main path: counts from 0 just before, read just after
    rpc_post.launches = 0
    t0 = time.perf_counter()
    with sync_errors():
        final = device_run(step, state, n)
    loop_ms = (time.perf_counter() - t0) * 1e3
    effects_barrier()
    fetch.stop()
    posts = rpc_post.launches
    rec = {"batches": n, "rpc_post_launches": posts,
           "tokens_sum_equal": int(final["tok"]) == want_tok,
           "x_sum_close": abs(float(final["x"]) - want_x) <= 1e-3,
           "python_loop_ms": loop_ms}
    log({"host_pipeline": rec})
    if not (posts == n and rec["tokens_sum_equal"] and rec["x_sum_close"]):
        raise AssertionError(f"host_pipeline: {rec}")
    return posts


# ---------------------------------------------------------------------------
# The page spill, the sanitizer, the allocators and events
# ---------------------------------------------------------------------------

def _spill_engine_run(model, params, prompts, max_new, max_len, sink,
                      releases, **kw):
    """A spill engine on ``prompts``, run to the end; ``releases`` gets
    the page table, lengths and mask at each release (snapshots on the
    card; a sink reads its length to know its tick).  Returns the engine,
    the request ids, the flushes ``_deliver_spills`` made and the seconds
    it took."""
    from repro_torch.serving import kvcache
    from repro_torch.serving.engine import ServingEngine

    release = kvcache.release_slots

    def recording(kv, mask):
        releases.append((kv.page_table.clone(), kv.lengths.clone(),
                         mask.clone()))
        return release(kv, mask)

    engine = ServingEngine(model, params, batch_slots=4, page_size=16,
                           max_len=max_len, device="cuda", spill_sink=sink,
                           **kw)
    rids = [engine.submit(p, max_new=max_new) for p in prompts]
    flushes = [0]
    flush = engine.spill_q.flush

    def counted(*a, **k):
        flushes[0] += 1
        return flush(*a, **k)

    engine.spill_q.flush = counted
    kvcache.release_slots = recording
    try:
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        kvcache.release_slots = release
    return engine, rids, flushes[0], dt


def _spill_counts():
    from repro_torch.kernels.rpc_async import (rpc_async_collect,
                                               rpc_async_post)
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.rpc_queue import rpc_enqueue
    return {"rpc_enqueue": rpc_enqueue.launches,
            "rpc_async_post": rpc_async_post.launches,
            "rpc_async_collect": rpc_async_collect.launches,
            "rpc_post": rpc_post.launches}


def serve_spill_phase(model, params, prompts, max_new, max_len, streams):
    """llama3.2-3b at full width and depth (``serve``'s model, traffic and
    engine geometry) with a page-spill sink on the engine's async queue.
    Gates: the greedy streams equal ``serve``'s; each spill's pages are
    the slot's page-table prefix just before its release and its
    ``n_tokens`` is prompt + generated - 1; each ack is its page count;
    the launches are exact: one ``rpc_enqueue`` a request, one
    ``rpc_async_post`` and one ``rpc_async_collect`` a flush that
    ``_deliver_spills`` makes (two a tick that retires requests; under
    ``spill_retries=2`` one more a tick whose carried record still read
    PENDING after the collect, which depends on whether its redrive had
    finished), no ``rpc_post``.  Then a flaky sink (the first
    call of each odd request raises; ``spill_retries=2``) acks every
    request and leaves its failures in ``error_log()``, and a dead sink
    leaves every request in ``recompute_on_readmit`` with a None ack (both
    on five short requests).  ms/tick and tok/s beside an engine without
    a sink on the same traffic, run just before it.  Returns the main
    path's launches."""
    from repro_torch.core import clear_error_log, error_log
    from repro_torch.kernels import rpc_async, rpc_channel, rpc_queue
    from repro_torch.serving.engine import ServingEngine

    def reset():
        rpc_queue.rpc_enqueue.launches = 0
        rpc_async.rpc_async_post.launches = 0
        rpc_async.rpc_async_collect.launches = 0
        rpc_channel.rpc_post.launches = 0

    def no_sink():
        plain = ServingEngine(model, params, batch_slots=4, page_size=16,
                              max_len=max_len, device="cuda")
        for p in prompts:
            plain.submit(p, max_new=max_new)
        t0 = time.perf_counter()
        ticks = 0
        while plain.queue or any(s.request_id >= 0 for s in plain.slots):
            plain.step()
            ticks += 1
        torch.cuda.synchronize()
        return plain, ticks, time.perf_counter() - t0

    t_phase = time.perf_counter()
    plain, ticks, plain_s = no_sink()

    calls = []
    releases = []

    def sink(rid, n_tokens, pages):
        calls.append((len(releases), int(rid), int(n_tokens),
                      pages.tolist()))

    # main path: counts from 0 just before, read just after
    reset()
    engine, rids, n_flush, spill_s = _spill_engine_run(
        model, params, prompts, max_new, max_len, sink, releases)
    launches = _spill_counts()
    n_tok = sum(len(v) for v in engine.finished.values())
    page_ok, tokens_ok = True, True
    for k, (table, lengths, mask) in enumerate(releases):
        slots = mask.nonzero().flatten().tolist()
        mine = [c for c in calls if c[0] == k]
        table, lengths = table.cpu(), lengths.cpu()
        for slot, (_, rid, n, pages) in zip(slots, mine):
            want = table[slot, :-(-int(lengths[slot]) // 16)].tolist()
            page_ok &= pages == want and n == int(lengths[slot])
            tokens_ok &= n == len(prompts[rid]) + max_new - 1
        page_ok &= len(slots) == len(mine)
    flushes = 2 * len(releases)
    checks = {
        "streams_equal_serve": engine.finished == streams
        and plain.finished == streams,
        "one_spill_a_request": sorted(c[1] for c in calls) == rids,
        "pages_are_the_page_table_prefix": page_ok,
        "n_tokens_prompt_plus_generated_minus_1": tokens_ok,
        "acks_are_page_counts": engine.spill_acks == {
            c[1]: len(c[3]) for c in calls},
        "nothing_to_recompute": engine.recompute_on_readmit == set(),
        "one_enqueue_a_request": launches["rpc_enqueue"] == len(rids),
        "two_flushes_a_retiring_tick": launches["rpc_async_post"]
        == launches["rpc_async_collect"] == n_flush == flushes,
        "no_rpc_post": launches["rpc_post"] == 0,
    }
    rec = {"checks": checks, "requests": len(rids), "ticks": ticks,
           "retiring_ticks": len(releases), "launches": launches,
           "spill": {"seconds": spill_s, "ms_per_tick": spill_s / ticks * 1e3,
                     "tok_per_s": n_tok / spill_s},
           "no_sink": {"seconds": plain_s,
                       "ms_per_tick": plain_s / ticks * 1e3,
                       "tok_per_s": n_tok / plain_s}}

    short = prompts[1:6]
    frel, drel, attempts = [], [], []

    def flaky(rid, n_tokens, pages):
        rid = int(rid)
        n = 1 + sum(r == rid for _, r in attempts)
        attempts.append((len(frel), rid))
        if rid % 2 and n == 1:
            raise RuntimeError(f"spill store hiccup, request {rid}")

    def dead(rid, n_tokens, pages):
        raise RuntimeError("spill store down")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        clear_error_log()
        reset()
        eng, frids, f_flush, _ = _spill_engine_run(
            model, params, short, 4, max_len, flaky, frel, spill_retries=2)
        fl = _spill_counts()
        errs = [e for e in error_log() if e["callee"] == "kvcache.spill"]
        reset()
        deng, drids, d_flush, _ = _spill_engine_run(
            model, params, short, 4, max_len, dead, drel, spill_retries=1)
        dl = _spill_counts()
    odd = [r for r in frids if r % 2]
    # a retiring tick with an odd request grants its carry one more flush
    carried_ticks = len({k for k, r in attempts if r % 2})
    checks.update({
        "flaky_every_rid_acked": set(eng.spill_acks) == set(frids)
        and all(v is not None for v in eng.spill_acks.values())
        and eng.recompute_on_readmit == set(),
        "flaky_retried_once_each": sorted(r for _, r in attempts)
        == sorted(frids + odd),
        "flaky_failures_in_error_log": len(errs) == len(odd),
        "flaky_launches": fl["rpc_enqueue"] == len(frids)
        and fl["rpc_async_post"] == fl["rpc_async_collect"] == f_flush
        and 2 * len(frel) <= f_flush <= 2 * len(frel) + carried_ticks,
        "dead_sink_recompute": deng.recompute_on_readmit == set(drids)
        and deng.spill_acks == {r: None for r in drids},
        "dead_launches": dl["rpc_enqueue"] == len(drids)
        and dl["rpc_async_post"] == dl["rpc_async_collect"] == d_flush
        == 2 * len(drel),
        "short_streams_unaffected": deng.finished == eng.finished,
    })
    rec.update({"flaky_launches": fl, "dead_launches": dl,
                "flaky_flushes": f_flush, "flaky_carried_ticks": carried_ticks,
                "flaky_errors": len(errs),
                "phase_seconds": time.perf_counter() - t_phase})
    log({"serve_spill": rec})
    if not all(checks.values()):
        raise AssertionError(f"serve_spill: {rec}")
    return launches


#: The sanitizer's plans: rpc_queue's, on an arena large enough that
#: neither a sanitized nor a plain queue drops at it (a canary-bracketed
#: reservation takes 2 more words, so drops there would differ by design).
SAN_GEOMETRY = dict(QUEUE_GEOMETRY, payload_capacity=8192)


def _san_plan_run(plan, q, logs, twin=None):
    """Enqueue ``plan`` on ``q`` (flush every QUEUE_FLUSH_EVERY records
    and at the end; an async queue once more to collect the tail).  With
    ``twin`` (a queue of the same kind on the card) each record also goes
    through ``enqueue_reference`` there and both states are kept after
    every enqueue.  Returns the tickets, the reply regions after each
    flush and the per-enqueue state pairs (clones)."""
    from repro_torch.kernels.rpc_queue import enqueue_reference
    logged = _queue_callees()
    L = q.layout
    tickets, replies, pairs = [], [], []
    n = len(plan)
    for k, (name, args, returns, where) in enumerate(plan):
        _, t = q.enqueue_ticketed(name, *args, returns=returns, where=where)
        tickets.append(t)
        if twin is not None:
            enqueue_reference(twin.lanes(), twin.record(name, args, returns,
                                                        where))
            pairs.append((q.state.clone(), twin.state.clone()))
        if (k + 1) % QUEUE_FLUSH_EVERY == 0 or k + 1 == n:
            q.flush(logged(logs))
            if twin is not None:
                twin.state.copy_(q.state)
            replies.append(q.state[L.out_start:].clone())
    if q.mode == "async":
        q.flush(logged(logs))
        replies.append(q.state[L.out_start:].clone())
    return tickets, replies, pairs


def _san_faults(dev):
    """The three seeded faults on the card, each alone: a trailing canary
    overwritten on the device (``canary_stomps``), a payload copied from
    a block freed by ``poison_free`` (``poison_hits``) and an ArenaRef to
    a freed pointer through ``rpc_call`` (``uaf_marshals``).  Returns
    each fault's counters."""
    import numpy as np
    from repro_torch.analysis import poison_free
    from repro_torch.core import (READ, ArenaRef, GenericAllocator,
                                  RpcQueue, ShapeDtype, effects_barrier,
                                  reset_sanitize_stats, rpc_call,
                                  sanitize_stats)
    from repro_torch.core.rpc import REGISTRY

    REGISTRY.register("smoke.san_rec", lambda *a: None)
    REGISTRY.register("smoke.san_probe",
                      lambda ptr, base, size, found, arena: np.int32(found))
    keys = ("canary_stomps", "poison_hits", "uaf_marshals")
    out = {}

    def counted(label, fn):
        effects_barrier()
        reset_sanitize_stats()
        with sync_errors():
            fn()
        effects_barrier()
        st = sanitize_stats()
        out[label] = {k: st[k] for k in keys}

    def stomp():
        q = RpcQueue.create(8, 4, 64, sanitize=True, device=dev)
        q.enqueue("smoke.san_rec", torch.arange(4, dtype=torch.int32,
                                                device=dev))
        q.pbuf[5].fill_(7)        # the 4-word payload's trailing canary
        q.flush()

    def poison():
        st = GenericAllocator.init(64, cap=8, device=dev)
        buf = torch.arange(64, dtype=torch.int32, device=dev)
        st, p = GenericAllocator.malloc(st, 8)
        st, buf = poison_free(GenericAllocator, st, buf, p)
        stale = buf.index_select(0, p.long() + torch.arange(8, device=dev))
        q = RpcQueue.create(8, 4, 64, sanitize=True, device=dev)
        q.enqueue("smoke.san_rec", stale).flush()

    def uaf():
        st = GenericAllocator.init(64, cap=8, device=dev)
        st, p = GenericAllocator.malloc(st, 8)
        st = GenericAllocator.free(st, p)
        rpc_call("smoke.san_probe", ArenaRef(
            torch.zeros(64, dtype=torch.int32, device=dev), p, st,
            access=READ), result_shape=ShapeDtype((), torch.int32))

    counted("canary_stomp", stomp)
    counted("poison_free_then_marshal", poison)
    counted("freed_arena_ref", uaf)
    return out


def sanitizer_phase(card_line):
    """The transport's sanitizer on the card.  ``rpc_queue``'s three plans
    (on ``SAN_GEOMETRY``) on sanitized sync and async card queues (the
    main path, under ``set_sync_debug_mode("error")``), each record also
    through ``enqueue_reference`` with ``sanitize`` on the card, then on
    unsanitized card queues and on sanitized CPU queues.  Gates: the
    state after every enqueue bit-equal to the plain version's (canaries
    included); the replay logs, tickets and reply regions (heads, window,
    offsets, lengths, statuses, replies) after every flush bit-equal to
    the unsanitized run's and the CPU's; the counters zero and the epoch
    records equal to the CPU run's; one ``rpc_enqueue`` a record.  Then
    the three seeded faults each count once.  Times: ``rpc_enqueue``
    sanitized against plain (device us behind a sleep) at a scalar
    record, 1 KB and 64 KB, and the host pre-check of a 1024-record
    flush.  Returns (sanitized ``rpc_enqueue`` launches, async kernels'
    launches)."""
    from repro_torch.core import (RpcQueue, effects_barrier,
                                  reset_sanitize_stats, sanitize_stats)
    from repro_torch.kernels.rpc_async import (rpc_async_collect,
                                               rpc_async_post)
    from repro_torch.kernels.rpc_queue import rpc_enqueue

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    zero = ("canary_stomps", "poison_hits", "uaf_marshals",
            "stale_ticket_reads", "failed_ticket_reads")
    rec, launches = {}, 0
    async_launches = {"rpc_async_post": 0, "rpc_async_collect": 0}
    for mode in ("sync", "async"):
        for seed in QUEUE_SEEDS:
            plan = _queue_plan(dev, seed, QUEUE_RECORDS)
            card = [(n, c, r, wk) for n, c, _, r, wk, _ in plan]
            cpu = [(n, c, r, wc) for n, _, c, r, _, wc in plan]
            runs = {}
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for label, sub, san, where in (
                        ("san", card, True, dev), ("plain", card, False, dev),
                        ("cpu", cpu, True, "cpu")):
                    q = RpcQueue.create(**SAN_GEOMETRY, mode=mode,
                                        sanitize=san, device=where)
                    twin = (RpcQueue.create(**SAN_GEOMETRY, mode=mode,
                                            sanitize=True, device=dev)
                            if label == "san" else None)
                    logs = []
                    effects_barrier()
                    reset_sanitize_stats()
                    if label == "san":
                        # main path: counts from 0 just before, read after
                        rpc_enqueue.launches = 0
                        rpc_async_post.launches = 0
                        rpc_async_collect.launches = 0
                        with sync_errors():
                            out = _san_plan_run(sub, q, logs, twin)
                        n_enq = rpc_enqueue.launches
                        n_post = rpc_async_post.launches
                        n_coll = rpc_async_collect.launches
                    else:
                        out = _san_plan_run(sub, q, logs)
                    assert q.join(timeout=60)
                    effects_barrier()
                    tickets, replies, pairs = out
                    runs[label] = {"tickets": [int(t) for t in tickets],
                                   "replies": [r.cpu() for r in replies],
                                   "pairs": pairs, "logs": logs,
                                   "stats": sanitize_stats()}
                    del q, twin
            san, plain, cpu_run = runs["san"], runs["plain"], runs["cpu"]
            flushes = len(san["replies"])
            checks = {
                "arena_vs_plain_version_every_enqueue": all(
                    _equal_states(a, b) for a, b in san["pairs"]),
                "canaries_written": all(
                    bool((a == 0x7FC0FFEE).any()) for a, _ in
                    san["pairs"][-1:]),
                "tickets": san["tickets"] == plain["tickets"]
                == cpu_run["tickets"],
                "records_as_unsanitized_and_cpu": san["logs"]
                == plain["logs"] == cpu_run["logs"] and bool(san["logs"]),
                "replies_statuses_as_unsanitized_and_cpu": all(
                    torch.equal(a, b) and torch.equal(a, c)
                    for a, b, c in zip(san["replies"], plain["replies"],
                                       cpu_run["replies"])),
                "counters_zero": all(san["stats"][k] == 0 for k in zero),
                "epochs_as_cpu": san["stats"]["epochs"]
                == cpu_run["stats"]["epochs"]
                and len(san["stats"]["epochs"]) == flushes,
                "plain_run_no_epochs": plain["stats"]["epochs"] == [],
                "one_enqueue_launch_a_record": n_enq == len(plan),
            }
            if mode == "async":
                checks["one_post_and_collect_a_flush"] = \
                    n_post == n_coll == flushes
                async_launches["rpc_async_post"] += n_post
                async_launches["rpc_async_collect"] += n_coll
            rec[f"{mode}_seed_{seed}"] = {
                "checks": checks, "records": len(plan), "flushes": flushes,
                "epochs": len(san["stats"]["epochs"]),
                "payloads_checked": sum(e["payloads_checked"]
                                        for e in san["stats"]["epochs"]),
                "rpc_enqueue_launches": n_enq}
            launches += n_enq
            if not all(checks.values()):
                raise AssertionError(f"sanitizer {mode} seed {seed}: "
                                     f"{rec[f'{mode}_seed_{seed}']}")
    faults = _san_faults(dev)
    want = {"canary_stomp": "canary_stomps",
            "poison_free_then_marshal": "poison_hits",
            "freed_arena_ref": "uaf_marshals"}
    fault_ok = all(v == {k: int(k == want[f]) for k in v}
                   for f, v in faults.items())
    rec["seeded_faults"] = faults
    rec["times"] = _san_times(dev)
    rec["phase_seconds"] = time.perf_counter() - t_phase
    log({"sanitizer": rec, "card": card_line})
    if not fault_ok:
        raise AssertionError(f"sanitizer seeded faults: {faults}")
    return launches, async_launches


def _san_times(dev):
    """``rpc_enqueue`` device and host us, sanitized and plain, at a
    scalar record, 1 KB and 64 KB (behind a device sleep); the host
    pre-check of a 1024-record flush and the drain's Python for it,
    sanitized and plain (median of 5)."""
    from repro_torch.core import RpcQueue, effects_barrier
    from repro_torch.core.rpc import REGISTRY, _san_precheck
    from repro_torch.kernels.rpc_channel import channel_for

    REGISTRY.register("smoke.q_sink", lambda *a: None)
    out = {}
    for label, words in (("scalar_w4", 0), ("payload_1KB", 256),
                         ("payload_64KB", 16384)):
        n = 200 if words <= 256 else 50
        args = ([1, 2.5, torch.tensor(3, dtype=torch.int32, device=dev),
                 torch.tensor(0.25, device=dev)] if not words else
                [7, torch.randn(words, device=dev)])
        arena = max(1, (3 + 3 * n) * (words + 2))
        row = {}
        for san in (False, True):
            q = RpcQueue.create(max(n, 64), 4, arena, sanitize=san,
                                device=dev)
            t = _behind_busy(lambda: q.enqueue("smoke.q_sink", *args), n)
            kept = int(q.adrops) == 0
            row["sanitized" if san else "plain"] = dict(t, all_kept=kept)
            if not (t["host_hidden"] and kept):
                raise AssertionError(f"sanitizer times {label}: {t}")
            del q
        out[label] = row
    REGISTRY.register("smoke.q_full", lambda i, x, p: None)
    chan = channel_for(dev)
    payload = torch.arange(4, dtype=torch.int32, device=dev)
    flush = {}
    for san in (False, True):
        q = RpcQueue.create(1024, 4, 8192, sanitize=san, device=dev)
        serve, pre = [], []
        for _ in range(6):
            for i in range(1024):
                q.enqueue("smoke.q_full", i, 0.5, payload)
            L = q.layout
            words = q.state[:L.in_end].cpu().numpy()
            if san:
                t0 = time.perf_counter()
                _san_precheck(L.views(words), 0)
                pre.append((time.perf_counter() - t0) * 1e6)
            q.flush()
            effects_barrier()
            serve.append(chan.last_serve_ns * 1e-3)
        flush["sanitized" if san else "plain"] = {
            "drain_python_us": _median(serve[1:])}
        if san:
            flush["precheck_host_us"] = _median(pre[1:])
        del q
    out["flush_1024_records"] = flush
    return out


#: The size-class heaps of the allocators phase: (heap words, entries).
SIZECLASS_GEOMETRIES = ((1 << 20, 4096), (1 << 24, 65536))


def _states(*sts):
    """Every tensor field of allocator states, cloned."""
    out = []
    for st in sts:
        inner = getattr(st, "shards", st)
        out += [getattr(inner, f.name).clone()
                for f in dataclasses.fields(inner)
                if isinstance(getattr(inner, f.name), torch.Tensor)]
    return out


def _sizeclass_churn(dev, heap, cap, seed, n_ops=24):
    """A seeded churn on a size-class heap on ``dev``: bulk malloc_many and
    free_many, single malloc and free, coalesce and find_obj.  Which
    handles an op frees is drawn on the host; the pointers stay on the
    device (a handle is a slice of an earlier result).  Returns a closure
    that runs it (every tensor it needs made first, so the run copies
    nothing to the device) and returns the results and states after
    every op (clones)."""
    import numpy as np
    from repro_torch.core import SizeClassAllocator as A

    rng = np.random.default_rng(seed)
    big = max(heap // 64, 2)
    st0 = A.init(heap, cap=cap, device=dev)
    ar = torch.arange(32, dtype=torch.int32, device=dev)
    plan, n_handles = [], 0
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.3 or not n_handles:
            k = int(rng.integers(1, 33))
            plan.append(("malloc_many", k, int(rng.integers(1, big))))
            n_handles += k
        elif r < 0.5:
            plan.append(("free_many", sorted(set(rng.integers(
                0, n_handles, int(rng.integers(1, 9))).tolist()))))
        elif r < 0.7:
            plan.append(("malloc", int(rng.integers(1, big))))
            n_handles += 1
        elif r < 0.85:
            plan.append(("free", int(rng.integers(n_handles))))
        elif r < 0.93:
            plan.append(("coalesce",))
        else:
            plan.append(("find_obj", int(rng.integers(n_handles)),
                         int(rng.integers(0, 3))))

    def go():
        st, handles, trail = st0, [], []
        for op, *a in plan:
            out = []
            if op == "malloc_many":
                st, ptrs = A.malloc_many(st, ar[:a[0]] + a[1])
                handles += [ptrs[j:j + 1] for j in range(a[0])]
                out = [ptrs]
            elif op == "free_many":
                st = A.free_many(st, torch.cat([handles[j] for j in a[0]]))
            elif op == "malloc":
                st, p = A.malloc(st, a[0])
                handles.append(p.reshape(1))
                out = [p]
            elif op == "free":
                st = A.free(st, handles[a[0]][0])
            elif op == "coalesce":
                st = A.coalesce(st)
            else:
                out = list(A.find_obj(st, handles[a[0]][0] + a[1]))
            trail.append([o.clone() for o in out] + _states(st))
        return trail

    return go


def _page_heap_churn(dev, seed, n_ops=12):
    """The engine's page heap geometry (4 slots x 32 pages: 512 tokens at
    page 16): malloc_grid and malloc_grid_scan of (4, 1) page requests,
    free_grid and free_grid_scan of earlier pages, reset_chunks.  Returns
    a closure, as :func:`_sizeclass_churn`."""
    import numpy as np
    from repro_torch.core import BalancedAllocator as A

    rng = np.random.default_rng(seed)
    st0 = A.init(128, 4, 1, cap=32, first_chunk_ratio=1.0, device=dev)
    plan, grids = [], 0
    for _ in range(n_ops):
        r = rng.random()
        need = torch.from_numpy(rng.random((4, 1)) < 0.7).to(dev)
        if r < 0.55 or not grids:
            plan.append(("malloc_grid" if r < 0.3 else "malloc_grid_scan",
                         need))
            grids += 1
        elif r < 0.85:
            plan.append(("free_grid" if r < 0.7 else "free_grid_scan",
                         int(rng.integers(grids))))
        else:
            plan.append(("reset_chunks", need.reshape(4)))

    def go():
        st, pages, trail = st0, [], []
        for op, arg in plan:
            out = []
            if op.startswith("malloc"):
                st, p = getattr(A, op)(st, 4, 1, arg.to(torch.int32))
                pages.append(p)
                out = [p]
            elif op.startswith("free"):
                st = getattr(A, op)(st, 4, 1, pages[arg])
            else:
                st = A.reset_chunks(st, arg)
            trail.append([o.clone() for o in out] + _states(st))
        return trail

    return go


def _sharded_churn(dev, seed, n_ops=10):
    """A 4-shard heap stacked on ``dev`` (balanced shards of 2**22 words in
    4 x 2 chunks): malloc_grid of (4, 8, 4) requests, free_grid,
    reset_chunks and find_obj of global pointers.  Returns a closure, as
    :func:`_sizeclass_churn`."""
    import numpy as np
    from repro_torch.core import (BalancedAllocator, ShardedAllocator as A,
                                  find_obj, shard_heap)

    rng = np.random.default_rng(seed)
    span = 1 << 22
    st0 = shard_heap(BalancedAllocator.init(span, 4, 2, cap=256,
                                            device=dev), 4, span=span)
    plan, grids = [], 0
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45 or not grids:
            plan.append(("malloc_grid", torch.from_numpy(rng.integers(
                -1, 4096, (4, 8, 4)).astype(np.int32)).to(dev)))
            grids += 1
        elif r < 0.7:
            plan.append(("free_grid", int(rng.integers(grids))))
        elif r < 0.85:
            plan.append(("reset_chunks", torch.from_numpy(
                rng.random((4, 8)) < 0.25).to(dev)))
        else:
            plan.append(("find_obj", (int(rng.integers(grids)),
                                      *(int(x) for x in rng.integers(
                                          0, (4, 8, 4))),
                                      int(rng.integers(0, 5)))))

    def go():
        st, gps, trail = st0, [], []
        for op, arg in plan:
            out = []
            if op == "malloc_grid":
                st, p = A.malloc_grid(st, 8, 4, arg)
                gps.append(p)
                out = [p]
            elif op == "free_grid":
                st = A.free_grid(st, 8, 4, gps[arg])
            elif op == "reset_chunks":
                st = A.reset_chunks(st, arg)
            else:
                g, d, i, j, off = arg
                out = list(find_obj(st, gps[g][d, i, j] + off))
            trail.append([o.clone() for o in out] + _states(st))
        return trail

    return go


def _alloc_op_times(dev):
    """Host and device us of one call of each operation (behind a device
    sleep), on heaps filled half way: the size-class ops at both
    geometries, the page heap's grid ops and the sharded heap's."""
    from repro_torch.core import (BalancedAllocator as B,
                                  ShardedAllocator as S,
                                  SizeClassAllocator as A, find_obj,
                                  shard_heap)

    def timed(fn):
        t = _behind_busy(fn, 1)
        return {"host_us": t["host_us"], "device_us": t["device_us"],
                "host_hidden": t["host_hidden"]}

    out = {}
    for heap, cap in SIZECLASS_GEOMETRIES:
        st = A.init(heap, cap=cap, device=dev)
        sizes = torch.full((cap // 2,), heap // cap, dtype=torch.int32,
                           device=dev)
        st, ptrs = A.malloc_many(st, sizes[:32])
        st, _ = A.malloc_many(st, sizes[32:64])
        st = A.free_many(st, ptrs[::2])
        k32 = torch.full((32,), 8, dtype=torch.int32, device=dev)
        out[f"sizeclass_cap{cap}"] = {
            "malloc": timed(lambda: A.malloc(st, 100)),
            "free": timed(lambda: A.free(st, ptrs[1])),
            "malloc_many_32": timed(lambda: A.malloc_many(st, k32)),
            "free_many_16": timed(lambda: A.free_many(st, ptrs[1::2])),
            "coalesce": timed(lambda: A.coalesce(st)),
            "find_obj": timed(lambda: find_obj(st, ptrs[3])),
        }
    pg = B.init(128, 4, 1, cap=32, first_chunk_ratio=1.0, device=dev)
    ones = torch.ones((4, 1), dtype=torch.int32, device=dev)
    for _ in range(8):
        pg, p = B.malloc_grid(pg, 4, 1, ones)
    out["page_heap"] = {
        "malloc_grid": timed(lambda: B.malloc_grid(pg, 4, 1, ones)),
        "malloc_grid_scan": timed(lambda: B.malloc_grid_scan(pg, 4, 1,
                                                             ones)),
        "free_grid": timed(lambda: B.free_grid(pg, 4, 1, p)),
        "free_grid_scan": timed(lambda: B.free_grid_scan(pg, 4, 1, p)),
    }
    span = 1 << 22
    sh = shard_heap(B.init(span, 4, 2, cap=256, device=dev), 4, span=span)
    req = torch.full((4, 8, 4), 64, dtype=torch.int32, device=dev)
    sh, gp = S.malloc_grid(sh, 8, 4, req)
    mask = torch.zeros((4, 8), dtype=torch.bool, device=dev)
    out["sharded_4x8_chunks"] = {
        "malloc_grid": timed(lambda: S.malloc_grid(sh, 8, 4, req)),
        "free_grid": timed(lambda: S.free_grid(sh, 8, 4, gp)),
        "reset_chunks": timed(lambda: S.reset_chunks(sh, mask)),
        "find_obj": timed(lambda: find_obj(sh, gp[2, 3, 1])),
    }
    return out


def allocators_phase(card_line):
    """The heaps on the card against the same sequences on CPU tensors,
    bit for bit after every operation, the card's run under
    ``set_sync_debug_mode("error")``: seeded size-class churns (bulk and
    single malloc and free, coalesce, find_obj) at ``cap`` 4096 (a 2**20
    word heap) and 65536 (2**24 words); the engine's page heap geometry
    through ``malloc_grid``, ``malloc_grid_scan``, ``free_grid``,
    ``free_grid_scan`` and ``reset_chunks``; and a 4-shard
    ``ShardedAllocator`` stacked on the card (``malloc_grid``,
    ``free_grid``, ``reset_chunks``, ``find_obj`` of global pointers).
    Then each operation's host and device us."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    runs = {f"sizeclass_cap{cap}": (
        lambda d, h=heap, c=cap: _sizeclass_churn(d, h, c, seed=c))
        for heap, cap in SIZECLASS_GEOMETRIES}
    runs["page_heap"] = lambda d: _page_heap_churn(d, seed=5)
    runs["sharded_4_shards"] = lambda d: _sharded_churn(d, seed=6)
    rec = {}
    for label, make in runs.items():
        go = make(dev)
        t0 = time.perf_counter()
        with sync_errors():
            card = go()
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        host = make(cpu)()
        equal = len(card) == len(host) and all(
            len(a) == len(b) and all(torch.equal(x.cpu(), y)
                                     for x, y in zip(a, b))
            for a, b in zip(card, host))
        rec[label] = {"ops": len(card), "bit_equal_to_cpu": equal,
                      "card_seconds": card_s}
        if not equal:
            raise AssertionError(f"allocators {label}: the card's states "
                                 "differ from the CPU's")
    rec["op_times"] = _alloc_op_times(dev)
    rec["phase_seconds"] = time.perf_counter() - t_phase
    log({"allocators": rec, "card": card_line})


def events_phase():
    """``events.record`` around a size-class churn, a sanitized queue's
    enqueues and flush, and a 10-step ``device_run`` with a batched and an
    immediate hook, on the card under ``set_sync_debug_mode("error")``
    (nothing may wait for the device) and on the CPU: the same event kinds
    and counts."""
    from collections import Counter

    from repro_torch.core import (HostHook, RpcQueue, device_run,
                                  effects_barrier, events)

    def program(dev, churn):
        churn()
        q = RpcQueue.create(16, 4, 256, reply_capacity=8, sanitize=True,
                            device=dev)
        q.enqueue("smoke.san_rec", 3, torch.arange(5, device=dev))
        q.enqueue_ticketed("smoke.san_rec", torch.ones((), device=dev),
                           returns=None)
        q.flush()
        hooks = [HostHook(every=2, extract=lambda s, st: st,
                          host_fn=lambda s, x: None, name="smoke.ev_b",
                          batched=True),
                 HostHook(every=5, extract=lambda s, st: st[0],
                          host_fn=lambda s, x: None, name="smoke.ev_i")]
        device_run(lambda s, st: st + 1, torch.zeros(4, device=dev), 10,
                   hooks=hooks)

    from repro_torch.core.rpc import REGISTRY
    t_phase = time.perf_counter()
    REGISTRY.register("smoke.san_rec", lambda *a: None)
    streams = {}
    for label, dev in (("card", torch.device("cuda", 0)),
                       ("cpu", torch.device("cpu"))):
        sink = []
        churn = _sizeclass_churn(dev, 1 << 16, 256, seed=3, n_ops=10)
        with events.record(sink):
            if label == "card":
                with sync_errors():
                    program(dev, churn)
            else:
                program(dev, churn)
        effects_barrier()
        streams[label] = sink
    counts = {k: Counter(e["kind"] for e in v) for k, v in streams.items()}
    kinds = {k: [e["kind"] for e in v] for k, v in streams.items()}
    ptrs_none = all(e.get("ptr") is None for e in streams["card"]
                    if "ptr" in e)
    rec = {"counts": dict(counts["card"]), "events": len(streams["card"]),
           "same_kinds_and_counts": counts["card"] == counts["cpu"],
           "same_order": kinds["card"] == kinds["cpu"],
           "card_ptrs_none": ptrs_none,
           "phase_seconds": time.perf_counter() - t_phase}
    log({"events": rec})
    if not (rec["same_kinds_and_counts"] and rec["same_order"]
            and ptrs_none):
        raise AssertionError(f"events: {rec}")


def _cuobjdump():
    """The toolkit's ``cuobjdump``, else the copy bundled with Triton."""
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = ["/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if os.path.exists(c)), None)


def _ptxas_entries(text: str) -> dict:
    """Registers, spill bytes (stores, loads) and static shared memory of
    each kernel in one ``nvcc -Xptxas -v`` report, by mangled name."""
    import re
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["static_smem_bytes"] = int(m.group(1)) if m else 0
            entry = None
    return out


def _ptxas_summary(text: str) -> dict:
    """Registers and spills of every kernel in one ``nvcc -Xptxas -v``
    report: the kernel count, the most registers any uses, and the kernels
    that spill (mangled name cut to 90 characters, spill store and load
    bytes)."""
    entries = _ptxas_entries(text)
    return {"kernels": len(entries),
            "max_registers": max((e.get("registers", 0)
                                  for e in entries.values()), default=0),
            "spilling": [[name[:90], *e["spill_bytes"]]
                         for name, e in entries.items()
                         if any(e.get("spill_bytes", (0, 0)))]}


def _sass_counts(name: str) -> dict:
    """HMMA and HGMMA instructions of each kernel in the SASS of
    ``csrc/<name>.cu``'s library (``cuobjdump -sass``), by mangled name;
    empty without ``cuobjdump``."""
    from repro_torch.kernels import _build
    tool = _cuobjdump()
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                          capture_output=True, text=True).stdout
    out = {}
    for func in sass.split("Function : ")[1:]:
        fname = func.split(None, 1)[0]
        out[fname] = {"hmma": func.count("HMMA"), "hgmma": func.count("HGMMA")}
    return out


def _kernel_report(name: str, ptxas_text: str, labels: dict,
                   dynamic_smem: dict) -> dict:
    """For each kernel of ``csrc/<name>.cu`` whose mangled name matches a
    regex in ``labels`` (label -> regex): registers, spills and static
    shared memory from ``ptxas -v``, dynamic shared memory
    (``dynamic_smem``, label -> bytes) and HMMA / HGMMA counts in its
    SASS."""
    import re
    entries, sass = _ptxas_entries(ptxas_text), _sass_counts(name)
    report = {}
    for label, rx in labels.items():
        for mangled, rec in entries.items():
            if re.search(rx, mangled):
                report[label] = dict(rec)
                report[label]["dynamic_smem_bytes"] = dynamic_smem.get(label, 0)
                report[label].update(sass.get(mangled) or
                                     {"hmma": "not counted: no cuobjdump"})
                break
    return report


def _wgmma_report(build_logs: dict) -> dict:
    """The tensor-core kernels: for each head dim of flash's wgmma variant
    and for the tensor-core decode (G > 8, D 256, and the parallel merge)
    and SSD kernels, registers, spills, shared memory and the HMMA /
    HGMMA instructions in their SASS."""
    import ctypes
    from repro_torch.kernels import _build
    flash = _build.load("flash_attention")
    flash.flash_attention_wgmma_smem.argtypes = [ctypes.c_int]
    decode = _build.load("decode_attention")
    decode.decode_attention_mma_smem.argtypes = [ctypes.c_int]
    ssd = _build.load("ssd_scan")
    ssd.ssd_scan_tc_smem.argtypes = [ctypes.c_int]
    heads = (64, 128, 256)
    return {
        "flash_attention": _kernel_report(
            "flash_attention", build_logs["flash_attention"],
            {f"D{d}": rf"flash_fwd_hopperILi{d}E" for d in heads},
            {f"D{d}": flash.flash_attention_wgmma_smem(d) for d in heads}),
        "decode_attention": _kernel_report(
            "decode_attention", build_logs["decode_attention"],
            {"split_mma_d256": r"split_mmaILi256ENS_12ContiguousKV",
             "merge_kernel_bf16": r"merge_kernelI13__nv_bfloat16"},
            {"split_mma_d256": decode.decode_attention_mma_smem(256)}),
        "ssd_scan": _kernel_report(
            "ssd_scan", build_logs["ssd_scan"],
            {"ssd_state_tc": r"ssd_state_tc", "ssd_cb_tc": r"ssd_cb_tc",
             "ssd_state_pass": r"ssd_state_pass",
             "ssd_out_tc": r"ssd_out_tc"},
            {"ssd_state_tc": ssd.ssd_scan_tc_smem(0),
             "ssd_out_tc": ssd.ssd_scan_tc_smem(1)}),
    }


def _fused_report(build_logs: dict) -> dict:
    """The one-launch decode kernels at head_dim 128 in both sources
    (decode_fused_mma, bf16 at G <= 8; decode_fused, fp32 with 4 and 8
    query heads a block): registers, spills, shared memory, HMMA counts."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load("decode_attention")
    lib.decode_attention_fused_smem.argtypes = [ctypes.c_int] * 3
    labels = {"bf16_d128": (1, 8, r"decode_fused_mmaILi128E"),
              "f32_d128_g4": (0, 4, r"decode_fusedILi128ELi4E"),
              "f32_d128_g8": (0, 8, r"decode_fusedILi128ELi8E")}
    smem = {lab: lib.decode_attention_fused_smem(code, 128, maxg)
            for lab, (code, maxg, _) in labels.items()}
    return {src: _kernel_report(src, build_logs[src],
                                {lab: rx + kv for lab, (_, _, rx)
                                 in labels.items()}, smem)
            for src, kv in (("decode_attention", "NS_12ContiguousKV"),
                            ("paged_attention", "NS_7PagedKV"))}


def _cuda_core_report(build_logs: dict) -> dict:
    """The CUDA-core kernels redesigned for Hopper: ``flash_fwd_f32`` at
    every head dim and ``rglru_stream`` at the chunk lengths that the
    plans of the timed shapes take (fp32 16 steps, bf16 32, both with
    16-byte copies): registers, spills and shared memory.  Raises if
    one is missing from the build report or spills."""
    import ctypes
    from repro_torch.kernels import HEAD_DIMS, _build
    flash = _build.load("flash_attention")
    flash.flash_attention_f32_smem.argtypes = [ctypes.c_int]
    scan = _build.load("rglru_scan")
    scan.rglru_scan_smem.argtypes = [ctypes.c_int] * 3
    scan_labels = {"f32_l16": (0, 16, r"rglru_streamIffLi16ELi4ELi4E"),
                   "bf16_l32": (1, 32,
                                r"rglru_streamI13__nv_bfloat16S\d*_Li32ELi8ELi8E")}
    report = {
        "flash_attention": _kernel_report(
            "flash_attention", build_logs["flash_attention"],
            {f"f32_D{d}": rf"flash_fwd_f32ILi{d}E" for d in HEAD_DIMS},
            {f"f32_D{d}": flash.flash_attention_f32_smem(d)
             for d in HEAD_DIMS}),
        "rglru_scan": _kernel_report(
            "rglru_scan", build_logs["rglru_scan"],
            {lab: rx for lab, (_, _, rx) in scan_labels.items()},
            {lab: scan.rglru_scan_smem(code, code, k)
             for lab, (code, k, _) in scan_labels.items()})}
    want = len(HEAD_DIMS) + len(scan_labels)
    got = sum(len(r) for r in report.values())
    spilling = [lab for r in report.values() for lab, e in r.items()
                if any(e.get("spill_bytes", (0, 0)))]
    if got != want or spilling:
        raise AssertionError(f"CUDA-core kernels: {got} of {want} reported, "
                             f"spilling: {spilling}: {report}")
    return report


SOURCES = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:86"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:82"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:94"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:83"),
    "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:57"),
    "rpc_channel": ("src/repro_torch/csrc/rpc_channel.cu",
                    "io_callback (src/repro/core/rpc.py:1317), no Pallas "
                    "kernel"),
    "rpc_queue": ("src/repro_torch/csrc/rpc_queue.cu",
                  "RpcQueue._enqueue (src/repro/core/rpc.py:2984), array "
                  "updates fused by XLA, no Pallas kernel"),
    "rpc_async": ("src/repro_torch/csrc/rpc_async.cu",
                  "RpcQueue.flush with mode='async' "
                  "(src/repro/core/rpc.py:3180), an ordered io_callback, no "
                  "Pallas kernel"),
}
#: The kernels line's names of a source's kernels, where they are not the
#: source's own.
ENTRY_NAMES = {"rpc_channel": ("rpc_post",), "rpc_queue": ("rpc_enqueue",),
               "rpc_async": ("rpc_async_post", "rpc_async_collect")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card_line = nvidia_smi()
    t0 = time.perf_counter()
    build_logs = _build.build_all(list(SOURCES))
    log({"env": {"nvidia_smi": card_line, "torch": torch.__version__,
                 "cuda": torch.version.cuda, "python": sys.version.split()[0],
                 "kernel_build_s": time.perf_counter() - t0,
                 "ptxas": {n: _ptxas_summary(text)
                           for n, text in build_logs.items()},
                 "tensor_cores": _wgmma_report(build_logs),
                 "decode_fused": _fused_report(build_logs),
                 "cuda_cores": _cuda_core_report(build_logs)}})
    card = torch.cuda.get_device_name(0)

    summary = kernel_phase(card)
    decode_reuse_phase()
    decode_launch_phase()
    rglru_launch_phase()
    serve, spill = serve_phase()
    identity_phase()
    dense = dense_serve_phase()
    summary["flash_attention"] = flash_phase(card_line)
    prefill_phase()
    train = train_phase()
    train_profile()
    at_ssd = ssd_kernel_phase(card_line)
    summary["ssd_scan"] = at_ssd["prefill"]
    ssm_serve = ssm_serve_phase()
    ssm_prefill_phase()
    ssm_train, ssm_hooks = ssm_train_phase()
    train_profile("mamba2-130m", SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)
    at_rglru = rglru_kernel_phase(card_line)
    summary["rglru_scan"] = at_rglru["serve"]
    at_hybrid = hybrid_attn_kernel_phase(card_line)
    hybrid = hybrid_serve_phase()
    hybrid_prefill_phase()
    rpc_err = rpc_phase()
    rpc_gil_phase()
    empty = rpc_time_phase(card_line)
    summary["rpc_channel"] = {
        "max_abs_err": rpc_err, "kernel_ms": empty["ms"],
        "plain_ms": empty["plain_ms"], "bound_ms": empty["bound_ms"],
        "bound_by": "bytes", "library_ms": None}
    queue_launches, queue_posts = rpc_queue_phase()
    rpc_queue_faults_phase()
    scalar = rpc_queue_time_phase(card_line)
    summary["rpc_queue"] = {
        "max_abs_err": 0.0, "kernel_ms": scalar["ms"],
        "plain_ms": scalar["plain_ms"], "bound_ms": scalar["bound_ms"],
        "bound_by": "bytes", "library_ms": None}
    libc_launches, libc_posts = libc_io_phase()
    hooks, hook_enqueues = device_run_hooks_phase()
    async_queue = rpc_queue_async_phase()
    summary.update(rpc_async_time_phase(card_line))
    async_run = device_run_async_phase()
    pipeline_posts = host_pipeline_phase()
    san_enqueues, san_async = sanitizer_phase(card_line)
    allocators_phase(card_line)
    events_phase()
    gpu_first = gpu_first_phase()

    by_path = {
        "decode_attention": {"serve": serve["decode_attention"],
                             "dense_serve": dense["decode_attention"],
                             "hybrid_serve": hybrid["decode_attention"]},
        "paged_attention": {"serve": serve["paged_attention"],
                            "dense_serve": dense["paged_attention"]},
        "flash_attention": {"train": train["flash_attention"],
                            "hybrid_serve": hybrid["flash_attention"]},
        "ssd_scan": {"ssm_serve": ssm_serve, "ssm_train": ssm_train},
        "rglru_scan": {"hybrid_serve": hybrid["rglru_scan"]},
        "rpc_channel": {"train": train["rpc_post"], "ssm_train": ssm_hooks,
                        "rpc_queue": queue_posts, "libc_io": libc_posts,
                        "device_run_hooks": hooks,
                        "host_pipeline": pipeline_posts,
                        "gpu_first": gpu_first},
        "rpc_queue": {"rpc_queue": queue_launches, "libc_io": libc_launches,
                      "device_run_hooks": hook_enqueues,
                      "serve_spill": spill["rpc_enqueue"],
                      "sanitizer": san_enqueues},
    }
    for name in ENTRY_NAMES["rpc_async"]:
        by_path[name] = {"rpc_queue_async": async_queue[name],
                         "device_run_async": async_run[name],
                         "serve_spill": spill[name],
                         "sanitizer": san_async[name]}
    kernels = []
    # a source with one kernel keys its records by the source's name
    entries = [(name, name if name in by_path else src_name, source,
                replaces)
               for src_name, (source, replaces) in SOURCES.items()
               for name in ENTRY_NAMES.get(src_name, (src_name,))]
    for name, key, source, replaces in entries:
        rec = summary[key]
        paths = by_path[key]
        if not all(n >= 1 for n in paths.values()):
            raise AssertionError(f"{name} was not launched on every path "
                                 f"that runs it: {paths}")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(paths.values()),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"] if "kernel_ms" in rec else rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        if len(paths) > 1:
            kernels[-1]["launches_by_path"] = paths
        for key, other in (("at_hybrid_shape", at_hybrid.get(name)),
                           ("at_dense_serve_shape",
                            summary.get(name + "@g6")),
                           ("at_train_shape", name == "ssd_scan"
                            and at_ssd["train"]),
                           ("at_s1000_shape", name == "rglru_scan"
                            and at_rglru["s1000"])):
            if other:
                kernels[-1][key] = {
                    "shape": other.get("shape", other.get("case")),
                    "max_abs_err": other["max_abs_err"],
                    "ms": other["kernel_ms"], "plain_ms": other["plain_ms"],
                    "bound_ms": other["bound_ms"],
                    "bound_by": other["bound_by"],
                    "library_ms": other["library_ms"]}
    log({"kernels": kernels})
    log(card_line)
    log({"ok": True, "device": {"platform": "gpu", "kind": card,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
