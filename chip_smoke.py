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
   heads over 8, G=6, D=128: rows 0..5 of the 16-row mma tile), at
   seamless's cross attention (16 heads over 16, D 64, over 1024 encoder
   frames with ragged lengths, G=1: one row of the tile; and a row of
   length 0), at qwen2-vl's grouping (16 padded heads over 2, G=8, D=128,
   decode and paged) and at
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
   device kernels and host operators); inside it ``serve_spill`` and
   ``artifact_serve``: the engine exported (``export_artifact``:
   ``torch.export`` of the decode step, the manifest, a step-0
   checkpoint, ``engine.json``) and cold-started in a fresh process
   (``from_artifact``), which serves the same traffic with the live
   engine's streams, spill calls and acks and 28 ``paged_attention``
   launches a tick; then ``analysis``: the analyzer's 34 corpus cases on
   the card against JAX's golden codes, the export-graph walker over the
   saved ``serve_step.pt2`` (28 ``paged_attention`` nodes, no transport
   node, no hazard), and captures of that engine's ticks and of a hooked
   ``device_run`` against the codes the CPU test pins; then ``mesh``: a
   world of one process (``nccl``) and its one-device mesh, bit-identical
   to the paths without one (Fig. 6's region, ``expand(sanitize=True)``,
   ``device_run(mesh=)``, ``parallel_for(mesh=)``), the engine on the
   sharded page heap with the one-device mesh and 4 shards beside the
   unsharded one (streams, page tables, shard spans), and Fig. 6's mesh
   section;
4. ``identity``: fp32, full width, 4 layers; the engine's greedy streams
   must equal the contiguous decode's token for token;
5. ``flash``: the flash kernel against its plain version, fp32 and bf16, at
   the training shape (B 2, S 1024, 32 heads over 8 KV heads, D 128,
   causal), a ragged shape (Sq = Sk = 1000), a window of 128, a q_offset
   with Sq < Sk, G = 1 with D = 16 (bf16: the mma.sync variant),
   seamless's width (16 heads over 16, D 64), its encoder (B 4 x 1024
   and 1000 frames, not causal), its decoder's cross attention (48
   queries over 1024 frames, not causal) and qwen2-vl's prefill (B 2 x
   1024, 16 padded heads over 2, D 128, causal); bf16 rows that see no key
   (``blind_rows_d*``, the wgmma variant at D 64, 128 and 256 against
   its tiled plain twin), and fp32 ones (the CUDA-core variant at D 64,
   128 and 256 against its twin at its own tiles); the q/k/v gradients
   through the op against autograd through the plain version at the
   training shape; kernel (also ``kernel_ms_clean_l2``), plain and SDPA
   (timed only) times beside the flops bound at the training and D 64
   shapes, where the fp32 kernel must beat SDPA, at seamless's encoder
   and at qwen2-vl's prefill;
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
   memory; then ``mesh_train``: the same run through ``run(mesh=)`` on a
   world of one and its (1, 1) ``("data", "model")`` mesh (``train``'s
   losses), phi3.5-moe at full width in 2 of its 32 layers through the
   expert-parallel path (finite losses, drops a step; its MoE layer
   against ``moe_reference``), and a llama-100m run that fails after a
   save and resumes from it with ``restore_checkpoint(shardings=)``;
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
    (``rpc_call_reference``) on the same inputs, one launch a call; and
    ``one_callee_sizes``: one callee returning 1, 64 and 1024 elements on
    one channel (one landing pad, a staging region a result shape); the
    call plan's cases: a slot under the copy limit beside one above it in
    one call (both routes), as many tensor slots as the descriptor holds,
    and a call captured in a CUDA graph and replayed twice;
19. ``rpc_gil``: a posted call whose callee sleeps, followed at once by
    ``.item()``, ``.cpu()``, ``torch.cuda.synchronize()``,
    ``Event.synchronize()`` and 4096 launches, each under a 60 s
    ``faulthandler`` watchdog (a deadlock ends the run, it never hangs);
20. ``rpc_time``: the empty round trip (CUDA events, median of 200; the
    kernel's wait, the drain's Python and its wait for Python's lock, the
    CUDA API calls a call: one), the same after 60 ms idle, the latency
    floor (a C loop answers, no Python), the enqueue's split (Python, the
    op's dispatch, the launch's Python, the C call), READWRITE refs of
    4 KB, 1 MB and 64 MB against the host link's rate (``nvidia-smi``
    PCIe generation and width), each beside the host-synchronous
    version's wall time, and both copy routes at 4 KB-64 MB;
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
    bound: ``enqueue`` through the queue's enqueue plan (one direct
    launch), ``enqueue_ticketed``, and the forced op route, in turns;
    the plan route against the op route on a seeded plan (queue states,
    replay logs, tickets, replies and statuses bit-equal); the flush of
    a full 1024-record ring (events, host, the drain's Python) beside
    the link's bound;
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
    ``set_sync_debug_mode("error")``, bit-equal to the CPU's;
27. ``host_driven``: ``device_run`` against ``host_driven_run`` (a wait
    for the card after every step) over 1000 steps of XSBench's history
    step at "small" (2**15 particles): ms/step of each, the final states
    bit-equal, ``device_run`` under ``set_sync_debug_mode("error")``;
28. ``paper_eval``: the paper's evaluation (``repro_torch.evaluation``),
    one line a figure.  Figs. 8-10 at ``evaluation/run.py::CARD_SIZES``:
    each region's serial (on a prefix, scaled), gpu_first and manual ms,
    JAX's two ratios, ATen ops a serial iteration and of the expanded loop
    (device launches by ``torch.profiler`` beside them), and its gates:
    the columns under ``set_sync_debug_mode("error")`` with vmap's
    fallback an error, gpu_first against serial on the prefix and manual
    against gpu_first where JAX's columns agree (rtol 1e-5 against the
    value plus the column's largest; hypterm against its plane's absolute
    terms; integers equal; on each region's ``gate_region()``: the
    history chains at depth 1 and botsspar in float64, where rounding
    differences grow, their timed columns only finite), and every column
    against the CPU at the JAX modules' sizes (1e-4 chained, stencil and
    inverse, 1e-5 the others); smithwa's scores at L 32..2048 equal to
    the CPU's.  Then Figs. 6 and 7 on the card and on the CPU: pointers,
    records and replies bit-equal, and the transport kernels' launches
    exactly those the sections' loops make.

Between ``identity`` and ``flash`` runs
``dense_serve``: qwen2.5-14b at full width, cut from 48 to
:data:`DENSE_LAYERS` layers (40 heads padded to 48 over 8 KV heads of
128, QKV bias, bf16, random parameters from seed 0 built on the card;
the cut keeps the script within its limit beside ``artifact_serve`` and
``analysis``) through the engine as ``serve`` runs llama: ms/tick,
tok/s, init time, peak memory, the logits gate against the
teacher-forced contiguous decode and exact launches (paged and decode
one a layer a tick or step), and ``dense_profile`` (8
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
events behind a device sleep) beside its plain version, the bytes bound
and the latency floor (an empty launch, a mapped ``ld.acquire.sys``);
the hand-off's gates at both copy routes, single and 4-row sharded
(the ring's ``in`` region bit-equal to the state's snapshot, the state
to a CPU queue's after every flush, CUDA API calls a flush), the host
us of a flush through the flush plan and through the two ops, and a
deadline overrun on the card (TIMEOUT stamped by the device, the late
drain abandoned) equal to a CPU queue;
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

After ``dense_serve`` come ``moe_serve``, phi3.5-moe-42b-a6.6b
at full width (d_model 4096, 32 query heads over 8 KV heads of 128, 16
experts of d_ff 6400, top 2, vocab 32064, bf16) and 8 of its 32 layers
(16 until ``artifact_serve`` joined the script; ~21 GB, built on the card
after ``dense_serve``'s model is freed) through the engine with
``serve``'s gates (logits against the teacher-forced contiguous decode,
exact launches: paged 8 a tick, decode 8 a step) and ``moe_profile``; and
``moe_fp32``, the same width in fp32 at 2 layers: the engine within
2e-5 of the contiguous decode, ``Model.forward`` within 1e-3 of
``Model.prefill`` + decode and the experts chosen for every token and
layer equal on both paths.  Then the last two model families, each at
full width and depth on the card from random weights (seed 0):
``encdec_serve``, seamless-m4t-large-v2 (24 encoder and 24 decoder
layers, 16 heads over 16 of 64, bf16, ~2.04e9 parameters):
``Model.prefill`` of 4 requests x 1024 frame embeddings and 32 greedy
decode steps (prefill ms, decode ms/step and tok/s, peak memory; exact
launches: flash 24 a prefill, decode 48 a step, self and cross), its
steps' logits and ``Model.forward``'s teacher-forced on the stream
(flash at Sq 32 over 1024 frames; 72 launches) both held against the
fp32 forward of the same weights, the steps within twice the forward's
distance (bf16 rounding alone puts the two bf16 paths ~0.1 apart), and
``encdec_profile``; ``encdec_fp32``, the same width in
fp32 at 2 + 2 layers with ragged ``enc_lens``: the card's decode logits
against the same parameters on the CPU's plain versions within 1e-3;
``vlm_serve``, qwen2-vl-2b (:data:`VLM_SERVE_LAYERS` of its 28 layers,
cut as ``dense_serve`` is; 12 heads padded to 16 over 2 of 128, M-RoPE,
bf16):
``Model.prefill`` of 2 x 1024 patch-and-text embeddings at Qwen2-VL's
(t, h, w) positions and 32 greedy steps, the last 4 fed as embeddings
(exact launches; the logits
and ``Model.forward``'s over the same embeddings and positions held
against fp32 as seamless's; ``vlm_profile``), then the paged engine on
token prompts with ``serve``'s gates and ``vlm_engine_profile``; and
``vlm_fp32``, the same width in fp32 at 2 layers: prefill + 8 steps
against the forward within 1e-3, the same argmax.  After ``events``:
``rpc_sharded``, the
``rpc_queue`` plans on 4-shard ``ShardedRpcQueue``s, sync and async,
plain and sanitized (states bit-equal to CPU queues and, sync, to four
single queues flushed in (device, slot) order; replay logs, tickets,
sanitizer epochs and ``flush_stats`` equal; every enqueue and flush
under ``set_sync_debug_mode("error")``; exact launches: one
``rpc_enqueue`` a record, one ``rpc_post`` a sync flush, one
``rpc_async_post`` and one ``rpc_async_collect`` an async one), the
deadline's partial epoch (``shard_deadline`` 0.25 s, a 2 s delay pinned
to shard 1: shard 1 TIMEOUT, the others OK, warned; sync, and async at
the collecting flush), async independence,
the sharded ``LogRing`` in (device, slot) order, the cross-transport
conformance of ``fprintf``, ``fwrite`` and remote malloc on the card, and
a 4 x 256-record sharded flush timed beside a 1 x 1024 one; then
``manifest``: the batched program of JAX's cross-process test here and
in a fresh ``python3 -c`` process that adopts this one's manifest
(bit-equal effects, pointers and launches; a tampered pad refused,
naming its callee).

After ``hybrid_prefill`` come the training paths beyond llama and
mamba2, each at full width from random weights (seed 0): ``ckpt_train``,
``examples/train_100m_torch.py --preset full`` (llama-100m: 12 layers, d
768, 12 heads over 4 of 64, vocab 32000, fp32; batch 8 x 1024, 2 x 20
steps around a simulated failure, a save every 10 steps through the
checkpoint hook into a temporary directory, the resume from the newest
manifest; gates: manifest 40 newest and ``final_step`` 40, losses finite
and phase 2's below phase 1's + 0.5, one ``rpc_post`` a hook firing,
flash 24 a step, the live state bit-equal to the states restored from
the hook's and the last save, and one more step from each within
``CKPT_STEP_TOL``; ms/step, bytes a save, the hook's host seconds, the
device loop's stall at a save, the writer's and the restore's seconds);
``hybrid_train``, recurrentgemma-9b cut to 9 of its 38 layers (three
(rec, rec, attn) blocks) through ``launch/train.run``, 4 steps of 1 x
4096 tokens in bf16 (rglru_scan 12 and flash 6 a step, ms/step,
``train_mfu``, peak memory); ``encdec_train``, seamless-m4t-large-v2 at
full depth, and ``vlm_train``, qwen2-vl-2b at full depth in 2
microbatches, each 4 steps of 2 x 1024 from ``make_synthetic_batch``
through ``make_train_step`` inside ``device_run`` with a loss hook
(flash 144 and 112 a step).  The kernel phases hold flash at those
training shapes too (fp32 at 8 x 1024 over 12 heads of 64 and 4 KV
heads; bf16 at 1 x 4096, D 256, window 2048), and the RG-LRU scan at 1
x 4096 x 4096.

Every phase raises on failure.  The kernels' launch counts are reset just
before each counted path (phases 3, 7, 10, 12, 16, 21, 24, 25 and 26,
``artifact_serve`` (in its fresh process), ``dense_serve``, ``moe_serve``,
``moe_fp32``, ``encdec_serve``, ``encdec_fp32``, ``vlm_serve``,
``vlm_fp32``, ``ckpt_train``, ``hybrid_train``, ``encdec_train``,
``vlm_train``, ``rpc_queue_async``, ``device_run_async``, ``host_pipeline``,
``serve_spill``, ``sanitizer``, ``rpc_sharded``, ``manifest`` and
``paper_eval``'s Figs. 6 and 7) and
read just after it; each path's count must be the exact number its depth
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
decode their numbers at the hybrid shapes, decode and paged at
qwen2.5-14b's, seamless's cross attention's (decode) and qwen2-vl's
(``at_*_shape``), flash at seamless's encoder and qwen2-vl's prefill,
flash and the RG-LRU scan at the training shapes of the new training
paths, and for the SSD scan at the training shape),
the ``nvidia-smi`` line and ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits with code 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import timeit
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
# bf16 decode steps against a bf16 forward at full depth differ by bf16
# rounding alone by more than LOGIT_ATOL_BF16 (on an H100: seamless
# 0.103, qwen2-vl 0.174; llama's ungated difference 0.103), so those
# gates hold each bf16 path against the same weights run in fp32: the
# decode steps' distance from it within LOGIT_ATOL_BF16 or, where the
# forward's own distance is larger, within this multiple of it.
BF16_ERR_MULT = 2.0
SERVE_LAYERS = 28
DENSE_LAYERS = 24                # qwen2.5-14b (48 layers), dense_serve's cut
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
# seamless-m4t-large-v2 (encdec_serve, encdec_fp32) and qwen2-vl-2b
# (vlm_serve)
ENCDEC_LAYERS = 24               # seamless-m4t-large-v2, each stack
ENCDEC_FRAMES = 1024             # frame embeddings a request
ENCDEC_STEPS = 32                # greedy decode steps a request
ENCDEC_BOS = 2                   # the decoder's first token
#: The fp32 gate: its depth (each stack), ragged encoder lengths, steps.
ENCDEC_FP32_LAYERS, ENCDEC_FP32_STEPS = 2, 8
ENC_LENS_RAGGED = (1024, 700, 333, 97)
VLM_SERVE_LAYERS = 14            # vlm_serve's cut, for the script's length
#: Qwen2-VL's prompt: 16 text tokens, an image of 24 x 32 patches, 240
#: text tokens (1024 positions).
VLM_LAYOUT = (16, (24, 32), 240)
#: Greedy steps after the embeddings' prefill; the last few are fed as
#: embeddings (``decode_step(..., embeds=)``).
VLM_STEPS, VLM_EMBED_STEPS = 32, 4
#: The fp32 gate's depth and greedy steps.
VLM_FP32_LAYERS, VLM_FP32_STEPS = 2, 8
# The training phases of the checkpoint, hybrid, encdec and vlm paths:
# llama-100m (examples/train_100m_torch.py) in 2 x 20 steps around a
# restart, a save every 10; recurrentgemma-9b cut to three (rec, rec,
# attn) blocks; seamless and qwen2-vl at full depth
CKPT_STEPS, CKPT_BATCH, CKPT_SEQ = 40, 8, 1024
# One step from the restored state against one from the live state: the
# restored state is bit-equal to the live one, and so is the step's loss
# (the forward is deterministic), but the embedding's backward
# (``index_add_``: atomic fp32 adds over repeated tokens) sums in an
# order that varies between runs: the embedding's leaves (values, master,
# mu, nu) differ by up to 3.7e-9 on an H100 (fp32 values ~0.02-1), the
# others not at all, so the step is held within 1e-6.
CKPT_STEP_TOL = 1e-6
HYBRID_TRAIN_LAYERS = 9
HYBRID_TRAIN_STEPS, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ = 4, 1, 4096
ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 4, 2, 1024
VLM_TRAIN_STEPS, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ = 4, 2, 1024
VLM_TRAIN_MICROBATCHES = 2


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


#: The bf16 decode and paged cases that the kernels line reports, and the
#: suffix of their summary keys.
SUMMARY_CASES = {"serve": "", "g6_d128": "@g6", "g1_d64_enc": "@g1_enc",
                 "g8_d128": "@g8"}


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
            # seamless's cross attention: 16 heads over 16 (G 1) over 1024
            # encoder frames, ragged enc_lens (whole splits idle); a row
            # of enc_lens 0 returns 0
            "g1_d64_enc": (4, 1024, 16, 16, 64, list(ENC_LENS_RAGGED), None,
                           True),
            "g1_d64_enc_zero": (4, 1024, 16, 16, 64, [1024, 0, 333, 1],
                                None, False),
            # qwen2-vl's grouping: 12 heads padded to 16 over 2 (G 8)
            "g8_d128": (4, 512, 16, 2, 128, serve_lengths, None, True),
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
            if dtn == "bfloat16" and case in SUMMARY_CASES:
                summary["decode_attention" + SUMMARY_CASES[case]] = rec
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
            # qwen2-vl's engine: 16 padded heads over 2 (G 8)
            "g8_d128": (4, 16, 32, 16, 2, 128, serve_lengths, None, True),
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
            if dtn == "bfloat16" and case in SUMMARY_CASES:
                summary["paged_attention" + SUMMARY_CASES[case]] = rec
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


#: Profiler windows a launch gate takes at most: a window in which
#: torch.profiler recorded no device kernel at all (CUPTI lost its buffer,
#: seen on the chip machine) shows nothing either way and is taken again.
PROFILE_WINDOWS = 3


def _device_kernels(fn, calls):
    """{device kernel name (60 chars): count} that ``torch.profiler`` sees
    over ``calls`` calls of ``fn`` (synchronised); a window that recorded
    no device kernel is taken again, up to :data:`PROFILE_WINDOWS`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels_ = {e.key[:60]: e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA}
        if kernels_:
            return kernels_
    return {}


def decode_launch_phase():
    """torch.profiler over 5 calls of each one-launch path (decode and paged
    at llama's serve shape in bf16 and fp32, fp32 decode at 16 heads over 1
    and D 256): exactly one device kernel a call, decode_fused (fp32) or
    decode_fused_mma (bf16)."""
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
            kernels_ = _device_kernels(fn, calls)
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


def _engine_serve(tag, cfg, n_short, long_len, seed, atol=LOGIT_ATOL_BF16):
    """``cfg`` at full width (bf16 unless ``cfg`` says otherwise, random
    weights from seed 0, built on the card) behind
    ``ServingEngine(batch_slots=4, page_size=16, max_len=512)``: a
    ``long_len``-token prompt and ``n_short`` short ones, 16 new tokens
    each.  The counts are reset just before the engine runs and read
    after the contiguous check: paged attention exactly once a layer a
    tick, decode once a layer a step of the contiguous decode
    (``Model.decode_step``) that is teacher-forced on the first four
    requests and held to the engine's logits (within ``atol``) and
    argmax.  Returns (launches, model, params, prompts, max_new, max_len,
    the greedy streams)."""
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
                                  "tol": atol,
                                  "same_argmax": same,
                                  "argmax_is_stream": tokens}})
        if diff > atol or not same or not tokens:
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
    spill, spill_engine, spill_calls, spill_ms = serve_spill_phase(
        model, params, prompts, max_new, max_len, streams)
    artifact, directory = artifact_serve_phase(spill_engine, spill_calls,
                                               spill_ms, prompts, max_new)
    try:
        analysis = timed(analysis_phase, spill_engine, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    del spill_engine
    mesh = timed(mesh_phase, model, params, prompts)
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
    return launches, spill, artifact, analysis, mesh


# A fresh process: cold-start the artifact on the card and serve the
# ``serve`` phase's traffic with a recording spill sink.  Arguments: the
# artifact's directory, the output file, the prompts (JSON), max_new.
_ARTIFACT_CHILD = r"""
import time
t_start = time.time()
import collections, json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.serving.engine import ServingEngine

directory, out_path, prompts, max_new = (sys.argv[1], sys.argv[2],
                                         json.loads(sys.argv[3]),
                                         int(sys.argv[4]))
t_import = time.time()
calls = []
sink = lambda rid, n, pages: calls.append(
    [int(rid), int(n), [int(p) for p in pages]])
engine = ServingEngine.from_artifact(directory, get_config("llama3.2-3b"),
                                     spill_sink=sink, device="cuda")
torch.cuda.synchronize()
t_loaded = time.time()
ops = collections.Counter(str(n.target) for n in engine._step.graph.nodes
                          if n.op == "call_function")
rids = [engine.submit(p, max_new=max_new) for p in prompts]
paged_attention_cuda.launches = 0        # counts from 0 just before
ticks, t_first = 0, None
t0 = time.perf_counter()
while engine.queue or any(s.request_id >= 0 for s in engine.slots):
    engine.step()
    ticks += 1
    if t_first is None and (engine.finished or any(
            s.out for s in engine.slots)):
        t_first = time.time()
torch.cuda.synchronize()
run_s = time.perf_counter() - t0
out = {"streams": [engine.finished[r] for r in rids], "ticks": ticks,
       "paged_attention": paged_attention_cuda.launches,
       "model_is_none": engine.model is None,
       "step_source": engine._step_source, "calls": calls,
       "acks": {str(k): v for k, v in engine.spill_acks.items()},
       "t_start": t_start, "import_s": t_import - t_start,
       "load_s": t_loaded - t_import, "t_first_token": t_first,
       "run_s": run_s, "ms_per_tick": run_s / ticks * 1e3,
       "graph_ops": sum(ops.values()), "top_graph_ops": ops.most_common(4)}
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def artifact_serve_phase(engine, calls, live_ms, prompts, max_new):
    """The engine's durable artifact at llama3.2-3b's full width and depth
    (28 layers, bf16).  ``engine`` is ``serve_spill``'s engine after its
    run (``serve``'s model, weights and traffic, a recording spill sink;
    its streams were held to ``serve``'s there), ``calls`` its sink's
    ``(request, n_tokens, pages)`` and ``live_ms`` its ms/tick. This process
    exports it (``export_artifact``: ``torch.export`` of the decode step,
    the manifest with the spill queue, a step-0 checkpoint of the weights in
    JAX's stacked layout, ``engine.json``) under the ignored ``build/``,
    and a fresh process of this interpreter cold-starts it on the card
    (``from_artifact``: no model built, nothing traced) and serves the same
    traffic.  Gates: the child's streams equal the live engine's, its
    sink calls and acks equal the live engine's, it launched
    ``paged_attention`` exactly 28 times a tick, its engine has no model
    and an ``artifact`` step.  Reports the artifact's bytes, the export,
    save and checkpoint seconds, the cold start (the child's process start
    to its first token, on the wall clock), both ms/tick and the exported
    graph's ops.  Returns the child's launches (the path) and the
    artifact's directory, which the ``analysis`` phase reads and
    ``serve_phase`` then deletes."""
    t_phase = time.perf_counter()
    directory = os.path.join(ROOT, "build", "artifact_serve")
    shutil.rmtree(directory, ignore_errors=True)
    rids = sorted(engine.finished)
    live = [engine.finished[r] for r in rids]
    acks = {str(k): v for k, v in engine.spill_acks.items()}
    calls = [[rid, n, pages] for rid, n, pages in calls]
    t0 = time.perf_counter()
    engine.export_artifact(directory, extra_meta={"arch": "llama3.2-3b",
                                                  "tiny_preset": False})
    export_s = time.perf_counter() - t0
    seconds = dict(engine.export_seconds)
    files = {n: os.path.getsize(os.path.join(directory, n))
             for n in os.listdir(directory)}
    torch.cuda.empty_cache()

    out_path = os.path.join(directory, "child.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t_spawn = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", _ARTIFACT_CHILD, directory, out_path,
         json.dumps(prompts), str(max_new)],
        env=env, capture_output=True, text=True, timeout=600)
    child_s = time.time() - t_spawn
    if proc.returncode != 0:
        raise AssertionError(f"artifact_serve: the cold-start process "
                             f"failed:\n{proc.stderr[-4000:]}")
    with open(out_path) as f:
        child = json.load(f)
    per_tick = child["paged_attention"] / child["ticks"]
    checks = {
        "streams_bit_equal": child["streams"] == live,
        "spill_calls_equal": child["calls"] == calls
        and len(calls) == len(prompts),
        "spill_acks_equal": child["acks"] == acks,
        "paged_attention_28_a_tick":
        child["paged_attention"] == SERVE_LAYERS * child["ticks"],
        "no_model_artifact_step": child["model_is_none"]
        and child["step_source"] == "artifact",
    }
    rec = {"layers": SERVE_LAYERS, "requests": len(prompts),
           "ticks": child["ticks"],
           "paged_attention_launches": child["paged_attention"],
           "paged_attention_per_tick": per_tick,
           "artifact_bytes": sum(files.values()),
           "serve_step_pt2_bytes": files["serve_step.pt2"],
           "files": len(files), "export_artifact_s": export_s,
           "export_s": seconds["export"], "save_s": seconds["save"],
           "checkpoint_s": seconds["checkpoint"],
           "cold_start_s": child["t_first_token"] - t_spawn,
           "child_import_s": child["import_s"],
           "child_from_artifact_s": child["load_s"],
           "child_process_s": child_s,
           "live_ms_per_tick": live_ms,
           "artifact_ms_per_tick": child["ms_per_tick"],
           "graph_ops": child["graph_ops"],
           "top_graph_ops": child["top_graph_ops"],
           "nvidia_smi": nvidia_smi(), "checks": checks,
           "phase_seconds": time.perf_counter() - t_phase}
    log({"artifact_serve": rec})
    if not all(checks.values()):
        raise AssertionError(f"artifact_serve: {checks}")
    return {"paged_attention": child["paged_attention"]}, directory


#: The codes of the ``analysis`` phase's engine ticks and hooked
#: ``device_run``: the codes that tests/test_torch_analysis.py pins for the
#: same programs on the CPU, where JAX's engine gives the same and JAX's
#: ``device_run`` one false ``CAPACITY_REPLY`` (its returning hook's flush
#: inside ``lax.cond`` joins no queue lineage; see the test).
ANALYSIS_ENGINE_CODES: list = []
ANALYSIS_LOOP_CODES: list = []
#: Requests (two-token prompts, two new tokens) and ticks of the engine
#: program: every request retires, and spills, at the third tick.
ANALYSIS_PROMPTS = [[11, 23], [12, 24], [13, 25], [14, 26]]
ANALYSIS_TICKS = 4
ANALYSIS_STEPS = 1000


def analysis_hooks(HostHook, ShapeDtype, dtype):
    """``device_run_hooks``' hooks in one run: a named immediate hook every
    100 steps and one every step, a batched hook every step and a
    returning hook every 100 steps (the same program in either package:
    its ``HostHook``, its ``ShapeDtype`` and float32)."""
    def note(i, v):
        return None

    def reply(i, v):
        import numpy as np
        return np.float32(1.0)

    return [
        HostHook(every=100, extract=lambda i, s: s[:256].sum(),
                 host_fn=note, name="analysis.every_100"),
        HostHook(every=1, extract=lambda i, s: s[:256].sum(),
                 host_fn=note, name="analysis.every_1"),
        HostHook(every=1, extract=lambda i, s: s[:256].sum(),
                 host_fn=note, name="analysis.batched_every_1",
                 batched=True),
        HostHook(every=100, extract=lambda i, s: s[:256].sum(),
                 host_fn=reply, name="analysis.returning_every_100",
                 batched=True, returns=ShapeDtype((), dtype),
                 consume=lambda i, s, v, ok: s + v * ok),
    ]


def analysis_phase(engine, directory):
    """The analyzer (``repro_torch.analysis``, the paper's §5.3 porting
    advisor) on the card.  Gates, each failing the run:

    * the corpus: each of the 34 ported cases on ``device="cuda"`` gives
      JAX's golden codes (``tests/data/hazard_corpus.json``), its
      transport launched through the ops (``rpc_enqueue``, ``rpc_post``,
      ``rpc_async_post`` and ``rpc_async_collect`` each at least once);
    * the walker over ``artifact_serve``'s ``serve_step.pt2`` (loaded,
      not exported again): 28 ``paged_attention`` nodes, no transport
      node, no hazard, in under a second;
    * ``analyze`` of ``serve_spill``'s llama3.2-3b engine (full width and
      depth, bf16): four requests through 4 ticks under a capture (28
      ``paged_attention`` launches a tick; the requests retire and spill
      at the third), and a ``device_run`` of 1000 steps with
      :func:`analysis_hooks`: their codes are the ones the CPU test pins
      (:data:`ANALYSIS_ENGINE_CODES`, :data:`ANALYSIS_LOOP_CODES`).

    Returns the transport's launches over the corpus, the ticks and the
    loop (the kernels line's ``analysis`` path)."""
    from repro_torch.analysis import capture, corpus, walk_graph
    from repro_torch.core import (HostHook, ShapeDtype, device_run,
                                  effects_barrier)
    from repro_torch.kernels import rpc_async, rpc_channel, rpc_queue
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda)

    t_phase = time.perf_counter()
    counters = {"rpc_post": rpc_channel.rpc_post,
                "rpc_enqueue": rpc_queue.rpc_enqueue,
                "rpc_async_post": rpc_async.rpc_async_post,
                "rpc_async_collect": rpc_async.rpc_async_collect}
    with open(os.path.join(ROOT, "tests", "data", "hazard_corpus.json")) as f:
        golden = json.load(f)["cases"]

    for fn in counters.values():      # main path: counts from 0 just before
        fn.launches = 0
    t0 = time.perf_counter()
    cases = {c.name: corpus.run_case(c, device="cuda").codes
             for c in corpus.CASES}
    effects_barrier()
    corpus_s = time.perf_counter() - t0
    corpus_launches = {k: fn.launches for k, fn in counters.items()}
    mismatched = sorted(n for n, codes in cases.items()
                        if codes != golden[n])

    t0 = time.perf_counter()
    program = torch.export.load(os.path.join(directory, "serve_step.pt2"))
    load_s = time.perf_counter() - t0
    counts: dict = {}
    t0 = time.perf_counter()
    walked = walk_graph(program.graph_module, counts=counts)
    walk_s = time.perf_counter() - t0
    del program

    for p in ANALYSIS_PROMPTS:
        engine.submit(p, max_new=2)
    spilled = len(engine.spill_acks)
    paged_attention_cuda.launches = 0
    launches = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    with capture() as cap:
        for _ in range(ANALYSIS_TICKS):
            engine.step()
    torch.cuda.synchronize()
    ticks_s = time.perf_counter() - t0
    paged = paged_attention_cuda.launches
    engine_codes = cap.report().codes
    engine_events = (len(cap.events), len(cap.folded()))
    new_acks = len(engine.spill_acks) - spilled

    state = torch.zeros(256, device="cuda")
    t0 = time.perf_counter()
    with capture() as cap:
        device_run(lambda i, s: s + 1.0, state, ANALYSIS_STEPS,
                   hooks=analysis_hooks(HostHook, ShapeDtype,
                                        torch.float32))
    effects_barrier()
    loop_s = time.perf_counter() - t0
    loop_codes = cap.report().codes
    loop_events = (len(cap.events), len(cap.folded()))
    total = {k: fn.launches for k, fn in counters.items()}
    program_launches = {k: total[k] - launches[k] for k in counters}

    checks = {
        "corpus_golden_on_cuda": not mismatched,
        "corpus_through_ops": all(n >= 1 for n in corpus_launches.values()),
        "walker_28_paged": counts.get("paged_attention") == SERVE_LAYERS,
        "walker_no_transport_no_hazard": not walked and not any(
            k.startswith("rpc_") for k in counts),
        "walker_under_1s": walk_s < 1.0,
        "engine_codes": engine_codes == ANALYSIS_ENGINE_CODES,
        "engine_28_paged_a_tick": paged == SERVE_LAYERS * ANALYSIS_TICKS,
        "engine_spilled": new_acks == len(ANALYSIS_PROMPTS),
        "loop_codes": loop_codes == ANALYSIS_LOOP_CODES,
    }
    rec = {"cases": cases, "ported": len(cases),
           "not_ported": list(corpus.NOT_PORTED), "mismatched": mismatched,
           "corpus_s": corpus_s, "corpus_launches": corpus_launches,
           "graph": {"ops": counts, "hazards": walked.codes,
                     "load_s": load_s, "walk_s": walk_s},
           "engine": {"layers": SERVE_LAYERS, "ticks": ANALYSIS_TICKS,
                      "requests": len(ANALYSIS_PROMPTS),
                      "paged_attention_launches": paged,
                      "codes": engine_codes, "events": engine_events[0],
                      "events_folded": engine_events[1], "s": ticks_s},
           "loop": {"steps": ANALYSIS_STEPS, "hooks": 4,
                    "codes": loop_codes, "events": loop_events[0],
                    "events_folded": loop_events[1], "s": loop_s},
           "program_launches": program_launches,
           "nvidia_smi": nvidia_smi(), "checks": checks,
           "phase_seconds": time.perf_counter() - t_phase}
    log({"analysis": rec})
    if not all(checks.values()):
        raise AssertionError(f"analysis: {checks}")
    return total


def dense_serve_phase():
    """qwen2.5-14b at full width on one card, cut from 48 to
    :data:`DENSE_LAYERS` layers: d_model 5120, 40 query heads padded to 48
    over 8 KV heads of 128 (G 6), QKV bias, bf16, random weights from seed
    0 built on the card, through the
    engine as ``serve`` runs llama (9 prompts, one of 200 tokens, 16 new
    tokens each) with the same logits gate and exact launch counts, then
    ``torch.profiler`` over 8 ticks (``dense_profile``).  Returns the
    launches."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-14b")
    assert (cfg.num_layers, cfg.d_model, cfg.padded_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.qkv_bias) == \
        (48, 5120, 48, 8, 128, True)
    cfg = dataclasses.replace(cfg, num_layers=DENSE_LAYERS)
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
            # seamless's encoder (bidirectional) and its decoder's cross
            # attention (48 queries over 1024 frames): the wgmma variant
            # without the causal mask, Sk a multiple of the key tile and
            # not; qwen2-vl's prefill (16 padded heads over 2)
            "enc_d64": (4, 1024, 1024, 16, 16, 64, False, None, 0, True),
            "enc_ragged": (4, 1000, 1000, 16, 16, 64, False, None, 0, False),
            "cross_d64": (4, 48, 1024, 16, 16, 64, False, None, 0, False),
            "vlm_prefill": (2, 1024, 1024, 16, 2, 128, True, None, 0, True),
            # llama-100m's training (ckpt_train: fp32, 12 heads over 4)
            "ckpt_d64": (8, 1024, 1024, 12, 4, 64, True, None, 0, True),
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
                        qt, kt, vt, is_causal=causal, enable_gqa=True)))
                bound = _flash_bound(dtn, es, B, Sq, Sk, Hq, Hkv, D, causal,
                                     window, q_offset)
                rec.update(bound_ms=bound[0], bound_by=bound[1],
                           card=card_line)
                if dt == torch.float32:
                    rec["faster_than_library"] = \
                        rec["kernel_ms"] < rec["library_ms"]
                    if case in ("train", "d64"):
                        ok = ok and rec["faster_than_library"]
                    rec["ok"] = ok
            log(rec)
            if not ok:
                raise AssertionError(f"flash_attention {case} {dtn} disagrees "
                                     f"with its plain version or is not "
                                     f"faster than SDPA: {rec}")
            if dtn == "bfloat16" and case in ("train", "enc_d64",
                                              "vlm_prefill", "d64"):
                summary[case] = rec
            if dtn == "float32" and case == "ckpt_d64":
                summary[case] = rec
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
    return {"flash_attention": launches, "rpc_post": hook_launches,
            "losses": losses}


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
    if arch == "llama3.2-3b":
        dryrun_line(model, params, opt, step_fn, batch)
    del params, opt, model, step_fn
    torch.cuda.empty_cache()


#: The card's counted FLOPs of a step against the CPU's fake and meta
#: counts of the same step (``launch/opcost.py``): relative difference.
DRYRUN_FLOP_TOL = 0.01


def dryrun_line(model, params, opt, step_fn, batch):
    """The dry run's counter on the card: one training step of the train
    phase's llama3.2-3b under ``OpCost``, held against the same step
    counted on the CPU on ``FakeTensorMode`` tensors and on the meta
    tensors of ``launch/dryrun.py`` (FLOPs within
    :data:`DRYRUN_FLOP_TOL`), beside the step's time measured without the
    counter and its compute and memory terms at the dry run's H100
    constants."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.opcost import OpCost
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.tree import tree_map

    t_line = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, _ = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with OpCost() as card:
        params, opt, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0

    def on_cpu(device):
        t = time.perf_counter()
        like = lambda x: torch.zeros(x.shape, dtype=x.dtype,  # noqa: E731
                                     device=device)
        vals = tree_map(like, params)
        cpu_batch = {k: like(v) for k, v in batch.items()}
        with OpCost() as c:
            step_fn(vals, adamw_init(vals), cpu_batch)
        return c.summary(), time.perf_counter() - t

    with FakeTensorMode():
        fake, fake_s = on_cpu("cpu")
    meta, meta_s = on_cpu("meta")
    got = card.summary()
    rel = {k: abs(got["flops"] - c["flops"]) / c["flops"]
           for k, c in (("fake", fake), ("meta", meta))}
    compute_s = got["flops"] / dryrun.PEAK_FLOPS
    memory_s = got["bytes"] / dryrun.HBM_BW
    log({"dryrun": {
        "arch": "llama3.2-3b", "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
        "card": nvidia_smi(), "counted_flops": got["flops"],
        "counted_bytes": got["bytes"],
        "flops_by_class": got["flops_by_class"],
        "kernel_calls": got["kernel_calls"], "ops": got["ops"],
        "fake_cpu_flops": fake["flops"], "meta_cpu_flops": meta["flops"],
        "fake_cpu_bytes": fake["bytes"], "meta_cpu_bytes": meta["bytes"],
        "flops_rel_diff": rel, "step_ms": step_s * 1e3,
        "counted_step_ms": counted_s * 1e3,
        "compute_ms": compute_s * 1e3, "memory_ms": memory_s * 1e3,
        "compute_over_step": compute_s / step_s,
        "memory_over_step": memory_s / step_s,
        "fake_count_s": fake_s, "meta_count_s": meta_s,
        "seconds": time.perf_counter() - t_line}})
    if not got["flops"] > 0 or got["kernel_calls"]["flash_attention"] == 0:
        raise AssertionError(f"the counter saw no step on the card: {got}")
    if max(rel.values()) > DRYRUN_FLOP_TOL:
        raise AssertionError(f"the card's counted FLOPs {got['flops']} are "
                             f"not within {DRYRUN_FLOP_TOL} of the CPU's "
                             f"(fake {fake['flops']}, meta {meta['flops']})")


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
def _decode_profile(model, params, cache, tok, tag, steps=8, warm=4,
                    **extra):
    """``warm`` greedy decode steps on ``cache``, ``steps`` timed, then
    ``steps`` more under ``torch.profiler``: the ``tag`` line (busy share,
    kernels, top kernels and host operators a step)."""
    from torch.profiler import ProfilerActivity, profile

    def decode(cache, tok, n):
        for _ in range(n):
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits.argmax(-1)
        return cache, tok

    cache, tok = decode(cache, tok, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, tok = decode(cache, tok, steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode(cache, tok, steps)
        torch.cuda.synchronize()
    log({tag: {"what": "decode_step", **extra,
               **_profile_summary(prof, steps, wall)}})


@torch.no_grad()
def ssm_serve_profile(model, params, batch, single, steps=8,
                      tag="ssm_profile"):
    """Where a recurrent model's serving time goes, outside the counted
    path: greedy decode after a prefill of ``batch`` (4 warm steps,
    ``steps`` steps timed, ``steps`` more under ``torch.profiler``), then
    the prefill of ``single`` (once timed, once profiled); logged as
    ``tag`` lines."""
    from torch.profiler import ProfilerActivity, profile

    logits, cache = model.prefill(params, {"tokens": batch},
                                  batch.shape[1] + 4 + 2 * steps + 1)
    _decode_profile(model, params, cache, logits.argmax(-1), tag, steps,
                    batch=batch.shape[0])
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
            "train": (1, 4096, 4096, True),   # hybrid_train's shape
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
    from repro_torch.kernels.rglru_scan.kernel import linear_scan_cuda

    gen = torch.Generator(device="cuda").manual_seed(77)
    calls, seen = 5, {}
    for dt in (torch.float32, torch.bfloat16):
        a = torch.rand((2, 3072, 4096), generator=gen, device="cuda").to(dt)
        b = torch.randn((2, 3072, 4096), generator=gen, device="cuda").to(dt)
        linear_scan_cuda(a, b)
        torch.cuda.synchronize()
        dev = _device_kernels(lambda: linear_scan_cuda(a, b), calls)
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
            # hybrid_train's shape: one row of 4096, past the window
            "train": (1, 4096, 4096, 0, True),
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
                    if case == "serve":
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
            if case == "train" and dtn == "bfloat16":
                summary["flash_attention@train"] = rec
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


# ---------------------------------------------------------------------------
# Training beyond llama and mamba2, and checkpoints with kill-and-resume
# ---------------------------------------------------------------------------

def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a, b) -> bool:
    """Bit-equal tensors, or equal Python numbers (``OptState.step``)."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _windows(times, every, save_every):
    """Per-step seconds of the windows between consecutive loss logs
    (``times`` at steps every, 2 every, ...), split by whether a save
    fired inside the window: (save windows, plain windows)."""
    saves, plain = [], []
    for j in range(1, len(times)):
        lo, hi = j * every, (j + 1) * every
        per_step = (times[j] - times[j - 1]) / every
        has_save = any(s % save_every == 0 for s in range(lo + 1, hi + 1))
        (saves if has_save else plain).append(per_step)
    return saves, plain


def ckpt_train_phase():
    """``examples/train_100m_torch.py --preset full`` on the card: llama-100m
    (12 layers, d 768, 12 heads over 4 of 64, vocab 32000, fp32), batch 8 x
    1024, 2 x 20 steps around a simulated failure, a save every 10 steps
    through the checkpoint hook (one ``rpc_post`` a firing, as the loss
    hook's), the resume from the newest manifest.  Gates: manifest 40 is
    the newest and ``final_step`` 40; the losses finite and phase 2's
    below phase 1's + 0.5; ``rpc_post`` launches equal to the hooks'
    firings; flash 2 x 12 a step (forward and remat); a bitwise restart:
    the live state after step 40 against the states restored from the
    hook's save (``manifest-20``: a resumed run labels its periodic saves
    with its own step count, as JAX's does) and from the last save
    (``manifest-40``), leaf for leaf, then one more step from each,
    leaf for leaf."""
    import math
    import shutil
    import tempfile
    from repro_torch.ckpt import latest_step, restore_checkpoint
    from repro_torch.core.libc import rand_init
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten_with_paths, leaves

    ex = _example("train_100m_torch")
    cfg = ex.full_100m()
    tmp = tempfile.mkdtemp(prefix="ckpt_train_")
    disk = shutil.disk_usage(tmp)
    half = CKPT_STEPS // 2
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # main path: counts from 0 just before, read just after
        reset_launches(flash_attention_cuda, rpc_post)
        out1, out2 = ex.main(["--preset", "full", "--steps", str(CKPT_STEPS),
                              "--batch", str(CKPT_BATCH), "--seq-len",
                              str(CKPT_SEQ), "--device", "cuda",
                              "--ckpt-dir", tmp])
        torch.cuda.synchronize()
        flash, posts = flash_attention_cuda.launches, rpc_post.launches
        peak = torch.cuda.max_memory_allocated()
        newest = latest_step(tmp)
        every, log_every = max(half // 2, 1), max(half // 4, 1)
        firings = sum(half // every + len(o["losses"]) for o in (out1, out2))

        # the bitwise restart
        live = out2.pop("state")
        like = {"values": live["values"], "opt": live["opt"]}
        t0 = time.perf_counter()
        _, hooked = restore_checkpoint(tmp, like, step=half)
        _, last = restore_checkpoint(tmp, like, step=CKPT_STEPS)
        torch.cuda.synchronize()
        restore_s = (time.perf_counter() - t0) / 2
        restored_equal = all(
            _same(a, b) and _same(a, c)
            for a, b, c in zip(leaves(like), leaves(hooked), leaves(last)))
        model = build_model(cfg, device="cuda")
        step_fn = make_train_step(model, OptConfig(
            lr=3e-3, warmup_steps=max(half // 10, 1), total_steps=half))
        _, batch = SyntheticLM(cfg.vocab_size, CKPT_SEQ, CKPT_BATCH).batch_at(
            rand_init(1234, device="cuda"), CKPT_STEPS)
        va, oa, ma = step_fn(like["values"], like["opt"], batch)
        vb, ob, mb = step_fn(hooked["values"], hooked["opt"], batch)
        after = [flatten_with_paths({"values": v, "opt": o})
                 for v, o in ((va, oa), (vb, ob))]
        diff = {p: float((a.float() - after[1][p].float()).abs().max())
                if isinstance(a, torch.Tensor) else float(a != after[1][p])
                for p, a in after[0].items()}
        differing = [p for p, d in diff.items() if d]
        loss_equal = torch.equal(ma["loss"], mb["loss"])
        # the named nondeterministic op: the embedding's backward
        # (index_add_, atomics) twice on this step's rows
        tokens = batch["tokens"].reshape(-1)
        dy = torch.randn((tokens.numel(), cfg.d_model), device="cuda")
        adds = [torch.zeros((cfg.vocab_size, cfg.d_model), device="cuda")
                .index_add_(0, tokens, dy) for _ in range(2)]
        index_add_equal = torch.equal(*adds)
        del adds, dy

        losses = {f"phase{i}": [l for _, l in o["losses"]]
                  for i, o in ((1, out1), (2, out2))}
        saves, plain = [], []
        for o in (out1, out2):
            s, p = _windows(o["log_times"], log_every, every)
            saves += s
            plain += p
        step_s = sum(plain) / len(plain)
        writes = out1["ckpt_writes"] + out2["ckpt_writes"]
        rec = {
            "arch": cfg.name, "params": cfg.num_params(),
            "layers": cfg.num_layers, "batch": CKPT_BATCH,
            "seq_len": CKPT_SEQ, "steps": CKPT_STEPS, "ckpt_every": every,
            "losses": losses, "final_step": out2["final_step"],
            "latest_step": newest, "ms_per_step": step_s * 1e3,
            "tokens_per_s": CKPT_BATCH * CKPT_SEQ / step_s,
            # a save window holds one save in log_every steps
            "save_stall_ms": [(x - step_s) * log_every * 1e3
                              for x in saves],
            "save_windows_ms_per_step": [x * 1e3 for x in saves],
            "plain_windows_ms_per_step": [x * 1e3 for x in plain],
            "hook_host_s": [h[1] for o in (out1, out2)
                            for h in o["ckpt_hook_s"]],
            "bytes_per_save": writes[0][2],
            "writer_s": [w[1] for w in writes],
            "saves": [w[0] for w in writes],
            "resume_restore_s": out2["restore_s"],
            "restore_s": restore_s,
            "restored_equal_live": restored_equal,
            "next_step_loss_equal": loss_equal,
            "next_step_max_abs_diff": max(diff.values()),
            "next_step_tol": CKPT_STEP_TOL,
            "next_step_differing_leaves": len(differing),
            "next_step_first_differing": differing[:6],
            "index_add_twice_equal": index_add_equal,
            "flash_launches": flash,
            "expected_flash": 2 * cfg.num_layers * CKPT_STEPS,
            "rpc_post_launches": posts, "hook_firings": firings,
            "peak_mem_gb": peak / 1e9, "disk_free_gb": disk.free / 1e9,
            "seconds": [out1["seconds"], out2["seconds"]]}
        log({"ckpt_train": rec})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    all_losses = losses["phase1"] + losses["phase2"]
    if not all(math.isfinite(x) for x in all_losses):
        raise AssertionError(f"ckpt_train losses not finite: {losses}")
    if not out2["final_loss"] < out1["final_loss"] + 0.5:
        raise AssertionError(f"ckpt_train: phase 2's loss rose: {losses}")
    if newest != CKPT_STEPS or out2["final_step"] != CKPT_STEPS:
        raise AssertionError(f"ckpt_train: newest manifest {newest}, final "
                             f"step {out2['final_step']}, want {CKPT_STEPS}")
    if posts != firings:
        raise AssertionError(f"ckpt_train: the hooks fired {firings} times "
                             f"and rpc_post launched {posts} times")
    if flash != 2 * cfg.num_layers * CKPT_STEPS:
        raise AssertionError(f"ckpt_train: flash launched {flash} times")
    if not (restored_equal and loss_equal
            and max(diff.values()) <= CKPT_STEP_TOL):
        raise AssertionError(f"ckpt_train: the restart is not bitwise: "
                             f"restored {restored_equal}, next loss "
                             f"{loss_equal}, next step's max abs diff "
                             f"{max(diff.values())} (tolerance "
                             f"{CKPT_STEP_TOL})")
    del live, like, hooked, last, va, oa, vb, ob, model
    torch.cuda.empty_cache()
    return {"flash_attention": flash, "rpc_post": posts}


#: mesh_train: phi3.5-moe's depth cut (of 32 layers), its steps, the
#: kill-and-resume's steps a part, and the losses' tolerance against runs
#: whose embedding backward (``index_add_``, atomics) is not bitwise
#: repeatable on the card; the first step, before any update, is exact.
MESH_MOE_LAYERS, MESH_MOE_STEPS = 2, 3
MESH_CKPT_STEPS = 2
MESH_LOSS_RTOL = 1e-4


class _Killed(RuntimeError):
    """The failure :func:`_killed_at` injects."""


@contextlib.contextmanager
def _killed_at(step):
    """With ``step``, ``launch/train.py::run``'s training step raises
    :class:`_Killed` when called for the ``step``-th time (a run that
    fails mid-way); without, nothing."""
    if step is None:
        yield
        return
    import repro_torch.launch.train as train
    real = train.make_train_step

    def dying(*args, **kwargs):
        fn, calls = real(*args, **kwargs), []

        def step_fn(*a):
            calls.append(1)
            if len(calls) == step:
                raise _Killed(f"killed in step {step}")
            return fn(*a)
        return step_fn

    train.make_train_step = dying
    try:
        yield
    finally:
        train.make_train_step = real


def _mesh_counts(*fns):
    return {fn.__name__: fn.launches for fn in fns}


def mesh_train_phase(train_losses):
    """Meshes, the model side, on the card: a world of one process
    (``nccl``) and its one-device ``("data", "model")`` (1, 1) mesh, every
    run through ``launch/train.py::run(mesh=)`` (blocks, the sharded step,
    ``device_run(mesh=)``: its hooks stage on the sharded queue, one
    ``rpc_enqueue`` a firing and one ``rpc_post`` a run).  Gates, each
    failing the run:

    * (a) llama3.2-3b at full width and depth, as ``train``: 4 steps of 2 x
      1024, remat "full"; the losses are ``train``'s (the first exactly,
      the rest within :data:`MESH_LOSS_RTOL`) and flash launches 2 x 28 a
      step;
    * (b) phi3.5-moe at full width, :data:`MESH_MOE_LAYERS` of 32 layers,
      3 steps of 2 x 1024 through the expert-parallel path (ep 1): the
      losses finite, the capacity drops a step at the config's 1.25
      printed, flash 2 x 2 a step; and its MoE layer under the mesh at a
      capacity that drops nothing against ``moe_reference`` within bf16's
      tolerance;
    * (c) ``ckpt_train``'s llama-100m, a run of 4 steps with a save every
      2 that fails in its third step (:func:`_killed_at`): the save of
      step 2 is on disk and no later one; the last 2 steps resumed from
      it with ``restore_checkpoint(shardings=)`` log the losses of 4
      steps uninterrupted, within :data:`MESH_LOSS_RTOL`.

    The launch counts are set to 0 just before each run and read just
    after.  The world is left after the phase."""
    import dataclasses
    import math
    import shutil
    import tempfile
    from repro_torch import configs as registry
    from repro_torch.ckpt import latest_step
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingCtx, rows_over
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.rpc_queue import rpc_enqueue
    from repro_torch.launch.mesh import close_world, init_world, make_mesh
    from repro_torch.launch.train import run
    from repro_torch.models import moe

    kernels = (flash_attention_cuda, rpc_post, rpc_enqueue)
    t_phase = time.perf_counter()
    init_world(device="cuda")
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    world_s = time.perf_counter() - t_phase
    tmp = tempfile.mkdtemp(prefix="mesh_ckpt_")
    rec, launches = {"world_s": world_s}, {}

    def one(tag, *args, kill_at=None, **kw):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # main path: counts from 0 just before, read just after
        reset_launches(*kernels)
        try:
            with _killed_at(kill_at):
                out = run(*args, device="cuda", mesh=mesh, **kw)
        except _Killed:
            # the failed run's logged losses were staged on the sharded
            # queue, which drains only when the run ends
            out = {"losses": [], "seconds": None, "killed": True}
        torch.cuda.synchronize()
        launches[tag] = _mesh_counts(*kernels)
        rec[tag] = {"losses": [l for _, l in out["losses"]],
                    "seconds": out["seconds"],
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": launches[tag]}
        return out

    try:
        # (a) llama3.2-3b at full width and depth
        one("llama", "llama3.2-3b", preset="full", steps=TRAIN_STEPS,
            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=1)
        got = rec["llama"]["losses"]
        rec["llama"]["train_losses"] = train_losses
        rec["llama"]["max_rel_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(got, train_losses))
        # (b) phi3.5-moe at full width, cut in depth, its drops a step
        cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                                  name="phi3.5-moe-mesh",
                                  num_layers=MESH_MOE_LAYERS)
        registry.CONFIGS[cfg.name] = cfg
        with moe.record_drops() as drops:
            one("moe", cfg.name, preset="full", steps=MESH_MOE_STEPS,
                batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=1)
        per = len(drops) // MESH_MOE_STEPS
        rec["moe"].update(
            params=cfg.num_params(), layers=cfg.num_layers,
            capacity_factor=cfg.capacity_factor,
            drops_per_step=[float(sum(drops[i * per:(i + 1) * per]))
                            for i in range(MESH_MOE_STEPS)],
            assignments_per_step=TRAIN_BATCH * TRAIN_SEQ *
            cfg.experts_per_token * cfg.num_layers)
        del drops
        torch.cuda.empty_cache()
        rec["moe_layer"] = _mesh_moe_layer(cfg, mesh, moe, ShardingCtx,
                                           rows_over)
        # (c) the kill-and-resume of ckpt_train's llama-100m
        c100 = _example("train_100m_torch").full_100m()
        registry.CONFIGS[c100.name] = c100
        kw = dict(preset="full", batch=CKPT_BATCH, seq_len=CKPT_SEQ,
                  lr=3e-3, log_every=1, total_steps=2 * MESH_CKPT_STEPS)
        part1 = one("ckpt_part1", c100.name, steps=2 * MESH_CKPT_STEPS,
                    ckpt_dir=tmp, ckpt_every=MESH_CKPT_STEPS,
                    kill_at=MESH_CKPT_STEPS + 1, **kw)
        newest = latest_step(tmp)
        manifests = sorted(n for n in os.listdir(tmp)
                           if n.startswith("manifest"))
        part2 = one("ckpt_part2", c100.name, steps=MESH_CKPT_STEPS,
                    ckpt_dir=tmp, resume=True, **kw)
        one("ckpt_whole", c100.name, steps=2 * MESH_CKPT_STEPS, **kw)
        rec["ckpt"] = {"arch": c100.name,
                       "killed_in_step": MESH_CKPT_STEPS + 1,
                       "killed": bool(part1.get("killed")),
                       "manifests": manifests, "newest_manifest": newest,
                       "resumed_from": part2["start_step"],
                       "restore_s": part2["restore_s"]}
    finally:
        close_world()     # the later phases run without a process group
        shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    log({"mesh_train": rec})

    def same(a, b):
        return len(a) == len(b) and a[:1] == b[:1] and all(
            abs(x - y) <= MESH_LOSS_RTOL * abs(y) for x, y in zip(a, b))

    L = get_config("llama3.2-3b").num_layers
    resumed = rec["ckpt_part2"]["losses"]
    after = rec["ckpt_whole"]["losses"][MESH_CKPT_STEPS:]
    checks = {
        "llama_losses_are_train_s": same(rec["llama"]["losses"],
                                         train_losses),
        "llama_flash": launches["llama"]["flash_attention_cuda"] ==
        2 * L * TRAIN_STEPS,
        "moe_losses_finite": len(rec["moe"]["losses"]) == MESH_MOE_STEPS
        and all(math.isfinite(x) for x in rec["moe"]["losses"]),
        "moe_flash": launches["moe"]["flash_attention_cuda"] ==
        2 * MESH_MOE_LAYERS * MESH_MOE_STEPS,
        "moe_layer_within_bf16": rec["moe_layer"]["ok"],
        "moe_layer_no_drops": rec["moe_layer"]["drops"] == 0.0,
        "killed_mid_run": rec["ckpt"]["killed"] and
        rec["ckpt"]["manifests"] == [f"manifest-{MESH_CKPT_STEPS}.json"],
        "resume_losses_are_uninterrupted": len(resumed) == len(after) ==
        MESH_CKPT_STEPS and all(abs(x - y) <= MESH_LOSS_RTOL * abs(y)
                                for x, y in zip(resumed, after)),
        "resume_from_the_save": rec["ckpt"]["newest_manifest"] ==
        MESH_CKPT_STEPS == rec["ckpt"]["resumed_from"],
        # one staged record a logged step and one post a run; the failed
        # run staged its steps before the failure and posted nothing
        "hook_launches": all(
            (launches[t]["rpc_enqueue"], launches[t]["rpc_post"]) ==
            ((MESH_CKPT_STEPS, 0) if t == "ckpt_part1" else
             (len(rec[t]["losses"]), 1)) for t in launches),
    }
    log({"mesh_train_checks": checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"mesh_train: failed {bad}")
    return {"flash_attention": sum(c["flash_attention_cuda"]
                                   for c in launches.values()),
            "rpc_post": sum(c["rpc_post"] for c in launches.values()),
            "rpc_enqueue": sum(c["rpc_enqueue"] for c in launches.values())}


def _mesh_moe_layer(cfg, mesh, moe, ShardingCtx, rows_over):
    """phi3.5-moe's MoE layer at full width on 2 x 1024 bf16 tokens under
    the (1, 1) mesh (``_moe_local``, ep 1) at a capacity for every
    assignment, against the dense ``moe_reference``."""
    import dataclasses
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe.moe_init(gen, cfg)
    x = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                     device="cuda") * 0.5).to(torch.bfloat16)
    roomy = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    with torch.no_grad():
        with ShardingCtx(mesh), rows_over(("data", "model")), \
                moe.record_drops() as drops:
            y, aux = moe.moe_apply(p, x, roomy)
        ref, aux_ref = moe.moe_reference(p, x.reshape(-1, cfg.d_model), cfg)
    err, ok = _close(y.reshape(ref.shape), ref, "bfloat16")
    out = {"tokens": TRAIN_BATCH * TRAIN_SEQ, "max_abs_err": err,
           "tol": TOL["bfloat16"], "ok": ok,
           "aux": float(aux), "aux_ref": float(aux_ref),
           "drops": float(sum(drops))}
    del p, x, y, ref
    torch.cuda.empty_cache()
    return out


def _hybrid_train_cfg():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import hybrid_layer_kinds
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              name=f"recurrentgemma-9b-l{HYBRID_TRAIN_LAYERS}",
                              num_layers=HYBRID_TRAIN_LAYERS)
    kinds = hybrid_layer_kinds(cfg)
    assert (cfg.d_model, cfg.lru_width, cfg.padded_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.local_window) == (4096, 4096, 16, 1, 256, 12288, 256000, 2048)
    return cfg, kinds.count("rec"), kinds.count("attn")


def _steady(times):
    """Mean seconds a step over steps 2..n of per-step log times."""
    steady = [b - a for a, b in zip(times, times[1:])]
    return sum(steady) / len(steady)


def hybrid_train_phase():
    """Item 1.2: recurrentgemma-9b at full width (d_model 4096, lru_width
    4096, 16 heads of 256 over 1, d_ff 12288, vocab 256000, window 2048),
    its depth cut from 38 to ``HYBRID_TRAIN_LAYERS`` (three (rec, rec,
    attn) blocks: full depth with AdamW state is ~153 GB), registered at
    run time and trained through ``launch/train.run`` for 4 steps of 1 x
    4096 tokens (past the window) in bf16.  Gates: finite losses, exact
    launches: rglru_scan 2 a recurrent layer a step and flash 2 an
    attention layer a step (forward and remat recompute), ``rpc_post`` one
    a loss log."""
    import math
    from repro_torch import configs as registry
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rglru_scan.kernel import linear_scan_cuda
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.launch.train import run

    cfg, n_rec, n_attn = _hybrid_train_cfg()
    registry.CONFIGS[cfg.name] = cfg
    B, S, steps = HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ, HYBRID_TRAIN_STEPS
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # main path: counts from 0 just before, read just after
        reset_launches(flash_attention_cuda, linear_scan_cuda, rpc_post)
        out = run(cfg.name, preset="full", steps=steps, batch=B, seq_len=S,
                  log_every=1, device="cuda")
        torch.cuda.synchronize()
    finally:
        del registry.CONFIGS[cfg.name]
    flash, scans, posts = (flash_attention_cuda.launches,
                           linear_scan_cuda.launches, rpc_post.launches)
    by_variant = dict(flash_attention_cuda.launches_by_variant)
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in out["losses"]]
    step_s = _steady(out["log_times"])
    D, H = cfg.resolved_head_dim, cfg.num_heads
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.d_model
    attn = 3 * 4 * D * H * B * n_attn * _visible_pairs(
        S, S, True, cfg.local_window, 0)
    flops = 6 * n_matmul * B * S + attn
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "rec_layers": n_rec,
           "attn_layers": n_attn, "params": cfg.num_params(),
           "cut": "depth 38 -> %d" % cfg.num_layers, "steps": steps,
           "batch": B, "seq_len": S, "losses": losses,
           "first_step_s": out["log_times"][0], "ms_per_step": step_s * 1e3,
           "tokens_per_s": B * S / step_s, "model_flops_per_step": flops,
           "train_mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
           "rglru_scan_launches": scans,
           "expected_rglru": 2 * n_rec * steps, "flash_launches": flash,
           "expected_flash": 2 * n_attn * steps,
           "flash_launches_by_variant": by_variant,
           "rpc_post_launches": posts, "peak_mem_gb": peak / 1e9,
           "seconds": out["seconds"]}
    log({"hybrid_train": rec})
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"hybrid training losses not finite: {losses}")
    if scans != 2 * n_rec * steps or flash != 2 * n_attn * steps:
        raise AssertionError(f"hybrid_train launches: rglru_scan {scans}, "
                             f"flash {flash}; want {2 * n_rec * steps}, "
                             f"{2 * n_attn * steps}")
    if posts != steps:
        raise AssertionError(f"hybrid_train: {posts} rpc_post, {steps} logs")
    torch.cuda.empty_cache()
    return {"flash_attention": flash, "rglru_scan": scans, "rpc_post": posts}


def _family_train(cfg, steps, batch, microbatches=1):
    """``make_train_step`` on one ``make_synthetic_batch`` batch inside
    ``device_run`` with an immediate loss hook every step, from the random
    weights of ``Model.init(0)``.  Returns (losses, ms a step over steps
    2..n, peak GB)."""
    from repro_torch.core.device_main import HostHook, device_run
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.step import make_train_step

    model = build_model(cfg, device="cuda")
    values = model.init(0)
    opt = adamw_init(values)
    step_fn = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1,
                                               total_steps=steps),
                              microbatches=microbatches)
    losses, times = [], []

    def log_loss(step, loss):
        times.append(time.perf_counter())
        losses.append(float(loss))

    def step(i, state):
        v, o, m = step_fn(state["values"], state["opt"], batch)
        return {"values": v, "opt": o, "loss": m["loss"]}

    state = device_run(step, {"values": values, "opt": opt,
                              "loss": torch.zeros((), device="cuda")},
                       steps, hooks=[HostHook(
                           every=1, extract=lambda i, s: {"loss": s["loss"]},
                           host_fn=log_loss)])
    float(state["loss"])
    return losses, _steady(times) * 1e3


def encdec_train_phase():
    """seamless-m4t-large-v2 at full width and depth (24 + 24 layers, 16
    heads over 16 of 64, vocab 256206, bf16), 4 steps of 2 x 1024 frame
    embeddings and 1024 decoder tokens from ``make_synthetic_batch``.
    Gates: finite losses; flash 2 x (24 encoder + 24 decoder-self + 24
    cross) a step (forward and remat), ``rpc_post`` one a loss log."""
    import math
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_synthetic_batch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rpc_channel import rpc_post

    cfg = _seamless_cfg()
    steps, B, S = ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ
    batch = make_synthetic_batch(cfg, ShapeConfig("encdec_train", S, B,
                                                  "train"), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # main path: counts from 0 just before, read just after
    reset_launches(flash_attention_cuda, rpc_post)
    losses, ms = _family_train(cfg, steps, batch)
    torch.cuda.synchronize()
    flash, posts = flash_attention_cuda.launches, rpc_post.launches
    per_step = 2 * (cfg.encoder_layers + 2 * cfg.decoder_layers)
    rec = {"arch": cfg.name, "encoder_layers": cfg.encoder_layers,
           "decoder_layers": cfg.decoder_layers, "params": cfg.num_params(),
           "steps": steps, "batch": B, "frames": S, "tokens": S,
           "batch_keys": sorted(batch), "losses": losses, "ms_per_step": ms,
           "tokens_per_s": B * S / ms * 1e3, "flash_launches": flash,
           "expected_flash": per_step * steps, "rpc_post_launches": posts,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log({"encdec_train": rec})
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"encdec training losses not finite: {losses}")
    if flash != per_step * steps or posts != steps:
        raise AssertionError(f"encdec_train: flash {flash} (want "
                             f"{per_step * steps}), rpc_post {posts}")
    del batch
    torch.cuda.empty_cache()
    return {"flash_attention": flash, "rpc_post": posts}


def vlm_train_phase():
    """qwen2-vl-2b at full width and depth (28 layers, 12 heads padded to 16
    over 2 of 128, M-RoPE (16, 24, 24), bf16), 4 steps of 2 x 1024
    embeddings with ``labels`` and ``positions`` (3, 2, 1024) from
    ``make_synthetic_batch``, at ``microbatches=2`` (the positions split on
    their row axis).  Gates: finite losses; flash 2 a layer a microbatch a
    step (forward and remat), ``rpc_post`` one a loss log."""
    import math
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_synthetic_batch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rpc_channel import rpc_post

    cfg = _vlm_cfg()
    steps, B, S, k = (VLM_TRAIN_STEPS, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ,
                      VLM_TRAIN_MICROBATCHES)
    batch = make_synthetic_batch(cfg, ShapeConfig("vlm_train", S, B,
                                                  "train"), device="cuda")
    assert tuple(batch["positions"].shape) == (3, B, S)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # main path: counts from 0 just before, read just after
    reset_launches(flash_attention_cuda, rpc_post)
    losses, ms = _family_train(cfg, steps, batch, microbatches=k)
    torch.cuda.synchronize()
    flash, posts = flash_attention_cuda.launches, rpc_post.launches
    want = 2 * cfg.num_layers * k * steps
    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "params": cfg.num_params(), "steps": steps, "batch": B,
           "seq_len": S, "microbatches": k, "batch_keys": sorted(batch),
           "losses": losses, "ms_per_step": ms,
           "tokens_per_s": B * S / ms * 1e3, "flash_launches": flash,
           "expected_flash": want, "rpc_post_launches": posts,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log({"vlm_train": rec})
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"vlm training losses not finite: {losses}")
    if flash != want or posts != steps:
        raise AssertionError(f"vlm_train: flash {flash} (want {want}), "
                             f"rpc_post {posts}")
    del batch
    torch.cuda.empty_cache()
    return {"flash_attention": flash, "rpc_post": posts}


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
    sizes = _one_callee_sizes(dev)
    checks["one_callee_sizes"] = all(
        r["bit_equal"] and r["launches"] == 1 for r in sizes["calls"]) \
        and sizes["pads"] == 1 and len(set(sizes["staging_ids"])) == 3
    plans = _rpc_plan_cases(dev)
    checks.update(plans.pop("checks"))
    log({"rpc": {"cases": rec, "checks": checks,
                 "one_callee_sizes": sizes, "plans": plans}})
    if not all(checks.values()):
        raise AssertionError(f"rpc checks failed: {checks}")
    return 0.0


def _rpc_plan_cases(dev):
    """The call plan's cases, each against the host-synchronous version on
    the same inputs, bit-equal, one ``rpc_post`` launch a call:

    * ``routes``: a 4 KB READWRITE ref (at most ``COPY_LIMIT``: the kernel
      copies it) beside one of 2 x ``COPY_LIMIT`` (a copy engine around
      the launch) in one call: the launch's table holds both routes, and
      the call makes 3 CUDA API calls (the big ref's two copies and the
      launch); the 4 KB ref alone makes 1;
    * ``max_slots``: as many tensor slots as the descriptor holds
      (``MAX_SLOTS``: 447 READWRITE refs, their write-backs, 449 values
      and the result, of 2 to 256 bytes and int32, float32, bf16 and
      int16), and one more refused; its grid has several blocks (a
      cooperative launch), and only the blocks that copy results back
      (``out_grid``, fewer) wait for the host;
    * ``graph_replay``: a call captured into a CUDA graph on a stream of
      its own, replayed twice: two records posted (the channel's device
      sequence counter), the callee run twice, the graph's outputs those
      of the second replay; the capture is the one host launch.  Its
      32 KB ref makes a grid of several blocks: a cooperative launch in
      a graph."""
    import numpy as np
    from repro_torch.core import (READWRITE, Ref, ShapeDtype,
                                  effects_barrier, rpc_call,
                                  rpc_call_reference)
    from repro_torch.core.rpc import REGISTRY
    from repro_torch.kernels.rpc_channel import (COPY_LIMIT, ENGINE, KERNEL,
                                                 MAX_SLOTS, channel_for,
                                                 rpc_post)
    from repro_torch.kernels.rpc_channel.kernel import api_calls

    i32 = ShapeDtype((), torch.int32)
    checks, rec = {}, {}

    def both(name, *args):
        """The channel's call and the plain one, with launches and CUDA
        API calls of the channel's."""
        calls0, rpc_post.launches = api_calls(), 0
        chan = rpc_call(name, *args, result_shape=i32)
        launches, api = rpc_post.launches, api_calls() - calls0
        plain = rpc_call_reference(name, *args, result_shape=i32)
        effects_barrier()
        equal = _same_tensor(chan[0], plain[0]) and all(
            _same_tensor(a, b) for a, b in zip(chan[1], plain[1]))
        return equal, launches, api

    def bump(small, big):
        small[:] = small * 3 + 1
        big[::4097] += 1.5
        return np.int32(small.size + big.size)

    REGISTRY.register("smoke.bump", bump)
    small = torch.arange(1024, dtype=torch.float32, device=dev)
    big = torch.linspace(0, 1, 2 * COPY_LIMIT // 4, device=dev)
    equal, launches, api = both("smoke.bump", Ref(small, READWRITE),
                                Ref(big, READWRITE))
    sizes = [4096, 2 * COPY_LIMIT, 4, 4096, 2 * COPY_LIMIT]
    (launch,) = [d for d in channel_for(dev).launches.values()
                 if d.bytes == sizes]
    routes = [row[3] for row in launch.table]
    REGISTRY.register("smoke.bump_small", lambda s: bump(s, np.zeros(0)))
    equal_small, launches_small, api_small = both(
        "smoke.bump_small", Ref(small, READWRITE))
    rec["routes"] = {"table": [list(r) for r in launch.table],
                     "bit_equal": equal and equal_small,
                     "launches": [launches, launches_small],
                     "cuda_api_calls": [api, api_small],
                     "grid": launch.call.grid}
    checks["plan_routes"] = equal and equal_small \
        and [launches, launches_small] == [1, 1] \
        and [api, api_small] == [3, 1] \
        and routes == [KERNEL, ENGINE, KERNEL, KERNEL, ENGINE]

    n_refs = (MAX_SLOTS - 1) // 3
    n_vals = MAX_SLOTS - 1 - 2 * n_refs
    dtypes = (torch.int32, torch.float32, torch.bfloat16, torch.int16)

    def many(*arrays):
        total = 0
        for k, a in enumerate(arrays):
            total += int(np.asarray(a, np.float64).sum())
            if k < n_refs:
                a[...] = a * 2 + k
        return np.int32(total)

    REGISTRY.register("smoke.many", many)
    args = [Ref((torch.arange(k % 64 + 1, device=dev) % 7).to(dtypes[k % 4]),
                READWRITE) for k in range(n_refs)] + \
        [(torch.arange(k % 61 + 2, device=dev) % 5).to(dtypes[k % 4])
         for k in range(n_vals)]
    equal, launches, api = both("smoke.many", *args)
    refused = False
    try:
        rpc_call("smoke.many", *args, torch.zeros(2, device=dev),
                 result_shape=i32)
    except ValueError as e:
        refused = "tensor slots" in str(e)
    (table,) = [d for d in channel_for(dev).launches.values()
                if len(d.table) == MAX_SLOTS]
    grid, out_grid = table.call.grid, table._params.out_grid
    rec["max_slots"] = {"slots": len(table.table), "bit_equal": equal,
                        "launches": launches, "cuda_api_calls": api,
                        "grid": grid, "out_grid": out_grid,
                        "one_more_refused": refused}
    checks["plan_max_slots"] = equal and launches == 1 and api == 1 \
        and refused and 1 <= out_grid < grid

    seen = []

    def count(x, buf):
        seen.append(int(x))
        buf[:] = buf + float(len(seen))
        return np.int32(len(seen) * 10 + int(x))

    REGISTRY.register("smoke.count", count)
    side = torch.cuda.Stream(dev)
    x = torch.full((), 7, dtype=torch.int32, device=dev)
    buf = torch.zeros(8192, device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        rpc_call("smoke.count", x, Ref(buf, READWRITE), result_shape=i32)
    side.synchronize()
    effects_barrier()
    graph = torch.cuda.CUDAGraph()
    rpc_post.launches = 0
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        out, (back,) = rpc_call("smoke.count", x, Ref(buf, READWRITE),
                                result_shape=i32)
    captured = rpc_post.launches
    seq0 = int(channel_for_stream(side, dev).counter[0])
    del seen[:]
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    effects_barrier()
    seq1 = int(channel_for_stream(side, dev).counter[0])
    want_out = torch.tensor(2 * 10 + 7, dtype=torch.int32)
    want_back = torch.full((8192,), 2.0)
    (grid,) = [d.call.grid for d in
               channel_for_stream(side, dev).launches.values()]
    rec["graph_replay"] = {"launches_at_capture": captured,
                           "launches_at_replay": rpc_post.launches - captured,
                           "records_posted": seq1 - seq0,
                           "callee_runs": len(seen), "result": int(out),
                           "grid": grid}
    checks["plan_graph_replay"] = captured == 1 and grid > 1 \
        and rpc_post.launches == captured and seq1 - seq0 == 2 \
        and seen == [7, 7] and _same_tensor(out, want_out) \
        and _same_tensor(back, want_back)
    del graph
    return {"checks": checks, **rec}


def channel_for_stream(stream, dev):
    """The RPC channel of ``stream`` on ``dev``."""
    from repro_torch.kernels.rpc_channel import channel_for
    with torch.cuda.stream(stream):
        return channel_for(dev)


def _one_callee_sizes(dev):
    """One callee returning 1, 64 and 1024 int32 elements on one channel,
    then 1 again (``benchmarks/rpc_bench.py``'s ``bench.reply``): one
    landing pad, a staging region a result shape on the channel.  Each call
    against the host-synchronous version, bit-equal, one rpc_post a call;
    the values are ``arange(P) + i``."""
    import numpy as np
    from repro_torch.core import (ShapeDtype, effects_barrier, pad_stats,
                                  rpc_call, rpc_call_reference, rpc_stats)
    from repro_torch.core.rpc import REGISTRY, staging_key
    from repro_torch.kernels.rpc_channel import channel_for, rpc_post

    REGISTRY.register("smoke.reply", lambda i, p: np.arange(
        int(p), dtype=np.int32) + int(i))
    calls = []
    for i, P in enumerate((1, 64, 1024, 1)):
        spec = ShapeDtype((P,), torch.int32)
        arg = torch.full((), i, dtype=torch.int32, device=dev)
        rpc_post.launches = 0
        chan, _ = rpc_call("smoke.reply", arg, P, result_shape=spec)
        launches = rpc_post.launches
        plain, _ = rpc_call_reference("smoke.reply", arg, P,
                                      result_shape=spec)
        effects_barrier()
        want = torch.arange(P, dtype=torch.int32) + i
        calls.append({"elements": P, "launches": launches,
                      "bit_equal": _same_tensor(chan, plain)
                      and _same_tensor(chan, want)})
    (pid,) = [k for k, v in pad_stats().items()
              if REGISTRY.pad_info[k][0] == "smoke.reply"]
    stagings = channel_for(dev).stagings.ids
    return {"calls": calls, "pads": rpc_stats("smoke.reply")["pads"],
            "pad_calls": pad_stats(pid)["calls"],
            "staging_ids": [stagings[staging_key(pid, ShapeDtype(
                (P,), torch.int32))] for P in (1, 64, 1024)]}


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
    post to reply, the drain thread's time in Python and its wait for
    Python's lock before it (``drain_gil_us``), the CUDA API calls a call,
    and the events' time when a 1 GB add ahead on the stream hides the
    enqueue); the same call after 60 ms idle (``isolated``: the drain
    asleep, woken by the launch); the latency floor (``latency_floor``:
    records answered by a C loop, no Python); the enqueue's split (Python
    before the op, the op's dispatch, the launch's Python, the C call);
    READWRITE refs of 4 KB, 1 MB and 64 MB (GB/s both ways against the
    host link's rate from ``nvidia-smi``, or the data sheet's where it
    reports none); and both copy routes at 4 KB-64 MB on one slot
    (``routes``: the kernel's copies against the copy engines', bit-equal,
    in turns), from which ``kernel.py::COPY_LIMIT`` was set.  The
    host-synchronous times are wall times (that version waits for the
    device by design).  Returns the empty call's numbers for the kernels
    line."""
    import numpy as np
    from repro_torch.core import (Ref, ShapeDtype, effects_barrier, rpc_call,
                                  rpc_call_reference)
    from repro_torch.core.rpc import REGISTRY, _result_specs, plan_key
    from repro_torch.kernels.rpc_channel import COPY_LIMIT, channel_for
    from repro_torch.kernels.rpc_channel.kernel import (_lib, api_calls,
                                                        latency_floor)
    from repro_torch.kernels.rpc_channel.ops import _ANCHORS, _OP

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

    def one(fn, ahead=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if ahead is not None:
            ahead()
        t0 = time.perf_counter()
        a.record()
        fn()
        enq = (time.perf_counter() - t0) * 1e6
        b.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return (a.elapsed_time(b), wall, enq, chan.waited_ns() * 1e-3,
                chan.last_serve_ns * 1e-3, chan.last_gil_ns * 1e-3)

    def summary(rows, n, api=None):
        cols = list(zip(*rows))
        out = {k: _median(c) for k, c in zip(
            ("ms", "wall_ms", "enqueue_us", "kernel_wait_us",
             "host_serve_us", "drain_gil_us"), cols)}
        out["calls"] = n
        if api is not None:
            out["cuda_api_calls_per_call"] = api / n
        return out

    def on_channel(fn, n, ahead=None):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        calls0 = api_calls()
        rows = [one(fn, ahead) for _ in range(n)]
        return summary(rows, n, api_calls() - calls0)

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
                     behind_busy_stream_kernel_wait_us=busy["kernel_wait_us"],
                     behind_busy_stream_host_serve_us=busy["host_serve_us"],
                     behind_busy_stream_drain_gil_us=busy["drain_gil_us"])
    del ahead
    rows = []
    for _ in range(10):
        time.sleep(0.06)
        rows.append(one(call_empty))
    empty_rec["isolated"] = dict(summary(rows, 10), idle_ms=60)
    empty_rec["latency_floor"] = latency_floor(dev, 200)
    empty_rec["enqueue_split"] = _enqueue_split(
        chan, call_empty, dev, _OP, _ANCHORS,
        chan.plans[plan_key(REGISTRY.pads[("smoke.empty",)],
                            _result_specs(i32))], _lib())
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
    routes = _copy_routes(chan, dev)
    link = pcie_link()                   # read just after the 64 MB calls
    rate = link["bytes_per_s"]
    for r in [empty_rec] + list(refs.values()):
        moved = 2 * r.get("bytes_each_way", 0) + 4
        r["bound_ms"] = moved / rate * 1e3 if rate else None
        r["gb_per_s"] = moved / (r["ms"] * 1e-3) / 1e9
        r["plain_gb_per_s"] = moved / (r["plain_ms"] * 1e-3) / 1e9
    log({"rpc_time": {"card": card_line, "link": link, "empty": empty_rec,
                      "readwrite": refs, "copy_limit": COPY_LIMIT,
                      "routes": routes}})
    if empty_rec["cuda_api_calls_per_call"] != 1 or \
            refs["4KB"]["cuda_api_calls_per_call"] != 1:
        raise AssertionError("rpc_time: a call with no slot above the "
                             "limit made more than one CUDA API call")
    return empty_rec


def _enqueue_split(chan, call, dev, op, anchors, plan, lib, n=200):
    """The host's enqueue of ``call`` (an empty call on ``chan``) cut in
    four, median us of ``n`` calls of each, in turns, each followed by a
    synchronise (outside the time): the whole ``rpc_call``; the op called
    with the plan's arguments (``op_us``); the plan's ``Launch.run`` (the
    launch's Python and the C call); the C call alone (``rpc_roundtrip``
    through ctypes).  ``python_us`` = whole - op, ``dispatch_us`` = op -
    run, ``launch_python_us`` = run - C."""
    out = torch.empty((), dtype=torch.int32, device=dev)
    launch = plan.launch
    anchor = anchors[dev]
    fns = {
        "rpc_call_us": call,
        "op_us": lambda: op(anchor, plan.sid, [], [], [], [out],
                            plan.out_slots),
        "run_us": lambda: launch.run([], [], [out]),
        "c_call_us": lambda: lib.rpc_roundtrip(launch._address,
                                               chan.stream_handle),
    }
    times = {k: [] for k in fns}
    for _ in range(5):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    for _ in range(n):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[k].append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
    m = {k: _median(v) for k, v in times.items()}
    m.update(python_us=m["rpc_call_us"] - m["op_us"],
             dispatch_us=m["op_us"] - m["run_us"],
             launch_python_us=m["run_us"] - m["c_call_us"], calls=n)
    return m


def _copy_routes(chan, dev):
    """One slot copied device -> staging -> device by each route at 4 KB to
    64 MB: the kernel's copies (a ``Launch`` whose limit is the slot's
    size) against the copy engines' (a limit one byte below), in turns
    (kernel, engine, engine, kernel), CUDA events on an idle stream (the
    host's enqueue inside: ``*_ms``) and behind a device sleep (the
    device's time: ``*_busy_ms``); the served region does nothing, so
    both outputs must equal the input bit for bit.  ``limit_measured`` is
    the largest size at which the kernel's route is no slower on the
    device."""
    from repro_torch.kernels.rpc_channel.kernel import _launch_with_limit
    rec = {}
    for nbytes, n in ((4 << 10, 40), (64 << 10, 40), (256 << 10, 20),
                      (1 << 20, 20), (4 << 20, 10), (16 << 20, 6),
                      (64 << 20, 4)):
        src = torch.randint(-2**31, 2**31 - 1, (nbytes // 4,),
                            dtype=torch.int32, device=dev)
        sid, staging = chan.stagings.get(
            ("smoke.route", nbytes),
            lambda: (chan.new_staging([nbytes]), lambda: None))
        routes = {"kernel": _launch_with_limit(nbytes, sid, staging, [0],
                                               [0], channel=chan),
                  "engine": _launch_with_limit(nbytes - 1, sid, staging, [0],
                                               [0], channel=chan)}
        outs = {k: torch.zeros_like(src) for k in routes}
        ms = {k + busy: [] for k in routes for busy in ("", "_busy")}
        for r in range(2 * n):
            busy = "_busy" if r >= n else ""
            for k in (("kernel", "engine") if r % 2 == 0
                      else ("engine", "kernel")):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                if busy:                 # the stream busy: device time
                    torch.cuda._sleep(2_000_000)
                a.record()
                routes[k].run([src], [], [outs[k]])
                b.record()
                torch.cuda.synchronize()
                ms[k + busy].append(a.elapsed_time(b))
        row = {k + "_ms": _median(v) for k, v in ms.items()}
        row["kernel_grid"] = routes["kernel"].call.grid
        row["bit_equal"] = all(_same_tensor(o, src) for o in outs.values())
        if not row["bit_equal"]:
            raise AssertionError(f"rpc_time: the copy routes disagree at "
                                 f"{nbytes} bytes")
        rec[str(nbytes)] = row
    rec["limit_measured"] = max(
        [int(k) for k, v in rec.items()
         if v["kernel_busy_ms"] <= v["engine_busy_ms"]] or [0])
    return rec


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


# ---------------------------------------------------------------------------
# The paper's evaluation (Figs. 6-10) and the offload baseline
# ---------------------------------------------------------------------------

#: The card the paper_eval and host_driven phases run on.
CARD = torch.device("cuda", 0)
#: host_driven: XSBench's history step at "small" (68 nuclides x 11,303
#: points), one lookup a particle a step.
HOST_DRIVEN_STEPS, HOST_DRIVEN_PARTICLES = 1000, 1 << 15
#: The timed runs follow a gate pass over the same shapes (which warms
#: them up), so they take no warm-up of their own.
PAPER_WARMUP, PAPER_ITERS = 0, 3
#: A region's columns against each other on the card, by body kind
#: (relative, with a floor of the tolerance times the largest value, since
#: the bodies' sums cancel; hypterm's against its plane's absolute terms).
EVAL_TOL = {"elementwise": 1e-5, "chained": 1e-5, "stencil": 1e-5,
            "inverse": 1e-5, "integer": 0}
#: The card's columns against the CPU's at the JAX modules' sizes.
EVAL_CPU_TOL = {"elementwise": 1e-5, "chained": 1e-4, "stencil": 1e-4,
                "inverse": 1e-4, "integer": 0}
#: The serial prefix the CPU comparison runs.
EVAL_CPU_PREFIX = 32
#: Fig. 7's counts on the card and the CPU (JAX's: up to 3 rounds of 9
#: iterations after 2 warm-ups), cut to keep the phase near 90 s.
FIG7_TIMING = dict(warmup=1, iters=3, rounds=1)


@contextlib.contextmanager
def _columns_guard():
    """A block that must not wait for the device nor fall back to a loop
    inside ``torch.vmap``: ``set_sync_debug_mode("error")``, and vmap's
    fallback warning (C++'s "There is a performance drop because we have
    not yet implemented the batching rule", which reaches Python's
    warnings only from some call paths) caught on the process's stderr."""
    import tempfile
    with tempfile.TemporaryFile() as cap:
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(cap.fileno(), 2)
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        try:
            with sync_errors(), warnings.catch_warnings():
                warnings.filterwarnings("error",
                                        message="There is a performance")
                yield
        finally:
            torch._C._functorch._set_vmap_fallback_warning_enabled(False)
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            cap.seek(0)
            text = cap.read().decode(errors="replace")
            sys.stderr.write(text)
    if "There is a performance drop" in text:
        raise AssertionError(f"vmap fell back to a loop: {text[:300]}")


def _device_launches(fn) -> int:
    """Device activities (kernels, copies, fills) one call of ``fn`` puts
    on the card, counted by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _eval_err(got, ref, kind, magnitude=None) -> float:
    """The largest difference of ``got`` from ``ref`` over its scale: the
    value plus the largest value (or ``magnitude``, hypterm's absolute
    terms); an integer body's largest difference."""
    got, ref = got.cpu().double(), ref.cpu().double()
    if got.shape != ref.shape:
        raise AssertionError(f"shapes {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    diff = (got - ref).abs()
    if kind == "integer":
        return float(diff.max())
    if magnitude is not None:
        scale = magnitude.cpu().double()
    else:
        scale = ref.abs() + ref.abs().max()
    return float((diff / scale.clamp(min=1e-30)).max())


def _columns(reg, m):
    """The three columns of ``reg`` (serial on the first ``m``) and the
    serial prefix's magnitude, on the card under :func:`_columns_guard`."""
    with _columns_guard():
        out = (reg.serial(m), reg.gpu_first(), reg.manual(),
               reg.magnitude(m) if reg.magnitude else None)
    torch.cuda.synchronize()
    return out


def _gate_columns(reg, m, tol) -> dict:
    """gpu_first against serial on the first ``m`` iterations, and manual
    against gpu_first where JAX's columns agree; raises beyond ``tol``."""
    s, g, man, mag = _columns(reg, m)
    for t in (s, g, man):
        if not bool(torch.isfinite(t.double()).all()):
            raise AssertionError(f"{reg.name}: a column is not finite")
    out = {"serial_vs_gpu_first": _eval_err(s, g[:m], reg.kind, mag)}
    if reg.manual_agrees:
        out["manual_vs_gpu_first"] = _eval_err(man, g, reg.kind)
    if max(out.values()) > tol:
        raise AssertionError(f"{reg.name}: columns differ: {out} > {tol}")
    return out


def host_driven_phase(card_line, dev=CARD):
    """``device_run`` against ``host_driven_run`` (JAX's offload baseline:
    a wait for the device after every step) over 1000 steps of XSBench's
    history step at "small" (2**15 particles, the state their energies),
    in turns (device, host, host, device): wall ms/step of each run, the
    final states bit-equal, ``device_run`` under
    ``set_sync_debug_mode("error")``."""
    from repro_torch.core import device_run, host_driven_run
    from repro_torch.evaluation import xsbench

    gen = torch.Generator().manual_seed(0)
    egrid, xs, conc = xsbench.make_data(68, 11303, generator=gen, device=dev)
    e0 = xsbench.energies(HOST_DRIVEN_PARTICLES, generator=gen, device=dev)

    def step(i, e):
        return xsbench.history_step(i, e, egrid, xs, conc)

    device_run(step, e0, 3)                        # warm up
    runs, finals = {"device_run": [], "host_driven_run": []}, {}
    for name in ("device_run", "host_driven_run", "host_driven_run",
                 "device_run"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "device_run":
            with _columns_guard():
                out = device_run(step, e0, HOST_DRIVEN_STEPS)
        else:
            out = host_driven_run(step, e0, HOST_DRIVEN_STEPS)
        torch.cuda.synchronize()
        runs[name].append((time.perf_counter() - t0)
                          / HOST_DRIVEN_STEPS * 1e3)
        finals.setdefault(name, []).append(out)
    a = finals["device_run"][0]
    dev_ms, host_ms = (sum(runs[k]) / 2 for k in runs)
    rec = {"card": card_line, "steps": HOST_DRIVEN_STEPS,
           "particles": HOST_DRIVEN_PARTICLES,
           "device_run_ms_per_step": runs["device_run"],
           "host_driven_ms_per_step": runs["host_driven_run"],
           "host_driven_over_device_run": host_ms / dev_ms,
           "bit_equal": all(torch.equal(a, x) for x in
                            finals["device_run"] + finals["host_driven_run"]),
           "finite": bool(torch.isfinite(a).all())}
    log({"host_driven": rec})
    if not (rec["bit_equal"] and rec["finite"]):
        raise AssertionError(f"host_driven: {rec}")


def _paper_regions(card_line, dev=CARD):
    """Figs. 8-10 at the card's sizes: each region's gates, times, ATen
    ops a serial iteration and of the expanded loop, and the device
    launches ``torch.profiler`` counts over a window of up to 8 serial
    iterations and over the expanded loop; then every column against the
    CPU at the JAX modules' sizes."""
    from repro_torch.evaluation import spec
    from repro_torch.evaluation.common import aten_ops
    from repro_torch.evaluation.run import CARD_SIZES, REGION_SUITES, smithwa

    cpu = torch.device("cpu")
    for suite, build in REGION_SUITES.items():
        t_suite = time.perf_counter()
        sizes = dict(CARD_SIZES[suite])
        lengths = sizes.pop("smithwa", None)
        recs = []
        for reg in build(dev, **sizes):
            torch.cuda.empty_cache()
            tol = EVAL_TOL[reg.kind]
            gate = reg.gate_region()
            rec = {"gates": _gate_columns(gate, gate.n_serial, tol),
                   "tol": tol}
            if gate is not reg:
                rec["gated_at"] = reg.gate_note
                s, g, man, _ = _columns(reg, reg.n_serial)
                if not all(bool(torch.isfinite(t).all())
                           for t in (s, g, man)):
                    raise AssertionError(f"{reg.name}: not finite")
                rec["timed_serial_vs_gpu_first_rel"] = float(
                    ((s.double() - g[:reg.n_serial].double()).abs()
                     / g[:reg.n_serial].double().abs()).max())
            timed = reg.measure(warmup=PAPER_WARMUP, iters=PAPER_ITERS,
                                device=dev)
            rec.update({(key[:-2] + "_ms" if key.endswith("_s") else key):
                        (v * 1e3 if key.endswith("_s") else v)
                        for key, v in timed.items()})
            # one iteration's ATen ops: two iterations' less one's (the
            # stack after the loop cancels); botsspar's one is the whole
            one = aten_ops(lambda: reg.serial(1))
            rec["serial_ops_per_iteration"] = one if reg.n == 1 else \
                aten_ops(lambda: reg.serial(2)) - one
            rec["gpu_first_ops"] = aten_ops(reg.gpu_first)
            w = min(8, reg.n_serial)
            rec["serial_window_device_launches"] = {
                "iterations": w,
                "launches": _device_launches(lambda: reg.serial(w))}
            rec["gpu_first_device_launches"] = _device_launches(
                reg.gpu_first)
            recs.append(rec)
        line = {"figure": suite, "card": card_line, "regions": recs}
        if lengths:
            pairs = spec.smithwa_pairs(lengths, device=dev)
            cpu_pairs = spec.smithwa_pairs(lengths, device=cpu)
            with _columns_guard():
                scores = {L: spec.sw_score(*ab) for L, ab in pairs.items()}
            line["smithwa"] = smithwa(dev, lengths,
                                      warmup=PAPER_WARMUP, iters=PAPER_ITERS)
            a, b = pairs[32]
            line["smithwa"]["ops_per_diagonal"] = aten_ops(
                lambda: spec.sw_score(a, b)) / (2 * 32 - 1)
            line["smithwa"]["device_launches_L32"] = _device_launches(
                lambda: spec.sw_score(a, b))
            for L, score in scores.items():
                want = int(spec.sw_score(*cpu_pairs[L]))
                line["smithwa"][f"L{L}"]["score"] = int(score)
                if int(score) != want:
                    raise AssertionError(f"smithwa L{L}: {int(score)} on "
                                         f"the card, {want} on the CPU")
        line["cpu_parity"] = _cpu_parity(build, dev, cpu)
        line["suite_s"] = time.perf_counter() - t_suite
        log({"paper_eval": line})


def _cpu_parity(build, dev, cpu) -> dict:
    """Each column on the card against the same code on the CPU at the JAX
    module's sizes, on the gates' regions (``Region.gate_region``: the
    histories at depth 1, botsspar in float64): the largest difference of
    each over its scale (hypterm's: its absolute terms)."""
    card = [r.gate_region() for r in build(dev)]
    host = [r.gate_region() for r in build(cpu)]
    out = {}
    for c, h in zip(card, host):
        m = min(c.n, EVAL_CPU_PREFIX)
        cc, hc = _columns(c, m), (h.serial(m), h.gpu_first(), h.manual())
        scales = (h.magnitude(m) if h.magnitude else None,
                  h.magnitude(h.n) if h.magnitude else None,
                  h.manual_magnitude() if h.manual_magnitude else None)
        errs = [_eval_err(x, y, c.kind, sc)
                for x, y, sc in zip(cc[:3], hc, scales)]
        out[c.name] = dict(zip(("serial", "gpu_first", "manual"), errs))
        if max(errs) > EVAL_CPU_TOL[c.kind]:
            raise AssertionError(f"{c.name}: the card differs from the CPU: "
                                 f"{out[c.name]}")
    return out


def _same_evidence(a, b) -> bool:
    """Deep equality of two sections' evidence: tensors bit for bit,
    numbers exactly."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_evidence(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same_evidence(x, y) for x, y in zip(a, b))
    return a == b


def _fig6_fig7_launches() -> dict:
    """The transport launches ``allocator.run`` and ``rpc.run`` make at
    the phase's counts: ``rpc_post`` one a call and a flush,
    ``rpc_enqueue`` one a record (a ``LogRing.log`` too),
    ``rpc_async_post`` and ``rpc_async_collect`` one each an async flush.
    A timed loop runs ``warmup + iters`` times (``rounds`` times that in
    a contrast) and once more for its evidence."""
    from repro_torch.evaluation import allocator as fig6, rpc as fig7

    loops = []                  # (runs, posts a run, records a run)
    # Fig. 6: find_obj's ArenaRef round trip a cap; the queue contrast's
    # funneled and sharded loops (an untimed run for the records first)
    loops.append((len(fig6.FIND_OBJ_CAPS) * (PAPER_WARMUP + PAPER_ITERS + 1),
                  1, 0))
    loops.append((2 * (1 + PAPER_WARMUP + fig6.QUEUE_ITERS), 1,
                  fig6.SHARD_DEVICES * fig6.QUEUE_PER_SHARD))
    # Fig. 7
    timed = FIG7_TIMING["warmup"] + FIG7_TIMING["iters"]
    t, c = timed + 1, FIG7_TIMING["rounds"] * timed + 1
    K = fig7.N_QUEUED
    loops += [(t, fig7.N_CALLS, 0), (t, 1, fig7.N_CALLS)]  # calls, LogRing
    for _ in range(1 + len(fig7.PAYLOAD_ELEMS)):           # scalars, arrays
        loops += [(t, K, 0), (t, 1, K)]
    for _ in fig7.REPLY_ELEMS:                             # a contrast
        loops += [(c, K, 0), (c, 1, K)]
    loops.append((2 * t, 1, fig7.N_SHARDS * K))            # queue contrast
    loops.append((2 * c + t, 1, K))          # fast, guarded; timeout
    n_async = 1 + FIG7_TIMING["iters"]       # a leg: warm-up and iters
    loops.append((2 * n_async, 0, K))
    loops.append((n_async, 1, 0))            # the sync leg's flushes
    return {"rpc_post": sum(n * p for n, p, _ in loops),
            "rpc_enqueue": sum(n * r for n, _, r in loops),
            "rpc_async_post": n_async, "rpc_async_collect": n_async}


def _paper_transport(card_line, dev=CARD) -> dict:
    """Figs. 6 and 7 on the card (JAX's grids, caps and counts and the
    (128, 132) grid) and on the CPU: pointers, records and replies
    bit-equal.  Returns the transport kernels' launches on the card."""
    from repro_torch.evaluation import allocator, rpc
    from repro_torch.evaluation.run import CARD_SIZES
    from repro_torch.kernels.rpc_async import (rpc_async_collect,
                                               rpc_async_post)
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.rpc_queue import rpc_enqueue

    fns = (rpc_post, rpc_enqueue, rpc_async_post, rpc_async_collect)
    # main path: counts from 0 just before, read just after
    reset_launches(*fns)
    t0 = time.perf_counter()
    a_rec, a_ev = allocator.run(dev, warmup=PAPER_WARMUP, iters=PAPER_ITERS,
                                **CARD_SIZES["fig6_allocator"])
    r_rec, r_ev = rpc.run(dev, **FIG7_TIMING)
    launches = {f.__name__: f.launches for f in fns}
    card_s = time.perf_counter() - t0
    a_cpu = allocator.run("cpu", warmup=0, iters=1,
                          **CARD_SIZES["fig6_allocator"])[1]
    r_cpu = rpc.run("cpu", **FIG7_TIMING)[1]
    want = _fig6_fig7_launches()
    rec = {"card": card_line, "fig6": a_rec, "fig7": r_rec,
           "launches": launches, "expected_launches": want, "card_s": card_s,
           "fig6_bit_equal_to_cpu": {k: _same_evidence(a_ev[k], a_cpu[k])
                                     for k in a_ev},
           "fig7_bit_equal_to_cpu": {k: _same_evidence(r_ev[k], r_cpu[k])
                                     for k in r_ev}}
    log({"paper_eval": {"figure": "fig6_fig7", **rec}})
    if not (all(rec["fig6_bit_equal_to_cpu"].values())
            and all(rec["fig7_bit_equal_to_cpu"].values())
            and launches == want):
        raise AssertionError(f"paper_eval fig6/fig7: {rec}")
    return launches


def paper_eval_phase(card_line, dev=CARD) -> dict:
    """The paper's evaluation through ``repro_torch.evaluation``: Figs.
    8-10 (:func:`_paper_regions`), then Figs. 6 and 7
    (:func:`_paper_transport`).  Returns the transport kernels'
    launches."""
    t0 = time.perf_counter()
    _paper_regions(card_line, dev)
    launches = _paper_transport(card_line, dev)
    log({"paper_eval_s": time.perf_counter() - t0})
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


def _enqueue_routes_gate(dev):
    """The plan route (``RpcQueue.enqueue``/``enqueue_ticketed`` in eager
    mode: one direct launch through the queue's enqueue plan; a
    fire-and-forget record with no ticket) against the op route (the
    ``rpc_enqueue`` op on ``record()``'s record, as under export or a
    dispatch mode) on a seeded plan of :data:`QUEUE_RECORDS` records:
    each queue state before each flush, the flushes' replay logs and
    states after them (replies, statuses, heads), the tickets and the
    last epoch's reads bit-equal.  Twice: on queues as made
    (``as_made``), and on queues whose ``sanitize`` is set after the
    first flush (``sanitize_set_later``, as ``expand(queue=True,
    sanitize=True)`` sets it on a queue already made), when the plan
    route holds plans and lanes made unsanitized."""
    from repro_torch.core import RpcQueue, effects_barrier
    from repro_torch.core.expand import _with_sanitize
    from repro_torch.kernels.rpc_queue import enqueue as enqueue_op

    logged = _queue_callees()
    plan = _queue_plan(dev, 3, QUEUE_RECORDS)
    out = {}
    for label in ("as_made", "sanitize_set_later"):
        qa = RpcQueue.create(**QUEUE_GEOMETRY, device=dev)
        qb = RpcQueue.create(**QUEUE_GEOMETRY, device=dev)
        logs = {"plan": [], "op": []}
        states, tickets, last, reads = [], [], [], []
        with warnings.catch_warnings(), sync_errors():
            warnings.simplefilter("ignore", RuntimeWarning)
            for k, (name, card, _, returns, wcard, _) in enumerate(plan):
                if returns is None:
                    qa.enqueue(name, *card, where=wcard)
                    ta = None
                else:
                    _, ta = qa.enqueue_ticketed(name, *card, returns=returns,
                                                where=wcard)
                tb = enqueue_op(qb.state, qb.arrivals, qb.layout.lanes,
                                qb.record(name, card, returns, wcard))
                tickets.append((ta, tb))
                last.append((k, returns))
                if (k + 1) % QUEUE_FLUSH_EVERY and k + 1 != len(plan):
                    continue
                before = (qa.state.clone(), qb.state.clone())
                qa.flush(logged(logs["plan"]))
                qb.flush(logged(logs["op"]))
                states.append(before + (qa.state.clone(), qb.state.clone()))
                if k + 1 != len(plan):
                    last = []
                if label == "sanitize_set_later" and \
                        k + 1 == QUEUE_FLUSH_EVERY:
                    _with_sanitize(qa)
                    _with_sanitize(qb)
            for k, returns in last:
                ta, tb = tickets[k]
                if returns is not None:
                    reads.append(([qa.result_status(ta)]
                                  + list(qa.result_ok(ta, returns)),
                                  [qb.result_status(tb)]
                                  + list(qb.result_ok(tb, returns))))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            effects_barrier()
        checks = {
            "states_before_flush": all(_equal_states(a, b)
                                       for a, b, _, _ in states),
            "replies_statuses_heads": all(_equal_states(a, b)
                                          for _, _, a, b in states),
            "replay_log": logs["plan"] == logs["op"] and bool(logs["op"]),
            "tickets": all(a is None or int(a) == int(b)
                           for a, b in tickets),
            "last_epoch_reads": bool(reads) and all(
                all(_equal_states(x, y) for x, y in zip(a, b))
                for a, b in reads),
            "sanitize": qa.sanitize == qb.sanitize
            == (label == "sanitize_set_later"),
        }
        out[label] = {"checks": checks, "records": len(plan),
                      "flushes": len(states),
                      "fire_and_forget": sum(a is None for a, _ in tickets)}
        if not all(checks.values()):
            raise AssertionError(f"rpc_queue_time routes {label}: "
                                 f"{out[label]}")
    return out


def rpc_queue_time_phase(card_line):
    """Host and device microseconds per ``rpc_enqueue`` and per plain
    enqueue on the card (behind a device sleep that hides the host) for a
    scalar record at W 4, a 1 KB and a 64 KB payload, beside the bound
    (the record's bytes at 3.35 TB/s), through three routes timed in
    turns: ``plan``, ``RpcQueue.enqueue`` (the queue's enqueue plan, one
    direct launch, no ticket); ``ticketed``, ``enqueue_ticketed`` (the
    same plus a 0-d ticket); ``op``, the ``torch.ops.repro_torch.
    rpc_enqueue`` op on ``record()``'s record (the route under export or
    a dispatch mode, and the whole enqueue before the plan), so
    ``op_host_us_over_ctypes`` is the op's host us over the direct plan
    launch's.  Then the routes' gate (:func:`_enqueue_routes_gate`) and
    the flush of a full ring of 1024 records with a 4096-word arena (CUDA
    events around the round trip, the host's time in ``flush``, the
    drain's Python; median of 5).  Returns the scalar record's numbers
    for the kernels line."""
    import numpy as np
    from repro_torch.core import RpcQueue, effects_barrier
    from repro_torch.core.rpc import REGISTRY
    from repro_torch.kernels.rpc_channel import channel_for
    from repro_torch.kernels.rpc_queue import enqueue as enqueue_op
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
        # room for two timings' warm-up calls and three attempts each:
        # nothing dropped
        arena = max(1, (6 + 6 * n) * words)
        queues = {route: RpcQueue.create(max(n, 64), width, arena, device=dev)
                  for route in ("plan", "ticketed", "op", "plain")}
        q, qt, qo, qp = (queues[r] for r in ("plan", "ticketed", "op",
                                             "plain"))
        calls = {
            "plan": lambda: q.enqueue("smoke.q_sink", *args),
            "ticketed": lambda: qt.enqueue_ticketed("smoke.q_sink", *args),
            "op": lambda: enqueue_op(qo.state, qo.arrivals, qo.layout.lanes,
                                     qo.record("smoke.q_sink", args)),
        }
        runs = {route: [] for route in calls}
        for _ in range(2):                       # in turns
            for route, fn in calls.items():
                runs[route].append(_behind_busy(fn, n))
        # the plain version is ~100 small launches a record: five stay
        # within CUDA's launch queue behind the sleep (more would block
        # the host on the sleeping device)
        plain = _behind_busy(lambda: enqueue_reference(
            qp.lanes(), qp.record("smoke.q_sink", args)), PLAIN_TIMED_CALLS)
        kept = all(int(queues[r].head) == 6 + n * sum(
            t["attempts"] for t in runs[r]) and int(queues[r].adrops) == 0
            for r in calls)
        lanes = 4 + 3 * width
        nbytes = 4 * lanes + 8 * words + 4 * 6 + 4

        def host(route):
            return [t["host_us"] for t in runs[route]]

        def device(route):
            return [t["device_us"] for t in runs[route]]

        kernel = runs["plan"][0]
        cases[label] = {
            "payload_words": words, "kernel": kernel, "plain": plain,
            "plan_host_us": host("plan"), "plan_device_us": device("plan"),
            "ticketed_host_us": host("ticketed"),
            "ticketed_device_us": device("ticketed"),
            "op_host_us": host("op"), "op_device_us": device("op"),
            "op_host_us_over_ctypes": float(np.mean(host("op"))
                                            - np.mean(host("plan"))),
            "ms": float(np.mean(device("plan"))) * 1e-3,
            "plain_ms": plain["device_us"] * 1e-3,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
            "all_kept": kept}
        hidden = all(t["host_hidden"] for ts in runs.values() for t in ts)
        if not (hidden and plain["host_hidden"] and kept):
            raise AssertionError(f"rpc_queue_time {label}: {cases[label]}")
        del q, qt, qo, qp, queues, calls
    routes = _enqueue_routes_gate(dev)
    # the current stream's handle: the raw one the plan route reads every
    # launch, against a stream object's
    reps = 100_000
    stream_us = {
        "raw": timeit.timeit(lambda: torch._C._cuda_getCurrentRawStream(0),
                             number=reps) / reps * 1e6,
        "current_stream": timeit.timeit(
            lambda: torch.cuda.current_stream(dev).cuda_stream,
            number=reps) / reps * 1e6}
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
                            "routes": routes, "stream_handle_us": stream_us,
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


#: The async hand-off's gates (:func:`_async_in_gate`): label -> (rows, or
#: None for a single queue; payload words of ``QUEUE_GEOMETRY``).  Both
#: copy routes (``COPY_LIMIT`` bytes of rows in all: the kernel's at or
#: below, one block or several, the copy engines' above) on a single and
#: a 4-row sharded ring.
ASYNC_GATE_GEOMETRIES = {
    "rpc_queue": (None, QUEUE_GEOMETRY["payload_capacity"]),
    "kernel_800KB": (None, 200_000),
    "engine_1.2MB": (None, 300_000),
    "sharded_4": (4, QUEUE_GEOMETRY["payload_capacity"]),
    "sharded_4_engine": (4, 70_000),
}
#: Flushes (and records a row each) of an async gate, and flushes timed
#: through each route.
ASYNC_GATE_FLUSHES, ASYNC_GATE_RECORDS, ASYNC_ROUTE_FLUSHES = 3, 3, 200


class _OpRoute(torch.overrides.TorchFunctionMode):
    """A pass-through function mode: under it ``rpc._eager()`` is false,
    so an async flush takes its two ops, the route under export, compile
    or a dispatch mode (the mode's own Python is in what it times)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _async_in_gate(dev, rows, payload, op_route=False):
    """:data:`ASYNC_GATE_FLUSHES` flushes of an async queue on the card
    (``rows`` None: a single queue, else a sharded one) and of the same
    queue on the CPU, each after :data:`ASYNC_GATE_RECORDS` records a row
    (two ticketed scalars and one with an int32 payload), through the
    flush plan (or the two ops, ``op_route``), then two to collect the
    tail.  Gates: after each flush the ring's ``in`` region of the
    epoch's parity bit-equal to a snapshot of every row's ``state[:in_end]``
    taken before it; the card's whole state bit-equal to the CPU queue's
    after every flush; the CUDA API calls each flush made (2 on the
    kernel's copy route, 3 on the copy engines')."""
    import numpy as np
    from repro_torch.core import (RpcQueue, ShapeDtype, ShardedRpcQueue,
                                  effects_barrier)
    from repro_torch.core.rpc import REGISTRY, _slot
    from repro_torch.kernels.rpc_async.kernel import api_calls, pack_flush
    from repro_torch.kernels.rpc_channel.kernel import COPY_LIMIT

    REGISTRY.register("smoke.af_scalar", lambda i: np.int32(i * 3 + 1))
    REGISTRY.register("smoke.af_payload",
                      lambda i, x: np.int32(i + int(x.sum()) % 9973))
    geo = dict(QUEUE_GEOMETRY, payload_capacity=payload, mode="async")

    def make(device):
        return (RpcQueue.create(**geo, device=device) if rows is None else
                ShardedRpcQueue.create(rows, **geo, device=device))

    card, cpu = make(dev), make("cpu")
    n_rows, L = rows or 1, card.layout
    plen = min(payload // (2 * ASYNC_GATE_FLUSHES), 4096)
    rng = np.random.default_rng(n_rows * 1000 + payload)
    i32 = ShapeDtype((), torch.int32)

    def local(q, d):
        return q if rows is None else q.local(d)

    in_equal, states_equal, calls = [], [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for k in range(ASYNC_GATE_FLUSHES + 2):
            if k < ASYNC_GATE_FLUSHES:
                for d in range(n_rows):
                    vals = rng.integers(-1000, 1000, 2)
                    pay = rng.integers(-2 ** 20, 2 ** 20, plen,
                                       dtype=np.int32)
                    for q, device in ((card, dev), (cpu, "cpu")):
                        lq = local(q, d)
                        for v in vals:
                            lq.enqueue_ticketed("smoke.af_scalar", int(v),
                                                returns=i32)
                        lq.enqueue_ticketed(
                            "smoke.af_payload", 1,
                            torch.from_numpy(pay).to(device), returns=i32)
            torch.cuda.synchronize()
            snap = card.state.reshape(n_rows, -1)[:, :L.in_end].cpu().numpy()
            before = api_calls()
            if op_route:
                with _OpRoute():
                    card.flush()
            else:
                card.flush()
            calls.append(api_calls() - before)
            cpu.flush()
            torch.cuda.synchronize()
            ring = _slot((card.shards[0] if rows else card).qslot).ring
            in_equal.append(bool(np.array_equal(
                ring._in[ring.issued & 1], snap)))
            states_equal.append(_equal_states(card.state, cpu.state))
        assert card.join(timeout=60) and cpu.join(timeout=60)
    effects_barrier()
    block = pack_flush(ring, card.state, 1, L.out_start, True, L.rslots,
                       L.reply_capacity, None)
    engine = n_rows * 4 * L.in_end > COPY_LIMIT
    checks = {
        "in_region_equals_snapshot": all(in_equal),
        "states_equal_cpu_queue": all(states_equal),
        "route": bool(block.engine) == engine,
        "api_calls_per_flush": all(c == (3 if engine else 2)
                                   for c in calls),
    }
    return {"checks": checks, "rows": n_rows, "in_bytes": 4 * L.in_end,
            "route": "engine" if block.engine else "kernel",
            "post_grid": block.grid, "api_calls": calls,
            "op_route": op_route}


def _async_floor(ring, cycles):
    """The latency floor under both kernels (median device ms of 50,
    CUDA events behind a device sleep): an empty launch, and one whose
    thread makes one ``ld.acquire.sys`` round trip of a mapped word (the
    ring's live carried depth)."""
    from repro_torch.kernels.rpc_async.kernel import floor_launch

    out = {}
    for label, word in (("empty_launch_ms", None),
                        ("mapped_acquire_ms", ring._live_dev)):
        ms = []
        for _ in range(51):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            floor_launch(word)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        out[label] = _median(ms[1:])
    return out


def rpc_async_time_phase(card_line):
    """The two kernels alone on a ring of the ``rpc_queue`` geometry whose
    host side answers each epoch at once: device time of ``rpc_async_post``
    (the copy of the state into the ring and the window's move) and of
    ``rpc_async_collect`` with the previous epoch already answered, each
    between CUDA events behind a device sleep (median of 50), beside their
    plain versions on the card (``post_reference``; ``collect_reference``
    with its host-to-device copy), the bytes bound and the latency floor
    (:func:`_async_floor`); the answer installed exactly, into reply
    fields that are not 16-byte aligned.  Then the hand-off's gates
    (:func:`_async_in_gate` at each of :data:`ASYNC_GATE_GEOMETRIES`
    through the flush plan, and at ``rpc_queue`` through the two ops),
    the host us of an empty flush through ``RpcQueue.flush`` on each
    route (``plan``, eager; ``op``, under :class:`_OpRoute`; behind a
    device sleep, :data:`ASYNC_ROUTE_FLUSHES` flushes) and a deadline
    overrun on the card against a CPU queue.  Launches here are not the
    main path's: the counts are restored.  Returns the two kernels'
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
    floor = _async_floor(ring, cycles)
    ring.close()
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
    gates = {label: _async_in_gate(dev, rows, payload)
             for label, (rows, payload) in ASYNC_GATE_GEOMETRIES.items()}
    gates["rpc_queue_op_route"] = _async_in_gate(
        dev, *ASYNC_GATE_GEOMETRIES["rpc_queue"], op_route=True)
    routes = {"plan": [], "op": []}
    queues = {r: RpcQueue.create(**QUEUE_GEOMETRY, mode="async", device=dev)
              for r in routes}
    for _ in range(2):                   # in turns
        routes["plan"].append(_behind_busy(queues["plan"].flush,
                                           ASYNC_ROUTE_FLUSHES))
        with _OpRoute():
            routes["op"].append(_behind_busy(queues["op"].flush,
                                             ASYNC_ROUTE_FLUSHES))
    for qr in queues.values():
        assert qr.join(timeout=60)
    rpc_async_post.launches, rpc_async_collect.launches = saved
    rec = {
        "card": card_line, "geometry": QUEUE_GEOMETRY,
        "installed_equals_answer": bool(np.array_equal(installed, answer)),
        "reply_fields_16_byte_aligned": (
            q.state.data_ptr() + 4 * (L.out_start + H_CDEPTH)) % 16 == 0,
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
        "floor": floor,
        "gates": gates,
        "flush_host_us": {
            r: [t["host_us"] for t in ts] for r, ts in routes.items()},
        "flush_device_us": {
            r: [t["device_us"] for t in ts] for r, ts in routes.items()},
        "flush_host_hidden": all(t["host_hidden"] for ts in routes.values()
                                 for t in ts),
        "deadline": _deadline_case(dev)}
    log({"rpc_async_time": rec})
    if not (rec["installed_equals_answer"]
            and not rec["reply_fields_16_byte_aligned"]
            and all(all(g["checks"].values()) for g in gates.values())
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
    path's launches, its engine after the run, its sink's ``(request,
    n_tokens, pages)`` calls and its ms/tick (``artifact_serve`` exports
    that engine)."""
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
    spill_engine = engine

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
    return (launches, spill_engine, [c[1:] for c in calls],
            rec["spill"]["ms_per_tick"])


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
                _san_precheck([L.views(words)], 0)
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


# ---------------------------------------------------------------------------
# The moe family at full width: phi3.5-moe through the paged engine
# ---------------------------------------------------------------------------

#: phi3.5-moe's depth in ``moe_serve``: 8 of its 32 layers (~21 GB of bf16
#: weights; all 32 are ~83.7 GB, more than the card holds; 16 fit, and ran
#: until the script's length with ``artifact_serve`` asked for a cut).
MOE_LAYERS = 8
#: The fp32 phase's depth (~11.5 GB of fp32 weights).
MOE_FP32_LAYERS = 2
#: The fp32 engine against the contiguous decode (fp32 logits).
MOE_ENGINE_ATOL_FP32 = 2e-5


def _moe_cfg(**kw):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), **kw)
    assert (cfg.d_model, cfg.padded_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.num_experts, cfg.experts_per_token,
            cfg.d_ff, cfg.vocab_size) == (4096, 32, 8, 128, 16, 2, 6400,
                                          32064)
    return cfg


def moe_serve_phase():
    """phi3.5-moe-42b-a6.6b at full width (d_model 4096, 32 query heads
    over 8 KV heads of 128, 16 experts of d_ff 6400, top 2, vocab 32064,
    bf16) and :data:`MOE_LAYERS` of its 32 layers, random weights from seed 0
    built on the card, through the engine as ``dense_serve`` runs
    qwen2.5-14b (9 prompts, one of 200 tokens, 16 new tokens each): the
    logits gate against the teacher-forced contiguous decode and exact
    launches (paged and decode once a layer a tick or step), then
    ``moe_profile`` (8 busy ticks under ``torch.profiler``).  Returns the
    launches."""
    cfg = _moe_cfg(num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    launches, model, params, prompts, max_new, max_len, _ = _engine_serve(
        "moe_serve", cfg, 8, 200, 23)
    profile_window(model, params, prompts, max_new, max_len,
                   tag="moe_profile")
    # the expert products read the (E, d, f) weights in place: a decode
    # step of 4 rows allocates activations only, never a copy of a weight
    cache = model.init_cache(4, 64)
    tok = torch.tensor(prompts[1][:4], device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    expert = params["layers"][0]["moe"]["wi_gate"]
    weight_bytes = expert.numel() * expert.element_size()
    log({"moe_step_temporaries": {"peak_extra_bytes": extra,
                                  "expert_weight_bytes": weight_bytes}})
    if extra >= weight_bytes // 8:
        raise AssertionError(f"moe decode step allocated {extra} bytes "
                             f"beside an expert weight of {weight_bytes}")
    del model, params, cache
    torch.cuda.empty_cache()
    log({"moe_serve_phase_s": time.perf_counter() - t0})
    return launches


@contextlib.contextmanager
def _recorded_routes():
    """Record the experts ``models/moe.py::_route`` picks, one (tokens, k)
    array a call (it reads the device)."""
    from repro_torch.models import moe as moe_mod
    inner, seen = moe_mod._route, []

    def route(x, w, k):
        out = inner(x, w, k)
        seen.append(out[1].cpu())
        return out

    moe_mod._route = route
    try:
        yield seen
    finally:
        moe_mod._route = inner


def moe_fp32_phase():
    """The same configuration in fp32 at 2 layers, TF32 off: the engine
    against the contiguous decode within ``MOE_ENGINE_ATOL_FP32`` (4
    prompts, one of 64 tokens), then ``Model.forward`` over 48 tokens
    against ``Model.prefill`` of 32 and 16 teacher-forced decode steps
    (within ``LOGIT_ATOL_FP32``, the same argmax) and the experts chosen
    for every token and layer equal on both paths: the exact gate for
    routing.  Returns the launches of the engine's path."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _moe_cfg(num_layers=MOE_FP32_LAYERS, dtype="float32",
                   param_dtype="float32")
    launches, model, params, prompts, _, _, _ = _engine_serve(
        "moe_fp32", cfg, 3, 64, 31, atol=MOE_ENGINE_ATOL_FP32)
    tokens = torch.tensor([prompts[0][:48]], device="cuda")
    S0 = 32
    with torch.no_grad():
        with _recorded_routes() as fwd_routes:
            fwd, _ = model.forward(params, {"tokens": tokens})
        with _recorded_routes() as dec_routes:
            logits, cache = model.prefill(params, {"tokens": tokens[:, :S0]},
                                          64)
            rows = [logits]
            for j in range(S0, tokens.shape[1] - 1):
                logits, cache = model.decode_step(params, cache,
                                                  tokens[:, j])
                rows.append(logits)
    dec = torch.stack(rows, dim=1)
    ref = fwd[:, S0 - 1:tokens.shape[1] - 1]
    diff = float((dec - ref).abs().max())
    same = bool(torch.equal(dec.argmax(-1), ref.argmax(-1)))
    L = cfg.num_layers
    # per layer: the forward's (48, k) picks against the prefill's (32, k)
    # and the decode steps' (1, k) each, in token order
    fwd_ids = [r.numpy()[:tokens.shape[1] - 1] for r in fwd_routes]
    dec_ids = [np.concatenate(dec_routes[li::L]) for li in range(L)]
    routing = [np.array_equal(a, b) for a, b in zip(fwd_ids, dec_ids)]
    flips = [int((a != b).any(-1).sum()) for a, b in zip(fwd_ids, dec_ids)]
    log({"moe_forward_vs_prefill_decode_fp32": {
        "layers": L, "tokens": int(tokens.shape[1]), "prefill": S0,
        "max_abs_logit_diff": diff, "tol": LOGIT_ATOL_FP32,
        "same_argmax": same, "routing_equal_by_layer": routing,
        "tokens_with_other_experts_by_layer": flips,
        "routing_calls": [len(fwd_routes), len(dec_routes)]}})
    if not (diff <= LOGIT_ATOL_FP32 and same and all(routing)
            and len(fwd_routes) == L and bool(torch.isfinite(fwd).all())):
        raise AssertionError("moe fp32: forward and prefill + decode "
                             "disagree")
    del model, params, fwd, dec, cache
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The encdec and vlm families at full width and depth
# ---------------------------------------------------------------------------

def _seamless_cfg(**kw):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"), **kw)
    assert (cfg.d_model, cfg.padded_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.qkv_bias) == (1024, 16, 16, 64, 8192, 256206, True)
    return cfg


@torch.no_grad()
def _encdec_greedy(model, params, batch, steps, max_len):
    """``Model.prefill`` of ``batch``'s frames (no tokens), then ``steps``
    greedy ``decode_step``s from ``ENCDEC_BOS``.  Returns (stream (B,
    steps), logits (B, steps, V), prefill s, decode s, cache); both times
    end in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = model.prefill(params, batch, max_len)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = torch.full((batch["embeds"].shape[0],), ENCDEC_BOS,
                     device=batch["embeds"].device)
    toks, rows = [], []
    for _ in range(steps):
        logits, cache = model.decode_step(params, cache, tok)
        tok = logits.argmax(-1)
        rows.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (torch.stack(toks, dim=1), torch.stack(rows, dim=1), t1 - t0,
            t2 - t1, cache)


@torch.no_grad()
def _bf16_gate(tag, model, params, batch, dec, fwd, rows=slice(None)):
    """Hold bf16 decode logits ``dec`` and the bf16 forward's ``fwd`` (the
    same positions) against ``Model.forward`` of ``batch`` with the same
    weights in fp32 (TF32 off; its ``rows`` positions): the decode
    steps' largest distance from it within ``LOGIT_ATOL_BF16`` or
    ``BF16_ERR_MULT`` times the forward's, whichever is larger.  Logs
    ``tag`` with both distances, the decode-to-forward difference beside
    ``LOGIT_ATOL_BF16`` and the argmax agreements."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(model.cfg, dtype="float32",
                                param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    ref, _ = build_model(cfg32, device="cuda").forward(params32, batch)
    ref = ref[:, rows]
    del params32
    real = slice(0, model.cfg.vocab_size)
    e_dec = float((dec[..., real] - ref[..., real]).abs().max())
    e_fwd = float((fwd[..., real] - ref[..., real]).abs().max())
    rec = {"positions": dec.shape[1],
           "max_abs_logit_diff": float((dec[..., real] - fwd[..., real])
                                       .abs().max()),
           "atol_bf16": LOGIT_ATOL_BF16,
           "decode_vs_fp32": e_dec, "forward_vs_fp32": e_fwd,
           "mult": BF16_ERR_MULT,
           "same_argmax_share": float((dec.argmax(-1) == fwd.argmax(-1))
                                      .float().mean()),
           "decode_argmax_is_fp32_share": float(
               (dec.argmax(-1) == ref.argmax(-1)).float().mean())}
    rec["ok"] = bool(e_dec <= max(LOGIT_ATOL_BF16, BF16_ERR_MULT * e_fwd)
                     and torch.isfinite(fwd[..., real]).all()
                     and torch.isfinite(ref[..., real]).all())
    log({tag: rec})
    if not rec["ok"]:
        raise AssertionError(f"{tag}: the bf16 decode steps are further "
                             f"from fp32 than the gate allows: {rec}")


def encdec_serve_phase():
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers, d_model 1024, 16 heads over 16 of 64, QKV bias, vocab
    256206, bf16, ~2.04e9 random parameters from seed 0 built on the
    card), served as the JAX package serves the encdec family: one
    ``Model.prefill`` of 4 requests x 1024 frame embeddings (the encoder,
    bidirectional: flash non-causal at G 1, D 64; the cross K/V of every
    decoder layer) and 32 greedy ``decode_step``s (self attention over the
    decoder's cache and cross attention over the 1024 frames: decode at
    G 1, D 64).  The counts are reset just before and read just after:
    flash 24 (all of the wgmma variant), decode 48 a step.  The logits
    gate: ``Model.forward`` teacher-forced on the generated stream (its
    decoder's cross attention is flash at Sq 32 over Sk 1024; 72 flash
    launches, counted too) and the decode steps, both held against the
    fp32 forward of the same weights (``_bf16_gate``).  Then
    ``encdec_profile`` (8 decode steps under ``torch.profiler``).  Returns
    the launches."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models import build_model

    cfg = _seamless_cfg()
    L = ENCDEC_LAYERS
    assert cfg.encoder_layers == cfg.decoder_layers == L
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[encdec_serve] {cfg.name}: {L} + {L} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params} parameters ({cfg.param_dtype}), init {init_s:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    gen = torch.Generator(device="cuda").manual_seed(41)
    B, S = 4, ENCDEC_FRAMES
    embeds = torch.randn((B, S, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    max_len = 64                     # 32 steps, then the profile's 20
    # the warm-up at the served shapes: the GEMMs' first calls at a shape
    # load their kernels
    _encdec_greedy(model, params, {"embeds": embeds}, 2, max_len)

    # main path: counts from 0 just before, read just after
    reset_launches(flash_attention_cuda, decode_attention_cuda)
    torch.cuda.reset_peak_memory_stats()
    stream, dec, t_pre, t_dec, cache = _encdec_greedy(
        model, params, {"embeds": embeds}, ENCDEC_STEPS, max_len)
    launches = {"flash_attention": flash_attention_cuda.launches,
                "decode_attention": decode_attention_cuda.launches}
    by_variant = dict(flash_attention_cuda.launches_by_variant)
    expected = {"flash_attention": L,
                "decode_attention": ENCDEC_STEPS * 2 * L}
    log({"encdec_serve": {
        "model": cfg.name, "layers": [L, L], "batch": B, "frames": S,
        "steps": ENCDEC_STEPS, "parameters": n_params, "init_s": init_s,
        "prefill_ms": t_pre * 1e3, "prefill_frames_per_s": B * S / t_pre,
        "decode_ms_per_step": t_dec / ENCDEC_STEPS * 1e3,
        "decode_tok_per_s": B * ENCDEC_STEPS / t_dec,
        "launches": launches, "expected": expected,
        "flash_launches_by_variant": by_variant,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "stream_head": stream[0, :8].tolist()}})
    if launches != expected or by_variant["wgmma"] != L:
        raise AssertionError(f"encdec serve launches {launches} "
                             f"({by_variant}), expected {expected}, all "
                             "flash of the wgmma variant")
    real = slice(0, cfg.vocab_size)
    if not (torch.isfinite(dec[..., real]).all()
            and bool((stream < cfg.vocab_size).all())):
        raise AssertionError("encdec serve: non-finite logits or a pad "
                             "token")

    # the gate: the teacher-forced forward over the same stream
    reset_launches(flash_attention_cuda, decode_attention_cuda)
    tokens = torch.cat([torch.full((B, 1), ENCDEC_BOS, device="cuda"),
                        stream[:, :-1]], dim=1)
    with torch.no_grad():
        fwd, _ = model.forward(params, {"embeds": embeds, "tokens": tokens})
    torch.cuda.synchronize()
    fwd_launches = {"flash_attention": flash_attention_cuda.launches,
                    "decode_attention": decode_attention_cuda.launches}
    log({"encdec_forward_launches": fwd_launches})
    if fwd_launches != {"flash_attention": 3 * L, "decode_attention": 0}:
        raise AssertionError(f"encdec forward launches {fwd_launches}, "
                             f"expected {3 * L} flash and no decode")
    _bf16_gate("encdec_forward_vs_decode_bf16", model, params,
               {"embeds": embeds, "tokens": tokens}, dec, fwd)
    _decode_profile(model, params, cache, stream[:, -1], "encdec_profile",
                    batch=B, frames=S)
    del model, params, cache, fwd, dec, embeds
    torch.cuda.empty_cache()
    log({"encdec_serve_phase_s": time.perf_counter() - t_phase})
    return {k: launches[k] + fwd_launches[k] for k in launches}


def encdec_fp32_phase():
    """seamless at full width, fp32, 2 + 2 layers, TF32 off, with ragged
    ``enc_lens`` (1024, 700, 333, 97) over 1024 frames: the card's
    ``Model.prefill`` and 8 greedy decode steps against the same
    parameters moved to the CPU, which runs the plain versions,
    teacher-forced on the card's stream: every step's logits within
    ``LOGIT_ATOL_FP32``; whether the CPU's argmax follows the card's
    stream is printed.  Returns the card's launches (flash 2, decode 4 a
    step)."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    L, n = ENCDEC_FP32_LAYERS, ENCDEC_FP32_STEPS
    cfg = _seamless_cfg(encoder_layers=L, decoder_layers=L,
                        dtype="float32", param_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=1)
    gen = torch.Generator(device="cuda").manual_seed(43)
    embeds = torch.randn((4, ENCDEC_FRAMES, cfg.d_model), generator=gen,
                         device="cuda")
    enc_lens = torch.tensor(ENC_LENS_RAGGED, dtype=torch.int32)
    reset_launches(flash_attention_cuda, decode_attention_cuda)
    stream, dec, *_ = _encdec_greedy(
        model, params, {"embeds": embeds, "enc_lens": enc_lens.cuda()}, n,
        n + 1)
    launches = {"flash_attention": flash_attention_cuda.launches,
                "decode_attention": decode_attention_cuda.launches}
    expected = {"flash_attention": L, "decode_attention": n * 2 * L}

    cpu = build_model(cfg, device="cpu")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    with torch.no_grad():
        _, cache = cpu.prefill(cpu_params, {"embeds": embeds.cpu(),
                                            "enc_lens": enc_lens}, n + 1)
        tok, rows = torch.full((4,), ENCDEC_BOS), []
        for j in range(n):
            logits, cache = cpu.decode_step(cpu_params, cache, tok)
            rows.append(logits)
            tok = stream[:, j].cpu()
    ref = torch.stack(rows, dim=1)
    real = slice(0, cfg.vocab_size)
    diff = float((dec.cpu()[..., real] - ref[..., real]).abs().max())
    follows = bool(torch.equal(ref.argmax(-1), stream.cpu()))
    log({"encdec_fp32": {"layers": [L, L], "frames": ENCDEC_FRAMES,
                         "enc_lens": list(ENC_LENS_RAGGED), "steps": n,
                         "max_abs_logit_diff_vs_cpu": diff,
                         "tol": LOGIT_ATOL_FP32,
                         "cpu_greedy_follows_card_stream": follows,
                         "launches": launches, "expected": expected}})
    if launches != expected:
        raise AssertionError(f"encdec fp32 launches {launches}, expected "
                             f"{expected}")
    if not (diff <= LOGIT_ATOL_FP32 and torch.isfinite(ref).all()):
        raise AssertionError("encdec fp32: the card's decode logits and "
                             "the CPU's plain versions disagree")
    del model, params, cpu_params, cache, dec
    torch.cuda.empty_cache()
    return launches


def vlm_positions(batch, device):
    """Qwen2-VL's M-RoPE positions (3, B, S) of ``VLM_LAYOUT``: text has
    one position in all three streams; the image's t is constant at the
    next position and its h and w follow the patch grid from there; the
    text after it continues from the largest position + 1."""
    n_text, (gh, gw), n_after = VLM_LAYOUT
    text = torch.arange(n_text)
    t = torch.full((gh * gw,), n_text)
    h = n_text + torch.arange(gh).repeat_interleave(gw)
    w = n_text + torch.arange(gw).repeat(gh)
    after = int(max(t.max(), h.max(), w.max())) + 1 + torch.arange(n_after)
    pos = torch.stack([torch.cat([text, s, after]) for s in (t, h, w)])
    return pos[:, None].expand(3, batch, -1).to(
        device=device, dtype=torch.int32).contiguous()


def _vlm_cfg(**kw):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen2-vl-2b"), **kw)
    assert (cfg.d_model, cfg.padded_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.mrope_sections, cfg.qkv_bias) == \
        (1536, 16, 2, 128, (16, 24, 24), True)
    return cfg


@torch.no_grad()
def _vlm_run(model, params, embeds, pos, steps, max_len):
    """``Model.prefill`` of ``embeds`` (B, S, d) at M-RoPE positions
    ``pos`` (3, B, S), then ``steps`` greedy ``decode_step``s, the last
    ``VLM_EMBED_STEPS`` of them fed the chosen tokens' embeddings through
    ``embeds=``.  Returns (logits (B, 1 + steps, V): the prefill's, then
    each step's; the fed embeddings (B, steps, d); the cache; prefill s;
    decode s), the times ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"embeds": embeds,
                                           "positions": pos}, max_len)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows, fed = [logits], []
    for j in range(steps):
        tok = rows[-1].argmax(-1)
        fed.append(params["embed"][tok][:, None])
        via_embeds = j >= steps - VLM_EMBED_STEPS
        logits, cache = model.decode_step(
            params, cache, tok, embeds=fed[-1] if via_embeds else None)
        rows.append(logits)
    torch.cuda.synchronize()
    return (torch.stack(rows, dim=1), torch.cat(fed, dim=1), cache, t1 - t0,
            time.perf_counter() - t1)


def _vlm_forward_batch(embeds, pos, fed):
    """The forward's batch over the prompt's and the fed embeddings: each
    decode step sits at its position (its cache length) in all three
    M-RoPE streams, as ``decode_step`` puts it."""
    B, S = embeds.shape[:2]
    n = fed.shape[1]
    steps_pos = torch.arange(S, S + n, dtype=torch.int32,
                             device=pos.device).expand(3, B, n)
    return {"embeds": torch.cat([embeds, fed], dim=1),
            "positions": torch.cat([pos, steps_pos], dim=-1)}


def vlm_serve_phase():
    """qwen2-vl-2b at full width, :data:`VLM_SERVE_LAYERS` of its 28 layers
    (d_model 1536, 12 heads padded to 16 over 2 KV heads of 128, QKV bias,
    M-RoPE sections (16, 24, 24), bf16, random weights from seed 0 built on
    the card):

    (a) ``Model.prefill`` on 2 prompts of 1024 patch-and-text embeddings
    at Qwen2-VL's positions (``vlm_positions``: flash causal at G 8, D
    128), then 32 greedy ``decode_step``s (decode at G 8), the last 4 fed
    as the chosen tokens' embeddings through ``embeds=`` (``_vlm_run``);
    counts reset just before and read just after (flash 28, decode 28 a
    step); the prefill's and steps' logits and ``Model.forward``'s over
    the prompt's and the fed embeddings at their positions
    (``_vlm_forward_batch``) both held against the fp32 forward of the
    same weights (``_bf16_gate``); then ``vlm_profile`` (8 decode steps
    under ``torch.profiler``);

    (b) the paged engine on token prompts, as JAX's engine serves vlm
    (``_engine_serve``: paged exactly once a layer a tick at G 8, the
    contiguous decode's logits gate), and ``vlm_engine_profile`` (8 busy
    ticks).  Returns the launches of both."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models import build_model

    L = VLM_SERVE_LAYERS
    cfg = _vlm_cfg(num_layers=L)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[vlm_serve] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
        f"{cfg.padded_heads} padded heads ({cfg.num_heads} real) over "
        f"{cfg.num_kv_heads} of {cfg.resolved_head_dim}, M-RoPE "
        f"{cfg.mrope_sections}, {n_params} parameters ({cfg.param_dtype}), "
        f"init {time.perf_counter() - t_phase:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    B = 2
    pos = vlm_positions(B, "cuda")
    S = pos.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(47)
    embeds = torch.randn((B, S, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    max_len = S + VLM_STEPS + 20     # the main path, then the profile's 20
    # the warm-up at the served shapes (a 64-token one left the 2048-row
    # GEMMs' first calls in the timed prefill: 445 ms against ~30 on an
    # H100)
    _vlm_run(model, params, embeds, pos, 2, max_len)

    # main path: counts from 0 just before, read just after
    reset_launches(flash_attention_cuda, decode_attention_cuda)
    torch.cuda.reset_peak_memory_stats()
    dec, fed, cache, t_pre, t_dec = _vlm_run(model, params, embeds, pos,
                                             VLM_STEPS, max_len)
    launches = {"flash_attention": flash_attention_cuda.launches,
                "decode_attention": decode_attention_cuda.launches}
    by_variant = dict(flash_attention_cuda.launches_by_variant)
    expected = {"flash_attention": L, "decode_attention": VLM_STEPS * L}
    stream = dec.argmax(-1)
    log({"vlm_embeds_serve": {
        "model": cfg.name, "layers": L, "batch": B, "prompt": S,
        "layout": [VLM_LAYOUT[0], list(VLM_LAYOUT[1]), VLM_LAYOUT[2]],
        "steps": VLM_STEPS, "steps_via_embeds": VLM_EMBED_STEPS,
        "parameters": n_params, "prefill_ms": t_pre * 1e3,
        "prefill_tok_per_s": B * S / t_pre,
        "decode_ms_per_step": t_dec / VLM_STEPS * 1e3,
        "decode_tok_per_s": B * VLM_STEPS / t_dec,
        "launches": launches, "expected": expected,
        "flash_launches_by_variant": by_variant,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "stream_head": stream[0, :8].tolist()}})
    if launches != expected or by_variant["wgmma"] != L:
        raise AssertionError(f"vlm serve launches {launches} "
                             f"({by_variant}), expected {expected}, all "
                             "flash of the wgmma variant")
    real = slice(0, cfg.vocab_size)
    if not (torch.isfinite(dec[..., real]).all()
            and bool((stream < cfg.vocab_size).all())):
        raise AssertionError("vlm serve: non-finite logits or a pad token")

    # the gate: one forward over the prompt and the fed embeddings
    reset_launches(flash_attention_cuda, decode_attention_cuda)
    batch = _vlm_forward_batch(embeds, pos, fed)
    with torch.no_grad():
        fwd, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    fwd_launches = flash_attention_cuda.launches
    log({"vlm_forward_launches": {
        "flash_attention": fwd_launches,
        "decode_attention": decode_attention_cuda.launches}})
    if fwd_launches != L or decode_attention_cuda.launches:
        raise AssertionError(f"vlm forward launched flash {fwd_launches} "
                             f"times and decode "
                             f"{decode_attention_cuda.launches}")
    _bf16_gate("vlm_forward_vs_decode_bf16", model, params, batch, dec,
               fwd[:, S - 1:], rows=slice(S - 1, None))
    _decode_profile(model, params, cache, stream[:, -1], "vlm_profile",
                    batch=B, prompt=S)
    del model, params, cache, fwd, dec, embeds, fed, batch
    torch.cuda.empty_cache()

    # (b) the engine on token prompts
    eng, model, params, prompts, max_new, eng_len, _ = _engine_serve(
        "vlm_serve", cfg, 8, 200, 29)
    profile_window(model, params, prompts, max_new, eng_len,
                   tag="vlm_engine_profile")
    del model, params
    torch.cuda.empty_cache()
    log({"vlm_serve_phase_s": time.perf_counter() - t_phase})
    return {"flash_attention": launches["flash_attention"] + fwd_launches,
            "decode_attention": launches["decode_attention"]
            + eng["decode_attention"],
            "paged_attention": eng["paged_attention"]}


def vlm_fp32_phase():
    """qwen2-vl-2b at full width in fp32, 2 layers, TF32 off: ``_vlm_run``
    over the 2 x 1024 embeddings at Qwen2-VL's positions and 8 greedy
    steps (the last 4 through ``embeds=``) against ``Model.forward`` over
    the same embeddings and positions (every position within
    ``LOGIT_ATOL_FP32``, the same argmax): the exact gate for M-RoPE and
    the embeddings' path on the card.  Returns the launches (flash 2,
    decode 2 a step)."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    L, n = VLM_FP32_LAYERS, VLM_FP32_STEPS
    cfg = _vlm_cfg(num_layers=L, dtype="float32", param_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=1)
    pos = vlm_positions(2, "cuda")
    S = pos.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(53)
    embeds = torch.randn((2, S, cfg.d_model), generator=gen, device="cuda")
    reset_launches(flash_attention_cuda, decode_attention_cuda)
    dec, fed, *_ = _vlm_run(model, params, embeds, pos, n, S + n)
    launches = {"flash_attention": flash_attention_cuda.launches,
                "decode_attention": decode_attention_cuda.launches}
    expected = {"flash_attention": L, "decode_attention": n * L}
    with torch.no_grad():
        fwd, _ = model.forward(params, _vlm_forward_batch(embeds, pos, fed))
    ref = fwd[:, S - 1:]
    diff = float((dec - ref).abs().max())
    same = bool(torch.equal(dec.argmax(-1), ref.argmax(-1)))
    log({"vlm_fp32": {"layers": L, "prompt": S, "steps": n,
                      "steps_via_embeds": VLM_EMBED_STEPS,
                      "max_abs_logit_diff": diff, "tol": LOGIT_ATOL_FP32,
                      "same_argmax": same, "launches": launches,
                      "expected": expected}})
    if launches != expected:
        raise AssertionError(f"vlm fp32 launches {launches}, expected "
                             f"{expected}")
    if not (diff <= LOGIT_ATOL_FP32 and same
            and bool(torch.isfinite(fwd).all())):
        raise AssertionError("vlm fp32: prefill + decode and the forward "
                             "over the same embeddings disagree")
    del model, params, fwd, dec
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The sharded transport and the manifest on the card
# ---------------------------------------------------------------------------

SHARDS = 4


def _sharded_run(target, plan, logs, on_card):
    """Enqueue ``plan`` (``(name, args, returns, where)``) record k on
    shard k % SHARDS of ``target`` (a sharded queue, or a list of single
    queues, one a shard), flushing every QUEUE_FLUSH_EVERY records and at
    the end (single queues in shard order; an async queue once more to
    collect the tail).  On a card everything runs under
    ``set_sync_debug_mode("error")``.  Returns the tickets and the
    (D, words) state after each flush (clones)."""
    logged = _queue_callees()
    singles = isinstance(target, list)
    tickets, states = [], []
    n = len(plan)
    ctx = sync_errors() if on_card else contextlib.nullcontext()
    flushes = [(k + 1) for k in range(n)
               if (k + 1) % QUEUE_FLUSH_EVERY == 0 or k + 1 == n]
    if not singles and target.mode == "async":
        flushes.append(n)
    with ctx:
        k = 0
        for stop in flushes:
            for name, args, returns, where in plan[k:stop]:
                q = target[k % SHARDS] if singles else \
                    target.local(k % SHARDS)
                _, t = q.enqueue_ticketed(name, *args, returns=returns,
                                          where=where)
                tickets.append(t)
                k += 1
            for q in (target if singles else [target]):
                q.flush(logged(logs))
            states.append(torch.stack([q.state.clone() for q in target])
                          if singles else target.state.clone())
    return tickets, states


def _sharded_plans_case(dev, geometry, mode, sanitize):
    """``rpc_queue``'s three seeded plans, each spread over a 4-shard
    queue on the card and on the CPU (and, sync, over four single CPU
    queues flushed in shard order): the state bit-equal after every
    flush, the tickets and the replay logs equal (an async queue's
    shards drain independently: its log as a multiset), the sanitizer's
    epoch records and ``flush_stats`` equal; exact launches.  Returns the
    records and the launches."""
    from repro_torch.core import (RpcQueue, ShardedRpcQueue, effects_barrier,
                                  flush_stats, reset_rpc_stats,
                                  reset_sanitize_stats, sanitize_stats)
    from repro_torch.kernels.rpc_async import (rpc_async_collect,
                                               rpc_async_post)
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.rpc_queue import rpc_enqueue

    geo = dict(geometry, mode=mode, sanitize=sanitize)
    counts = dict.fromkeys(("rpc_enqueue", "rpc_post", "rpc_async_post",
                            "rpc_async_collect"), 0)
    rec = {}
    labels = ("card", "cpu", "singles") if mode == "sync" else ("card", "cpu")
    for seed in QUEUE_SEEDS:
        plan = _queue_plan(dev, seed, QUEUE_RECORDS)
        runs = {}
        for label in labels:
            on_card = label == "card"
            if label == "singles":
                target = [RpcQueue.create(**geo, device="cpu")
                          for _ in range(SHARDS)]
            else:
                target = ShardedRpcQueue.create(
                    SHARDS, **geo, device=dev if on_card else "cpu")
            sub = [(n, card if on_card else cpu, r, wk if on_card else wc)
                   for n, card, cpu, r, wk, wc in plan]
            logs = []
            effects_barrier()
            reset_rpc_stats()
            reset_sanitize_stats()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                if on_card:
                    # main path: counts from 0 just before, read just after
                    rpc_enqueue.launches = rpc_post.launches = 0
                    rpc_async_post.launches = rpc_async_collect.launches = 0
                tickets, states = _sharded_run(target, sub, logs, on_card)
                if on_card:
                    n = {"rpc_enqueue": rpc_enqueue.launches,
                         "rpc_post": rpc_post.launches,
                         "rpc_async_post": rpc_async_post.launches,
                         "rpc_async_collect": rpc_async_collect.launches}
                if label != "singles":
                    assert target.join(timeout=60)
                effects_barrier()
            runs[label] = {"tickets": [int(t) for t in tickets],
                           "states": states, "logs": logs,
                           "san": sanitize_stats(), "stats": flush_stats()}
            del target
        card, cpu = runs["card"], runs["cpu"]
        flushes = len(card["states"])
        per_flush = {"sync": {"rpc_post": 1},
                     "async": {"rpc_async_post": 1,
                               "rpc_async_collect": 1}}[mode]
        want = {k: per_flush.get(k, 0) * flushes for k in n}
        want["rpc_enqueue"] = len(plan)
        order = (card["logs"] == cpu["logs"] if mode == "sync" else
                 sorted(card["logs"]) == sorted(cpu["logs"]))
        checks = {
            "states_vs_cpu": all(_equal_states(a, b) for a, b in
                                 zip(card["states"], cpu["states"])),
            "tickets": card["tickets"] == cpu["tickets"],
            "replay_log": order and bool(cpu["logs"]),
            "sanitizer_epochs": card["san"] == cpu["san"],
            "flush_stats": card["stats"] == cpu["stats"],
            "launches": n == want,
        }
        if mode == "sync":
            one = runs["singles"]
            checks["states_vs_single_queues"] = all(
                _equal_states(a, b) for a, b in zip(cpu["states"],
                                                    one["states"]))
            checks["log_vs_single_queues_in_device_slot_order"] = \
                cpu["logs"] == one["logs"]
            checks["tickets_vs_single_queues"] = \
                cpu["tickets"] == one["tickets"]
        rec[f"seed_{seed}"] = {"checks": checks, "flushes": flushes,
                               "records_replayed": len(cpu["logs"]),
                               "launches": n}
        for key in counts:
            counts[key] += n[key]
        if not all(checks.values()):
            raise AssertionError(f"rpc_sharded {mode} sanitize={sanitize} "
                                 f"seed {seed}: {rec}")
    return rec, counts


def _sharded_deadline(dev, mode="sync"):
    """``shard_deadline=0.25`` with a 2 s delay pinned to shard 1's record
    (occurrence 1 in (device, slot) order): the other shards read OK with
    their replies, shard 1 TIMEOUT, and a sync flush warns partial-epoch.
    An async queue flushes twice (the second collects, every row waiting
    up to the deadline) and joins the late drain."""
    import numpy as np
    from repro_torch.core import (ShapeDtype, ShardedRpcQueue,
                                  effects_barrier)
    from repro_torch.core.rpc import REGISTRY
    from repro_torch.testing.faults import Fault, FaultPlan

    REGISTRY.register("smoke.sd", lambda x: np.int32(x) * 2)
    sq = ShardedRpcQueue.create(SHARDS, 8, width=2, reply_capacity=8,
                                shard_deadline=0.25, mode=mode, device=dev)
    i32 = ShapeDtype((), torch.int32)
    tks = [sq.local(d).enqueue_ticketed("smoke.sd", 10 + d, returns=i32)[1]
           for d in range(SHARDS)]
    plan = FaultPlan([Fault("delay", "smoke.sd", call_index=1, delay=2.0)])
    t0 = time.perf_counter()
    with plan, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sq.flush()
        if mode == "async":
            sq.flush()
        effects_barrier()
        wall = time.perf_counter() - t0
        assert sq.join(timeout=60)
    statuses = [int(sq.result_status(d, t)) for d, t in enumerate(tks)]
    values = [int(sq.result(d, t)) for d, t in enumerate(tks)]
    warned = any("partial-epoch" in str(w.message) for w in caught)
    return {"statuses": statuses, "values": values, "warned": warned,
            "fired": [list(f) for f in plan.fired], "flush_wall_s": wall}


def _sharded_async_independent(dev):
    """An async 4-shard queue: every shard's ticket reads PENDING after
    the submitting flush and its reply after the collecting one."""
    import numpy as np
    from repro_torch.core import ShapeDtype, ShardedRpcQueue
    from repro_torch.core.rpc import REGISTRY

    REGISTRY.register("smoke.sh", lambda x: np.int32(x) + 5)
    sq = ShardedRpcQueue.create(SHARDS, 8, width=2, reply_capacity=8,
                                mode="async", device=dev)
    i32 = ShapeDtype((), torch.int32)
    tks = [int(sq.local(d).enqueue_ticketed("smoke.sh", 100 * (d + 1),
                                            returns=i32)[1])
           for d in range(SHARDS)]
    sq.flush()
    pending = [sq.local(d).statuses_host([t])[0] for d, t in enumerate(tks)]
    sq.flush()
    assert sq.join(timeout=60)
    done = [(sq.local(d).statuses_host([t])[0], int(sq.result(d, t)))
            for d, t in enumerate(tks)]
    return {"pending": pending, "collected": done}


def _sharded_logring(dev):
    """Four ring shards, shard d logging d + 1 records (some with a
    payload), drained by one flush: the lines in (device, slot) order."""
    from repro_torch.core import (LogRing, ShardedRpcQueue, drain_log_lines,
                                  effects_barrier)
    drain_log_lines()
    ring = LogRing.create_sharded(SHARDS, 16, payload_capacity=32,
                                  device=dev)
    pays = {(d, k): torch.tensor([float(d), float(k)], device=dev)
            for d in range(SHARDS) for k in range(0, d + 1, 2)}
    with sync_errors() if dev.type == "cuda" else contextlib.nullcontext():
        for d in range(SHARDS):
            for k in range(d + 1):
                LogRing(ring.q.local(d), ring.name).log(
                    10 * d + k, 0.5 * k, payload=pays.get((d, k)))
        LogRing(ShardedRpcQueue.stack([ring.q.local(d)
                                       for d in range(SHARDS)]),
                ring.name).flush()
    effects_barrier()
    return [(a, b) + tuple(c.tolist() for c in rest)
            for a, b, *rest in drain_log_lines()]


def _conformance(dev, transport, what):
    """JAX's ``test_cross_transport_conformance`` issuers on the port, on
    ``dev``: ``fprintf``, ``fwrite`` and remote malloc through immediate
    calls, a batched queue and a 2-shard sharded queue (one call a
    shard).  Returns the host effect and the device's results."""
    import numpy as np
    from repro_torch.core import (GenericAllocator, RpcQueue, ShapeDtype,
                                  ShardedRpcQueue, drain_fwrite,
                                  drain_printf, effects_barrier, fprintf,
                                  fwrite, remote_heap_register,
                                  remote_malloc_enqueue,
                                  remote_malloc_results, rpc_call)
    from repro_torch.core.libc import _intern_fmt

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    stream = {"immediate": 41, "batched": 42, "sharded": 43}[transport]
    drain_printf()
    drain_fwrite(stream)
    sharded = (ShardedRpcQueue.create(2, 8, width=4, payload_capacity=16,
                                      reply_capacity=8, device=dev)
               if transport == "sharded" else None)
    single = (RpcQueue.create(8, width=4, payload_capacity=16,
                              reply_capacity=8, device=dev)
              if transport == "batched" else None)
    if what == "fprintf":
        fmt = "conf %d %.1f"
        calls = [(3, 1.5), (4, -0.5)]
        for d, (a, b) in enumerate(calls):
            x = torch.tensor(b, device=dev)
            if transport == "immediate":
                rpc_call("libc.fprintf", i32(_intern_fmt(fmt)), i32(a), x,
                         result_shape=())
            else:
                fprintf(sharded.local(d) if sharded else single, fmt,
                        i32(a), x)
        if sharded or single:
            (sharded or single).flush()
        effects_barrier()
        return drain_printf(), None
    if what == "fwrite":
        for d, c in enumerate([[10, 20, 30], [40]]):
            if transport == "immediate":
                rpc_call("libc.fwrite", i32(stream), i32(c), result_shape=())
            else:
                fwrite(sharded.local(d) if sharded else single, i32(c),
                       stream=stream)
        if sharded or single:
            (sharded or single).flush()
        effects_barrier()
        return drain_fwrite(stream).tolist(), None
    name = f"heap.smoke_conf.{transport}"
    remote_heap_register(name, GenericAllocator.init(256, cap=16,
                                                     device="cpu"))
    nid = _intern_fmt(name)
    outs = []
    for d, sizes in enumerate([[8, 16], [4]]):
        spec = ShapeDtype((len(sizes),), torch.int32)
        if transport == "immediate":
            outs.append(rpc_call("libc.remote_malloc", i32(nid), i32(0),
                                 i32(sizes), result_shape=spec)[0])
            continue
        q = sharded.local(d) if sharded else single
        _, t = remote_malloc_enqueue(q, name, i32(sizes))
        outs.append((d, t, spec))
    if transport != "immediate":
        (sharded or single).flush()
        outs = [(sharded.result(d, t, spec) if sharded else
                 single.result(t, spec)) for d, t, spec in outs]
    effects_barrier()
    device_ptrs = [np.asarray(o.cpu()).tolist() for o in outs]
    state, host_ptrs = remote_malloc_results(name)
    return ([p.tolist() for p in host_ptrs], int(state.watermark)), \
        device_ptrs


def _flush_times(dev):
    """A 4 x 256-record sharded flush (one ``rpc_post`` carrying four
    rows) beside a 1 x 1024-record single-queue flush, in turns: CUDA
    events around the round trip, the host's time in ``flush`` and the
    drain's Python (median of 5 after a warm-up each)."""
    from repro_torch.core import RpcQueue, ShardedRpcQueue, effects_barrier
    from repro_torch.core.rpc import REGISTRY
    from repro_torch.kernels.rpc_channel import channel_for

    REGISTRY.register("smoke.q_full", lambda i, x, p: None)
    payload = torch.arange(4, dtype=torch.int32, device=dev)
    queues = {"sharded_4x256": ShardedRpcQueue.create(SHARDS, 256, 4, 1024,
                                                      device=dev),
              "single_1x1024": RpcQueue.create(1024, 4, 4096, device=dev)}
    chan = channel_for(dev)
    times = {k: {"ms": [], "host_us": [], "drain_python_us": []}
             for k in queues}
    for _ in range(6):
        for label, q in queues.items():
            for i in range(1024):
                (q.local(i % SHARDS) if label.startswith("sharded")
                 else q).enqueue("smoke.q_full", i, 0.5, payload)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            q.flush()
            host = (time.perf_counter() - t0) * 1e6
            b.record()
            effects_barrier()
            times[label]["ms"].append(a.elapsed_time(b))
            times[label]["host_us"].append(host)
            times[label]["drain_python_us"].append(chan.last_serve_ns * 1e-3)
    out = {}
    for label, t in times.items():
        ms = _median(t["ms"][1:])
        drain_ms = _median(t["drain_python_us"][1:]) * 1e-3
        out[label] = {"ms": ms, "host_us": _median(t["host_us"][1:]),
                      "drain_python_ms": drain_ms,
                      "host_share": drain_ms / ms, "flushes_timed": 5}
    return out


def rpc_sharded_phase(card_line):
    """The sharded transport on the card (see the module docstring):
    ``rpc_queue``'s plans on 4-shard queues, sync and async, plain and
    sanitized; the deadline's partial epoch; async independence; the
    sharded ``LogRing``; the cross-transport conformance; the flush
    times.  Returns the launches of each transport kernel on the path and
    the sharded queues (for the manifest)."""
    from repro_torch.core import ShardedRpcQueue
    from repro_torch.core.rpc import STATUS_OK, STATUS_PENDING, STATUS_TIMEOUT

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    launches = dict.fromkeys(("rpc_enqueue", "rpc_post", "rpc_async_post",
                              "rpc_async_collect"), 0)
    plans = {}
    for mode in ("sync", "async"):
        for sanitize in (False, True):
            geo = SAN_GEOMETRY if sanitize else QUEUE_GEOMETRY
            rec, n = _sharded_plans_case(dev, geo, mode, sanitize)
            plans[f"{mode}{'_sanitized' if sanitize else ''}"] = rec
            for k in launches:
                launches[k] += n[k]
    deadline = {"card": _sharded_deadline(dev),
                "cpu": _sharded_deadline(torch.device("cpu"))}
    deadline_async = {"card": _sharded_deadline(dev, "async"),
                      "cpu": _sharded_deadline(torch.device("cpu"), "async")}
    independent = {"card": _sharded_async_independent(dev),
                   "cpu": _sharded_async_independent(torch.device("cpu"))}
    ring = {"card": _sharded_logring(dev),
            "cpu": _sharded_logring(torch.device("cpu"))}
    conformance = {}
    for what in ("fprintf", "fwrite", "remote_malloc"):
        conformance[what] = {t: _conformance(dev, t, what)
                             for t in ("immediate", "batched", "sharded")}
    times = _flush_times(dev)
    ok_d = [STATUS_OK, STATUS_TIMEOUT] + [STATUS_OK] * (SHARDS - 2)
    checks = {
        "deadline_card_eq_cpu": deadline["card"]["statuses"]
        == deadline["cpu"]["statuses"] == ok_d,
        "deadline_replies": [v for d, v in
                             enumerate(deadline["card"]["values"]) if d != 1]
        == [2 * (10 + d) for d in range(SHARDS) if d != 1],
        "deadline_warned": deadline["card"]["warned"]
        and deadline["cpu"]["warned"],
        "deadline_async_card_eq_cpu": deadline_async["card"]["statuses"]
        == deadline_async["cpu"]["statuses"] == ok_d
        and deadline_async["card"]["values"]
        == deadline_async["cpu"]["values"],
        "async_independent": independent["card"] == independent["cpu"] == {
            "pending": [STATUS_PENDING] * SHARDS,
            "collected": [(STATUS_OK, 100 * (d + 1) + 5)
                          for d in range(SHARDS)]},
        "logring_device_slot_order": ring["card"] == ring["cpu"] and
        [r[0] for r in ring["card"]] == [10 * d + k for d in range(SHARDS)
                                         for k in range(d + 1)],
        "conformance": all(v["immediate"] == v["batched"] == v["sharded"]
                           for v in conformance.values()),
    }
    log({"rpc_sharded": {"card": card_line, "shards": SHARDS,
                         "plans": plans, "deadline": deadline,
                         "deadline_async": deadline_async,
                         "async_independent": independent,
                         "logring_lines": len(ring["card"]),
                         "conformance": conformance, "flush_times": times,
                         "checks": checks, "launches": launches,
                         "phase_seconds": time.perf_counter() - t_phase}})
    if not all(checks.values()):
        raise AssertionError(f"rpc_sharded: {checks}")
    keep = ShardedRpcQueue.create(SHARDS, **QUEUE_GEOMETRY, device=dev)
    return launches, [keep]


_XP_PROGRAM = r"""
import json, os
import torch
from repro_torch.core import libc
from repro_torch.core import rpc as rpc_mod
from repro_torch.core.allocator import GenericAllocator
from repro_torch.kernels.rpc_channel import rpc_post
from repro_torch.kernels.rpc_queue import rpc_enqueue

HEAP, FMT = "heap.xproc", "xp %d %.1f"
dev = torch.device("cuda", 0)
libc.remote_heap_register(HEAP, GenericAllocator.init(256, cap=16,
                                                      device="cpu"))
adopted = {}
if mode == "adopt":
    # a fresh process binds the ids before issuing anything; the
    # exporter's other callees have no host here, so the strict adopt
    # names one, and the program's own (libc's) are checked to resolve
    m = rpc_mod.RpcManifest.load(os.path.join(outdir, "manifest.json"))
    try:
        rpc_mod.adopt_manifest(m)
    except ValueError as exc:
        adopted["strict_refusal"] = str(exc)
    rpc_mod.adopt_manifest(m, require_hosts=False)
    adopted["libc_ids"] = {name: cid == rpc_mod.REGISTRY.batch_callee_id(name)
                           for cid, name in m.callees.items()
                           if name.startswith("libc.")}
    adopted["formats"] = {text: libc._intern_fmt(text) == fid
                          for fid, text in m.formats.items()
                          if text in (HEAP, FMT)}
fid = libc._intern_fmt(FMT)
nid = libc._intern_fmt(HEAP)
rpc_enqueue.launches = rpc_post.launches = 0
i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
q = rpc_mod.RpcQueue.create(8, width=4, payload_capacity=32,
                            reply_capacity=8, device=dev)
libc.fprintf(q, FMT, i32(3), torch.tensor(1.5, device=dev))
q, t = libc.remote_malloc_enqueue(q, HEAP, i32([8, 16]))
libc.fprintf(q, FMT, i32(4), torch.tensor(-0.5, device=dev))
q.flush()
ptrs = q.result(t, (2,), torch.int32).tolist()
rpc_mod.effects_barrier()
state, host_ptrs = libc.remote_malloc_results(HEAP)
out = {"printf": libc.drain_printf(),
       "host_ptrs": [p.tolist() for p in host_ptrs],
       "watermark": int(state.watermark), "device_ptrs": ptrs,
       "launches": {"rpc_enqueue": rpc_enqueue.launches,
                    "rpc_post": rpc_post.launches},
       "adopted": adopted}
with open(os.path.join(outdir, mode + ".json"), "w") as f:
    json.dump(out, f)
"""


def manifest_phase(queues):
    """JAX's ``test_cross_process_conformance`` on the card.  This process
    runs the batched program (``fprintf`` and a ticketed remote malloc on
    a card queue) and exports its manifest with the sharded queues'
    geometry (``export_manifest(queues=...)``); a fresh ``python3 -c``
    process that imports only ``repro_torch`` adopts it and issues the
    same program on the card.  The printf lines, heap pointers,
    watermark, reply-arena pointers and launches must be equal; a
    manifest whose pad signature was tampered is refused with the pad's
    callee named.  Returns the exporter's launches (the path)."""
    from repro_torch.core import RpcManifest, adopt_manifest, export_manifest

    t_phase = time.perf_counter()
    outdir = os.path.join(ROOT, "build", "manifest_smoke")
    os.makedirs(outdir, exist_ok=True)
    scope = {"outdir": outdir, "mode": "export"}
    exec(compile(_XP_PROGRAM, "xp_program", "exec"), scope)
    manifest = export_manifest(queues=queues)
    manifest.save(os.path.join(outdir, "manifest.json"))
    doc = json.loads(manifest.to_json())
    # a pad with an operand (a call without one has an empty signature)
    pid, entry = next((p, e) for p, e in doc["pads"].items()
                      if e["signature"])
    sig = entry["signature"][0]
    sig[2] = "float32" if sig[2] != "float32" else "int32"
    try:
        adopt_manifest(RpcManifest.from_json(json.dumps(doc)))
        refused = None
    except ValueError as exc:
        refused = str(exc)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = f"outdir, mode = {outdir!r}, 'adopt'\n" + _XP_PROGRAM
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"manifest: the adopting process failed:\n"
                             f"{proc.stderr[-4000:]}")
    with open(os.path.join(outdir, "export.json")) as f:
        a = json.load(f)
    with open(os.path.join(outdir, "adopt.json")) as f:
        b = json.load(f)
    adopted = b.pop("adopted")
    a.pop("adopted")
    checks = {
        "adopter_equals_exporter": a == b,
        "printf": a["printf"] == ["xp 3 1.5", "xp 4 -0.5"],
        "pointers": a["device_ptrs"] == a["host_ptrs"][0] == [0, 8],
        "launches": a["launches"] == {"rpc_enqueue": 3, "rpc_post": 1},
        "libc_ids_resolve": bool(adopted.get("libc_ids"))
        and all(adopted["libc_ids"].values())
        and len(adopted["formats"]) == 2 and all(adopted["formats"].values()),
        "strict_adopt_names_a_missing_host": "not registered" in
        adopted.get("strict_refusal", "")
        or "no host function" in adopted.get("strict_refusal", ""),
        "tampered_refused_naming_callee": refused is not None
        and repr(entry["callee"]) in refused,
        "queues_in_manifest": any(g["shards"] == SHARDS
                                  for g in doc["queues"]),
    }
    log({"manifest": {"exporter": a, "adopter": b, "adopted": adopted,
                      "tampered_pad": int(pid), "refusal": refused,
                      "pads": len(doc["pads"]),
                      "callees": len(doc["callees"]),
                      "formats": len(doc["formats"]),
                      "queues": len(doc["queues"]),
                      "subprocess_s": sub_s, "checks": checks,
                      "phase_seconds": time.perf_counter() - t_phase}})
    if not all(checks.values()):
        raise AssertionError(f"manifest: {checks}")
    return a["launches"]


# ---------------------------------------------------------------------------
# Meshes, the runtime side: the one-device mesh on the card
# ---------------------------------------------------------------------------

#: The mesh phase's traffic: four short requests of 16 new tokens on four
#: slots (``serve``'s llama3.2-3b, full width and depth), and the steps of
#: its ``device_run`` comparison.
MESH_NEW = 16
MESH_MAX_LEN = 64
MESH_STEPS = 200
MESH_SHARDS = 4


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _mesh_fig6_region(mesh, device):
    """Fig. 6's region (``malloc_grid`` 8 x 4 on the team's balanced heap,
    the sum of its pointers logged on the team's ring row) expanded over
    ``mesh``, against the same requests on one heap and one ring without
    a mesh: the pointers (``team_ptr`` of each, resolved through
    ``find_obj``) and the records must be the single heap's."""
    from repro_torch.core import (P, effects_barrier, expand, find_obj,
                                  set_team_heap, set_team_queue, shard_heap,
                                  team_heap, team_id, team_ptr, team_queue)
    from repro_torch.core.allocator import BalancedAllocator as BA
    from repro_torch.core.libc import LogRing, drain_log_lines
    from repro_torch.evaluation.allocator import MESH_GRID, MESH_SPAN

    T, G = MESH_GRID
    sizes = (torch.arange(T * G, dtype=torch.int32,
                          device=device).reshape(T, G) % 7) + 1

    def log_sum(ring, tag, ptrs):
        total = torch.sum(torch.where(ptrs >= 0, ptrs, 0))
        return ring.log(tag, total.to(torch.float32))

    def region():
        st, ptrs = BA.malloc_grid(team_heap(), T, G, sizes)
        set_team_heap(st)
        set_team_queue(log_sum(team_queue(), team_id(), ptrs))
        return team_ptr(ptrs)[None]

    heap = shard_heap(BA.init(MESH_SPAN, 4, 2, cap=64, device=device), 1,
                      span=MESH_SPAN)
    ring = LogRing.create_sharded(1, 16, device=device)
    heap2, ring2, gptrs = expand(region, mesh, (), P("dev"), heap=True,
                                 queue=True)(heap, ring)
    effects_barrier()
    drain_log_lines()
    ring2.flush()
    effects_barrier()
    recs = drain_log_lines()
    st, ref = BA.malloc_grid(BA.init(MESH_SPAN, 4, 2, cap=64, device=device),
                             T, G, sizes)
    plain = LogRing.create(16, device=device)
    log_sum(plain, 0, ref).flush()
    effects_barrier()
    want = drain_log_lines()
    resolved = [[int(v) for v in find_obj(heap2, p)] for p in
                gptrs.reshape(-1) if int(p) >= 0]
    return {"pointers_equal": torch.equal(gptrs[0], ref),
            "records_equal": recs == want and len(recs) == 1,
            "find_obj_resolves": len(resolved) == MESH_GRID[0] * MESH_GRID[1]
            and all(found == 1 and base == p for (found, base, _), p in
                    zip(resolved, gptrs.reshape(-1).tolist())),
            "heap_state_equal": all(
                torch.equal(getattr(heap2.shards, f)[0], getattr(st, f))
                for f in ("offsets", "sizes", "in_use", "count",
                          "watermark"))}


def _mesh_sanitize(mesh, device):
    """``tests/test_sanitizer.py:134-160``'s program on the card:
    ``expand(queue=True, sanitize=True)`` against ``sanitize=False``,
    the same outputs and records, no canary stomp or poison hit."""
    import numpy as np
    from repro_torch.core import (P, ShardedRpcQueue, effects_barrier, expand,
                                  reset_sanitize_stats, sanitize_stats,
                                  set_team_queue, team_queue)
    from repro_torch.core.rpc import REGISTRY
    recs = []
    REGISTRY.register("smoke.mesh_rec", lambda *a: recs.append(
        [np.asarray(x).tolist() for x in a]))

    def region(x):
        q = team_queue()
        q.enqueue("smoke.mesh_rec", x * 2)
        q.enqueue("smoke.mesh_rec", 0.5)
        set_team_queue(q)
        return torch.cumsum(x, 0).to(torch.int32) + 1

    runs = {}
    for sanitize in (False, True):
        recs.clear()
        reset_sanitize_stats()
        f = expand(region, mesh, (P("dev"),), P("dev"), queue=True,
                   sanitize=sanitize)
        q, out = f(ShardedRpcQueue.create(1, 8, 4, 64, device=device),
                   torch.arange(4, dtype=torch.int32, device=device))
        q.flush()
        effects_barrier()
        runs[sanitize] = (out.cpu(), list(recs), sanitize_stats())
    st = runs[True][2]
    return {"outputs_equal": torch.equal(runs[True][0], runs[False][0])
            and runs[True][0].tolist() == [1, 2, 4, 7],
            "records_equal": runs[True][1] == runs[False][1]
            and runs[True][1] == [[[0, 2, 4, 6]], [0.5]],
            "sanitizer_clean": st["canary_stomps"] == 0
            and st["poison_hits"] == 0 and len(st["epochs"]) == 1}


def _mesh_device_run(mesh, device):
    """``device_run_hooks``' hooks (an immediate hook every 100 steps and
    one every step, a batched one every step) over :data:`MESH_STEPS`
    steps with ``mesh=`` and without: the same host records in the same
    order and the same final state (under the mesh every hook rides the
    team's queue row and one flush at the end)."""
    from repro_torch.core import HostHook, device_run, effects_barrier
    runs, secs = [], []
    for m in (None, mesh):
        seen = []
        hooks = [HostHook(every=every, extract=lambda i, s: s[:256].sum(),
                          host_fn=lambda i, v, tag=tag: seen.append(
                              (tag, i, float(v))),
                          name=f"smoke.mesh_{tag}", batched=batched)
                 for tag, every, batched in (("every_100", 100, False),
                                             ("every_1", 1, False),
                                             ("batched_every_1", 1, True))]
        t0 = time.perf_counter()
        final = device_run(lambda i, s: s + 1.0,
                           torch.zeros(256, device=device), MESH_STEPS,
                           hooks=hooks, mesh=m, queue_capacity=4096)
        effects_barrier()
        secs.append(time.perf_counter() - t0)
        runs.append((final.cpu(), sorted(seen, key=lambda r: (r[1], r[0]))))
    return ({"records_equal": runs[0][1] == runs[1][1]
             and len(runs[0][1]) == MESH_STEPS * 2 + MESH_STEPS // 100,
             "state_equal": torch.equal(runs[0][0], runs[1][0])},
            {"plain_s": secs[0], "mesh_s": secs[1]})


def _mesh_engines(model, params, prompts, mesh, device):
    """Three engines on the same four requests, tick by tick: without a
    mesh, on the one-device mesh (``mesh=`` the ``DeviceMesh``) and on
    :data:`MESH_SHARDS` shards of the page heap stacked on the card
    (``mesh=4``).  Page tables equal without a mesh and on the one-device
    mesh at every tick; at ``mesh=4`` each slot's live pages lie in its
    shard's span; the greedy streams equal.  Returns the checks, ms a
    tick of each engine and the ticks."""
    from repro_torch.serving import kvcache
    from repro_torch.serving.engine import ServingEngine

    engines = [ServingEngine(model, params, batch_slots=4, page_size=16,
                             max_len=MESH_MAX_LEN, device=device, mesh=m)
               for m in (None, mesh, MESH_SHARDS)]
    rids = [[e.submit(p, max_new=MESH_NEW) for p in prompts]
            for e in engines]
    tables_equal, in_span, ticks = True, True, 0
    secs = [0.0, 0.0, 0.0]
    span = engines[2].kv.alloc.span
    per = engines[2].B // MESH_SHARDS
    while any(e.queue or any(s.request_id >= 0 for s in e.slots)
              for e in engines):
        for k, e in enumerate(engines):
            _sync(device)
            t0 = time.perf_counter()
            e.step()
            _sync(device)
            secs[k] += time.perf_counter() - t0
        ticks += 1
        tables_equal &= torch.equal(engines[0].kv.page_table,
                                    engines[1].kv.page_table)
        kv = engines[2].kv
        for b in range(engines[2].B):
            pages = kvcache.live_pages(kv, b)
            d = b // per
            in_span &= bool(((pages >= d * span)
                             & (pages < (d + 1) * span)).all())
    streams = [[e.finished[r] for r in rs] for e, rs in zip(engines, rids)]
    checks = {"streams_equal": streams[0] == streams[1] == streams[2]
              and all(len(s) == MESH_NEW for s in streams[0]),
              "page_tables_equal_mesh1": tables_equal,
              "pages_in_shard_span_mesh4": in_span}
    return checks, {"ms_per_tick": {k: s / ticks * 1e3 for k, s in
                                    zip(("unsharded", "mesh1", "mesh4"),
                                        secs)},
                    "ticks": ticks, "streams": streams[0]}


def mesh_phase(model, params, prompts):
    """Meshes, the runtime side, on the card: a world of one process
    (``nccl``) and its one-device mesh ``("dev",)``.  Gates, each failing
    the run:

    * (a) the one-device mesh bit-identical to the paths without one:
      Fig. 6's region (:func:`_mesh_fig6_region`), ``expand(sanitize=
      True)`` (:func:`_mesh_sanitize`), ``device_run(mesh=)``
      (:func:`_mesh_device_run`) and ``parallel_for(mesh=)``; a CPU
      tensor for the card's mesh raises;
    * (b) the engine on the sharded page heap (:func:`_mesh_engines`):
      ``serve``'s llama3.2-3b at full width and depth on 4 slots and 4
      short requests of :data:`MESH_NEW` new tokens, with ``mesh=`` the
      one-device mesh and ``mesh=4`` beside the unsharded engine;
    * (c) Fig. 6's mesh section (``evaluation/allocator.py::
      mesh_section``) on the one-device mesh.

    The launch counts are set to 0 just before and read just after:
    ``paged_attention`` (3 engines x ticks x 28 layers), ``rpc_enqueue``
    and ``rpc_post`` (the kernels line's ``mesh`` path).  The world (which
    the corpus's ``callback_in_mesh`` may have started) is left after the
    phase."""
    from repro_torch.launch.mesh import close_world, init_world, make_mesh

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    init_world(device="cuda")
    mesh = make_mesh((1,), ("dev",), device="cuda")
    world_s = time.perf_counter() - t0
    try:
        return _mesh_gates(model, params, prompts, mesh, world_s, t_phase)
    finally:
        close_world()     # the later phases run without a process group


def _mesh_gates(model, params, prompts, mesh, world_s, t_phase):
    """:func:`mesh_phase`'s gates on ``mesh``; returns the launches."""
    from repro_torch.core import P, expand, parallel_for
    from repro_torch.evaluation.allocator import mesh_section
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda)
    from repro_torch.kernels.rpc_channel import rpc_post
    from repro_torch.kernels.rpc_queue import rpc_enqueue

    requests = prompts[1:5]
    # main path: counts from 0 just before, read just after
    paged_attention_cuda.launches = 0
    rpc_post.launches = rpc_enqueue.launches = 0
    checks = {f"fig6_region_{k}": v
              for k, v in _mesh_fig6_region(mesh, CARD).items()}
    checks.update({f"sanitize_{k}": v
                   for k, v in _mesh_sanitize(mesh, CARD).items()})
    run_checks, run_times = _mesh_device_run(mesh, CARD)
    checks.update({f"device_run_{k}": v for k, v in run_checks.items()})
    arr = torch.arange(64.0, device=CARD)
    body = lambda i, a: a[i] * 3.0 + i  # noqa: E731
    checks["parallel_for_equal"] = torch.equal(
        parallel_for(body, 61, arr, mesh=mesh), parallel_for(body, 61, arr))
    try:
        expand(lambda x: x, mesh, (P("dev"),), P("dev"))(torch.zeros(1))
        checks["cpu_tensor_refused"] = False
    except ValueError:
        checks["cpu_tensor_refused"] = True
    engine_checks, engines = _mesh_engines(model, params, requests, mesh,
                                           model.device)
    checks.update({f"engine_{k}": v for k, v in engine_checks.items()})
    fig6 = mesh_section(mesh, mesh)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention_cuda.launches,
                "rpc_enqueue": rpc_enqueue.launches,
                "rpc_post": rpc_post.launches}
    checks["fig6_mesh_section"] = (
        fig6["per_device_bit_identical_to_single_heap"]
        and fig6["one_device_mesh_bit_identical"]
        and fig6["queue_flush_records"] == 1
        and fig6["queue_flush_device_major"])
    checks["paged_3_engines_x_ticks_x_layers"] = (
        launches["paged_attention"] == 3 * engines["ticks"] * SERVE_LAYERS)
    checks["transport_launched"] = (launches["rpc_enqueue"] >= 1
                                    and launches["rpc_post"] >= 1)
    rec = {"world": {"backend": str(torch.distributed.get_backend()),
                     "size": torch.distributed.get_world_size(),
                     "init_s": world_s},
           "mesh": {"shape": [mesh.size()], "axes": ["dev"],
                    "device_type": mesh.device_type},
           "engines": {"layers": SERVE_LAYERS, "slots": 4,
                       "requests": len(requests), "new_tokens": MESH_NEW,
                       "shards": MESH_SHARDS, **engines},
           "device_run": {"steps": MESH_STEPS, **run_times},
           "fig6": fig6, "launches": launches, "nvidia_smi": nvidia_smi(),
           "checks": checks,
           "phase_seconds": time.perf_counter() - t_phase}
    log({"mesh": rec})
    if not all(checks.values()):
        raise AssertionError(f"mesh: {checks}")
    return launches


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



#: Wall seconds of each phase that ``main`` ran (a phase run twice, the
#: sum), logged before the ``kernels`` line.
PHASE_SECONDS: dict = {}


def timed(fn, *args):
    """``fn(*args)``, its wall seconds added to :data:`PHASE_SECONDS`."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        key = fn.__name__
        PHASE_SECONDS[key] = PHASE_SECONDS.get(key, 0.0) \
            + time.perf_counter() - t0


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

    summary = timed(kernel_phase, card)
    timed(decode_reuse_phase)
    timed(decode_launch_phase)
    timed(rglru_launch_phase)
    serve, spill, artifact, analysis, mesh = timed(serve_phase)
    timed(identity_phase)
    dense = timed(dense_serve_phase)
    moe = timed(moe_serve_phase)
    moe32 = timed(moe_fp32_phase)
    encdec = timed(encdec_serve_phase)
    encdec32 = timed(encdec_fp32_phase)
    vlm = timed(vlm_serve_phase)
    vlm32 = timed(vlm_fp32_phase)
    at_flash = timed(flash_phase, card_line)
    summary["flash_attention"] = at_flash["train"]
    timed(prefill_phase)
    train = timed(train_phase)
    mesh_train = timed(mesh_train_phase, train["losses"])
    timed(train_profile)
    at_ssd = timed(ssd_kernel_phase, card_line)
    summary["ssd_scan"] = at_ssd["prefill"]
    ssm_serve = timed(ssm_serve_phase)
    timed(ssm_prefill_phase)
    ssm_train, ssm_hooks = timed(ssm_train_phase)
    timed(train_profile, "mamba2-130m", SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)
    at_rglru = timed(rglru_kernel_phase, card_line)
    summary["rglru_scan"] = at_rglru["serve"]
    at_hybrid = timed(hybrid_attn_kernel_phase, card_line)
    hybrid = timed(hybrid_serve_phase)
    timed(hybrid_prefill_phase)
    ckpt = timed(ckpt_train_phase)
    hybrid_train = timed(hybrid_train_phase)
    encdec_train = timed(encdec_train_phase)
    vlm_train = timed(vlm_train_phase)
    rpc_err = timed(rpc_phase)
    timed(rpc_gil_phase)
    empty = timed(rpc_time_phase, card_line)
    summary["rpc_channel"] = {
        "max_abs_err": rpc_err, "kernel_ms": empty["ms"],
        "plain_ms": empty["plain_ms"], "bound_ms": empty["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "latency_floor_ms": empty["latency_floor"]["ms"]}
    queue_launches, queue_posts = timed(rpc_queue_phase)
    timed(rpc_queue_faults_phase)
    scalar = timed(rpc_queue_time_phase, card_line)
    summary["rpc_queue"] = {
        "max_abs_err": 0.0, "kernel_ms": scalar["ms"],
        "plain_ms": scalar["plain_ms"], "bound_ms": scalar["bound_ms"],
        "bound_by": "bytes", "library_ms": None}
    libc_launches, libc_posts = timed(libc_io_phase)
    hooks, hook_enqueues = timed(device_run_hooks_phase)
    async_queue = timed(rpc_queue_async_phase)
    summary.update(timed(rpc_async_time_phase, card_line))
    async_run = timed(device_run_async_phase)
    pipeline_posts = timed(host_pipeline_phase)
    san_enqueues, san_async = timed(sanitizer_phase, card_line)
    timed(allocators_phase, card_line)
    timed(events_phase)
    sharded, sharded_queues = timed(rpc_sharded_phase, card_line)
    manifest = timed(manifest_phase, sharded_queues)
    gpu_first = timed(gpu_first_phase)
    timed(host_driven_phase, card_line)
    paper_eval = timed(paper_eval_phase, card_line)

    by_path = {
        "decode_attention": {"serve": serve["decode_attention"],
                             "dense_serve": dense["decode_attention"],
                             "moe_serve": moe["decode_attention"],
                             "moe_fp32": moe32["decode_attention"],
                             "encdec_serve": encdec["decode_attention"],
                             "encdec_fp32": encdec32["decode_attention"],
                             "vlm_serve": vlm["decode_attention"],
                             "vlm_fp32": vlm32["decode_attention"],
                             "hybrid_serve": hybrid["decode_attention"]},
        "paged_attention": {"serve": serve["paged_attention"],
                            "artifact_serve": artifact["paged_attention"],
                            "mesh": mesh["paged_attention"],
                            "dense_serve": dense["paged_attention"],
                            "moe_serve": moe["paged_attention"],
                            "moe_fp32": moe32["paged_attention"],
                            "vlm_serve": vlm["paged_attention"]},
        "flash_attention": {"train": train["flash_attention"],
                            "mesh_train": mesh_train["flash_attention"],
                            "encdec_serve": encdec["flash_attention"],
                            "encdec_fp32": encdec32["flash_attention"],
                            "vlm_serve": vlm["flash_attention"],
                            "vlm_fp32": vlm32["flash_attention"],
                            "hybrid_serve": hybrid["flash_attention"],
                            "ckpt_train": ckpt["flash_attention"],
                            "hybrid_train": hybrid_train["flash_attention"],
                            "encdec_train": encdec_train["flash_attention"],
                            "vlm_train": vlm_train["flash_attention"]},
        "ssd_scan": {"ssm_serve": ssm_serve, "ssm_train": ssm_train},
        "rglru_scan": {"hybrid_serve": hybrid["rglru_scan"],
                       "hybrid_train": hybrid_train["rglru_scan"]},
        "rpc_channel": {"train": train["rpc_post"], "ssm_train": ssm_hooks,
                        "ckpt_train": ckpt["rpc_post"],
                        "hybrid_train": hybrid_train["rpc_post"],
                        "encdec_train": encdec_train["rpc_post"],
                        "vlm_train": vlm_train["rpc_post"],
                        "rpc_queue": queue_posts, "libc_io": libc_posts,
                        "device_run_hooks": hooks,
                        "host_pipeline": pipeline_posts,
                        "rpc_sharded": sharded["rpc_post"],
                        "manifest": manifest["rpc_post"],
                        "gpu_first": gpu_first,
                        "paper_eval": paper_eval["rpc_post"],
                        "analysis": analysis["rpc_post"],
                        "mesh": mesh["rpc_post"],
                        "mesh_train": mesh_train["rpc_post"]},
        "rpc_queue": {"rpc_queue": queue_launches, "libc_io": libc_launches,
                      "device_run_hooks": hook_enqueues,
                      "serve_spill": spill["rpc_enqueue"],
                      "sanitizer": san_enqueues,
                      "rpc_sharded": sharded["rpc_enqueue"],
                      "manifest": manifest["rpc_enqueue"],
                      "paper_eval": paper_eval["rpc_enqueue"],
                      "analysis": analysis["rpc_enqueue"],
                      "mesh": mesh["rpc_enqueue"],
                      "mesh_train": mesh_train["rpc_enqueue"]},
    }
    for name in ENTRY_NAMES["rpc_async"]:
        by_path[name] = {"rpc_queue_async": async_queue[name],
                         "device_run_async": async_run[name],
                         "serve_spill": spill[name],
                         "sanitizer": san_async[name],
                         "rpc_sharded": sharded[name],
                         "paper_eval": paper_eval[name],
                         "analysis": analysis[name]}
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
        if "latency_floor_ms" in rec:
            kernels[-1]["latency_floor_ms"] = rec["latency_floor_ms"]
        if len(paths) > 1:
            kernels[-1]["launches_by_path"] = paths
        is_flash = name == "flash_attention"
        for key, other in (("at_hybrid_shape", at_hybrid.get(name)),
                           ("at_dense_serve_shape",
                            summary.get(name + "@g6")),
                           ("at_encdec_cross_shape",
                            summary.get(name + "@g1_enc")),
                           ("at_vlm_shape", summary.get(name + "@g8")),
                           ("at_encoder_shape",
                            is_flash and at_flash["enc_d64"]),
                           ("at_vlm_prefill_shape",
                            is_flash and at_flash["vlm_prefill"]),
                           ("at_train_shape", name == "ssd_scan"
                            and at_ssd["train"]),
                           ("at_s1000_shape", name == "rglru_scan"
                            and at_rglru["s1000"]),
                           ("at_hybrid_train_shape",
                            (is_flash and at_hybrid["flash_attention@train"])
                            or (name == "rglru_scan" and at_rglru["train"])),
                           ("at_ckpt_train_shape",
                            is_flash and at_flash["ckpt_d64"]),
                           ("at_encdec_train_shape",
                            is_flash and at_flash["d64"])):
            if other:
                kernels[-1][key] = {
                    "shape": other.get("shape", other.get("case")),
                    "max_abs_err": other["max_abs_err"],
                    "ms": other["kernel_ms"], "plain_ms": other["plain_ms"],
                    "bound_ms": other["bound_ms"],
                    "bound_by": other["bound_by"],
                    "library_ms": other["library_ms"]}
    log({"phase_seconds": PHASE_SECONDS})
    log({"kernels": kernels})
    log(card_line)
    log({"ok": True, "device": {"platform": "gpu", "kind": card,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
