"""The serve driver: an open loop of requests in front of the port's
``ServingEngine``, one cell's run from set-up to the check.

Set-up builds the weights from the seed (``modelcfg.make_weights``) and the
engine (:data:`SETTINGS`' slots and page size; ``max_len`` the mix's
longest request, rounded up to a page), submits the mix's first wave and
runs ``warmup_ticks`` ticks while requests arrive, so that every shape the
window uses has run.  The window then runs whole ticks until ``seconds``
have passed.  Before each tick every request due by then is submitted
(``harness/trafficgen.py``: Poisson arrivals at the mix's fixed rate).

The host clock reads each tick's end; the engine's one device-to-host copy
a tick (its argmax) ends the tick, so the clock sees the device's work.
A request's first token and each later one are stamped with the end of
the tick that returned it, and its times count from when it was due.
With ``trace`` the window also sums the cache's lengths on the device
before each tick (two small launches a tick), and ``trace_ticks`` more
ticks run under the profiler after it.

After the window closes and the engine is freed, a seeded sample of the
requests the window finished, the longest among them, is run through the
plain reference (``reference/decoder.py``) over its prompt and its served
tokens.  At each served token the gap is the reference's best logit less
the served token's; the configuration's ``check`` names the numbers
compared (the widest gap, the mean gap) and their limits.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from harness import modelcfg
from harness.costs import paged_decode_bytes, paged_decode_flops
from harness.trafficgen import Traffic, longest
from reference import decoder

#: Settings of the serve loop, the same in every mix; a mix may set any of
#: them to another value.  ``batch_slots`` and ``page_size`` are the
#: engine's; ``pool`` and ``arrival_pool`` size the traffic's pools of
#: lengths and gaps (``harness/trafficgen.py``), paired by
#: ``length_seed``; ``warmup_ticks`` run in set-up; a traced run traces
#: ``trace_ticks`` ticks of the device, then ``label_ticks`` with the host,
#: each after ``trace_warm_ticks``; the check compares
#: ``check_requests`` finished requests, at least ``check_min_tokens``
#: served tokens.
SETTINGS = {"batch_slots": 512, "page_size": 16, "pool": 4096,
            "arrival_pool": 8192, "length_seed": 0, "warmup_ticks": 40,
            "trace_warm_ticks": 2, "trace_ticks": 8, "label_ticks": 3,
            "check_requests": 12, "check_min_tokens": 200}
#: What the CPU rehearsal shrinks them to.
REHEARSAL = {"batch_slots": 8, "page_size": 4, "pool": 64,
             "arrival_pool": 256, "warmup_ticks": 2, "trace_warm_ticks": 1,
             "trace_ticks": 3, "label_ticks": 2, "check_requests": 8,
             "check_min_tokens": 8}


def settings(mix: Dict[str, Any], rehearse: bool = False) -> Dict[str, Any]:
    """The mix's keys over :data:`SETTINGS` (shrunk for a rehearsal),
    with the engine's ``max_len``: the longest request, rounded up to a
    page."""
    out = {**SETTINGS, **(REHEARSAL if rehearse else {}), **mix}
    page = int(out["page_size"])
    out["max_len"] = -(-longest(out) // page) * page
    return out


@dataclasses.dataclass
class _Req:
    prompt: List[int]
    max_new: int
    submit_t: float
    first_wave: bool
    n_out: int = 0
    last_t: Optional[float] = None
    out: Optional[List[int]] = None


class _Loop:
    """The arrivals, the engine and the window's records."""

    def __init__(self, engine, traffic: Traffic):
        self.engine = engine
        self.reqs: Dict[int, _Req] = {}
        self.in_window = False
        self.tokens = 0
        self.ttft: List[float] = []
        self.itl: List[float] = []
        self.queue_wait: List[float] = []
        self.tick_s: List[float] = []
        self.processed = 0
        self.finished: List[int] = []
        self.len_sum = None          # device sum of lengths, traced runs
        self.contexts: Optional[list] = None   # per traced tick
        #: Arrivals start after the first tick, whose lazy set-up (kernel
        #: loads, library handles) would otherwise pile them up.
        self.t_base: Optional[float] = None
        now = time.perf_counter()
        for prompt, max_new in traffic.first_wave():
            self._submit(prompt, max_new, now, first=True)
        self._arrivals = traffic.arrivals()
        self._next = next(self._arrivals)

    def _submit(self, prompt, max_new, due: float, first=False) -> None:
        rid = self.engine.submit(prompt, max_new=max_new)
        self.reqs[rid] = _Req(prompt, max_new, due, first)

    def _arrive(self, now: float) -> None:
        """Submit every request due by ``now``, stamped with its due time
        (a request due during a tick is submitted after it, and its wait
        counts)."""
        while self.t_base + self._next[0] <= now:
            due = self.t_base + self._next[0]
            self._submit(self._next[1], self._next[2], due)
            self._next = next(self._arrivals)

    def _tokens(self, rid: int, n: int, t: float) -> None:
        r = self.reqs[rid]
        new = n - r.n_out
        if new <= 0:
            return
        if self.in_window:
            self.tokens += new
            if r.n_out == 0:
                if not r.first_wave:
                    self.ttft.append(t - r.submit_t)
            else:
                self.itl.append(t - r.last_t)
            self.itl.extend([0.0] * (new - 1))
        r.n_out, r.last_t = n, t

    def tick(self) -> None:
        eng = self.engine
        if self.t_base is not None:
            self._arrive(time.perf_counter())
        prev = [s.request_id for s in eng.slots]
        lengths = None
        if self.len_sum is not None:
            self.len_sum += eng.kv.lengths.sum()
        if self.contexts is not None:
            lengths = eng.kv.lengths.clone()
        t0 = time.perf_counter()
        eng.step()
        t1 = time.perf_counter()
        active, done = [], []
        for i, s in enumerate(eng.slots):
            rid = s.request_id
            if prev[i] >= 0 and rid != prev[i]:
                done.append(prev[i])
                active.append(i)
            elif rid >= 0:
                active.append(i)
                if rid != prev[i]:
                    self._admitted(rid, t0)
                self._tokens(rid, len(s.out), t1)
        for rid in done:
            r = self.reqs[rid]
            r.out = eng.finished.pop(rid)
            self._tokens(rid, len(r.out), t1)
            if self.in_window:
                self.finished.append(rid)
        if self.t_base is None:
            self.t_base = t1
        if self.in_window:
            self.tick_s.append(t1 - t0)
            self.processed += len(active)
        if lengths is not None:
            self.contexts.append((lengths, active))

    def _admitted(self, rid: int, t: float) -> None:
        r = self.reqs[rid]
        if self.in_window and not r.first_wave:
            self.queue_wait.append(t - r.submit_t)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample(loop: _Loop, n: int, seed: int) -> List[int]:
    """``n`` requests the window finished: the longest (prompt and output),
    then others drawn from the seed."""
    done = list(loop.finished)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(loop.reqs[r].prompt)
                                       + loop.reqs[r].max_new, -r))
    rest = [r for r in done if r != longest]
    rng = np.random.default_rng([int(seed), 1])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def gap_numbers(g: List[float]) -> Dict[str, float]:
    """The numbers a check can compare: the widest gap and the mean gap
    over every checked token (infinity for none)."""
    if not g:
        return {"widest_logit_gap": float("inf"),
                "mean_logit_gap": float("inf")}
    return {"widest_logit_gap": max(g), "mean_logit_gap": sum(g) / len(g)}


def gaps(conf, w, reqs: List[_Req], quant: Optional[str] = None,
         flips: Optional[list] = None) -> List[float]:
    """For each served token of ``reqs``, the reference's best logit at its
    position less the served token's (a token outside the vocabulary:
    infinity).  With ``quant`` the served token is the one that the
    reference in that precision puts first, and ``flips`` (a list, a moe
    model) receives at each position whether some layer's router chose
    other experts in that precision than in float32."""
    vocab = int(conf["vocab_size"])
    seqs = [r.prompt + r.out[:-1] for r in reqs]
    wanted = [list(range(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.out)))
              for r in reqs]
    hi, lo = [], []
    ref = decoder.logits_at(conf, w, seqs, wanted, routes=hi)
    if quant is not None:
        low = decoder.logits_at(conf, w, seqs, wanted, quant=quant,
                                routes=lo)
        if flips is not None:
            flips.extend(b for a, c in zip(hi, lo)
                         for b in (a != c).flatten(1).any(1).tolist())
        chosen = [lo.argmax(-1).tolist() for lo in low]
    else:
        chosen = [r.out for r in reqs]
    out = []
    for lg, toks in zip(ref, chosen):
        best = lg.max(-1).values
        for j, t in enumerate(toks):
            out.append(float(best[j] - lg[j, t]) if 0 <= t < vocab
                       else float("inf"))
    return out


def _traced(loop: _Loop, cfg, conf, mix, dev) -> Dict[str, Any]:
    """``trace_ticks`` ticks with the device's operations traced, bracketed
    by a one-element fill at each end, then ``label_ticks`` more with the
    host's operations too, whose idle gaps are labelled by host op; each
    after ``trace_warm_ticks`` ticks that warm the profiler up."""
    from harness import trace as tr
    mark = torch.zeros((1,), device=dev)
    warm = int(mix["trace_warm_ticks"])
    loop.contexts = []
    summary = tr.device_window(tr.profile(
        loop.tick, warm, int(mix["trace_ticks"]), host=False,
        on_open=lambda: (mark.fill_(1.0), loop.contexts.clear()),
        on_close=lambda: mark.fill_(2.0)))
    contexts = [[ls[i] + 1 for i in active] for ls, active in
                ((lengths.tolist(), active) for lengths, active
                 in loop.contexts)]
    loop.contexts = None
    labelled = tr.profile(loop.tick, warm, int(mix["label_ticks"]),
                          host=True)
    if summary is None:            # no device (the CPU rehearsal)
        summary = {"window_s": 0.0, "busy_s": 0.0, "device_ops": [],
                   "device_seconds_by_name": {}}
    summary["idle_gaps"] = tr.idle_by_host_op(labelled)
    summary["contexts"] = contexts
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    D = cfg.resolved_head_dim
    es = torch.finfo(getattr(torch, conf["torch_dtype"])).bits // 8
    row = 4 * -(-int(mix["max_len"]) // int(mix["page_size"]))
    return {"trace": summary, "decode_attn": {
        "bytes": cfg.num_layers * sum(paged_decode_bytes(c, H, Hkv, D, es, row)
                                      for c in contexts),
        "flops": cfg.num_layers * sum(paged_decode_flops(c, H, D)
                                      for c in contexts)}}


def run(ctx) -> Dict[str, Any]:
    """One run of a serve cell; ``ctx`` carries ``conf``, ``mix``, ``seed``,
    ``seconds``, ``trace``, ``device``, ``t_start``, and may carry
    ``rehearse`` (the CPU rehearsal's settings), ``after_setup`` (called
    as the window opens) and ``control`` (also read the control's gaps
    and, for a moe model, the plain bfloat16 witness's)."""
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    conf, dev = ctx.conf, ctx.device
    mix = settings(ctx.mix, getattr(ctx, "rehearse", False))
    cfg = modelcfg.port_config(conf)
    w = modelcfg.make_weights(conf, ctx.seed, dev)
    params = modelcfg.program_params(w, conf)
    model = build_model(cfg, device=dev)
    engine = ServingEngine(model, params, batch_slots=int(mix["batch_slots"]),
                           max_len=int(mix["max_len"]),
                           page_size=int(mix["page_size"]), device=dev)
    loop = _Loop(engine, Traffic(mix, ctx.seed, cfg.vocab_size))
    for _ in range(int(mix["warmup_ticks"])):
        loop.tick()
    _sync(dev)
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if ctx.trace:
        loop.len_sum = torch.zeros((), dtype=torch.int64, device=dev)
    if getattr(ctx, "after_setup", None) is not None:
        ctx.after_setup()
    loop.in_window = True
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t_start
    while time.perf_counter() - t_open < ctx.seconds:
        loop.tick()
    window_s = time.perf_counter() - t_open
    loop.in_window = False
    ticks = len(loop.tick_s)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    total = (torch.cuda.get_device_properties(dev).total_memory
             if dev.type == "cuda" else None)
    rec: Dict[str, Any] = {
        "conf": conf, "setup_s": setup_s, "window_s": window_s,
        "ticks": ticks, "tick_s": loop.tick_s, "tokens": loop.tokens,
        "ttft_s": loop.ttft, "itl_s": loop.itl, "processed": loop.processed,
        "queue_wait_s": loop.queue_wait,
        "slots": int(mix["batch_slots"]), "max_len": int(mix["max_len"]),
        "matmul_params": modelcfg.matmul_params(conf),
        "peak_bytes": peak, "device_total_bytes": total, "trace": None}
    gc.unfreeze()

    if ctx.trace:
        len_sum = int(loop.len_sum)
        rec["len_sum"] = len_sum
        rec["context_sum"] = len_sum + loop.processed
        rec.update(_traced(loop, cfg, conf, mix, dev))

    # the check: the window's finished requests, the engine freed first
    finished = [loop.reqs[r] for r in loop.finished]
    vocab = int(conf["vocab_size"])
    bad = [r for r in finished if len(r.out) != r.max_new
           or any(not 0 <= t < vocab for t in r.out)]
    sample = [loop.reqs[r] for r in _sample(loop, int(mix["check_requests"]),
                                            ctx.seed)]
    del engine, model, params, loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    g = gaps(conf, w, sample) if sample else []
    numbers = gap_numbers(g)
    least = int(mix["check_min_tokens"])
    checks = {name: {"value": numbers[name], "limit": float(lim),
                     "ok": numbers[name] <= float(lim)}
              for name, lim in conf["check"].items()}
    checks["bad_requests"] = {"value": len(bad), "limit": 0, "ok": not bad}
    checks["checked_tokens_at_least"] = {"value": len(g), "limit": least,
                                         "ok": len(g) >= least}
    rec.update(attempted=len(finished), failed=len(bad), checks=checks,
               correct=all(c["ok"] for c in checks.values()),
               gap_numbers=numbers)
    if getattr(ctx, "control", False) and sample:
        rec["gaps"] = g
        rec["control_numbers"] = gap_numbers(gaps(conf, w, sample,
                                                  quant="fp8"))
        if conf.get("num_local_experts"):
            rec["route_flips"] = []
            rec["bf16_numbers"] = gap_numbers(gaps(
                conf, w, sample, quant="bf16", flips=rec["route_flips"]))
    del w
    return rec

