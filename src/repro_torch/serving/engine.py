"""Continuous-batching serving engine with paged KV (dense decoder LMs).

The port of ``repro/serving/engine.py`` without its mesh and artifact
export (ROADMAP item 5) and its moe and vlm families (item 4).  A fixed
grid of request slots decodes in lock-step, one batched decode step per
tick; finished slots are released through the balanced allocator's chunk
reset and refilled from the request queue.  The engine has no prefill:
prompt tokens go through the decode step one per tick.  Each tick copies
one (B,) argmax from the device to the host.

A ``spill_sink`` receives each retiring request's page ids through an
async :class:`~repro_torch.core.rpc.RpcQueue` on the engine's device (on
a card: one ``rpc_enqueue`` a request, and ``rpc_async_post`` and
``rpc_async_collect`` a flush), acknowledged through its reply arena.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import rpc as rpc_mod
from repro_torch.core.rpc import REGISTRY, RpcQueue, ShapeDtype
from repro_torch.models import common
from repro_torch.models.attention import _project_qkv, attn_out
from repro_torch.models.common import rmsnorm
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.model_zoo import Model, resolve_device
from repro_torch.models.transformer import _lm_head
from repro_torch.serving import kvcache
from repro_torch.serving.kvcache import PagedKV

#: Batched-transport callee of retiring requests' page spills; the default
#: binding does nothing, so an enqueue always resolves: each engine passes
#: its own sink as the flush's handler.
_SPILL_RPC = "kvcache.spill"
REGISTRY.register(_SPILL_RPC, lambda rid, n_tokens, pages: None,
                  idempotent=True)

#: Occupancy (ring, arena or replies, the fullest) at which
#: ``_deliver_spills`` flushes before enqueueing more records.
_SPILL_PRESSURE = 0.75
_I32 = ShapeDtype((), torch.int32)


def paged_decode_step(params, kv: PagedKV, tokens: torch.Tensor,
                      active: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, PagedKV]:
    """tokens: (B,) -> (logits (B, V) fp32, kv).  ``kv`` is updated in
    place.  The JAX version's ``_write_layer`` (a scan-safe copy of
    ``write_token_kv``) is ``write_token_kv`` itself here: the layer index
    is a Python int, and the write targets, the same in every layer, are
    computed once per tick."""
    kv = kvcache.ensure_pages(kv, active)
    slots = kvcache.token_slots(kv, active)
    x = common.embed_tokens(params["embed"], tokens[:, None], cfg)
    angles = common.rope_angles(kv.lengths[:, None], cfg.resolved_head_dim,
                                cfg.rope_theta)
    for li, layer in enumerate(params["layers"]):
        h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(layer["attn"], h, cfg, angles)
        kv = kvcache.write_token_kv(kv, li, k[:, 0], v[:, 0], slots)
        a = kvcache.paged_attend(kv, li, q[:, 0].contiguous())
        x = x + attn_out(layer["attn"], a, cfg)[:, None]
        h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
        x = x + mlp_apply(layer["mlp"], h)
    kv = kvcache.advance(kv, active)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = common.lm_logits(x, _lm_head(params, cfg), cfg)[:, 0]
    return logits, kv


@dataclasses.dataclass
class _Slot:
    request_id: int = -1
    prompt: List[int] = dataclasses.field(default_factory=list)
    fed: int = 0
    out: List[int] = dataclasses.field(default_factory=list)
    max_new: int = 0


class ServingEngine:
    """Host-side orchestration of the batched decode step."""

    def __init__(self, model: Model, params, *, batch_slots: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 eos_id: Optional[int] = None,
                 spill_sink: Optional[Any] = None,
                 spill_timeout: Optional[float] = None,
                 spill_retries: int = 1, device="cuda"):
        """``spill_sink(request_id, n_tokens, pages)``, a host callback,
        receives every retiring request's page ids (a 1-D int32 numpy
        array) before its slot is released: the requests retiring in a
        tick travel in one flush of the engine's async queue, each acked
        through the reply arena with the sink's return value (the page
        count when it returns None).  Acks collect in ``spill_acks``
        (:meth:`drain_spill_acks` empties it).  ``spill_timeout`` bounds
        each sink call; a record whose sink raises or times out is
        redriven by the transport for ``spill_retries`` more drains, and
        one that still fails (or whose reply is lost) acks None and its
        request joins ``recompute_on_readmit``."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"the engine serves the dense family; {self.cfg.family!r} is "
                "not ported yet")
        self.params = params
        self.B = batch_slots
        self.kv = kvcache.paged_cache_init(
            self.cfg, batch_slots, max_len, page_size=page_size,
            device=self.device)
        self.eos_id = eos_id
        self.spill_sink = spill_sink
        self.spill_q: Optional[RpcQueue] = None
        self.spill_acks: Dict[int, Optional[int]] = {}
        self.spill_retries = int(spill_retries)
        self.recompute_on_readmit: set = set()
        if spill_sink is not None:
            maxp = (max_len + page_size - 1) // page_size
            self.spill_q = RpcQueue.create(
                capacity=max(2 * batch_slots, 8), width=3,
                payload_capacity=max(batch_slots * maxp, 8),
                reply_capacity=max(2 * batch_slots, 8),
                timeout=spill_timeout, mode="async",
                carry_budget=self.spill_retries, device=self.device)
        self.slots: List[_Slot] = [_Slot() for _ in range(batch_slots)]
        self.queue: List[Tuple[int, List[int], int]] = []
        self.finished: Dict[int, List[int]] = {}
        self._next_id = 0
        #: fp32 logits (B, V) of the last tick, on the device.
        self.last_logits: Optional[torch.Tensor] = None

    # -- public API --------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 16) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, list(prompt), max_new))
        return rid

    def step(self) -> None:
        """One engine tick: refill slots, one batched decode step, harvest."""
        for s in self.slots:
            if s.request_id < 0 and self.queue:
                rid, prompt, max_new = self.queue.pop(0)
                s.request_id, s.prompt, s.fed, s.out, s.max_new = \
                    rid, prompt, 0, [], max_new

        tokens, active = [], []
        for s in self.slots:
            if s.request_id < 0:
                tokens.append(0)
                active.append(False)
            elif s.fed < len(s.prompt):
                tokens.append(s.prompt[s.fed])
                active.append(True)
            else:
                tokens.append(s.out[-1] if s.out else s.prompt[-1])
                active.append(True)

        tok = torch.tensor(tokens, dtype=torch.int64, device=self.device)
        act = torch.tensor(active, dtype=torch.bool, device=self.device)
        logits, self.kv = paged_decode_step(self.params, self.kv, tok, act,
                                            self.cfg)
        self.last_logits = logits
        nxt = torch.argmax(logits, dim=-1).tolist()    # the tick's one copy

        done_slots, done_rids = [], []
        for i, s in enumerate(self.slots):
            if s.request_id < 0:
                continue
            if s.fed < len(s.prompt):
                s.fed += 1
                if s.fed < len(s.prompt):
                    continue
            t = nxt[i]
            s.out.append(t)
            if len(s.out) >= s.max_new or \
                    (self.eos_id is not None and t == self.eos_id):
                self.finished[s.request_id] = s.out
                done_slots.append(i)
                done_rids.append(s.request_id)
                self.slots[i] = _Slot()
        if done_slots:
            if self.spill_q is not None:
                # every retiring slot's page ids ride the payload arena
                # before the slot is released; its reply acks the spill
                self._deliver_spills(
                    [(rid, self.kv.lengths[i], kvcache.live_pages(self.kv, i))
                     for i, rid in zip(done_slots, done_rids)])
            # every request retired this tick releases in one bulk reset
            mask = torch.zeros((self.B,), dtype=torch.bool)
            mask[done_slots] = True
            self.kv = kvcache.release_slots(self.kv, mask.to(self.device))

    def _deliver_spills(self, records) -> None:
        """Deliver ``(rid, n_tokens, pages)`` records: enqueue them (a
        flush first whenever ``spill_q.pressure()`` reaches
        :data:`_SPILL_PRESSURE`, which reads the device), then a submit
        and a collect flush a chunk.  A record whose sink failed reads
        ``PENDING`` (the transport carries it): the engine grants the
        carried records the rest of their budget, joins the drains and
        reads their outcomes; a record that still failed, or whose reply
        was lost, goes to :meth:`_spill_failed`."""
        sink = self.spill_sink

        def handler(rid, n_tokens, pages):
            out = sink(rid, n_tokens, pages)
            return np.int32(len(pages)) if out is None else out

        handlers = {_SPILL_RPC: handler}
        pending: List[Tuple[Any, Any]] = []
        i = 0
        while i < len(records):
            chunk = []
            while i < len(records):
                rid, n_tok, pages = records[i]
                _, t = self.spill_q.enqueue_ticketed(
                    _SPILL_RPC, rid, n_tok, pages, returns=_I32)
                chunk.append((records[i], t))
                i += 1
                if float(self.spill_q.pressure()) >= _SPILL_PRESSURE:
                    break
            self.spill_q.flush(handlers=handlers)      # submit
            self.spill_q.flush(handlers=handlers)      # collect
            tix = [t for _, t in chunk]
            statuses = self.spill_q.statuses_host(tix)
            acks = self.spill_q.results_host(tix)
            for (rec, t), st, (val, ok) in zip(chunk, statuses, acks):
                if st == rpc_mod.STATUS_OK and ok:
                    self.spill_acks[rec[0]] = int(val)
                elif st == rpc_mod.STATUS_PENDING:
                    pending.append((rec, t))
                else:
                    self._spill_failed(rec)
        if pending:
            # the collect flush submitted one redrive epoch already
            for _ in range(max(0, self.spill_retries - 1)):
                self.spill_q.flush(handlers=handlers)
            self.spill_q.join()
            tix = [t for _, t in pending]
            statuses = self.spill_q.statuses_host(tix)
            acks = self.spill_q.results_host(tix)
            for (rec, _), st, (val, ok) in zip(pending, statuses, acks):
                if st == rpc_mod.STATUS_OK and ok:
                    self.spill_acks[rec[0]] = int(val)
                else:
                    self._spill_failed(rec)

    def _spill_failed(self, rec) -> None:
        """The pages were never provably spilled: a None ack (not 0) and
        the request must recompute from its prompt if readmitted."""
        self.spill_acks[rec[0]] = None
        self.recompute_on_readmit.add(rec[0])

    def drain_spill_acks(self) -> Dict[int, Optional[int]]:
        """Collect and clear the spill acks (request id -> ack, or None)."""
        acks, self.spill_acks = self.spill_acks, {}
        return acks

    def run_until_drained(self, max_ticks: int = 10_000
                          ) -> Dict[int, List[int]]:
        ticks = 0
        while (self.queue or any(s.request_id >= 0 for s in self.slots)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return dict(self.finished)
