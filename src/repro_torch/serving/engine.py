"""Continuous-batching serving engine with paged KV (the dense, moe and
vlm decoder LMs; a vlm request is a token prompt).

The port of ``repro/serving/engine.py``.  A fixed grid of request slots
decodes in lock-step, one batched decode step per tick (``self._step``);
finished slots are released through the balanced allocator's chunk reset
and refilled from the request queue. The engine has no prefill: prompt
tokens go through the decode step one per tick.  Each tick copies one
(B,) argmax from the device to the host. ``mesh=`` (a ``DeviceMesh`` or
a shard count) shards the page heap, one shard a block of slots, stacked
on the engine's device (``serving/kvcache.py``); it needs no process
group.

The durable artifact (JAX's ``export_artifact``/``from_artifact``):
:meth:`ServingEngine.export_artifact` writes the decode step as a
``torch.export`` program (``serve_step.pt2``: the kernels are
``torch.ops.repro_torch`` custom ops, the weights are inputs), the RPC
manifest, a step-0 checkpoint of the weights in JAX's files and stacked
layout, and ``engine.json``; :meth:`ServingEngine.from_artifact` serves
it in a fresh process without building a model or tracing anything.

A ``spill_sink`` receives each retiring request's page ids through an
async :class:`~repro_torch.core.rpc.RpcQueue` on the engine's device (on
a card: one ``rpc_enqueue`` a request, and ``rpc_async_post`` and
``rpc_async_collect`` a flush), acknowledged through its reply arena.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import from_jax_layout, to_jax_layout
from repro_torch.core import rpc as rpc_mod
from repro_torch.core.rpc import REGISTRY, RpcQueue, ShapeDtype
from repro_torch.models import common
from repro_torch.models.attention import _project_qkv, attn_out
from repro_torch.models.common import rmsnorm
from repro_torch.models.model_zoo import Model, resolve_device
from repro_torch.models.transformer import _decode_angles, _ffn, _lm_head
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
#: The families the engine serves: decoder-only attention LMs.
ENGINE_FAMILIES = ("dense", "moe", "vlm")


def check_servable(cfg: ModelConfig) -> None:
    """Raise unless the engine serves ``cfg``'s family (JAX's engine
    asserts the same families)."""
    if cfg.family not in ENGINE_FAMILIES:
        raise NotImplementedError(
            f"the engine serves the dense, moe and vlm families, not "
            f"{cfg.family!r}: the ssm, hybrid and encdec families are served "
            "through Model.prefill and Model.decode_step, as in JAX")


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
    angles = _decode_angles(cfg, kv.lengths)
    for li, layer in enumerate(params["layers"]):
        h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(layer["attn"], h, cfg, angles)
        kv = kvcache.write_token_kv(kv, li, k[:, 0], v[:, 0], slots)
        a = kvcache.paged_attend(kv, li, q[:, 0].contiguous())
        x = x + attn_out(layer["attn"], a, cfg)[:, None]
        h = rmsnorm(x, layer["ln2"], cfg.norm_eps)
        x = x + _ffn(layer, h, cfg)[0]        # the aux is not needed here
    kv = kvcache.advance(kv, active)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = common.lm_logits(x, _lm_head(params, cfg), cfg)[:, 0]
    return logits, kv


class ServeStep(torch.nn.Module):
    """:func:`paged_decode_step` of ``cfg`` over ``(values, kv, tokens,
    active)``: the program :meth:`ServingEngine.export_artifact` exports.
    It holds no weights; they are its first input."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, values, kv: PagedKV, tokens: torch.Tensor,
                active: torch.Tensor) -> Tuple[torch.Tensor, PagedKV]:
        return paged_decode_step(values, kv, tokens, active, self.cfg)


#: The artifact's files (JAX's, with ``serve_step.pt2`` for its
#: ``serve_step.bin``); the step-0 checkpoint's files sit beside them.
STEP_FILE, MANIFEST_FILE, META_FILE = ("serve_step.pt2", "manifest.json",
                                       "engine.json")


def _exported_inputs(program) -> Tuple[Any, torch.device]:
    """The exported step's ``(values, kv, tokens, active)`` as
    :class:`~repro_torch.core.rpc.ShapeDtype` stand-ins, and the device it
    was exported on."""
    vals = {n.name: n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder"}
    user = [vals[name] for name in program.graph_signature.user_inputs]
    flat = [ShapeDtype(tuple(v.shape), v.dtype) for v in user]
    args, _ = pytree.tree_unflatten(flat, program.call_spec.in_spec)
    return args, user[0].device


def _same_device(a: torch.device, b: torch.device) -> bool:
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


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
                 spill_retries: int = 1, device="cuda", mesh=None):
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
        request joins ``recompute_on_readmit``.  ``mesh`` (a
        ``DeviceMesh`` or an int shard count) shards the KV page heap: each
        shard serves its block of slots, so page allocation and release
        never funnel through one allocator state."""
        device = resolve_device(device)
        if model.device != device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{device}")
        check_servable(model.cfg)
        self._setup(model.cfg, batch_slots, max_len, page_size, eos_id,
                    spill_sink, spill_timeout, spill_retries, device, mesh)
        self.model = model
        self.params = params
        self._values = params
        self._step = ServeStep(self.cfg)
        self._step_source = "live"

    def _setup(self, cfg, batch_slots, max_len, page_size, eos_id,
               spill_sink, spill_timeout, spill_retries, device,
               mesh) -> None:
        """Everything but the step: the KV cache, the spill queue, the
        slots and the geometry ``export_artifact`` writes."""
        self.device = device
        self.cfg = cfg
        self.B = batch_slots
        self.kv = kvcache.paged_cache_init(
            cfg, batch_slots, max_len, page_size=page_size, device=device,
            mesh=mesh)
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
                carry_budget=self.spill_retries, device=device)
        self.slots: List[_Slot] = [_Slot() for _ in range(batch_slots)]
        self.queue: List[Tuple[int, List[int], int]] = []
        self.finished: Dict[int, List[int]] = {}
        self._next_id = 0
        #: fp32 logits (B, V) of the last tick, on the device.
        self.last_logits: Optional[torch.Tensor] = None
        self._geom = {"batch_slots": int(batch_slots),
                      "max_len": int(max_len), "page_size": int(page_size),
                      "eos_id": eos_id}

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
        logits, self.kv = self._step(self._values, self.kv, tok, act)
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

    # -- durable artifact: torch.export of the step, cold start -----------------
    def export_artifact(self, directory: str,
                        extra_meta: Optional[dict] = None) -> str:
        """Export this engine as a durable cold-start artifact.

        Writes into ``directory``:

        * ``serve_step.pt2``: ``torch.export`` of :class:`ServeStep` over
          ``(values, kv, tokens, active)``, the weights an input (its
          example inputs are not saved, so the weights are written once);
        * ``manifest.json``: the :class:`~repro_torch.core.rpc.
          RpcManifest` of every pad, callee id, format string and queue
          geometry this process bound (the engine's spill queue included);
        * a step-0 checkpoint of the weights in JAX's files and stacked
          layout, whose manifest embeds the same transport section;
        * ``engine.json``: the geometry (batch slots, max_len, page size,
          eos id) and ``extra_meta``, as JAX's ``json.dump`` writes them.

        :meth:`from_artifact` serves all four in a fresh process.  The
        program records the device it was traced on (``torch.arange``'s
        and ``.to``'s ``device=``), so it serves there.  The seconds of
        each part land in ``self.export_seconds`` (``export``, ``save``,
        ``checkpoint``)."""
        os.makedirs(directory, exist_ok=True)
        t0 = time.perf_counter()
        tokens = torch.zeros((self.B,), dtype=torch.int64, device=self.device)
        active = torch.zeros((self.B,), dtype=torch.bool, device=self.device)
        program = torch.export.export(
            ServeStep(self.cfg), (self._values, self.kv, tokens, active),
            strict=False)
        program.example_inputs = None
        t1 = time.perf_counter()
        torch.export.save(program, os.path.join(directory, STEP_FILE))
        t2 = time.perf_counter()
        queues = [self.spill_q] if self.spill_q is not None else []
        manifest = rpc_mod.export_manifest(queues=queues)
        manifest.save(os.path.join(directory, MANIFEST_FILE))
        save_checkpoint(directory, 0, {"values": to_jax_layout(self._values)},
                        transport=manifest)
        meta = dict(self._geom)
        meta.update(extra_meta or {})
        with open(os.path.join(directory, META_FILE), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
            f.write("\n")
        self.export_seconds = {"export": t1 - t0, "save": t2 - t1,
                               "checkpoint": time.perf_counter() - t2}
        return directory

    @classmethod
    def from_artifact(cls, directory: str, cfg: ModelConfig, *,
                      spill_sink: Optional[Any] = None,
                      spill_timeout: Optional[float] = None,
                      spill_retries: int = 1, device="cuda",
                      mesh=None) -> "ServingEngine":
        """Cold-start an engine from :meth:`export_artifact`'s output in a
        fresh process: adopt the manifest (so every id the step and the
        spill queue use resolves; as in JAX, every callee it names must be
        registered here, so export from a process that bound no other
        landing pads), load ``serve_step.pt2`` (the custom ops
        are registered by this module's imports), and restore the weights
        into the exported input structure.  No model is built and nothing
        is traced (``engine.model is None``, ``engine._step_source ==
        "artifact"``).  ``cfg`` must be the config the exporting process
        served (the KV cache is made from it); ``device`` must be the
        device the step was exported on, and ``mesh`` the exporting
        engine's (the cache's page heap is an input of the step)."""
        with open(os.path.join(directory, META_FILE)) as f:
            meta = json.load(f)
        rpc_mod.adopt_manifest(rpc_mod.RpcManifest.load(
            os.path.join(directory, MANIFEST_FILE)))
        program = torch.export.load(os.path.join(directory, STEP_FILE))
        (values_like, _, _, _), traced_on = _exported_inputs(program)
        device = resolve_device(device)
        if not _same_device(device, traced_on):
            raise ValueError(f"the artifact's step was exported on "
                             f"{traced_on}, not {device}: it serves only "
                             "there")
        check_servable(cfg)
        self = cls.__new__(cls)
        self._setup(cfg, int(meta["batch_slots"]), int(meta["max_len"]),
                    int(meta["page_size"]), meta.get("eos_id"), spill_sink,
                    spill_timeout, spill_retries, device, mesh)
        _, restored = restore_checkpoint(
            directory, {"values": to_jax_layout(values_like)}, step=0,
            device=device)
        self.model = None
        self.params = None
        self._values = from_jax_layout(restored["values"])
        self._step = program.module()
        self._step_source = "artifact"
        return self

