"""Continuous-batching serving engine with paged KV (dense decoder LMs).

The port of ``repro/serving/engine.py`` without its spill sink, mesh and
artifact export.  A fixed grid of request slots decodes in lock-step, one
batched decode step per tick; finished slots are released through the
balanced allocator's chunk reset and refilled from the request queue.  The
engine has no prefill: prompt tokens go through the decode step one per
tick.  Each tick copies one (B,) argmax from the device to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import _project_qkv, attn_out
from repro_torch.models.common import rmsnorm
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.model_zoo import Model, resolve_device
from repro_torch.models.transformer import _lm_head
from repro_torch.serving import kvcache
from repro_torch.serving.kvcache import PagedKV


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
                 eos_id: Optional[int] = None, device="cuda"):
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

        done_slots = []
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
                self.slots[i] = _Slot()
        if done_slots:
            # every request retired this tick releases in one bulk reset
            mask = torch.zeros((self.B,), dtype=torch.bool)
            mask[done_slots] = True
            self.kv = kvcache.release_slots(self.kv, mask.to(self.device))

    def run_until_drained(self, max_ticks: int = 10_000
                          ) -> Dict[int, List[int]]:
        ticks = 0
        while (self.queue or any(s.request_id >= 0 for s in self.slots)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return dict(self.finished)
