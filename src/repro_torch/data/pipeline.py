"""Data pipeline, ported so far: the on-device synthetic token stream.

:class:`SyntheticLM` draws every batch on the device from the counter-based
RNG of :mod:`repro_torch.core.libc`, with no host contact; its batches equal
the JAX package's bit for bit.  The host-RPC feed (``make_host_pipeline``)
is an immediate ordered call with several results, which the port's
``rpc_call`` (one result) does not make yet (ROADMAP queue 1, item 3.8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from repro_torch.core.libc import rand_uniform


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Deterministic on-device LM data: a period-8 pattern plus jitter, so
    that a model can reduce its loss."""
    vocab_size: int
    seq_len: int
    batch: int

    def batch_at(self, rng_state: torch.Tensor,
                 step: Union[int, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The batch of ``step`` (the RNG counter is set to it): returns
        (state', {"tokens": (batch, seq_len) int32}) on the state's
        device."""
        state = rng_state.clone()
        state[2] = step & 0xFFFFFFFF
        state, u = rand_uniform(state, (self.batch, self.seq_len))
        pos = torch.arange(self.seq_len, dtype=torch.int32,
                           device=state.device)
        base = (pos % 8) * (self.vocab_size // 8)
        noise = (u * 7).to(torch.int32)
        tokens = (base[None, :] + noise) % self.vocab_size
        return state, {"tokens": tokens.to(torch.int32)}
