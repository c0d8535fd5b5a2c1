"""Data pipeline: the on-device synthetic token stream and the host feed.

:class:`SyntheticLM` draws every batch on the device from the counter-based
RNG of :mod:`repro_torch.core.libc`, with no host contact; its batches equal
the JAX package's bit for bit.  :func:`make_host_pipeline` is the paper's
``fscanf``-by-RPC for batches: device code fetches each batch from a host
iterator with one immediate ordered RPC whose result is a tuple of arrays
(on a card through the RPC channel, with no host wait), and a prefetch
thread keeps batches staged so the callee returns at once.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
from typing import Callable, Dict, Iterator, Tuple, Union

import numpy as np
import torch

from repro_torch.core.libc import rand_uniform
from repro_torch.core.rpc import REGISTRY, ShapeDtype, _torch_dtype, rpc_call


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


# ---------------------------------------------------------------------------
# Host-RPC feed
# ---------------------------------------------------------------------------

def _np_dtype(dtype) -> np.dtype:
    """A spec's dtype (torch or numpy) as the numpy dtype a batch is cast
    to on the host (bf16 travels as float32)."""
    t = _torch_dtype(dtype)
    if t == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=t).numpy().dtype


def _specs(specs: Dict[str, object]) -> Dict[str, ShapeDtype]:
    return {k: ShapeDtype(tuple(s.shape), _torch_dtype(s.dtype))
            for k, s in specs.items()}


def host_feed_batch(it: Iterator[Dict[str, np.ndarray]],
                    specs: Dict[str, object]):
    """The host callback that serves ``next(it)`` (shape-checked), and the
    keys in the order of its results (sorted)."""
    keys = sorted(specs)
    specs = _specs(specs)

    def host(_step) -> Tuple[np.ndarray, ...]:
        b = next(it)
        out = []
        for k in keys:
            a = np.asarray(b[k])
            want = specs[k]
            assert a.shape == tuple(want.shape), (k, a.shape, want.shape)
            out.append(a.astype(_np_dtype(want.dtype)))
        return tuple(out)

    return host, keys


_PIPELINE_IDS = itertools.count()


def make_host_pipeline(it: Iterator[Dict[str, np.ndarray]],
                       specs: Dict[str, object], *, prefetch: int = 2,
                       device="cuda") -> Callable:
    """Returns ``fetch(step) -> batch`` (a dict of tensors of ``specs``'
    shapes and dtypes on ``device``, the card unless the caller asks for
    the CPU), callable from device code.

    A background thread keeps ``prefetch`` batches staged on the host, so
    the ordered RPC returns at once (the device never waits on storage,
    only on the staging queue).  ``fetch.stop()`` ends the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            for b in it:
                if stop.is_set():
                    return
                q.put(b)
        finally:
            q.put(None)

    threading.Thread(target=producer, daemon=True,
                     name="host-pipeline-prefetch").start()
    keys = sorted(specs)
    specs = _specs(specs)

    def host(_step):
        b = q.get()
        if b is None:
            raise StopIteration("host pipeline exhausted")
        return tuple(np.asarray(b[k]).astype(_np_dtype(specs[k].dtype))
                     for k in keys)

    name = f"data.host_pipeline.{next(_PIPELINE_IDS)}"
    REGISTRY.register(name, host)
    shapes = tuple(specs[k] for k in keys)

    def fetch(step):
        out, _ = rpc_call(name, step, result_shape=shapes, device=device)
        return dict(zip(keys, out))

    fetch.stop = stop.set
    fetch.rpc_name = name
    return fetch
