"""Whole-program device execution (paper §3.1): the training loop's state
lives on the card and the host only sees it through hooks.

The JAX package compiles the whole multi-step loop into one program
(``lax.while_loop``) whose only host contact is its RPC hooks.  The port
runs the loop in Python over ``step_fn``, with every tensor of the state on
the card: PyTorch enqueues each step's kernels and returns, so the host
runs ahead of the device and a step where no hook fires makes no host sync
(no ``.item()``, no ``.cpu()``).  A hook that fires copies its payload to
the host, which waits for the device there, exactly as the JAX
``io_callback`` does.  Capturing the step in a CUDA graph is later work.

Ported so far: immediate hooks.  Batched hooks (``batched=``, ``returns=``,
``consume=``), the run queue's options and ``mesh=`` ride the RPC transport
(``core/rpc.py``), which is not ported yet (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.tree import leaves

_TRANSPORT = ("ROADMAP queue 1, item 3: the RPC transport, core/rpc.py")


@dataclasses.dataclass(frozen=True)
class HostHook:
    """A periodic host escape from the device main loop.

    every:    fire after step ``s`` (counted from 1) when ``s % every == 0``
    extract:  (step, state) -> tree of tensors shipped to the host
    host_fn:  host callback receiving (step, *leaves) with each leaf a numpy
              array (bf16 leaves arrive as float32); its return value is
              ignored
    batched, returns, consume: options of the RPC transport, which is not
              ported yet; ``device_run`` refuses a hook that sets them.
              The JAX hook's ``name`` and ``idempotent`` (RPC naming and
              retry) come with the transport too.
    """
    every: int
    extract: Callable[[int, Any], Any]
    host_fn: Callable
    batched: bool = False
    returns: Any = None
    consume: Optional[Callable] = None


def _to_host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _fire(hook: HostHook, step: int, state: Any) -> None:
    """Immediate hook: ship the payload and call ``host_fn``, only on firing
    steps (the JAX ``_fire`` puts the callback in the taken branch of a
    ``lax.cond`` for the same reason: silent steps stay on the device)."""
    if step % hook.every == 0 and step > 0:
        payload = hook.extract(step, state)
        hook.host_fn(step, *[_to_host(x) for x in leaves(payload)])


def device_run(step_fn: Callable[[int, Any], Any], state: Any,
               n_steps: int, *, hooks: Sequence[HostHook] = (),
               mesh=None, **queue_options) -> Any:
    """Run ``state = step_fn(step, state)`` for ``step`` in 0..n_steps-1,
    firing each hook after its step as ``step + 1``.  Returns the final
    state; its tensors may still be in flight on the card (synchronise
    before timing).

    ``mesh=`` and the JAX version's queue options (``queue_capacity``,
    ``queue_async``, ``thread_queue``, ...) raise ``NotImplementedError``,
    as do hooks with ``batched``, ``returns`` or ``consume``: they ride the
    RPC transport, not ported yet."""
    if mesh is not None:
        raise NotImplementedError(f"device_run(mesh=) needs {_TRANSPORT}")
    if queue_options:
        raise NotImplementedError(
            f"device_run options {sorted(queue_options)} need {_TRANSPORT}")
    for h in hooks:
        if h.batched or h.returns is not None or h.consume is not None:
            raise NotImplementedError(
                f"batched / returning hooks need {_TRANSPORT}")
        if h.every < 1:
            raise ValueError(f"hook every={h.every} must be >= 1")
    for step in range(n_steps):
        state = step_fn(step, state)
        for h in hooks:
            _fire(h, step + 1, state)
    return state
