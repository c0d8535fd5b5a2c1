"""Whole-program device execution (paper §3.1): the training loop's state
lives on the card and the host only sees it through hooks.

The JAX package compiles the whole multi-step loop into one program
(``lax.while_loop``) whose only host contact is its RPC hooks.  The port
runs the loop in Python over ``step_fn``, with every tensor of the state on
the card: PyTorch enqueues each step's kernels and returns, so the host
runs ahead of the device.  An immediate hook dispatches through
:func:`~repro_torch.core.rpc.rpc_call`, as the JAX ``_fire`` does, and only
on its firing steps: on the card its payload rides the RPC channel in
stream order (the host thread is not held), on the CPU the landing pad is
called directly.  Steps where no hook fires make no host contact at all.
Capturing the step in a CUDA graph is later work (ROADMAP queue 1, item
2.2); the channel's device-side sequence numbers are what make a hook
capturable.

Hook hygiene, as in JAX: a hook without a ``name`` gets a name derived
from its host function and ``every`` (a content hash, so reruns bind the
same landing pads), and its registry entries are retired when
``device_run`` returns, after :func:`~repro_torch.core.rpc.effects_barrier`
(so repeated runs leave the registry at a constant size).

Not ported yet: batched and returning hooks (``batched=``, ``returns=``,
``consume=``) and the run queue's options ride the batched RPC queue
(ROADMAP queue 1, item 3.2); ``mesh=`` is item 5.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.rpc import (_QUEUE, REGISTRY, ShapeDtype,
                                  effects_barrier, rpc_call, stable_hook_id)
from repro_torch.tree import leaves

_MESH = "ROADMAP queue 1, item 5 (scale-out)"
_I32 = ShapeDtype((), torch.int32)


@dataclasses.dataclass(frozen=True)
class HostHook:
    """A periodic host escape from the device main loop.

    every:    fire after step ``s`` (counted from 1) when ``s % every == 0``
    extract:  (step, state) -> tree of tensors shipped to the host
    host_fn:  host callback receiving (step, *leaves) with each leaf a numpy
              array (bf16 leaves arrive as float32); its return value is
              ignored.  On a card it runs on the RPC channel's thread while
              the stream waits: numpy only, no CUDA calls
    name:     RPC name for the pad table and stats; by default derived
              from host_fn's module, qualname and first line and ``every``
    batched, returns, consume: options of the batched RPC queue, not
              ported yet; ``device_run`` refuses a hook that sets them
    """
    every: int
    extract: Callable[[int, Any], Any]
    host_fn: Callable
    name: Optional[str] = None
    batched: bool = False
    returns: Any = None
    consume: Optional[Callable] = None


def _hook_name(hook: HostHook) -> str:
    """``hook.<fn>.<hash31 hex>``, the JAX package's auto-name: stable
    across processes, so reruns bind the same landing pads."""
    if hook.name:
        return hook.name
    fn_name = getattr(hook.host_fn, "__name__", "fn")
    code = getattr(hook.host_fn, "__code__", None)
    if code is None:
        return f"hook.{fn_name}.{id(hook):x}"
    mod = getattr(hook.host_fn, "__module__", "") or ""
    qual = getattr(hook.host_fn, "__qualname__", fn_name)
    key = f"{mod}:{qual}:{code.co_firstlineno}:{int(hook.every)}"
    return f"hook.{fn_name}.{stable_hook_id(key):08x}"


def _name_hooks(hooks: Sequence[HostHook]) -> List[Tuple[HostHook, str]]:
    """Name every hook; same-named duplicates get their position's
    suffix (``.2``, ``.3``, ...) in program order."""
    named, seen = [], {}
    for h in hooks:
        base = _hook_name(h)
        occ = seen.get(base, 0)
        seen[base] = occ + 1
        named.append((h, base if occ == 0 else f"{base}.{occ + 1}"))
    return named


def _register_hook(hook: HostHook, hname: str) -> None:
    def adapter(step, *payload):
        hook.host_fn(int(step), *payload)
        return np.int32(0)

    adapter.__name__ = hname
    REGISTRY.register(hname, adapter)


def _fire(hook: HostHook, hname: str, step: int, state: Any) -> None:
    """Immediate hook: one RPC through its landing pad, only on firing
    steps (the JAX ``_fire`` puts the call in the taken branch of a
    ``lax.cond`` for the same reason: silent steps stay on the device)."""
    if step % hook.every == 0 and step > 0:
        rpc_call(hname, step, *leaves(hook.extract(step, state)),
                 result_shape=_I32)


def device_run(step_fn: Callable[[int, Any], Any], state: Any,
               n_steps: int, *, hooks: Sequence[HostHook] = (),
               mesh=None, **queue_options) -> Any:
    """Run ``state = step_fn(step, state)`` for ``step`` in 0..n_steps-1,
    firing each hook after its step as ``step + 1``.  Returns the final
    state; its tensors may still be in flight on the card (synchronise
    before timing), and so may the hooks' host calls, unless an auto-named
    hook made ``device_run`` wait for them before retiring it.

    ``mesh=`` and the JAX version's queue options (``queue_capacity``,
    ``queue_async``, ``thread_queue``, ...) raise ``NotImplementedError``,
    as do hooks with ``batched``, ``returns`` or ``consume``."""
    if mesh is not None:
        raise NotImplementedError(f"device_run(mesh=) needs {_MESH}")
    if queue_options:
        raise NotImplementedError(
            f"device_run options {sorted(queue_options)} need {_QUEUE}")
    for h in hooks:
        if h.batched or h.returns is not None or h.consume is not None:
            raise NotImplementedError(
                f"batched / returning hooks need {_QUEUE}")
        if h.every < 1:
            raise ValueError(f"hook every={h.every} must be >= 1")
    named = _name_hooks(hooks)
    for h, hname in named:
        _register_hook(h, hname)
    try:
        for step in range(n_steps):
            state = step_fn(step, state)
            for h, hname in named:
                _fire(h, hname, step + 1, state)
        return state
    finally:
        auto = [hname for h, hname in named if h.name is None]
        if auto:
            effects_barrier()
            for hname in auto:
                REGISTRY.unregister(hname)
