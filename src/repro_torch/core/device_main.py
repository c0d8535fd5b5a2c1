"""Whole-program device execution (paper §3.1): the training loop's state
lives on the card and the host only sees it through hooks.

The JAX package compiles the whole multi-step loop into one program
(``lax.while_loop``) whose only host contact is its RPC hooks.  The port
runs the loop in Python over ``step_fn``, with every tensor of the state on
the card: PyTorch enqueues each step's kernels and returns, so the host
runs ahead of the device.  A hook's firing test is a Python bool, so a
silent step does nothing at all:

* an **immediate hook** dispatches through
  :func:`~repro_torch.core.rpc.rpc_call` on its firing steps, as the JAX
  ``_fire`` does: on the card its payload rides the RPC channel in stream
  order (the host thread is not held), on the CPU the landing pad is
  called directly;
* a **batched hook** (``batched=True``) enqueues a record on the run's
  :class:`~repro_torch.core.rpc.RpcQueue` on its firing steps (on the card
  one ``rpc_enqueue`` launch, no host contact), and one flush after the
  loop replays every firing on the host in order; a silent step leaves the
  queue as JAX's ``where=False`` record does;
* a **returning hook** (``returns=`` and ``consume=``) enqueues a ticketed
  record, flushes and folds the reply into the state on its firing steps.

Capturing the step in a CUDA graph is later work (ROADMAP queue 1, item
2.2); the channel's device-side sequence numbers are what make a hook
capturable.

Hook hygiene, as in JAX: a hook without a ``name`` gets a name derived
from its host function and ``every`` (a content hash, so reruns bind the
same landing pads and callee ids), and its registry entries are retired
when ``device_run`` returns, after
:func:`~repro_torch.core.rpc.effects_barrier` (so repeated runs leave the
registry at a constant size).

``queue_async=True`` makes the run's queue async (its flushes hand each
epoch to a host drain that overlaps the device's work) and owns its
boundary: the flush after the loop only submits the last epoch, so the
run flushes once more to collect it and joins the queue's drains before
it returns.

``mesh=`` (a ``DeviceMesh``) runs the whole loop under parallelism
expansion (``core/expand.py``): every rank runs it as one team of the
mesh, ``step_fn`` and ``extract`` may use the team vocabulary
(``team_id()``, ...), and every hook, immediate or batched, enqueues on
the team's row of one :class:`~repro_torch.core.rpc.ShardedRpcQueue`,
drained once at the program boundary on the mesh's first rank, in
``(device, slot)`` order.

Events (:mod:`repro_torch.core.events`), as JAX's: a ``hook_decl`` for
each hook, the step loop inside ``loop_scope(n_steps)`` and each hook
inside ``cond_scope(every, key=name)``.  JAX emits the loop body's
events once, as it traces; the eager loop here emits them at each firing,
each hook's inside the one frame it enters at every step.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import events
from repro_torch.core.expand import (P, _check_mesh, expand, set_team_queue,
                                     team_queue)
from repro_torch.core.rpc import (REGISTRY, RpcQueue, ShapeDtype,
                                  ShardedRpcQueue, effects_barrier, rpc_call,
                                  stable_hook_id)
from repro_torch.tree import leaves

_NO_SCOPE = contextlib.nullcontext()
_I32 = ShapeDtype((), torch.int32)


@dataclasses.dataclass(frozen=True)
class HostHook:
    """A periodic host escape from the device main loop.

    every:    fire after step ``s`` (counted from 1) when ``s % every == 0``
    extract:  (step, state) -> tree of tensors shipped to the host; a
              batched hook's (every hook's under ``mesh=``) may return
              None to stage nothing, as every team but one does with a
              payload that all the teams gather together
    host_fn:  host callback receiving (step, *leaves); immediate hooks get
              each leaf as a numpy array (bf16 as float32), batched ones a
              0-d leaf as a Python int or float and an array as a 1-D
              int32 or float32 array.  Its return value is ignored unless
              ``returns`` declares one.  On a card it runs on the RPC
              channel's thread while the stream waits: numpy only, no CUDA
              calls
    name:     RPC name for the pad table and stats; by default derived
              from host_fn's module, qualname and first line and ``every``
    batched:  enqueue firings on the run's queue; one flush after the loop
              replays them in order
    returns:  (batched only) the shape and dtype of host_fn's return value,
              which the device consumes: the firing step enqueues a
              ticketed record, flushes the queue and folds the reply into
              the state through ``consume``
    consume:  ``(step, state, value, ok) -> state``, required with
              ``returns`` (``ok`` False when the record or its reply was
              dropped or the callee failed)
    idempotent: host_fn is safe to re-run, so a queue with a
              :class:`~repro_torch.core.rpc.RetryPolicy` may redrive a
              failed firing
    """
    every: int
    extract: Callable[[int, Any], Any]
    host_fn: Callable
    name: Optional[str] = None
    batched: bool = False
    returns: Any = None
    consume: Optional[Callable] = None
    idempotent: bool = False


def _hook_key(hook: HostHook) -> Optional[str]:
    """The hook's durable identity (module, qualname, first line of
    host_fn, ``every``), or None when host_fn has no code object."""
    code = getattr(hook.host_fn, "__code__", None)
    if code is None:
        return None
    mod = getattr(hook.host_fn, "__module__", "") or ""
    qual = getattr(hook.host_fn, "__qualname__",
                   getattr(hook.host_fn, "__name__", "fn"))
    return f"{mod}:{qual}:{code.co_firstlineno}:{int(hook.every)}"


def _hook_name(hook: HostHook) -> str:
    """``hook.<fn>.<hash31 hex>``, the JAX package's auto-name: stable
    across processes, so reruns bind the same landing pads."""
    if hook.name:
        return hook.name
    fn_name = getattr(hook.host_fn, "__name__", "fn")
    key = _hook_key(hook)
    if key is None:
        return f"hook.{fn_name}.{id(hook):x}"
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
    """Bind the hook's host_fn into the RPC registry, JAX's checks
    first."""
    if hook.returns is not None:
        if not hook.batched:
            raise ValueError(
                f"hook {hname!r}: returns= is the batched reply path; "
                "construct it with batched=True (immediate hooks already "
                "run synchronously)")
        if hook.consume is None:
            raise ValueError(
                f"hook {hname!r}: returns= declares a device-consumed "
                "reply; pass consume=(step, state, value, ok) -> state "
                "to fold it into the state")

        def adapter(step, *payload):
            return hook.host_fn(int(step), *payload)
    else:
        def adapter(step, *payload):
            hook.host_fn(int(step), *payload)
            return np.int32(0)

    adapter.__name__ = hname
    REGISTRY.register(hname, adapter, idempotent=hook.idempotent)


def _fires(hook: HostHook, step: int) -> bool:
    return step % hook.every == 0 and step > 0


def _fire(hook: HostHook, hname: str, step: int, state: Any) -> None:
    """Immediate hook: one RPC through its landing pad, only on firing
    steps (the JAX ``_fire`` puts the call in the taken branch of a
    ``lax.cond`` for the same reason: silent steps stay on the device)."""
    if _fires(hook, step):
        rpc_call(hname, step, *leaves(hook.extract(step, state)),
                 result_shape=_I32)


def _fire_batched(hook: HostHook, hname: str, step: int, state: Any,
                  q: RpcQueue) -> None:
    """Batched hook: one record on firing steps, none on silent ones or
    where ``extract`` returns None (a team with nothing to stage)."""
    if _fires(hook, step):
        payload = hook.extract(step, state)
        if payload is not None:
            q.enqueue(hname, step, *leaves(payload))


def _fire_returning(hook: HostHook, hname: str, step: int, state: Any,
                    q: RpcQueue) -> Any:
    """Reply-consuming batched hook: on firing steps a ticketed record, a
    flush, and the reply folded into the state through ``consume``.
    Returns the state."""
    if not _fires(hook, step):
        return state
    _, ticket = q.enqueue_ticketed(hname, step,
                                   *leaves(hook.extract(step, state)),
                                   returns=hook.returns)
    q.flush()
    value, ok = q.result_ok(ticket, hook.returns)
    return hook.consume(step, state, value, ok)


def _device_of(state: Any) -> torch.device:
    """The device of the state's first tensor (the host without one)."""
    for leaf in leaves(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def device_run(step_fn: Callable[..., Any], state: Any, n_steps: int, *,
               hooks: Sequence[HostHook] = (), queue_capacity: int = 1024,
               queue_width: int = 8, queue_payload: int = 4096,
               queue_reply: int = 0, queue_retry=None,
               queue_timeout: Optional[float] = None,
               queue_async: bool = False, thread_queue: bool = False,
               return_queue: bool = False, mesh=None,
               state_spec: Optional[P] = None) -> Any:
    """Run ``state = step_fn(step, state)`` for ``step`` in 0..n_steps-1,
    firing each hook after its step as ``step + 1``.  Returns the final
    state; its tensors may still be in flight on the card (synchronise
    before timing), and so may the hooks' host calls, unless an auto-named
    hook made ``device_run`` wait for them before retiring it.

    Batched and returning hooks share one :class:`RpcQueue` on the state's
    device (``queue_capacity`` records of ``queue_width`` args, a
    ``queue_payload``-word arena, a ``queue_reply``-word reply arena,
    ``queue_retry`` and ``queue_timeout`` its drain's policy), flushed once
    after the loop.  ``thread_queue=True`` hands the queue to the step:
    ``step_fn(step, state, queue) -> (state, queue)`` may enqueue, flush
    and read replies mid-loop.  ``return_queue=True`` returns ``(state,
    flushed queue)``.  ``queue_async=True`` runs the queue async (see the
    module docstring): in-loop flushes land replies one epoch late, so it
    refuses returning hooks, and every host effect has retired when the
    run returns.

    ``mesh=`` (see the module docstring) refuses returning hooks (their
    reply needs a flush inside the region); with ``thread_queue`` the
    step gets its team's queue row and may only enqueue, and
    ``return_queue`` returns the flushed sharded queue, every team's
    replies in its row.  ``state_spec`` is the state's
    :class:`~repro_torch.core.expand.P` (``P()``, replicated, by
    default: the step must then keep the state the same on every
    team)."""
    if mesh is not None:
        _check_mesh(mesh)
    for h in hooks:
        if h.every < 1:
            raise ValueError(f"hook every={h.every} must be >= 1")
    named = _name_hooks(hooks)
    for h, hname in named:
        _register_hook(h, hname)
    tracing = events.active()
    if tracing:
        for h, hname in named:
            events.emit("hook_decl", name=hname, every=int(h.every),
                        n_steps=int(n_steps), batched=bool(h.batched),
                        mesh=mesh is not None,
                        unstable=h.name is None and _hook_key(h) is None)
    try:
        returning = [hname for h, hname in named if h.returns is not None]
        if queue_async and returning:
            raise ValueError(
                f"hook(s) {returning} use returns= with queue_async=True: "
                "the double-buffered transport lands replies one epoch "
                "late, but a consume step folds its reply into the SAME "
                "firing step's state; use the synchronous queue for "
                "reply-consuming hooks")
        if mesh is not None:
            if returning:
                raise ValueError(
                    f"hook(s) {returning} use returns= under mesh=: the "
                    "reply needs a flush inside the expanded region; read "
                    "replies after the boundary flush through "
                    "thread_queue/return_queue instead")
            return _device_run_mesh(
                step_fn, state, n_steps, named, mesh, state_spec,
                dict(capacity=queue_capacity, width=queue_width,
                     payload_capacity=queue_payload,
                     reply_capacity=queue_reply, retry=queue_retry,
                     timeout=queue_timeout,
                     mode="async" if queue_async else "sync"),
                thread_queue, return_queue, tracing)
        carries_queue = (any(h.batched for h in hooks) or thread_queue
                         or return_queue)
        if returning:
            # each reply-consuming hook flushes at its firing step, so an
            # epoch holds at most one round of declared replies
            need = sum(int(np.prod(h.returns.shape) or 1)
                       for h, _ in named if h.returns is not None)
            queue_reply = max(queue_reply, need)
        q = None
        if carries_queue:
            q = RpcQueue.create(queue_capacity, queue_width, queue_payload,
                                queue_reply, retry=queue_retry,
                                timeout=queue_timeout,
                                mode="async" if queue_async else "sync",
                                device=_device_of(state))
        with (events.loop_scope(int(n_steps)) if tracing
              else events.NO_LOOP) as trip:
            for step in range(n_steps):
                trip.next()
                if thread_queue:
                    state, q = step_fn(step, state, q)
                else:
                    state = step_fn(step, state)
                for h, hname in named:
                    with (events.cond_scope(int(h.every), key=hname)
                          if tracing else _NO_SCOPE):
                        if h.returns is not None:
                            state = _fire_returning(h, hname, step + 1,
                                                    state, q)
                        elif h.batched:
                            _fire_batched(h, hname, step + 1, state, q)
                        else:
                            _fire(h, hname, step + 1, state)
        if q is not None:
            q.flush()
            if queue_async:
                # that flush only submitted the last epoch: collect it,
                # then wait for the drains (JAX's boundary protocol)
                q.flush()
                q.join()
        return (state, q) if return_queue else state
    finally:
        auto = [hname for h, hname in named if h.name is None]
        if auto:
            effects_barrier()
            for hname in auto:
                REGISTRY.unregister(hname)


def _device_run_mesh(step_fn, state, n_steps, named, mesh, state_spec,
                     queue_kw, thread_queue, return_queue, tracing):
    """The step loop as one expanded region: each team runs every step,
    its hooks enqueue on its queue row (a silent step enqueues nothing),
    and one gathered flush after the region drains every team's firings
    (an async queue: flush, flush again to collect, join)."""
    q0 = ShardedRpcQueue.create(mesh.size(), **queue_kw,
                                device=mesh.device_type)

    def region(state):
        lq = team_queue()
        with (events.loop_scope(int(n_steps)) if tracing
              else events.NO_LOOP) as trip:
            for step in range(n_steps):
                trip.next()
                if thread_queue:
                    state, lq = step_fn(step, state, lq)
                else:
                    state = step_fn(step, state)
                for h, hname in named:
                    with (events.cond_scope(int(h.every), key=hname)
                          if tracing else _NO_SCOPE):
                        _fire_batched(h, hname, step + 1, state, lq)
        set_team_queue(lq)
        return state

    spec = state_spec if state_spec is not None else P()
    q, final = expand(region, mesh, (spec,), spec, queue=True,
                      queue_async=queue_kw["mode"] == "async")(q0, state)
    q.flush()
    if queue_kw["mode"] == "async":
        q.flush()
        q.join()
    return (final, q) if return_queue else final


def host_driven_run(step_fn: Callable[[int, Any], Any], state: Any,
                    n_steps: int) -> Any:
    """The classical offload baseline (JAX's ``host_driven_run``,
    ``repro/core/device_main.py``): ``state = step_fn(step, state)`` for
    ``step`` in 0..n_steps-1, with the step argument :func:`device_run`
    passes (a Python int), and after each step a wait for the state's
    device (``torch.cuda.synchronize`` on a card, nothing on the CPU).
    What whole-program execution saves is the difference to
    :func:`device_run` over the same steps."""
    for step in range(n_steps):
        state = step_fn(step, state)
        device = _device_of(state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return state
