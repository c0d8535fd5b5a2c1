"""Instrumentation seam for the analysis layer (paper §5.3 tooling).

The port of ``repro/core/events.py``.  The runtime (``rpc``,
``allocator``, ``device_main``) emits lightweight EVENTS as it runs:
queue creation, enqueues, flushes, heap operations, immediate RPC issues,
``ArenaRef`` marshals, hook declarations.  An analysis layer subscribes
with :func:`record` around the program it inspects.  The dependency
points one way: core emits through this module and imports nothing of an
analysis layer; with no subscriber :func:`emit` is one attribute check.

Events carry what a rule needs:

* **call sites**: the innermost stack frame outside the runtime (the
  port's ``core`` and ``kernels`` packages, PyTorch, ``contextlib`` and
  friends), so a hazard points at the user's enqueue or free;
* **scope context**: the stack of enclosing loop and conditional regions
  at emit time.  ``loop_scope(trips)`` marks a region that runs ``trips``
  times per outer run (``device_run`` wraps its step loop);
  ``cond_scope(period)`` marks a conditionally run region (a hook that
  fires once every ``period`` steps);
* **object identity**: ``id()`` of the queues, tickets and pointers in
  the program; a capture holds strong references to every object an event
  names (``_refs``), so a recycled ``id()`` cannot alias two objects.

JAX emits while it traces, so a loop body's events appear once inside its
``loop_scope``.  The port runs eagerly, so they appear once per run of the
body, each inside the same scopes.  A value an event would read from a
CUDA tensor (a heap pointer on the card) is ``None``, as JAX gives
``None`` for a tracer: an event never reads the device.

Scope frames are ``(kind, uid, value)`` tuples: ``("loop", n, trips)``
with ``trips`` an int or None (unbounded), and ``("cond", n, period)``
with ``period`` an int >= 1 or None (a plain conditional).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

ScopeFrame = Tuple[str, int, Optional[int]]

#: Path parts of the frames a site skips: the runtime and PyTorch.
_RUNTIME = ("/repro_torch/core/", "/repro_torch/kernels/", "/torch/")
_PLUMBING = ("/contextlib.py", "/functools.py", "/threading.py",
             "/runpy.py")


class _State(threading.local):
    def __init__(self):
        self.sinks: List[list] = []
        self.stack: List[ScopeFrame] = []
        self.uids = itertools.count()


_S = _State()


def active() -> bool:
    """True iff at least one capture is recording on this thread."""
    return bool(_S.sinks)


def _user_site() -> str:
    """``file:line`` of the innermost stack frame outside the runtime and
    PyTorch."""
    for fr in reversed(traceback.extract_stack()):
        fn = (fr.filename or "").replace("\\", "/")
        if not fn or fn.startswith("<"):
            continue
        if any(part in fn for part in _RUNTIME) or fn.endswith(_PLUMBING):
            continue
        return f"{fn}:{fr.lineno}"
    return "<unknown>"


def emit(kind: str, _refs: Tuple = (), **data: Any) -> None:
    """Record one event on every active capture (a no-op when none).

    ``_refs`` are objects the event names by ``id()``: the capture keeps
    them alive so identities stay unique for its lifetime."""
    if not _S.sinks:
        return
    ev: Dict[str, Any] = {"kind": kind, "site": _user_site(),
                          "scopes": tuple(_S.stack)}
    ev.update(data)
    if _refs:
        ev["_refs"] = tuple(_refs)
    for sink in _S.sinks:
        sink.append(ev)


@contextlib.contextmanager
def record(sink: list):
    """Subscribe ``sink`` (a plain list) to this thread's events."""
    _S.sinks.append(sink)
    try:
        yield sink
    finally:
        _S.sinks.remove(sink)


@contextlib.contextmanager
def loop_scope(trips: Optional[int]):
    """Mark a region whose body runs ``trips`` times per outer run (None:
    unbounded)."""
    frame = ("loop", next(_S.uids),
             None if trips is None else max(int(trips), 0))
    _S.stack.append(frame)
    try:
        yield
    finally:
        _S.stack.pop()


@contextlib.contextmanager
def cond_scope(period: Optional[int] = None):
    """Mark a conditionally run region; ``period`` says it fires at most
    once every ``period`` iterations of the innermost enclosing loop."""
    frame = ("cond", next(_S.uids),
             None if period is None else max(int(period), 1))
    _S.stack.append(frame)
    try:
        yield
    finally:
        _S.stack.pop()


def scopes() -> Tuple[ScopeFrame, ...]:
    """Snapshot of the current scope stack (innermost last)."""
    return tuple(_S.stack)
