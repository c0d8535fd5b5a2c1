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
  port's ``core`` and ``kernels`` packages, its ``analysis`` package but
  the seeded corpus ``analysis/corpus.py``, PyTorch, ``contextlib`` and
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
body, each inside the same scopes: inside a loop frame, a region's uid
is the same each time the loop's body enters it from the same place (the
same stack of code locations, under the same enclosing frame, with the
same ``key``), as JAX's one trace of the body has one frame.  A region
under no loop frame gets a fresh uid each time it is entered: a bare
Python loop around it is unrolled, and JAX traces each of its calls
anew.  An event under a loop frame also carries ``trips``: the trip
index of each enclosing loop frame, outermost first, which the loop sets
through the handle ``loop_scope`` yields (``next()`` at each trip).  The
analysis layer folds the repeats by it (``analysis/capture.py``).  A
value an event would read from a CUDA tensor (a heap pointer on the
card) is ``None``, as JAX gives ``None`` for a tracer: an event never
reads the device.

Scope frames are ``(kind, uid, value)`` tuples: ``("loop", n, trips)``
with ``trips`` an int or None (unbounded), and ``("cond", n, period)``
with ``period`` an int >= 1 or None (a plain conditional).
"""
from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import traceback
from typing import Any, Dict, Hashable, List, Optional, Tuple

ScopeFrame = Tuple[str, int, Optional[int]]

#: Path parts of the frames a site skips: the runtime and PyTorch.
_RUNTIME = ("/repro_torch/core/", "/repro_torch/kernels/", "/torch/")
#: The analysis package's frames are skipped too, but for its seeded
#: corpus: its programs are the linted subject, so hazard sites point
#: into it (JAX's rule).
_ANALYSIS, _CORPUS = "/repro_torch/analysis/", "/corpus.py"
_PLUMBING = ("/contextlib.py", "/functools.py", "/threading.py",
             "/runpy.py")


def is_internal_frame(path: str) -> bool:
    """True iff a frame in file ``path`` is one a hazard site skips: the
    runtime, PyTorch, the standard library's plumbing, and the analysis
    package but its corpus.  The event sites and the graph walker's node
    sites share this rule."""
    path = path.replace("\\", "/")
    if any(part in path for part in _RUNTIME) or path.endswith(_PLUMBING):
        return True
    return _ANALYSIS in path and not path.endswith(_CORPUS)


class _State(threading.local):
    def __init__(self):
        self.sinks: List[list] = []
        self.stack: List[ScopeFrame] = []
        # one trip handle per loop frame on the stack, outermost first
        self.loops: List["Trips"] = []
        self.uids = itertools.count()
        # (kind, value, key, enclosing uid, code locations) -> uid
        self.frames: Dict[Tuple, int] = {}


_S = _State()


def active() -> bool:
    """True iff at least one capture is recording on this thread."""
    return bool(_S.sinks)


def _user_site() -> str:
    """``file:line`` of the innermost stack frame outside the runtime, the
    analysis package (but its corpus) and PyTorch."""
    for fr in reversed(traceback.extract_stack()):
        fn = (fr.filename or "").replace("\\", "/")
        if not fn or fn.startswith("<") or is_internal_frame(fn):
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
    if _S.loops:
        ev["trips"] = tuple(t.index for t in _S.loops)
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
        if not _S.sinks:
            _S.frames.clear()


def _frame(kind: str, value: Optional[int], key: Hashable) -> ScopeFrame:
    """The frame of a region entered here.  Inside a loop frame its uid is
    the one the region got when the loop's body last entered it from the
    same code locations under the same enclosing frame with the same
    ``key`` (a new one the first time); under no loop frame it is new."""
    if not any(k == "loop" for k, _u, _v in _S.stack):
        return (kind, next(_S.uids), value)
    where, f = [], sys._getframe(3)
    while f is not None:
        where.append((f.f_code.co_filename, f.f_lineno))
        f = f.f_back
    at = (kind, value, key, _S.stack[-1][1] if _S.stack else None,
          tuple(where))
    uid = _S.frames.get(at)
    if uid is None:
        uid = _S.frames[at] = next(_S.uids)
    return (kind, uid, value)


class Trips:
    """A loop frame's trip counter: the loop calls :meth:`next` as each
    trip starts (-1 before the first)."""

    __slots__ = ("index",)

    def __init__(self):
        self.index = -1

    def next(self) -> None:
        self.index += 1


class _NoTrips:
    """The handle of a loop run with no capture: counts nothing."""

    def next(self) -> None:
        pass


#: Entered in place of ``loop_scope`` when no capture records.
NO_LOOP = contextlib.nullcontext(_NoTrips())


@contextlib.contextmanager
def loop_scope(trips: Optional[int]):
    """Mark a region whose body runs ``trips`` times per outer run (None:
    unbounded).  Yields the frame's :class:`Trips`."""
    _S.stack.append(_frame(
        "loop", None if trips is None else max(int(trips), 0), None))
    handle = Trips()
    _S.loops.append(handle)
    try:
        yield handle
    finally:
        _S.loops.pop()
        _S.stack.pop()


@contextlib.contextmanager
def cond_scope(period: Optional[int] = None, key: Hashable = None):
    """Mark a conditionally run region; ``period`` says it fires at most
    once every ``period`` iterations of the innermost enclosing loop.
    ``key`` tells apart regions entered from one place."""
    _S.stack.append(_frame(
        "cond", None if period is None else max(int(period), 1), key))
    try:
        yield
    finally:
        _S.stack.pop()


def scopes() -> Tuple[ScopeFrame, ...]:
    """Snapshot of the current scope stack (innermost last)."""
    return tuple(_S.stack)
