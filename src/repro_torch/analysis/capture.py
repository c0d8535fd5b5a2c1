"""Event capture: run a program, record what the runtime emitted, judge it.

The port of ``repro/analysis/capture.py``.  :func:`capture` subscribes to
:mod:`repro_torch.core.events`.  It patches nothing: the port's loops
scope themselves (``core/expand.py::serial_for`` under
``events.loop_scope(n)``, as JAX's capture scopes the ``lax.map`` JAX's
``serial_for`` is; ``device_run``'s step loop under
``loop_scope(n_steps)``).  A bare Python ``for`` stays unscoped, JAX's
rule for ``lax.while_loop``: the capacity model may under-count it, it
never gives a false positive.

**The fold.**  JAX emits while it traces, so a loop body's events appear
once, a bare Python loop inside the body unrolled.  The eager port emits
once per run of the body, each run inside the same scope frames
(``events`` gives a region the same uid each time it is entered from the
same place), and each event carries ``trips``, the trip index of every
enclosing loop frame: a run of the body is one tuple of trips.  Fed to
the rules unchanged, the five enqueues of ``serial_for(body, 5)`` would
each count five times.  So :meth:`Capture.folded` keeps an event that
lies under at least one loop frame as many times as its key occurs in
the run where it occurs most, and drops the rest.  The key is the kind,
site, scope frames (uids included) and data without the ids and the
trips (``IDS``); the kept occurrences are the first of each count, with
their ids.  So two enqueues from a bare inner loop of one trip both
count, as in JAX's unrolled trace, and an event that first fires on a
later trip (a hook with ``every > 1``) is kept.  Two kinds of event are
never dropped:

* events under no loop frame: JAX traces an unscoped Python loop once an
  iteration, so it sees each of them too;
* heap events (``heap_malloc``, ``heap_free``, ``ptr_lookup``,
  ``arena_marshal``): the pointer rules count no repeats, and a dropped
  re-``malloc`` of a freed address would read as a use after free.

The fold's boundary: ``capacity`` enqueues in ``serial_for(...,
capacity)`` are clean, ``capacity + 1`` give ``CAPACITY_RECORDS``, in
both packages (``tests/test_torch_analysis.py``).

:func:`analyze` is the one-call entry point: run the program under a
capture, fold, feed the rules, and (``graph=``) export it for the graph
walker (:mod:`repro_torch.analysis.walker`), JAX's ``jaxpr=``.  The
program runs, on the device of its tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.analysis.model import HazardReport
from repro_torch.analysis.rules import analyze_events
from repro_torch.analysis.walker import analyze_graph
from repro_torch.core import events

#: An event's object identities and its trips: left out when events are
#: compared.
IDS = ("_refs", "qid", "qid_out", "ptr_id", "ticket_id", "trips")
#: Events the fold never drops.
HEAP_KINDS = frozenset({"heap_malloc", "heap_free", "ptr_lookup",
                        "arena_marshal"})


def _fold_key(ev: dict):
    key = tuple(sorted((k, v) for k, v in ev.items() if k not in IDS))
    try:
        hash(key)
    except TypeError:
        key = repr(key)
    return key


def fold(stream: List[dict]) -> List[dict]:
    """``stream`` with the repeats of looped events dropped (see the module
    docstring), in order: an occurrence is kept when its count within its
    run exceeds the count kept so far for its key."""
    kept: Dict[Any, int] = {}
    in_run: Dict[Any, int] = {}
    out = []
    for ev in stream:
        if ev["kind"] not in HEAP_KINDS and any(
                kind == "loop" for kind, _u, _v in ev["scopes"]):
            key = _fold_key(ev)
            run = (key, ev.get("trips", ()))
            in_run[run] = in_run.get(run, 0) + 1
            if in_run[run] <= kept.get(key, 0):
                continue
            kept[key] = in_run[run]
        out.append(ev)
    return out


@dataclasses.dataclass
class Capture:
    events: List[dict] = dataclasses.field(default_factory=list)

    def folded(self) -> List[dict]:
        return fold(self.events)

    def report(self) -> HazardReport:
        return analyze_events(self.folded())


@contextlib.contextmanager
def capture():
    """Record the runtime's events for the body."""
    cap = Capture()
    with events.record(cap.events):
        yield cap


def analyze(fn: Callable, *args: Any, graph: Optional[bool] = None,
            **kwargs: Any) -> HazardReport:
    """Run ``fn(*args, **kwargs)`` under a capture and report hazards.

    ``graph`` controls the walker pass (transport placement lints on the
    exported program): ``True`` requires it, ``False`` skips it, ``None``
    (default) attempts it and silently skips programs that
    ``torch.export`` cannot trace (host-side branching on outputs, etc.).
    """
    with capture() as cap:
        fn(*args, **kwargs)
    report = cap.report()
    if graph is not False:
        try:
            walked = analyze_graph(fn, *args, **kwargs)
        except Exception:
            if graph:
                raise
        else:
            report = report.merged(walked)
    return report.deduped()
