"""Deterministic fault injection for the host RPC boundary: the port of
``repro/testing/faults.py`` (numpy only), the same plans for the same
seeds.

The transport's drain consults one process-wide injector at DISPATCH
time (:func:`repro_torch.core.rpc.set_fault_injector`): ``on_call(name,
attempt)`` fires before the callee runs and may raise (the record is
isolated as ``CALLEE_RAISED`` with the host effect never happening) or
return a delay in seconds (the callee runs late — trips a per-callee
``timeout`` if one is configured); ``on_reply(name, words)`` fires after
a successful callee and may drop the reply (``None`` → ``DROPPED``) or
corrupt reply words in place.

**Determinism policy.**  Faults address records by *(callee name,
per-callee occurrence index, attempt)*.  The occurrence index counts
first-attempt dispatches of that callee in the drain's deterministic
replay order — ``(flush order, device, slot)`` — so the same
:class:`FaultPlan` instance replayed against any of the three transports
(immediate-style per-enqueue flushes, one batched flush, sharded) hits
the same logical records and produces bit-identical statuses and host
effects.  Plans are either hand-built from :class:`Fault` records or
generated from a seed via :meth:`FaultPlan.generate`; a plan holds
mutable occurrence counters, so call :meth:`FaultPlan.reset` (or build a
fresh plan from the same seed) before replaying it.

The port's async queues and its sharded queue with ``shard_deadline``
reserve occurrences at each flush through :meth:`FaultPlan.reserve`, a
sharded flush for every shard in one ``(device, slot)`` sweep, and pass
them back with ``index=``.

**Concurrent drains (async / sharded-async transports).**  When drains
run on background threads, arrival order at ``on_call`` is scheduler
noise — so the implicit counters above would make fault addressing
nondeterministic.  Those drains instead call :meth:`FaultPlan.reserve`
at SUBMIT time (still on the caller thread, in canonical
``(device, slot)`` record order) to atomically claim each record's
occurrence index up front, then pass it back explicitly via the
``index=`` keyword of ``on_call`` / ``on_reply``, which bypasses the
internal counters entirely.  A record carried across epochs for redrive
keeps its ORIGINAL index, so a fault pinned to occurrence *k* follows
the record through retries regardless of which epoch retires it.

Usage::

    plan = FaultPlan.generate(seed=7, callees=["log", "read"])
    with inject(plan):
        q = q.flush()          # drain consults the plan per record
    assert plan.fired          # which faults actually triggered
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import rpc

FAULT_KINDS = ("raise", "delay", "drop_reply", "corrupt")


class InjectedFault(RuntimeError):
    """The exception a ``kind="raise"`` fault throws inside the drain."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault.

    ``kind``        one of :data:`FAULT_KINDS`.
    ``callee``      registered RPC name the fault targets.
    ``call_index``  0-based per-callee occurrence (deterministic replay
                    order) the fault fires on.
    ``attempt``     for ``raise``/``delay``: which attempt triggers
                    (1-based) — ``attempt=1`` with a retrying queue
                    models a transient failure that succeeds on retry.
    ``delay``       seconds, for ``kind="delay"``.
    ``word``        reply-word index, for ``kind="corrupt"``.
    ``value``       int32 written over that word.
    """
    kind: str
    callee: str
    call_index: int
    attempt: int = 1
    delay: float = 0.0
    word: int = 0
    value: int = -1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


class FaultPlan:
    """A deterministic set of :class:`Fault` records plus the occurrence
    counters that address them.  Implements the injector protocol the
    drain consults (``on_call`` / ``on_reply``)."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.fired: List[Tuple[str, str, int, int]] = []
        self._occ: Dict[str, int] = {}       # next first-attempt index
        self._cur: Dict[str, int] = {}       # index of the in-flight call
        self._lock = threading.Lock()        # guards _occ/_cur/fired

    # -- injector protocol -------------------------------------------------
    def reserve(self, names: Sequence[Optional[str]]) -> List[int]:
        """Atomically claim occurrence indices for ``names`` in order.

        Concurrent drains call this at submit time (caller thread,
        canonical record order) and pass the returned indices back via
        ``on_call(..., index=)`` / ``on_reply(..., index=)`` so fault
        addressing stays deterministic under threaded replay.  ``None``
        entries (records with no callee, e.g. already-failed slots) get
        index ``-1`` and advance nothing.
        """
        out: List[int] = []
        with self._lock:
            for name in names:
                if name is None:
                    out.append(-1)
                    continue
                idx = self._occ.get(name, 0)
                self._occ[name] = idx + 1
                out.append(idx)
        return out

    def on_call(self, name: str, attempt: int,
                index: Optional[int] = None) -> Optional[float]:
        if index is not None:
            idx = index
        elif attempt == 1:
            with self._lock:
                idx = self._occ.get(name, 0)
                self._occ[name] = idx + 1
                self._cur[name] = idx
        else:
            idx = self._cur.get(name, 0)
        for f in self.faults:
            if f.callee != name or f.call_index != idx \
                    or f.attempt != attempt:
                continue
            if f.kind == "raise":
                self.fired.append(("raise", name, idx, attempt))
                raise InjectedFault(
                    f"injected fault: {name!r} occurrence {idx} "
                    f"attempt {attempt}")
            if f.kind == "delay":
                self.fired.append(("delay", name, idx, attempt))
                return float(f.delay)
        return None

    def on_reply(self, name: str, words: np.ndarray,
                 index: Optional[int] = None):
        idx = self._cur.get(name, 0) if index is None else index
        for f in self.faults:
            if f.callee != name or f.call_index != idx:
                continue
            if f.kind == "drop_reply":
                self.fired.append(("drop_reply", name, idx, 1))
                return None
            if f.kind == "corrupt" and words.size:
                self.fired.append(("corrupt", name, idx, 1))
                words = np.array(words, dtype=np.int32, copy=True)
                words[f.word % words.size] = np.int32(f.value)
        return words

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Zero the occurrence counters (and the fired log) so the same
        plan replays identically against another transport."""
        with self._lock:
            self.fired = []
            self._occ = {}
            self._cur = {}

    def __enter__(self) -> "FaultPlan":
        rpc.set_fault_injector(self)
        return self

    def __exit__(self, *exc) -> None:
        rpc.set_fault_injector(None)

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.faults)!r})"

    # -- seeded generation -------------------------------------------------
    @staticmethod
    def generate(seed: int, callees: Sequence[str], n_faults: int = 3,
                 max_index: int = 8,
                 kinds: Sequence[str] = FAULT_KINDS,
                 max_delay: float = 0.01) -> "FaultPlan":
        """Seeded plan: ``n_faults`` faults over ``callees``, occurrence
        indices in ``[0, max_index)``.  Same seed → same plan, process-
        and platform-independent (pure :mod:`random`, no numpy RNG)."""
        if not callees:
            raise ValueError("generate() needs at least one callee name")
        rng = random.Random(seed)
        faults = []
        for _ in range(n_faults):
            kind = rng.choice(tuple(kinds))
            faults.append(Fault(
                kind=kind,
                callee=rng.choice(tuple(callees)),
                call_index=rng.randrange(max_index),
                attempt=1,
                delay=rng.uniform(0.0, max_delay) if kind == "delay"
                else 0.0,
                word=rng.randrange(4),
                value=rng.randrange(-(1 << 31), 1 << 31),
            ))
        return FaultPlan(faults)


def inject(plan: Optional[FaultPlan]):
    """Context manager installing ``plan`` as the process-wide drain
    injector (``None`` → no-op).  Equivalent to ``with plan:`` but reads
    better at call sites that may pass ``None``."""
    if plan is None:
        return _NullCtx()
    return plan


class _NullCtx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None
