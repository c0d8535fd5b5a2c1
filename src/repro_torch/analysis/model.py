"""Hazard taxonomy and the structured report the analyzer produces.

The port of ``repro/analysis/model.py``, the same codes, classes and JSON
(:meth:`HazardReport.to_json`), so a report compares with JAX's byte for
byte.

A :class:`Hazard` is one finding: a stable ``code`` (the class), the user
``site`` that caused it (``file:line`` of the offending enqueue / free /
read — never a runtime-internal frame), a human message, and a ``detail``
dict with the numbers behind the claim (worst-case words, capacities,
epochs).  :class:`HazardReport` aggregates findings, de-duplicates by
``(code, site)`` — one hazard per offending line per class, however many
times tracing revisits it — and serializes to the JSON the CI golden file
pins down.

Hazard classes
--------------

Ticket lifecycle
  ``RESULT_BEFORE_FLUSH``  — ``result()`` reachable before any ``flush()``
  on the queue lineage (reads all-zeros).
  ``NEVER_FLUSHED``        — records enqueued on a lineage that never
  flushes inside the analyzed program.
  ``STALE_TICKET``         — ticket consumed >= 2 flushes after its
  enqueue: the reply window has slid past it.
  ``UNGUARDED_RESULT``     — conditionally-enqueued ticket read through
  ``result()`` instead of ``result_ok()`` (a dropped record reads zeros).

Capacity proofs
  ``CAPACITY_RECORDS`` / ``CAPACITY_PAYLOAD`` / ``CAPACITY_REPLY`` —
  static worst-case records / payload words / reply words per flush epoch
  exceed the queue's configured capacity: this program can drop.

Pointer safety
  ``USE_AFTER_FREE`` — freed heap pointer flows into ``ArenaRef``
  marshalling or ``find_obj``.
  ``DOUBLE_FREE``    — second ``free`` of the same pointer.
  ``OOB_PTR``        — constant pointer outside the arena.

Performance lints
  ``RPC_IN_LOOP``      — immediate ordered RPC issued unconditionally
  inside a loop body (the Fig. 7 ``wait_fraction ~ 0.98`` pathology;
  use the batched queue).
  ``CALLBACK_IN_LOOP`` — graph-level twin of the above (a transport op
  that reaches the host inside a loop subgraph of an exported program,
  or one call path's op repeated by an unrolled loop, not in a taken
  branch; see :mod:`repro_torch.analysis.walker`).
  ``CALLBACK_IN_MESH`` — host callback inside a partitioned program: in
  JAX, XLA cannot lower the gathered operand (the known abort case).  In
  the port, an immediate call inside an ``expand`` region (the event
  rules read ``rpc_immediate``'s ``in_mesh``; the walker tests a
  transport node's call stack for the region's frame): every team's
  host is called, where a team queue drains once at the boundary.
  ``HOOK_NEVER_FIRES`` — immediate/batched hook whose ``every`` exceeds
  the run's ``n_steps``: it can never fire.

Durable identity
  ``UNSTABLE_PAD_NAME`` — hook landing pad auto-named from ``id()``
  (its callable carries no code object — e.g. ``functools.partial``),
  so the pad id changes every process: an exported ``RpcManifest``
  cannot round-trip and a cold-started replica binds a DIFFERENT pad.
  Pass ``HostHook(name=...)`` explicitly.

Robustness (the v5 fault-tolerant boundary)
  ``RETRY_NON_IDEMPOTENT`` — a queue with a ``RetryPolicy`` carries a
  callee not registered ``idempotent=True``: the drain will NOT redrive
  its transient failures (the record surfaces ``CALLEE_RAISED``), so the
  retry policy silently does not apply where it was probably wanted.
  ``UNCHECKED_STATUS``     — a ticketed reply consumed only through raw
  ``result()`` with no ``result_status()``/``result_ok()`` guard
  reachable: a ``CALLEE_RAISED``/``TIMEOUT``/``DROPPED`` record reads
  silent zeros indistinguishable from a real zero reply.
  ``PENDING_TICKET_READ``  — on the v6 double-buffered (``mode="async"``)
  transport a flush only SUBMITS its epoch; the replies land at the NEXT
  flush.  A raw ``result()`` one flush after the enqueue therefore reads
  a reply that has not been collected yet (``STATUS_PENDING`` in the
  status lane) — guard with ``result_status()`` or read after the
  collect flush.  Async lineages also get one extra flush of reply-window
  grace before ``STALE_TICKET`` (the window trails by an epoch).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

TICKET_CODES = ("RESULT_BEFORE_FLUSH", "NEVER_FLUSHED", "STALE_TICKET",
                "UNGUARDED_RESULT")
CAPACITY_CODES = ("CAPACITY_RECORDS", "CAPACITY_PAYLOAD", "CAPACITY_REPLY")
POINTER_CODES = ("USE_AFTER_FREE", "DOUBLE_FREE", "OOB_PTR")
PERF_CODES = ("RPC_IN_LOOP", "CALLBACK_IN_LOOP", "CALLBACK_IN_MESH",
              "HOOK_NEVER_FIRES")
IDENTITY_CODES = ("UNSTABLE_PAD_NAME",)
ROBUSTNESS_CODES = ("RETRY_NON_IDEMPOTENT", "UNCHECKED_STATUS",
                    "PENDING_TICKET_READ")
ALL_CODES = TICKET_CODES + CAPACITY_CODES + POINTER_CODES + PERF_CODES \
    + IDENTITY_CODES + ROBUSTNESS_CODES


@dataclasses.dataclass(frozen=True)
class Hazard:
    code: str                    # one of ALL_CODES
    message: str                 # human-readable finding
    site: str                    # "file:line" of the offending user frame
    detail: Tuple[Tuple[str, Any], ...] = ()   # sorted key/value evidence

    @staticmethod
    def make(code: str, message: str, site: str,
             **detail: Any) -> "Hazard":
        assert code in ALL_CODES, f"unknown hazard code {code!r}"
        return Hazard(code, message, site or "<unknown>",
                      tuple(sorted(detail.items())))

    @property
    def details(self) -> Dict[str, Any]:
        return dict(self.detail)

    def to_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "site": self.site,
                "message": self.message, "detail": self.details}

    def __str__(self) -> str:
        return f"{self.site}: [{self.code}] {self.message}"


@dataclasses.dataclass
class HazardReport:
    hazards: List[Hazard] = dataclasses.field(default_factory=list)

    def add(self, hazard: Hazard) -> None:
        self.hazards.append(hazard)

    def extend(self, hazards: Iterable[Hazard]) -> None:
        self.hazards.extend(hazards)

    def merged(self, other: "HazardReport") -> "HazardReport":
        return HazardReport(list(self.hazards) + list(other.hazards))

    def deduped(self) -> "HazardReport":
        """One hazard per ``(code, site)`` — first occurrence wins."""
        seen, out = set(), []
        for h in self.hazards:
            key = (h.code, h.site)
            if key not in seen:
                seen.add(key)
                out.append(h)
        return HazardReport(out)

    def by_code(self, code: str) -> List[Hazard]:
        return [h for h in self.hazards if h.code == code]

    @property
    def codes(self) -> List[str]:
        return sorted({h.code for h in self.hazards})

    def __len__(self) -> int:
        return len(self.hazards)

    def __bool__(self) -> bool:
        return bool(self.hazards)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(
            {"hazards": [h.to_dict() for h in self.hazards],
             "codes": self.codes, "count": len(self.hazards)},
            indent=indent, sort_keys=True, default=str)

    def summary(self) -> str:
        if not self.hazards:
            return "no hazards"
        lines = [f"{len(self.hazards)} hazard(s) "
                 f"in {len(self.codes)} class(es):"]
        lines += [f"  {h}" for h in self.hazards]
        return "\n".join(lines)
