"""Hazard rules over the runtime's event stream.

The port of ``repro/analysis/rules.py``: a pure function of the event
dicts, which gives JAX's report for the same stream.  The capture
(:mod:`repro_torch.analysis.capture`) hands it the ordered events the
runtime emitted while the program ran, repeats folded; the rules
reconstruct three kinds of object history and judge them:

* **queue lineages** — JAX's ``RpcQueue`` is functionally updated, so one
  logical queue appears as a chain of objects (``create -> enqueue ->
  ... -> flush``).  Events carry ``qid``/``qid_out`` object identities;
  the lineage map unions them.  The port's queues update in place, so
  its events carry ``qid_out == qid`` and a lineage is one object; the
  map stays for JAX's streams, for ``queue_view`` and for queues made
  outside the capture.  A lineage that starts at ``queue_create``
  has a *known origin* (the program provably never flushed before a read);
  one first seen mid-stream (a ``local_view``, or a queue passed in from
  outside the capture) does not — origin-dependent rules are suppressed
  for it, capacity rules still apply.
* **tickets** — each ticketed enqueue records its epoch (the lineage's
  flush count at enqueue time); reads are judged against the window the
  v4 reply transport actually keeps (the LAST flush's replies).
* **pointers** — heap pointers keyed by concrete value when they have one
  (and by object identity otherwise), so ``malloc -> free -> marshal``
  chains survive functional state updates.  A re-``malloc`` un-freezes
  the key: handing the block out again is not a use-after-free.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import capacity as cap_math
from repro_torch.analysis.model import Hazard, HazardReport


@dataclasses.dataclass
class _Lineage:
    lid: int
    known_origin: bool
    caps: Dict[str, Optional[int]]
    flush_count: int = 0
    pending: List[dict] = dataclasses.field(default_factory=list)
    epochs: List[Tuple[Optional[dict], List[dict]]] = \
        dataclasses.field(default_factory=list)
    last_flush: Optional[dict] = None
    mode: str = "sync"            # "async": v6 double-buffered transport


def _cap_of(ev: dict, key: str) -> Optional[int]:
    v = ev.get(key)
    try:
        return int(v)
    except Exception:
        return None


def _lineage_caps(ev: dict) -> Dict[str, Optional[int]]:
    return {k: _cap_of(ev, k)
            for k in ("capacity", "payload_capacity", "reply_capacity")}


def _exempt_in_cond(scopes) -> bool:
    """True when a cond frame encloses the event more tightly than any
    loop: the RPC only fires in a taken branch (device_run's immediate
    hooks), so the every-iteration-sync lint does not apply."""
    last_loop = -1
    last_cond = -1
    for i, (kind, _uid, _val) in enumerate(scopes):
        if kind == "loop":
            last_loop = i
        elif kind == "cond":
            last_cond = i
    return last_cond > last_loop


def _has_loop(scopes) -> bool:
    return any(kind == "loop" for kind, _u, _v in scopes)


def analyze_events(events: List[dict]) -> HazardReport:
    report = HazardReport()
    lineages: Dict[int, _Lineage] = {}
    owner: Dict[int, _Lineage] = {}          # object id -> lineage
    tickets: Dict[int, dict] = {}            # ticket id -> enqueue record
    ptr_state: Dict[Tuple, str] = {}         # pointer key -> "live"/"freed"
    next_lid = iter(range(1 << 30))

    def lineage_for(ev: dict, known: bool) -> _Lineage:
        lin = owner.get(ev["qid"])
        if lin is None:
            lin = _Lineage(next(next_lid), known, _lineage_caps(ev))
            owner[ev["qid"]] = lin
            lineages[lin.lid] = lin
        return lin

    def ptr_key(ev: dict) -> Tuple:
        if ev.get("ptr") is not None:
            return ("v", ev.get("heap"), int(ev["ptr"]))
        return ("id", ev["ptr_id"])

    def check_oob(ev: dict) -> bool:
        ptr, heap = ev.get("ptr"), ev.get("heap")
        if ptr is None or heap is None:
            return False
        if 0 <= int(ptr) < int(heap):
            return False
        report.add(Hazard.make(
            "OOB_PTR",
            f"pointer {int(ptr)} is outside the [0, {int(heap)}) arena",
            ev["site"], ptr=int(ptr), heap=int(heap)))
        return True

    for ev in events:
        kind = ev["kind"]

        if kind == "queue_create":
            lin = _Lineage(next(next_lid), True, _lineage_caps(ev),
                           mode=str(ev.get("mode") or "sync"))
            owner[ev["qid"]] = lin
            lineages[lin.lid] = lin

        elif kind == "queue_view":
            lin = _Lineage(next(next_lid), False, _lineage_caps(ev),
                           mode=str(ev.get("mode") or "sync"))
            owner[ev["qid"]] = lin
            lineages[lin.lid] = lin

        elif kind == "rpc_enqueue":
            lin = lineage_for(ev, known=False)
            owner[ev["qid_out"]] = lin
            lin.pending.append(ev)
            for k, v in _lineage_caps(ev).items():
                if lin.caps.get(k) is None:
                    lin.caps[k] = v
            if ev.get("retry") and not ev.get("idempotent"):
                report.add(Hazard.make(
                    "RETRY_NON_IDEMPOTENT",
                    f"retrying queue carries {ev.get('name')!r}, which is "
                    "not registered idempotent=True — the drain will NOT "
                    "redrive its transient failures (the record surfaces "
                    "CALLEE_RAISED); register the callee idempotent, or "
                    "drop the RetryPolicy",
                    ev["site"], name=ev.get("name")))
            if ev.get("ticketed"):
                tickets[ev["ticket_id"]] = {
                    "lineage": lin, "epoch": lin.flush_count,
                    "conditional": bool(ev.get("conditional")),
                    "site": ev["site"], "name": ev.get("name"),
                    "raw_sites": [], "guarded": False}

        elif kind == "rpc_flush":
            lin = lineage_for(ev, known=False)
            owner[ev["qid_out"]] = lin
            lin.epochs.append((ev, lin.pending))
            lin.pending = []
            lin.flush_count += 1
            lin.last_flush = ev
            if ev.get("mode"):
                lin.mode = str(ev["mode"])

        elif kind == "rpc_result":
            lin = owner.get(ev["qid"])
            tk = tickets.get(ev["ticket_id"])
            never = bool(ev.get("never_flushed"))
            if not never and lin is not None and lin.known_origin \
                    and lin.flush_count == 0:
                never = True
            if never:
                report.add(Hazard.make(
                    "RESULT_BEFORE_FLUSH",
                    "result() reachable before any flush() on this queue "
                    "— reads all-zeros indistinguishable from a real "
                    "zero reply",
                    ev["site"]))
            if tk is not None:
                t_lin = tk["lineage"]
                is_async = t_lin.mode == "async"
                if is_async and ev.get("via_result") \
                        and t_lin.flush_count == tk["epoch"] + 1:
                    report.add(Hazard.make(
                        "PENDING_TICKET_READ",
                        f"ticket from epoch {tk['epoch']} read through "
                        "raw result() one flush later — on the async "
                        "transport that flush only SUBMITTED the epoch "
                        "(status lane reads PENDING); collect with a "
                        "second flush, or guard with result_status()",
                        ev["site"], epoch=tk["epoch"],
                        flushes=t_lin.flush_count,
                        enqueue_site=tk["site"]))
                # the async reply window trails by one epoch: the collect
                # flush at epoch+2 is the valid read point, not stale
                stale_at = tk["epoch"] + (3 if is_async else 2)
                if t_lin.flush_count >= stale_at:
                    report.add(Hazard.make(
                        "STALE_TICKET",
                        f"ticket from epoch {tk['epoch']} read after "
                        f"flush {t_lin.flush_count} — the reply window "
                        "keeps only the LAST flush's replies",
                        ev["site"], epoch=tk["epoch"],
                        flushes=t_lin.flush_count,
                        enqueue_site=tk["site"]))
                if tk["conditional"] and ev.get("via_result"):
                    report.add(Hazard.make(
                        "UNGUARDED_RESULT",
                        "conditionally-enqueued ticket read through "
                        "result() — use result_ok() so a dropped record "
                        "is distinguishable from a zero reply",
                        ev["site"], enqueue_site=tk["site"]))
                if ev.get("via_result"):
                    tk["raw_sites"].append(ev["site"])
                else:
                    # result_ok / result_status read: the status lane IS
                    # consulted for this ticket
                    tk["guarded"] = True

        elif kind == "rpc_immediate":
            if ev.get("in_mesh"):
                report.add(Hazard.make(
                    "CALLBACK_IN_MESH",
                    f"immediate rpc_call({ev.get('name')!r}) inside a "
                    "partitioned (expanded) region — XLA cannot lower "
                    "the gathered callback; enqueue on the team queue "
                    "and drain at the program boundary",
                    ev["site"], name=ev.get("name")))
            elif ev.get("ordered") and _has_loop(ev["scopes"]) \
                    and not _exempt_in_cond(ev["scopes"]):
                trips = cap_math.multiplicity(ev["scopes"])
                report.add(Hazard.make(
                    "RPC_IN_LOOP",
                    f"immediate ordered rpc_call({ev.get('name')!r}) "
                    "issued every loop iteration "
                    f"({cap_math.fmt_count(trips)} host round-trips; "
                    "Fig. 7 wait_fraction ~= 0.98) — enqueue on an "
                    "RpcQueue and flush once instead",
                    ev["site"], name=ev.get("name"),
                    round_trips=cap_math.fmt_count(trips)))

        elif kind == "hook_decl":
            every, n_steps = ev.get("every"), ev.get("n_steps")
            if every and n_steps is not None and every > n_steps:
                report.add(Hazard.make(
                    "HOOK_NEVER_FIRES",
                    f"hook {ev.get('name')!r} has every={every} but the "
                    f"run is only {n_steps} step(s) — it can never fire",
                    ev["site"], name=ev.get("name"), every=every,
                    n_steps=n_steps))
            if ev.get("unstable"):
                report.add(Hazard.make(
                    "UNSTABLE_PAD_NAME",
                    f"hook {ev.get('name')!r} is auto-named from id() — "
                    "its callable has no code object to hash, so the "
                    "landing-pad id changes every process and an exported "
                    "RpcManifest cannot round-trip; pass HostHook(name=...)",
                    ev["site"], name=ev.get("name")))

        elif kind == "heap_malloc":
            ptr_state[ptr_key(ev)] = "live"

        elif kind == "heap_free":
            if check_oob(ev):
                continue
            key = ptr_key(ev)
            if ptr_state.get(key) == "freed":
                report.add(Hazard.make(
                    "DOUBLE_FREE",
                    "second free() of the same heap pointer — the block "
                    "may already be handed out again",
                    ev["site"], ptr=ev.get("ptr")))
            else:
                ptr_state[key] = "freed"

        elif kind in ("arena_marshal", "ptr_lookup"):
            if check_oob(ev):
                continue
            if ptr_state.get(ptr_key(ev)) == "freed":
                what = ("marshalled into an ArenaRef RPC argument"
                        if kind == "arena_marshal"
                        else "looked up through find_obj")
                report.add(Hazard.make(
                    "USE_AFTER_FREE",
                    f"freed heap pointer {what}",
                    ev["site"], ptr=ev.get("ptr")))

    # -- end of capture: tickets consumed with no status guard ------------
    for tk in tickets.values():
        if tk.get("raw_sites") and not tk.get("guarded"):
            report.add(Hazard.make(
                "UNCHECKED_STATUS",
                f"ticketed reply ({tk.get('name')!r}) consumed only "
                "through result() — no result_status()/result_ok() guard "
                "reachable, so a CALLEE_RAISED/TIMEOUT/DROPPED record "
                "reads silent zeros indistinguishable from a real zero "
                "reply",
                tk["raw_sites"][0], name=tk.get("name"),
                enqueue_site=tk["site"]))

    # -- end of capture: never-flushed lineages + capacity proofs ---------
    for lin in lineages.values():
        if lin.pending and lin.flush_count == 0 and lin.known_origin:
            site = lin.pending[0]["site"]
            report.add(Hazard.make(
                "NEVER_FLUSHED",
                f"{len(lin.pending)} enqueue site(s) on a queue that "
                "never flushes — the records are silently dropped",
                site, sites=sorted({e["site"] for e in lin.pending})))
        groups = list(lin.epochs)
        if lin.pending:
            # enqueues after the last flush drain at the NEXT flush of the
            # same shape (mid-loop flush) or at a boundary flush outside
            # the capture — anchor at the last flush seen, else at the
            # program root (worst case: everything accumulates)
            anchor = lin.last_flush
            groups.append((anchor, lin.pending))
        for anchor, enqueues in groups:
            if not enqueues:
                continue
            _check_capacity(report, lin, anchor, enqueues)
    return report.deduped()


def _check_capacity(report: HazardReport, lin: _Lineage,
                    anchor: Optional[dict], enqueues: List[dict]) -> None:
    anchor_scopes = anchor["scopes"] if anchor is not None else ()
    rows = []
    for ev in enqueues:
        mult = cap_math.multiplicity(ev["scopes"], anchor_scopes)
        rows.append((ev, mult))

    def worst(field: str) -> float:
        total = 0.0
        for ev, mult in rows:
            per = ev.get(field) if field else 1
            try:
                per = float(per)
            except Exception:
                continue
            if per:
                total += per * mult
        return total

    checks = (
        ("CAPACITY_RECORDS", None, "capacity", "record(s)"),
        ("CAPACITY_PAYLOAD", "payload_words", "payload_capacity",
         "payload word(s)"),
        ("CAPACITY_REPLY", "reply_words", "reply_capacity",
         "reply word(s)"),
    )
    for code, field, cap_key, unit in checks:
        limit = lin.caps.get(cap_key)
        if limit is None:
            continue
        total = worst(field)
        if total <= limit:
            continue
        # blame the largest contributor; list every contributing site
        contrib = [(r[1] * (1 if field is None else
                            float(r[0].get(field) or 0)), r[0])
                   for r in rows]
        contrib.sort(key=lambda t: -t[0])
        sites = [e["site"] for c, e in contrib if c > 0]
        report.add(Hazard.make(
            code,
            f"worst case {cap_math.fmt_count(total)} {unit} per flush "
            f"epoch exceeds {cap_key}={limit} — this program can drop",
            contrib[0][1]["site"],
            worst=cap_math.fmt_count(total), limit=limit,
            sites=sorted(set(sites))))
