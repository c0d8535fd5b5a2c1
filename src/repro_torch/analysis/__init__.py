"""GPU-First Sanitizer on PyTorch/CUDA: static hazard analysis and runtime
shadow checks (the paper's §5.3 porting advisor), the port of
``repro/analysis``.

* the STATIC half (:func:`analyze`, ``python -m
  repro_torch.analysis.lint``) runs a program under an event capture —
  and exports it for the graph walker — and reports transport and heap
  hazards before you trust a run: ticket lifecycle, capacity proofs,
  pointer safety, RPC placement lints (see
  :mod:`repro_torch.analysis.model` for the taxonomy);
* the RUNTIME half (``RpcQueue.create(sanitize=True)``, surfaced here via
  :mod:`repro_torch.analysis.sanitize`) plants canaries and poison
  patterns in the live transport and counts violations in
  :func:`sanitize_stats`.
"""
from repro_torch.analysis.capture import Capture, analyze, capture
from repro_torch.analysis.model import (ALL_CODES, CAPACITY_CODES,
                                        PERF_CODES, POINTER_CODES,
                                        TICKET_CODES, Hazard, HazardReport)
from repro_torch.analysis.rules import analyze_events
from repro_torch.analysis.sanitize import (CANARY, POISON, poison_free,
                                           reset_sanitize_stats,
                                           sanitize_stats)
from repro_torch.analysis.walker import analyze_graph, walk_graph

__all__ = [
    "ALL_CODES", "CANARY", "CAPACITY_CODES", "Capture", "Hazard",
    "HazardReport", "PERF_CODES", "POINTER_CODES", "POISON", "TICKET_CODES",
    "analyze", "analyze_events", "analyze_graph", "capture", "poison_free",
    "reset_sanitize_stats", "sanitize_stats", "walk_graph",
]
