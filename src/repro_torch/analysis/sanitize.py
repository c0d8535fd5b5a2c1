"""The runtime sanitizer's heap side, on the transport's checks.

The transport (:mod:`repro_torch.core.rpc`) brackets the payload
reservations of a ``RpcQueue.create(sanitize=True)`` queue with canary
words and scans each drained payload for the poison pattern.  This module
adds :func:`poison_free`, a ``free`` that also stamps the freed block's
words with that pattern in the buffer the heap offsets index, so a record
that later marshals the stale words counts a ``poison_hits`` at its
drain, and re-exports the counters (``sanitize_stats()``):

``canary_stomps``       a payload reservation over- or underran its bracket
``poison_hits``         freed-pattern words delivered in a payload
``uaf_marshals``        an ``ArenaRef`` resolved to no live block
``stale_ticket_reads``  a ``results_host`` read outside the live window
``failed_ticket_reads`` a failed ticket read through ``result()`` (CPU
                        queues)
``epochs``              one record a sanitized drain
"""
from __future__ import annotations

import torch

from repro_torch.core.rpc import (CANARY, POISON, reset_sanitize_stats,
                                  sanitize_stats)

__all__ = ["CANARY", "POISON", "poison_free", "reset_sanitize_stats",
           "sanitize_stats"]


def poison_free(allocator_cls, state, buf: torch.Tensor, ptr):
    """Free ``ptr`` in ``state`` and stamp its block's words in ``buf`` (the
    buffer the heap offsets index) with :data:`POISON`.  Returns
    ``(state, buf)``.  The block's extent comes from ``find_obj`` before
    the free; an unknown pointer poisons nothing (the free is still
    attempted).  Tensor ops only: nothing is read back to the host."""
    found, base, size = allocator_cls.find_obj(state, ptr)
    state = allocator_cls.free(state, ptr)
    idx = torch.arange(buf.shape[0], device=buf.device)
    inside = found & (idx >= base) & (idx < base + size)
    poison = torch.full((), int(POISON), dtype=buf.dtype, device=buf.device)
    return state, torch.where(inside, poison, buf)
