"""Worst-case multiplicity math over event scope stacks.

The port of ``repro/analysis/capacity.py``, as it is.

An event traced ONCE inside a loop body executes ``trips`` times; inside a
conditional region it executes at most every ``period`` iterations.  The
capacity proof needs "how many times does this enqueue execute per flush
EPOCH" — which is the enqueue's execution count relative to the flush that
drains it, i.e. over the scope frames the two do NOT share:

* shared frames cancel (an enqueue and a flush in the same loop body drain
  once per iteration — per-iteration epochs, no multiplication);
* unshared ``loop`` frames multiply by their trip count (``None`` =
  statically unbounded -> ``inf``);
* unshared ``cond`` frames divide (ceil) by their declared period —
  a plain conditional (period ``None``) may fire every time, so it
  divides by 1: the worst case stands.

Frames carry trace-unique uids, so "same frame" means the same loop
INSTANCE, not a look-alike.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

ScopeFrame = Tuple[str, int, object]


def common_prefix(a: Sequence[ScopeFrame], b: Sequence[ScopeFrame]) -> int:
    n = 0
    for fa, fb in zip(a, b):
        if fa != fb:
            break
        n += 1
    return n


def multiplicity(event_scopes: Sequence[ScopeFrame],
                 anchor_scopes: Sequence[ScopeFrame] = ()) -> float:
    """Worst-case executions of an event per execution of an anchor
    (a flush epoch, or the program when the anchor is empty).  Returns a
    float so ``inf`` (unbounded loop) flows through comparisons."""
    rest = event_scopes[common_prefix(event_scopes, anchor_scopes):]
    n: float = 1.0
    for kind, _uid, val in rest:
        if kind == "loop":
            n = math.inf if val is None else n * max(int(val), 0)
        elif kind == "cond":
            period = 1 if val is None else max(int(val), 1)
            if n != math.inf:
                n = math.ceil(n / period)
    return n


def fmt_count(n: float) -> str:
    return "unbounded" if n == math.inf else str(int(n))
