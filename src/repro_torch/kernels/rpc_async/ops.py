"""The async queue's two launches as custom ops: ``torch.ops.repro_torch.
rpc_async_post`` and ``rpc_async_collect``.

Both update the words of ``state`` (a queue's, ``(words,)``, or a sharded
queue's, ``(rows, words)``) from ``out_start`` on.

* ``rpc_async_post(state, ring, epoch, out_start, has_reply)`` hands
  epoch ``epoch`` to the host through ring ``ring`` (an
  :attr:`AsyncRing.id`) and moves the windows;
* ``rpc_async_collect(state, ring, epoch, out_start, rslots, rc,
  deadline, words)`` installs epoch ``epoch - 1``'s replies.

The CUDA kernels are the ctypes launches (``kernel.py``, where the launch
counters count; ``words`` is None there, the replies come through the
ring), the CPU kernels the plain versions (``ref.py``) row by row, where
``ring`` and ``epoch`` are unused and ``words`` holds each row's reply
words (``(n,)`` or ``(rows, n)``: the host drain's answer).  The fake
kernels do nothing.  Each mutates ``state`` and is marked
side-effectful.  The ops are defined with ``torch.library.Library`` (as
``rpc_enqueue``, see ``kernels/rpc_queue/ops.py``).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.kernels import OPS_NAMESPACE, traced_stack
from repro_torch.kernels.rpc_async.kernel import (ring_by_id,
                                                  rpc_async_collect,
                                                  rpc_async_post)
from repro_torch.kernels.rpc_async.ref import (collect_reference,
                                               post_reference)


def _rows(state: torch.Tensor) -> List[torch.Tensor]:
    return [state] if state.dim() == 1 else list(state)


def post_plain(state: torch.Tensor, out_start: int, has_reply: bool) -> None:
    """``rpc_async_post``'s plain version on every row of ``state``."""
    for row in _rows(state):
        post_reference(row[out_start:], has_reply)


def collect_plain(state: torch.Tensor, out_start: int,
                  words: torch.Tensor) -> None:
    """``rpc_async_collect``'s plain version: row d of ``state`` gets row d
    of ``words``."""
    words = words.to(state.device)
    for row, w in zip(_rows(state), _rows(words)):
        collect_reference(row[out_start:], w)


_LIB = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
_LIB.define("rpc_async_post(Tensor(a!) state, int ring, int epoch, "
            "int out_start, bool has_reply) -> ()")
_LIB.define("rpc_async_collect(Tensor(a!) state, int ring, int epoch, "
            "int out_start, int rslots, int rc, float? deadline, "
            "Tensor? words) -> ()")


def _post_cpu(state, ring, epoch, out_start, has_reply):
    post_plain(state, out_start, has_reply)


def _post_cuda(state, ring, epoch, out_start, has_reply):
    rpc_async_post(ring_by_id(ring), epoch, state, out_start, has_reply)


def _collect_cpu(state, ring, epoch, out_start, rslots, rc, deadline, words):
    if words is None:
        raise ValueError("rpc_async_collect: a CPU queue's collect takes "
                         "the drain's reply words")
    collect_plain(state, out_start, words)


def _collect_cuda(state, ring, epoch, out_start, rslots, rc, deadline,
                  words):
    rpc_async_collect(ring_by_id(ring), epoch, state, out_start, rslots, rc,
                      deadline)


def _nothing(*args):
    return None


for _name, _cpu, _cuda in (("rpc_async_post", _post_cpu, _post_cuda),
                           ("rpc_async_collect", _collect_cpu,
                            _collect_cuda)):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{OPS_NAMESPACE}::{_name}", _nothing,
                                lib=_LIB)
_POST = torch.ops.repro_torch.rpc_async_post.default
_COLLECT = torch.ops.repro_torch.rpc_async_collect.default
for _op in (_POST, _COLLECT):
    torch.fx.node.has_side_effect(_op)


def async_post(state: torch.Tensor, ring: int, epoch: int, out_start: int,
               has_reply: bool) -> None:
    with traced_stack():
        _POST(state, ring, epoch, out_start, has_reply)


def async_collect(state: torch.Tensor, ring: int, epoch: int,
                  out_start: int, rslots: int, rc: int,
                  deadline: Optional[float],
                  words: Optional[torch.Tensor] = None) -> None:
    with traced_stack():
        _COLLECT(state, ring, epoch, out_start, rslots, rc,
                 None if deadline is None else float(deadline), words)
