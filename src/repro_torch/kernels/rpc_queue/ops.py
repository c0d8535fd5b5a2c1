"""The batched queue's enqueue as a custom op: ``torch.ops.repro_torch.
rpc_enqueue``.

``rpc_enqueue(state, arrivals, geometry, header, args, srcs, where)``
appends one record to the queue whose int32 words are ``state`` and
returns its ticket.  ``geometry`` places the lanes in ``state``
(:func:`geometry`); ``header``, ``args``, ``srcs`` and ``where`` are a
:class:`~repro_torch.kernels.rpc_queue.ref.Record` in the op's types
(:func:`enqueue` flattens one).  The CUDA kernel is the ctypes launch
(``kernel.py::rpc_enqueue``, which packs the kernel's parameters from
the lists through the packing code that a queue's enqueue plan uses, and
where its launch counter counts), the CPU kernel the plain version
(``ref.py::enqueue_reference``), the fake kernel the ticket's shape.  It
mutates ``state`` and ``arrivals`` and is marked side-effectful.  The op
is defined with ``torch.library.Library`` (schema, then a kernel a
device), not ``custom_op``: its Python wrapper's handling of mutated
arguments cost the enqueue ~190 us of host time on the card's host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import OPS_NAMESPACE, traced_stack
from repro_torch.kernels.rpc_queue.kernel import ARG_WORDS, rpc_enqueue
from repro_torch.kernels.rpc_queue.ref import (Arg, Lanes, Record,
                                               enqueue_reference)


def geometry(capacity: int, width: int, payload_capacity: int, rslots: int,
             offsets: Dict[str, int]) -> List[int]:
    """A queue's ``geometry`` argument: its sizes, then the word offset in
    ``state`` of each :class:`Lanes` field, in the tuple's order."""
    return [capacity, width, payload_capacity, rslots] + [
        offsets[name] for name in Lanes._fields]


def lanes_of(state: torch.Tensor, geom: Sequence[int]) -> Lanes:
    """The :class:`Lanes` views of ``state`` that ``geom`` places."""
    N, W, PC, R = geom[:4]
    shapes = {"ivals": (N, W), "fvals": (N, W), "plens": (N, W),
              "pbuf": (PC,), "rwant": (R,), "head": (), "phead": (),
              "adrops": (), "base": ()}
    views = []
    for name, at in zip(Lanes._fields, geom[4:]):
        shape = shapes.get(name, (N,))
        n = 1
        for d in shape:
            n *= d
        v = state[at:at + n].view(shape)
        views.append(v.view(torch.float32) if name == "fvals" else v)
    return Lanes(*views)


def _record(header: Sequence[int], args: Sequence[int],
            srcs: Sequence[Optional[torch.Tensor]],
            where: Optional[torch.Tensor]) -> Record:
    callee, imask, pmask, rwant, npay, sanitize, where_mode, const = header
    rargs = [Arg(args[j], bool(args[j + 1]), args[j + 2], src, args[j + 3],
                 args[j + 4])
             for j, src in zip(range(0, len(args), ARG_WORDS), srcs)]
    w = None if where_mode == 0 else bool(const) if where_mode == 1 \
        else where
    return Record(callee, imask, pmask, rwant, npay, rargs, w,
                  bool(sanitize))


_LIB = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
_LIB.define("rpc_enqueue(Tensor(a!) state, Tensor(b!) arrivals, "
            "int[] geometry, int[] header, int[] args, Tensor?[] srcs, "
            "Tensor? where) -> Tensor")


def _cpu(state, arrivals, geometry, header, args, srcs, where):
    return enqueue_reference(lanes_of(state, geometry),
                             _record(header, args, srcs, where))


def _cuda(state, arrivals, geometry, header, args, srcs, where):
    return rpc_enqueue(state, geometry, arrivals, header, args, srcs, where)


def _fake(state, arrivals, geometry, header, args, srcs, where):
    return state.new_empty((), dtype=torch.int32)


_LIB.impl("rpc_enqueue", _cpu, "CPU")
_LIB.impl("rpc_enqueue", _cuda, "CUDA")
torch.library.register_fake(f"{OPS_NAMESPACE}::rpc_enqueue", _fake,
                            lib=_LIB)
_OP = torch.ops.repro_torch.rpc_enqueue.default
torch.fx.node.has_side_effect(_OP)


def flatten(rec: Record) -> Tuple[List[int], List[int],
                                  List[Optional[torch.Tensor]],
                                  Optional[torch.Tensor]]:
    """``rec`` as the op's ``header``, ``args``, ``srcs`` and ``where``."""
    if rec.where is None:
        mode, const, where = 0, 0, None
    elif isinstance(rec.where, bool):
        mode, const, where = 1, int(rec.where), None
    else:
        mode, const, where = 2, 0, rec.where
    header = [rec.callee, rec.imask, rec.pmask, rec.rwant, rec.npay,
              int(rec.sanitize), mode, const]
    args: List[int] = []
    for a in rec.args:
        args += [a.kind, int(a.is_int), a.word, a.offset, a.length]
    return header, args, [a.src for a in rec.args], where


def enqueue(state: torch.Tensor, arrivals: torch.Tensor,
            geom: Sequence[int], rec: Record) -> torch.Tensor:
    """Append ``rec`` through the op; returns the ticket."""
    header, args, srcs, where = flatten(rec)
    with traced_stack():
        return _OP(state, arrivals, list(geom), header, args, srcs, where)
