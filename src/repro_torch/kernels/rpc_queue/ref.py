"""Plain PyTorch version of the batched queue's enqueue (one record).

The JAX package's ``RpcQueue._enqueue`` (``repro/core/rpc.py``) is about
thirty array updates that XLA fuses into the jitted program: row selects
under ``where``, the payloads' ``dynamic_update_slice``s and the head
bumps.  :func:`enqueue_reference` makes the same updates with tensor ops
on any device, in place, and reads nothing back to the host, so it is also
sync-free on a card.  A CPU queue runs it; a CUDA queue launches the
``rpc_enqueue`` kernel (``kernel.py``) instead, and the two are held equal
bit for bit by ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Union

import torch

I32 = torch.int32

#: The word a sanitized queue writes on both sides of each payload
#: reservation (JAX's ``CANARY``, ``repro/core/rpc.py``).
CANARY = 0x7FC0FFEE

#: Kinds of a record argument: a lane value known to the host (a Python
#: number), a 0-d tensor read on the device, an array in the payload arena.
IMMEDIATE, DEVICE, PAYLOAD = 0, 1, 2


class Lanes(NamedTuple):
    """Views of one queue's state that an enqueue reads and writes (see
    ``core/rpc.py::RpcQueue``): the row lanes, the arena, the heads, the
    reply-declaration lane (0 words on a reply-less queue) and ``base``."""
    callee: torch.Tensor     # (N,) int32
    nargs: torch.Tensor      # (N,) int32
    imask: torch.Tensor      # (N,) int32
    pmask: torch.Tensor      # (N,) int32
    ivals: torch.Tensor      # (N, W) int32
    fvals: torch.Tensor      # (N, W) float32 (int32 storage)
    plens: torch.Tensor      # (N, W) int32
    pbuf: torch.Tensor       # (PC,) int32
    head: torch.Tensor       # () int32
    phead: torch.Tensor      # () int32
    adrops: torch.Tensor     # () int32
    rwant: torch.Tensor      # (N,) or (0,) int32
    base: torch.Tensor       # () int32


@dataclasses.dataclass
class Arg:
    """One argument of a record.  ``word`` is an immediate's 32 bits (an
    int32 value or a float32's bits), ``src`` a device scalar or a payload
    (contiguous, its own dtype), ``offset`` a payload's words into the
    record's reservation."""
    kind: int
    is_int: bool
    word: int = 0
    src: Optional[torch.Tensor] = None
    offset: int = 0
    length: int = 0


@dataclasses.dataclass
class Record:
    """What one enqueue writes: the callee id, ``imask``/``pmask`` bits,
    the declared reply words (``+n`` int32, ``-n`` float32, 0 none), the
    payload words in all, the arguments, ``where`` (None, a Python bool
    or a 0-d bool tensor on the queue's device) and ``sanitize``: each
    payload's reservation (at its ``offset``) is then ``[CANARY][words]
    [CANARY]``, its descriptor points one word in, and ``npay`` counts the
    canaries."""
    callee: int
    imask: int
    pmask: int
    rwant: int
    npay: int
    args: List[Arg]
    where: Union[None, bool, torch.Tensor] = None
    sanitize: bool = False


def payload_words(t: torch.Tensor) -> torch.Tensor:
    """An array argument as int32 arena words, JAX's ``_payload_words``:
    integer and bool values as int32, floats (bf16 and f16 included) as
    float32 bitcast to int32."""
    flat = t.reshape(-1)
    if flat.dtype.is_floating_point:
        return flat.to(torch.float32).view(I32)
    return flat.to(I32)


def scalar_bits(t: torch.Tensor, is_int: bool) -> torch.Tensor:
    """A 0-d argument's lane value as int32 bits."""
    if is_int:
        return t.to(I32)
    return t.to(torch.float32).view(I32)


def enqueue_reference(q: Lanes, rec: Record) -> torch.Tensor:
    """Append ``rec`` to the queue ``q`` in place; returns the ticket (a 0-d
    int32 tensor: ``base + head``, or -1 when the record was dropped).

    As JAX's ``_enqueue``: ``keep`` is ``where`` and, for a record with
    payloads, whether all of them fit the arena (an atomic drop otherwise,
    counted in ``adrops``); a kept record's payloads go to ``phead`` plus
    their static offsets (canary-bracketed when ``rec.sanitize``) and its
    row to ``head % capacity`` (overwriting the oldest record when the
    ring is full); a dropped one changes nothing else."""
    dev = q.head.device
    cap, width = q.callee.shape[0], q.ivals.shape[1]
    pc = q.pbuf.shape[0]
    san = int(rec.sanitize)
    head, phead = q.head.clone(), q.phead.clone()
    if rec.where is None:
        keep = torch.ones((), dtype=torch.bool, device=dev)
    elif isinstance(rec.where, bool):
        keep = torch.full((), rec.where, dtype=torch.bool, device=dev)
    else:
        keep = rec.where.to(torch.bool)
    dropped = None
    if rec.npay:
        fits = phead + rec.npay <= pc
        dropped = keep & ~fits
        keep = keep & fits
    iv = torch.zeros(width, dtype=I32, device=dev)
    fv = torch.zeros(width, dtype=I32, device=dev)      # float32 bits
    pl = torch.zeros(width, dtype=I32, device=dev)
    # element views filled in place: ``t[j] = number`` would copy a host
    # scalar to the card and synchronise
    for j, a in enumerate(rec.args):
        lane = iv if a.is_int or a.kind == PAYLOAD else fv
        if a.kind == IMMEDIATE:
            lane[j].fill_(a.word - (1 << 32) if a.word >= 1 << 31 else a.word)
        elif a.kind == DEVICE:
            lane[j].copy_(scalar_bits(a.src, a.is_int))
        else:
            iv[j].copy_(phead + a.offset + san)
            pl[j].fill_(a.length)
            words = payload_words(a.src)
            if san:
                can = torch.full((1,), CANARY, dtype=I32, device=dev)
                words = torch.cat([can, words, can])
            n = words.shape[0]
            # JAX's dynamic_update_slice clamps the start; a dropped record
            # writes the old words back
            start = (phead + a.offset).clamp(0, pc - n).long()
            idx = start + torch.arange(n, device=dev)
            old = q.pbuf.index_select(0, idx)
            q.pbuf.index_copy_(0, idx, torch.where(keep, words, old))
    i = torch.remainder(head, cap).long().view(1)

    def put(lane: torch.Tensor, new: torch.Tensor) -> None:
        lane.index_copy_(0, i, torch.where(keep, new, lane.index_select(0, i)))

    def full(v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=I32, device=dev)

    put(q.callee, full(rec.callee))
    put(q.nargs, full(len(rec.args)))
    put(q.imask, full(rec.imask))
    put(q.pmask, full(rec.pmask))
    put(q.ivals, iv.view(1, width))
    put(q.fvals.view(I32), fv.view(1, width))
    put(q.plens, pl.view(1, width))
    if q.rwant.shape[0]:
        put(q.rwant, full(rec.rwant))
    ticket = torch.where(keep, q.base + head, torch.full_like(head, -1))
    step = keep.to(I32)
    q.head.add_(step)
    if rec.npay:
        q.phead.add_(step * rec.npay)
        q.adrops.add_(dropped.to(I32))
    return ticket
