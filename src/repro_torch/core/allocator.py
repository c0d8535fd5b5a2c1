"""Heap allocators (paper §3.4) on device tensors.

The port of ``repro/core/allocator.py``:

* :class:`GenericAllocator`: one global allocation list with first-fit
  reuse (the heap behind the RPC layer's ``ArenaRef`` and
  ``libc.realloc``); ``malloc_many``/``free_many`` are the prefix-sum and
  sorted-lookup bulk paths, the ``*_serial`` ones their request-by-request
  contrast (JAX's ``lax.scan``, a Python loop here).
* :class:`SizeClassAllocator`: the segregated heap: the generic layout
  plus power-of-two class bins of free entries (one bit per entry), with
  ``coalesce`` of adjacent free holes and splitting of an oversized hole.
* :class:`BalancedAllocator`: the serving engine's page heap: N (thread
  slots) x M (team slots) chunks, chunk 0 larger by
  ``first_chunk_ratio``, entries a watermark stack per chunk; grid
  requests run in every chunk at once (``malloc_grid``, ``free_grid``),
  the ``*_scan`` paths request by request.
* :class:`ShardedHeap` / :class:`ShardedAllocator`: one inner state per
  device of a mesh, stacked along a leading axis on one device; pointers
  are global (``dev * span + local``); an expanded region's teams each
  work on a copy of their row (``team_local``, gathered after the
  region); ``local_view``/``with_local`` are JAX's one-row protocol.

State lives in device tensors and every operation is torch ops on them:
each ``lax.cond`` of the JAX version becomes a select over both branches,
a write at a computed index a select against an ``arange``, and a read at
one an ``index_select``, so no operation reads a value back to the host
(no ``.item()``, no Python ``if`` on a tensor, no indexing with a 0-d
tensor, which PyTorch turns into ``.item()``).  Results are bit-identical
to the JAX package.  Two consequences of the selects, both deliberate:
``SizeClassAllocator.malloc`` computes its coalescing retry (``coalesce``
and a second search) on every call, where JAX runs it only when the first
search fails; and ``_chunk_free_serial``'s ``while_loop`` is a fixed
``cap`` masked steps.  The class bins keep JAX's uint32 words in int64
(values below 2**32); bit positions come from exact integer compares,
never from a float ``log2``.  A heap event's ``ptr`` is ``None`` for a
CUDA tensor (it would read the device), as JAX emits ``None`` for a
tracer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core import events
from repro_torch.distributed.collectives import gather_blocks
from repro_torch.tree import register_export_node

I32 = torch.int32
I64 = torch.int64
FAIL = -1
#: Offset of entry slots that hold no entry; keeps each chunk's offset table
#: sorted (INT32_MAX).
DEAD = 2 ** 31 - 1
#: Power-of-two size classes cover every positive int32 size.
NCLASSES = 32


def as_i32(x, device) -> torch.Tensor:
    """``x`` as int32 on ``device``.  A Python int is filled on the device
    (``torch.full`` takes it as a kernel argument), since ``as_tensor`` of
    a Python number onto a card is a host-to-device copy that synchronises
    the stream."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I32)
    if isinstance(x, int) or hasattr(x, "__index__"):
        return torch.full((), int(x), dtype=I32, device=device)
    return torch.as_tensor(x, dtype=I32, device=device)


def _concrete_int(x):
    """``int(x)`` for a Python number or a one-element tensor on the host;
    None for a CUDA tensor (an event never reads the device) and for
    anything else, as JAX gives None for a tracer."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu" or x.numel() != 1:
            return None
    try:
        return int(x)
    except Exception:  # noqa: BLE001 (a batched tensor under vmap)
        return None


def _emit_heap(kind: str, st, ptr, **data) -> None:
    """A heap event for :mod:`repro_torch.core.events` subscribers."""
    events.emit(kind, ptr_id=id(ptr), ptr=_concrete_int(ptr),
                heap=getattr(st, "heap_size", None), _refs=(ptr,), **data)


def _tensor_fields(st) -> Tuple[str, ...]:
    """The tensor fields of an allocator state, in declaration order."""
    return tuple(f.name for f in dataclasses.fields(st)
                 if isinstance(getattr(st, f.name), torch.Tensor))


def _select(pred: torch.Tensor, a, b):
    """The state ``a`` where ``pred`` else ``b``, field by field (a
    ``lax.cond`` over two computed branches)."""
    return dataclasses.replace(a, **{
        f: torch.where(pred, getattr(a, f), getattr(b, f))
        for f in _tensor_fields(a)})


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis for a 0-d index tensor, without the
    host read that ``x[idx]`` makes of a 0-d index."""
    return x.index_select(0, idx.reshape(1).long()).squeeze(0)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, in int32 like the JAX code."""
    return torch.cumsum(x, dim=-1, dtype=I32) - x


def _pow2(lo: int, hi: int, device) -> torch.Tensor:
    return 1 << torch.arange(lo, hi, dtype=I64, device=device)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Largest c with 2**c <= max(x, 1), exactly: the count of k in 1..31
    with 2**k <= max(x, 1) (JAX's ``31 - clz``)."""
    m = torch.clamp(x.to(I64), min=1)
    return (m.unsqueeze(-1) >= _pow2(1, 32, x.device)).sum(-1).to(I32)


def _ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """Smallest c with 2**c >= max(x, 1), exactly (JAX's ``32 -
    clz(max(x, 1) - 1)``)."""
    y = torch.clamp(x.to(I64), min=1) - 1
    return (y.unsqueeze(-1) >= _pow2(0, 32, x.device)).sum(-1).to(I32)


def _low_bit(word: torch.Tensor) -> torch.Tensor:
    """Position of the lowest set bit of a 32-bit word held in int64 (0 for
    a zero word), by an exact compare of each bit."""
    bits = (word.unsqueeze(-1) >> torch.arange(32, dtype=I64,
                                               device=word.device)) & 1
    return _first_true(bits.bool()).to(I32)


def _serial_fit_mask(sizes: torch.Tensor, wm: torch.Tensor,
                     limit: torch.Tensor, count: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """Success mask of serially processing each row of ``sizes`` (NC, k)
    against its chunk (``wm``, ``limit``, ``count`` are (NC,)).

    Request i succeeds iff ``wm + sum(successful j<i) + sizes[i] <= limit``,
    ``count + #successful j<i < cap`` and ``sizes[i] > 0``.  That mask is the
    unique fixed point of ``refine``; a pass fixes at least one more prefix
    position, so exactly k passes reach it from any start.  The JAX version
    iterates to the fixed point with a ``while_loop``; a fixed k passes
    needs no read back of a convergence flag.
    """
    positive = sizes > 0
    wm, limit, count = wm[:, None], limit[:, None], count[:, None]

    def refine(m):
        taken = torch.where(m, sizes, 0)
        mi = m.to(I32)
        return positive & (wm + _excl_cumsum(taken) + sizes <= limit) \
            & (count + _excl_cumsum(mi) < cap)

    m = positive
    for _ in range(sizes.shape[-1]):
        m = refine(m)
    return m


def _bulk_watermark_alloc(offsets, sizes, caps, in_use, count, wm, limit,
                          req):
    """Allocate each chunk's row of requests ``req`` (NC, k) from its
    watermark in one shot.  Returns ``(offsets, sizes, caps, in_use, count,
    wm, rel_ptrs)``; ``rel_ptrs`` is chunk-relative or :data:`FAIL`.  Failed
    and skipped (``size <= 0``) requests write to a scratch column that is
    cut off afterwards (the JAX version drops them by out-of-range scatter,
    which torch does not allow)."""
    nc, cap_entries = offsets.shape
    m = _serial_fit_mask(req, wm, limit, count, cap_entries)
    mi = m.to(I32)
    taken = torch.where(m, req, 0)
    rel = wm[:, None] + _excl_cumsum(taken)
    slot = count[:, None] + _excl_cumsum(mi)
    idx = torch.where(m, slot, cap_entries).to(I64)

    def put(table, values):
        pad = torch.cat([table, table.new_zeros((nc, 1))], dim=1)
        return pad.scatter(1, idx, values)[:, :cap_entries]

    offsets = put(offsets, rel)
    sizes = put(sizes, req)
    caps = put(caps, req)
    in_use = put(in_use, torch.ones_like(req))
    return (offsets, sizes, caps, in_use, count + mi.sum(-1, dtype=I32),
            wm + taken.sum(-1, dtype=I32), torch.where(m, rel, FAIL))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry along the last axis (0 if none), int64
    — ``jnp.argmax`` of a boolean array."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[r, idx[r]]`` for each row ``r`` (``idx`` (R,), in range)."""
    return x.gather(1, idx.long()[:, None]).squeeze(1)


def _suffix_reclaim_rows(offsets, in_use, count, wm):
    """Pop every dead entry off the top of each row's entry stack at once
    (rows (R, n), ``count`` and ``wm`` (R,)): the new stack top is one past
    the last live entry, the watermark drops to the first popped entry's
    offset, and popped slots become :data:`DEAD`.  Returns ``(offsets,
    count, wm)``."""
    n = offsets.shape[-1]
    ar = torch.arange(n, device=offsets.device)
    live = (in_use == 1) & (ar < count[:, None])
    last_live = (n - 1 - _first_true(live.flip(-1))).to(I32)
    new_count = torch.where(live.any(-1), last_live + 1, 0).to(I32)
    popped = new_count < count
    new_wm = torch.where(popped, _gather_rows(offsets,
                                              new_count.clamp(0, n - 1)), wm)
    offsets = torch.where(ar >= new_count[:, None], DEAD, offsets)
    return offsets, new_count, new_wm


def _sorted_lookup(offsets, sizes, in_use, count, ptr):
    """O(log cap) containing-object lookup over a sorted offset table (dead
    slots at :data:`DEAD`).  Returns ``(found, base, size)``; ``base`` and
    ``size`` mean something only where ``found``."""
    n = offsets.shape[0]
    j = torch.searchsorted(offsets, ptr, right=True).to(I32) - 1
    idx = j.clamp(0, n - 1)
    base, size = _at(offsets, idx), _at(sizes, idx)
    found = (j >= 0) & (j < count) & (_at(in_use, idx) == 1) \
        & (ptr < base + size)
    return found, base, size


def _sorted_exact(offsets, in_use, count, ptr):
    """O(log cap) exact-base lookup: ``(hit, idx)`` of the live entry whose
    offset equals ``ptr`` (one pointer or a 1-D batch of them)."""
    n = offsets.shape[0]
    j = torch.searchsorted(offsets, ptr).to(I32)
    idx = j.clamp(0, n - 1).long()
    hit = (j < count) & (torch.take(offsets, idx) == ptr) \
        & (torch.take(in_use, idx) == 1)
    return hit, idx


def _freed_mask_rows(offsets, in_use, count, limit, ptrs):
    """Per-entry freed mask of each row (offsets (R, n); ``count`` and
    ``limit`` (R,)) for its batch of pointers ``ptrs`` (R, k): one sorted
    exact lookup each, scattered back to entry space.  Invalid and
    unmatched pointers contribute nothing."""
    n = offsets.shape[-1]
    valid = (ptrs >= 0) & (ptrs < limit[:, None])
    j = torch.searchsorted(offsets.contiguous(), ptrs.contiguous()).to(I32)
    idx = j.clamp(0, n - 1).long()
    hit = (j < count[:, None]) & (offsets.gather(1, idx) == ptrs) \
        & (in_use.gather(1, idx) == 1) & valid
    slot = torch.where(hit, idx, n)
    mask = torch.zeros((offsets.shape[0], n + 1), dtype=torch.bool,
                       device=offsets.device)
    return mask.scatter(1, slot, True)[:, :n]


def _bulk_freed_mask(offsets, in_use, count, limit, ptrs):
    """:func:`_freed_mask_rows` of one table and a 1-D batch of pointers."""
    limit = as_i32(limit, offsets.device)
    return _freed_mask_rows(offsets[None], in_use[None], count.reshape(1),
                            limit.reshape(1), ptrs.reshape(1, -1))[0]


# ---------------------------------------------------------------------------
# Generic allocator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GenericState:
    offsets: torch.Tensor   # (CAP,) i32 — sorted; DEAD beyond count
    sizes: torch.Tensor     # (CAP,) i32 — requested size (find_obj reports it)
    caps: torch.Tensor      # (CAP,) i32 — block capacity (reuse fit checks)
    in_use: torch.Tensor    # (CAP,) i32 (0/1)
    count: torch.Tensor     # () i32 — entries ever created (stack top)
    watermark: torch.Tensor  # () i32
    heap_size: int


#: The tensor fields of :class:`GenericState`, in declaration order.
GENERIC_FIELDS = ("offsets", "sizes", "caps", "in_use", "count", "watermark")


def _bump(st, size: torch.Tensor, ok: torch.Tensor):
    """``st`` with a new entry of ``size`` at the watermark where ``ok``
    (a flat heap's stack-top allocation), and its pointer or FAIL."""
    ar = torch.arange(st.offsets.shape[0], device=st.count.device)
    at = ok & (ar == st.count)
    out = dataclasses.replace(
        st,
        offsets=torch.where(at, st.watermark, st.offsets),
        sizes=torch.where(at, size, st.sizes),
        caps=torch.where(at, size, st.caps),
        in_use=torch.where(at, 1, st.in_use),
        count=st.count + ok.to(I32),
        watermark=st.watermark + torch.where(ok, size, 0))
    return out, torch.where(ok, st.watermark, FAIL).to(I32)


class GenericAllocator:
    """One global allocation list with first-fit reuse of freed entries
    (the paper's single-lock design), with the sorted-offset ``find_obj``
    and ``free`` and the prefix-sum bulk ``malloc_many``."""

    @staticmethod
    def init(heap_size: int, cap: int = 4096, *, device) -> GenericState:
        def z():
            return torch.zeros((cap,), dtype=I32, device=device)

        return GenericState(
            torch.full((cap,), DEAD, dtype=I32, device=device), z(), z(), z(),
            torch.zeros((), dtype=I32, device=device),
            torch.zeros((), dtype=I32, device=device), heap_size)

    @staticmethod
    def malloc(st: GenericState, size) -> Tuple[GenericState, torch.Tensor]:
        """First fit over freed entries (capacity decides), else a bump of
        the watermark, else :data:`FAIL`."""
        size_t = as_i32(size, st.count.device)
        cap = st.offsets.shape[0]
        ar = torch.arange(cap, device=st.count.device)
        reusable = (st.in_use == 0) & (st.caps >= size_t) & (ar < st.count) \
            & (size_t > 0)
        reuse = reusable.any()
        at_reuse = reuse & (ar == _first_true(reusable))
        bump = ~reuse & (size_t > 0) \
            & (st.watermark + size_t <= st.heap_size) & (st.count < cap)
        bumped, bump_ptr = _bump(st, size_t, bump)
        reused_at = torch.where(at_reuse, st.offsets, 0).sum(dtype=I32)
        out = dataclasses.replace(
            bumped,
            sizes=torch.where(at_reuse, size_t, bumped.sizes),
            in_use=torch.where(at_reuse, 1, bumped.in_use))
        ptr = torch.where(reuse, reused_at, bump_ptr).to(I32)
        if events.active():
            _emit_heap("heap_malloc", st, ptr, size=_concrete_int(size))
        return out, ptr

    @staticmethod
    def free(st: GenericState, ptr) -> GenericState:
        """Mark the entry at ``ptr`` free; FAIL, wild and already-free
        pointers are no-ops."""
        if events.active():
            _emit_heap("heap_free", st, ptr)
        ptr = as_i32(ptr, st.count.device)
        valid = (ptr >= 0) & (ptr < st.heap_size)
        hit, idx = _sorted_exact(st.offsets, st.in_use, st.count, ptr)
        ar = torch.arange(st.offsets.shape[0], device=st.count.device)
        return dataclasses.replace(
            st, in_use=torch.where(hit & valid & (ar == idx), 0, st.in_use))

    @staticmethod
    def find_obj(st: GenericState, ptr
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The paper's ``_FindObj``: (found, base, size) of the object that
        contains ``ptr``, by binary search of the sorted offsets."""
        ptr = as_i32(ptr, st.count.device)
        valid = (ptr >= 0) & (ptr < st.heap_size)
        found, base, size = _sorted_lookup(st.offsets, st.sizes, st.in_use,
                                           st.count, ptr)
        return found & valid, base, size

    @staticmethod
    def malloc_many(st: GenericState, sizes
                    ) -> Tuple[GenericState, torch.Tensor]:
        """Prefix-sum bulk allocation from the watermark, identical to a
        serial scan of single mallocs on fresh space; never reuses holes."""
        sizes = as_i32(sizes, st.count.device)
        lim = torch.full((1,), st.heap_size, dtype=I32,
                         device=st.count.device)
        out = _bulk_watermark_alloc(
            st.offsets[None], st.sizes[None], st.caps[None], st.in_use[None],
            st.count[None], st.watermark[None], lim, sizes[None])
        offsets, szs, caps, in_use, count, wm, ptrs = (t[0] for t in out)
        return dataclasses.replace(
            st, offsets=offsets, sizes=szs, caps=caps, in_use=in_use,
            count=count, watermark=wm), ptrs

    @staticmethod
    def free_many(st: GenericState, ptrs) -> GenericState:
        """Bulk free: one sorted lookup a pointer (FAIL and unmatched
        pointers are no-ops)."""
        freed = _bulk_freed_mask(st.offsets, st.in_use, st.count,
                                 st.heap_size, as_i32(ptrs, st.count.device))
        return dataclasses.replace(st, in_use=torch.where(freed, 0,
                                                          st.in_use))

    # -- the serial contrast (JAX's lax.scan; a request at a time here) ----
    @staticmethod
    def malloc_many_serial(st: GenericState, sizes
                           ) -> Tuple[GenericState, torch.Tensor]:
        """:meth:`malloc` of each size in turn (hole reuse included)."""
        ptrs = []
        for size in as_i32(sizes, st.count.device).unbind(0):
            st, p = GenericAllocator.malloc(st, size)
            ptrs.append(p)
        return st, torch.stack(ptrs) if ptrs else \
            torch.zeros((0,), dtype=I32, device=st.count.device)

    @staticmethod
    def free_many_serial(st: GenericState, ptrs) -> GenericState:
        for p in as_i32(ptrs, st.count.device).unbind(0):
            st = GenericAllocator.free(st, p)
        return st


# ---------------------------------------------------------------------------
# Size-class allocator: segregated power-of-two bins of free entries
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SizeClassState:
    offsets: torch.Tensor    # (CAP,) i32 — sorted; DEAD beyond count
    sizes: torch.Tensor      # (CAP,) i32 — requested size
    caps: torch.Tensor       # (CAP,) i32 — block capacity
    in_use: torch.Tensor     # (CAP,) i32
    free_bits: torch.Tensor  # (NCLASSES, ceil(CAP/32)) int64 holding JAX's
    #                          uint32 words: bit e%32 of word e//32 of class
    #                          c set <=> entry e is free and in class c
    count: torch.Tensor      # () i32
    watermark: torch.Tensor  # () i32
    heap_size: int


#: The tensor fields of :class:`SizeClassState`, in declaration order.
SIZECLASS_FIELDS = ("offsets", "sizes", "caps", "in_use", "free_bits",
                    "count", "watermark")


def _bins(is_free: torch.Tensor, caps: torch.Tensor, nwords: int
          ) -> torch.Tensor:
    """Class bins built from scratch: entry e's bit in class
    ``floor_log2(caps[e])`` where ``is_free``.  Each entry owns a distinct
    bit of its (class, word) cell, so a scatter-add is an OR."""
    return _add_bins(torch.zeros((NCLASSES, nwords), dtype=I64,
                                 device=caps.device), is_free, caps)


def _add_bins(free_bits, is_free, caps):
    """``free_bits`` with entry e's bit set where ``is_free`` (its bit is
    clear before)."""
    e = torch.arange(caps.shape[0], device=caps.device)
    nwords = free_bits.shape[1]
    contrib = torch.where(is_free, 1 << (e % 32), 0)
    cell = _floor_log2(caps).to(I64) * nwords + e // 32
    return free_bits.reshape(-1).scatter_add(0, cell, contrib).view(
        NCLASSES, nwords)


def _set_word(free_bits: torch.Tensor, c, w, word) -> torch.Tensor:
    """``free_bits`` with cell (c, w) (0-d tensors) set to ``word``."""
    nwords = free_bits.shape[1]
    flat = free_bits.reshape(-1)
    at = torch.arange(flat.shape[0], device=flat.device) == c.to(I64) \
        * nwords + w
    return torch.where(at, word, flat).view(NCLASSES, nwords)


def _cell(free_bits: torch.Tensor, c, w) -> torch.Tensor:
    return _at(free_bits.reshape(-1), c.to(I64) * free_bits.shape[1] + w)


class SizeClassAllocator:
    """The segregated heap: the generic single list plus class bins.

    A freed block of capacity in ``[2^c, 2^(c+1))`` sets its entry's bit in
    class c.  ``malloc`` searches the first non-empty class at or above
    ``ceil_log2(size)`` (every block there fits), then the lowest set bit
    names the entry; a hole more than a class larger than the request is
    split, the rest re-binned as a free entry (:meth:`_take_entry`).  When
    both the bins and the watermark fail, :meth:`coalesce` merges adjacent
    free holes and an exact first fit retries.  On the card that retry is
    a select: it runs on every call."""

    @staticmethod
    def init(heap_size: int, cap: int = 4096, *, device) -> SizeClassState:
        def z():
            return torch.zeros((cap,), dtype=I32, device=device)

        nwords = (cap + 31) // 32
        return SizeClassState(
            torch.full((cap,), DEAD, dtype=I32, device=device), z(), z(), z(),
            torch.zeros((NCLASSES, nwords), dtype=I64, device=device),
            torch.zeros((), dtype=I32, device=device),
            torch.zeros((), dtype=I32, device=device), heap_size)

    @staticmethod
    def coalesce(st: SizeClassState) -> SizeClassState:
        """Merge every maximal run of spatially adjacent free holes into its
        first entry, compact the table (sorted, DEAD beyond count), rebuild
        the bins from the merged capacities, and pull the watermark down
        when the topmost merged hole touches it.  O(cap), no loop."""
        dev = st.count.device
        cap = st.offsets.shape[0]
        nwords = st.free_bits.shape[1]
        e = torch.arange(cap, device=dev)
        valid = e < st.count
        freeb = valid & (st.in_use == 0)
        no = torch.zeros((1,), dtype=torch.bool, device=dev)
        prev_free = torch.cat([no, freeb[:-1]])
        prev_end = torch.cat([torch.zeros((1,), dtype=I32, device=dev),
                              (st.offsets + st.caps)[:-1]])
        run_start = freeb & ~(prev_free & (st.offsets == prev_end))
        run = torch.cumsum(run_start.to(I32), 0, dtype=I32) - 1
        merged = torch.zeros((cap + 1,), dtype=I32, device=dev).scatter_add(
            0, torch.where(freeb, run, cap).to(I64),
            torch.where(freeb, st.caps, 0))[:cap]
        keep = (valid & (st.in_use == 1)) | run_start
        dst = torch.where(keep, torch.cumsum(keep.to(I32), 0) - 1,
                          cap).to(I64)
        count = keep.to(I32).sum(dtype=I32)
        caps_src = torch.where(run_start,
                               merged.index_select(0, run.clamp(0, cap - 1)),
                               st.caps)

        def place(fill, src):
            pad = torch.full((cap + 1,), fill, dtype=src.dtype, device=dev)
            return pad.scatter(0, dst, src)[:cap]

        offsets = place(DEAD, st.offsets)
        sizes = place(0, torch.where(freeb, 0, st.sizes))
        caps = place(0, caps_src)
        in_use = place(0, st.in_use)
        is_free = place(False, run_start)
        top = torch.clamp(count - 1, min=0)
        top_free = (count > 0) & _at(is_free, top) \
            & (_at(offsets, top) + _at(caps, top) == st.watermark)
        wm = torch.where(top_free, _at(offsets, top), st.watermark)
        drop = top_free & (e == top)
        offsets = torch.where(drop, DEAD, offsets)
        sizes = torch.where(drop, 0, sizes)
        caps = torch.where(drop, 0, caps)
        is_free = is_free & ~drop
        count = torch.where(top_free, count - 1, count)
        return dataclasses.replace(
            st, offsets=offsets, sizes=sizes, caps=caps, in_use=in_use,
            free_bits=_bins(is_free, caps, nwords), count=count,
            watermark=wm)

    @staticmethod
    def malloc(st: SizeClassState, size
               ) -> Tuple[SizeClassState, torch.Tensor]:
        """Bin reuse, else a watermark bump; where both fail for a positive
        size, coalesce and retry with an exact first fit (see the class
        docstring)."""
        st2, ptr = SizeClassAllocator._malloc_with_retry(
            st, as_i32(size, st.count.device))
        if events.active():
            _emit_heap("heap_malloc", st, ptr, size=_concrete_int(size))
        return st2, ptr

    @staticmethod
    def _malloc_with_retry(st: SizeClassState, size: torch.Tensor
                           ) -> Tuple[SizeClassState, torch.Tensor]:
        # JAX's lax.cond runs the retry only on a failure; choosing would
        # read the device, so both branches run and a select keeps one
        st1, ptr = SizeClassAllocator._malloc_once(st, size)
        need_retry = (ptr == FAIL) & (size > 0)
        st2, ptr2 = SizeClassAllocator._malloc_fallback(
            SizeClassAllocator.coalesce(st), size)
        return _select(need_retry, st2, st1), torch.where(need_retry, ptr2,
                                                          ptr)

    @staticmethod
    def _take_entry(st: SizeClassState, e: torch.Tensor, size: torch.Tensor
                    ) -> Tuple[SizeClassState, torch.Tensor]:
        """Claim free entry ``e`` for a ``size``-word request, splitting the
        block when its capacity overshoots the request's class: the caller
        keeps ``min(cap_e, 2^ceil_log2(size))`` words and the rest becomes a
        free entry at ``e + 1`` (the table stays sorted), re-binned under
        its own class.  No split when the table is full."""
        dev = st.count.device
        cap = st.offsets.shape[0]
        nwords = st.free_bits.shape[1]
        e = e.to(I32)
        blk = _at(st.caps, e)
        cls = (1 << _ceil_log2(size).to(I64)).to(I32)
        keep = torch.minimum(blk, torch.maximum(size, cls))
        rem = blk - keep
        do_split = (rem > 0) & (st.count < cap)
        idx = torch.arange(cap, device=dev)
        at_e = idx == e

        # plain: the whole block, its bit cleared
        c = _floor_log2(blk)
        w, b = e // 32, (e % 32).to(I64)
        word = _cell(st.free_bits, c, w) & ~(1 << b)
        plain = dataclasses.replace(
            st, sizes=torch.where(at_e, size, st.sizes),
            in_use=torch.where(at_e, 1, st.in_use),
            free_bits=_set_word(st.free_bits, c, w, word))

        # split: entries above e move up one slot
        up, new = idx > e + 1, idx == e + 1
        src = torch.clamp(idx - 1, 0, cap - 1)

        def shifted(a, ins):
            return torch.where(up, a.index_select(0, src),
                               torch.where(new, ins, a))

        offsets = shifted(st.offsets, _at(st.offsets, e) + keep)
        sizes = torch.where(at_e, size, shifted(st.sizes, 0))
        caps = shifted(torch.where(at_e, keep, st.caps), rem)
        in_use = torch.where(at_e, 1, shifted(st.in_use, 0))
        count = st.count + 1
        split = dataclasses.replace(
            st, offsets=offsets, sizes=sizes, caps=caps, in_use=in_use,
            free_bits=_bins((idx < count) & (in_use == 0), caps, nwords),
            count=count)
        return _select(do_split, split, plain), _at(st.offsets, e)

    @staticmethod
    def _malloc_fallback(st: SizeClassState, size: torch.Tensor
                         ) -> Tuple[SizeClassState, torch.Tensor]:
        """After coalescing: exact first fit over the free entries, else the
        regular class search and watermark bump."""
        cap = st.offsets.shape[0]
        ar = torch.arange(cap, device=st.count.device)
        ok = (st.in_use == 0) & (st.caps >= size) & (ar < st.count) \
            & (size > 0)
        has_fit = ok.any()
        fit, fit_ptr = SizeClassAllocator._take_entry(st, _first_true(ok),
                                                      size)
        once, once_ptr = SizeClassAllocator._malloc_once(st, size)
        return _select(has_fit, fit, once), torch.where(has_fit, fit_ptr,
                                                        once_ptr)

    @staticmethod
    def _malloc_once(st: SizeClassState, size: torch.Tensor
                     ) -> Tuple[SizeClassState, torch.Tensor]:
        dev = st.count.device
        cap = st.offsets.shape[0]
        valid = size > 0
        nonempty = (st.free_bits != 0).any(1)
        eligible = nonempty & (torch.arange(NCLASSES, device=dev)
                               >= _ceil_log2(size))
        has_reuse = valid & eligible.any()
        words = _at(st.free_bits, _first_true(eligible))
        w = _first_true(words != 0)
        b = _low_bit(_at(words, w))
        e = torch.clamp(w.to(I32) * 32 + b, 0, cap - 1)
        can_bump = valid & (st.watermark + size <= st.heap_size) \
            & (st.count < cap)
        reused, reuse_ptr = SizeClassAllocator._take_entry(st, e, size)
        bumped, bump_ptr = _bump(st, size, can_bump)
        return _select(has_reuse, reused, bumped), torch.where(
            has_reuse, reuse_ptr, bump_ptr)

    @staticmethod
    def free(st: SizeClassState, ptr) -> SizeClassState:
        if events.active():
            _emit_heap("heap_free", st, ptr)
        ptr = as_i32(ptr, st.count.device)
        valid = (ptr >= 0) & (ptr < st.heap_size)
        hit, idx = _sorted_exact(st.offsets, st.in_use, st.count, ptr)
        hit = hit & valid
        c = _floor_log2(_at(st.caps, idx))
        w, b = idx // 32, idx % 32
        word = _cell(st.free_bits, c, w) | (1 << b)
        ar = torch.arange(st.offsets.shape[0], device=st.count.device)
        return dataclasses.replace(
            st, in_use=torch.where(hit & (ar == idx), 0, st.in_use),
            free_bits=torch.where(hit, _set_word(st.free_bits, c, w, word),
                                  st.free_bits))

    @staticmethod
    def find_obj(st: SizeClassState, ptr
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return GenericAllocator.find_obj(st, ptr)

    @staticmethod
    def malloc_many(st: SizeClassState, sizes
                    ) -> Tuple[SizeClassState, torch.Tensor]:
        """Prefix-sum bulk allocation (watermark only; the bins are for
        single requests)."""
        return GenericAllocator.malloc_many(st, sizes)

    @staticmethod
    def free_many(st: SizeClassState, ptrs) -> SizeClassState:
        """Bulk free and one scatter of every freed entry into its bin."""
        freed = _bulk_freed_mask(st.offsets, st.in_use, st.count,
                                 st.heap_size, as_i32(ptrs, st.count.device))
        return dataclasses.replace(
            st, in_use=torch.where(freed, 0, st.in_use),
            free_bits=_add_bins(st.free_bits, freed, st.caps))


# ---------------------------------------------------------------------------
# Balanced allocator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BalancedState:
    chunk_start: torch.Tensor   # (NC,) i32 — absolute base of each chunk
    chunk_size: torch.Tensor    # (NC,) i32
    offsets: torch.Tensor       # (NC, CAP) i32 — chunk-relative; DEAD past count
    sizes: torch.Tensor         # (NC, CAP) i32 — requested sizes
    caps: torch.Tensor          # (NC, CAP) i32 — block capacities
    in_use: torch.Tensor        # (NC, CAP) i32
    count: torch.Tensor         # (NC,) i32 — stack top per chunk
    watermark: torch.Tensor     # (NC,) i32 — chunk-relative
    n_slots: int                # N (thread slots)
    m_slots: int                # M (team slots)


#: The tensor fields of :class:`BalancedState`, in declaration order.
STATE_FIELDS = ("chunk_start", "chunk_size", "offsets", "sizes", "caps",
                "in_use", "count", "watermark")

#: The per-chunk fields the row primitives rewrite.
_ROW_FIELDS = ("offsets", "sizes", "caps", "in_use", "count", "watermark")


def _chunk_malloc_rows(rows: dict, csize: torch.Tensor, size: torch.Tensor
                       ) -> Tuple[dict, torch.Tensor]:
    """One request a row (``size`` (R,)): the top of the row's stack when
    it fits, else its first freed entry large enough, else FAIL.  ``rows``
    holds ``_ROW_FIELDS`` with a leading (R,) axis; returns the rows and
    the chunk-relative offsets."""
    cap = rows["offsets"].shape[-1]
    ar = torch.arange(cap, device=size.device)
    count, wm = rows["count"], rows["watermark"]
    top = (size > 0) & (wm + size <= csize) & (count < cap)
    ok = (rows["in_use"] == 0) & (rows["caps"] >= size[:, None]) \
        & (ar < count[:, None])
    hole = ~top & ok.any(-1) & (size > 0)
    at_top = top[:, None] & (ar == count[:, None])
    at_hole = hole[:, None] & (ar == _first_true(ok)[:, None])
    taken = at_top | at_hole
    hole_at = torch.where(at_hole, rows["offsets"], 0).sum(-1, dtype=I32)
    rel = torch.where(top, wm, torch.where(hole, hole_at, FAIL))
    s = size[:, None]
    return {
        "offsets": torch.where(at_top, wm[:, None], rows["offsets"]),
        "sizes": torch.where(taken, s, rows["sizes"]),
        "caps": torch.where(at_top, s, rows["caps"]),
        "in_use": torch.where(taken, 1, rows["in_use"]),
        "count": count + top.to(I32),
        "watermark": wm + torch.where(top, size, 0)}, rel.to(I32)


def _chunk_free_rows(rows: dict, csize: torch.Tensor, rel: torch.Tensor
                     ) -> dict:
    """Free each row's batch of chunk-relative pointers ``rel`` (R, k) and
    pop the dead top of its stack (FAIL and unmatched pointers are
    no-ops)."""
    freed = _freed_mask_rows(rows["offsets"], rows["in_use"], rows["count"],
                             csize, rel)
    in_use = torch.where(freed, 0, rows["in_use"])
    offsets, count, wm = _suffix_reclaim_rows(rows["offsets"], in_use,
                                              rows["count"],
                                              rows["watermark"])
    return dict(rows, offsets=offsets, in_use=in_use, count=count,
                watermark=wm)


def _chunk_free_serial_rows(rows: dict, rel: torch.Tensor) -> dict:
    """JAX's ``_chunk_free_serial`` on each row (``rel`` (R,)): free the
    live entry at ``rel``, then pop the stack top while it is unused.  The
    ``while_loop``'s data-dependent trip count becomes ``cap`` masked
    steps (the most a stack can pop)."""
    cap = rows["offsets"].shape[-1]
    ar = torch.arange(cap, device=rel.device)
    offsets, in_use = rows["offsets"], rows["in_use"]
    count, wm = rows["count"], rows["watermark"]
    hit = (offsets == rel[:, None]) & (in_use == 1) & (ar < count[:, None])
    at = hit.any(-1)[:, None] & (ar == _first_true(hit)[:, None])
    in_use = torch.where(at, 0, in_use)
    for _ in range(cap):
        i = count - 1
        ic = i.clamp(min=0)
        pop = (count > 0) & (_gather_rows(in_use, ic) == 0)
        wm = torch.where(pop, _gather_rows(offsets, ic), wm)
        offsets = torch.where(pop[:, None] & (ar == i[:, None]), DEAD,
                              offsets)
        count = torch.where(pop, i, count)
    return dict(rows, offsets=offsets, in_use=in_use, count=count,
                watermark=wm)


class BalancedAllocator:
    @staticmethod
    def init(heap_size: int, n_slots: int, m_slots: int, *, device,
             cap: int = 256, first_chunk_ratio: float = 4.0
             ) -> BalancedState:
        nc = n_slots * m_slots
        # chunk 0 gets `first_chunk_ratio` x the share of the others
        unit = heap_size / (nc - 1 + first_chunk_ratio)
        sizes = [int(unit * first_chunk_ratio)] + [int(unit)] * (nc - 1)
        sizes[-1] += heap_size - sum(sizes)          # absorb rounding
        starts = [0]
        for s in sizes[:-1]:
            starts.append(starts[-1] + s)

        def t(x):
            return torch.as_tensor(x, dtype=I32, device=device)

        def z2():
            return torch.zeros((nc, cap), dtype=I32, device=device)

        return BalancedState(
            t(starts), t(sizes),
            torch.full((nc, cap), DEAD, dtype=I32, device=device),
            z2(), z2(), z2(),
            torch.zeros((nc,), dtype=I32, device=device),
            torch.zeros((nc,), dtype=I32, device=device), n_slots, m_slots)

    # -- chunk selection (paper: thread id % N, team id % M) -------------------
    @staticmethod
    def chunk_of(st: BalancedState, tid, team) -> torch.Tensor:
        tid = as_i32(tid, st.count.device)
        team = as_i32(team, st.count.device)
        return (tid % st.n_slots) * st.m_slots + (team % st.m_slots)

    @staticmethod
    def _heap_end(st: BalancedState) -> torch.Tensor:
        return st.chunk_start[-1] + st.chunk_size[-1]

    @staticmethod
    def _chunk_at(st: BalancedState, ptr: torch.Tensor) -> torch.Tensor:
        """The chunk whose range holds ``ptr`` (clipped into range)."""
        c = torch.searchsorted(st.chunk_start, ptr, right=True) - 1
        return c.clamp(0, st.chunk_start.shape[0] - 1)

    @staticmethod
    def _row(st: BalancedState, c: torch.Tensor) -> dict:
        """Chunk ``c``'s fields as a one-row batch."""
        idx = c.reshape(1).long()
        return {f: getattr(st, f).index_select(0, idx) for f in _ROW_FIELDS}

    @staticmethod
    def _put_row(st: BalancedState, c: torch.Tensor, row: dict
                 ) -> BalancedState:
        hit = torch.arange(st.count.shape[0], device=c.device) == c
        return dataclasses.replace(st, **{
            f: torch.where(hit[:, None] if getattr(st, f).dim() == 2 else hit,
                           row[f], getattr(st, f))
            for f in _ROW_FIELDS})

    @staticmethod
    def _rows(st: BalancedState) -> dict:
        return {f: getattr(st, f) for f in _ROW_FIELDS}

    @staticmethod
    def malloc(st: BalancedState, tid, team, size
               ) -> Tuple[BalancedState, torch.Tensor]:
        """One request from chunk ``chunk_of(tid, team)``: the top of its
        stack when it fits, else its first freed entry large enough, else
        :data:`FAIL`.  ``size <= 0`` fails and changes nothing."""
        c = BalancedAllocator.chunk_of(st, tid, team)
        size = as_i32(size, st.count.device)
        row, rel = _chunk_malloc_rows(BalancedAllocator._row(st, c),
                                      _at(st.chunk_size, c).reshape(1),
                                      size.reshape(1))
        rel = rel[0]
        ptr = torch.where(rel == FAIL, FAIL, _at(st.chunk_start, c) + rel)
        return BalancedAllocator._put_row(st, c, row), ptr.to(I32)

    @staticmethod
    def free(st: BalancedState, ptr) -> BalancedState:
        """Free one pointer and pop the dead top of its chunk's stack; FAIL
        and out-of-heap pointers are no-ops."""
        ptr = as_i32(ptr, st.count.device)
        valid = (ptr >= 0) & (ptr < BalancedAllocator._heap_end(st))
        c = BalancedAllocator._chunk_at(st, ptr)
        rel = torch.where(valid, ptr - _at(st.chunk_start, c), FAIL)
        row = _chunk_free_rows(BalancedAllocator._row(st, c),
                               _at(st.chunk_size, c).reshape(1),
                               rel.reshape(1, 1))
        out = BalancedAllocator._put_row(st, c, row)
        return dataclasses.replace(out, **{
            f: torch.where(valid, getattr(out, f), getattr(st, f))
            for f in _ROW_FIELDS})

    @staticmethod
    def find_obj(st: BalancedState, ptr
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(found, base, size): the chunk by binary search over the chunk
        bases, the entry by binary search over its sorted offsets."""
        ptr = as_i32(ptr, st.count.device)
        valid = (ptr >= 0) & (ptr < BalancedAllocator._heap_end(st))
        c = BalancedAllocator._chunk_at(st, ptr)
        start = _at(st.chunk_start, c)
        found, base, size = _sorted_lookup(
            _at(st.offsets, c), _at(st.sizes, c), _at(st.in_use, c),
            _at(st.count, c), ptr - start)
        return found & valid, start + base, size

    @staticmethod
    def reset_chunk(st: BalancedState, c) -> BalancedState:
        """Drop every entry of chunk ``c`` (the serving layer's
        request-completion path)."""
        c = as_i32(c, st.count.device)
        return BalancedAllocator.reset_chunks(
            st, torch.arange(st.count.shape[0], device=c.device) == c)

    @staticmethod
    def reset_chunks(st: BalancedState, mask: torch.Tensor) -> BalancedState:
        """Drop every entry of each chunk where ``mask`` (NC,) is true — one
        vectorised select, no per-chunk loop."""
        mask = torch.as_tensor(mask, dtype=torch.bool, device=st.count.device)
        return dataclasses.replace(
            st,
            offsets=torch.where(mask[..., None], DEAD, st.offsets),
            in_use=torch.where(mask[..., None], 0, st.in_use),
            count=torch.where(mask, 0, st.count),
            watermark=torch.where(mask, 0, st.watermark))

    @staticmethod
    def _check_grid(st: BalancedState, n_threads: int, n_teams: int):
        if n_threads % st.n_slots or n_teams % st.m_slots:
            raise ValueError("grid must tile the chunk slots")

    @staticmethod
    def malloc_grid(st: BalancedState, n_threads: int, n_teams: int,
                    sizes: torch.Tensor) -> Tuple[BalancedState, torch.Tensor]:
        """sizes: (n_threads, n_teams) i32 -> ptrs of the same shape.

        Every chunk serves its requests at once through the prefix-sum bulk
        path (watermark only; freed holes are not reused)."""
        BalancedAllocator._check_grid(st, n_threads, n_teams)
        N, M = st.n_slots, st.m_slots
        sizes = torch.as_tensor(sizes, dtype=I32, device=st.count.device)
        grouped = _group_grid(sizes, N, M)            # (NC, per_chunk)
        offsets, szs, caps, in_use, count, wm, rels = _bulk_watermark_alloc(
            st.offsets, st.sizes, st.caps, st.in_use, st.count, st.watermark,
            st.chunk_size, grouped)
        ptrs = torch.where(rels == FAIL, FAIL, st.chunk_start[:, None] + rels)
        st = dataclasses.replace(st, offsets=offsets, sizes=szs, caps=caps,
                                 in_use=in_use, count=count, watermark=wm)
        return st, _ungroup_grid(ptrs, n_threads, n_teams, N, M)

    @staticmethod
    def free_grid(st: BalancedState, n_threads: int, n_teams: int, ptrs
                  ) -> BalancedState:
        """Bulk free: every chunk frees its pointers at once and pops its
        dead stack top; FAIL pointers in the grid are no-ops."""
        BalancedAllocator._check_grid(st, n_threads, n_teams)
        grouped = _group_grid(as_i32(ptrs, st.count.device), st.n_slots,
                              st.m_slots)
        rel = torch.where(grouped < 0, FAIL,
                          grouped - st.chunk_start[:, None])
        rows = _chunk_free_rows(BalancedAllocator._rows(st), st.chunk_size,
                                rel)
        return dataclasses.replace(st, **rows)

    # -- the serial contrast (JAX's per-chunk lax.scan) --------------------
    @staticmethod
    def malloc_grid_scan(st: BalancedState, n_threads: int, n_teams: int,
                         sizes) -> Tuple[BalancedState, torch.Tensor]:
        """:meth:`malloc_grid` one request a chunk at a time (every chunk
        in parallel), hole reuse included."""
        BalancedAllocator._check_grid(st, n_threads, n_teams)
        N, M = st.n_slots, st.m_slots
        grouped = _group_grid(as_i32(sizes, st.count.device), N, M)
        rows, rels = BalancedAllocator._rows(st), []
        for j in range(grouped.shape[1]):
            rows, rel = _chunk_malloc_rows(rows, st.chunk_size,
                                           grouped[:, j])
            rels.append(rel)
        rels = torch.stack(rels, 1)
        ptrs = torch.where(rels == FAIL, FAIL, st.chunk_start[:, None] + rels)
        return dataclasses.replace(st, **rows), \
            _ungroup_grid(ptrs, n_threads, n_teams, N, M)

    @staticmethod
    def free_grid_scan(st: BalancedState, n_threads: int, n_teams: int, ptrs
                       ) -> BalancedState:
        BalancedAllocator._check_grid(st, n_threads, n_teams)
        grouped = _group_grid(as_i32(ptrs, st.count.device), st.n_slots,
                              st.m_slots)
        rel = torch.where(grouped < 0, FAIL,
                          grouped - st.chunk_start[:, None])
        rows = BalancedAllocator._rows(st)
        for j in range(rel.shape[1]):
            rows = _chunk_free_serial_rows(rows, rel[:, j])
        return dataclasses.replace(st, **rows)


# ---------------------------------------------------------------------------
# Grid <-> chunk request grouping
# ---------------------------------------------------------------------------

def _group_grid(grid: torch.Tensor, N: int, M: int) -> torch.Tensor:
    """(..., n_threads, n_teams) -> (..., N*M, per_chunk) grouped by
    (tid%N, team%M)."""
    *lead, T, G = grid.shape
    a, b, n = T // N, G // M, len(lead)
    g = grid.reshape(*lead, a, N, b, M)   # tid = i*N+n -> (i, n); team = j*M+m
    return g.permute(*range(n), n + 1, n + 3, n, n + 2).reshape(
        *lead, N * M, a * b)


def _ungroup_grid(grouped: torch.Tensor, T: int, G: int, N: int, M: int
                  ) -> torch.Tensor:
    *lead, _, _ = grouped.shape
    a, b, n = T // N, G // M, len(lead)
    g = grouped.reshape(*lead, N, M, a, b)
    return g.permute(*range(n), n + 2, n, n + 3, n + 1).reshape(*lead, T, G)


# ---------------------------------------------------------------------------
# Sharded heap: one allocator state per device, stacked on one card
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedHeap:
    """Per-device heaps: ``shards`` is an allocator state whose every
    tensor field carries a leading ``(D, ...)`` device axis.  Device ``d``'s
    local offset ``p`` has the global address ``d * span + p`` (``span`` >=
    the per-device heap size), so a pointer names a unique object and
    :meth:`ShardedAllocator.find_obj` (the dispatch target of ``ArenaRef``
    marshalling) resolves it.  The shards are stacked on one device; in an
    expanded region (``core/expand.py``) each team of the mesh works on a
    copy of its row, and the rows are gathered after the region."""
    shards: Any
    n_devices: int
    span: int

    @property
    def device(self) -> torch.device:
        return self.shards.count.device

    # -- the team protocol of an expanded region (JAX's) ------------------
    def local_view(self):
        """The one shard of a one-row heap (the team's block in a
        region) as a plain allocator state."""
        rows = {f: getattr(self.shards, f) for f in
                _tensor_fields(self.shards)}
        assert all(t.shape[0] == 1 for t in rows.values()), \
            "local_view() needs a one-row heap (a team's block); use " \
            "local(dev) outside a region"
        return dataclasses.replace(self.shards,
                                   **{f: t[0] for f, t in rows.items()})

    def with_local(self, local) -> "ShardedHeap":
        """Inverse of :meth:`local_view`: the one-row heap of ``local``."""
        return dataclasses.replace(self, shards=dataclasses.replace(
            local, **{f: getattr(local, f).unsqueeze(0)
                      for f in _tensor_fields(local)}))

    def team_local(self, dev: int):
        """Team ``dev``'s heap in an expanded region: a copy of row
        ``dev`` as a plain allocator state, so the team's writes never
        touch this heap."""
        sh = self.shards
        return dataclasses.replace(sh, **{f: getattr(sh, f)[dev].clone()
                                          for f in _tensor_fields(sh)})

    def gathered(self, local, mesh) -> "ShardedHeap":
        """The heap of every team's ``local`` state of ``mesh``, in team
        order: a new heap, as every allocator op returns a new state."""
        return dataclasses.replace(self, shards=dataclasses.replace(
            local, **{f: gather_blocks(getattr(local, f).unsqueeze(0), mesh)
                      for f in _tensor_fields(local)}))

    def local(self, dev):
        """Device ``dev``'s shard (an int or a 0-d tensor, read on the
        device)."""
        sh = self.shards

        def pick(t):
            return t[dev] if isinstance(dev, int) else _at(t, dev)

        return dataclasses.replace(sh, **{f: pick(getattr(sh, f))
                                          for f in _tensor_fields(sh)})

    @staticmethod
    def global_ptr(dev, local_ptr, span) -> torch.Tensor:
        """(device, local offset) -> global pointer; FAIL stays FAIL."""
        return torch.where(local_ptr < 0, FAIL, dev * span + local_ptr).to(I32)


def _inner_heap_span(state) -> int:
    """The per-device pointer span of an inner allocator state."""
    if hasattr(state, "heap_size"):
        return int(state.heap_size)
    if isinstance(state, BalancedState):
        if state.chunk_start.device.type != "cpu":
            # its end lives on the card: reading it would synchronise
            raise TypeError(
                "shard_heap of a BalancedState on a card cannot infer the "
                "per-device span without a device read; pass "
                "span=<per-device heap size>")
        return int(state.chunk_start[-1] + state.chunk_size[-1])
    raise TypeError(f"cannot infer heap span of {type(state)!r}; pass "
                    "span= explicitly")


def shard_heap(state, n_devices: int, span: "int | None" = None
               ) -> ShardedHeap:
    """``n_devices`` independent copies of a freshly initialised
    per-device state, stacked along a leading axis.  ``span`` (the
    global-pointer stride between devices) defaults to the per-device heap
    size."""
    if span is None:
        span = _inner_heap_span(state)
    shards = dataclasses.replace(state, **{
        f: getattr(state, f).unsqueeze(0).expand(
            (n_devices,) + tuple(getattr(state, f).shape)).clone()
        for f in _tensor_fields(state)})
    return ShardedHeap(shards, n_devices, int(span))


def _vmap_state(fn, st, *args):
    """``torch.vmap`` of ``fn(state, *args) -> (state, out)`` (or ``->
    state``) over a state's leading device axis and each arg's first."""
    names = _tensor_fields(st)

    def flat(*xs):
        s = dataclasses.replace(st, **dict(zip(names, xs[:len(names)])))
        out = fn(s, *xs[len(names):])
        s2, rest = (out, ()) if not isinstance(out, tuple) else \
            (out[0], out[1:])
        return tuple(getattr(s2, f) for f in names) + tuple(rest)

    res = torch.vmap(flat)(*(getattr(st, f) for f in names), *args)
    state = dataclasses.replace(st, **dict(zip(names, res[:len(names)])))
    return state, res[len(names):]


class ShardedAllocator:
    """Operations over a :class:`ShardedHeap`: the inner allocator mapped
    across the device axis (``torch.vmap``), or, for the balanced grid
    ops, the D x NC chunks dispatched flat as one batch of rows (JAX's
    ``_flat_rows``).  Pointers in and out are global."""

    @staticmethod
    def _dev(st: ShardedHeap, extra: int) -> torch.Tensor:
        dev = torch.arange(st.n_devices, dtype=I32,
                           device=st.shards.count.device)
        return dev.reshape((-1,) + (1,) * extra)

    @staticmethod
    def malloc(st: ShardedHeap, sizes) -> Tuple[ShardedHeap, torch.Tensor]:
        """``sizes`` (D,): one request per device from its shard (hole
        reuse included); global pointers (FAIL where a shard fails)."""
        A = allocator_for(st.shards)
        shards, (local,) = _vmap_state(
            A.malloc, st.shards, as_i32(sizes, st.shards.count.device))
        return dataclasses.replace(st, shards=shards), ShardedHeap.global_ptr(
            ShardedAllocator._dev(st, 0), local, st.span)

    @staticmethod
    def malloc_many(st: ShardedHeap, sizes) -> Tuple[ShardedHeap, torch.Tensor]:
        """``sizes`` (D, k): bulk allocation per shard, every shard at once;
        (D, k) global pointers."""
        A = allocator_for(st.shards)
        shards, (local,) = _vmap_state(
            A.malloc_many, st.shards, as_i32(sizes, st.shards.count.device))
        return dataclasses.replace(st, shards=shards), ShardedHeap.global_ptr(
            ShardedAllocator._dev(st, 1), local, st.span)

    @staticmethod
    def free(st: ShardedHeap, ptrs) -> ShardedHeap:
        """``ptrs`` (D, k) global pointers, row ``d`` freed in shard ``d``;
        pointers of another device (and FAIL) are no-ops."""
        A = allocator_for(st.shards)
        ptrs = as_i32(ptrs, st.shards.count.device)
        dev = ShardedAllocator._dev(st, 1)
        mine = (ptrs >= dev * st.span) & (ptrs < (dev + 1) * st.span)
        local = torch.where(mine, ptrs - dev * st.span, FAIL)
        shards, _ = _vmap_state(A.free_many, st.shards, local)
        return dataclasses.replace(st, shards=shards)

    @staticmethod
    def find_obj(st: ShardedHeap, ptr
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Decode ``(device, offset)`` from a global pointer, look it up in
        that device's shard, and report the global base."""
        ptr = as_i32(ptr, st.shards.count.device)
        valid = (ptr >= 0) & (ptr < st.n_devices * st.span)
        dev = torch.clamp(torch.div(ptr, st.span, rounding_mode="floor"),
                          0, st.n_devices - 1)
        shard = st.local(dev)
        found, base, size = allocator_for(shard).find_obj(
            shard, ptr - dev * st.span)
        return found & valid, dev * st.span + base, size

    # -- balanced-inner grid ops: the D*NC chunks as one batch of rows -----
    @staticmethod
    def _flat(sh: BalancedState, dn: int) -> Tuple[dict, torch.Tensor]:
        rows = {f: getattr(sh, f).reshape((dn,) + tuple(
            getattr(sh, f).shape[2:])) for f in _ROW_FIELDS}
        return rows, sh.chunk_size.reshape(dn)

    @staticmethod
    def _unflat(sh: BalancedState, rows: dict) -> BalancedState:
        return dataclasses.replace(sh, **{
            f: rows[f].reshape(getattr(sh, f).shape) for f in _ROW_FIELDS})

    @staticmethod
    def _grid_geometry(st: ShardedHeap, n_threads: int, n_teams: int):
        sh = st.shards
        BalancedAllocator._check_grid(sh, n_threads, n_teams)
        return sh, sh.offsets.shape[0], sh.offsets.shape[1]

    @staticmethod
    def malloc_grid(st: ShardedHeap, n_threads: int, n_teams: int, sizes
                    ) -> Tuple[ShardedHeap, torch.Tensor]:
        """``sizes`` (D, n_threads, n_teams): every device's grid
        allocation as one prefix-sum pass over all D*NC chunks; (D,
        n_threads, n_teams) global pointers."""
        sh, D, NC = ShardedAllocator._grid_geometry(st, n_threads, n_teams)
        N, M = sh.n_slots, sh.m_slots
        sizes = as_i32(sizes, sh.count.device)
        grouped = _group_grid(sizes, N, M)
        k = grouped.shape[-1]
        rows, csize = ShardedAllocator._flat(sh, D * NC)
        offsets, szs, caps, in_use, count, wm, rels = _bulk_watermark_alloc(
            rows["offsets"], rows["sizes"], rows["caps"], rows["in_use"],
            rows["count"], rows["watermark"], csize,
            grouped.reshape(D * NC, k))
        rels = rels.reshape(D, NC, k)
        ptrs = torch.where(rels == FAIL, FAIL,
                           sh.chunk_start[:, :, None] + rels)
        ptrs = _ungroup_grid(ptrs, n_threads, n_teams, N, M)
        sh = ShardedAllocator._unflat(sh, {
            "offsets": offsets, "sizes": szs, "caps": caps, "in_use": in_use,
            "count": count, "watermark": wm})
        return dataclasses.replace(st, shards=sh), ShardedHeap.global_ptr(
            ShardedAllocator._dev(st, 2), ptrs, st.span)

    @staticmethod
    def free_grid(st: ShardedHeap, n_threads: int, n_teams: int, ptrs
                  ) -> ShardedHeap:
        """``ptrs`` (D, n_threads, n_teams) global pointers, row ``d`` from
        device ``d``'s grid; FAIL and foreign pointers are no-ops.  One
        pass over all D*NC chunks."""
        sh, D, NC = ShardedAllocator._grid_geometry(st, n_threads, n_teams)
        ptrs = as_i32(ptrs, sh.count.device)
        dev = ShardedAllocator._dev(st, 2)
        mine = (ptrs >= dev * st.span) & (ptrs < (dev + 1) * st.span)
        local = torch.where(mine, ptrs - dev * st.span, FAIL)
        grouped = _group_grid(local, sh.n_slots, sh.m_slots)
        flat = grouped.reshape(D * NC, -1)
        rel = torch.where(flat < 0, FAIL,
                          flat - sh.chunk_start.reshape(D * NC)[:, None])
        rows, csize = ShardedAllocator._flat(sh, D * NC)
        rows = _chunk_free_rows(rows, csize, rel)
        return dataclasses.replace(
            st, shards=ShardedAllocator._unflat(sh, rows))

    @staticmethod
    def reset_chunks(st: ShardedHeap, mask) -> ShardedHeap:
        """``mask`` (D, NC): whole-chunk reclaim in every shard."""
        return dataclasses.replace(st, shards=BalancedAllocator.reset_chunks(
            st.shards, mask))


# ---------------------------------------------------------------------------
# State-directed dispatch (the RPC layer's entry point)
# ---------------------------------------------------------------------------

_ALLOCATORS = {GenericState: GenericAllocator,
               SizeClassState: SizeClassAllocator,
               BalancedState: BalancedAllocator,
               ShardedHeap: ShardedAllocator}


def allocator_for(state):
    """The allocator class that operates on ``state`` (by state type)."""
    for cls, alloc in _ALLOCATORS.items():
        if isinstance(state, cls):
            return alloc
    raise TypeError(f"no allocator registered for state {type(state)!r}")


def find_obj(state, ptr) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paper's ``_FindObj`` over any allocator state: the lookup that
    the RPC layer's ``ArenaRef`` marshalling rides."""
    if events.active():
        _emit_heap("ptr_lookup", state, ptr)
    return allocator_for(state).find_obj(state, ptr)


def find_obj_linear(state, ptr
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The O(cap) masked-scan lookup (JAX's v1 reference), for benchmarks
    and property cross-checks."""
    if isinstance(state, ShardedHeap):
        ptr = as_i32(ptr, state.shards.count.device)
        valid = (ptr >= 0) & (ptr < state.n_devices * state.span)
        dev = torch.clamp(torch.div(ptr, state.span, rounding_mode="floor"),
                          0, state.n_devices - 1)
        found, base, size = find_obj_linear(state.local(dev),
                                            ptr - dev * state.span)
        return found & valid, dev * state.span + base, size
    ptr = as_i32(ptr, state.count.device)
    if isinstance(state, BalancedState):
        c = BalancedAllocator._chunk_at(state, ptr)
        start = _at(state.chunk_start, c)
        rel = ptr - start
        offsets, sizes = _at(state.offsets, c), _at(state.sizes, c)
        ar = torch.arange(offsets.shape[0], device=ptr.device)
        live = (_at(state.in_use, c) == 1) & (ar < _at(state.count, c))
        inside = live & (offsets <= rel) & (rel < offsets + sizes)
        idx = _first_true(inside)
        valid = (ptr >= 0) & (ptr < BalancedAllocator._heap_end(state))
        return inside.any() & valid, start + _at(offsets, idx), \
            _at(sizes, idx)
    ar = torch.arange(state.offsets.shape[0], device=ptr.device)
    live = (state.in_use == 1) & (ar < state.count)
    inside = live & (state.offsets <= ptr) & (ptr < state.offsets
                                              + state.sizes)
    idx = _first_true(inside)
    return inside.any(), _at(state.offsets, idx), _at(state.sizes, idx)


# ---------------------------------------------------------------------------
# torch.export: allocator states ride an exported serve step (the page heap
# of serving/kvcache.py), so each is a pytree node whose static ints are
# its context (JAX: register_pytree_node_serialization)
# ---------------------------------------------------------------------------

for _cls, _static in ((GenericState, ("heap_size",)),
                      (SizeClassState, ("heap_size",)),
                      (BalancedState, ("n_slots", "m_slots")),
                      (ShardedHeap, ("n_devices", "span"))):
    register_export_node(_cls, _static)

