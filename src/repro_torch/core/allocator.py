"""Heap allocators (paper §3.4) on device tensors: generic and balanced.

The port of ``repro/core/allocator.py``'s :class:`GenericAllocator` (one
global allocation list with first-fit reuse, the heap behind the RPC
layer's ``ArenaRef`` and ``libc.realloc``) and :class:`BalancedAllocator`
(the serving engine's page heap: N (thread slots) x M (team slots)
chunks; chunk 0 is larger by ``first_chunk_ratio``; entries form a
watermark stack per chunk).

State lives in device tensors and every operation is torch ops on them:
each ``lax.cond`` of the JAX version becomes a select over both branches,
a write at a computed index a select against an ``arange``, and a read at
one an ``index_select``, so no operation reads a value back to the host
(no ``.item()``, no Python ``if`` on a tensor, no indexing with a 0-d
tensor, which PyTorch turns into ``.item()``).  Results are bit-identical
to the JAX package.  ``SizeClassAllocator``, ``ShardedHeap`` and
``ShardedAllocator`` are not ported yet (ROADMAP queue 1, item 3.6).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

I32 = torch.int32
FAIL = -1
#: Offset of entry slots that hold no entry; keeps each chunk's offset table
#: sorted (INT32_MAX).
DEAD = 2 ** 31 - 1

_NOT_PORTED = "ROADMAP queue 1, item 3.6 (SizeClassAllocator, ShardedHeap)"


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


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis for a 0-d index tensor, without the
    host read that ``x[idx]`` makes of a 0-d index."""
    return x.index_select(0, idx.reshape(1).long()).squeeze(0)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, in int32 like the JAX code."""
    return torch.cumsum(x, dim=-1, dtype=I32) - x


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
    idx = torch.where(m, slot, cap_entries).to(torch.int64)

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
    """Index of the first true entry of a 1-D mask (0 if none), int64 —
    ``jnp.argmax`` of a boolean array."""
    return torch.argmax(mask.to(torch.uint8))


def _suffix_reclaim(offsets, in_use, count, wm):
    """Pop every dead entry off the top of a region's entry stack at once:
    the new stack top is one past the last live entry, the watermark drops
    to the first popped entry's offset, and popped slots become
    :data:`DEAD`.  Returns ``(offsets, count, wm)``."""
    n = offsets.shape[0]
    ar = torch.arange(n, device=offsets.device)
    live = (in_use == 1) & (ar < count)
    last_live = (n - 1 - _first_true(live.flip(0))).to(I32)
    new_count = torch.where(live.any(), last_live + 1, 0).to(I32)
    popped = new_count < count
    new_wm = torch.where(popped, _at(offsets, new_count.clamp(0, n - 1)), wm)
    offsets = torch.where(ar >= new_count, DEAD, offsets)
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


def _bulk_freed_mask(offsets, in_use, count, limit, ptrs):
    """Per-entry freed mask for a 1-D batch of pointers: one sorted exact
    lookup each, scattered back to entry space.  Invalid and unmatched
    pointers contribute nothing."""
    n = offsets.shape[0]
    valid = (ptrs >= 0) & (ptrs < limit)
    hit, idx = _sorted_exact(offsets, in_use, count, ptrs)
    slot = torch.where(hit & valid, idx, n)
    mask = torch.zeros((n + 1,), dtype=torch.bool, device=offsets.device)
    return mask.scatter(0, slot, True)[:n]


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
        size = as_i32(size, st.count.device)
        cap = st.offsets.shape[0]
        ar = torch.arange(cap, device=st.count.device)
        reusable = (st.in_use == 0) & (st.caps >= size) & (ar < st.count) \
            & (size > 0)
        reuse = reusable.any()
        at_reuse = reuse & (ar == _first_true(reusable))
        bump = ~reuse & (size > 0) & (st.watermark + size <= st.heap_size) \
            & (st.count < cap)
        at_bump = bump & (ar == st.count)
        taken = at_reuse | at_bump
        reused_at = torch.where(at_reuse, st.offsets, 0).sum(dtype=I32)
        ptr = torch.where(reuse, reused_at,
                          torch.where(bump, st.watermark, FAIL)).to(I32)
        return dataclasses.replace(
            st,
            offsets=torch.where(at_bump, st.watermark, st.offsets),
            sizes=torch.where(taken, size, st.sizes),
            caps=torch.where(at_bump, size, st.caps),
            in_use=torch.where(taken, 1, st.in_use),
            count=st.count + bump.to(I32),
            watermark=st.watermark + torch.where(bump, size, 0)), ptr

    @staticmethod
    def free(st: GenericState, ptr) -> GenericState:
        """Mark the entry at ``ptr`` free; FAIL, wild and already-free
        pointers are no-ops."""
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

#: Fields of one chunk's row that the single-request ops rewrite.
_ROW_FIELDS = ("offsets", "sizes", "caps", "in_use", "count", "watermark")


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
        return {f: _at(getattr(st, f), c) for f in _ROW_FIELDS}

    @staticmethod
    def _put_row(st: BalancedState, c: torch.Tensor, row: dict
                 ) -> BalancedState:
        hit = torch.arange(st.count.shape[0], device=c.device) == c
        return dataclasses.replace(st, **{
            f: torch.where(hit[:, None] if getattr(st, f).dim() == 2 else hit,
                           row[f], getattr(st, f))
            for f in _ROW_FIELDS})

    @staticmethod
    def malloc(st: BalancedState, tid, team, size
               ) -> Tuple[BalancedState, torch.Tensor]:
        """One request from chunk ``chunk_of(tid, team)``: the top of its
        stack when it fits, else its first freed entry large enough, else
        :data:`FAIL`.  ``size <= 0`` fails and changes nothing."""
        c = BalancedAllocator.chunk_of(st, tid, team)
        size = as_i32(size, st.count.device)
        row = BalancedAllocator._row(st, c)
        csize = _at(st.chunk_size, c)
        cap = st.offsets.shape[1]
        ar = torch.arange(cap, device=c.device)
        top = (size > 0) & (row["watermark"] + size <= csize) \
            & (row["count"] < cap)
        ok = (row["in_use"] == 0) & (row["caps"] >= size) & (ar < row["count"])
        hole = ~top & ok.any() & (size > 0)
        at_top = top & (ar == row["count"])
        at_hole = hole & (ar == _first_true(ok))
        taken = at_top | at_hole
        hole_at = torch.where(at_hole, row["offsets"], 0).sum(dtype=I32)
        rel = torch.where(top, row["watermark"],
                          torch.where(hole, hole_at, FAIL))
        row = {
            "offsets": torch.where(at_top, row["watermark"], row["offsets"]),
            "sizes": torch.where(taken, size, row["sizes"]),
            "caps": torch.where(at_top, size, row["caps"]),
            "in_use": torch.where(taken, 1, row["in_use"]),
            "count": row["count"] + top.to(I32),
            "watermark": row["watermark"] + torch.where(top, size, 0)}
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
        row = BalancedAllocator._row(st, c)
        freed = _bulk_freed_mask(row["offsets"], row["in_use"], row["count"],
                                 _at(st.chunk_size, c), rel[None])
        in_use = torch.where(freed, 0, row["in_use"])
        offsets, count, wm = _suffix_reclaim(row["offsets"], in_use,
                                             row["count"], row["watermark"])
        row = dict(row, offsets=offsets, in_use=in_use, count=count,
                   watermark=wm)
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
        row = BalancedAllocator._row(st, c)
        found, base, size = _sorted_lookup(row["offsets"], row["sizes"],
                                           row["in_use"], row["count"],
                                           ptr - start)
        return found & valid, start + base, size

    @staticmethod
    def reset_chunks(st: BalancedState, mask: torch.Tensor) -> BalancedState:
        """Drop every entry of each chunk where ``mask`` (NC,) is true — one
        vectorised select, no per-chunk loop."""
        mask = torch.as_tensor(mask, dtype=torch.bool, device=st.count.device)
        return dataclasses.replace(
            st,
            offsets=torch.where(mask[:, None], DEAD, st.offsets),
            in_use=torch.where(mask[:, None], 0, st.in_use),
            count=torch.where(mask, 0, st.count),
            watermark=torch.where(mask, 0, st.watermark))

    @staticmethod
    def malloc_grid(st: BalancedState, n_threads: int, n_teams: int,
                    sizes: torch.Tensor) -> Tuple[BalancedState, torch.Tensor]:
        """sizes: (n_threads, n_teams) i32 -> ptrs of the same shape.

        Every chunk serves its requests at once through the prefix-sum bulk
        path (watermark only; freed holes are not reused)."""
        N, M = st.n_slots, st.m_slots
        if n_threads % N or n_teams % M:
            raise ValueError("grid must tile the chunk slots")
        sizes = torch.as_tensor(sizes, dtype=I32, device=st.count.device)
        grouped = _group_grid(sizes, N, M)            # (NC, per_chunk)
        offsets, szs, caps, in_use, count, wm, rels = _bulk_watermark_alloc(
            st.offsets, st.sizes, st.caps, st.in_use, st.count, st.watermark,
            st.chunk_size, grouped)
        ptrs = torch.where(rels == FAIL, FAIL, st.chunk_start[:, None] + rels)
        st = dataclasses.replace(st, offsets=offsets, sizes=szs, caps=caps,
                                 in_use=in_use, count=count, watermark=wm)
        return st, _ungroup_grid(ptrs, n_threads, n_teams, N, M)


# ---------------------------------------------------------------------------
# Grid <-> chunk request grouping
# ---------------------------------------------------------------------------

def _group_grid(grid: torch.Tensor, N: int, M: int) -> torch.Tensor:
    """(n_threads, n_teams) -> (N*M, per_chunk) grouped by (tid%N, team%M)."""
    T, G = grid.shape
    a, b = T // N, G // M
    g = grid.reshape(a, N, b, M)          # tid = i*N+n -> (i, n); team = j*M+m
    return g.permute(1, 3, 0, 2).reshape(N * M, a * b)


def _ungroup_grid(grouped: torch.Tensor, T: int, G: int, N: int, M: int
                  ) -> torch.Tensor:
    a, b = T // N, G // M
    g = grouped.reshape(N, M, a, b)
    return g.permute(2, 0, 3, 1).reshape(T, G)


# ---------------------------------------------------------------------------
# State-directed dispatch (the RPC layer's entry point)
# ---------------------------------------------------------------------------

_ALLOCATORS = {GenericState: GenericAllocator,
               BalancedState: BalancedAllocator}


def allocator_for(state):
    """The allocator class that operates on ``state`` (by state type)."""
    for cls, alloc in _ALLOCATORS.items():
        if isinstance(state, cls):
            return alloc
    if type(state).__name__ in ("SizeClassState", "ShardedHeap"):
        raise NotImplementedError(
            f"{type(state).__name__} is not ported yet: {_NOT_PORTED}")
    raise TypeError(f"no allocator registered for state {type(state)!r}")


def find_obj(state, ptr) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paper's ``_FindObj`` over any allocator state: the lookup that
    the RPC layer's ``ArenaRef`` marshalling rides."""
    return allocator_for(state).find_obj(state, ptr)
