"""Balanced heap allocator (paper §3.4, Fig. 5) on device tensors.

The port of ``repro/core/allocator.py``'s :class:`BalancedAllocator`, the
allocator behind the serving engine's page heap.  The heap is split into
N (thread slots) x M (team slots) chunks; chunk 0 is larger by
``first_chunk_ratio``.  Entries form a watermark stack per chunk.  State
lives in device tensors and every operation is a vectorised torch op over
all chunks at once: no Python loop over chunks or requests, and no read
back to the host.  Results are bit-identical to the JAX package.
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
        tid = torch.as_tensor(tid, dtype=I32, device=st.count.device)
        team = torch.as_tensor(team, dtype=I32, device=st.count.device)
        return (tid % st.n_slots) * st.m_slots + (team % st.m_slots)

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
