"""Paged KV cache managed by the paper's balanced allocator (§3.4, applied).

The port of ``repro/serving/kvcache.py``.  Mapping:

  chunk slot        <- request slot  (N = max batch slots, M = 1)
  allocation        <- one KV page (``page_size`` tokens, all layers)
  watermark reclaim <- request completion frees its whole chunk stack

Pages are shared across layers (a page id addresses every layer's page
arrays).  With ``mesh=`` (a ``DeviceMesh`` or a shard count ``D``) the
page heap is sharded: ``D`` balanced heaps of ``n_pages / D`` pages, one
for each block of ``B / D`` slots, stacked on the one device (a data
layout, not a placement, as in JAX), so a slot's pages lie in its
shard's span of page ids and page allocation and release run in every
shard at once.  Attention over the paged cache uses the
``paged_attention`` CUDA kernel on the card, which reads pages in place
through the page table.

Unlike the JAX version, the functions here update ``kv``'s tensors in place
(pages, page table) and return the same :class:`PagedKV`: copying a
multi-gigabyte page array per token is not an option outside a compiler
that elides it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import (BalancedAllocator, BalancedState,
                                        ShardedAllocator, ShardedHeap,
                                        shard_heap)
from repro_torch.core.expand import _check_mesh
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models.common import torch_dtype
from repro_torch.tree import register_export_node


@dataclasses.dataclass
class PagedKV:
    k_pages: torch.Tensor       # (L, NP, page, Hkv, hd)
    v_pages: torch.Tensor
    page_table: torch.Tensor    # (B, MAXP) int32
    lengths: torch.Tensor       # (B,) int32
    alloc: Union[BalancedState, ShardedHeap]  # page-slot allocator
    #                          (arena = page-id space; sharded with a mesh)
    page_size: int


#: A pytree node for ``torch.export`` (the engine's exported step takes and
#: returns the cache), ``page_size`` its context.
register_export_node(PagedKV, ("page_size",))


def _mesh_devices(mesh, device) -> int:
    """The shard count of a mesh-like: an int, or a ``DeviceMesh`` of
    ``device``'s type (another device type raises)."""
    if isinstance(mesh, int):
        return mesh
    _check_mesh(mesh)
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"paged_cache_init: a mesh on {mesh.device_type} "
                         f"for a cache on {device}")
    return int(mesh.size())


def paged_cache_init(cfg: ModelConfig, batch_slots: int, max_len: int,
                     *, device, page_size: int = 64,
                     n_pages: Optional[int] = None, mesh=None) -> PagedKV:
    hd = cfg.resolved_head_dim
    maxp = (max_len + page_size - 1) // page_size
    n_pages = n_pages if n_pages is not None else batch_slots * maxp
    cdt = torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, n_pages, page_size, cfg.num_kv_heads, hd)
    if mesh is None:
        alloc = BalancedAllocator.init(n_pages, batch_slots, 1, cap=maxp,
                                       first_chunk_ratio=1.0, device=device)
    else:
        D = _mesh_devices(mesh, device)
        if batch_slots % D or n_pages % D:
            raise ValueError(f"batch_slots={batch_slots} and n_pages="
                             f"{n_pages} must tile the {D} mesh devices")
        local = BalancedAllocator.init(n_pages // D, batch_slots // D, 1,
                                       cap=maxp, first_chunk_ratio=1.0,
                                       device=device)
        alloc = shard_heap(local, D, span=n_pages // D)
    return PagedKV(
        k_pages=torch.zeros(shape, dtype=cdt, device=device),
        v_pages=torch.zeros(shape, dtype=cdt, device=device),
        page_table=torch.zeros((batch_slots, maxp), dtype=torch.int32,
                               device=device),
        lengths=torch.zeros((batch_slots,), dtype=torch.int32, device=device),
        alloc=alloc,
        page_size=page_size)


def _slot_rows(kv: PagedKV):
    """(row index, page-table column of the current position) per slot."""
    B, maxp = kv.page_table.shape
    rows = torch.arange(B, device=kv.lengths.device)
    col = torch.clamp(kv.lengths // kv.page_size, max=maxp - 1).to(torch.int64)
    return rows, col


def ensure_pages(kv: PagedKV, active: torch.Tensor) -> PagedKV:
    """Allocate a page for every active slot whose next token crosses a page
    boundary: one balanced-allocator grid call.  A full chunk stores FAIL
    page ids, which the attention kernels clip and ``lengths`` masks.
    With a sharded heap each shard serves its block of slots, all shards
    in one pass, global page ids out."""
    B = kv.lengths.shape[0]
    need = active & (kv.lengths % kv.page_size == 0)
    sizes = need.to(torch.int32).reshape(B, 1)
    if isinstance(kv.alloc, ShardedHeap):
        D = kv.alloc.n_devices
        kv.alloc, ptrs = ShardedAllocator.malloc_grid(
            kv.alloc, B // D, 1, sizes.reshape(D, B // D, 1))
    else:
        kv.alloc, ptrs = BalancedAllocator.malloc_grid(kv.alloc, B, 1, sizes)
    rows, col = _slot_rows(kv)
    kv.page_table[rows, col] = torch.where(need, ptrs.reshape(B),
                                           kv.page_table[rows, col])
    return kv


@dataclasses.dataclass
class TokenSlots:
    """Where each slot's current token goes: the same in every layer of a
    tick, so :func:`token_slots` computes it once and every layer's
    :func:`write_token_kv` reuses it."""
    src: torch.Tensor    # (B,) slot whose K/V each row writes
    page: torch.Tensor   # (B,) page id of that slot's current position
    off: torch.Tensor    # (B,) offset in the page
    live: torch.Tensor   # (B, 1, 1) True where the row writes new data


def token_slots(kv: PagedKV, active: torch.Tensor) -> TokenSlots:
    """Write targets of one tick's tokens.

    Inactive slots must write nothing.  The JAX version drops their write
    through an out-of-range page id, which torch refuses (an illegal
    address on the card).  Here an inactive slot repeats the first active
    slot's write — same place, same value — so duplicate indices carry
    identical data and the result does not depend on write order; with no
    active slot, every slot rewrites what is already there.  This needs no
    read back of ``active`` to the host."""
    rows, col = _slot_rows(kv)
    page = kv.page_table[rows, col].to(torch.int64)
    off = (kv.lengths % kv.page_size).to(torch.int64)
    first = torch.argmax(active.to(torch.int32))
    src = torch.where(active, rows, first)
    return TokenSlots(src, page[src], off[src], active[src][:, None, None])


def write_token_kv(kv: PagedKV, layer: int, k: torch.Tensor, v: torch.Tensor,
                   slots: TokenSlots) -> PagedKV:
    """Write one token's K/V (B, Hkv, hd) for ``layer`` at each active slot's
    current position (targets from :func:`token_slots`)."""
    for pages, new in ((kv.k_pages[layer], k), (kv.v_pages[layer], v)):
        pages[slots.page, slots.off] = torch.where(
            slots.live, new[slots.src].to(pages.dtype),
            pages[slots.page, slots.off])
    return kv


def paged_attend(kv: PagedKV, layer: int, q: torch.Tensor,
                 window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, hd) one token per slot -> (B, Hq, hd).  Attends over
    lengths+1 entries (the current token was just written)."""
    return paged_decode_attention(
        q, kv.k_pages[layer], kv.v_pages[layer], kv.page_table,
        kv.lengths + 1, window=window)


def advance(kv: PagedKV, active: torch.Tensor) -> PagedKV:
    kv.lengths = kv.lengths + active.to(torch.int32)
    return kv


def live_pages(kv: PagedKV, slot: int) -> torch.Tensor:
    """Page ids currently backing ``slot`` (in position order): the page
    table's live prefix, one entry per started page.  Reads the slot's
    length back to the host."""
    n = (int(kv.lengths[slot]) + kv.page_size - 1) // kv.page_size
    return kv.page_table[slot, :n]


def release_slot(kv: PagedKV, slot: int) -> PagedKV:
    """Release one slot: reset its allocator chunk (the whole stack's
    watermark reclaim) and zero its page-table row and length."""
    row = torch.arange(kv.lengths.shape[0], device=kv.lengths.device) == slot
    if isinstance(kv.alloc, ShardedHeap):
        return release_slots(kv, row)
    kv.alloc = BalancedAllocator.reset_chunk(kv.alloc, slot)
    kv.page_table = torch.where(row[:, None], 0, kv.page_table)
    kv.lengths = torch.where(row, 0, kv.lengths)
    return kv


def release_slots(kv: PagedKV, mask: torch.Tensor) -> PagedKV:
    """Release every slot where ``mask`` (B,) is true in one vectorised
    allocator reset (every shard's at once), and zero its page-table row
    and length."""
    if isinstance(kv.alloc, ShardedHeap):
        D = kv.alloc.n_devices
        kv.alloc = ShardedAllocator.reset_chunks(
            kv.alloc, mask.reshape(D, mask.shape[0] // D))
    else:
        kv.alloc = BalancedAllocator.reset_chunks(kv.alloc, mask)
    kv.page_table = torch.where(mask[:, None], 0, kv.page_table)
    kv.lengths = torch.where(mask, 0, kv.lengths)
    return kv
