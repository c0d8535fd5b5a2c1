"""Plain versions of the async queue's two kernels (``csrc/rpc_async.cu``).

They update the queue's words from ``head`` on (``h``, a 1-D int32 tensor
on any device, in place), in the order of ``core/rpc.py``'s ``_HEADS`` and
``_WINDOW`` followed by the reply offsets, lengths, statuses and arena.
A CPU queue's flush runs them; on a card they are the host-visible twin
the kernels are held against.  Every write is a tensor op, so on CUDA
tensors they read nothing back to the host.
"""
from __future__ import annotations

import torch

(H_HEAD, H_PHEAD, H_ADROPS, H_BASE, H_RBASE, H_RCOUNT, H_FONCE, H_PBASE,
 H_PCOUNT, H_CDEPTH) = range(10)


def post_reference(h: torch.Tensor, has_reply: bool) -> None:
    """``rpc_async_post``'s window hand-off: the submitted epoch becomes
    the pending window (and on a reply-carrying queue the pending one the
    reply window), ``base`` advances by ``head`` (int32 wrap), the heads
    zero and ``fonce`` is set."""
    old = h[:H_CDEPTH].clone()
    new = old.clone()
    if has_reply:
        new[H_RBASE] = old[H_PBASE]
        new[H_RCOUNT] = old[H_PCOUNT]
    new[H_PBASE] = old[H_BASE]
    new[H_PCOUNT] = old[H_HEAD]
    wide = old[H_BASE].to(torch.int64) + old[H_HEAD].to(torch.int64)
    new[H_BASE] = (torch.remainder(wide + (1 << 31), 1 << 32)
                   - (1 << 31)).to(torch.int32)
    new[H_HEAD:H_ADROPS + 1].zero_()
    new[H_FONCE].fill_(1)
    h[:H_CDEPTH].copy_(new)


def collect_reference(h: torch.Tensor, words: torch.Tensor) -> None:
    """``rpc_async_collect``: the previous epoch's words (carried depth,
    offsets, lengths, statuses, replies; zeros at the first flush, the
    TIMEOUT-stamped window past a deadline) into the queue from
    ``cdepth`` on."""
    h[H_CDEPTH:H_CDEPTH + words.numel()].copy_(words)

