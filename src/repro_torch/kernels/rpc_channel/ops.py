"""The channel's round trip as a custom op: ``torch.ops.repro_torch.
rpc_post``.

``rpc_post(anchor, staging, inputs, in_slots, words, outputs, out_slots)``
copies each input into its slot of the staging region ``staging`` (an id
in the channel's ``Stagings``), passes the scalar ``words`` (uint32
values), runs the region's ``serve()`` on the host and copies each
output's slot into it.  ``anchor`` is any tensor on the call's device (the
first input, or an empty tensor for a call with none): it picks the
kernel, and the channel (``anchor``'s device, the current stream).  The
CUDA kernel is the ctypes launch (``kernel.py::rpc_post``, where the
launch counter counts), the CPU kernel the same round trip on the
thread's :class:`HostChannel`, the fake kernel nothing.  It mutates its
outputs and is marked side-effectful, so ``torch.export`` keeps every
call, its result used or not.  A staging id is this process's: an
exported graph names the call, it does not carry the callee.  The op is
defined with ``torch.library.Library`` (as ``rpc_enqueue``, see
``kernels/rpc_queue/ops.py``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.kernels import OPS_NAMESPACE, traced_stack
from repro_torch.kernels.rpc_channel.kernel import (channel_for, host_channel,
                                                    rpc_post)


_LIB = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
_LIB.define("rpc_post(Tensor anchor, int staging, Tensor[] inputs, "
            "int[] in_slots, int[] words, Tensor(a!)[] outputs, "
            "int[] out_slots) -> ()")


def _cpu(anchor, staging, inputs, in_slots, words, outputs, out_slots):
    host_channel().post(staging, inputs, in_slots, words, outputs, out_slots)


def _cuda(anchor, staging, inputs, in_slots, words, outputs, out_slots):
    rpc_post(channel_for(anchor.device), staging, inputs, in_slots, words,
             outputs, out_slots)


def _fake(anchor, staging, inputs, in_slots, words, outputs, out_slots):
    return None


_LIB.impl("rpc_post", _cpu, "CPU")
_LIB.impl("rpc_post", _cuda, "CUDA")
torch.library.register_fake(f"{OPS_NAMESPACE}::rpc_post", _fake, lib=_LIB)
_OP = torch.ops.repro_torch.rpc_post.default
torch.fx.node.has_side_effect(_OP)

#: An empty tensor a device: the anchor of eager calls with no input.
_ANCHORS: Dict[torch.device, torch.Tensor] = {}


def post(device: torch.device, staging: int, inputs: Sequence[torch.Tensor],
         in_slots: Sequence[int], words: Sequence[int],
         outputs: Sequence[torch.Tensor], out_slots: Sequence[int]) -> None:
    """One round trip through the op on ``device``'s channel (see the
    module docstring): ``inputs[k]`` into slot ``in_slots[k]``, slot
    ``out_slots[k]`` into ``outputs[k]``; ``words`` are ints."""
    if torch.compiler.is_exporting():
        # a fresh anchor: the export's own (fake) tensor
        anchor = inputs[0] if inputs else torch.empty(
            0, dtype=torch.int32, device=device)
        with traced_stack():
            _OP(anchor, staging, inputs, in_slots, words, outputs, out_slots)
        return
    anchor = inputs[0] if inputs else _ANCHORS.get(device)
    if anchor is None:
        anchor = _ANCHORS[device] = torch.empty(0, dtype=torch.int32,
                                                device=device)
    _OP(anchor, staging, inputs, in_slots, words, outputs, out_slots)
