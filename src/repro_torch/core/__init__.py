"""GPU First core on PyTorch/CUDA: the paper's contributions, ported so far.

  device_main — whole-program device execution, immediate hooks (§3.1)
  rpc         — generated host RPC, immediate calls (§3.2), on a channel of
                pinned host-mapped memory on the card
  expand      — single-team parallelism expansion: parallel_for vs
                serial_for (§3.3)
  allocator   — generic and balanced heap allocators (§3.4)
  libc        — rand, atoi, strtod, realloc (§3.4)
"""
from repro_torch.core.allocator import (
    DEAD, FAIL, BalancedAllocator, BalancedState, GenericAllocator,
    GenericState, allocator_for, find_obj)
from repro_torch.core.device_main import HostHook, device_run
from repro_torch.core.expand import (
    barrier, expand, num_teams, num_threads, parallel_for, serial_for,
    team_id, thread_id, ws_range)
from repro_torch.core.libc import (
    atoi, rand_init, rand_u32, rand_uniform, realloc, strtod)
from repro_torch.core.rpc import (
    READ, READWRITE, WRITE, ArenaRef, Ref, ShapeDtype, effects_barrier,
    host_rpc, pad_stats, pad_table, reset_rpc_stats, rpc_call,
    rpc_call_reference, rpc_stats)

__all__ = [
    "DEAD", "FAIL", "BalancedAllocator", "BalancedState", "GenericAllocator",
    "GenericState", "allocator_for", "find_obj",
    "HostHook", "device_run",
    "barrier", "expand", "num_teams", "num_threads", "parallel_for",
    "serial_for", "team_id", "thread_id", "ws_range",
    "atoi", "rand_init", "rand_u32", "rand_uniform", "realloc", "strtod",
    "READ", "READWRITE", "WRITE", "ArenaRef", "Ref", "ShapeDtype",
    "effects_barrier", "host_rpc", "pad_stats", "pad_table",
    "reset_rpc_stats", "rpc_call", "rpc_call_reference", "rpc_stats",
]
