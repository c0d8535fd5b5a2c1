"""GPU First core on PyTorch/CUDA: the paper's contributions, ported so far.

  device_main — whole-program device execution, immediate, batched and
                returning hooks (§3.1)
  rpc         — generated host RPC (§3.2): immediate calls on a channel of
                pinned host-mapped memory on the card, and the batched
                RpcQueue (one rpc_enqueue launch a record, one round trip
                a flush) with its status lane, retries and timeouts,
                the async queue and the sanitizer (canary-bracketed
                payloads, poison scans, sanitize_stats)
  expand      — single-team parallelism expansion: parallel_for vs
                serial_for (§3.3)
  allocator   — generic, size-class, balanced and sharded heap
                allocators (§3.4), find_obj and find_obj_linear
  events      — the instrumentation seam the analysis layer subscribes to
  libc        — rand, atoi, strtod, realloc, and buffered I/O on the
                queue: LogRing, fprintf, fwrite, fread, fgets, remote
                malloc (§3.4)
"""
from repro_torch.core import events
from repro_torch.core.allocator import (
    DEAD, FAIL, BalancedAllocator, BalancedState, GenericAllocator,
    GenericState, ShardedAllocator, ShardedHeap, SizeClassAllocator,
    SizeClassState, allocator_for, find_obj, find_obj_linear, shard_heap)
from repro_torch.core.device_main import HostHook, device_run
from repro_torch.core.expand import (
    barrier, expand, num_teams, num_threads, parallel_for, serial_for,
    team_id, thread_id, ws_range)
from repro_torch.core.libc import (
    LogRing, atoi, drain_fwrite, drain_log_lines, drain_printf, fgets,
    fprintf, fread, fread_feed, fwrite, rand_init, rand_u32, rand_uniform,
    realloc, remote_heap_register, remote_malloc_enqueue,
    remote_malloc_results, strtod)
from repro_torch.core.rpc import (
    CANARY, POISON, READ, READWRITE, STATUS_CALLEE_RAISED, STATUS_DROPPED, STATUS_NAMES,
    STATUS_OK, STATUS_PENDING, STATUS_REPLY_OVERFLOW, STATUS_STALE,
    STATUS_TIMEOUT, WRITE, ArenaRef, Ref, RetryPolicy, RpcQueue, ShapeDtype,
    clear_error_log, effects_barrier, error_log, flush_stats, host_rpc,
    pad_stats, pad_table, queue_drops, reset_rpc_stats, rpc_call,
    reset_sanitize_stats, rpc_call_reference, rpc_stats, sanitize_stats,
    set_fault_injector)

__all__ = [
    "DEAD", "FAIL", "BalancedAllocator", "BalancedState", "GenericAllocator",
    "GenericState", "ShardedAllocator", "ShardedHeap", "SizeClassAllocator",
    "SizeClassState", "allocator_for", "events", "find_obj",
    "find_obj_linear", "shard_heap",
    "HostHook", "device_run",
    "barrier", "expand", "num_teams", "num_threads", "parallel_for",
    "serial_for", "team_id", "thread_id", "ws_range",
    "LogRing", "atoi", "drain_fwrite", "drain_log_lines", "drain_printf",
    "fgets", "fprintf", "fread", "fread_feed", "fwrite", "rand_init",
    "rand_u32", "rand_uniform", "realloc", "remote_heap_register",
    "remote_malloc_enqueue", "remote_malloc_results", "strtod",
    "CANARY", "POISON", "READ", "READWRITE", "STATUS_CALLEE_RAISED", "STATUS_DROPPED",
    "STATUS_NAMES", "STATUS_OK", "STATUS_PENDING", "STATUS_REPLY_OVERFLOW",
    "STATUS_STALE", "STATUS_TIMEOUT", "WRITE", "ArenaRef", "Ref",
    "RetryPolicy", "RpcQueue", "ShapeDtype", "clear_error_log",
    "effects_barrier", "error_log", "flush_stats", "host_rpc", "pad_stats",
    "pad_table", "queue_drops", "reset_rpc_stats", "rpc_call",
    "reset_sanitize_stats", "rpc_call_reference", "rpc_stats",
    "sanitize_stats", "set_fault_injector",
]
