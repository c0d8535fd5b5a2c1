"""GPU First core on PyTorch/CUDA: the paper's contributions, ported so far.

  device_main — whole-program device execution, immediate, batched and
                returning hooks (§3.1), and host_driven_run, the offload
                baseline it is measured against
  rpc         — generated host RPC (§3.2): immediate calls on a channel of
                pinned host-mapped memory on the card, and the batched
                RpcQueue (one rpc_enqueue launch a record, one round trip
                a flush) with its status lane, retries and timeouts,
                the async queue, the sanitizer (canary-bracketed
                payloads, poison scans, sanitize_stats), the
                ShardedRpcQueue (shards stacked on one device, replayed in
                (device, slot) order, shard_deadline; drained on a mesh's
                first rank once gathered over it) and the RpcManifest
                of durable ids (export_manifest, adopt_manifest)
  expand      — parallelism expansion (§3.3): the team vocabulary,
                expand over a torch.distributed mesh with team heaps and
                queues (team_heap, team_queue, team_ptr), parallel_for
                (over a mesh too) vs serial_for
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
from repro_torch.core.device_main import (HostHook, device_run,
                                          host_driven_run)
from repro_torch.core.expand import (
    P, barrier, expand, num_teams, num_threads, parallel_for, serial_for,
    set_team_heap, set_team_queue, team_heap, team_id, team_ptr, team_queue,
    thread_id, ws_range)
from repro_torch.core.libc import (
    LogRing, atoi, drain_fwrite, drain_log_lines, drain_printf, fgets,
    fprintf, fread, fread_feed, fwrite, rand_init, rand_u32, rand_uniform,
    realloc, remote_heap_register, remote_malloc_enqueue,
    remote_malloc_results, strtod)
from repro_torch.core.rpc import (
    CANARY, POISON, READ, READWRITE, STATUS_CALLEE_RAISED, STATUS_DROPPED, STATUS_NAMES,
    STATUS_OK, STATUS_PENDING, STATUS_REPLY_OVERFLOW, STATUS_STALE,
    STATUS_TIMEOUT, WRITE, ArenaRef, Ref, RetryPolicy, RpcManifest, RpcQueue,
    ShapeDtype, ShardedRpcQueue, adopt_manifest, clear_error_log,
    effects_barrier, error_log, export_manifest, flush_stats, host_rpc,
    pad_stats, pad_table, queue_drops, queue_geometry, reset_rpc_stats,
    rpc_call, reset_sanitize_stats, rpc_call_reference, rpc_stats,
    sanitize_stats, set_fault_injector)

__all__ = [
    "DEAD", "FAIL", "BalancedAllocator", "BalancedState", "GenericAllocator",
    "GenericState", "ShardedAllocator", "ShardedHeap", "SizeClassAllocator",
    "SizeClassState", "allocator_for", "events", "find_obj",
    "find_obj_linear", "shard_heap",
    "HostHook", "device_run", "host_driven_run",
    "P", "barrier", "expand", "num_teams", "num_threads", "parallel_for",
    "serial_for", "set_team_heap", "set_team_queue", "team_heap", "team_id",
    "team_ptr", "team_queue", "thread_id", "ws_range",
    "LogRing", "atoi", "drain_fwrite", "drain_log_lines", "drain_printf",
    "fgets", "fprintf", "fread", "fread_feed", "fwrite", "rand_init",
    "rand_u32", "rand_uniform", "realloc", "remote_heap_register",
    "remote_malloc_enqueue", "remote_malloc_results", "strtod",
    "CANARY", "POISON", "READ", "READWRITE", "STATUS_CALLEE_RAISED", "STATUS_DROPPED",
    "STATUS_NAMES", "STATUS_OK", "STATUS_PENDING", "STATUS_REPLY_OVERFLOW",
    "STATUS_STALE", "STATUS_TIMEOUT", "WRITE", "ArenaRef", "Ref",
    "RetryPolicy", "RpcManifest", "RpcQueue", "ShapeDtype",
    "ShardedRpcQueue", "adopt_manifest", "clear_error_log",
    "effects_barrier", "error_log", "export_manifest", "flush_stats",
    "host_rpc", "pad_stats", "pad_table", "queue_drops", "queue_geometry",
    "reset_rpc_stats", "rpc_call",
    "reset_sanitize_stats", "rpc_call_reference", "rpc_stats",
    "sanitize_stats", "set_fault_injector",
]
