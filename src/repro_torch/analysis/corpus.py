"""Seeded hazard corpus: one tiny program per hazard class, buggy + fixed.

The port of ``repro/analysis/corpus.py``: the same case names,
expectations and ``# BUG`` comments, all 34 of JAX's cases.
``callback_in_mesh`` runs on a mesh of one device (a world of one
process, :mod:`repro_torch.launch.mesh`).  Each case takes ``device``
(the card unless the caller asks for the CPU) and builds every queue,
heap and tensor there;
``run_case(case, device=...)`` analyzes one.  The expectations are
JAX's golden file, ``tests/data/hazard_corpus.json``: the buggy programs
are the analyzer's positive tests, every ``*_fixed`` variant must report
none (the false-positive fence).

JAX's ``lax.scan`` bodies are ``serial_for`` loops here (which an event
capture scopes), written as one line so that the loop's enqueue or call
is the ``# BUG`` line.  A constant pointer stays a constant (a Python
int), so ``OOB_PTR`` fires on the card too and no event reads the device.

This module's own frames are visible to ``events._user_site`` (the rest
of ``repro_torch/analysis`` is skipped): hazard sites point into this
file, at the ``# BUG`` line of the offending call.

Run modes: ``run`` feeds the event rules only; ``both`` also exports the
program for the graph walker; ``trace`` (``callback_in_mesh``, as JAX's)
only exports and walks it.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core import allocator
from repro_torch.core.allocator import SizeClassAllocator
from repro_torch.core.device_main import HostHook, device_run
from repro_torch.core.expand import P, expand, serial_for
from repro_torch.core.rpc import (REGISTRY, RetryPolicy, RpcQueue, ShapeDtype,
                                  rpc_call)
from repro_torch.launch.mesh import one_device_mesh

_I32 = ShapeDtype((), torch.int32)
#: The cases' device unless the caller names one.
DEVICE = "cuda"
#: JAX's cases the port lacks: none since the mesh (ROADMAP item 5.4).
NOT_PORTED: Tuple[str, ...] = ()


def _echo(x):
    return np.int32(x)


def _note(*args):
    return None


REGISTRY.register("corpus.echo", _echo)
REGISTRY.register("corpus.note", _note)
# the retry-safe twin: same callee, declared idempotent — the
# RETRY_NON_IDEMPOTENT fixed variant enqueues this one
REGISTRY.register("corpus.echo_idem", _echo, idempotent=True)


def _i32(v, device) -> torch.Tensor:
    """A 0-d int32 on ``device`` (JAX's ``jnp.int32(v)``), made without a
    host-to-device copy."""
    return torch.full((), v, dtype=torch.int32, device=device)


def _arange(n, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    fn: Callable
    expect: Tuple[str, ...]        # sorted hazard codes the analyzer must find
    mode: str = "run"              # "run" | "both" | "trace"


# -- ticket lifecycle -------------------------------------------------------

def result_before_flush(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(7, device), returns=_I32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the runtime warns here too
        q.result(t, _I32)                    # BUG: no flush yet


def result_before_flush_fixed(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(7, device), returns=_I32)
    q = q.flush()
    q.result_ok(t, _I32)              # guarded read after the flush


def never_flushed(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, device=device)
    q = q.enqueue("corpus.note", _i32(1, device))   # BUG: dropped, no flush


def never_flushed_fixed(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, device=device)
    q = q.enqueue("corpus.note", _i32(1, device))
    q.flush()


def stale_ticket(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(3, device), returns=_I32)
    q = q.flush()
    q = q.enqueue("corpus.note", _i32(0, device))
    q = q.flush()                 # second flush slides the reply window
    q.result_ok(t, _I32)          # BUG: epoch-0 ticket read after epoch 1


def stale_ticket_fixed(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(3, device), returns=_I32)
    q = q.flush()
    q.result_ok(t, _I32)          # read inside the ticket's window
    q = q.enqueue("corpus.note", _i32(0, device))
    q.flush()


def unguarded_result(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(9, device), returns=_I32,
                              where=torch.ones((), dtype=torch.bool,
                                               device=device))
    q = q.flush()
    q.result(t, _I32)             # BUG: dropped record reads as zero


def unguarded_result_fixed(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(9, device), returns=_I32,
                              where=torch.ones((), dtype=torch.bool,
                                               device=device))
    q = q.flush()
    q.result_ok(t, _I32)          # validity mask guards the read


# -- robustness (v5 fault-tolerant boundary) --------------------------------

def retry_non_idempotent(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8,
                        retry=RetryPolicy(max_attempts=2), device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(1, device), returns=_I32)  # BUG: echo not idempotent
    q = q.flush()
    q.result_ok(t, _I32)


def retry_non_idempotent_fixed(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8,
                        retry=RetryPolicy(max_attempts=2), device=device)
    q, t = q.enqueue_ticketed("corpus.echo_idem", _i32(1, device),
                              returns=_I32)   # registered idempotent=True
    q = q.flush()
    q.result_ok(t, _I32)


def unchecked_status(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(5, device), returns=_I32)
    q = q.flush()
    q.result(t, _I32)             # BUG: status lane never consulted


def unchecked_status_fixed(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(5, device), returns=_I32)
    q = q.flush()
    q.result_status(t)            # the guard: status consulted ...
    q.result(t, _I32)             # ... so the raw read is fine


def pending_ticket_read(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, mode="async",
                        device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(4, device), returns=_I32)
    q = q.flush()                 # async: SUBMIT only — replies not here
    q.result(t, _I32)             # BUG: epoch still pending (reads zeros)
    q = q.flush()                 # collect, so the drain retires cleanly
    q.join()


def pending_ticket_read_fixed(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, mode="async",
                        device=device)
    q, t = q.enqueue_ticketed("corpus.echo", _i32(4, device), returns=_I32)
    q = q.flush()                 # submit the epoch
    q = q.flush()                 # collect: the epoch's replies land
    q.result_status(t)            # guard distinguishes PENDING from OK
    q.result(t, _I32)
    q.join()


# -- capacity proofs --------------------------------------------------------
# Each loop body returns the queue's head (serial_for stacks a tensor an
# iteration); the enqueue is the body.

def capacity_records(device=DEVICE):
    q = RpcQueue.create(4, 4, 64, device=device)     # 4 records per epoch
    xs = _arange(10, device)
    serial_for(lambda i: q.enqueue("corpus.note", xs[i]).head, 10)  # BUG: 10 > 4
    q.flush()


def capacity_records_fixed(device=DEVICE):
    q = RpcQueue.create(16, 4, 64, device=device)
    xs = _arange(10, device)
    serial_for(lambda i: q.enqueue("corpus.note", xs[i]).head, 10)
    q.flush()


def capacity_payload(device=DEVICE):
    q = RpcQueue.create(64, 4, 32, device=device)    # 32 payload words per epoch
    xs = torch.zeros((10, 8), dtype=torch.int32, device=device)
    serial_for(lambda i: q.enqueue("corpus.note", xs[i]).head, 10)  # BUG: 80
    q.flush()


def capacity_payload_fixed(device=DEVICE):
    q = RpcQueue.create(64, 4, 1024, device=device)
    xs = torch.zeros((10, 8), dtype=torch.int32, device=device)
    serial_for(lambda i: q.enqueue("corpus.note", xs[i]).head, 10)
    q.flush()


def capacity_reply(device=DEVICE):
    q = RpcQueue.create(64, 4, 64, reply_capacity=4, device=device)
    xs = _arange(10, device)
    serial_for(lambda i: q.enqueue_ticketed("corpus.echo", xs[i], returns=_I32)[1], 10)  # BUG: 10 reply words
    q.flush()


def capacity_reply_fixed(device=DEVICE):
    q = RpcQueue.create(64, 4, 64, reply_capacity=16, device=device)
    xs = _arange(10, device)
    serial_for(lambda i: q.enqueue_ticketed("corpus.echo", xs[i], returns=_I32)[1], 10)
    q.flush()


# -- pointer safety ---------------------------------------------------------

def use_after_free(device=DEVICE):
    st = SizeClassAllocator.init(1024, device=device)
    st, p = SizeClassAllocator.malloc(st, _i32(8, device))
    st = SizeClassAllocator.free(st, p)
    allocator.find_obj(st, p)     # BUG: lookup through a freed pointer


def use_after_free_fixed(device=DEVICE):
    st = SizeClassAllocator.init(1024, device=device)
    st, p = SizeClassAllocator.malloc(st, _i32(8, device))
    allocator.find_obj(st, p)
    SizeClassAllocator.free(st, p)


def double_free(device=DEVICE):
    st = SizeClassAllocator.init(1024, device=device)
    st, p = SizeClassAllocator.malloc(st, _i32(8, device))
    st = SizeClassAllocator.free(st, p)
    SizeClassAllocator.free(st, p)   # BUG: block may be handed out again


def double_free_fixed(device=DEVICE):
    st = SizeClassAllocator.init(1024, device=device)
    st, p = SizeClassAllocator.malloc(st, _i32(8, device))
    SizeClassAllocator.free(st, p)


def oob_ptr(device=DEVICE):
    st = SizeClassAllocator.init(1024, device=device)
    allocator.find_obj(st, 4096)   # BUG: outside the arena


def oob_ptr_fixed(device=DEVICE):
    st = SizeClassAllocator.init(1024, device=device)
    st, p = SizeClassAllocator.malloc(st, _i32(8, device))
    allocator.find_obj(st, p)


# -- performance lints ------------------------------------------------------

def rpc_in_loop(device=DEVICE):
    xs = _arange(5, device)
    serial_for(lambda i: rpc_call("corpus.echo", xs[i], result_shape=_I32)[0], 5)  # BUG


def rpc_in_loop_fixed(device=DEVICE):
    q = RpcQueue.create(8, 4, 64, device=device)
    xs = _arange(5, device)
    serial_for(lambda i: q.enqueue("corpus.note", xs[i]).head, 5)
    q.flush()


def callback_in_loop(device=DEVICE):
    # same pathology, judged from the exported graph as well ("both" mode)
    xs = _arange(5, device)
    serial_for(lambda i: rpc_call("corpus.echo", xs[i], result_shape=_I32)[0], 5)  # BUG


def callback_in_mesh(device=DEVICE):
    # walker-only ("trace"), as JAX's: an immediate call inside a region
    # expanded over a mesh of one device
    mesh = one_device_mesh("d", device=device)

    def region(x):
        r, _ = rpc_call("corpus.echo", x[0], result_shape=_I32)  # BUG
        return x + r

    return expand(region, mesh, (P("d"),), P("d"))(
        torch.zeros((1,), dtype=torch.int32, device=device))


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def hook_never_fires(device=DEVICE):
    h = HostHook(extract=lambda step, s: s, host_fn=lambda step, v: None,
                 every=50)
    device_run(lambda i, s: s + 1.0, _zero(device), 3, hooks=[h])  # BUG: run is 3 steps


def hook_never_fires_fixed(device=DEVICE):
    h = HostHook(extract=lambda step, s: s, host_fn=lambda step, v: None,
                 every=1)
    device_run(lambda i, s: s + 1.0, _zero(device), 3, hooks=[h])


def _sink(tag, step, v):
    return None


def unstable_pad_name(device=DEVICE):
    # functools.partial has no code object, so the auto-name falls back
    # to id() — a different landing pad every process; an exported
    # manifest of this program cannot round-trip.
    h = HostHook(extract=lambda step, s: s,
                 host_fn=functools.partial(_sink, "metrics"), every=1)
    device_run(lambda i, s: s + 1.0, _zero(device), 3, hooks=[h])  # BUG


def unstable_pad_name_fixed(device=DEVICE):
    h = HostHook(extract=lambda step, s: s,
                 host_fn=functools.partial(_sink, "metrics"), every=1,
                 name="corpus.metrics")       # explicit durable name
    device_run(lambda i, s: s + 1.0, _zero(device), 3, hooks=[h])


CASES = (
    Case("result_before_flush", result_before_flush,
         ("NEVER_FLUSHED", "RESULT_BEFORE_FLUSH", "UNCHECKED_STATUS")),
    Case("result_before_flush_fixed", result_before_flush_fixed, ()),
    Case("never_flushed", never_flushed, ("NEVER_FLUSHED",)),
    Case("never_flushed_fixed", never_flushed_fixed, ()),
    Case("stale_ticket", stale_ticket, ("STALE_TICKET",)),
    Case("stale_ticket_fixed", stale_ticket_fixed, ()),
    Case("unguarded_result", unguarded_result,
         ("UNCHECKED_STATUS", "UNGUARDED_RESULT")),
    Case("unguarded_result_fixed", unguarded_result_fixed, ()),
    Case("retry_non_idempotent", retry_non_idempotent,
         ("RETRY_NON_IDEMPOTENT",)),
    Case("retry_non_idempotent_fixed", retry_non_idempotent_fixed, ()),
    Case("unchecked_status", unchecked_status, ("UNCHECKED_STATUS",)),
    Case("unchecked_status_fixed", unchecked_status_fixed, ()),
    Case("pending_ticket_read", pending_ticket_read,
         ("PENDING_TICKET_READ", "UNCHECKED_STATUS")),
    Case("pending_ticket_read_fixed", pending_ticket_read_fixed, ()),
    Case("capacity_records", capacity_records, ("CAPACITY_RECORDS",)),
    Case("capacity_records_fixed", capacity_records_fixed, ()),
    Case("capacity_payload", capacity_payload, ("CAPACITY_PAYLOAD",)),
    Case("capacity_payload_fixed", capacity_payload_fixed, ()),
    Case("capacity_reply", capacity_reply, ("CAPACITY_REPLY",)),
    Case("capacity_reply_fixed", capacity_reply_fixed, ()),
    Case("use_after_free", use_after_free, ("USE_AFTER_FREE",)),
    Case("use_after_free_fixed", use_after_free_fixed, ()),
    Case("double_free", double_free, ("DOUBLE_FREE",)),
    Case("double_free_fixed", double_free_fixed, ()),
    Case("oob_ptr", oob_ptr, ("OOB_PTR",)),
    Case("oob_ptr_fixed", oob_ptr_fixed, ()),
    Case("rpc_in_loop", rpc_in_loop, ("RPC_IN_LOOP",)),
    Case("rpc_in_loop_fixed", rpc_in_loop_fixed, ()),
    Case("callback_in_loop", callback_in_loop,
         ("CALLBACK_IN_LOOP", "RPC_IN_LOOP"), mode="both"),
    Case("callback_in_mesh", callback_in_mesh,
         ("CALLBACK_IN_MESH",), mode="trace"),
    Case("hook_never_fires", hook_never_fires, ("HOOK_NEVER_FIRES",)),
    Case("hook_never_fires_fixed", hook_never_fires_fixed, ()),
    Case("unstable_pad_name", unstable_pad_name, ("UNSTABLE_PAD_NAME",)),
    Case("unstable_pad_name_fixed", unstable_pad_name_fixed, ()),
)


def run_case(case: Case, device=DEVICE):
    """Analyze one corpus case on ``device`` in its declared mode ->
    HazardReport.

    The buggy programs really do drop records when they run — their
    RuntimeWarnings are the seeded defect, not noise worth surfacing."""
    from repro_torch.analysis.capture import analyze
    from repro_torch.analysis.walker import analyze_graph
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if case.mode == "trace":
            return analyze_graph(case.fn, device=device)
        return analyze(case.fn, device=device,
                       graph=(True if case.mode == "both" else False))
