"""Parallelism expansion (paper §3.3): single-team code run across every
team, with continuous thread ids and team-local heaps and queues.

The port of ``repro/core/expand.py``.  A team is a device of a mesh (a
``torch.distributed`` ``DeviceMesh``, :mod:`repro_torch.launch.mesh`), a
thread a ``torch.vmap`` lane.  The program is SPMD: every rank of the
mesh runs the same code.

* :func:`team_id`, :func:`num_teams`, :func:`thread_id`,
  :func:`num_threads`, :func:`barrier` and :func:`ws_range` (the ``omp
  for`` static schedule): what legacy-style code is written against.
  Outside an expanded region there is one team of one thread; inside,
  they read the region's mesh (continuous ids across teams, row-major in
  the mesh's axis order, the paper's Fig. 4).
* :func:`expand`, JAX's ``shard_map`` rewrite: every rank passes the
  GLOBAL arguments, the region gets this team's block of each (the
  leading dimension split over a spec's axes; a replicated input whole)
  and runs under the team environment, and the sharded outputs are
  all-gathered, so every rank returns the same global result.
* Team-local runtime state: ``expand(heap=True, queue=True)`` threads a
  :class:`~repro_torch.core.allocator.ShardedHeap` and a
  :class:`~repro_torch.core.rpc.ShardedRpcQueue` (or a sharded
  ``LogRing``), stacked ``(D, ...)``, through the region.  Inside,
  :func:`team_heap` / :func:`team_queue` hand the region a copy of this
  team's row (so a team's writes never touch the global object while
  other teams read it), :func:`set_team_heap` / :func:`set_team_queue`
  store the updated one, and :func:`team_ptr` encodes a team-local heap
  offset as a global ``(device, offset)`` pointer that ``find_obj``
  resolves after the region.  After the region every team's row is
  gathered: the heap comes back as a new ``ShardedHeap`` (allocator
  states are values in the port: every op returns a new one), the queue
  is updated in place (queues are objects) and remembers the mesh, so
  its flush drains on the mesh's first rank alone and broadcasts the
  replies: host effects happen once, as in JAX's one process.
* :func:`parallel_for`, the expanded execution of ``for i in range(n):
  out[i] = body(i, *arrays)`` (a block of iterations a team, a lane an
  iteration, ragged ``n`` padded and masked), and :func:`serial_for`, the
  same loop as a sequential Python loop (``lax.map``'s single-team
  semantics, the baseline column of the paper's Figs. 8-10).

Specs are the port's :class:`P`; ``expand`` takes ``P()`` (replicated)
and ``P(axes)`` (the leading dimension over those axes), the only ones
the JAX package's callers of ``expand`` pass.  A queue flush inside a region
raises ``RuntimeError``, as JAX's does: enqueue in the region and flush
at the program boundary.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import types
from typing import Callable, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import events
from repro_torch.distributed.collectives import barrier as _barrier
from repro_torch.distributed.collectives import gather_blocks, team_index
from repro_torch.tree import leaves, tree_map


class _Env(threading.local):
    def __init__(self):
        self.mesh = None                     # the region's DeviceMesh
        self.axes: Tuple[str, ...] = ()      # mesh axes visible to the region
        self.lanes: int = 1                  # vectorised lanes per team
        self.heap = None                     # this team's allocator shard
        self.queue = None                    # this team's RPC queue shard
        self.span: Optional[int] = None      # global-pointer stride
        self.sanitize: bool = False          # region runs sanitized transport


_ENV = _Env()
_FIELDS = ("mesh", "axes", "lanes", "heap", "queue", "span", "sanitize")


@contextlib.contextmanager
def _team_env(mesh, axes: Tuple[str, ...], lanes: int,
              sanitize: bool = False):
    old = tuple(getattr(_ENV, f) for f in _FIELDS)
    _ENV.mesh, _ENV.axes, _ENV.lanes = mesh, axes, lanes
    _ENV.heap = _ENV.queue = _ENV.span = None
    _ENV.sanitize = sanitize
    try:
        yield
    finally:
        for f, v in zip(_FIELDS, old):
            setattr(_ENV, f, v)


def in_region() -> bool:
    """True inside an expanded region (on this thread)."""
    return bool(_ENV.axes)


def current_mesh():
    """The mesh of the expanded region this thread runs in, else None."""
    return _ENV.mesh


# ---------------------------------------------------------------------------
# Single-team semantics (the vocabulary legacy-style code is written in)
# ---------------------------------------------------------------------------

def team_id() -> torch.Tensor:
    """Continuous team id across the whole mesh, row-major in the mesh's
    axis order (0 outside a region): a 0-d int32 CPU tensor, which torch
    takes as a scalar beside CUDA tensors."""
    tid = team_index(_ENV.mesh, _ENV.axes) if _ENV.axes else 0
    return torch.tensor(tid, dtype=torch.int32)


def _teams(mesh, axes: Tuple[str, ...]) -> int:
    """The number of teams over ``axes`` of ``mesh``."""
    n = 1
    for ax in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(ax))
    return n


def num_teams() -> int:
    return _teams(_ENV.mesh, _ENV.axes)


def thread_id(lane=None) -> torch.Tensor:
    """Continuous global thread id = team_id * lanes + lane (paper Fig. 4:
    the teams are "bulked together as one large team")."""
    tid = team_id() * _ENV.lanes
    return tid if lane is None else tid + lane


def num_threads() -> int:
    return num_teams() * _ENV.lanes


def barrier() -> None:
    """Cross-team barrier: a collective over the region's mesh, which
    orders every team (the paper's global atomic counters); nothing to
    order with one team."""
    if _ENV.axes:
        _barrier(_ENV.axes, _ENV.mesh)


def ws_range(n: int) -> Tuple[torch.Tensor, int]:
    """``omp for schedule(static)`` over [0, n): this team's (start,
    count)."""
    teams = num_teams()
    if n % teams:
        raise ValueError(f"iteration space {n} must tile {teams} teams")
    per = n // teams
    return team_id() * per, per


# ---------------------------------------------------------------------------
# Team-local runtime state (sharded heap / sharded RPC queue accessors)
# ---------------------------------------------------------------------------

def team_heap():
    """This team's allocator shard (a plain one-device allocator state),
    inside a region expanded with ``heap=True``; operate on it with the
    inner allocator's ops (team-local offsets) and store the result with
    :func:`set_team_heap`."""
    if _ENV.heap is None:
        raise RuntimeError(
            "team_heap() outside a heap-carrying expanded region; wrap the "
            "region with expand(..., heap=True) and pass a ShardedHeap")
    return _ENV.heap


def set_team_heap(state) -> None:
    """Store this team's updated allocator shard."""
    if _ENV.heap is None:
        raise RuntimeError("set_team_heap() outside a heap-carrying region")
    _ENV.heap = state


def team_queue():
    """This team's RPC queue shard (an ``RpcQueue``, or the ring of a
    sharded ``LogRing``), inside a region expanded with ``queue=True``."""
    if _ENV.queue is None:
        raise RuntimeError(
            "team_queue() outside a queue-carrying expanded region; wrap "
            "the region with expand(..., queue=True) and pass a "
            "ShardedRpcQueue (or sharded LogRing)")
    return _ENV.queue


def set_team_queue(q) -> None:
    """Store this team's updated queue shard."""
    if _ENV.queue is None:
        raise RuntimeError("set_team_queue() outside a queue-carrying region")
    _ENV.queue = q


def team_ptr(local_ptr) -> torch.Tensor:
    """A team-local heap offset as a GLOBAL pointer (``team_id() * span +
    offset``) that outlives the region: ``allocator.find_obj`` decodes the
    ``(device, offset)`` pair, so the RPC ``ArenaRef`` marshalling
    resolves it like any heap pointer.  FAIL stays FAIL."""
    if _ENV.span is None:
        raise RuntimeError("team_ptr() outside a heap-carrying region")
    if not isinstance(local_ptr, torch.Tensor):
        local_ptr = torch.tensor(local_ptr, dtype=torch.int32)
    local_ptr = local_ptr.to(torch.int32)
    return torch.where(local_ptr < 0, -1,
                       team_id() * _ENV.span + local_ptr).to(torch.int32)


# ---------------------------------------------------------------------------
# Specs and blocks
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec (JAX's ``PartitionSpec``): one entry a dimension,
    None, a mesh axis name or a tuple of them (split row-major in their
    order).  ``distributed/sharding.py`` computes full specs; ``expand``
    takes two: ``P()`` replicated and ``P(axes)`` over the leading
    dimension."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def _spec_axes(spec, mesh) -> Tuple[str, ...]:
    """The axes that ``spec`` splits the leading dimension over (``()``
    replicated); any other spec raises."""
    if not isinstance(spec, P):
        raise TypeError(f"spec {spec!r} is not a repro_torch P")
    if len(spec) == 0:
        return ()
    part = spec[0]
    axes = (part,) if isinstance(part, str) else \
        tuple(part) if isinstance(part, tuple) else None
    if len(spec) != 1 or not axes or \
            any(a not in mesh.mesh_dim_names for a in axes):
        raise ValueError(
            f"unsupported spec {spec!r} on a mesh of axes "
            f"{tuple(mesh.mesh_dim_names)}: the port supports P() and "
            "P(axes) over the leading dimension")
    return axes


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, "
                        f"not {type(mesh).__name__}")


def _check_devices(tree, mesh, what: str) -> None:
    """Refuse tensors of another device type than the mesh's: no region
    carries on on another device."""
    for t in leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type != mesh.device_type:
            raise ValueError(f"{what}: a tensor on {t.device} for a mesh on "
                             f"{mesh.device_type}")


def _block(t, axes: Tuple[str, ...], mesh):
    """This team's block of ``t``'s leading dimension over ``axes``."""
    if not axes or not isinstance(t, torch.Tensor):
        return t
    n = _teams(mesh, axes)
    if t.ndim == 0 or t.shape[0] % n:
        raise ValueError(f"a leading dimension of {tuple(t.shape)} does "
                         f"not split over {n} teams of {axes}")
    k = t.shape[0] // n
    return t.narrow(0, team_index(mesh, axes) * k, k)


def _gather(t, axes: Tuple[str, ...], mesh):
    if not axes or not isinstance(t, torch.Tensor):
        return t
    if t.ndim == 0:
        raise ValueError("a sharded output needs a leading dimension")
    return gather_blocks(t, mesh, axes)


def _per_output(out, out_specs, fn: Callable):
    """Apply ``fn(tensor, spec)`` to each output leaf: one spec for the
    whole output, or a tuple of specs for a tuple output."""
    if isinstance(out_specs, P):
        return tree_map(lambda t: fn(t, out_specs), out)
    if not isinstance(out, (tuple, list)) or len(out) != len(out_specs):
        raise ValueError(f"out_specs {out_specs!r} do not match the "
                         "region's output")
    return type(out)(tree_map(lambda t, s=s: fn(t, s), o)
                     for o, s in zip(out, out_specs))


# ---------------------------------------------------------------------------
# Expansion
# ---------------------------------------------------------------------------

def _with_sanitize(q):
    """Turn on the sanitized transport of a ``ShardedRpcQueue`` or an
    ``RpcQueue`` (in place, as the port's queues are updated); anything
    else (a sharded ``LogRing``) is returned unchanged, as JAX's.  Flip it
    only on a queue that has not enqueued yet: the sanitized arena
    brackets every payload with canaries."""
    for row in getattr(q, "shards", [q]):
        if hasattr(row, "sanitize"):
            row.sanitize = True
    return q


def _with_fault_policy(q, retry, timeout):
    """Set the drain's ``retry``/``timeout`` of a ``ShardedRpcQueue`` or an
    ``RpcQueue`` (in place); duck-typed carriers pass through, as in
    JAX.  Both are read at drain time, so an enqueued queue may take
    them."""
    if retry is None and timeout is None:
        return q
    for row in getattr(q, "shards", [q]):
        if hasattr(row, "retry"):
            row.retry, row.timeout = retry, timeout
    return q


def _n_rows(obj) -> int:
    inner = getattr(obj, "q", obj)
    return int(inner.n_devices)


def expand(fn: Callable, mesh, in_specs, out_specs, *, heap: bool = False,
           queue: bool = False, sanitize: bool = False, queue_retry=None,
           queue_timeout: Optional[float] = None,
           queue_async: bool = False) -> Callable:
    """Rewrite single-team ``fn`` for every team of ``mesh``.

    The returned callable takes the global arguments (one spec of
    ``in_specs`` each) on every rank; ``fn`` gets this team's block of
    each, runs under the team environment (the single-team primitives
    report global coordinates), and its output comes back per
    ``out_specs``: a ``P(axes)`` output gathered along its leading
    dimension, a ``P()`` one as this team computed it.

    ``heap=True`` / ``queue=True`` declare team-local runtime state: the
    callable then takes the sharded object(s) first, ``wrapped(heap,
    [queue,] *args)``, and returns ``(heap', [queue',] out)`` (see the
    module docstring); the objects have one row a team.
    ``sanitize=True`` switches the queue to the sanitized transport
    (pass one that has not enqueued yet); ``queue_retry`` /
    ``queue_timeout`` set its drain's fault policy; ``queue_async=True``
    asserts that the queue was created with ``mode="async"``."""
    _check_mesh(mesh)
    axes = tuple(mesh.mesh_dim_names)
    in_axes = tuple(_spec_axes(s, mesh) for s in in_specs)
    for s in ((out_specs,) if isinstance(out_specs, P) else out_specs):
        _spec_axes(s, mesh)
    n_extra = int(heap) + int(queue)

    @functools.wraps(fn)
    def wrapped(*call_args):
        if len(call_args) < n_extra:
            raise TypeError(f"expand(heap={heap}, queue={queue}) takes the "
                            f"sharded state as its first {n_extra} "
                            "argument(s)")
        extra, args = call_args[:n_extra], call_args[n_extra:]
        if len(args) != len(in_axes):
            raise TypeError(f"{len(args)} arguments for {len(in_axes)} "
                            "in_specs")
        if queue:
            q = extra[-1]
            if queue_async and getattr(getattr(q, "q", q), "mode",
                                       "sync") != "async":
                raise ValueError(
                    "expand(queue_async=True) was handed a synchronous "
                    "queue: the double-buffered transport's epoch slot is "
                    "allocated at create time, so build the queue with "
                    "RpcQueue.create(..., mode='async') (or "
                    "ShardedRpcQueue.create(..., mode='async')) instead "
                    "of flipping it per call")
            if sanitize:
                _with_sanitize(q)
            _with_fault_policy(q, queue_retry, queue_timeout)
            from repro_torch.core import rpc as _rpc
            try:
                _rpc.REGISTRY.note_queue_geometry(_rpc.queue_geometry(q))
            except (AttributeError, TypeError):
                pass               # duck-typed queue (a sharded LogRing)
        for obj in extra:
            if _n_rows(obj) != mesh.size():
                raise ValueError(f"a sharded object of {_n_rows(obj)} rows "
                                 f"for a mesh of {mesh.size()} teams")
            if torch.device(obj.device).type != mesh.device_type:
                raise ValueError(f"expand: a sharded object on {obj.device} "
                                 f"for a mesh on {mesh.device_type}")
        _check_devices(args, mesh, "expand")
        team = team_index(mesh, axes)
        blocks = [tree_map(lambda t, a=a: _block(t, a, mesh), arg)
                  for arg, a in zip(args, in_axes)]
        locals_ = [obj.team_local(team) for obj in extra]
        with _team_env(mesh, axes, 1, sanitize):
            if heap:
                _ENV.heap, _ENV.span = locals_[0], extra[0].span
            if queue:
                _ENV.queue = locals_[-1]
            out = fn(*blocks)
            if heap:
                locals_[0] = _ENV.heap
            if queue:
                locals_[-1] = _ENV.queue
        out = _per_output(out, out_specs,
                          lambda t, s: _gather(t, _spec_axes(s, mesh), mesh))
        if not n_extra:
            return out
        return tuple(obj.gathered(local, mesh)
                     for obj, local in zip(extra, locals_)) + (out,)

    return wrapped


def _device(arrays) -> Optional[torch.device]:
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def _empty_like_loop(body: Callable, arrays) -> torch.Tensor:
    """The (0, ...) result of a loop of no iterations: the shape and dtype
    of iteration 0's result, as ``lax.map`` traces its body for them."""
    with torch.no_grad():
        out = body(0, *arrays)
    return out.new_empty((0,) + tuple(out.shape))


def region_frame() -> Tuple[str, int, int]:
    """``(file, first line, last line)`` of :func:`expand`'s region
    wrapper: a call stack through it runs inside an expanded region (the
    graph walker's frame test)."""
    code = next(c for c in expand.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "wrapped")
    lines = [ln for _, _, ln in code.co_lines() if ln is not None]
    return code.co_filename, min(lines), max(lines)


def parallel_for(body: Callable, n: int, *arrays, mesh=None, device=None
                 ) -> torch.Tensor:
    """Expanded execution of ``for i in range(n): out[i] = body(i,
    *arrays)``: every iteration a lane of one ``torch.vmap`` over
    ``arange(n)`` (int32, as JAX's).  ``body`` must be pure; an op without
    a batching rule falls back to a loop inside vmap (PyTorch warns when
    its fallback warning is on).

    With a ``mesh`` of several teams the iterations are block-distributed
    (``omp distribute parallel for``): team ``t`` runs ``per = ceil(n /
    D)`` lanes from ``t * per``, the lanes past ``n`` recompute iteration
    ``n - 1`` (so the body never sees an index out of range), and the
    blocks are all-gathered and cut to ``n``.  A mesh of one team takes
    the path without one, as JAX's.

    The lane index lies on ``device``; without it, on the first tensor
    argument's device, and without one, on torch's default device
    (``arange``'s own default; JAX's ``jnp.arange`` lands on JAX's).
    A body that only closes over card tensors therefore passes
    ``device=``; left out, the index lies on the default device and the
    body's first mixed-device op raises."""
    if mesh is not None:
        _check_mesh(mesh)
        _check_devices(arrays, mesh, "parallel_for")
        if device is not None and torch.device(device).type != \
                mesh.device_type:
            raise ValueError(f"parallel_for: device {device} for a mesh on "
                             f"{mesh.device_type}")
    if n == 0:
        return _empty_like_loop(body, arrays)
    if device is None:
        device = _device(arrays) or (mesh.device_type if mesh is not None
                                     else None)
    if mesh is None or mesh.size() == 1:
        idx = torch.arange(n, dtype=torch.int32, device=device)
        return torch.vmap(lambda i: body(i, *arrays))(idx)
    axes = tuple(mesh.mesh_dim_names)
    D = mesh.size()
    per = -(-n // D)
    with _team_env(mesh, axes, per):
        start = team_index(mesh, axes) * per
        idx = torch.clamp(torch.arange(start, start + per, dtype=torch.int32,
                                       device=device), max=n - 1)
        out = torch.vmap(lambda i: body(i, *arrays))(idx)
    out = gather_blocks(out, mesh, axes)
    return out if per * D == n else out[:n]


def serial_for(body: Callable, n: int, *arrays) -> torch.Tensor:
    """Single-team execution of the same loop: a sequential Python loop,
    ``i`` a Python int, the results stacked.  The host enqueues each
    iteration's kernels in order and never waits for the device.  Under
    an event capture the loop runs inside ``events.loop_scope(n)`` (JAX's
    capture scopes the ``lax.map`` its ``serial_for`` is)."""
    if n == 0:
        return _empty_like_loop(body, arrays)
    outs = []
    with (events.loop_scope(n) if events.active()
          else events.NO_LOOP) as trip:
        for i in range(n):
            trip.next()
            outs.append(body(i, *arrays))
    return torch.stack(outs)
