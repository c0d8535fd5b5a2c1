"""Logical-axis sharding (the JAX package's ``repro/distributed/
sharding.py``): the model names every tensor dimension with a logical
axis ("batch", "heads", "ffn", ...), and a rules table maps logical names
onto mesh axes.

The table, :class:`ShardingCtx`, :func:`logical_spec` (with its
divisibility guard), :func:`param_sharding_tree` and ZeRO-1
(:func:`zero1_spec`) compute the specs JAX computes, entry for entry, as
the port's :class:`~repro_torch.core.expand.P`.  A mesh is a
``DeviceMesh`` (:mod:`repro_torch.launch.mesh`) or an
:class:`AbstractMesh` (axis names and sizes, no processes: specs at the
production shapes of ``launch/mesh.py::production_shape``).

Eager PyTorch has no GSPMD partitioner, so what JAX's ``jit`` does with a
:class:`NamedSharding` the port does by hand: :func:`shard_tree` cuts a
full tree to this rank's blocks, :func:`gather_tree` all-gathers blocks
back to full tensors, and :func:`reduce_block` sums a per-rank gradient
over the ranks and cuts it to this rank's block.  A block is this rank's slice of
every dimension: a dimension split over a tuple of axes is cut row-major
over them, in their order (the order of JAX's device layout), and
:func:`with_logical_constraint` only validates (it re-lays nothing: the
activations of a rank are what its own rows compute).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.expand import P

AxisVal = Union[None, str, Tuple[str, ...]]

# (logical axis -> mesh axes), JAX's table entry for entry: ``pod``
# composes with ``data`` for data parallelism; ``model`` carries TP/EP/SP.
LOGICAL_RULES: Tuple[Tuple[str, AxisVal], ...] = (
    ("batch",      ("pod", "data")),   # global batch (DP)
    ("seq",        None),              # activations keep the full sequence
    ("seq_shard",  "model"),           # sequence-parallel alternative (SP)
    ("seq_kv",     "model"),           # KV-cache sequence dim (decode)
    ("embed",      None),              # d_model on activations: replicated
    ("embed_p",    "model"),           # d_model on the embedding table
    ("fsdp",       "data"),            # weight in-dims: ZeRO-3/FSDP over data
    ("vocab",      "model"),           # vocab-parallel embedding / lm head
    ("heads",      "model"),           # q heads (TP)
    ("kv_heads",   "model"),           # kv heads (TP)
    ("kv_heads_r", None),              # kv replicated (``kv_repl``)
    ("head_dim",   None),
    ("qkv",        "model"),           # flattened q/kv projection output dim
    ("ffn",        "model"),           # MLP hidden (TP)
    ("experts",    "model"),           # MoE expert dim (EP)
    ("expert_ffn", None),              # per-expert hidden: unsharded under EP
    ("ssm_inner",  "model"),           # SSM inner width
    ("ssm_heads",  "model"),           # SSD heads
    ("ssm_state",  None),
    ("lru",        "model"),           # RG-LRU width
    ("conv",       None),
    ("capacity",   None),
    ("tokens",     ("pod", "data", "model")),  # flattened tokens (MoE)
    ("stack",      None),              # scan-stacked layer dim (JAX only)
    ("window",     None),
)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes without processes (JAX's
    ``jax.sharding.AbstractMesh``): enough to compute specs."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return {a: mesh.size(i) for i, a in enumerate(mesh_axis_names(mesh))}


def mesh_size(mesh) -> int:
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules = dict(LOGICAL_RULES)
        # the mesh axes a rank's rows of activations are split over, and
        # whether the expert weights are its blocks (the sharded training
        # step sets both; see train/step.py)
        self.row_axes: Tuple[str, ...] = ()
        self.expert_blocks = False


_CTX = _Ctx()


@contextlib.contextmanager
def ShardingCtx(mesh, rules: Optional[Sequence[Tuple[str, AxisVal]]] = None):
    """Install a mesh and logical rules (JAX's defaults updated by
    ``rules``) for the enclosed code, on this thread.  ``mesh=None`` runs
    the same model code unexpanded."""
    old = _snapshot()
    merged = dict(LOGICAL_RULES)
    if rules:
        merged.update(dict(rules))
    _restore((mesh, merged, (), False))
    try:
        yield
    finally:
        _restore(old)


def _snapshot():
    return _CTX.mesh, _CTX.rules, _CTX.row_axes, _CTX.expert_blocks


def _restore(snapshot) -> None:
    _CTX.mesh, _CTX.rules, _CTX.row_axes, _CTX.expert_blocks = snapshot


def current_mesh():
    """The mesh of the enclosing :class:`ShardingCtx`, else None."""
    return _CTX.mesh


@contextlib.contextmanager
def rows_over(axes: Tuple[str, ...], expert_blocks: bool = False):
    """Declare that the enclosed activations hold this rank's block of
    rows, split over mesh ``axes`` (row-major, in the mesh's order) and
    the same on the other axes; ``expert_blocks`` that the MoE layers'
    expert weights are this rank's ``E / ep`` experts (the sharded step's
    blocks), not all ``E``."""
    old = _snapshot()
    _CTX.row_axes, _CTX.expert_blocks = tuple(axes), bool(expert_blocks)
    try:
        yield
    finally:
        _restore(old)


def row_axes() -> Tuple[str, ...]:
    return _CTX.row_axes


def expert_blocks() -> bool:
    return _CTX.expert_blocks


def current_rules() -> Tuple[Tuple[str, AxisVal], ...]:
    """The rules table in force (JAX's defaults and the context's)."""
    return tuple(_CTX.rules.items())


@contextlib.contextmanager
def _installed(snapshot):
    old = _snapshot()
    _restore(snapshot)
    try:
        yield
    finally:
        _restore(old)


def checkpoint_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: the recompute sees
    the forward's sharding context.  Autograd runs a CUDA backward, and
    with it the recompute, on its own device thread, where this module's
    thread-local context is not set."""
    return contextlib.nullcontext(), _installed(_snapshot())


def _resolve(axis: Optional[str]) -> AxisVal:
    if axis is None:
        return None
    try:
        val = _CTX.rules[axis]
    except KeyError:
        raise KeyError(f"unknown logical axis {axis!r}") from None
    mesh = _CTX.mesh
    if mesh is None:
        return None
    names = mesh_axis_names(mesh)
    # drop mesh axes this mesh does not have (e.g. "pod" on one pod)
    if isinstance(val, tuple):
        kept = tuple(a for a in val if a in names)
        return kept if kept else None
    if isinstance(val, str) and val not in names:
        return None
    return val


def entry_axes(entry: AxisVal) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, val: AxisVal) -> int:
    """How many ranks a spec entry (an axis or a tuple of them) spans."""
    shape = mesh_shape(mesh)
    n = 1
    for a in entry_axes(val):
        n *= shape[a]
    return n


def logical_spec(*logical_axes: Optional[str],
                 shape: Optional[Sequence[int]] = None) -> P:
    """Logical axis names (one a dimension) -> a full per-dimension
    :class:`P`.  With ``shape``, an axis that does not divide its
    dimension is dropped (replicated), as JAX's guard drops it."""
    mesh = _CTX.mesh
    vals = [_resolve(a) for a in logical_axes]
    if shape is not None and mesh is not None:
        vals = [v if dim % axis_size(mesh, v) == 0 else None
                for v, dim in zip(vals, shape)]
    return P(*vals)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P

    def entries(self, ndim: int) -> Tuple[AxisVal, ...]:
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def block_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one rank's block of a ``shape`` tensor."""
        return tuple(d // axis_size(self.mesh, e)
                     for d, e in zip(shape, self.entries(len(shape))))

    def replicas(self) -> int:
        """How many ranks hold each block."""
        used = 1
        for e in self.spec:
            used *= axis_size(self.mesh, e)
        return mesh_size(self.mesh) // used


def logical_sharding(*logical_axes: Optional[str],
                     shape: Optional[Sequence[int]] = None
                     ) -> Optional[NamedSharding]:
    mesh = _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_spec(*logical_axes, shape=shape))


def with_logical_constraint(x: torch.Tensor,
                            *logical_axes: Optional[str]) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` in logical names: a no-op without
    a mesh; under one it checks the rank and the names and returns ``x``
    (a rank computes its own rows; nothing is re-laid)."""
    if _CTX.mesh is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"constraint rank mismatch: {len(logical_axes)} "
                         f"axes for ndim={x.ndim}")
    for a in logical_axes:
        _resolve(a)
    return x


def device_axis_spec(mesh) -> P:
    """Spec of the sharded runtime's leading device axis
    (``ShardedHeap``/``ShardedRpcQueue`` rows): dim 0 over every axis."""
    return P(mesh_axis_names(mesh))


def place_sharded_state(obj, mesh):
    """Check that a sharded runtime object (one row a team, stacked on
    every rank, as ``core/expand.py`` takes it) lives on the mesh's
    device type, and return it: the port's ``expand`` hands each team its
    row, so nothing moves (JAX ``device_put``s the rows one a device)."""
    dev = torch.device(getattr(obj, "device", mesh.device_type))
    if dev.type != mesh.device_type:
        raise ValueError(f"a sharded object on {dev} for a mesh on "
                         f"{mesh.device_type}")
    return obj


# ---------------------------------------------------------------------------
# Trees of axes and shardings
# ---------------------------------------------------------------------------

def is_axes_leaf(v) -> bool:
    return isinstance(v, tuple) and all(
        a is None or isinstance(a, str) for a in v)


def map_axes(fn: Callable, axes: Any, *rest: Any) -> Any:
    """``fn(axes_tuple, *matching leaves of rest)`` over an axes tree
    (dicts and lists of axes tuples), keeping its structure."""
    if is_axes_leaf(axes):
        return fn(axes, *rest)
    if isinstance(axes, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes.items()}
    if isinstance(axes, (list, tuple)):
        return [map_axes(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(axes)]
    raise TypeError(f"not an axes tree node: {axes!r}")


def axes_leaves(axes: Any) -> list:
    """The axes tuples of an axes tree in :func:`~repro_torch.tree.leaves`
    order (dict keys sorted)."""
    if is_axes_leaf(axes):
        return [axes]
    if isinstance(axes, dict):
        return [x for k in sorted(axes) for x in axes_leaves(axes[k])]
    return [x for v in axes for x in axes_leaves(v)]


def param_sharding_tree(param_axes, mesh, rules=None, like=None):
    """A tree of logical-axes tuples -> :class:`NamedSharding` leaves under
    ``mesh``; ``like`` (a matching tree with ``.shape``) turns on the
    divisibility guard."""
    with ShardingCtx(mesh, rules):
        if like is None:
            return map_axes(lambda a: logical_sharding(*a), param_axes)
        return map_axes(lambda a, l: logical_sharding(*a, shape=l.shape),
                        param_axes, like)


def zero1_spec(spec: P, shape, mesh, axis: str = "data") -> P:
    """ZeRO-1: additionally shard one unsharded, divisible dim over
    ``axis`` (for fp32 optimizer state whose parameter is replicated or
    partly sharded)."""
    if mesh is None or axis not in mesh_axis_names(mesh):
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        used.update(entry_axes(e))
    if axis in used:
        return spec
    n = mesh_shape(mesh)[axis]
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % n == 0:
            entries[i] = axis
            return P(*entries)
    return spec


def zero1_sharding_tree(v_shard, like, mesh, axis: str = "data"):
    """The ZeRO-1 shardings of a tree of value shardings."""
    def one(sh, l):
        if sh is None:
            return None
        return NamedSharding(mesh, zero1_spec(sh.spec, l.shape, mesh, axis))
    return _map_leaves(one, v_shard, like)


def _map_leaves(fn, tree, *rest):
    """``fn`` over a tree whose leaves are shardings, tensors, ShapeDtypes
    or None (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Blocks: cut, gather, reduce (the port's explicit GSPMD)
# ---------------------------------------------------------------------------

def _live(mesh, axes: Tuple[str, ...]) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in axes if shape[a] > 1)


def refinement(inner: NamedSharding, outer: NamedSharding, ndim: int
               ) -> NamedSharding:
    """The sharding of ``outer``'s blocks within ``inner``'s: the axes
    ``outer`` splits each dim over beyond ``inner``'s (``outer`` refines
    ``inner``: it splits every dim ``inner`` splits, the same way first)."""
    return NamedSharding(outer.mesh, P(*(
        tuple(a for a in entry_axes(eo) if a not in entry_axes(ei)) or None
        for ei, eo in zip(inner.entries(ndim), outer.entries(ndim)))))


def block(t, sharding: Optional[NamedSharding]):
    """This rank's block of the full tensor (or numpy array) ``t``: a
    view, ``t`` itself when nothing is cut."""
    if sharding is None or not hasattr(t, "shape"):
        return t
    from repro_torch.distributed.collectives import team_index
    mesh, index, cut = sharding.mesh, [], False
    for d, e in zip(t.shape, sharding.entries(len(t.shape))):
        axes = _live(mesh, entry_axes(e))
        k = d // axis_size(mesh, axes)
        i = team_index(mesh, axes) if axes else 0
        index.append(slice(i * k, (i + 1) * k))
        cut = cut or bool(axes)
    return t[tuple(index)] if cut else t


def gather(t: torch.Tensor, sharding: Optional[NamedSharding]
           ) -> torch.Tensor:
    """The full tensor from this rank's block ``t``: an all-gather a
    sharded dimension."""
    if sharding is None or not isinstance(t, torch.Tensor):
        return t
    from repro_torch.distributed.collectives import gather_blocks
    mesh = sharding.mesh
    for d, e in enumerate(sharding.entries(t.ndim)):
        axes = _live(mesh, entry_axes(e))
        if axes:
            t = gather_blocks(t.movedim(d, 0), mesh, axes).movedim(0, d)
    return t


def all_reduce_sum(t: torch.Tensor, mesh, axes: Optional[Sequence[str]] = None
                   ) -> torch.Tensor:
    """Sum over ``axes`` (all of the mesh's by default); axes of one rank
    are skipped."""
    from repro_torch.distributed.collectives import _all_reduce
    axes = _live(mesh, tuple(axes) if axes is not None
                 else mesh_axis_names(mesh))
    return _all_reduce(t, mesh, axes) if axes else t


def shard_tree(tree, shardings):
    """A full tree -> this rank's blocks (a copy of each block that is cut,
    so the full tensor can be freed; an uncut leaf is kept as is)."""
    def one(t, sh):
        b = block(t, sh)
        return b.clone() if b is not t else t
    return _map_leaves(one, tree, shardings)


def gather_tree(tree, shardings):
    """A tree of blocks -> full tensors."""
    return _map_leaves(gather, tree, shardings)


def reduce_block(g: torch.Tensor, computed: NamedSharding,
                 target: NamedSharding) -> torch.Tensor:
    """Per-rank gradient ``g`` of a leaf computed as ``computed``'s block
    (whole on its other dims), each rank's over a disjoint share of the
    loss -> the sum over the ranks, cut to ``target``'s block (``target``
    refines ``computed``): a reduce-scatter over each axis that
    ``target`` cuts beyond ``computed``, along its dim, then an
    all-reduce over the summed axes that cut nothing.  Summed in fp32
    when ranks are summed, returned in ``g``'s dtype."""
    from repro_torch.distributed.collectives import reduce_scatter_dim
    mesh = target.mesh
    held = {a for e in computed.spec for a in entry_axes(e)}
    summed = _live(mesh, tuple(a for a in mesh_axis_names(mesh)
                               if a not in held))
    if not summed:
        b = block(g, refinement(computed, target, g.ndim))
        return b.clone() if b is not g else g
    out, cut = g.float(), set()
    # an axis cuts one dim at most; within a dim the first axis is major
    for d, e in enumerate(refinement(computed, target, g.ndim)
                          .entries(g.ndim)):
        for a in _live(mesh, entry_axes(e)):
            out = reduce_scatter_dim(out, a, d, mesh)
            cut.add(a)
    rest = tuple(a for a in summed if a not in cut)
    if rest:
        out = all_reduce_sum(out, mesh, rest)
    return out.to(g.dtype)
