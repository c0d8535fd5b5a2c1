"""Mesh-aware collectives (the JAX package's
``repro/distributed/collectives.py``) over a ``DeviceMesh``.

JAX's helpers run inside ``shard_map`` and name mesh axes; here they take
the mesh (by default the mesh of the expanded region they run in,
``core/expand.py``) and run each axis's collective on that axis's process
group (``mesh.get_group(axis)``).  The reductions and gathers are
``torch.distributed._functional_collectives``, which ``torch.export``
traces as graph nodes; :func:`broadcast_from_first` is an in-place
``torch.distributed.broadcast`` (the queue drain's reply broadcast, never
exported).

* :func:`hierarchical_psum`: reduce-scatter over ``intra_axis``,
  all-reduce over ``inter_axis``, all-gather over ``intra_axis``; JAX's
  flat fall-backs without an inter axis, for a 0-d tensor, or a leading
  dimension that ``intra_axis`` does not divide.
* :func:`all_to_all_tokens`: tiled all-to-all (split, send chunk ``j`` to
  rank ``j``, concatenate what arrives in rank order), differentiable (its
  backward is the reverse all-to-all), as are :func:`psum_autograd` and
  :func:`gather_autograd` (the MoE layer's collectives in training).
* :func:`reduce_scatter_dim`: a sum over one axis cut along any dim
  (the sharded step's gradients to their ZeRO-1 blocks).
* :func:`barrier`, :func:`global_norm_sq`.
* :func:`gather_blocks`: every team's block along dim 0, row-major over
  the axes (how an expanded region's sharded outputs come back whole).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.tree import leaves

Axes = Union[str, Sequence[str], None]
_all_gather = getattr(funcol, "all_gather_single", None) or \
    funcol.all_gather_tensor
_reduce_scatter = getattr(funcol, "reduce_scatter_single", None) or \
    funcol.reduce_scatter_tensor


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.core.expand import current_mesh
    found = current_mesh()
    if found is None:
        raise RuntimeError("a collective outside an expanded region needs "
                           "mesh=")
    return found


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _axes(mesh, axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return mesh_axes(mesh)
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh_axes(mesh).index(axis))


def team_index(mesh, axes: Axes = None) -> int:
    """This rank's position on ``axes`` (all of the mesh's by default),
    row-major in axis order (JAX's ``team_id``)."""
    names, coord = mesh_axes(mesh), mesh.get_coordinate()
    idx = 0
    for ax in _axes(mesh, axes):
        i = names.index(ax)
        idx = idx * mesh.size(i) + int(coord[i])
    return idx


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def gather_blocks(t: torch.Tensor, mesh=None, axes: Axes = None
                  ) -> torch.Tensor:
    """Every team's ``t`` concatenated along dim 0 in team order over
    ``axes`` (row-major in axis order): one all-gather an axis, the last
    axis first."""
    mesh = _mesh(mesh)
    for ax in reversed(_axes(mesh, axes)):
        t = _wait(_all_gather(t.contiguous(), 0, mesh.get_group(ax)))
    return t


def broadcast_from_first(t: torch.Tensor, mesh) -> torch.Tensor:
    """Overwrite ``t`` on every rank of ``mesh`` with the first team's
    (coordinate 0 on every axis): a broadcast an axis, in axis order, each
    from the rank at 0 on that axis (which holds the first team's ``t``
    once the axes before it are done)."""
    coord = tuple(mesh.get_coordinate())
    for i, ax in enumerate(mesh_axes(mesh)):
        src = int(mesh.mesh[coord[:i] + (0,) + coord[i + 1:]])
        dist.broadcast(t, src, group=mesh.get_group(ax))
    return t


def _all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    for ax in axes:
        x = _wait(funcol.all_reduce(x, "sum", mesh.get_group(ax)))
    return x


def hierarchical_psum(x: torch.Tensor, mesh=None, *, intra_axis: str = "data",
                      inter_axis: Optional[str] = "pod") -> torch.Tensor:
    """Pod-hierarchical sum over ``intra_axis`` and ``inter_axis``:
    reduce-scatter over ``intra_axis``, all-reduce over ``inter_axis``,
    all-gather over ``intra_axis`` (the slow inter-pod links carry
    ``1/intra`` of the bytes).  A flat sum over ``intra_axis`` alone
    without an inter axis on the mesh, over both for a 0-d tensor or a
    leading dimension that ``intra_axis`` does not divide."""
    mesh = _mesh(mesh)
    if inter_axis is None or inter_axis not in mesh_axes(mesh):
        return _all_reduce(x, mesh, (intra_axis,))
    n = _size(mesh, intra_axis)
    if x.ndim == 0 or x.shape[0] % n:
        return _all_reduce(x, mesh, (intra_axis, inter_axis))
    shard = _wait(_reduce_scatter(
        x.contiguous(), "sum", 0, mesh.get_group(intra_axis)))
    shard = _all_reduce(shard, mesh, (inter_axis,))
    return gather_blocks(shard, mesh, intra_axis)


def reduce_scatter_dim(x: torch.Tensor, axis: str, dim: int, mesh
                       ) -> torch.Tensor:
    """Sum over ``axis`` and keep this rank's block of dim ``dim`` (block
    ``i`` of ``n`` equal ones for the rank at ``i`` on the axis): one
    reduce-scatter."""
    return _wait(_reduce_scatter(x.contiguous(), "sum", dim,
                                 mesh.get_group(axis)))


def all_to_all_tokens(x: torch.Tensor, axis: str, *, split_dim: int,
                      concat_dim: int, mesh=None) -> torch.Tensor:
    """Tiled all-to-all over ``axis`` (JAX's ``lax.all_to_all(...,
    tiled=True)``, the MoE dispatch): ``x`` split into ``n`` equal chunks
    along ``split_dim``, chunk ``j`` sent to rank ``j`` of the axis, the
    chunks received concatenated along ``concat_dim`` in rank order."""
    mesh = _mesh(mesh)
    n = _size(mesh, axis)
    split_dim %= x.ndim
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all_tokens: dim {split_dim} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    if n == 1:
        return x
    moved = x.movedim(split_dim, 0).contiguous()
    got = _wait(funcol.all_to_all_single_autograd(
        moved, None, None, mesh.get_group(axis)))
    chunks = got.movedim(0, split_dim).chunk(n, dim=split_dim)
    return torch.cat(chunks, dim=concat_dim)


def psum_autograd(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes`` whose backward sums the cotangents over them
    (JAX's ``psum`` under ``grad``); axes of one rank are skipped."""
    from torch.distributed.nn.functional import all_reduce
    for ax in _axes(mesh, axes):
        if _size(mesh, ax) > 1:
            x = all_reduce(x, group=mesh.get_group(ax))
    return x


def gather_autograd(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """:func:`gather_blocks`, differentiable: the backward hands each
    team the cotangent of its block, summed over the ranks."""
    for ax in reversed(_axes(mesh, axes)):
        if _size(mesh, ax) > 1:
            x = _wait(funcol.all_gather_tensor_autograd(
                x.contiguous(), 0, mesh.get_group(ax)))
    return x


def barrier(axis: Axes = None, mesh=None) -> None:
    """Cross-team barrier over ``axis`` (all axes by default): a trivial
    all-reduce, which orders every rank of the axis (JAX's ``psum`` of a
    zero)."""
    mesh = _mesh(mesh)
    zero = torch.zeros((), dtype=torch.float32, device=mesh.device_type)
    _all_reduce(zero, mesh, _axes(mesh, axis))


def global_norm_sq(tree: Any, axis: Axes = None, mesh=None) -> torch.Tensor:
    """Sum of the squared L2 norms of a tree's tensors in fp32, summed
    over ``axis`` when given."""
    total = sum(torch.sum(torch.square(t.to(torch.float32)))
                for t in leaves(tree) if isinstance(t, torch.Tensor))
    if axis is not None:
        mesh = _mesh(mesh)
        total = _all_reduce(total, mesh, _axes(mesh, axis))
    return total
