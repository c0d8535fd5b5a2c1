"""Meshes on ``torch.distributed`` (the JAX package's
``repro/launch/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with JAX's
axis names over a world of processes, one process a device (a team of
``core/expand.py``).  The program is SPMD: every rank runs the same code.
Nothing here touches ``torch.distributed`` at import time.

A world is started by :func:`init_world`: a ``FileStore`` at a path that
no other world uses (tests give every world one in their own temporary
directory), or, for a world of one, an in-process ``HashStore``; the
backend is ``gloo`` on the CPU, and on the card ``nccl`` (beside ``gloo``
for CPU tensors).  Every collective waits at most :data:`TIMEOUT_S`
seconds, so a rank that dies cannot hang its peers for good.
"""
from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: The debug and production meshes' axes (JAX's).
DEBUG_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
#: Seconds a collective of a world waits for its peers.
TIMEOUT_S = 120.0


def _backend(device: str) -> str:
    return "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda" \
        else "gloo"


def init_world(rank: int = 0, world_size: int = 1, *,
               store_path: Optional[str] = None, device="cuda") -> None:
    """Join rank ``rank`` of a world of ``world_size`` processes for
    meshes on ``device`` (the card unless the caller asks for the CPU).
    ``store_path`` names the world's ``FileStore``; a world of one may
    leave it out.  A process that already belongs to a world of this size
    and rank keeps it.  On the card the rank's device is
    ``cuda:rank % device_count``."""
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
            raise RuntimeError(
                f"this process is rank {dist.get_rank()} of a world of "
                f"{dist.get_world_size()}, not rank {rank} of {world_size}")
        return
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "for a world on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if store_path is None:
        if world_size != 1:
            raise ValueError("a world of several ranks needs store_path")
        store = dist.HashStore()
    else:
        store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        _backend(device), store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def close_world() -> None:
    """Leave the world (every rank calls it), if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_device() -> str:
    """The device type the world was started for: ``cuda`` where its
    backend carries CUDA tensors, else ``cpu``."""
    if not dist.is_initialized():
        raise RuntimeError("no world: call init_world first")
    return "cuda" if "nccl" in str(dist.get_backend()).lower() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: Optional[str] = None):
    """A mesh of ``shape`` over the whole world with axis names ``axes``
    (JAX's ``jax.make_mesh``), on ``device`` (by default the world's)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import init_device_mesh
    # a program being exported may make its mesh: the mesh's own tensors
    # are real, never the trace's fake ones
    with unset_fake_temporarily():
        return init_device_mesh(device or world_device(), tuple(shape),
                                mesh_dim_names=tuple(axes))


def make_rank_mesh(axis: str = "dev", *, device: Optional[str] = None):
    """Every rank's own one-device mesh on axis ``axis`` (JAX's mesh of
    one of its devices): collective over the world to make, then each
    rank's alone."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((world, 1), ("world", axis), device=device)[axis]


def one_device_mesh(axis: str = "dev", *, device="cuda"):
    """A mesh of one device on axis ``axis`` for this process: its own
    rank's in a world (:func:`make_rank_mesh`), else that of a world of
    one started here for ``device`` (the card unless the caller asks for
    the CPU)."""
    if not dist.is_initialized():
        init_world(device=device)
    return make_rank_mesh(axis, device=torch.device(device).type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    device: Optional[str] = None):
    """The small ``(data, model)`` mesh of the tests."""
    return make_mesh((n_data, n_model), DEBUG_AXES, device=device)


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """16 x 16 = 256 devices a pod; 2 pods = 512 for the multi-pod run."""
    if multi_pod:
        return (2, 16, 16), POD_AXES
    return (16, 16), DEBUG_AXES


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None):
    """The production mesh: a world of 256 ranks (512 with
    ``multi_pod``), real or the dry run's ``fake`` one
    (``launch/dryrun.py::production_mesh``)."""
    shape, axes = production_shape(multi_pod)
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(
            f"the production mesh {shape} needs a world of {need} ranks, "
            f"not {world}; the dry run starts a fake world of that size "
            "(launch/dryrun.py)")
    return make_mesh(shape, axes, device=device)
