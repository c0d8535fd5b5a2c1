"""Parallelism expansion (paper §3.3), for one team.

The port of ``repro/core/expand.py``'s single-team vocabulary and its
measurable contrast:

* :func:`team_id`, :func:`num_teams`, :func:`thread_id`,
  :func:`num_threads`, :func:`barrier` and :func:`ws_range` (the ``omp
  for`` static schedule): what legacy-style code is written against.
  Without a mesh there is one team of one thread, as in the JAX package
  outside an expanded region.
* :func:`parallel_for`, the expanded execution of ``for i in range(n):
  out[i] = body(i, *arrays)``: the body runs once under ``torch.vmap``
  over ``torch.arange(n)`` (every iteration a lane), and
  :func:`serial_for`, the same loop as a sequential Python loop that
  stacks the per-iteration results (``lax.map``'s single-team semantics,
  the baseline column of the paper's Fig. 8-10).

``parallel_for(mesh=)``, ``expand`` and the team heap and queue accessors
spread a region over several devices: ROADMAP queue 1, item 5.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

_MESH = "ROADMAP queue 1, item 5 (expansion over several devices)"


def team_id() -> torch.Tensor:
    """Continuous team id across the machine: 0 with one team (a 0-d CPU
    tensor, which torch takes as a scalar beside CUDA tensors)."""
    return torch.zeros((), dtype=torch.int32)


def num_teams() -> int:
    return 1


def thread_id(lane=None) -> torch.Tensor:
    """Continuous global thread id = team_id * lanes + lane (paper Fig. 4);
    one lane a team without expansion."""
    return team_id() if lane is None else team_id() + lane


def num_threads() -> int:
    return num_teams()


def barrier() -> None:
    """Cross-team barrier: nothing to order with one team."""


def ws_range(n: int) -> Tuple[torch.Tensor, int]:
    """``omp for schedule(static)`` over [0, n): this team's (start,
    count)."""
    teams = num_teams()
    if n % teams:
        raise ValueError(f"iteration space {n} must tile {teams} teams")
    per = n // teams
    return team_id() * per, per


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


def parallel_for(body: Callable, n: int, *arrays, mesh=None
                 ) -> torch.Tensor:
    """Expanded execution of ``for i in range(n): out[i] = body(i,
    *arrays)``: every iteration a lane of one ``torch.vmap`` over
    ``arange(n)`` (int32, as JAX's).  ``body`` must be pure; an op without
    a batching rule falls back to a loop inside vmap (PyTorch warns when
    its fallback warning is on)."""
    if mesh is not None:
        raise NotImplementedError(f"parallel_for(mesh=) needs {_MESH}")
    if n == 0:
        return _empty_like_loop(body, arrays)
    idx = torch.arange(n, dtype=torch.int32, device=_device(arrays))
    return torch.vmap(lambda i: body(i, *arrays))(idx)


def serial_for(body: Callable, n: int, *arrays) -> torch.Tensor:
    """Single-team execution of the same loop: a sequential Python loop,
    ``i`` a Python int, the results stacked.  The host enqueues each
    iteration's kernels in order and never waits for the device."""
    if n == 0:
        return _empty_like_loop(body, arrays)
    return torch.stack([body(i, *arrays) for i in range(n)])


def _needs_mesh(name: str) -> Callable:
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{name} needs {_MESH}")
    refuse.__name__ = name
    refuse.__doc__ = f"``{name}`` of the multi-team rewrite: not ported yet."
    return refuse


expand = _needs_mesh("expand")
team_heap = _needs_mesh("team_heap")
set_team_heap = _needs_mesh("set_team_heap")
team_queue = _needs_mesh("team_queue")
set_team_queue = _needs_mesh("set_team_queue")
team_ptr = _needs_mesh("team_ptr")
