"""Paper Fig. 9b: the HeCBench "hypterm" stencil, the ExpCNS Navier-Stokes
flux (the JAX package's ``benchmarks/hypterm_bench.py``).

Three parallel regions, one a spatial direction, each an 8th-order central
difference over a 3-D grid of 5 conserved variables.

The single-team body (``plane_body``) computes plane ``i``'s flux from a
9-plane slab of the grid rolled by 4 along x.  JAX slices the slab with
``dynamic_slice_in_dim``, which clamps the start to ``NX - 9``, so planes
``NX - 8`` .. ``NX - 1`` all read the slab at ``NX - 9``; the port keeps
that (``index_select`` of ``clamp(i, 0, NX - 9) + arange(9)``: a narrow
with a tensor start has no batching rule).  The manual column,
``flux_region(q, axis).sum()``, is another function of ``q``; the port
keeps each column equal to JAX's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.expand import parallel_for, serial_for
from repro_torch.evaluation.common import Region

NX = NY = NZ = 24
VARS = 5
#: 8th-order central difference coefficients (float32, as JAX's array).
ALP = tuple(float(c) for c in np.asarray(
    [0.8, -0.2, 0.038095238095238, -0.003571428571429], np.float32))
SLAB = 9


def _diff(u, axis):
    """8th-order central difference along ``axis`` (periodic roll)."""
    out = torch.zeros_like(u)
    for k, c in enumerate(ALP, start=1):
        out = out + c * (torch.roll(u, -k, axis) - torch.roll(u, k, axis))
    return out


def flux_region(q, axis):
    """One hypterm parallel region: the flux difference along ``axis``."""
    rho, u, v, w, e = [q[..., i] for i in range(VARS)]
    vel = (u, v, w)[axis]
    frho = _diff(rho * vel, axis)
    fu = _diff(rho * u * vel + (axis == 0) * e, axis)
    fv = _diff(rho * v * vel + (axis == 1) * e, axis)
    fw = _diff(rho * w * vel + (axis == 2) * e, axis)
    fe = _diff((e + rho) * vel, axis)
    return torch.stack([frho, fu, fv, fw, fe], dim=-1)


def _slab(i, qq):
    """Planes ``start .. start + 8`` of ``qq`` rolled by 4 along x, with
    JAX's clamped ``start = min(max(i, 0), NX - 9)``."""
    nx = qq.shape[0]
    start = i.clamp(0, nx - SLAB) if isinstance(i, torch.Tensor) \
        else min(max(i, 0), nx - SLAB)
    idx = torch.arange(SLAB, device=qq.device) + start
    return torch.roll(qq, 4, 0).index_select(0, idx)


def plane_body(i, qq, axis):
    """Plane ``i``'s flux, summed (single-team semantics: one x-plane an
    iteration)."""
    return flux_region(_slab(i, qq), axis)[4].sum()


def plane_magnitude(i, qq, axis):
    """The sum of the absolute terms behind ``plane_body(i, qq, axis)``:
    the scale its cancelling sum is compared at."""
    return flux_region(_slab(i, qq), axis)[4].abs().sum()


def flux_regions(q, n_serial: Optional[int] = None) -> List[Region]:
    n = q.shape[0]
    out = []
    for axis in range(3):
        def body(i, qq, axis=axis):
            return plane_body(i, qq, axis)

        def mag(i, qq, axis=axis):
            return plane_magnitude(i, qq, axis)

        out.append(Region(
            f"fig9b/hypterm_pr{axis + 1}", n,
            serial=lambda m, body=body: serial_for(body, m, q),
            gpu_first=lambda body=body: parallel_for(body, n, q),
            manual=lambda axis=axis: flux_region(q, axis).sum(),
            n_serial=n if n_serial is None else n_serial, kind="stencil",
            manual_agrees=False,
            magnitude=lambda m, mag=mag: serial_for(mag, m, q),
            manual_magnitude=lambda axis=axis: flux_region(
                q, axis).abs().sum()))
    return out


def regions(device, *, nx: int = NX, ny: int = NY, nz: int = NZ,
            serial_planes: Optional[int] = None, seed: int = 0
            ) -> List[Region]:
    gen = torch.Generator().manual_seed(seed)
    q = torch.rand((nx, ny, nz, VARS), generator=gen) + 1.0
    return flux_regions(q.to(device), serial_planes)
