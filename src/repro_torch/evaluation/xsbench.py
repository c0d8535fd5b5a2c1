"""Paper Fig. 8a: XSBench, the OpenMC macroscopic cross-section lookup
proxy (the JAX package's ``benchmarks/xsbench_bench.py``).

Two algorithms, as in XSBench v20:
  event    a flat pool of independent lookups (the algorithm the manual GPU
           port uses),
  history  per-particle chains of lookups, each lookup's energy derived
           from the previous one (the CPU-only algorithm: GPU First
           measures it on the card without a port).
A lookup binary-searches the unionized energy grid, then interpolates and
sums the micro cross sections of every nuclide of a material.  The grid
is read with ``index_select``: indexing with a 0-d tensor would read its
value back to the host once a lookup.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.expand import parallel_for, serial_for
from repro_torch.evaluation.common import Region

N_GRID = 2048          # unionized grid points
N_NUCLIDES = 68        # H-M large has 355; 68 ~ small
XS = 5                 # total, elastic, absorption, fission, nu-fission
N_LOOKUPS = 4096       # event pool
N_PARTICLES = 128      # history mode
N_HISTORY = 16         # lookups per particle (34 in XSBench; data-dependent)


def make_data(n_nuclides: int = N_NUCLIDES, n_grid: int = N_GRID, *,
              generator: torch.Generator, device):
    """The sorted energy grid (n_grid,), the micro cross sections
    (n_nuclides, n_grid, XS) and the concentrations (n_nuclides,), drawn
    from the (CPU) ``generator`` and moved to ``device``."""
    egrid = torch.sort(torch.rand((n_grid,), generator=generator)).values
    xs = torch.rand((n_nuclides, n_grid, XS), generator=generator)
    conc = torch.rand((n_nuclides,), generator=generator)
    return egrid.to(device), xs.to(device), conc.to(device)


def energies(n: int, *, generator: torch.Generator, device):
    """``n`` energies in [1e-3, 0.999), as JAX's ``minval``/``maxval``."""
    u = torch.rand((n,), generator=generator)
    return (u * (0.999 - 1e-3) + 1e-3).to(device)


def lookup_one(e, egrid, xs, conc):
    """One macroscopic XS lookup (the paper's timed kernel body): (XS,)."""
    idx = (torch.searchsorted(egrid, e) - 1).clamp(0, egrid.shape[0] - 2)
    at = torch.stack([idx, idx + 1]).reshape(2)
    lo_e, hi_e = egrid.index_select(0, at).unbind(0)
    f = (e - lo_e) / torch.clamp(hi_e - lo_e, min=1e-9)
    lo, hi = xs.index_select(1, at).unbind(1)
    micro = lo + f * (hi - lo)                        # (nuclides, XS)
    return torch.einsum("n,nx->x", conc, micro)


def history_chain(e0, egrid, xs, conc, n_history: int = N_HISTORY):
    """A data-dependent chain: each energy derives from the previous
    lookup (JAX's ``lax.scan``, a Python loop here)."""
    e, outs = e0, []
    for _ in range(n_history):
        macro = lookup_one(e, egrid, xs, conc)
        outs.append(macro[0])
        e = torch.abs(torch.sin(e * 1000.0 + macro[0])) * 0.999 + 5e-4
    return torch.stack(outs).sum()


def event_region(e, egrid, xs, conc, n_serial: Optional[int] = None
                 ) -> Region:
    n = e.shape[0]

    def body(i, e):
        return lookup_one(e[i], egrid, xs, conc)[0]

    return Region(
        "fig8a/xsbench_event", n,
        serial=lambda m: serial_for(body, m, e),
        gpu_first=lambda: parallel_for(body, n, e),
        manual=lambda: torch.vmap(
            lambda ee: lookup_one(ee, egrid, xs, conc)[0])(e),
        n_serial=n if n_serial is None else n_serial)


def history_region(s, egrid, xs, conc, n_history: int = N_HISTORY,
                   n_serial: Optional[int] = None) -> Region:
    n = s.shape[0]

    def body(i, s):
        return history_chain(s[i], egrid, xs, conc, n_history)

    return Region(
        "fig8a/xsbench_history", n,
        serial=lambda m: serial_for(body, m, s),
        gpu_first=lambda: parallel_for(body, n, s),
        manual=lambda: torch.vmap(
            lambda ss: history_chain(ss, egrid, xs, conc, n_history))(s),
        n_serial=n if n_serial is None else n_serial, kind="chained",
        # a rounding difference grows up to 1000x a step: gate at depth 1
        gate=None if n_history == 1 else lambda: history_region(
            s, egrid, xs, conc, 1, n_serial),
        gate_note="depth 1")


def regions(device, *, n_nuclides: int = N_NUCLIDES, n_grid: int = N_GRID,
            n_lookups: int = N_LOOKUPS, n_particles: int = N_PARTICLES,
            n_history: int = N_HISTORY, serial_lookups: Optional[int] = None,
            serial_particles: Optional[int] = None, seed: int = 0
            ) -> List[Region]:
    """The event and history regions on ``device``, data from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    egrid, xs, conc = make_data(n_nuclides, n_grid, generator=gen,
                                device=device)
    e = energies(n_lookups, generator=gen, device=device)
    s = energies(n_particles, generator=gen, device=device)
    return [event_region(e, egrid, xs, conc, serial_lookups),
            history_region(s, egrid, xs, conc, n_history, serial_particles)]


def history_step(step, e, egrid, xs, conc):
    """One step of every particle's history (the state is the energies):
    each particle's lookup at its energy and the next energy, the
    ``host_driven`` contrast's step.  ``step`` is unused, as the loop
    drivers pass it."""
    def next_energy(i, e):
        macro = lookup_one(e[i], egrid, xs, conc)
        return torch.abs(torch.sin(e[i] * 1000.0 + macro[0])) * 0.999 + 5e-4

    return parallel_for(next_energy, e.shape[0], e)
