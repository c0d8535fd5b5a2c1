"""Paper Fig. 8b: RSBench, the multipole cross-section proxy (the JAX
package's ``benchmarks/rsbench_bench.py``).

Instead of table interpolation, each lookup evaluates a windowed sum of
complex poles (complex64) plus a low-order polynomial fit: heavier in
arithmetic and lighter in gathers than XSBench, which is why the paper
contrasts the two.  The window is read with ``index_select``, never by
indexing with a 0-d tensor (a read back to the host).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.expand import parallel_for, serial_for
from repro_torch.evaluation.common import Region
from repro_torch.evaluation.xsbench import energies

N_NUCLIDES = 32
N_WINDOWS = 100
POLES_PER_WINDOW = 4
FIT_ORDER = 6
N_LOOKUPS = 2048
N_PARTICLES = 128
N_HISTORY = 16


def make_data(n_nuclides: int = N_NUCLIDES, n_windows: int = N_WINDOWS,
              poles_per_window: int = POLES_PER_WINDOW,
              fit_order: int = FIT_ORDER, *, generator: torch.Generator,
              device):
    """The poles (n_nuclides, n_windows, poles_per_window, 2) complex64,
    the fits (n_nuclides, n_windows, fit_order) and the concentrations."""
    shape = (n_nuclides, n_windows, poles_per_window, 2)
    re = torch.randn(shape, generator=generator)
    im = torch.randn(shape, generator=generator)
    fit = torch.randn((n_nuclides, n_windows, fit_order),
                      generator=generator)
    conc = torch.rand((n_nuclides,), generator=generator)
    return (torch.complex(re, im).to(device), fit.to(device),
            conc.to(device))


def lookup_one(e, poles, fit, conc):
    """One lookup: the poles' and the fit's contributions of every nuclide
    in the energy's window, weighted by the concentrations (0-d)."""
    n_windows = poles.shape[1]
    w = (e * n_windows).to(torch.int32).clamp(0, n_windows - 1).reshape(1)
    pw = poles.index_select(1, w)[:, 0]               # (nuc, poles, 2)
    fw = fit.index_select(1, w)[:, 0]                 # (nuc, order)
    sqrt_e = torch.sqrt(e)
    z = pw[..., 0] / (sqrt_e - pw[..., 1])            # (nuc, poles) complex
    sigma = torch.sum(torch.real(z), dim=-1)          # (nuc,)
    powers = e ** torch.arange(fit.shape[-1], device=fit.device)
    sigma = sigma + fw @ powers
    return torch.dot(conc, sigma)


def history_chain(e0, poles, fit, conc, n_history: int = N_HISTORY):
    e, outs = e0, []
    for _ in range(n_history):
        s = lookup_one(e, poles, fit, conc)
        outs.append(s)
        e = torch.abs(torch.sin(e * 777.0 + s)) * 0.999 + 5e-4
    return torch.stack(outs).sum()


def event_region(e, poles, fit, conc, n_serial: Optional[int] = None
                 ) -> Region:
    n = e.shape[0]

    def body(i, e):
        return lookup_one(e[i], poles, fit, conc)

    return Region(
        "fig8b/rsbench_event", n,
        serial=lambda m: serial_for(body, m, e),
        gpu_first=lambda: parallel_for(body, n, e),
        manual=lambda: torch.vmap(
            lambda ee: lookup_one(ee, poles, fit, conc))(e),
        n_serial=n if n_serial is None else n_serial)


def history_region(s, poles, fit, conc, n_history: int = N_HISTORY,
                   n_serial: Optional[int] = None) -> Region:
    n = s.shape[0]

    def body(i, s):
        return history_chain(s[i], poles, fit, conc, n_history)

    return Region(
        "fig8b/rsbench_history", n,
        serial=lambda m: serial_for(body, m, s),
        gpu_first=lambda: parallel_for(body, n, s),
        manual=lambda: torch.vmap(
            lambda ss: history_chain(ss, poles, fit, conc, n_history))(s),
        n_serial=n if n_serial is None else n_serial, kind="chained",
        # a rounding difference grows up to 777x a step: gate at depth 1
        gate=None if n_history == 1 else lambda: history_region(
            s, poles, fit, conc, 1, n_serial),
        gate_note="depth 1")


def regions(device, *, n_nuclides: int = N_NUCLIDES,
            n_windows: int = N_WINDOWS,
            poles_per_window: int = POLES_PER_WINDOW,
            n_lookups: int = N_LOOKUPS, n_particles: int = N_PARTICLES,
            n_history: int = N_HISTORY, serial_lookups: Optional[int] = None,
            serial_particles: Optional[int] = None, seed: int = 0
            ) -> List[Region]:
    gen = torch.Generator().manual_seed(seed)
    poles, fit, conc = make_data(n_nuclides, n_windows, poles_per_window,
                                 generator=gen, device=device)
    e = energies(n_lookups, generator=gen, device=device)
    s = energies(n_particles, generator=gen, device=device)
    return [event_region(e, poles, fit, conc, serial_lookups),
            history_region(s, poles, fit, conc, n_history, serial_particles)]
