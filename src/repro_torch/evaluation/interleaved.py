"""Paper Fig. 9a: the HeCBench "interleaved" micro benchmark (the JAX
package's ``benchmarks/interleaved_bench.py``).

Array-of-struct (interleaved) against struct-of-array (non-interleaved)
access from a data-parallel region: the layout experiment whose outcome
differs between CPUs and accelerators, measured without a port.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.expand import parallel_for, serial_for
from repro_torch.evaluation.common import Region

N = 1 << 16
FIELDS = 8


def compute_fields(rec):
    """Per-element body: a little arithmetic over all 8 struct fields."""
    s = rec[0] * rec[1] + rec[2] - rec[3]
    s = s + torch.sqrt(torch.abs(rec[4])) * rec[5]
    return s + rec[6] * rec[7]


def _aos_body(i, a):
    return compute_fields(a[i])


def _soa_body(i, a):
    return compute_fields(a[:, i])


def aos_region(aos, n_serial: Optional[int] = None) -> Region:
    n = aos.shape[0]
    return Region(
        "fig9a/interleaved_aos", n,
        serial=lambda m: serial_for(_aos_body, m, aos),
        gpu_first=lambda: parallel_for(_aos_body, n, aos),
        manual=lambda: torch.vmap(compute_fields)(aos),
        n_serial=n if n_serial is None else n_serial)


def soa_region(soa, n_serial: Optional[int] = None) -> Region:
    n = soa.shape[1]
    return Region(
        "fig9a/noninterleaved_soa", n,
        serial=lambda m: serial_for(_soa_body, m, soa),
        gpu_first=lambda: parallel_for(_soa_body, n, soa),
        manual=lambda: compute_fields(soa),
        n_serial=n if n_serial is None else n_serial)


def regions(device, *, n: int = N, serial_records: Optional[int] = None,
            seed: int = 0) -> List[Region]:
    gen = torch.Generator().manual_seed(seed)
    aos = torch.randn((n, FIELDS), generator=gen).to(device)  # interleaved
    soa = aos.t().contiguous()                       # (FIELDS, n)
    return [aos_region(aos, serial_records), soa_region(soa, serial_records)]
