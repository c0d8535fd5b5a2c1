"""Paper Fig. 9c: the AMGmk relax kernel and a page-rank step (the JAX
package's ``benchmarks/amgmk_pagerank_bench.py``).

AMGmk: one Jacobi relaxation sweep of a 7-point Laplacian (the CORAL AMGmk
"relax" kernel).  Page rank: one propagation step over a random sparse
graph of fixed in-degree (a gather and a row sum), the latency-bound
gather pattern.  JAX's closures are module functions here; each reads its
operands through ``index_select`` where JAX indexes with the loop index.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.expand import parallel_for, serial_for
from repro_torch.evaluation.common import Region

N3 = 20                 # 20^3 grid for the relax kernel
N_NODES = 1 << 12
DEG = 8


def relax_manual(u, f):
    nb = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0) +
          torch.roll(u, 1, 1) + torch.roll(u, -1, 1) +
          torch.roll(u, 1, 2) + torch.roll(u, -1, 2))
    return (f + nb) / 6.0


def relax_row(i, u, f):
    """Single-team semantics: one x-plane at a time."""
    up = torch.roll(u, 1, 0)[i]
    dn = torch.roll(u, -1, 0)[i]
    ui = u[i]
    nb = (up + dn + torch.roll(ui, 1, 0) + torch.roll(ui, -1, 0) +
          torch.roll(ui, 1, 1) + torch.roll(ui, -1, 1))
    return (f[i] + nb) / 6.0


def pr_node(i, rank, src, out_deg):
    """Node ``i``'s new rank from its ``DEG`` sources."""
    s = src[i]
    n = rank.shape[0]
    return 0.15 / n + 0.85 * torch.sum(rank.index_select(0, s)
                                       / out_deg.index_select(0, s))


def pr_manual(rank, src, out_deg):
    n = rank.shape[0]
    return 0.15 / n + 0.85 * torch.sum(rank[src] / out_deg[src], dim=1)


def relax_region(u, f, n_serial: Optional[int] = None) -> Region:
    n = u.shape[0]
    body = lambda i: relax_row(i, u, f)                  # noqa: E731
    return Region(
        "fig9c/amgmk_relax", n,
        serial=lambda m: serial_for(body, m),
        gpu_first=lambda: parallel_for(body, n, device=u.device),
        manual=lambda: relax_manual(u, f),
        n_serial=n if n_serial is None else n_serial, kind="stencil")


def pagerank_region(rank, src, out_deg, n_serial: Optional[int] = None
                    ) -> Region:
    n = rank.shape[0]
    body = lambda i: pr_node(i, rank, src, out_deg)      # noqa: E731
    return Region(
        "fig9c/pagerank", n,
        serial=lambda m: serial_for(body, m),
        gpu_first=lambda: parallel_for(body, n, device=rank.device),
        manual=lambda: pr_manual(rank, src, out_deg),
        n_serial=n if n_serial is None else n_serial)


def make_graph(n_nodes: int = N_NODES, deg: int = DEG, *,
               generator: torch.Generator, device):
    """The sources of every node (n_nodes, deg) int32, the uniform start
    rank and the out-degrees in [1, deg] (float32)."""
    src = torch.randint(0, n_nodes, (n_nodes, deg), generator=generator,
                        dtype=torch.int32)
    out_deg = torch.randint(1, deg + 1, (n_nodes,), generator=generator
                            ).to(torch.float32)
    rank = torch.full((n_nodes,), 1.0 / n_nodes)
    return rank.to(device), src.to(device), out_deg.to(device)


def regions(device, *, n3: int = N3, n_nodes: int = N_NODES, deg: int = DEG,
            serial_planes: Optional[int] = None,
            serial_nodes: Optional[int] = None, seed: int = 0
            ) -> List[Region]:
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((n3, n3, n3), generator=gen).to(device)
    f = torch.rand((n3, n3, n3), generator=gen).to(device)
    rank, src, out_deg = make_graph(n_nodes, deg, generator=gen,
                                    device=device)
    return [relax_region(u, f, serial_planes),
            pagerank_region(rank, src, out_deg, serial_nodes)]
