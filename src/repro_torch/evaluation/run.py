"""The paper's evaluation on the port: one suite a table or figure (the
JAX package's ``benchmarks/run.py``).

  PYTHONPATH=src python -m repro_torch.evaluation.run [--only fig8,fig10]
      [--device cpu|cuda]

Prints ``name,us_per_call,derived`` CSV rows, named letter for letter as
the JAX package's.  ``--device`` defaults to the card, where it runs the
sizes of :data:`CARD_SIZES`, and refuses to run without one; ``--device
cpu`` runs the CPU at the JAX modules' sizes.  Writes no file.  Fig. 6's
mesh section runs on the one-device mesh on the card and in a ``gloo``
world of two processes on the CPU.  The ``roofline`` suite renders the
dry run's JSONs (``evaluation/roofline.py``; it times nothing, on either
device).
"""
from __future__ import annotations

import argparse
import sys
import traceback
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.evaluation import (allocator, amgmk_pagerank, hypterm,
                                    interleaved, roofline, rpc, rsbench,
                                    spec, xsbench)
from repro_torch.evaluation.common import Region, emit, emit_region, \
    time_region

#: The region suites of Figs. 8-10: ``(device, **sizes) -> [Region]``.
REGION_SUITES: Dict[str, Callable[..., List[Region]]] = {
    "fig8a_xsbench": xsbench.regions,
    "fig8b_rsbench": rsbench.regions,
    "fig9a_interleaved": interleaved.regions,
    "fig9b_hypterm": hypterm.regions,
    "fig9c_amgmk_pagerank": amgmk_pagerank.regions,
    "fig10_spec": spec.regions,
}

#: The sizes on an H100.  XSBench and RSBench "small" (68 nuclides; XSBench
#: 11,303 energy points, RSBench 100 windows of 10 poles) at 2**20
#: lookups and 2**15 particles; 2**24 records of 8 fields (512 MB a
#: layout); 128**3 grids; 2**22 nodes; 4096 pairs of 256; 16 x 16 blocks
#: of 64; smithwa's lengths (``smithwa``: JAX's, then 512 and 2048).  The
#: serial column runs a prefix where its launch-bound loop would take
#: minutes (a history particle is ~340 launches, a botsalgn pair
#: ~10,700).
CARD_SIZES: Dict[str, Dict] = {
    "fig6_allocator": dict(grids=allocator.GRIDS + [allocator.CARD_GRID],
                           serial_limit=512),
    "fig8a_xsbench": dict(n_grid=11303, n_lookups=1 << 20,
                          n_particles=1 << 15, serial_lookups=2048,
                          serial_particles=128),
    "fig8b_rsbench": dict(n_nuclides=68, poles_per_window=10,
                          n_lookups=1 << 20, n_particles=1 << 15,
                          serial_lookups=2048, serial_particles=128),
    "fig9a_interleaved": dict(n=1 << 24, serial_records=4096),
    "fig9b_hypterm": dict(nx=128, ny=128, nz=128),
    "fig9c_amgmk_pagerank": dict(n3=128, n_nodes=1 << 22,
                                 serial_nodes=4096),
    "fig10_spec": dict(seq_len=256, n_pairs=4096, nb=16, bs=64,
                       serial_pairs=4, smithwa=(32, 64, 128, 512, 2048)),
}


def smithwa(device, lengths=spec.SMITHWA_LENGTHS, *, warmup: int = 2,
            iters: int = 5) -> Dict:
    """Fig. 10c: one alignment a length; time a cell as L grows."""
    out = {}
    for L, (a, b) in spec.smithwa_pairs(lengths, device=device).items():
        t = time_region(spec.sw_score, a, b, warmup=warmup, iters=iters)
        emit(f"fig10c/smithwa_L{L}", t * 1e6,
             f"us_per_cell={t / (L * L) * 1e6:.3f}")
        out[f"L{L}"] = {"us": t * 1e6, "us_per_cell": t / (L * L) * 1e6}
    return out


def run_suite(name: str, device, sizes: Optional[Dict] = None, *,
              warmup: int = 2, iters: int = 5):
    """One suite's rows; returns its records."""
    sizes = dict(sizes or {})
    if name == "fig6_allocator":
        recs = allocator.run(device, warmup=warmup, iters=iters, **sizes)[0]
        recs["sharded_mesh"] = allocator.run_mesh(device)
        return recs
    if name == "fig7_rpc":
        return rpc.run(device)[0]
    if name == "roofline":
        return roofline.run()
    lengths = sizes.pop("smithwa", spec.SMITHWA_LENGTHS)
    recs = []
    for reg in REGION_SUITES[name](device, **sizes):
        rec = reg.measure(warmup=warmup, iters=iters, device=device)
        emit_region(rec)
        recs.append(rec)
    if name == "fig10_spec":
        recs.append(smithwa(device, lengths, warmup=warmup, iters=iters))
    return recs


SUITES = ["fig6_allocator", "fig7_rpc", *REGION_SUITES, "roofline"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated suite prefixes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the evaluation runs on the card; "
                           "pass --device cpu to run it on the CPU")
    only = args.only.split(",") if args.only else None
    print("name,us_per_call,derived")
    failures = 0
    for name in SUITES:
        if only and not any(name.startswith(o) for o in only):
            continue
        print(f"# === {name} ===", flush=True)
        sizes = CARD_SIZES.get(name, {}) if device.type == "cuda" else {}
        try:
            run_suite(name, device, sizes)
        except Exception:  # noqa: BLE001 (report and go on, as JAX's)
            failures += 1
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
