"""Roofline report: the port's dry-run JSONs as one row a cell (the JAX
package's ``benchmarks/roofline.py``).

Reads every ``*.json`` under :data:`RESULTS_DIR` (``results/dryrun_torch/``
at the repo's root, which git ignores), as ``launch/dryrun.py --out``
writes them, and emits ``roofline/{arch}/{shape}/{mesh}/{rules}`` with the
bound time in microseconds and JAX's ``derived`` text, once a cell, for
the cells with ``status`` "ok".  With no JSON it emits JAX's
``roofline/none`` row.  The numbers are counts against the H100's
constants (``launch/dryrun.py``), not times taken on a card.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from repro_torch.evaluation.common import emit

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def load_all(results_dir: str = RESULTS_DIR) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            data = json.load(f)
        rows.extend([data] if isinstance(data, dict) else data)
    return rows


def run(results_dir: str = RESULTS_DIR) -> List[str]:
    """Emit the rows; returns them."""
    rows = load_all(results_dir)
    if not rows:
        return [emit("roofline/none", 0.0,
                     "run repro_torch.launch.dryrun first")]
    seen, out = set(), []
    for r in rows:
        key = (r.get("arch"), r.get("shape"), r.get("mesh"), r.get("rules"))
        if key in seen or r.get("status") != "ok":
            continue
        seen.add(key)
        rf = r["roofline"]
        out.append(emit(
            f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}/{r['rules']}",
            rf["bound_time_s"] * 1e6,
            f"dominant={rf['dominant']};"
            f"fraction={rf['roofline_fraction']:.4f};"
            f"useful={rf['useful_compute_ratio']:.3f}"))
    return out
