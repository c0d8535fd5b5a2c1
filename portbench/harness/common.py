"""What every part of the benchmark shares: where its files are, how a
cell's entries are found by name, the statistics, and the check that no
JAX module was loaded.

The harness is driven by data.  ``BENCHMARK.json`` at the checkout's root
names each cell's configuration and traffic mix; a configuration is
``configs/<name>.json`` (the ``file`` its entry gives), a traffic mix is
``traffic/<name>.json``, and a per-layer or end-to-end metric is
``metrics/<name>.py``, a module with ``read(run)`` (one quantity split by
cells, ``<name>.<part>``, may share ``metrics/<name>.py``).  Adding one adds a file
and an entry, and edits nothing here.
"""
from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence

#: The benchmark's folder and the checkout's root.
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

#: Top-level module names that may not be loaded in a run's process:
#: JAX, its compiler and Flax, and the JAX package of this repository
#: (``repro``; the port is ``repro_torch``, a different top-level name).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

#: Published dense bf16 rate and memory bandwidth of one NVIDIA H100 SXM
#: (NVIDIA's data sheet, at the 700 W limit).
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: Iterable[Dict[str, Any]], name: str, what: str
         ) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def cell(bench: Dict[str, Any], workload: str, root: Path = ROOT
         ) -> Dict[str, Any]:
    """The cell ``workload``: its entry, its configuration's entry and
    file, and its traffic mix's file (``traffic/<traffic>.json``)."""
    wl = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], wl["config"], "config")
    return {"workload": wl, "config_entry": conf,
            "config": load_json(root / conf["file"]),
            "traffic": load_json(BENCH_DIR / "traffic"
                                 / f"{wl['traffic']}.json")}


def metrics_for(bench: Dict[str, Any], workload: str, trace: bool
                ) -> List[Dict[str, Any]]:
    """The metrics a run of ``workload`` reports: with ``trace`` off the
    end-to-end metrics that the cell reports (all, or those whose
    ``workloads`` list it), with it on the per-layer metrics that list
    the cell or, with no list, move an end-to-end metric the cell
    reports."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def load_module(path: Path, name: Optional[str] = None):
    """Import the Python file ``path`` (its name may hold dots)."""
    name = name or "portbench_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read`` of ``metrics/<name>.py``, or where there is none, of
    the file named by ``name`` less its last dotted part, and so on: a
    quantity split by the end-to-end metric it moves (``tick_ms_p50.serve``
    and ``tick_ms_p50.open``) has one reader (``tick_ms_p50.py``)."""
    base = name
    while not (BENCH_DIR / "metrics" / f"{base}.py").exists() \
            and "." in base:
        base = base.rsplit(".", 1)[0]
    return load_module(BENCH_DIR / "metrics" / f"{base}.py").read


def driver(kind: str):
    """``harness/<kind>.py``: the driver of a traffic mix of that kind."""
    return importlib.import_module(f"harness.{kind}")


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is in :data:`FORBIDDEN_MODULES`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def require_no_jax(when: str) -> None:
    """Exit with code 3 and no result, naming them on standard error, if
    modules of JAX or of the JAX package are loaded."""
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package loaded "
              f"{when}: {bad}; no result", file=sys.stderr)
        sys.exit(3)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile of every value, by linear interpolation
    between the closest ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def percentile_ms(values: Sequence[float], q: float) -> Optional[float]:
    """:func:`percentile` of seconds, in milliseconds."""
    p = percentile(values, q)
    return None if p is None else p * 1e3


def emit(result: Dict[str, Any], checks: Dict[str, Dict[str, Any]]) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output,
    its ``checks`` key last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    line = dict(result)
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
