"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with one NVIDIA card per chip the cell asks
for.  The cell, its configuration, its traffic mix and its metrics are
found by name through ``BENCHMARK.json`` (see ``harness/common.py``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the check compared, beside
its limit (also the last lines of standard error).

With no card, or fewer than the cell asks for, the run prints no result
and exits 2.  ``--rehearse`` runs the cell's driver instead on the CPU at a
tiny size (the configuration shrunk by ``harness/modelcfg.py::rehearsal``,
the mix's ``rehearsal`` overrides); its line says ``"rehearsal": true``,
holds no device metric and measures nothing.  A run that finds a module of
JAX or of the JAX package (``repro``) loaded, as its window opens or after
every metric's reader has loaded, prints no result and exits 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: Kernel and compiler caches of the program, at fixed paths in the
#: checkout (the port's own nvcc builds go to ``build/repro_torch``).
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
             "TRITON_CACHE_DIR": ROOT / "build" / "triton"}


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the driver on the CPU at a tiny size; measures "
                         "nothing")
    return ap.parse_args(argv)


def _overrides(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _overrides(base[k], v) if isinstance(v, dict) and \
            isinstance(base.get(k), dict) else v
    return out


def main(argv=None, t_start: float = T_START, control: bool = False,
         conf: dict = None):
    """One run; returns (result line, checks, the driver's record), or
    exits without a result.  ``control`` also reads the control's
    numbers, and ``conf`` replaces the cell's configuration
    (``calibrate.py``)."""
    args = _args(argv)
    for k, v in CACHE_ENV.items():
        os.environ[k] = str(v)
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from harness import common, modelcfg

    bench = common.load_benchmark(ROOT)
    c = common.cell(bench, args.workload, ROOT)
    chips = int(c["workload"]["chips"])
    conf, mix = conf or c["config"], c["traffic"]
    if args.rehearse:
        conf = modelcfg.rehearsal(conf)
        mix = _overrides(mix, mix.get("rehearsal", {}))
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if \
                torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {chips} CUDA "
                  f"device(s), found {found}; no result", file=sys.stderr)
            sys.exit(2)
        device = torch.device("cuda", 0)
    torch.set_num_threads(4)
    ctx = types.SimpleNamespace(
        conf=conf, mix=mix, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=device, t_start=t_start,
        control=control, rehearse=args.rehearse,
        after_setup=lambda: common.require_no_jax("after set-up"))
    rec = common.driver(mix["driver"]).run(ctx)

    values = {}
    for m in common.metrics_for(bench, args.workload, bool(args.trace)):
        v = common.metric_reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    if args.rehearse:
        dev = {"platform": "cpu", "kind": "cpu rehearsal (not a device "
               "measurement)", "count": 0, "memory_peak_bytes": None}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": chips, "memory_peak_bytes": rec["peak_bytes"]}
    line = {"correct": bool(rec["correct"]), "attempted": rec["attempted"],
            "failed": rec["failed"],
            "metrics": {} if args.rehearse else values, "device": dev}
    if args.rehearse:
        line["rehearsal"] = True
        line["rehearsal_numbers"] = {k: v["value"] for k, v in values.items()}
    tr = rec.get("trace")
    if tr is not None:
        if not args.rehearse:
            dev["busy_s"] = tr["busy_s"]
            dev["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    common.require_no_jax("at exit, every reader loaded")
    return line, rec["checks"], rec


if __name__ == "__main__":
    result, checks, _ = main()
    from harness import common
    common.emit(result, checks)
