"""Read the numbers a cell's check compares, for the program and for its
control, on several seeds in one process: the readings its limits are set
from.

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,13 \\
        --seconds 30 [--out calibrate.jsonl]

Each seed is one run of the cell as ``run.py`` makes it (the same set-up,
window and sample), and then the control: the plain reference computed
with every projection in float8 e4m3 (``reference/decoder.py``), whose
first choice at each sampled position is judged as the served token is.
A moe model also gets the plain reference in bfloat16 as a witness (its
first choice judged as the control's is), and the look at its router:
whether the witness's router chose other experts than float32's at the
positions of the program's largest gaps.
One JSON line a seed; the benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as runmod  # noqa: E402


def _router_look(gaps, flips):
    """Where the largest gaps sit: the share of positions at which some
    layer's router chose other experts in the plain bfloat16 witness than
    in float32, over all positions and over the largest 2% of gaps."""
    pairs = sorted(zip(gaps, flips), reverse=True)
    top = pairs[:max(1, len(pairs) // 50)]
    share = (lambda ps: sum(f for _, f in ps) / max(len(ps), 1))
    return {"positions": len(pairs), "flipped_all": share(pairs),
            "flipped_top2pct": share(top),
            "top_gaps": [[round(g, 4), bool(f)] for g, f in pairs[:10]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out")
    ap.add_argument("--config", help="a configuration file to run in the "
                    "cell's place (a second witness, such as float32)")
    a = ap.parse_args(argv)
    out = open(a.out, "a") if a.out else None
    for seed in [int(s) for s in a.seeds.split(",")]:
        args = ["--workload", a.workload, "--seed", str(seed), "--seconds",
                str(a.seconds), "--trace", "0"]
        conf = json.loads(Path(a.config).read_text()) if a.config else None
        _, checks, rec = runmod.main(args, time.perf_counter(),
                                     control=True, conf=conf)
        row = {"workload": a.workload, "seed": seed,
               "config": rec["conf"]["name"],
               "program": rec["gap_numbers"],
               "control": rec.get("control_numbers"),
               "bf16_witness": rec.get("bf16_numbers"),
               "checks": {k: [c["value"], c["limit"], c["ok"]]
                          for k, c in checks.items()},
               "tokens": len(rec.get("gaps", [])),
               "tick_ms_p50": sorted(rec["tick_s"])[len(rec["tick_s"]) // 2]
               * 1e3 if rec["tick_s"] else None}
        if rec.get("route_flips"):
            row["router"] = _router_look(rec["gaps"], rec["route_flips"])
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del rec
        gc.collect()
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
