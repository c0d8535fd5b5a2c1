"""The control: the plain reference computed in float8 e4m3, put in the
program's place.  At a size a CPU test run holds (width 512, 16 layers,
a 32,000-token vocabulary), on three seeds, the program passes the limits
of the numbers each configuration's check compares, the control reads
more than the program on every seed and three times as much over the
three.  On the card, at the
cell's own size, the control fails the check (``card``)."""
import json
import subprocess
import sys
import types

import pytest
import torch

import run as runmod
from harness import common, serve

BENCH = common.load_benchmark()
#: One cell a configuration, the first that names it.
CELLS = []
for _w in BENCH["workloads"]:
    if all(common.cell(BENCH, c)["config"]["name"] != _w["config"]
           for c in CELLS):
        CELLS.append(_w["name"])
SMALL = {"hidden_size": 512, "num_attention_heads": 8,
         "num_key_value_heads": 2, "head_dim": 64, "intermediate_size": 1024,
         "vocab_size": 32000, "num_hidden_layers": 16,
         "num_local_experts": 8}


def _small(conf):
    out = dict(conf)
    out.update({k: v for k, v in SMALL.items() if k in conf or k == "head_dim"})
    out["harness"] = dict(conf["harness"],
                          port_options={"head_pad_multiple": 1})
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_three_times_the_program(cell):
    c = common.cell(BENCH, cell)
    conf = _small(c["config"])
    mix = runmod._overrides(c["traffic"], c["traffic"]["rehearsal"])
    mix = dict(mix, check_requests=16)
    total = {name: [0.0, 0.0] for name in conf["check"]}
    for seed in (1, 2, 3):
        ctx = types.SimpleNamespace(
            conf=conf, mix=mix, seed=seed, seconds=8.0, trace=False,
            device=torch.device("cpu"), t_start=0.0, control=True,
            rehearse=True)
        rec = serve.run(ctx)
        assert rec["gaps"], "the window finished no request"
        for name, limit in conf["check"].items():
            prog = rec["gap_numbers"][name]
            ctrl = rec["control_numbers"][name]
            assert prog <= limit and ctrl > prog, (seed, name, prog, ctrl)
            total[name][0] += prog
            total[name][1] += ctrl
    for name, (prog, ctrl) in total.items():
        assert ctrl >= 3 * prog, (name, prog, ctrl)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check_on_the_card(card, cell):
    # a process of its own, as every run of the benchmark has: one cell's
    # model and cache would not fit beside another's on the card
    out = subprocess.run(
        [sys.executable, "portbench/calibrate.py", "--workload", cell,
         "--seeds", "1234567", "--seconds", "10"], cwd=common.ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(ok for _, _, ok in row["checks"].values()), row["checks"]
    limits = common.cell(BENCH, cell)["config"]["check"]
    assert any(row["control"][k] > v for k, v in limits.items()), row
