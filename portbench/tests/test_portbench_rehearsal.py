"""Each cell's driver rehearsed on the CPU at a tiny size, ``--seconds
2``: a well-formed last line marked as no device measurement.  Without
``--rehearse`` a machine without a card gets no result."""
import json
import subprocess
import sys

import pytest

from harness import common

CELLS = [w["name"] for w in common.load_benchmark()["workloads"]]
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _cmd(cell, trace, *extra):
    return [sys.executable, "portbench/run.py", "--workload", cell,
            "--seed", "4294967311", "--seconds", "2", "--trace", str(trace),
            *extra]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_line(cell, trace):
    out = subprocess.run(_cmd(cell, trace, "--rehearse"), cwd=common.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["rehearsal"] is True and line["metrics"] == {}
    assert line["device"]["platform"] == "cpu"
    assert "busy_s" not in line["device"]
    assert isinstance(line["correct"], bool)
    want = {m["name"] for m in common.metrics_for(
        common.load_benchmark(), cell, bool(trace))}
    got = set(line["rehearsal_numbers"])
    assert got <= want
    if trace:
        assert "breakdown" in line
    else:
        assert got == want
    err = out.stderr.strip().splitlines()
    assert err[-1].startswith("check ")


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the look for one succeeds")
    out = subprocess.run(_cmd(CELLS[0], 0), cwd=common.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
