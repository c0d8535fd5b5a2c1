"""Cells, configurations, traffic mixes and metrics are found from data:
every name in ``BENCHMARK.json`` has its file, and a new cell with a new
configuration, mix and metric runs with new files and entries alone."""
import json
import os
import subprocess
import sys

import pytest

from harness import common

BENCH = common.load_benchmark()


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        conf = common.load_json(common.ROOT / c["file"])
        assert conf["name"] == c["name"]
        assert conf["source"] == c["source"]
    for w in BENCH["workloads"]:
        cell = common.cell(BENCH, w["name"])
        assert common.driver(cell["traffic"]["driver"]).run
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def test_every_cell_reports_setup_another_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in common.metrics_for(BENCH, w["name"],
                                                     False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = common.metrics_for(BENCH, w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_reduced_keys_differ_from_the_source_only():
    for c in BENCH["configs"]:
        conf = common.load_json(common.ROOT / c["file"])
        changed = set(conf.get("reduced_from", {}))
        assert changed == set(c["reduced"])
        for k, v in conf.get("reduced_from", {}).items():
            assert conf[k] != v


DUMMY_METRIC = '''"""A dummy per-layer metric: the window's ticks."""


def read(run):
    return float(run["ticks"])
'''


def test_a_new_cell_needs_new_files_and_entries_only(checkout):
    pb = checkout / "portbench"
    conf = json.loads((pb / "configs" / "qwen2.5-14b.json").read_text())
    conf["name"] = "dummy-dense"
    (pb / "configs" / "dummy-dense.json").write_text(json.dumps(conf))
    first = BENCH["workloads"][0]["traffic"]
    mix = json.loads((pb / "traffic" / f"{first}.json").read_text())
    mix["rehearsal"]["rate_rps"] = 10.0
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "dummy_ticks.serve.py").write_text(DUMMY_METRIC)
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-dense", "source": "x",
                             "file": "portbench/configs/dummy-dense.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-dense",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_ticks.serve", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine tick", "moves": "serve_tok_s",
                               "workloads": ["dummy.cell"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dummy.cell",
         "--seed", "7", "--seconds", "1", "--trace", "1", "--rehearse"],
        cwd=checkout, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["rehearsal_numbers"]["dummy_ticks.serve"] >= 1


def test_no_program_no_result(checkout):
    os.remove(checkout / "src")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0", "--rehearse"],
        cwd=checkout, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
