"""The whole-name check for JAX and the JAX package (``repro``), which the
port's name (``repro_torch``) begins with."""
import json
import os
import subprocess
import sys
import types

import pytest

from harness import common


def test_top_level_names_compared_whole():
    names = ["repro_torch", "repro_torch.serving.engine", "jaxtyping",
             "reproducible", "numpy", "repro", "repro.core.rpc", "jax",
             "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert common.forbidden_loaded(names) == sorted(
        ["repro", "repro.core.rpc", "jax", "jax.numpy",
         "jaxlib.xla_client", "flax.linen"])


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    import run as runmod
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        runmod.main(["--workload", common.load_benchmark()["workloads"][0]["name"], "--seed", "1",
                     "--seconds", "0.5", "--trace", "0", "--rehearse"])
    assert e.value.code == 3
    assert "jax" in capsys.readouterr().err


def test_the_port_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src', 'portbench'];"
            "import repro_torch.serving.engine, repro_torch.models;"
            "import harness.serve, reference.decoder;"
            "from harness import common; print(common.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


PLANTED = '''"""A reader that a later change might add, which loads JAX."""
import jax  # noqa: F401


def read(run):
    return 1.0
'''


def test_a_reader_that_loads_jax_gets_no_result(checkout):
    """A metric's reader that imports ``jax`` (here a stand-in package on
    the path) is loaded after the window: the run still exits 3."""
    fake = checkout / "fake_site" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("")
    (checkout / "portbench" / "metrics" / "planted.py").write_text(PLANTED)
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    bench["end_to_end"].append({"name": "planted", "unit": "1",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": [cell]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "3", "--seconds", "1", "--trace", "0", "--rehearse"],
        cwd=checkout, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(checkout / "fake_site")))
    assert out.returncode == 3, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "every reader loaded" in out.stderr and "'jax'" in out.stderr


def test_jax_loaded_in_set_up_stops_the_run_before_the_window(monkeypatch,
                                                              capsys):
    import run as runmod
    from harness import modelcfg
    made = modelcfg.make_weights

    def loads_jax(*a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return made(*a, **k)
    monkeypatch.setattr(modelcfg, "make_weights", loads_jax)
    with pytest.raises(SystemExit) as e:
        runmod.main(["--workload",
                     common.load_benchmark()["workloads"][0]["name"],
                     "--seed", "1", "--seconds", "0.5", "--trace", "0",
                     "--rehearse"])
    assert e.value.code == 3
    assert "after set-up" in capsys.readouterr().err
