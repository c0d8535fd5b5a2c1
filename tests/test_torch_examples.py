"""The port's examples, run as a user runs them with ``--device cpu``,
against the JAX package's: the GPU First example
(examples/gpu_first_port_torch.py) against the JAX example's program run
here on the same seeds (the three result vectors within rtol 1e-5, the
same RPC count and answer); the quickstart (examples/quickstart_torch.py)
at the original's sizes; and the serving demo
(examples/serve_demo_torch.py), whose own check holds the engine to plain
cached decode and whose token streams, on the JAX example's weights
carried across, equal the streams the JAX example prints (fp32)."""
import ast
import contextlib
import dataclasses
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.expand import parallel_for, serial_for  # noqa: E402
from repro.core.libc import rand_init, rand_uniform  # noqa: E402
from repro.core.rpc import Ref, rpc_stats  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "gpu_first_port_jax", ROOT / "examples" / "gpu_first_port.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gpu_first_port_torch_matches_the_jax_example(tmp_path):
    out = tmp_path / "results.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "gpu_first_port_torch.py"),
         "--device", "cpu", "--save", str(out)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RPC wrote 2048 results" in res.stdout
    assert "verdict from GPU First measurement" in res.stdout
    got = np.load(out)

    ex = _jax_example()
    egrid, xs = ex.make_data()
    _, energies = rand_uniform(rand_init(42), (ex.N_LOOKUPS,))

    def body(i, e):
        return ex.lookup(e[i], egrid, xs)

    want = {
        "serial": jax.jit(lambda e: serial_for(body, ex.N_LOOKUPS, e))(
            energies),
        "expanded": jax.jit(lambda e: parallel_for(body, ex.N_LOOKUPS, e))(
            energies),
        "manual": jax.jit(jax.vmap(lambda x: ex.lookup(x, egrid, xs)))(
            energies)}
    for key, w in want.items():
        np.testing.assert_allclose(got[key], np.asarray(w), rtol=1e-5,
                                   err_msg=key)
    before = rpc_stats("write_results").get("calls", 0)
    n, _ = jax.jit(lambda r: ex.write_results.rpc(Ref(r, access="read")))(
        want["expanded"])
    jax.effects_barrier()
    assert int(got["rpc_wrote"]) == int(n) == ex.N_LOOKUPS
    assert int(got["rpc_calls"]) == rpc_stats("write_results")["calls"] \
        - before == 1


def _run_example(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".py", "_mod"), ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_the_cpu():
    out = _run_example("quickstart_torch.py")
    assert "assigned architectures: " in out
    m = re.search(r"trained 20 steps on cpu: final_loss=([0-9.]+)", out)
    losses = [float(x) for x in re.findall(r"\[train\] step \d+ loss "
                                           r"([0-9.]+)", out)]
    assert m and len(losses) == 4 and float(m.group(1)) < losses[0]
    served = re.search(r"served request 0: (\[.*\])", out)
    assert served and len(ast.literal_eval(served.group(1))) == 8


def _streams(text):
    return {int(r): ast.literal_eval(t) for r, t in
            re.findall(r"\[serve\] request (\d+): (\[[^\]]*\])", text)}


def test_serve_demo_torch_streams_match_the_jax_example():
    from repro.configs import CONFIGS
    from repro.models import build_model as j_build
    from repro.models.common import split_params
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model

    out = _run_example("serve_demo_torch.py")
    assert "verified vs reference decode" in out and len(_streams(out)) == 6

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _load("serve_demo.py").main()
    want = _streams(buf.getvalue())
    assert len(want) == 6

    jcfg = CONFIGS["qwen2.5-14b"].reduced()
    assert jcfg.qkv_bias
    values, _ = split_params(j_build(jcfg).init(jax.random.PRNGKey(0)))
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)),
                        device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, values), device="cpu")
    rids, got, _ = _load("serve_demo_torch.py").serve(model, params, "cpu")
    assert {r: got[r] for r in rids} == want


def test_train_100m_torch_resumes_on_the_cpu(tmp_path):
    """Both phases at the CPU preset, the resume from the newest manifest
    and the example's asserts; its full preset is JAX's ``full_100m``."""
    from repro_torch.ckpt import latest_step
    out = _run_example("train_100m_torch.py", "--steps", "12", "--batch",
                       "4", "--seq-len", "32", "--ckpt-dir", str(tmp_path))
    assert "[train] resumed from step 6" in out
    assert "phase 2 (after restart)" in out and "at step 12" in out
    assert "[100m] OK: loss descended" in out
    assert latest_step(str(tmp_path)) == 12
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("manifest-")) == [
        "manifest-12.json", "manifest-3.json", "manifest-6.json"]
    cfg = _load("train_100m_torch.py").full_100m()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        _load("train_100m.py").full_100m())
    assert 1.2e8 < cfg.num_params() < 1.3e8
