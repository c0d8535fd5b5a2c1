"""The port's GPU First example (examples/gpu_first_port_torch.py), run as
a user runs it with ``--device cpu``, against the JAX example's program
run here on the same seeds: the three result vectors within rtol 1e-5 and
the same RPC count and answer."""
import importlib.util
import os
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
