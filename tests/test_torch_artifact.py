"""The serving engine's durable artifact (``export_artifact`` /
``from_artifact``) against the JAX package's, on the CPU.

llama3.2-3b at ``tiny_preset`` (fp32, 2 slots, max_len 32, page size 8)
with JAX's weights carried into the port (``params_from_jax``): in a
fresh process (a manifest holds every landing pad its process bound, and
a cold start needs each one's host), each package's live engine serves
the traffic and exports its artifact; then fresh interpreters cold-start
them (a port process whose ``build_model``
and ``torch.export.export`` raise, so it builds no model and traces
nothing, and a JAX process), and the streams must be equal to each other
and to the live engines'.  ``engine.json`` is byte-equal to JAX's for the
same ``extra_meta``; JAX's ``restore_checkpoint`` reads the port's step-0
checkpoint to JAX's values.  With a ``spill_sink``, the artifact engine's
sink calls and acks equal the live engine's.  The moe and vlm tiny presets
export and serve their live engines' streams too, and the serve CLI's
``--export-artifact`` and ``--from-artifact`` run at ``--preset tiny
--device cpu``."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import CONFIGS  # noqa: E402
from repro.launch.train import tiny_preset as j_tiny  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.common import split_params  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TRAFFIC = [([1, 2, 3], 5), ([4, 5], 6), ([7, 8, 9, 10], 4)]
ARCHES = {"llama": "llama3.2-3b", "moe": "phi3.5-moe-42b-a6.6b",
          "vlm": "qwen2-vl-2b"}

# A fresh port process: cold-start each artifact named on the command line
# (``tag=arch=directory``) on the CPU and serve TRAFFIC; the llama one
# with a recording spill sink.  build_model and torch.export.export raise.
_PORT_COLD = r"""
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.launch.train import tiny_preset
import repro_torch.models as models, repro_torch.models.model_zoo as zoo
from repro_torch.serving.engine import ServingEngine

def refuse(*a, **k):
    raise AssertionError("the cold start built a model or traced")

zoo.build_model = models.build_model = torch.export.export = refuse
traffic = json.loads(sys.argv[2])
out = {}
for item in sys.argv[3:]:
    tag, arch, directory = item.split("=", 2)
    calls = []
    sink = (lambda rid, n, pages: calls.append(
        [int(rid), int(n), [int(p) for p in pages]])) if tag == "llama" \
        else None
    eng = ServingEngine.from_artifact(directory, tiny_preset(get_config(arch)),
                                      spill_sink=sink, device="cpu")
    rids = [eng.submit(p, max_new=n) for p, n in traffic]
    res = eng.run_until_drained()
    out[tag] = {"streams": [res[r] for r in rids],
                "model_is_none": eng.model is None,
                "source": eng._step_source, "calls": calls,
                "acks": {str(k): v for k, v in eng.spill_acks.items()}}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""

# A fresh JAX process: JAX's own cold start of its artifact.
_JAX_COLD = r"""
import json, sys
from repro.configs import CONFIGS
from repro.launch.train import tiny_preset
from repro.serving.engine import ServingEngine

traffic = json.loads(sys.argv[2])
eng = ServingEngine.from_artifact(sys.argv[3],
                                  tiny_preset(CONFIGS["llama3.2-3b"]))
assert eng._step_source == "artifact" and eng.model is None
rids = [eng.submit(p, max_new=n) for p, n in traffic]
res = eng.run_until_drained()
with open(sys.argv[1], "w") as f:
    json.dump([res[r] for r in rids], f)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(*argv, timeout=300) -> str:
    out = subprocess.run([sys.executable, *argv], capture_output=True,
                         text=True, timeout=timeout, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


# A fresh process exports both packages' artifacts (a manifest holds every
# pad the process bound, and a cold start must have each one's host, so
# the exporting process makes no other registration): JAX's llama, and the
# port's llama (with a recording spill sink), moe and vlm on JAX's weights
# (``params_from_jax``).  Writes the live engines' streams, sink calls and
# acks.  Arguments: the output directory, the traffic (JSON).
_EXPORT = r"""
import dataclasses, json, os, sys
import jax
import numpy as np
from repro.configs import CONFIGS
from repro.launch.train import tiny_preset
from repro.models import build_model as j_build
from repro.models.common import split_params
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine

out, traffic = sys.argv[1], json.loads(sys.argv[2])
geometry = dict(batch_slots=2, max_len=32, page_size=8)
arches = {"llama": "llama3.2-3b", "moe": "phi3.5-moe-42b-a6.6b",
          "vlm": "qwen2-vl-2b"}


def serve(engine):
    rids = [engine.submit(p, max_new=n) for p, n in traffic]
    res = engine.run_until_drained()
    return [res[r] for r in rids]


live = {}
for tag, arch in arches.items():
    jcfg = tiny_preset(CONFIGS[arch])
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    meta = {"arch": arch, "tiny_preset": True}
    if tag == "llama":
        jeng = JaxEngine(jmodel, jparams, **geometry)
        live["jax"] = serve(jeng)
        jeng.export_artifact(os.path.join(out, "jax"), extra_meta=meta)
    values, _ = split_params(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, values), device="cpu")
    calls = []
    sink = (lambda rid, n, pages: calls.append(
        [int(rid), int(n), [int(p) for p in pages]])) if tag == "llama" \
        else None
    eng = ServingEngine(build_model(ModelConfig(**dataclasses.asdict(jcfg)),
                                    device="cpu"),
                        params, spill_sink=sink, device="cpu", **geometry)
    live[tag] = serve(eng)
    if tag == "llama":
        live["llama_sink"] = [calls, {str(k): v for k, v in
                                      eng.spill_acks.items()}]
    eng.export_artifact(os.path.join(out, tag), extra_meta=meta)
with open(os.path.join(out, "live.json"), "w") as f:
    json.dump(live, f)
"""


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """Export the artifacts in a fresh process, cold-start them in two
    more (the port's three, JAX's llama).  Returns what each side saw and
    JAX's llama weights."""
    tmp = tmp_path_factory.mktemp("artifacts")
    traffic = json.dumps(TRAFFIC)
    _run("-c", _EXPORT, str(tmp), traffic)
    dirs = [f"{tag}={arch}={tmp / tag}" for tag, arch in ARCHES.items()]
    _run("-c", _PORT_COLD, str(tmp / "port.json"), traffic, *dirs)
    _run("-c", _JAX_COLD, str(tmp / "jax.json"), traffic, str(tmp / "jax"))
    live = json.loads((tmp / "live.json").read_text())
    cold = json.loads((tmp / "port.json").read_text())
    cold["jax"] = json.loads((tmp / "jax.json").read_text())
    jvalues, _ = split_params(j_build(j_tiny(CONFIGS[ARCHES["llama"]])).init(
        jax.random.PRNGKey(0)))
    return tmp, live, cold, jvalues


def test_cold_started_port_artifact_serves_jax_artifact_streams(round_trip):
    """The port's artifact, served in a fresh process that builds no model
    and traces nothing, gives the streams of JAX's artifact on the same
    weights, and both give the live engines' streams."""
    _, live, cold, _ = round_trip
    assert cold["llama"]["streams"] == cold["jax"] == live["jax"] \
        == live["llama"]
    assert cold["llama"]["model_is_none"]
    assert cold["llama"]["source"] == "artifact"


def test_artifact_files_match_jax(round_trip):
    """engine.json byte-equal to JAX's for the same extra_meta; the same
    checkpoint files (JAX's names, the stacked layout); JAX's
    restore_checkpoint reads the port's step-0 checkpoint to JAX's
    values."""
    tmp, _, _, jvalues = round_trip
    port, jax_dir = tmp / "llama", tmp / "jax"
    assert (port / "engine.json").read_bytes() == \
        (jax_dir / "engine.json").read_bytes()
    steps = sorted(n for n in os.listdir(port) if n.startswith("step0-"))
    assert steps == sorted(n for n in os.listdir(jax_dir)
                           if n.startswith("step0-"))
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        jvalues)
    step, restored = jckpt.restore_checkpoint(str(port), {"values": like},
                                              step=0)
    assert step == 0
    for got, want in zip(jax.tree.leaves(restored["values"]),
                         jax.tree.leaves(jvalues)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    section = json.loads((port / "manifest-0.json").read_text())["transport"]
    assert section == json.loads((port / "manifest.json").read_text())
    assert (port / "serve_step.pt2").stat().st_size < 4 << 20


def test_artifact_engine_spill_calls_and_acks_match_live(round_trip):
    """With a spill_sink, the cold-started engine's sink calls (request,
    tokens, page ids) and acks equal the live engine's."""
    _, live, cold, _ = round_trip
    calls, acks = live["llama_sink"]
    assert len(calls) == len(TRAFFIC)
    assert cold["llama"]["calls"] == calls
    assert cold["llama"]["acks"] == acks


@pytest.mark.parametrize("tag", ["moe", "vlm"])
def test_moe_and_vlm_artifacts_serve_live_streams(round_trip, tag):
    _, live, cold, _ = round_trip
    assert cold[tag]["streams"] == live[tag]
    assert cold[tag]["source"] == "artifact" and cold[tag]["model_is_none"]


def test_artifact_refuses_another_device(round_trip):
    """A step exported on the CPU serves only there (its graph records the
    device)."""
    tmp, _, _, _ = round_trip
    from repro_torch.configs import get_config
    from repro_torch.launch.train import tiny_preset
    with pytest.raises((ValueError, RuntimeError)):
        ServingEngine.from_artifact(str(tmp / "llama"),
                                    tiny_preset(get_config("llama3.2-3b")),
                                    device="meta")


def test_serve_cli_exports_then_cold_starts(tmp_path):
    """launch/serve.py --export-artifact, then --from-artifact in another
    process: the same streams."""
    art = str(tmp_path / "art")
    args = ["--requests", "3", "--max-new", "4", "--device", "cpu"]
    first = _run("-m", "repro_torch.launch.serve", "--preset", "tiny",
                 "--export-artifact", art, *args)
    second = _run("-m", "repro_torch.launch.serve", "--from-artifact", art,
                  *args)
    assert "cold start" in second and "artifact" in second

    def streams(text):
        return [ln for ln in text.splitlines() if "request" in ln
                and ln.startswith("[serve] request")]

    assert len(streams(first)) == 3
    assert streams(first) == streams(second)
