"""Sharded training (``train/step.py``'s mesh step, ``launch/train.py::
run(mesh=)``, ``restore_checkpoint(shardings=)``) on ``gloo`` worlds of
4, 2 and 1 processes on the CPU.

* ``run(preset="tiny", steps=3, batch=4, seq_len=16)`` on a (2, 2)
  ``("data", "model")`` mesh from JAX's weights against the JAX package's
  run on its Auto (2, 2) mesh of 4 host devices, in a child process (JAX
  0.9 runs it only with ``log_every=0`` and no checkpoints: ROADMAP
  caveat E): the final loss within 1e-5 relative, for llama3.2-3b and for
  phi3.5-moe, whose capacity drops make it differ from the run without a
  mesh; every rank's fp32 master, mu and nu hold only its ZeRO-1 block;
* ``gather_once``: one weight all-gather a step against one a microbatch,
  the same step within fp32 tolerance;
* checkpoints: the mesh run's files are JAX's format (byte-equal to a
  plain save of the same full state), restore at worlds of 4, 2 and 1
  (and a plain save's at 4) gives the checkpoint's state, from which
  training resumes with the uninterrupted run's losses; a run that fails
  after a save resumes from that save's files; on a world of one the
  (1, 1) mesh run's files are the run without a mesh's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RUN = dict(preset="tiny", steps=3, batch=4, seq_len=16)
#: JAX's final losses without a mesh (the same run, one device)
NO_MESH = {"phi3.5-moe-42b-a6.6b": 6.999347}

_JAX_CHILD = """
import json, pickle, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch.train import run, tiny_preset
from repro.models.common import split_params
from repro.models.model_zoo import build_model
arch, path = sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = run(arch, log_every=0, mesh=mesh, **json.loads(sys.argv[3]))
values, _ = split_params(build_model(tiny_preset(get_config(arch))).init(
    jax.random.PRNGKey(0)))
with open(path, "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, values), f)
print("RESULT " + json.dumps({"final_loss": float(out["final_loss"])}))
"""

_PORT_RUN = """
import pickle
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.libc import rand_init
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import run, tiny_preset
from repro_torch.models import Model, build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import MeshPlan, make_train_step
from repro_torch.tree import leaves, tree_map
with open({pkl!r}, "rb") as f:
    vals = params_from_jax(pickle.load(f), device="cpu")
Model.init = lambda self, seed=0: tree_map(lambda t: t.clone(), vals)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
out = run({arch!r}, mesh=mesh, device="cpu", log_every=1, keep_state=True,
          **{run})
cfg = tiny_preset(get_config({arch!r}))
model = build_model(cfg, device="cpu")
plan = MeshPlan.build(model, mesh)
# one sharded step from JAX's weights: its global gradient norm
_, batch = SyntheticLM(cfg.vocab_size, 16, 4).batch_at(
    rand_init(1234, device="cpu"), 0)
with sh.ShardingCtx(mesh):
    v = plan.block_values(model.init(0))
    _, _, m = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1,
                                               total_steps=3))(
        v, plan.init_opt(v), batch)
shapes = lambda t: [list(x.shape) for x in leaves(t)]  # noqa: E731
st = out["state"]
report({{"final": out["final_loss"], "losses": out["losses"],
        "grad_norm": float(m["grad_norm"]), "step_loss": float(m["loss"]),
        "master": shapes(st["opt"].master), "mu": shapes(st["opt"].mu),
        "nu": shapes(st["opt"].nu), "values": shapes(st["values"]),
        "zero1": [list(z.block_shape(s.shape)) for z, s in
                  zip(plan.zero1, leaves(plan.specs))],
        "blocks": [list(v.block_shape(s.shape)) for v, s in
                   zip(plan.values, leaves(plan.specs))],
        "full": [list(s.shape) for s in leaves(plan.specs)]}})
"""


def _jax_mesh_run(arch, workdir):
    pkl = os.path.join(workdir, "values.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD, arch, pkl, json.dumps(RUN)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    return json.loads(line[0][7:])["final_loss"], pkl


def _jax_first_step(arch, pkl):
    """JAX's first training step on the saved weights and step 0's
    batch: (loss, global gradient norm)."""
    import pickle

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.libc import rand_init
    from repro.data.pipeline import SyntheticLM
    from repro.launch.train import tiny_preset
    from repro.models.model_zoo import build_model
    from repro.train.optimizer import OptConfig, adamw_init
    from repro.train.step import make_train_step

    cfg = tiny_preset(get_config(arch))
    model = build_model(cfg)
    _, axes = model.param_specs()
    with open(pkl, "rb") as f:
        values = jax.tree.map(jnp.asarray, pickle.load(f))
    _, batch = SyntheticLM(cfg.vocab_size, 16, 4).batch_at(
        rand_init(1234), jnp.int32(0))
    step = make_train_step(model, axes, OptConfig(lr=1e-3, warmup_steps=1,
                                                  total_steps=3))
    _, _, m = step(values, adamw_init(values), batch)
    return float(m["loss"]), float(m["grad_norm"])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "phi3.5-moe-42b-a6.6b"])
def test_mesh_run_matches_jax_auto_mesh(arch, tmp_path):
    jax_final, pkl = _jax_mesh_run(arch, str(tmp_path))
    reps = run_world(_PORT_RUN.format(pkl=pkl, arch=arch, run=RUN), 4,
                     str(tmp_path / "world"))
    finals = [r[0]["final"] for r in reps]
    assert len(set(finals)) == 1                 # a global loss
    assert abs(finals[0] - jax_final) <= 1e-5 * abs(jax_final)
    # the loss hook: the first rank logs every step once, the others none
    assert [s for s, _ in reps[0][0]["losses"]] == [1, 2, 3]
    assert all(r[0]["losses"] == [] for r in reps[1:])
    if arch in NO_MESH:
        assert abs(finals[0] - NO_MESH[arch]) > 1e-3
    else:
        # AdamW after clipping hides a uniform factor on the gradients
        # from the losses; the global gradient norm shows it: JAX's step
        # (one device: a dense model's mesh step is the same function)
        jloss, jnorm = _jax_first_step(arch, pkl)
        np.testing.assert_allclose(reps[0][0]["step_loss"], jloss, rtol=2e-5)
        np.testing.assert_allclose(reps[0][0]["grad_norm"], jnorm, rtol=2e-5)
    for r in reps:
        got = r[0]
        assert got["master"] == got["mu"] == got["nu"] == got["zero1"]
        assert got["values"] == got["blocks"]
    # something is sharded: ZeRO-1 blocks smaller than the full leaves
    got = reps[0][0]
    assert sum(np.prod(z) for z in got["zero1"]) * 2 < \
        sum(np.prod(f) for f in got["full"])


_GATHER_ONCE = """
from repro_torch.configs import get_config
from repro_torch.core.libc import rand_init
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import tiny_preset
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import MeshPlan, make_train_step
from repro_torch.tree import leaves
cfg = tiny_preset(get_config("llama3.2-3b"))
model = build_model(cfg, device="cpu")
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
_, batch = SyntheticLM(cfg.vocab_size, 16, 8).batch_at(
    rand_init(1234, device="cpu"), 0)
out = {{}}
for once in (False, True):
    with sh.ShardingCtx(mesh):
        plan = MeshPlan.build(model, mesh)
        values = plan.block_values(model.init(0))
        opt = plan.init_opt(values)
        step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=4),
                               microbatches=4, gather_once=once)
        gathers = []
        for i in range(2):
            before = step.weight_gathers
            values, opt, m = step(values, opt, batch)
            gathers.append(step.weight_gathers - before)
        full = plan.gather_state(values, opt)["values"]
    out[str(once)] = {{"gathers": gathers, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "values": [t.reshape(-1)[:64].tolist()
                                 for t in leaves(full)]}}
report(out)
"""


def test_gather_once_gathers_once_a_step(tmp_path):
    """A world of 4, 4 microbatches of 2 rows: the weights are gathered 4
    times a step without ``gather_once`` and once with it; the steps
    agree within fp32 tolerance, and agree with the step without a
    mesh."""
    from repro_torch.configs import get_config
    from repro_torch.core.libc import rand_init
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import tiny_preset
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    reps = run_world(_GATHER_ONCE.format(), 4, str(tmp_path))
    out = reps[0][0]
    assert out["False"]["gathers"] == [4, 4]
    assert out["True"]["gathers"] == [1, 1]
    assert all(r[0]["True"]["loss"] == out["True"]["loss"] for r in reps)
    cfg = tiny_preset(get_config("llama3.2-3b"))
    model = build_model(cfg, device="cpu")
    _, batch = SyntheticLM(cfg.vocab_size, 16, 8).batch_at(
    rand_init(1234, device="cpu"), 0)
    values = model.init(0)
    opt = adamw_init(values)
    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=4), microbatches=4)
    for _ in range(2):
        values, opt, m = step(values, opt, batch)
    want = [t.reshape(-1)[:64].tolist() for t in leaves(values)]
    for key in ("False", "True"):
        np.testing.assert_allclose(out[key]["loss"], float(m["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(out[key]["grad_norm"],
                                   float(m["grad_norm"]), rtol=2e-5)
        for a, b in zip(out[key]["values"], want):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)


_CKPT_TRAIN = """
import torch
from repro_torch.ckpt import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import run, tiny_preset
from repro_torch.models import build_model
from repro_torch.train.step import MeshPlan
from repro_torch.tree import flatten_with_paths
mesh = make_mesh({shape}, ("data", "model"), device="cpu")
kw = dict(preset="tiny", batch=4, seq_len=16, log_every=1, device="cpu",
          total_steps=3, mesh=mesh)
if {save}:
    first = run("llama3.2-3b", steps=2, ckpt_dir={ckpt!r}, ckpt_every=1,
                **kw)
    whole = run("llama3.2-3b", steps=3, **kw)
    report({{"first": first["losses"], "whole": whole["losses"],
            "whole_final": whole["final_loss"]}})
model = build_model(tiny_preset(get_config("llama3.2-3b")), device="cpu")
plan = MeshPlan.build(model, mesh)
like = {{"values": plan.specs, "opt": plan.opt_specs()}}
step, blocks = restore_checkpoint(
    {ckpt!r}, like, shardings={{"values": plan.value_shardings(),
                               "opt": plan.opt_shardings()}}, device="cpu")
full = plan.gather_state(blocks["values"], blocks["opt"])
_, plain = restore_checkpoint({ckpt!r}, like, device="cpu")
a, b = flatten_with_paths(full), flatten_with_paths(plain)
same = all((torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
            else a[k] == b[k]) for k in b)
resumed = run("llama3.2-3b", steps=1, resume=True, ckpt_dir={ckpt!r}, **kw)
report({{"step": step, "same_state": same, "resumed": resumed["losses"],
        "resumed_final": resumed["final_loss"],
        "block_leaves": [list(t.shape) for t in
                         flatten_with_paths(blocks).values()
                         if isinstance(t, torch.Tensor)][:4]}})
"""


def test_mesh_checkpoints_save_and_reshard(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    saved = run_world(_CKPT_TRAIN.format(shape=(2, 2), save=True, ckpt=ckpt),
                      4, str(tmp_path / "w4"))
    first, resumed4 = saved[0]
    # the files: the manifests of steps 1 and 2 (the hook's and the last
    # save's), each leaf full and written once, byte-equal to a plain save
    # of the same full state
    assert sorted(n for n in os.listdir(ckpt) if n.startswith("manifest")) \
        == ["manifest-1.json", "manifest-2.json"]
    with open(os.path.join(ckpt, "manifest-2.json")) as f:
        manifest = json.load(f)
    like = _like_from_manifest(manifest)
    _, state = restore_checkpoint(ckpt, like, device="cpu")
    again = str(tmp_path / "again")
    save_checkpoint(again, 2, state)
    for key, ent in manifest["entries"].items():
        with open(os.path.join(ckpt, ent["file"]), "rb") as f1, \
                open(os.path.join(again, ent["file"]), "rb") as f2:
            assert f1.read() == f2.read(), key
    with open(os.path.join(again, "manifest-2.json")) as f:
        assert json.load(f)["entries"] == manifest["entries"]
    assert int(state["opt"]["step"] if isinstance(state["opt"], dict)
               else state["opt"].step) == 2
    # restore at worlds of 4, 2 and 1: the same state, the same step 3
    worlds = {4: resumed4}
    for n, shape in ((2, (2, 1)), (1, (1, 1))):
        worlds[n] = run_world(_CKPT_TRAIN.format(shape=shape, save=False,
                                                 ckpt=ckpt),
                              n, str(tmp_path / f"w{n}"))[0][0]
    whole = first["whole"]
    for n, got in worlds.items():
        assert got["step"] == 2 and got["same_state"], n
        assert [s for s, _ in got["resumed"]] == [1]
        np.testing.assert_allclose(got["resumed_final"],
                                   first["whole_final"], rtol=1e-5)
    np.testing.assert_allclose([l for _, l in first["first"]],
                               [l for _, l in whole[:2]], rtol=1e-6)
    # a world of 4 holds blocks, a world of 1 whole leaves
    assert worlds[4]["block_leaves"] != worlds[1]["block_leaves"]
    # and the reverse: the plain save (a world of one's) restores on 4
    back = run_world(_CKPT_TRAIN.format(shape=(2, 2), save=False,
                                        ckpt=again),
                     4, str(tmp_path / "back"))[0][0]
    assert back["step"] == 2 and back["same_state"]
    np.testing.assert_allclose(back["resumed_final"], first["whole_final"],
                               rtol=1e-5)


_KILLED = """
import os
import repro_torch.launch.train as train
from repro_torch.distributed.collectives import barrier
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
kw = dict(preset="tiny", batch=4, seq_len=16, log_every=1, device="cpu",
          total_steps=4, mesh=mesh)
real = train.make_train_step


def dies_at_step_3(*args, **kwargs):
    step, calls = real(*args, **kwargs), []

    def killed(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("killed at step 3")
        return step(*a)
    return killed


train.make_train_step = dies_at_step_3
try:
    train.run("llama3.2-3b", steps=4, ckpt_dir={ckpt!r}, ckpt_every=2, **kw)
    error = None
except RuntimeError as e:
    error = str(e)
train.make_train_step = real
barrier(mesh=mesh)              # the first rank's writes have landed
files = sorted(n for n in os.listdir({ckpt!r}) if n.startswith("manifest"))
resumed = train.run("llama3.2-3b", steps=2, resume=True, ckpt_dir={ckpt!r},
                    **kw)
whole = train.run("llama3.2-3b", steps=4, **kw)
report({{"error": error, "files": files, "start": resumed["start_step"],
        "resumed": resumed["losses"], "whole": whole["losses"]}})
"""


def test_mesh_run_killed_after_a_save_resumes(tmp_path):
    """A (2, 2) mesh run of 4 steps with a save every 2 fails in its
    third step: the save of step 2 is on disk (written from inside the
    loop, not at its end), and the run resumed from it for the last 2
    steps logs the uninterrupted run's losses."""
    ckpt = str(tmp_path / "ckpt")
    reps = run_world(_KILLED.format(ckpt=ckpt), 4, str(tmp_path / "w"))
    assert all(r[0]["error"] == "killed at step 3" for r in reps)
    got = reps[0][0]
    assert got["files"] == ["manifest-2.json"]
    assert got["start"] == 2
    assert [s for s, _ in got["resumed"]] == [1, 2]
    np.testing.assert_allclose([l for _, l in got["resumed"]],
                               [l for _, l in got["whole"][2:]], rtol=1e-5)


def _like_from_manifest(manifest):
    """A {"values", "opt"} tree of ShapeDtypes from a port manifest's
    paths (``opt/step`` a Python int)."""
    from repro_torch.core.rpc import ShapeDtype, _torch_dtype
    tree = {}
    for path, ent in manifest["entries"].items():
        node, parts = tree, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = 0 if path == "opt/step" else ShapeDtype(
            tuple(ent["shape"]), _torch_dtype(ent["dtype"]))

    def lists(t):
        if isinstance(t, dict) and t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        if isinstance(t, dict):
            return {k: lists(v) for k, v in t.items()}
        return t
    return lists(tree)


def test_one_device_mesh_checkpoints_are_the_plain_run_s(tmp_path):
    """On a world of one and its (1, 1) mesh the sharded step of a dense
    model is the unsharded arithmetic (a moe model's is not: the mesh
    takes the capacity path): the files of ``run(mesh=, ckpt_every=1)``
    are byte-equal to those of the run without a mesh, and the manifests
    equal but for ``time``."""
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.launch.train import run

    init_world(device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    kw = dict(preset="tiny", steps=2, batch=2, seq_len=16, log_every=1,
              device="cpu", ckpt_every=1)
    dirs = {name: str(tmp_path / name) for name in ("plain", "mesh")}
    plain = run("llama3.2-3b", ckpt_dir=dirs["plain"], **kw)
    meshed = run("llama3.2-3b", ckpt_dir=dirs["mesh"], mesh=mesh, **kw)
    assert meshed["losses"] == plain["losses"]
    names = sorted(os.listdir(dirs["plain"]))
    assert names == sorted(os.listdir(dirs["mesh"]))
    assert {"manifest-1.json", "manifest-2.json"} <= set(names)
    for name in names:
        paths = [os.path.join(dirs[k], name) for k in ("plain", "mesh")]
        if name.endswith(".npy"):
            with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                assert a.read() == b.read(), name
        else:
            a, b = (json.load(open(p)) for p in paths)
            a.pop("time"), b.pop("time")
            assert a == b, name
