"""The port's checkpoints (``repro_torch/ckpt/checkpoint.py``) against the
JAX package's on the CPU: the same files byte for byte, restores across the
two packages, the manager, the trainer's kill-and-resume against JAX's.

Tolerances: the files and the tree keys are exact; restored leaves are
bit-equal to what was saved; a training run of the ``tiny`` preset is held
to JAX's losses within test_torch_train.py's 2e-5 relative, and its saved
parameters after 18 AdamW steps within 2 * lr absolute (an entry whose
gradient is near 0 may take one step of the other sign when the two
packages round it apart) with all but 1e-4 of them within 2e-4 (the
one-step tolerance of test_torch_train.py).
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.rpc import RpcManifest as JManifest  # noqa: E402
from repro.launch.train import run as j_run  # noqa: E402
from repro.launch.train import tiny_preset as j_tiny  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.common import split_params  # noqa: E402
from repro.train.optimizer import OptState as JOptState  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.ckpt import (CheckpointManager, latest_step,  # noqa: E402
                              load_transport, restore_checkpoint,
                              save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (from_jax_layout, params_from_jax,  # noqa: E402
                                 to_jax_layout)
from repro_torch.core.rpc import RpcManifest, ShapeDtype  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig, OptState, adamw_init  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves, tree_map  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_arrays():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "ids": rng.integers(-9, 9, (5,)).astype(np.int32),
            "big": rng.integers(0, 2**40, (2, 2)).astype(np.int64),
            "h": rng.standard_normal((2, 3)).astype(np.float32),
            "layers": [rng.standard_normal((2,)).astype(np.float32)
                       for _ in range(2)],
            "m": rng.standard_normal((4,)).astype(np.float32)}


def _trees(bf16=True):
    """The same tree for both packages: fp32, int32, int64 and (optionally)
    bf16 leaves, a list and an optimizer state (JAX's step an int32
    array, the port's a Python int)."""
    a = _mixed_arrays()
    h = jnp.asarray(a["h"], jnp.bfloat16) if bf16 else jnp.asarray(a["h"])
    m = jnp.asarray(a["m"])
    jt = {"values": {"w": jnp.asarray(a["w"]), "ids": jnp.asarray(a["ids"]),
                     "big": a["big"], "h": h,
                     "layers": [jnp.asarray(x) for x in a["layers"]]},
          "opt": JOptState(master={"m": m}, mu={"m": m}, nu={"m": m},
                           step=jnp.int32(7))}
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()
         if k != "layers"}
    if bf16:
        t["h"] = t["h"].to(torch.bfloat16)
    tt = {"values": {"w": t["w"], "ids": t["ids"], "big": t["big"],
                     "h": t["h"],
                     "layers": [torch.from_numpy(x.copy())
                                for x in a["layers"]]},
          "opt": OptState(master={"m": t["m"]}, mu={"m": t["m"].clone()},
                          nu={"m": t["m"].clone()}, step=7)}
    return jt, tt


def test_tree_paths_are_jax_checkpoint_keys():
    jt, tt = _trees()
    assert list(flatten_with_paths(tt)) == list(jckpt._flatten_with_paths(jt))
    assert "opt/master/m" in flatten_with_paths(tt)
    assert "opt/step" in flatten_with_paths(tt)


def test_files_byte_equal_and_manifests_equal_but_time(tmp_path):
    jt, tt = _trees()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, 3, jt)
    save_checkpoint(tdir, 3, tt)
    jfiles, tfiles = sorted(os.listdir(jdir)), sorted(os.listdir(tdir))
    assert jfiles == tfiles and "manifest-3.json" in tfiles
    for name in jfiles:
        if name.endswith(".npy"):
            with open(os.path.join(jdir, name), "rb") as f, \
                    open(os.path.join(tdir, name), "rb") as g:
                assert f.read() == g.read(), name
    jm = json.load(open(os.path.join(jdir, "manifest-3.json")))
    tm = json.load(open(os.path.join(tdir, "manifest-3.json")))
    jm.pop("time"), tm.pop("time")
    assert jm == tm
    assert tm["entries"]["values/h"]["dtype"] == "bfloat16"
    assert tm["entries"]["opt/step"] == {
        "file": tm["entries"]["opt/step"]["file"], "shape": [],
        "dtype": "int32"}
    assert tm["entries"]["values/big"]["dtype"] == "int64"


def _j_like(tree):
    return jax.tree.map(lambda v: jax.ShapeDtypeStruct(np.shape(v),
                                                      np.asarray(v).dtype),
                        tree)


def _t_like(tree):
    return tree_map(lambda t: ShapeDtype(t.shape, t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def test_each_package_restores_the_others_fp32_checkpoint(tmp_path):
    jt, tt = _trees(bf16=False)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5, jt)
    save_checkpoint(str(tmp_path / "port"), 5, tt)

    step, got = restore_checkpoint(str(tmp_path / "jax"), _t_like(tt),
                                   device="cpu")
    assert step == 5 and got["opt"].step == 7
    for a, b in zip(leaves(got), leaves(tt)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    step, jgot = jckpt.restore_checkpoint(str(tmp_path / "port"), _j_like(jt))
    assert step == 5
    # JAX (x64 off) narrows the int64 leaf to int32 as it lands
    assert jgot["values"].pop("big").dtype == jnp.int32
    jt["values"].pop("big")
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_restores_jax_bf16_leaves_that_jax_cannot(tmp_path):
    jt, tt = _trees()
    jckpt.save_checkpoint(str(tmp_path), 2, jt)
    _, got = restore_checkpoint(str(tmp_path), tt, device="cpu")
    assert got["values"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["values"]["h"], tt["values"]["h"])
    # the reference's own caveat: np.load gives raw V2 records
    with pytest.raises(ValueError, match="No cast function"):
        jckpt.restore_checkpoint(str(tmp_path), _j_like(jt))


def _manifests():
    kw = dict(pads={12345: {"callee": "log.loss",
                            "signature": [["val", [], "float32"]]}},
              callees={77: "hook.save"}, formats={99: "step %d\n"},
              queues=[{"capacity": 1024, "width": 8}])
    return JManifest(**kw), RpcManifest(**kw)


def test_load_transport_reads_the_other_packages_section(tmp_path):
    jman, tman = _manifests()
    assert jman.to_json() == tman.to_json()
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, {"x": np.ones(2)},
                          transport=jman)
    save_checkpoint(str(tmp_path / "port"), 1, {"x": torch.ones(2)},
                    transport=tman)
    got = load_transport(str(tmp_path / "jax"))
    assert got.to_json() == tman.to_json()
    jgot = jckpt.load_transport(str(tmp_path / "port"))
    assert jgot.to_json() == jman.to_json()
    save_checkpoint(str(tmp_path / "none"), 1, {"x": torch.ones(2)})
    assert load_transport(str(tmp_path / "none")) is None


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("llama3.2-3b").reduced()
    model = build_model(cfg, device="cpu")
    values = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16), dtype=np.int32))
    return model, values, {"tokens": tokens}


def test_checkpoint_restart_bitwise(setup, tmp_path):
    """Kill-and-restore continues bit-identically (the port's version of
    tests/test_train.py's)."""
    model, values, batch = setup
    values = tree_map(lambda t: t.clone(), values)
    opt = adamw_init(values)
    step = make_train_step(model, OptConfig(lr=1e-3))
    for _ in range(3):
        values, opt, _ = step(values, opt, batch)
    save_checkpoint(str(tmp_path), 3, {"values": values, "opt": opt})

    # the "failed node" restores into the shapes and dtypes alone
    like = _t_like({"values": values, "opt": opt})
    st, restored = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert st == 3 and restored["opt"].step == 3
    v_a, _, _ = step(values, opt, batch)              # original continues
    v_b, _, _ = step(restored["values"], restored["opt"], batch)
    for a, b in zip(leaves(v_a), leaves(v_b)):
        assert torch.equal(a, b)


def test_checkpoint_manager_async_and_atomic(tmp_path):
    mgr = CheckpointManager(str(tmp_path), queue_depth=2)
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    for s in (5, 10):
        mgr.submit(s, tree)
    tree["a"].fill_(-1.0)          # submit copied: later writes don't leak
    mgr.wait()
    mgr.close()
    assert latest_step(str(tmp_path)) == 10
    assert not mgr.errors and [w[0] for w in mgr.writes] == [5, 10]
    assert mgr.writes[0][2] == 4 * (10 + 9)
    # a torn manifest (tmp file) must never be picked up
    open(os.path.join(str(tmp_path), ".manifest-99.tmp"), "w").write("{")
    assert latest_step(str(tmp_path)) == 10
    _, got = restore_checkpoint(str(tmp_path), {"a": torch.zeros(10),
                                                "b": {"c": torch.zeros(3, 3)}})
    assert torch.equal(got["a"], torch.arange(10.0))


def test_host_hook_writes_what_a_direct_save_writes(tmp_path):
    """The hook's payload rides the RPC transport (bf16 staged as fp32,
    the int step as a scalar word); its files equal save_checkpoint's."""
    from repro_torch.core.device_main import device_run
    _, tt = _trees()
    tt["values"].pop("big")       # the transport narrows 64-bit leaves
    mgr = CheckpointManager(str(tmp_path / "hook"))
    device_run(lambda i, s: s, tt, 4,
               hooks=[mgr.host_hook(2, lambda step, s: s)])
    mgr.wait()
    mgr.close()
    save_checkpoint(str(tmp_path / "direct"), 4, tt)
    hook = sorted(n for n in os.listdir(tmp_path / "hook")
                  if n.startswith("step4"))
    direct = sorted(n for n in os.listdir(tmp_path / "direct")
                    if n.endswith(".npy"))
    assert hook == direct
    for name in direct:
        assert (tmp_path / "hook" / name).read_bytes() == \
            (tmp_path / "direct" / name).read_bytes(), name
    assert latest_step(str(tmp_path / "hook")) == 4


def test_layouts_round_trip_and_match_jax_keys():
    jvalues = _jax_values()
    tvalues = params_from_jax(jvalues, device="cpu")
    topt = adamw_init(tvalues)
    jopt = j_adamw_init(jvalues)
    tree = {"values": tvalues, "opt": topt}
    stacked = to_jax_layout(tree)
    assert list(flatten_with_paths(stacked)) == list(
        jckpt._flatten_with_paths({"values": jvalues, "opt": jopt}))
    back = from_jax_layout(stacked)
    assert list(flatten_with_paths(back)) == list(flatten_with_paths(tree))
    for a, b in zip(leaves(back), leaves(tree)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_port_checkpoint_in_jax_layout_restores_in_jax(tmp_path):
    jvalues = _jax_values()
    tvalues = params_from_jax(jvalues, device="cpu")
    save_checkpoint(str(tmp_path), 4,
                    to_jax_layout({"values": tvalues,
                                   "opt": adamw_init(tvalues)}))
    like = {"values": _j_like(jvalues), "opt": _j_like(j_adamw_init(jvalues))}
    step, got = jckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 4
    for a, b in zip(jax.tree.leaves(got["values"]), jax.tree.leaves(jvalues)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(got["opt"].step) == 0


_RUN = dict(preset="tiny", batch=4, seq_len=32, lr=5e-3)


def _jax_values():
    jcfg = j_tiny(j_get_config("llama3.2-3b"))
    jvalues, _ = split_params(j_build(jcfg).init(jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, jvalues)


def _converted_init(monkeypatch):
    """Both packages' runs start from the JAX run's weights; returns the
    port's copy of them."""
    converted = params_from_jax(_jax_values(), device="cpu")
    monkeypatch.setattr(Model, "init", lambda self, seed=0: tree_map(
        lambda t: t.clone(), converted))
    return converted


def _losses(out):
    return np.array([l for _, l in out["losses"]])


def _manifest_step_state(directory, step):
    """(the manifest's step, the saved optimizer step)."""
    with open(os.path.join(directory, f"manifest-{step}.json")) as f:
        m = json.load(f)
    opt_step = np.load(os.path.join(directory,
                                    m["entries"]["opt/step"]["file"]))
    return m["step"], int(opt_step)


def test_run_with_checkpoints_and_resume_matches_jax(tmp_path, monkeypatch):
    """tests/test_train.py's end-to-end scenario in both packages: 12 steps
    saving every 6, then a resume for 6 more."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j1 = j_run("llama3.2-3b", steps=12, ckpt_dir=jdir, ckpt_every=6,
               log_every=4, **_RUN)
    j2 = j_run("llama3.2-3b", steps=6, ckpt_dir=jdir, ckpt_every=6,
               log_every=1, resume=True, **_RUN)
    jax.effects_barrier()
    converted = _converted_init(monkeypatch)
    t1 = run("llama3.2-3b", steps=12, ckpt_dir=tdir, ckpt_every=6,
             log_every=4, device="cpu", **_RUN)
    assert latest_step(tdir) == 12 and len(t1["losses"]) == 3
    t2 = run("llama3.2-3b", steps=6, ckpt_dir=tdir, ckpt_every=6,
             log_every=1, resume=True, device="cpu", **_RUN)
    assert t2["final_step"] == j2["final_step"] == 18
    assert t2["start_step"] == 12
    np.testing.assert_allclose(_losses(t1), _losses(j1), rtol=2e-5)
    np.testing.assert_allclose(_losses(t2), _losses(j2), rtol=2e-5)

    def manifests(d):
        return sorted(n for n in os.listdir(d) if n.startswith("manifest-"))

    assert manifests(tdir) == manifests(jdir) == [
        "manifest-12.json", "manifest-18.json", "manifest-6.json"]
    # the resumed run labels its periodic save with its own step count
    for d in (jdir, tdir):
        assert _manifest_step_state(d, 6) == (6, 18)
        assert _manifest_step_state(d, 18) == (18, 18)
    _, jstate = jckpt.restore_checkpoint(
        jdir, {"values": _j_like(_jax_values())})
    _, tstate = restore_checkpoint(tdir, {"values": converted})
    got = to_jax_layout(tstate)["values"]
    far = total = 0
    for a, b in zip(leaves(got), jax.tree.leaves(jstate["values"])):
        d = np.abs(a.numpy() - np.asarray(b))
        np.testing.assert_array_less(d, 2 * _RUN["lr"])
        far, total = far + int((d > 2e-4).sum()), total + d.size
    assert far <= 1e-4 * total, (far, total)


def test_jax_training_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """A checkpoint of JAX's trainer (stacked layers) resumes in the port's
    trainer through convert.py, and trains as JAX's resumed run does."""
    jdir = str(tmp_path / "jax")
    j_run("llama3.2-3b", steps=8, ckpt_dir=jdir, ckpt_every=8, log_every=0,
          **_RUN)
    copy = str(tmp_path / "copy")
    shutil.copytree(jdir, copy)
    j2 = j_run("llama3.2-3b", steps=5, ckpt_dir=jdir, ckpt_every=0,
               log_every=1, resume=True, **_RUN)
    jax.effects_barrier()
    _converted_init(monkeypatch)
    t2 = run("llama3.2-3b", steps=5, ckpt_dir=copy, ckpt_every=0,
             log_every=1, resume=True, device="cpu", **_RUN)
    assert t2["start_step"] == 8 and t2["final_step"] == 13
    np.testing.assert_allclose(_losses(t2), _losses(j2), rtol=2e-5)
