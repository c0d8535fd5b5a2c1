"""The port's training slice against the JAX package on the CPU, at the
``tiny_preset`` size (4 layers, d_model 128, 4 heads over 2 KV heads,
head_dim 16, vocab 512, fp32, remat "full") with the JAX weights converted
by ``params_from_jax``.

Tolerances (fp32):
- forward logits, loss, prefill logits and cache 2e-5 (tests/test_kernels.py
  for fp32): the same arithmetic, sums in another order;
- gradients 1e-4: the backward adds three products per layer and the
  softmax's derivative, whose rounding differences add up to a few times
  the forward's;
- AdamW 1e-6 relative and 1e-8 absolute: the same elementwise formula in
  fp32 (a division by a scalar may become a multiplication by its
  reciprocal), so entries near 0 differ by a few ulps of the update;
- one train step 1e-5 on the loss and 2e-4 absolute on the parameters:
  the first AdamW step moves each parameter by about lr * sign(g), so a
  gradient entry near 0 whose rounding differs moves its parameter by up
  to 2 * lr * warmup fraction (2e-4 here);
- the 20-step loss trajectory 2e-5 relative (fp32's tolerance): each
  step's rounding differences feed the next step's gradients, and AdamW's
  per-entry normalisation can amplify them in entries near 0; the largest
  difference seen is 3.3e-7, so the bound leaves room for other CPUs'
  summation orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.device_main import HostHook as JHook  # noqa: E402
from repro.core.device_main import device_run as j_device_run  # noqa: E402
from repro.core.libc import rand_init as j_rand_init  # noqa: E402
from repro.core.libc import rand_u32 as j_rand_u32  # noqa: E402
from repro.core.libc import rand_uniform as j_rand_uniform  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.launch.train import run as j_run  # noqa: E402
from repro.launch.train import tiny_preset as j_tiny  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.common import merge_params, split_params  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.optimizer import adamw_update as j_adamw_update  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.device_main import HostHook, device_run  # noqa: E402
from repro_torch.core.rpc import ShapeDtype  # noqa: E402
from repro_torch.core.libc import rand_init, rand_u32, rand_uniform  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.train import run, tiny_preset  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here: with several test
    workers on the machine, waking eight threads per op costs more than
    the op (20 tiny training steps: ~30x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(tree):
    vals, _ = split_params(tree)
    return jax.tree.map(np.asarray, vals)


def _close(t, j, tol=TOL, atol=None):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol if atol is None else atol, rtol=tol)


def _per_layer(jtree, tlist, check):
    """Hold each layer's leaves of the port (a list of dicts) against the
    JAX tree (layers stacked on axis 0)."""
    for i, layer in enumerate(tlist):
        jl = jax.tree.map(lambda a, i=i: np.asarray(a)[i], jtree)
        for t, j in zip(leaves(layer), jax.tree.leaves(jl)):
            check(t, j)


def _check_tree(ttree, jtree, check):
    for k in jtree:
        if k == "layers":
            _per_layer(jtree[k], ttree[k], check)
        else:
            check(ttree[k], jtree[k])


@pytest.fixture(scope="module")
def pair():
    jcfg = j_tiny(j_get_config("llama3.2-3b"))
    tcfg = tiny_preset(get_config("llama3.2-3b"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    values, axes = split_params(jparams)
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(_values(jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 24),
                                               dtype=np.int32)
    return jmodel, values, axes, tmodel, tparams, tokens


def test_lm_forward_and_loss_match_jax(pair):
    jmodel, values, axes, tmodel, tparams, tokens = pair
    jlogits, _ = jmodel.forward_v(values, axes, {"tokens": jnp.asarray(tokens)})
    tlogits, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert tlogits.dtype == torch.float32 and float(aux) == 0.0
    _close(tlogits, jlogits)
    jloss, jm = jmodel.loss_v(values, axes, {"tokens": jnp.asarray(tokens)})
    tloss, tm = tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tloss, jloss)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 23


def test_lm_loss_with_labels_matches_jax(pair):
    jmodel, values, axes, tmodel, tparams, tokens = pair
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -3:] = -1                       # masked positions
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    jloss, jm = jmodel.loss_v(values, axes, jb)
    tloss, tm = tmodel.loss(tparams, tb)
    _close(tloss, jloss)
    assert float(tm["tokens"]) == float(jm["tokens"])


def test_gradient_of_every_leaf_matches_jax_grad(pair):
    jmodel, values, axes, tmodel, tparams, tokens = pair
    jgrads = jax.grad(lambda v: jmodel.loss_v(
        v, axes, {"tokens": jnp.asarray(tokens)})[0])(values)
    vals = tree_map(lambda t: t.detach().requires_grad_(), tparams)
    loss, _ = tmodel.loss(vals, {"tokens": torch.from_numpy(tokens)})
    tgrads = dict(zip(map(id, leaves(vals)),
                      torch.autograd.grad(loss, leaves(vals))))
    gtree = tree_map(lambda t: tgrads[id(t)], vals)
    n = []
    _check_tree(gtree, jax.tree.map(np.asarray, jgrads),
                lambda t, j: n.append(1) or _close(t, j, GRAD_TOL))
    assert len(n) == len(leaves(tparams))


def test_lm_prefill_matches_jax(pair):
    jmodel, values, axes, tmodel, tparams, tokens = pair
    jl, jc = jmodel.prefill(merge_params(values, axes),
                            {"tokens": jnp.asarray(tokens)}, 32)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, 32)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["k"].shape == tuple(jc["k"].shape)
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
    assert tc["lengths"].dtype == torch.int32


def test_prefill_then_decode_matches_forward(pair):
    """The prefill's cache continues through decode_step exactly where the
    full-sequence forward would have gone."""
    _, _, _, tmodel, tparams, tokens = pair
    t = torch.from_numpy(tokens)
    full, _ = tmodel.forward(tparams, {"tokens": t})
    logits, cache = tmodel.prefill(tparams, {"tokens": t[:, :20]}, 32)
    _close(logits, full[:, 19].detach())
    for j in range(20, 24):
        logits, cache = tmodel.decode_step(tparams, cache, t[:, j])
        _close(logits, full[:, j].detach())


@pytest.mark.parametrize("seed", [0, 1234, (1 << 40) + 77])
def test_rand_bit_for_bit(seed):
    js, ts = j_rand_init(seed), rand_init(seed, device="cpu")
    assert np.asarray(js).astype(np.int64).tolist() == ts.tolist()
    for _ in range(4):
        js, jv = j_rand_u32(js)
        ts, tv = rand_u32(ts)
        assert int(jv) == int(tv)
    for shape in [(), (7,), (3, 17)]:
        js, ju = j_rand_uniform(js, shape)
        ts, tu = rand_uniform(ts, shape)
        assert tu.dtype == torch.float32 and tuple(tu.shape) == shape
        assert np.array_equal(np.asarray(ju).view(np.uint32),
                              tu.numpy().view(np.uint32))
    assert np.asarray(js).astype(np.int64).tolist() == ts.tolist()


def test_synthetic_batches_bit_for_bit():
    jd, td = JSynthetic(512, 32, 4), SyntheticLM(512, 32, 4)
    js, ts = j_rand_init(1234), rand_init(1234, device="cpu")
    for step in range(5):
        js2, jb = jd.batch_at(js, jnp.int32(step))
        ts2, tb = td.batch_at(ts, step)
        assert tb["tokens"].dtype == torch.int32
        assert np.array_equal(np.asarray(jb["tokens"]), tb["tokens"].numpy())
        assert np.asarray(js2).astype(np.int64).tolist() == ts2.tolist()


def test_adamw_update_per_leaf_matches_jax(pair):
    _, values, _, _, tparams, _ = pair
    rng = np.random.default_rng(3)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    jopt = j_adamw_init(values)
    topt = adamw_init(tparams)
    jv, tv = values, tree_map(lambda t: t.clone(), tparams)
    for scale in (10.0, 1e-3):        # clipped, then below the clip norm
        g = jax.tree.map(lambda v: (rng.standard_normal(v.shape) * scale
                                    ).astype(np.float32), values)
        jv, jopt, jm = j_adamw_update(g, jopt, JOptConfig(**cfg), jv)
        tg = params_from_jax(g, device="cpu")
        tv, topt, tm = adamw_update(tg, topt, OptConfig(**cfg), tv)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
        for t_tree, j_tree in [(tv, jv), (topt.master, jopt.master),
                               (topt.mu, jopt.mu), (topt.nu, jopt.nu)]:
            _check_tree(t_tree, jax.tree.map(np.asarray, j_tree),
                        lambda t, j: _close(t, j, 1e-6, atol=1e-8))
    assert topt.step == int(jopt.step) == 2


def test_make_train_step_microbatches_matches_jax(pair):
    jmodel, values, axes, tmodel, tparams, _ = pair
    tokens = np.random.default_rng(4).integers(0, 512, (4, 16),
                                               dtype=np.int32)
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = j_make_train_step(jmodel, axes, JOptConfig(**cfg),
                              microbatches=2)
    jv, jopt, jm = jstep(values, j_adamw_init(values),
                         {"tokens": jnp.asarray(tokens)})
    tstep = make_train_step(tmodel, OptConfig(**cfg), microbatches=2)
    tv = tree_map(lambda t: t.clone(), tparams)
    tv, topt, tm = tstep(tv, adamw_init(tv), {"tokens": torch.from_numpy(tokens)})
    _close(tm["loss"], jm["loss"], 1e-5)
    _close(tm["grad_norm"], jm["grad_norm"], 1e-4)
    _close(tm["tokens"], jm["tokens"])
    _check_tree(tv, jax.tree.map(np.asarray, jv),
                lambda t, j: _close(t, j, 0.0, atol=2e-4))
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        make_train_step(tmodel, OptConfig(), microbatches=2,
                        gather_once=True)


def test_device_run_hooks_fire_as_in_jax():
    """Firing steps and payloads of immediate hooks: every=3 and every=4
    over 10 steps."""
    def j_step(i, s):
        return {"x": s["x"] + i, "n": s["n"] + 1}

    def t_step(i, s):
        return {"x": s["x"] + i, "n": s["n"] + 1}

    seen = {"jax": [], "port": []}

    def hooks(tag, mk):
        return [mk(every=3, extract=lambda step, s: {"x": s["x"], "n": s["n"]},
                   host_fn=lambda step, n, x: seen[tag].append(
                       ("a", int(step), int(n), float(x)))),
                mk(every=4, extract=lambda step, s: s["x"] * 2,
                   host_fn=lambda step, x: seen[tag].append(
                       ("b", int(step), float(x))))]

    j_out = j_device_run(j_step, {"x": jnp.zeros((), jnp.float32),
                                  "n": jnp.zeros((), jnp.int32)}, 10,
                         hooks=hooks("jax", JHook))
    jax.effects_barrier()
    t_out = device_run(t_step, {"x": torch.zeros(()), "n": torch.zeros(
        (), dtype=torch.int32)}, 10, hooks=hooks("port", HostHook))
    assert seen["port"] == seen["jax"]
    assert [e[1] for e in seen["port"]] == [3, 4, 6, 8, 9]
    assert float(t_out["x"]) == float(j_out["x"]) == 45.0


def test_device_run_refuses_transport_options():
    seen = []
    hook = HostHook(every=1, extract=lambda s, st: st,
                    host_fn=lambda i, v: seen.append(i), batched=True)
    device_run(lambda i, s: s, torch.zeros(()), 2, hooks=[hook],
               queue_async=True)
    assert seen == [1, 2]
    ret = HostHook(every=1, extract=lambda s, st: st, host_fn=print,
                   batched=True, returns=ShapeDtype((), torch.float32),
                   consume=lambda i, s, v, ok: s)
    with pytest.raises(ValueError, match="queue_async=True"):
        device_run(lambda i, s: s, torch.zeros(()), 2, hooks=[ret],
                   queue_async=True)
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        device_run(lambda i, s: s, torch.zeros(()), 2, mesh=object())


def test_twenty_step_loss_trajectory_matches_jax(pair, monkeypatch):
    """Both runs start from the JAX run's weights (``PRNGKey(0)``): the
    port's ``Model.init`` hands out the converted copy."""
    _, values, _, _, _, _ = pair
    kw = dict(preset="tiny", steps=20, batch=4, seq_len=32, log_every=1)
    jout = j_run("llama3.2-3b", **kw)
    jax.effects_barrier()
    converted = params_from_jax(jax.tree.map(np.asarray, values),
                                device="cpu")
    monkeypatch.setattr(Model, "init", lambda self, seed=0: converted)
    tout = run("llama3.2-3b", device="cpu", **kw)
    jl = np.array([l for _, l in jout["losses"]])
    tl = np.array([l for _, l in tout["losses"]])
    assert [s for s, _ in tout["losses"]] == list(range(1, 21))
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    assert tl[-1] < tl[0] - 1.0
    assert tout["final_loss"] == tl[-1]


def test_train_cli_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    main(["--arch", "llama3.2-3b", "--preset", "tiny", "--device", "cpu",
          "--steps", "2", "--batch", "2", "--seq-len", "16",
          "--log-every", "1"])
    out = capsys.readouterr().out
    assert "[train] step 2 loss" in out and "final_loss" in out
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        run("llama3.2-3b", device="cpu", steps=1, ckpt_dir="x",
            ckpt_every=1)
