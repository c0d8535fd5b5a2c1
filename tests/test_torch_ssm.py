"""The port's ssm family (mamba2) against the JAX package on the CPU, at the
``tiny_preset`` size (4 layers, d_model 128, d_inner 256, 16 SSD heads of
P = 16, state N = 16, chunk 8, conv width 4, vocab 512 with tied
embeddings, fp32, remat "full") with the JAX weights converted by
``params_from_jax``.

Tolerances (fp32), as in tests/test_torch_train.py:
- block outputs and states, forward logits, loss, prefill logits and cache
  2e-5 (tests/test_kernels.py for fp32): the same arithmetic, sums in
  another order;
- gradients 1e-4: the backward recomputes the scan through its plain
  version and adds the head's and the scatter's parts of the tied
  embedding's gradient, whose rounding differences add up to a few times
  the forward's;
- the 20-step loss trajectory 2e-5 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.train import run as j_run  # noqa: E402
from repro.launch.train import tiny_preset as j_tiny  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import ssd as j_ssd  # noqa: E402
from repro.models.common import merge_params, split_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.train import run, tiny_preset  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.models import ssd as t_ssd  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-4
ARCH = "mamba2-130m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here (see
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(tree):
    vals, _ = split_params(tree)
    return jax.tree.map(np.asarray, vals)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _check_tree(ttree, jtree, check):
    """Hold the port's tree (``layers`` a list of dicts) against the JAX
    tree (layers stacked on axis 0), leaf by leaf."""
    for k in jtree:
        if k != "layers":
            check(ttree[k], jtree[k])
            continue
        for i, layer in enumerate(ttree[k]):
            jl = jax.tree.map(lambda a, i=i: np.asarray(a)[i], jtree[k])
            for t, j in zip(leaves(layer), jax.tree.leaves(jl)):
                check(t, j)


@pytest.fixture(scope="module")
def pair():
    jcfg = j_tiny(j_get_config(ARCH))
    tcfg = tiny_preset(get_config(ARCH))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.family == "ssm" and tcfg.tie_embeddings
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    values, axes = split_params(jparams)
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(_values(jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 21),
                                               dtype=np.int32)
    return jcfg, jmodel, values, axes, tcfg, tmodel, tparams, tokens


def test_init_and_conversion_keep_shapes_and_fp32_leaves(pair):
    """The port's init has JAX's leaves; the converted bf16 tree keeps the
    fp32 leaves (a_log, dt_bias, d_skip) in fp32."""
    jcfg, _, values, _, tcfg, tmodel, _, _ = pair
    tparams = tmodel.init(0)
    assert "lm_head" not in tparams and len(tparams["layers"]) == 4
    shapes = []
    _check_tree(tparams, jax.tree.map(np.asarray, values),
                lambda t, j: shapes.append((tuple(t.shape), j.shape)))
    assert all(t == j for t, j in shapes) and len(shapes) == len(
        leaves(tparams))
    bf = dataclasses.replace(jcfg, dtype="bfloat16", param_dtype="bfloat16")
    conv = params_from_jax(_values(j_build(bf).init(jax.random.PRNGKey(1))),
                           device="cpu")
    for name, leaf in conv["layers"][0]["ssd"].items():
        want = torch.float32 if name in ("a_log", "dt_bias", "d_skip") \
            else torch.bfloat16
        assert leaf.dtype == want, name
    assert conv["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("S", [13, 2], ids=["prompt", "shorter_than_conv"])
def test_ssd_block_and_decode_match_jax(pair, S):
    """ssd_apply with its state (a prompt shorter than conv_width - 1 pads
    the conv tail with zeros), then three ssd_decode steps from it."""
    jcfg, _, _, _, tcfg, _, _, _ = pair
    p = j_ssd.ssd_init(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in _values(p).items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    j_apply = jax.jit(j_ssd.ssd_apply, static_argnames=("cfg", "return_state"))
    j_decode = jax.jit(j_ssd.ssd_decode, static_argnames=("cfg",))
    jo, jst = j_apply(p, jnp.asarray(x), cfg=jcfg, return_state=True)
    to, tst = t_ssd.ssd_apply(tp, torch.from_numpy(x), tcfg,
                              return_state=True)
    _close(to, jo)
    for key in ("conv", "ssm"):
        assert tuple(tst[key].shape) == jst[key].shape
        _close(tst[key], jst[key])
    for _ in range(3):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jo, jst = j_decode(p, jnp.asarray(xt), jst, cfg=jcfg)
        to, tst = t_ssd.ssd_decode(tp, torch.from_numpy(xt), tst, tcfg)
        _close(to, jo)
        _close(tst["conv"], jst["conv"])
        _close(tst["ssm"], jst["ssm"])


def test_lm_forward_and_loss_match_jax(pair):
    _, jmodel, values, axes, _, tmodel, tparams, tokens = pair
    jb, tb = {"tokens": jnp.asarray(tokens)}, \
        {"tokens": torch.from_numpy(tokens)}
    jlogits, _ = jax.jit(lambda v, b: jmodel.forward_v(v, axes, b))(values,
                                                                     jb)
    tlogits, aux = tmodel.forward(tparams, tb)
    assert tlogits.dtype == torch.float32 and float(aux) == 0.0
    _close(tlogits, jlogits)
    jloss, jm = jax.jit(lambda v, b: jmodel.loss_v(v, axes, b))(values, jb)
    tloss, tm = tmodel.loss(tparams, tb)
    _close(tloss, jloss)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 20


def test_gradient_of_every_leaf_matches_jax_grad(pair):
    """Every leaf, the tied embedding included: its gradient sums the
    fp32 scatter of the lookup and the LM head's product."""
    _, jmodel, values, axes, _, tmodel, tparams, tokens = pair
    jgrads = jax.jit(jax.grad(lambda v: jmodel.loss_v(
        v, axes, {"tokens": jnp.asarray(tokens)})[0]))(values)
    vals = tree_map(lambda t: t.detach().requires_grad_(), tparams)
    loss, _ = tmodel.loss(vals, {"tokens": torch.from_numpy(tokens)})
    tgrads = dict(zip(map(id, leaves(vals)),
                      torch.autograd.grad(loss, leaves(vals))))
    gtree = tree_map(lambda t: tgrads[id(t)], vals)
    n = []
    _check_tree(gtree, jax.tree.map(np.asarray, jgrads),
                lambda t, j: n.append(1) or _close(t, j, GRAD_TOL))
    assert len(n) == len(leaves(tparams))
    # the tied embedding's gradient has both parts
    assert float(gtree["embed"].abs().sum()) > 0
    _close(gtree["embed"], jgrads["embed"], GRAD_TOL)


def test_lm_prefill_matches_jax(pair):
    _, jmodel, values, axes, _, tmodel, tparams, tokens = pair
    jl, jc = jmodel.prefill(merge_params(values, axes),
                            {"tokens": jnp.asarray(tokens)}, 32)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, 32)
    _close(tl, jl)
    for key in ("conv", "ssm"):
        assert tuple(tc["layers"][key].shape) == jc["layers"][key].shape
        _close(tc["layers"][key], jc["layers"][key])
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
    assert tc["lengths"].dtype == torch.int32


def test_decode_steps_match_jax(pair):
    """Decode from the prefill's cache: logits and cache step by step."""
    _, jmodel, values, axes, _, tmodel, tparams, tokens = pair
    jparams = merge_params(values, axes)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :9])},
                            32)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(
        tokens[:, :9])}, 32)
    jstep = jax.jit(jmodel.decode_step)
    for j in range(9, 14):
        jl, jc = jstep(jparams, jc, jnp.asarray(tokens[:, j]))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(
            tokens[:, j]))
        _close(tl, jl)
    for key in ("conv", "ssm"):
        _close(tc["layers"][key], jc["layers"][key])
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()


def test_prefill_then_decode_matches_forward(pair):
    """The prefill's recurrent state continues through decode_step exactly
    where the full-sequence forward would have gone."""
    *_, tmodel, tparams, tokens = pair
    t = torch.from_numpy(tokens)
    full, _ = tmodel.forward(tparams, {"tokens": t})
    logits, cache = tmodel.prefill(tparams, {"tokens": t[:, :13]}, 32)
    _close(logits, full[:, 12].detach().numpy())
    for j in range(13, 21):
        logits, cache = tmodel.decode_step(tparams, cache, t[:, j])
        _close(logits, full[:, j].detach().numpy())


def test_twenty_step_loss_trajectory_matches_jax(pair, monkeypatch):
    """Both runs start from the JAX run's weights (``PRNGKey(0)``): the
    port's ``Model.init`` hands out the converted copy."""
    _, _, values, _, _, _, _, _ = pair
    kw = dict(preset="tiny", steps=20, batch=4, seq_len=32, log_every=1)
    jout = j_run(ARCH, **kw)
    jax.effects_barrier()
    converted = params_from_jax(jax.tree.map(np.asarray, values),
                                device="cpu")
    monkeypatch.setattr(Model, "init", lambda self, seed=0: converted)
    tout = run(ARCH, device="cpu", **kw)
    jl = np.array([l for _, l in jout["losses"]])
    tl = np.array([l for _, l in tout["losses"]])
    assert [s for s, _ in tout["losses"]] == list(range(1, 21))
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    assert tl[-1] < tl[0] - 0.2
    assert tout["final_loss"] == tl[-1]


def test_train_cli_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    main(["--arch", ARCH, "--preset", "tiny", "--device", "cpu",
          "--steps", "2", "--batch", "2", "--seq-len", "16",
          "--log-every", "1"])
    out = capsys.readouterr().out
    assert "[train] step 2 loss" in out and "final_loss" in out


def test_families_still_to_port_are_refused():
    for arch in ("seamless-m4t-large-v2", "qwen3-moe-235b-a22b"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            build_model(get_config(arch).reduced(), device="cpu")
