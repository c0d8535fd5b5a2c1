"""The dense configurations other than llama against the JAX package, on
the CPU at fp32 with the JAX weights carried across (``convert.py``).

Cases, each at its ``reduced()`` widths (2 layers, d_model 64, head_dim 16,
vocab 256): qwen2.5-14b and codeqwen1.5-7b (QKV bias), minitron-8b (no
bias), qwen2.5-14b with a tied head, and qwen2.5-14b's own head grouping
with its default ``head_pad_multiple=16`` (40 query heads padded to 48
over 8 KV heads, G = 6, with the pad heads' biases nonzero too).  Every
bias gets random nonzero values (JAX initialises them to zero, which
would hide a bias dropped on one side).  Checks: the forward logits, the
loss, ``prefill`` (logits and cache) followed by three ``decode_step``s
(logits and cache), and every parameter leaf's gradient of the loss, all
within 2e-5 (``tests/test_kernels.py``'s fp32 tolerance)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.common import merge_params, split_params  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = 2e-5


def _pad48(cfg):
    """qwen2.5-14b's grouping at reduced widths: 40 heads over 8 KV heads,
    padded to a multiple of 16."""
    return dataclasses.replace(cfg, name=cfg.name + "-pad48", num_heads=40,
                               num_kv_heads=8, head_pad_multiple=16)


CASES = {
    "qwen2.5-14b": CONFIGS["qwen2.5-14b"].reduced(),
    "codeqwen1.5-7b": CONFIGS["codeqwen1.5-7b"].reduced(),
    "minitron-8b": CONFIGS["minitron-8b"].reduced(),
    "qwen2.5-14b-tied": dataclasses.replace(
        CONFIGS["qwen2.5-14b"].reduced(), tie_embeddings=True),
    "qwen2.5-14b-pad48": _pad48(CONFIGS["qwen2.5-14b"].reduced()),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors (as test_torch_train)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=TOL, rtol=TOL)


def _with_random_biases(values, seed):
    """Every bias leaf (``bq``/``bk``/``bv``) set to random nonzero values."""
    rng = np.random.default_rng(seed)
    n = [0]

    def fill(path, a):
        a = np.asarray(a)
        if path[-1].key in ("bq", "bk", "bv"):
            n[0] += 1
            return (rng.standard_normal(a.shape) * 0.5 + 0.25).astype(
                a.dtype)
        return a

    out = jax.tree_util.tree_map_with_path(fill, values)
    return out, n[0]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jcfg = CASES[request.param]
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jmodel = j_build(jcfg)
    values, axes = split_params(jmodel.init(jax.random.PRNGKey(0)))
    values, n_bias = _with_random_biases(values, 11)
    assert n_bias == (3 if jcfg.qkv_bias else 0)      # stacked layers
    assert ("lm_head" in values) != jcfg.tie_embeddings
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(values, device="cpu")
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    jvalues = jax.tree.map(jnp.asarray, values)
    return jcfg, jmodel, jvalues, axes, tmodel, tparams, tokens


def test_padding_and_grouping(case):
    jcfg, *_ = case
    if jcfg.name.endswith("-pad48"):
        assert (jcfg.num_heads, jcfg.padded_heads, jcfg.num_kv_heads) == \
            (40, 48, 8)
    else:
        assert jcfg.padded_heads == jcfg.num_heads


def test_forward_and_loss_match_jax(case):
    _, jmodel, values, axes, tmodel, tparams, tokens = case
    jl, _ = jmodel.forward_v(values, axes, {"tokens": jnp.asarray(tokens)})
    tl, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)
    jloss, _ = jmodel.loss_v(values, axes, {"tokens": jnp.asarray(tokens)})
    tloss, _ = tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tloss, jloss)


def test_prefill_then_decode_match_jax(case):
    _, jmodel, values, axes, tmodel, tparams, tokens = case
    params = merge_params(values, axes)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(tokens[:, :9])},
                            16)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(
        tokens[:, :9])}, 16)
    _close(tl, jl)
    jstep = jax.jit(jmodel.decode_step)
    for j in range(9, 12):
        jl, jc = jstep(params, jc, jnp.asarray(tokens[:, j]))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(
            tokens[:, j].copy()))
        _close(tl, jl)
    for key in ("k", "v", "lengths"):
        _close(tc[key], jc[key])


def test_gradient_of_every_leaf_matches_jax(case):
    _, jmodel, values, axes, tmodel, tparams, tokens = case
    jgrads = jax.grad(lambda v: jmodel.loss_v(
        v, axes, {"tokens": jnp.asarray(tokens)})[0])(values)
    vals = tree_map(lambda t: t.detach().requires_grad_(), tparams)
    loss, _ = tmodel.loss(vals, {"tokens": torch.from_numpy(tokens)})
    grads = dict(zip(map(id, leaves(vals)),
                     torch.autograd.grad(loss, leaves(vals))))
    checked = 0
    for key, jg in jax.tree.map(np.asarray, jgrads).items():
        if key != "layers":
            _close(grads[id(vals[key])], jg)
            checked += 1
            continue
        for i, layer in enumerate(vals["layers"]):
            jl = jax.tree.map(lambda a, i=i: a[i], jg)
            for t, j in zip(leaves(layer), jax.tree.leaves(jl)):
                assert tuple(t.shape) == j.shape
                _close(grads[id(t)], j)
                checked += 1
    assert checked == len(leaves(tparams))
