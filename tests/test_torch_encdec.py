"""The port's encdec family (seamless-m4t-large-v2) against the JAX package.

At ``seamless-m4t-large-v2.reduced()`` in fp32 (1 encoder and 1 decoder
layer, d_model 64, 4 heads over 2 KV heads of 16; also at 2 + 2 layers)
with the JAX weights carried across (``convert.py``'s ``enc_layers`` and
``dec_layers``) and random nonzero QKV biases: ``cross_kv``,
``cross_attn_apply`` with Sq != Sk and ``cross_attn_decode`` over ragged
``enc_lens``; ``encode``, ``encdec_forward``, ``Model.loss`` and the
gradient of every leaf; ``encdec_init_cache`` + ``encdec_prefill_cross``
+ decode steps field by field; ``Model.prefill`` with and without
tokens; JAX's forward-vs-decode consistency test run through the port.
Floats within 2e-5 (fp32), greedy streams and integer cache fields
exact.  Inputs come from seeded numpy generators."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models.common import (  # noqa: E402
    Param, merge_params, split_params)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = 2e-5
ARCH = "seamless-m4t-large-v2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors (several test workers
    share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               atol=tol, rtol=tol)


def _cfgs(layers=1):
    jcfg = dataclasses.replace(CONFIGS[ARCH].reduced(),
                               encoder_layers=layers, decoder_layers=layers)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               encoder_layers=layers, decoder_layers=layers)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _random_biases(values, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(np.shape(a)) * 0.3).astype(
            np.float32) if path[-1].key in ("bq", "bk", "bv")
        else np.asarray(a), values)


def _pair(layers):
    jcfg, tcfg = _cfgs(layers)
    jmodel = j_build(jcfg)
    values, axes = split_params(jmodel.init(jax.random.PRNGKey(0)))
    values = _random_biases(values, 1)
    jparams = merge_params(jax.tree.map(jnp.asarray, values), axes)
    tmodel = build_model(tcfg, device="cpu")
    return jmodel, jparams, values, axes, tmodel, params_from_jax(
        values, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair(1)


@pytest.fixture(scope="module")
def pair2():
    return _pair(2)


def _inputs(cfg, seed, B=2, S_enc=11, S_dec=7):
    rng = np.random.default_rng(seed)
    embeds = (rng.standard_normal((B, S_enc, cfg.d_model)) * 0.5).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_dec)).astype(np.int32)
    return embeds, tokens


# ---------------------------------------------------------------------------
# Cross attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross():
    jcfg, tcfg = _cfgs()
    p = j_attn.attn_init(jax.random.PRNGKey(3), jcfg)
    jvals = _random_biases({k: v.value for k, v in p.items()}, 4)
    jp = {k: Param(jnp.asarray(v), p[k].axes) for k, v in jvals.items()}
    tp = params_from_jax(jvals, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("Sq,Sk", [(5, 13), (13, 5), (1, 9)])
def test_cross_kv_and_cross_attn_apply_match_jax(cross, Sq, Sk):
    jcfg, tcfg, jp, tp = cross
    rng = np.random.default_rng(Sq * 100 + Sk)
    enc = (rng.standard_normal((2, Sk, 64)) * 0.5).astype(np.float32)
    xq = (rng.standard_normal((2, Sq, 64)) * 0.5).astype(np.float32)
    jk, jv = j_attn.cross_kv(jp, jnp.asarray(enc), jcfg)
    tk, tv = t_attn.cross_kv(tp, torch.from_numpy(enc), tcfg)
    assert tuple(tk.shape) == (2, Sk, 2, 16)
    _close(tk, jk)
    _close(tv, jv)
    j = j_attn.cross_attn_apply(jp, jnp.asarray(xq), (jk, jv), jcfg)
    t = t_attn.cross_attn_apply(tp, torch.from_numpy(xq), (tk, tv), tcfg)
    assert tuple(t.shape) == (2, Sq, 64)
    _close(t, j)


def test_cross_attn_decode_over_ragged_enc_lens_matches_jax(cross):
    jcfg, tcfg, jp, tp = cross
    rng = np.random.default_rng(5)
    enc = (rng.standard_normal((4, 16, 64)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((4, 1, 64)) * 0.5).astype(np.float32)
    lens = np.asarray([16, 11, 5, 1], np.int32)
    jkv = j_attn.cross_kv(jp, jnp.asarray(enc), jcfg)
    tkv = t_attn.cross_kv(tp, torch.from_numpy(enc), tcfg)
    j = j_attn.cross_attn_decode(jp, jnp.asarray(x), jkv, jnp.asarray(lens),
                                 jcfg)
    t = t_attn.cross_attn_decode(tp, torch.from_numpy(x), tkv,
                                 torch.from_numpy(lens), tcfg)
    assert tuple(t.shape) == (4, 1, 64)
    _close(t, j)
    # a row sees only its first enc_lens frames: changing the rest of row
    # 2's frames changes nothing
    k, v = (a.clone() for a in tkv)
    k[2, 5:] += 3.0
    v[2, 5:] -= 3.0
    assert torch.equal(t_attn.cross_attn_decode(
        tp, torch.from_numpy(x), (k, v), torch.from_numpy(lens), tcfg)[2],
        t[2])
    # the port's decode rule: a row with enc_lens 0 gets 0 from attention,
    # so its output is wo's of a zero vector
    zero = t_attn.cross_attn_decode(
        tp, torch.from_numpy(x), tkv,
        torch.tensor([16, 0, 5, 1], dtype=torch.int32), tcfg)
    assert torch.equal(zero[1], torch.zeros_like(zero[1]))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_convert_carries_the_encdec_layout(pair2):
    _, _, values, _, tmodel, tparams = pair2
    assert set(tparams) == {"embed", "lm_head", "enc_layers", "dec_layers",
                            "ln_enc", "ln_f"}
    assert len(tparams["enc_layers"]) == len(tparams["dec_layers"]) == 2
    assert set(tparams["dec_layers"][0]) == {"ln1", "self_attn", "ln_x",
                                             "cross_attn", "ln2", "mlp"}
    assert set(tparams["enc_layers"][0]) == {"ln1", "attn", "ln2", "mlp"}
    for key in ("enc_layers", "dec_layers"):
        for li, layer in enumerate(tparams[key]):
            jl = jax.tree.leaves(jax.tree.map(lambda a, i=li: a[i],
                                              values[key]))
            assert len(jl) == len(leaves(layer))
            for t, j in zip(leaves(layer), jl):
                assert np.array_equal(t.numpy(), np.asarray(j))
    own = tmodel.init(0)
    assert [(tuple(a.shape), a.dtype) for a in leaves(own)] == \
        [(tuple(a.shape), a.dtype) for a in leaves(tparams)]


@pytest.mark.parametrize("layers", [1, 2])
def test_encode_and_forward_match_jax(pair, pair2, layers):
    jmodel, jparams, values, axes, tmodel, tparams = \
        pair if layers == 1 else pair2
    cfg = tmodel.cfg
    embeds, tokens = _inputs(cfg, 6)
    je = j_encdec.encode(jparams, jnp.asarray(embeds), jmodel.cfg)
    te = t_encdec.encode(tparams, torch.from_numpy(embeds), cfg)
    _close(te, je)
    batch = {"embeds": embeds, "tokens": tokens}
    jl, jaux = jmodel.forward_v(values, axes,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    tl, taux = tmodel.forward(tparams, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert tuple(tl.shape) == (2, 7, cfg.padded_vocab)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


def test_loss_and_gradients_match_jax(pair2):
    jmodel, _, values, axes, tmodel, tparams = pair2
    embeds, tokens = _inputs(tmodel.cfg, 7)
    jb = {"embeds": jnp.asarray(embeds), "tokens": jnp.asarray(tokens)}
    tb = {"embeds": torch.from_numpy(embeds),
          "tokens": torch.from_numpy(tokens)}
    jloss, jm = jmodel.loss_v(values, axes, jb)
    tloss, tm = tmodel.loss(tparams, tb)
    _close(tloss, jloss)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 6
    jgrads = jax.tree.map(np.asarray, jax.grad(
        lambda v: jmodel.loss_v(v, axes, jb)[0])(values))
    vals = tree_map(lambda t: t.detach().requires_grad_(), tparams)
    loss, _ = tmodel.loss(vals, tb)
    grads = torch.autograd.grad(loss, leaves(vals))
    want = []
    for key in sorted(jgrads):                 # leaves() sorts dict keys
        if key in ("enc_layers", "dec_layers"):
            for li in range(len(vals[key])):
                want += jax.tree.leaves(jax.tree.map(lambda a, i=li: a[i],
                                                     jgrads[key]))
        else:
            want.append(jgrads[key])
    assert len(want) == len(grads) == len(leaves(tparams))
    for t, j in zip(grads, want):
        _close(t, j)
    # the encoder is trained through the cross attention
    enc = vals["enc_layers"][0]["attn"]["wq"]
    assert float(grads[[id(x) for x in leaves(vals)].index(id(enc))]
                 .abs().max()) > 0.0


def _cache_close(tc, jc):
    assert set(tc) == set(jc)
    for key in ("k", "v", "xk", "xv"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    for key in ("enc_lens", "lengths"):
        assert tc[key].dtype == torch.int32
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))


def test_cache_prefill_cross_and_decode_match_jax(pair2):
    jmodel, jparams, _, _, tmodel, tparams = pair2
    jcfg, cfg = jmodel.cfg, tmodel.cfg
    embeds, tokens = _inputs(cfg, 8, S_enc=13)
    lens = np.asarray([13, 6], np.int32)
    jc, _ = j_encdec.encdec_init_cache(jcfg, 2, 12)
    tc = t_encdec.encdec_init_cache(cfg, 2, 12, torch.device("cpu"))
    _cache_close(tc, jc)
    assert tuple(tc["xk"].shape) == (2, 2, 12, 2, 16)     # enc_len: max_len
    jc, _ = j_encdec.encdec_init_cache(jcfg, 2, 12, enc_len=13)
    tc = t_encdec.encdec_init_cache(cfg, 2, 12, torch.device("cpu"),
                                    enc_len=13)
    jc = j_encdec.encdec_prefill_cross(jparams, jc, jnp.asarray(embeds),
                                       jnp.asarray(lens), jcfg)
    tc = t_encdec.encdec_prefill_cross(tparams, tc, torch.from_numpy(embeds),
                                       torch.from_numpy(lens), cfg)
    _cache_close(tc, jc)
    for j in range(tokens.shape[1]):
        jl, jc = j_encdec.encdec_decode_step(jparams, jc,
                                             jnp.asarray(tokens[:, j]), jcfg)
        tl, tc = t_encdec.encdec_decode_step(tparams, tc,
                                             torch.from_numpy(tokens[:, j]),
                                             cfg)
        _close(tl, jl)
        _cache_close(tc, jc)
    assert tc["lengths"].tolist() == [7, 7]


@pytest.mark.parametrize("with_tokens", [False, True])
def test_model_prefill_matches_jax(pair, with_tokens):
    jmodel, jparams, _, _, tmodel, tparams = pair
    embeds, tokens = _inputs(tmodel.cfg, 9, S_enc=10)
    jb = {"embeds": jnp.asarray(embeds)}
    tb = {"embeds": torch.from_numpy(embeds)}
    if with_tokens:
        jb["tokens"] = jnp.asarray(tokens[:, :1])
        tb["tokens"] = torch.from_numpy(tokens[:, :1])
    else:           # enc_lens from the batch; full when it has none
        jb["enc_lens"] = jnp.asarray([10, 4], jnp.int32)
        tb["enc_lens"] = torch.tensor([10, 4], dtype=torch.int32)
    jl, jc = jmodel.prefill(jparams, jb, 16)
    tl, tc = tmodel.prefill(tparams, tb, 16)
    _cache_close(tc, jc)
    assert tuple(tc["xk"].shape) == (1, 2, 10, 2, 16)     # enc_len: S_enc
    if with_tokens:
        _close(tl, jl)
        assert tc["lengths"].tolist() == [1, 1]
        assert tc["enc_lens"].tolist() == [10, 10]
    else:
        assert tl is None and jl is None
        assert tc["lengths"].tolist() == [0, 0]
    # then greedy decode: the same stream as JAX's
    jt = jnp.asarray(tokens[:, 0]) if jl is None else jnp.argmax(jl, -1)
    tt = torch.from_numpy(tokens[:, 0]) if tl is None else tl.argmax(-1)
    js, ts = [], []
    for _ in range(5):
        jl, jc = jmodel.decode_step(jparams, jc, jt)
        tl, tc = tmodel.decode_step(tparams, tc, tt)
        _close(tl, jl)
        jt, tt = jnp.argmax(jl, -1), tl.argmax(-1)
        js.append(np.asarray(jt).tolist())
        ts.append(tt.tolist())
    assert ts == js


def test_decode_reproduces_the_teacher_forced_forward(pair2):
    """tests/test_models.py's decode-consistency test for the encdec
    family, run through the port: token-by-token decode after
    ``encdec_prefill_cross`` with enc_lens full reproduces the forward's
    logits (within JAX's 5e-3; fp32 here gives far less)."""
    _, _, _, _, tmodel, tparams = pair2
    cfg = tmodel.cfg
    rng = np.random.default_rng(1)
    S = 10
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
    embeds = torch.from_numpy((rng.standard_normal((2, 8, cfg.d_model))
                               * 0.3).astype(np.float32))
    full, _ = tmodel.forward(tparams, {"tokens": tokens, "embeds": embeds})
    cache = t_encdec.encdec_init_cache(cfg, 2, S + 2, torch.device("cpu"),
                                       enc_len=8)
    cache = t_encdec.encdec_prefill_cross(
        tparams, cache, embeds, torch.full((2,), 8, dtype=torch.int32), cfg)
    errs = []
    for t in range(S):
        lg, cache = tmodel.decode_step(tparams, cache, tokens[:, t])
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 5e-3, errs
    assert max(errs) < 1e-4, errs
