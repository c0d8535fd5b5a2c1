"""The port's hybrid family (recurrentgemma) against the JAX package on the
CPU, with the JAX weights converted by ``params_from_jax``.

Two sizes of ``get_config("recurrentgemma-9b").reduced()`` (d_model 64,
lru_width 64, 4 heads of 16 over 1 KV head, window 16, conv width 4,
vocab 256, fp32): its own 3 layers (one rec, rec, attn group) and 5
layers, whose last two run the remainder path (rec, rec, attn, rec, rec).

Tolerances (fp32), as in tests/test_torch_ssm.py:
- block outputs and states, forward logits, loss, prefill and decode
  logits and caches 2e-5 (tests/test_kernels.py for fp32): the same
  arithmetic, sums in another order;
- gradients 1e-4: the backward recomputes the scan through its plain
  version and sums the parts of each weight's gradient in another order.
At head_dim 256 with 16 query heads over 1 KV head (recurrentgemma-9b's
attention at full width) the plain decode and flash versions hold JAX's
references at 2e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_reference as j_decode_ref)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference as j_flash_ref)
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models.common import merge_params, split_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_tensor  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_reference)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    plain_attention)
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import rglru as t_rglru  # noqa: E402
from repro_torch.models.transformer import hybrid_layer_kinds  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-4
ARCH = "recurrentgemma-9b"
STACKED = ("rec_layers", "attn_layers")


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
    """Hold the port's tree (layer lists) against the JAX tree (layers
    stacked on axis 0), leaf by leaf; returns the number of leaves."""
    n = 0
    for k in jtree:
        if k not in STACKED:
            check(ttree[k], jtree[k])
            n += 1
            continue
        assert len(ttree[k]) == np.asarray(jtree[k]["ln1"]).shape[0]
        for i, layer in enumerate(ttree[k]):
            jl = jax.tree.map(lambda a, i=i: np.asarray(a)[i], jtree[k])
            for t, j in zip(leaves(layer), jax.tree.leaves(jl)):
                check(t, j)
                n += 1
    return n


def _configs(layers):
    jcfg = j_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    if layers != jcfg.num_layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[3, 5], ids=["3_layers", "5_layers"])
def pair(request):
    jcfg, tcfg = _configs(request.param)
    assert tcfg.family == "hybrid" and tcfg.local_window == 16
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    values, axes = split_params(jparams)
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(_values(jparams), device="cpu")
    tokens = np.random.default_rng(request.param).integers(
        0, tcfg.vocab_size, (2, 26), dtype=np.int32)
    return jcfg, jmodel, values, axes, tcfg, tmodel, tparams, tokens


def test_layer_kinds_and_init_keep_jax_shapes(pair):
    jcfg, _, values, _, tcfg, tmodel, _, _ = pair
    kinds = hybrid_layer_kinds(tcfg)
    assert kinds == ("rec", "rec", "attn", "rec", "rec")[:tcfg.num_layers]
    tparams = tmodel.init(0)
    assert len(tparams["rec_layers"]) == kinds.count("rec")
    assert len(tparams["attn_layers"]) == kinds.count("attn")
    shapes = []
    n = _check_tree(tparams, jax.tree.map(np.asarray, values),
                    lambda t, j: shapes.append((tuple(t.shape), j.shape,
                                                t.dtype, j.dtype)))
    assert n == len(leaves(tparams))
    assert all(ts == js for ts, js, _, _ in shapes)
    # the deterministic a_param of Griffin's init follows JAX's (log and
    # expm1 of fp32 round apart in the two libraries)
    _close(tparams["rec_layers"][0]["rglru"]["a_param"],
           np.asarray(values["rec_layers"]["rglru"]["a_param"])[0])


def test_bf16_conversion_keeps_fp32_gate_leaves():
    jcfg, _ = _configs(3)
    bf = dataclasses.replace(jcfg, dtype="bfloat16", param_dtype="bfloat16")
    conv = params_from_jax(_values(j_build(bf).init(jax.random.PRNGKey(1))),
                           device="cpu")
    for name, leaf in conv["rec_layers"][0]["rglru"].items():
        want = torch.float32 if name in ("g_r", "b_r", "g_i", "b_i",
                                         "a_param") else torch.bfloat16
        assert leaf.dtype == want, name
    assert conv["attn_layers"][0]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("S", [13, 2], ids=["prompt", "shorter_than_conv"])
def test_rglru_block_with_state_and_decode_match_jax(S):
    """rglru_apply with its state (a prompt shorter than conv_width - 1
    pads the conv tail with zeros), then three rglru_decode steps."""
    jcfg, tcfg = _configs(3)
    p = j_rglru.rglru_init(jax.random.PRNGKey(3), jcfg)
    tp = {k: to_tensor(v, device="cpu") for k, v in _values(p).items()}
    rng = np.random.default_rng(1)
    # non-zero gate weights, so that r and i depend on u
    for key in ("g_r", "b_r", "g_i", "b_i"):
        tp[key] = torch.from_numpy(
            rng.standard_normal(tcfg.lru_width).astype(np.float32))
        p[key] = j_common.Param(jnp.asarray(tp[key].numpy()), ("lru",))
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    j_apply = jax.jit(j_rglru.rglru_apply,
                      static_argnames=("cfg", "return_state"))
    j_decode = jax.jit(j_rglru.rglru_decode, static_argnames=("cfg",))
    jo, jst = j_apply(p, jnp.asarray(x), cfg=jcfg, return_state=True)
    to, tst = t_rglru.rglru_apply(tp, torch.from_numpy(x), tcfg,
                                  return_state=True)
    _close(to, jo)
    assert to.dtype == torch.float32 and tst["h"].dtype == torch.float32
    for key in ("conv", "h"):
        assert tuple(tst[key].shape) == jst[key].shape
        _close(tst[key], jst[key])
    _close(t_rglru.rglru_apply(tp, torch.from_numpy(x), tcfg), jo)
    for _ in range(3):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jo, jst = j_decode(p, jnp.asarray(xt), jst, cfg=jcfg)
        to, tst = t_rglru.rglru_decode(tp, torch.from_numpy(xt), tst, tcfg)
        _close(to, jo)
        _close(tst["conv"], jst["conv"])
        _close(tst["h"], jst["h"])


def test_rglru_init_cache_matches_jax():
    jcfg, tcfg = _configs(3)
    jc = j_rglru.rglru_init_cache(jcfg, 3)
    tc = t_rglru.rglru_init_cache(tcfg, 3, torch.device("cpu"))
    for key in ("conv", "h"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
        assert not tc[key].any()


def test_attn_decode_ring_matches_jax():
    """write_pos/valid_len: rows before, at and past the ring's wrap."""
    jcfg, tcfg = _configs(3)
    p = j_attn.attn_init(jax.random.PRNGKey(4), jcfg)
    tp = {k: to_tensor(v, device="cpu") for k, v in _values(p).items()}
    rng = np.random.default_rng(2)
    B, w, hd = 4, jcfg.local_window, jcfg.resolved_head_dim
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, w, jcfg.num_kv_heads, hd)).astype(np.float32)
    vc = rng.standard_normal((B, w, jcfg.num_kv_heads, hd)).astype(np.float32)
    lengths = np.asarray([0, 7, 16, 37], np.int32)
    ring = lengths % w
    valid = np.minimum(lengths + 1, w).astype(np.int32)
    pos = lengths[:, None]
    j_ang = j_common.rope_angles(jnp.asarray(pos), hd, jcfg.rope_theta)
    t_ang = t_common.rope_angles(torch.from_numpy(pos), hd, tcfg.rope_theta)
    jo, jk, jv = j_attn.attn_decode(
        p, jnp.asarray(x), jcfg, k_cache=jnp.asarray(kc),
        v_cache=jnp.asarray(vc), lengths=jnp.asarray(lengths), angles=j_ang,
        write_pos=jnp.asarray(ring), valid_len=jnp.asarray(valid))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, tk2, tv2 = t_attn.attn_decode(
        tp, torch.from_numpy(x), tcfg, k_cache=tk, v_cache=tv,
        lengths=torch.from_numpy(lengths), angles=t_ang,
        write_pos=torch.from_numpy(ring), valid_len=torch.from_numpy(valid))
    assert tk2 is tk and tv2 is tv          # written in place
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


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
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 25


def test_gradient_of_every_leaf_matches_jax_grad(pair):
    _, jmodel, values, axes, _, tmodel, tparams, tokens = pair
    jgrads = jax.jit(jax.grad(lambda v: jmodel.loss_v(
        v, axes, {"tokens": jnp.asarray(tokens)})[0]))(values)
    vals = tree_map(lambda t: t.detach().requires_grad_(), tparams)
    loss, _ = tmodel.loss(vals, {"tokens": torch.from_numpy(tokens)})
    tgrads = dict(zip(map(id, leaves(vals)),
                      torch.autograd.grad(loss, leaves(vals))))
    gtree = tree_map(lambda t: tgrads[id(t)], vals)
    n = _check_tree(gtree, jax.tree.map(np.asarray, jgrads),
                    lambda t, j: _close(t, j, GRAD_TOL))
    assert n == len(leaves(tparams))
    # the recurrence's parameters get gradients through the scan
    assert float(gtree["rec_layers"][0]["rglru"]["a_param"].abs().sum()) > 0


def _check_cache(tc, jc):
    for key in ("conv", "h"):
        assert tuple(tc["rec"][key].shape) == jc["rec"][key].shape
        _close(tc["rec"][key], jc["rec"][key])
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
    assert tc["lengths"].dtype == torch.int32


def test_prefill_past_window_then_decode_matches_jax(pair):
    """tests/test_models.py's ring scenario: prefill 22 tokens (window 16)
    at max_len 64, then 4 decode steps across the ring, logits and caches
    step by step; the logits also follow the full-sequence forward."""
    _, jmodel, values, axes, _, tmodel, tparams, tokens = pair
    jparams = merge_params(values, axes)
    half = 22
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :half])},
                            64)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(
        tokens[:, :half])}, 64)
    assert tc["k"].shape[2] == 16
    _close(tl, jl)
    _check_cache(tc, jc)
    full, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tl, full[:, half - 1].detach().numpy())
    jstep = jax.jit(jmodel.decode_step)
    for j in range(half, 26):
        jl, jc = jstep(jparams, jc, jnp.asarray(tokens[:, j]))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(
            tokens[:, j]))
        _close(tl, jl)
        _close(tl, full[:, j].detach().numpy())
        _check_cache(tc, jc)


def test_greedy_stream_matches_jax(pair):
    """Prefill then 10 greedy steps (past the window): the same tokens."""
    _, jmodel, values, axes, _, tmodel, tparams, tokens = pair
    jparams = merge_params(values, axes)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :9])},
                            32)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(
        tokens[:, :9])}, 32)
    jstep = jax.jit(jmodel.decode_step)
    jout, tout = [], []
    for _ in range(10):
        jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), tl.argmax(-1)
        jout.append(np.asarray(jt).tolist())
        tout.append(tt.tolist())
        jl, jc = jstep(jparams, jc, jt)
        tl, tc = tmodel.decode_step(tparams, tc, tt)
    assert tout == jout


@pytest.mark.parametrize("lens", [[64, 64], [64, 9]], ids=["full", "ragged"])
def test_plain_decode_g16_d256_matches_jax(lens):
    """recurrentgemma-9b's decode: 16 query heads over 1 KV head of 256."""
    rng = np.random.default_rng(6)
    B, T, Hq, Hkv, D = 2, 64, 16, 1, 256
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    out = decode_attention_reference(*(torch.from_numpy(a)
                                       for a in (q, k, v, lengths)))
    _close(out, j_decode_ref(*(jnp.asarray(a) for a in (q, k, v, lengths))))


def test_plain_flash_d256_with_window_matches_jax():
    """recurrentgemma-9b's prefill attention: head_dim 256, 16 heads over
    1 KV head, causal with a window, ragged Sq = Sk."""
    rng = np.random.default_rng(7)
    B, S, Hq, Hkv, D, window = 2, 45, 16, 1, 256, 16
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    out = plain_attention(*(torch.from_numpy(a) for a in (q, k, v)), True,
                          window, 0, None)
    _close(out, j_flash_ref(*(jnp.asarray(a) for a in (q, k, v)),
                            causal=True, window=window))


def test_build_model_admits_hybrid_and_refuses_the_rest():
    """build_model admits the hybrid family and, now that encdec and vlm
    are ported, refuses no family: each builds and initialises."""
    model = build_model(get_config(ARCH).reduced(), device="cpu")
    assert model.cfg.family == "hybrid"
    for arch, family in (("qwen3-moe-235b-a22b", "moe"),
                         ("seamless-m4t-large-v2", "encdec"),
                         ("qwen2-vl-2b", "vlm")):
        m = build_model(get_config(arch).reduced(), device="cpu")
        assert m.cfg.family == family
        assert "lm_head" in m.init(0)
