"""Port's dense model against the JAX package on converted weights, fp32.

Tolerance 2e-5 (that of tests/test_kernels.py for fp32): both sides compute
in fp32 and differ only in summation order inside matmuls and reductions.
Every check runs on ``reduced()`` (no head padding) and on a head-padded
config (6 query heads padded to 8 over 2 KV heads, G = 4), the grouping
llama3.2-3b has at full width (24 heads padded to 32 over 8)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.common import split_params  # noqa: E402
from repro.models.mlp import mlp_apply as j_mlp_apply  # noqa: E402
from repro.models.mlp import mlp_init as j_mlp_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_tensor  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models.mlp import mlp_apply as t_mlp_apply  # noqa: E402

TOL = 2e-5


def _padded(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-padded", num_heads=6,
                               num_kv_heads=2, head_pad_multiple=4)


CFGS = {
    "reduced": CONFIGS["llama3.2-3b"].reduced(),
    "padded": _padded(CONFIGS["llama3.2-3b"].reduced()),
}


def _tcfg(name):
    cfg = get_config("llama3.2-3b").reduced()
    return _padded(cfg) if name == "padded" else cfg


def _values(tree):
    vals, _ = split_params(tree)
    return jax.tree.map(np.asarray, vals)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=TOL, rtol=TOL)


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    jcfg, tcfg = CFGS[request.param], _tcfg(request.param)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, \
        params_from_jax(_values(jparams), device="cpu")


def test_config_copies_match():
    from repro.configs import list_configs
    from repro_torch.configs import list_configs as t_list
    assert t_list() == list_configs()
    for name in list_configs():
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(CONFIGS[name])
        cfg = get_config(name)
        assert (cfg.padded_heads, cfg.padded_vocab) == \
            (CONFIGS[name].padded_heads, CONFIGS[name].padded_vocab)
    assert get_config("llama3.2-3b").padded_heads == 32


def test_init_shapes_match_jax(pair):
    jcfg, _, jparams, tcfg, tmodel, _ = pair
    tparams = tmodel.init(0)
    jvals = _values(jparams)
    assert len(tparams["layers"]) == jcfg.num_layers
    for key in ("embed", "ln_f", "lm_head"):
        assert tuple(tparams[key].shape) == jvals[key].shape
    flat_j = jax.tree_util.tree_leaves_with_path(jvals["layers"])
    for path, leaf in flat_j:
        t = tparams["layers"][0]
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape[1:], path
    wq = tparams["layers"][0]["attn"]["wq"]
    assert torch.all(wq[:, tcfg.num_heads:] == 0)
    assert torch.all(tparams["layers"][0]["attn"]["wo"][tcfg.num_heads:] == 0)


def test_rmsnorm_rope_logits_match_jax(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(jcfg.d_model).astype(np.float32)
    _close(t_common.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale),
                            tcfg.norm_eps),
           j_common.rmsnorm(jnp.asarray(x), jnp.asarray(scale),
                            jcfg.norm_eps))
    pos = rng.integers(0, 500, (2, 3)).astype(np.int32)
    hd = jcfg.resolved_head_dim
    j_ang = j_common.rope_angles(jnp.asarray(pos), hd, jcfg.rope_theta)
    t_ang = t_common.rope_angles(torch.from_numpy(pos), hd, tcfg.rope_theta)
    _close(t_ang, j_ang)
    xh = rng.standard_normal((2, 3, 4, hd)).astype(np.float32)
    _close(t_common.apply_rope(torch.from_numpy(xh), t_ang),
           j_common.apply_rope(jnp.asarray(xh), j_ang))
    head = _values(jparams)["lm_head"]
    _close(t_common.lm_logits(torch.from_numpy(x),
                              to_tensor(head, device="cpu"), tcfg),
           j_common.lm_logits(jnp.asarray(x), jnp.asarray(head), jcfg))


def test_mlp_matches_jax(pair):
    jcfg, *_ = pair
    p = j_mlp_init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 1, jcfg.d_model)).astype(np.float32)
    tp = {k: to_tensor(v, device="cpu") for k, v in _values(p).items()}
    _close(t_mlp_apply(tp, torch.from_numpy(x)), j_mlp_apply(p, jnp.asarray(x)))


def test_attn_decode_matches_jax(pair):
    jcfg, _, _, tcfg, _, _ = pair
    p = j_attn.attn_init(jax.random.PRNGKey(4), jcfg)
    tp = {k: to_tensor(v, device="cpu") for k, v in _values(p).items()}
    rng = np.random.default_rng(2)
    B, T, hd = 3, 16, jcfg.resolved_head_dim
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, T, jcfg.num_kv_heads, hd)).astype(np.float32)
    vc = rng.standard_normal((B, T, jcfg.num_kv_heads, hd)).astype(np.float32)
    lengths = np.asarray([0, 5, 15], np.int32)
    pos = lengths[:, None]
    j_ang = j_common.rope_angles(jnp.asarray(pos), hd, jcfg.rope_theta)
    t_ang = t_common.rope_angles(torch.from_numpy(pos), hd, tcfg.rope_theta)
    jo, jk, jv = j_attn.attn_decode(
        p, jnp.asarray(x), jcfg, k_cache=jnp.asarray(kc),
        v_cache=jnp.asarray(vc), lengths=jnp.asarray(lengths), angles=j_ang)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, tk, tv = t_attn.attn_decode(
        tp, torch.from_numpy(x), tcfg, k_cache=tk, v_cache=tv,
        lengths=torch.from_numpy(lengths), angles=t_ang)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


def test_decode_steps_match_jax(pair):
    """N steps of lm_decode_step from an empty cache: logits and cache."""
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    rng = np.random.default_rng(5)
    B, max_len, steps = 2, 16, 6
    jcache, _ = jmodel.init_cache(B, max_len)
    tcache = tmodel.init_cache(B, max_len)
    jstep = jax.jit(jmodel.decode_step)
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        tl, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(tl, jl)
        assert tl.dtype == torch.float32
    for key in ("k", "v", "lengths"):
        _close(tcache[key], jcache[key])
