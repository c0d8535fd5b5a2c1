"""Training inputs of every family against the JAX package on the CPU: the
microbatch split of M-RoPE positions, ``input_specs`` and
``make_synthetic_batch`` for all ten configs, and one ``make_train_step``
step of each config at ``reduced()`` size (fp32) on the same batch.

Tolerances (fp32): integer leaves of a batch bit-equal; ``embeds`` within
4 ulps (4 * 2**-23 relative; 1e-8 absolute near 0): JAX's normal draw is
reproduced bit for bit up to XLA's erfinv polynomial, which the port
evaluates in another order of rounding (3 ulps seen); one train step as
tests/test_torch_train.py holds it: loss 1e-5, parameters 2e-4 absolute.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS as J_CONFIGS  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data.pipeline import make_synthetic_batch as j_batch  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.common import split_params  # noqa: E402
from repro.models.model_zoo import input_specs as j_specs  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.step import _split_mb_leaf  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import CONFIGS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import params_from_jax, to_jax_layout  # noqa: E402
from repro_torch.data.pipeline import make_synthetic_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model_zoo import input_specs  # noqa: E402
from repro_torch.train.optimizer import OptConfig, adamw_init  # noqa: E402
from repro_torch.train.step import _split_mb, make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = sorted(CONFIGS)
SMOKE = dict(name="smoke", seq_len=16, global_batch=2, kind="train")
EMBED_ULPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vlm(batch, seq=16):
    cfg = get_config("qwen2-vl-2b").reduced()
    shape = dict(SMOKE, global_batch=batch, seq_len=seq)
    t = make_synthetic_batch(cfg, ShapeConfig(**shape), seed=3, device="cpu")
    # distinct positions per row, so a wrong split shows
    t["positions"] = t["positions"] + 100 * torch.arange(
        batch, dtype=torch.int32)[None, :, None] + 1000 * torch.arange(
            3, dtype=torch.int32)[:, None, None]
    return cfg, t


@pytest.mark.parametrize("k", [2, 4])
def test_split_mb_matches_jax_on_a_vlm_batch(k):
    _, t = _vlm(4)
    mbs = _split_mb(t, k)
    for key, v in t.items():
        j = np.asarray(_split_mb_leaf(jnp.asarray(v.float().numpy()
                                                  if v.is_floating_point()
                                                  else v.numpy()), k))
        for i in range(k):
            np.testing.assert_array_equal(mbs[i][key].float().numpy()
                                          if v.is_floating_point()
                                          else mbs[i][key].numpy(), j[i])
    assert mbs[0]["positions"].shape == (3, 4 // k, 16)


def test_split_mb_gives_each_microbatch_its_rows_positions_at_three():
    """F3's silent case: 3 rows in 3 microbatches.  The positions' rows go
    with their microbatch (the streams stay whole), as JAX's rule gives."""
    _, t = _vlm(3)
    mbs = _split_mb(t, 3)
    for i in range(3):
        assert torch.equal(mbs[i]["positions"], t["positions"][:, i:i + 1])
        assert torch.equal(mbs[i]["embeds"], t["embeds"][i:i + 1])
        j = np.asarray(_split_mb_leaf(jnp.asarray(t["positions"].numpy()),
                                      3))[i]
        np.testing.assert_array_equal(mbs[i]["positions"].numpy(), j)


def test_split_mb_keys_on_the_name_not_the_shape():
    """The deliberate difference: JAX splits any (3, B, S) leaf on axis 1,
    so an ``embeds`` batch of three rows whose sequence divides would be
    cut along its sequence; the port cuts it by rows."""
    _, t = _vlm(3, seq=12)
    mbs = _split_mb(t, 3)
    assert mbs[0]["embeds"].shape == (1, 12, t["embeds"].shape[-1])
    j = _split_mb_leaf(jnp.asarray(t["embeds"].numpy()), 3)
    assert j.shape[1:] == (3, 4, t["embeds"].shape[-1])


def _np(v):
    return np.asarray(jnp.asarray(v, jnp.float32)) \
        if v.dtype == jnp.bfloat16 else np.asarray(v)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_synthetic_batch_match_jax(arch):
    cfg = CONFIGS[arch].reduced()
    jcfg = J_CONFIGS[arch].reduced()
    for kind in ("train", "prefill", "decode"):
        spec = input_specs(cfg, ShapeConfig(**dict(SMOKE, kind=kind)))
        jspec = j_specs(jcfg, JShape(**dict(SMOKE, kind=kind)))
        assert sorted(spec) == sorted(jspec)
        for k, s in spec.items():
            assert s.shape == tuple(jspec[k].shape)
            assert str(s.dtype).replace("torch.", "") == str(jspec[k].dtype)
    for seed in (0, 5):
        t = make_synthetic_batch(cfg, ShapeConfig(**SMOKE), seed,
                                 device="cpu")
        j = j_batch(jcfg, JShape(**SMOKE), seed)
        assert sorted(t) == sorted(j)
        for k, v in t.items():
            jv = np.asarray(j[k])
            assert tuple(v.shape) == jv.shape, k
            assert str(v.dtype).replace("torch.", "") == str(jv.dtype), k
            if k == "embeds":
                np.testing.assert_allclose(
                    v.numpy(), jv, rtol=EMBED_ULPS * 2.0 ** -23, atol=1e-8)
            else:
                np.testing.assert_array_equal(v.numpy(), jv)


def test_synthetic_bf16_embeds_equal_jax_bit_for_bit():
    """At a config's own dtype (bf16), the draws agree bit for bit."""
    for arch in ("qwen2-vl-2b", "seamless-m4t-large-v2"):
        cfg = dataclasses.replace(CONFIGS[arch].reduced(), dtype="bfloat16")
        jcfg = dataclasses.replace(J_CONFIGS[arch].reduced(),
                                   dtype="bfloat16")
        t = make_synthetic_batch(cfg, ShapeConfig(**SMOKE), 2, device="cpu")
        j = j_batch(jcfg, JShape(**SMOKE), 2)
        assert t["embeds"].dtype == torch.bfloat16
        np.testing.assert_array_equal(t["embeds"].float().numpy(),
                                      _np(j["embeds"]))


def _close(t, j, tol, atol=None):
    np.testing.assert_allclose(t.detach().float().numpy(), _np(j),
                               atol=tol if atol is None else atol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    """One AdamW step of each config on the JAX batch (through numpy)."""
    jcfg = J_CONFIGS[arch].reduced()
    jmodel = j_build(jcfg)
    values, axes = split_params(jmodel.init(jax.random.PRNGKey(0)))
    jb = j_batch(jcfg, JShape(**SMOKE), 1)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(j_make_train_step(jmodel, axes, JOptConfig(**opt)))
    jv, _, jm = jstep(values, j_adamw_init(values), jb)

    tmodel = build_model(CONFIGS[arch].reduced(), device="cpu")
    tv = params_from_jax(jax.tree.map(np.asarray, values), device="cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    tstep = make_train_step(tmodel, OptConfig(**opt))
    tv, topt, tm = tstep(tv, adamw_init(tv), tb)
    assert topt.step == 1
    _close(tm["loss"], jm["loss"], 1e-5)
    jv = jax.tree.map(np.asarray, jv)
    stacked = to_jax_layout(tv)
    for t, j in zip(leaves(stacked), jax.tree.leaves(jv)):
        _close(t, j, 0.0, atol=2e-4)


def test_microbatched_vlm_step_matches_jax():
    """F3 on the step: qwen2-vl (reduced) with M-RoPE positions, 4 rows in
    2 microbatches, against JAX's microbatched step."""
    arch = "qwen2-vl-2b"
    jcfg = J_CONFIGS[arch].reduced()
    jmodel = j_build(jcfg)
    values, axes = split_params(jmodel.init(jax.random.PRNGKey(0)))
    shape = dict(SMOKE, global_batch=4)
    jb = dict(j_batch(jcfg, JShape(**shape), 4))
    # rows with their own positions (text offsets), so a wrong split shows
    jb["positions"] = jb["positions"] + 3 * jnp.arange(4)[None, :, None]
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(j_make_train_step(jmodel, axes, JOptConfig(**opt),
                                      microbatches=2))
    jv, _, jm = jstep(values, j_adamw_init(values), jb)

    tmodel = build_model(CONFIGS[arch].reduced(), device="cpu")
    tv = params_from_jax(jax.tree.map(np.asarray, values), device="cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    tstep = make_train_step(tmodel, OptConfig(**opt), microbatches=2)
    tv, _, tm = tstep(tv, adamw_init(tv), tb)
    _close(tm["loss"], jm["loss"], 1e-5)
    for t, j in zip(leaves(to_jax_layout(tv)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jv))):
        _close(t, j, 0.0, atol=2e-4)
