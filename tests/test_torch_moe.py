"""The port's moe family against the JAX package on converted weights.

The layer (``moe_reference``: y and the load-balance aux) in fp32 and
bf16 on phi3.5-moe's and qwen3-moe's ``reduced()`` configs (4 experts,
top 2; tolerances of tests/test_kernels.py: fp32 2e-5, bf16 3e-2), the
port of tests/test_models.py's routing test, exact ties in the router
(both packages pick the lower expert ids), then the model at phi3.5-moe
``reduced()`` in fp32: ``lm_forward``'s logits and summed aux,
``lm_loss`` and the gradient of every leaf (1e-4, the tolerance of
tests/test_torch_train.py's gradients), prefill + decode against forward,
and the paged engine's greedy streams and page state against JAX's
engine, tick for tick.  Inputs are drawn from seeded numpy generators."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.common import split_params  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_tensor  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-4
ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors (several test workers
    share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    jcfg = dataclasses.replace(CONFIGS[arch].reduced(), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                               param_dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), _np(j),
                               atol=tol, rtol=tol)


def _layer_pair(jcfg, seed):
    p = j_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    jvals = {k: v.value for k, v in p.items()}
    tvals = {k: to_tensor(np.asarray(v), device="cpu")
             for k, v in jvals.items()}
    return jvals, tvals


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_reference_matches_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jvals, tvals = _layer_pair(jcfg, 1)
    assert tvals["router"].dtype == torch.float32
    assert tvals["wi_gate"].dtype == getattr(torch, dtype)
    x = (np.random.default_rng(2).standard_normal((24, jcfg.d_model))
         * 0.5).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, jaux = j_moe.moe_reference(jvals, jx, jcfg)
    ty, taux = t_moe.moe_reference(tvals, tx, tcfg)
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32
    # the same experts for every token
    _, jids, jprobs = j_moe._route(jx, jvals["router"], jcfg.experts_per_token)
    _, tids, tprobs = t_moe._route(tx, tvals["router"],
                                   tcfg.experts_per_token)
    assert tids.tolist() == np.asarray(jids).tolist()
    _close(tprobs, jprobs, TOL["float32"])
    _close(ty, jy, TOL[dtype])
    _close(taux, jaux, TOL["float32"])
    # moe_apply without a mesh is the reference; under a one-device mesh
    # the expert-parallel path (ep 1), which drops nothing at a capacity
    # for every token and gives the same y and aux
    ya, auxa = t_moe.moe_apply(tvals, tx.reshape(2, 12, -1), tcfg)
    assert torch.equal(ya.reshape(24, -1), ty) and torch.equal(auxa, taux)
    from repro_torch.distributed.sharding import ShardingCtx, rows_over
    from repro_torch.launch.mesh import init_world, make_mesh
    init_world(device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    roomy = dataclasses.replace(tcfg, capacity_factor=float(
        tcfg.num_experts))
    with ShardingCtx(mesh), rows_over(("data", "model")), \
            t_moe.record_drops() as drops:
        ye, auxe = t_moe.moe_apply(tvals, tx.reshape(2, 12, -1), roomy)
    assert [float(d) for d in drops] == [0.0]
    _close(ye.reshape(24, -1), jy, TOL[dtype])
    _close(auxe, jaux, TOL["float32"])


def test_moe_reference_routing_topk():
    """tests/test_models.py's routing test on the port (phi3.5-moe
    reduced, 32 tokens): shape, finite values, a load-balance loss near
    1 for near-uniform routing."""
    _, cfg = _cfgs("phi3.5-moe-42b-a6.6b")
    gen = torch.Generator().manual_seed(0)
    p = t_moe.moe_init(gen, cfg)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (64, 4), "wi_gate": (4, 64, 128), "wi_up": (4, 64, 128),
        "wo": (4, 128, 64)}
    x = torch.randn((32, cfg.d_model), generator=gen) * 0.5
    y, aux = t_moe.moe_reference(p, x, cfg)
    assert y.shape == x.shape
    assert bool(torch.all(torch.isfinite(y)))
    assert float(aux) > 0.5


@pytest.mark.parametrize("case", ["all_equal", "two_tied_best"])
def test_exact_router_ties_pick_the_lower_expert(case):
    """Tied router probabilities: ``lax.top_k`` takes the lower index, and
    so does the port's stable sort."""
    jcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    jvals, tvals = _layer_pair(jcfg, 3)
    router = np.zeros((jcfg.d_model, 4), np.float32)
    if case == "two_tied_best":
        col = np.random.default_rng(4).standard_normal(jcfg.d_model) * 0.1
        router[:, 1] = router[:, 3] = np.abs(col)
    jvals["router"] = jnp.asarray(router)
    tvals["router"] = torch.from_numpy(router)
    x = np.abs(np.random.default_rng(5).standard_normal(
        (8, jcfg.d_model))).astype(np.float32)
    _, jids, _ = j_moe._route(jnp.asarray(x), jvals["router"], 2)
    _, tids, _ = t_moe._route(torch.from_numpy(x), tvals["router"], 2)
    want = [0, 1] if case == "all_equal" else [1, 3]
    assert tids.tolist() == np.asarray(jids).tolist() == [want] * 8
    jy, _ = j_moe.moe_reference(jvals, jnp.asarray(x), jcfg)
    ty, _ = t_moe.moe_reference(tvals, torch.from_numpy(x), tcfg)
    _close(ty, jy, TOL["float32"])


@pytest.fixture(scope="module")
def model_pair():
    jcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    values, axes = split_params(jparams)
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, values),
                              device="cpu")
    tokens = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 20),
                                               dtype=np.int32)
    return jmodel, jparams, values, axes, tmodel, tparams, tokens


def test_lm_init_and_convert_carry_the_moe_layer(model_pair):
    _, _, values, _, tmodel, tparams, _ = model_pair
    layer = tparams["layers"][0]
    assert "mlp" not in layer and set(layer["moe"]) == {
        "router", "wi_gate", "wi_up", "wo"}
    assert layer["moe"]["router"].dtype == torch.float32
    jw = np.asarray(values["layers"]["moe"]["wi_up"])       # (L, E, d, f)
    assert jw.shape[0] == len(tparams["layers"])
    for li, lay in enumerate(tparams["layers"]):
        assert np.array_equal(lay["moe"]["wi_up"].numpy(), jw[li])
    own = tmodel.init(0)["layers"][0]["moe"]
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in layer["moe"].items()}


def test_lm_forward_logits_and_aux_match_jax(model_pair):
    jmodel, _, values, axes, tmodel, tparams, tokens = model_pair
    jl, jaux = jmodel.forward_v(values, axes, {"tokens": jnp.asarray(tokens)})
    tl, taux = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl, TOL["float32"])
    _close(taux, jaux, TOL["float32"])
    assert float(taux) > 0.0
    jloss, jm = jmodel.loss_v(values, axes, {"tokens": jnp.asarray(tokens)})
    tloss, tm = tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tloss, jloss, TOL["float32"])
    _close(tm["aux"], jm["aux"], TOL["float32"])
    _close(tm["ce"], jm["ce"], TOL["float32"])


def test_lm_loss_gradients_match_jax(model_pair):
    jmodel, _, values, axes, tmodel, tparams, tokens = model_pair
    jgrads = jax.tree.map(np.asarray, jax.grad(lambda v: jmodel.loss_v(
        v, axes, {"tokens": jnp.asarray(tokens)})[0])(values))
    vals = tree_map(lambda t: t.detach().requires_grad_(), tparams)
    loss, _ = tmodel.loss(vals, {"tokens": torch.from_numpy(tokens)})
    grads = dict(zip(map(id, leaves(vals)),
                     torch.autograd.grad(loss, leaves(vals))))
    n = 0
    for key, v in vals.items():
        if key != "layers":
            _close(grads[id(v)], jgrads[key], GRAD_TOL)
            n += 1
            continue
        for li, layer in enumerate(v):
            jl = jax.tree.map(lambda a, i=li: a[i], jgrads["layers"])
            for t, j in zip(leaves(layer), jax.tree.leaves(jl)):
                _close(grads[id(t)], j, GRAD_TOL)
                n += 1
    assert n == len(leaves(tparams))
    router = grads[id(vals["layers"][0]["moe"]["router"])]
    assert float(router.abs().max()) > 0.0        # the routing is trained


def test_prefill_then_decode_matches_forward_and_jax(model_pair):
    jmodel, jparams, _, _, tmodel, tparams, tokens = model_pair
    t = torch.from_numpy(tokens)
    full, _ = tmodel.forward(tparams, {"tokens": t})
    S0 = 12
    jl, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :S0])}, 32)
    tl, tcache = tmodel.prefill(tparams, {"tokens": t[:, :S0]}, 32)
    _close(tl, jl, TOL["float32"])
    _close(tcache["k"], jcache["k"], TOL["float32"])
    _close(tl, full[:, S0 - 1], 1e-4)
    for j in range(S0, tokens.shape[1]):
        tl, tcache = tmodel.decode_step(tparams, tcache, t[:, j])
        jl, jcache = jmodel.decode_step(jparams, jcache,
                                        jnp.asarray(tokens[:, j]))
        _close(tl, jl, TOL["float32"])
        _close(tl, full[:, j], 1e-4)


def test_moe_engine_streams_match_jax_engine(model_pair):
    """The paged engine on the moe model (fp32, reduced): the same greedy
    streams, page tables and lengths as JAX's engine after every tick,
    slots refilled from the queue; and the streams of the contiguous
    decode."""
    jmodel, jparams, _, _, tmodel, tparams, _ = model_pair
    rng = np.random.default_rng(7)
    traffic = [([int(t) for t in rng.integers(1, 256, 3 + i % 6)], 4 + i % 3)
               for i in range(6)]
    jeng = JaxEngine(jmodel, jparams, batch_slots=3, max_len=64,
                     page_size=8)
    teng = ServingEngine(tmodel, tparams, batch_slots=3, max_len=64,
                         page_size=8, device="cpu")
    for p, n in traffic:
        assert jeng.submit(p, max_new=n) == teng.submit(p, max_new=n)
    while jeng.queue or any(s.request_id >= 0 for s in jeng.slots):
        jeng.step()
        teng.step()
        np.testing.assert_array_equal(np.asarray(jeng.kv.page_table),
                                      teng.kv.page_table.numpy())
        np.testing.assert_array_equal(np.asarray(jeng.kv.lengths),
                                      teng.kv.lengths.numpy())
    assert teng.finished == jeng.finished and len(teng.finished) == 6
    for rid, (prompt, n) in enumerate(traffic[:2]):
        cache = tmodel.init_cache(1, 64)
        for tok in prompt[:-1]:
            _, cache = tmodel.decode_step(tparams, cache, torch.tensor([tok]))
        out, cur = [], prompt[-1]
        for _ in range(n):
            lg, cache = tmodel.decode_step(tparams, cache,
                                           torch.tensor([cur]))
            cur = int(torch.argmax(lg[0]))
            out.append(cur)
        assert out == teng.finished[rid]


def test_engine_admits_moe_and_refuses_vlm():
    """The engine admits the moe family and, now that vlm is ported, the
    vlm family too, as JAX's engine does; it refuses the ssm, hybrid and
    encdec families with a message naming the families it serves."""
    for arch in ("qwen3-moe-235b-a22b", "qwen2-vl-2b"):
        model = build_model(get_config(arch).reduced(), device="cpu")
        ServingEngine(model, model.init(0), batch_slots=2, max_len=32,
                      page_size=8, device="cpu")
    for arch in ("mamba2-130m", "recurrentgemma-9b",
                 "seamless-m4t-large-v2"):
        model = build_model(get_config(arch).reduced(), device="cpu")
        with pytest.raises(NotImplementedError,
                           match="serves the dense, moe and vlm families"):
            ServingEngine(model, {}, batch_slots=2, max_len=32,
                          page_size=8, device="cpu")


def test_serve_cli_serves_moe_tiny_and_refuses_full(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--preset", "tiny",
                "--device", "cpu", "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("[serve] request") == 2
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    assert serve.weight_bytes(cfg) > 80e9          # 32 layers, bf16
    # more than any device holds: refused, saying the CLI has no mesh
    with pytest.raises(SystemExit, match="does not fit one card.*no mesh"):
        serve.check_fits(dataclasses.replace(cfg, num_layers=10 ** 4),
                         "cpu")
