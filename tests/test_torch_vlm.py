"""The port's vlm family (qwen2-vl-2b) and M-RoPE against the JAX package.

At ``qwen2-vl-2b.reduced()`` in fp32 (2 layers, d_model 64, 4 heads over 2
KV heads of 16, M-RoPE sections (4, 6, 6)) with the JAX weights carried
across (``convert.py``: a vlm tree is the dense layout): ``rope_angles``
and ``default_positions`` with sections, the clamped (4, 6, 6) included;
forward and loss on patch embeddings with Qwen2-VL's grid positions and
labels with -1 entries; the gradient of every leaf; prefill then
``decode_step`` on tokens and on ``embeds=``; and the paged engine's
greedy streams against JAX's engine on token prompts.  Logits and
gradients within 2e-5 (fp32), streams and integer cache fields exact.
Inputs come from seeded numpy generators."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models.common import merge_params, split_params  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = 2e-5
ARCH = "qwen2-vl-2b"


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


def grid_positions(batch, n_text, grid, n_after):
    """Qwen2-VL's M-RoPE positions (3, B, S) of ``n_text`` text tokens, an
    image of ``grid`` = (h, w) patches and ``n_after`` text tokens: text
    has one position in all three streams; the image's t is constant at
    the next position and its h and w follow the grid from there; the text
    after it continues from the largest position + 1."""
    gh, gw = grid
    text = np.arange(n_text)
    t = np.full(gh * gw, n_text)
    h = n_text + np.repeat(np.arange(gh), gw)
    w = n_text + np.tile(np.arange(gw), gh)
    start = max(t.max(), h.max(), w.max()) + 1
    after = start + np.arange(n_after)
    pos = np.stack([np.concatenate([text, s, after]) for s in (t, h, w)])
    return np.broadcast_to(pos[:, None], (3, batch, pos.shape[1])).astype(
        np.int32).copy()


def test_grid_positions_follow_the_image_grid():
    pos = grid_positions(1, 2, (2, 3), 2)[:, 0]
    assert pos.tolist() == [[0, 1, 2, 2, 2, 2, 2, 2, 5, 6],
                            [0, 1, 2, 2, 2, 3, 3, 3, 5, 6],
                            [0, 1, 2, 3, 4, 2, 3, 4, 5, 6]]


@pytest.mark.parametrize("head_dim,sections", [
    (16, (4, 6, 6)),        # reduced(): 16 sections over 8 frequencies
    (128, (16, 24, 24)),    # qwen2-vl-2b: sums to the half-dim
    (16, (2, 3, 3)),
])
def test_rope_angles_with_sections_match_jax(head_dim, sections):
    pos = np.random.default_rng(1).integers(0, 300, (3, 2, 7)).astype(
        np.int32)
    j = j_common.rope_angles(jnp.asarray(pos), head_dim, 1e6, sections)
    t = t_common.rope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert tuple(t.shape) == (2, 7, head_dim // 2) == j.shape
    _close(t, j)          # XLA's and torch's pow round an ulp apart
    # the slicing clamps: section i takes frequencies [start, start + sec)
    # of the half-dim, as many as are left
    freqs = t_common._rope_freqs(head_dim, 1e6, torch.device("cpu"))
    start = 0
    for stream, sec in enumerate(sections):
        n = max(0, min(sec, head_dim // 2 - start))
        want = torch.from_numpy(pos[stream])[..., None].float() \
            * freqs[start:start + n]
        assert torch.equal(t[..., start:start + n], want)
        start += n
    assert start == head_dim // 2


def test_reduced_sections_clamp_to_4_4_0():
    """(4, 6, 6) at head_dim 16: t turns 4 frequencies, h the other 4 and
    w none, so the w stream changes nothing."""
    cfg = get_config(ARCH).reduced()
    assert cfg.mrope_sections == (4, 6, 6) and cfg.resolved_head_dim == 16
    pos = torch.from_numpy(np.random.default_rng(2).integers(
        0, 50, (3, 2, 5)).astype(np.int32))
    other = pos.clone()
    other[2] += 17
    a = t_common.rope_angles(pos, 16, cfg.rope_theta, cfg.mrope_sections)
    b = t_common.rope_angles(other, 16, cfg.rope_theta, cfg.mrope_sections)
    assert torch.equal(a, b)
    other[1] += 1
    c = t_common.rope_angles(other, 16, cfg.rope_theta, cfg.mrope_sections)
    assert torch.equal(c[..., :4], a[..., :4])
    assert not torch.equal(c[..., 4:], a[..., 4:])


def test_default_positions_with_sections_match_jax():
    cfg = get_config(ARCH).reduced()
    t = t_common.default_positions(2, 9, cfg, "cpu")
    j = j_common.default_positions(2, 9, CONFIGS[ARCH].reduced())
    assert tuple(t.shape) == (3, 2, 9) and t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    dense = t_common.default_positions(2, 9, get_config(
        "llama3.2-3b").reduced(), "cpu")
    assert tuple(dense.shape) == (2, 9)


def test_mrope_positions_need_three_streams():
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        t_common.rope_angles(torch.zeros((2, 5), dtype=torch.int32), 16,
                             1e6, (4, 6, 6))


@pytest.fixture(scope="module")
def pair():
    jcfg = CONFIGS[ARCH].reduced()
    tcfg = get_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    values, axes = split_params(jparams)
    # random nonzero biases (JAX initialises them to zero)
    rng = np.random.default_rng(3)
    values = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(np.shape(a)) * 0.3).astype(
            np.float32) if path[-1].key in ("bq", "bk", "bv")
        else np.asarray(a), values)
    jparams = merge_params(jax.tree.map(jnp.asarray, values), axes)
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(values, device="cpu")
    return jmodel, jparams, values, axes, tmodel, tparams


def _batch(cfg, seed, B=2, n_text=3, grid=(3, 4), n_after=5):
    rng = np.random.default_rng(seed)
    pos = grid_positions(B, n_text, grid, n_after)
    S = pos.shape[-1]
    embeds = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(
        np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :n_text + grid[0] * grid[1]] = -1      # no loss on the image
    labels[1, -2:] = -1
    return {"embeds": embeds, "positions": pos, "labels": labels}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_convert_carries_the_vlm_tree_as_the_dense_layout(pair):
    _, _, values, _, tmodel, tparams = pair
    assert set(tparams) == {"embed", "lm_head", "ln_f", "layers"}
    assert len(tparams["layers"]) == 2
    own = tmodel.init(0)
    assert [(tuple(a.shape), a.dtype) for a in leaves(own)] == \
        [(tuple(a.shape), a.dtype) for a in leaves(tparams)]
    np.testing.assert_array_equal(
        tparams["layers"][1]["attn"]["bq"].numpy(),
        np.asarray(values["layers"]["attn"]["bq"])[1])


def test_forward_and_loss_on_embeds_match_jax(pair):
    jmodel, _, values, axes, tmodel, tparams = pair
    batch = _batch(tmodel.cfg, 4)
    jl, jaux = jmodel.forward_v(values, axes, _j(batch))
    tl, taux = tmodel.forward(tparams, _t(batch))
    assert tuple(tl.shape) == (2, 20, tmodel.cfg.padded_vocab)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0
    jloss, jm = jmodel.loss_v(values, axes, _j(batch))
    tloss, tm = tmodel.loss(tparams, _t(batch))
    _close(tloss, jloss)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 5 - 2
    # M-RoPE's positions matter: the default ones give other logits
    plain = {k: v for k, v in _t(batch).items() if k != "positions"}
    assert not torch.allclose(tmodel.forward(tparams, plain)[0], tl)


def test_loss_gradients_match_jax(pair):
    jmodel, _, values, axes, tmodel, tparams = pair
    batch = _batch(tmodel.cfg, 5)
    jgrads = jax.tree.map(np.asarray, jax.grad(
        lambda v: jmodel.loss_v(v, axes, _j(batch))[0])(values))
    vals = tree_map(lambda t: t.detach().requires_grad_(), tparams)
    loss, _ = tmodel.loss(vals, _t(batch))
    grads = torch.autograd.grad(loss, leaves(vals), allow_unused=True)
    # the embeddings bypass the table: no gradient here, zeros in JAX
    assert grads[0] is None and not np.asarray(jgrads["embed"]).any()
    grads = (torch.zeros_like(vals["embed"]),) + grads[1:]
    jl = [jgrads[k] for k in sorted(jgrads) if k != "layers"]
    jlayers = [jax.tree.leaves(jax.tree.map(lambda a, i=i: a[i],
                                            jgrads["layers"]))
               for i in range(len(vals["layers"]))]
    # leaves() walks dict keys sorted: embed, layers, lm_head, ln_f
    want = [jl[0]] + [g for layer in jlayers for g in layer] + jl[1:]
    assert len(want) == len(grads) == len(leaves(tparams))
    for t, j in zip(grads, want):
        _close(t, j)


@pytest.mark.parametrize("tail", ["tokens", "embeds"])
def test_prefill_then_decode_matches_jax(pair, tail):
    """Prefill of embeddings at grid positions, then four decode steps fed
    tokens or embeddings: logits against JAX's at every step, the cache's
    K/V within the tolerance and its lengths exact."""
    jmodel, jparams, _, _, tmodel, tparams = pair
    batch = _batch(tmodel.cfg, 6)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    jl, jc = jmodel.prefill(jparams, _j(pre), 32)
    tl, tc = tmodel.prefill(tparams, _t(pre), 32)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    rng = np.random.default_rng(7)
    for _ in range(4):
        tok = rng.integers(0, tmodel.cfg.vocab_size, 2).astype(np.int32)
        emb = None
        if tail == "embeds":
            emb = (rng.standard_normal((2, 1, tmodel.cfg.d_model))
                   * 0.5).astype(np.float32)
        jl, jc = jmodel.decode_step(
            jparams, jc, jnp.asarray(tok),
            embeds=None if emb is None else jnp.asarray(emb))
        tl, tc = tmodel.decode_step(
            tparams, tc, torch.from_numpy(tok),
            embeds=None if emb is None else torch.from_numpy(emb))
        _close(tl, jl)
        np.testing.assert_array_equal(tc["lengths"].numpy(),
                                      np.asarray(jc["lengths"]))
    _close(tc["k"], jc["k"])
    assert tc["lengths"].tolist() == [24, 24]


def test_decode_matches_forward_on_concatenated_positions(pair):
    """Prefill + decode against one forward over the prompt and the fed
    embeddings, the decode positions (its lengths) in all three streams:
    the gate chip_smoke.py's vlm_fp32 holds at full width."""
    _, _, _, _, tmodel, tparams = pair
    cfg = tmodel.cfg
    batch = _t(_batch(cfg, 8))
    rng = np.random.default_rng(9)
    tail = torch.from_numpy((rng.standard_normal((2, 3, cfg.d_model))
                             * 0.5).astype(np.float32))
    _, cache = tmodel.prefill(tparams, {"embeds": batch["embeds"],
                                        "positions": batch["positions"]}, 32)
    rows = []
    for j in range(3):
        lg, cache = tmodel.decode_step(tparams, cache, None,
                                       embeds=tail[:, j:j + 1])
        rows.append(lg)
    S = batch["embeds"].shape[1]
    pos = torch.cat([batch["positions"],
                     torch.arange(S, S + 3, dtype=torch.int32).expand(
                         3, 2, 3)], dim=-1)
    full, _ = tmodel.forward(tparams, {
        "embeds": torch.cat([batch["embeds"], tail], dim=1),
        "positions": pos})
    _close(torch.stack(rows, dim=1), full[:, S:], 1e-4)


def test_vlm_engine_streams_match_jax_engine(pair):
    """The paged engine serves the vlm on token prompts (decode positions
    broadcast to the three streams): the same greedy streams, page tables
    and lengths as JAX's engine after every tick."""
    jmodel, jparams, _, _, tmodel, tparams = pair
    rng = np.random.default_rng(10)
    traffic = [([int(t) for t in rng.integers(1, 256, 2 + i % 5)], 3 + i % 3)
               for i in range(5)]
    jeng = JaxEngine(jmodel, jparams, batch_slots=3, max_len=48,
                     page_size=8)
    teng = ServingEngine(tmodel, tparams, batch_slots=3, max_len=48,
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
    assert teng.finished == jeng.finished and len(teng.finished) == 5


def test_serve_cli_serves_vlm_tiny_and_refuses_encdec(capsys):
    """``launch/serve.py`` serves qwen2-vl-2b's tiny preset on token
    prompts; at full size its ~3.6 GB of bf16 weights pass ``check_fits``;
    seamless is refused by family before its weights are built, as JAX's
    engine refuses it."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--preset", "tiny", "--device", "cpu",
                "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("[serve] request") == 2 and "2 requests, 6 tokens" in out
    full = get_config(ARCH)
    assert 3.4e9 < serve.weight_bytes(full) < 3.8e9
    serve.check_fits(full, "cpu")
    with pytest.raises(NotImplementedError,
                       match="serves the dense, moe and vlm families, not "
                             "'encdec'"):
        serve.main(["--arch", "seamless-m4t-large-v2", "--preset", "tiny",
                    "--device", "cpu"])
