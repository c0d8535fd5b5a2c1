"""Port's serving engine against the JAX engine on the same weights (fp32).

Both engines run the traffic of tests/test_serving.py in lock-step.  After
every tick the page table, the lengths and every allocator field must be
identical, and at the end the greedy token streams must be identical.  The
port's engine is also held against the port's own contiguous-cache decode,
the check that runs on the card where JAX is absent."""
import ast
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.common import split_params  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.allocator import STATE_FIELDS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def _padded(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-padded", num_heads=6,
                               num_kv_heads=2, head_pad_multiple=4)


def jcfg_to_port(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=["reduced", "padded"])
def models(request):
    jcfg = CONFIGS["llama3.2-3b"].reduced()
    if request.param == "padded":
        jcfg = _padded(jcfg)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    values, _ = split_params(jparams)
    tmodel = build_model(jcfg_to_port(jcfg), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, values),
                              device="cpu")
    return jmodel, jparams, tmodel, tparams


def _same_kv(jkv, tkv):
    np.testing.assert_array_equal(np.asarray(jkv.page_table),
                                  tkv.page_table.numpy())
    np.testing.assert_array_equal(np.asarray(jkv.lengths), tkv.lengths.numpy())
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jkv.alloc, f)),
                                      getattr(tkv.alloc, f).numpy(),
                                      err_msg=f)


def _lockstep(models, traffic, *, batch_slots, max_len=64, page_size=8,
              jax_kw=None, port_kw=None):
    jmodel, jparams, tmodel, tparams = models
    jeng = JaxEngine(jmodel, jparams, batch_slots=batch_slots,
                     max_len=max_len, page_size=page_size, **(jax_kw or {}))
    teng = ServingEngine(tmodel, tparams, batch_slots=batch_slots,
                         max_len=max_len, page_size=page_size, device="cpu",
                         **(port_kw or {}))
    jr = [jeng.submit(p, max_new=n) for p, n in traffic]
    tr = [teng.submit(p, max_new=n) for p, n in traffic]
    assert jr == tr
    ticks = 0
    while jeng.queue or any(s.request_id >= 0 for s in jeng.slots):
        jeng.step()
        teng.step()
        ticks += 1
        _same_kv(jeng.kv, teng.kv)
        assert [s.request_id for s in jeng.slots] == \
            [s.request_id for s in teng.slots]
    assert not teng.queue and all(s.request_id < 0 for s in teng.slots)
    assert teng.finished == jeng.finished
    if jeng.spill_q is not None:
        assert teng.spill_acks == jeng.spill_acks
        assert teng.recompute_on_readmit == jeng.recompute_on_readmit
    return teng, tr, ticks


def _greedy_contiguous(tmodel, tparams, prompt, max_new):
    """The port's contiguous-cache greedy decode (tests/test_serving.py's
    _greedy_reference)."""
    cache = tmodel.init_cache(1, 128)
    for t in prompt[:-1]:
        _, cache = tmodel.decode_step(tparams, cache, torch.tensor([t]))
    out, cur = [], prompt[-1]
    for _ in range(max_new):
        lg, cache = tmodel.decode_step(tparams, cache, torch.tensor([cur]))
        cur = int(torch.argmax(lg[0]))
        out.append(cur)
    return out


def test_engine_matches_jax_engine_mixed_lengths(models):
    """tests/test_serving.py: two prompts on three slots, then four mixed
    lengths on two slots (continuous batching, slot refill)."""
    _, _, tmodel, tparams = models
    teng, rids, _ = _lockstep(models, [([5, 17, 42, 7], 6), ([9, 3], 4)],
                              batch_slots=3)
    assert teng.finished[rids[0]] == _greedy_contiguous(
        tmodel, tparams, [5, 17, 42, 7], 6)
    traffic = [([3, 1], 7), ([9, 9, 9, 2], 3), ([5], 5), ([8, 2, 4], 6)]
    teng, rids, _ = _lockstep(models, traffic, batch_slots=2)
    for rid, (prompt, n) in zip(rids, traffic):
        assert teng.finished[rid] == _greedy_contiguous(tmodel, tparams,
                                                        prompt, n)


def test_engine_slot_reuse_matches_jax_engine(models):
    """A released slot must not leak KV into the next request."""
    _, _, tmodel, tparams = models
    teng, rids, _ = _lockstep(models, [([7, 7, 7, 7, 7], 3), ([11, 23, 4], 5)],
                              batch_slots=1)
    assert teng.finished[rids[1]] == _greedy_contiguous(
        tmodel, tparams, [11, 23, 4], 5)


def test_engine_page_crossings_match_jax_engine(models):
    """Requests long enough to cross several 8-token pages on every slot."""
    traffic = [([1 + i for i in range(11)], 9), ([4, 2], 15),
               ([6] * 17, 3), ([2, 5, 8], 10)]
    _, _, ticks = _lockstep(models, traffic, batch_slots=2)
    assert ticks > 20


def test_paged_cache_allocator_lifecycle():
    cfg = jcfg_to_port(CONFIGS["llama3.2-3b"].reduced())
    kv = kvcache.paged_cache_init(cfg, batch_slots=2, max_len=64, page_size=8,
                                  device="cpu")
    active = torch.tensor([True, True])
    kv = kvcache.ensure_pages(kv, active)
    assert kv.alloc.count.tolist() == [1, 1]
    kv = kvcache.advance(kv, active)
    kv = kvcache.ensure_pages(kv, active)
    assert kv.alloc.count.tolist() == [1, 1]
    for _ in range(7):
        kv = kvcache.advance(kv, active)
    kv = kvcache.ensure_pages(kv, active)
    assert kv.alloc.count.tolist() == [2, 2]
    assert kvcache.live_pages(kv, 0).tolist() == [0]
    kv = kvcache.advance(kv, active)
    assert kvcache.live_pages(kv, 0).tolist() == [0, 1]
    kv = kvcache.release_slots(kv, torch.tensor([True, False]))
    assert int(kv.alloc.count[0]) == 0 and int(kv.alloc.watermark[0]) == 0
    assert kv.lengths.tolist() == [0, 9]


def test_inactive_slots_write_nothing():
    """An inactive slot whose (page, offset) collides with an active
    slot's must not disturb the active write; with no active slot nothing
    changes."""
    cfg = jcfg_to_port(CONFIGS["llama3.2-3b"].reduced())
    kv = kvcache.paged_cache_init(cfg, batch_slots=3, max_len=16, page_size=8,
                                  device="cpu")
    kv.k_pages.normal_()
    kv.v_pages.normal_()
    before_k, before_v = kv.k_pages.clone(), kv.v_pages.clone()
    shape = (3, cfg.num_kv_heads, cfg.resolved_head_dim)
    k, v = torch.randn(shape), torch.randn(shape)
    kvcache.write_token_kv(
        kv, 1, k, v, kvcache.token_slots(kv, torch.tensor([False] * 3)))
    assert torch.equal(kv.k_pages, before_k) and torch.equal(kv.v_pages,
                                                             before_v)
    # slots 0 and 2 both point at page 0 offset 0; only slot 2 is active
    kvcache.write_token_kv(
        kv, 1, k, v, kvcache.token_slots(kv, torch.tensor([False, False,
                                                           True])))
    assert torch.equal(kv.k_pages[1, 0, 0], k[2])
    assert torch.equal(kv.v_pages[1, 0, 0], v[2])
    before_k[1, 0, 0] = k[2]
    assert torch.equal(kv.k_pages, before_k)


def test_serve_cli_tiny_preset_on_cpu(capsys):
    """The serve CLI answers its requests on the CPU when told so; seed
    and max_len are fixed, as in the JAX CLI."""
    from repro_torch.launch import serve
    serve.main(["--preset", "tiny", "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    streams = [ast.literal_eval(line.split(": ", 1)[1])
               for line in out.splitlines()
               if line.startswith("[serve] request")]
    assert len(streams) == 3
    assert all(len(s) == 4 and all(0 <= t < 512 for t in s) for s in streams)
    assert "3 requests, 12 tokens" in out
    for flag in ("--seed", "--max-len"):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu", flag, "1"])


# ---------------------------------------------------------------------------
# Page spill (tests/test_serving.py's spill cases) and release_slot
# ---------------------------------------------------------------------------

def _spill_pair(models, traffic, make_sink, *, batch_slots, max_len=64,
                **kw):
    """Both engines with a sink each (``make_sink(log)``), run in
    lock-step: the sinks' calls, the acks, ``recompute_on_readmit`` and
    the streams must be equal.  Returns the port's engine and its log."""
    import warnings
    logs = {"jax": [], "port": []}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        teng, rids, _ = _lockstep(
            models, traffic, batch_slots=batch_slots, max_len=max_len,
            jax_kw=dict(spill_sink=make_sink(logs["jax"]), **kw),
            port_kw=dict(spill_sink=make_sink(logs["port"]), **kw))
    assert logs["port"] == logs["jax"] and logs["port"]
    return teng, rids, logs["port"]


def _recording(log, ret=None):
    def sink(rid, n_tokens, pages):
        log.append((int(rid), int(n_tokens), np.asarray(pages).tolist()))
        return ret(rid, pages) if ret else None
    return sink


def test_spill_sink_receives_page_ids_as_jax_engine(models):
    """tests/test_serving.py: each retiring request ships its live page
    ids and token count (prompt + generated - 1) before its slot is
    released, acked with the page count."""
    teng, rids, log = _spill_pair(
        models, [([5, 17, 42, 7], 6), ([9, 3], 13)], _recording,
        batch_slots=2)
    by_rid = {rid: (n, pages) for rid, n, pages in log}
    assert by_rid[rids[0]][0] == 9 and len(by_rid[rids[0]][1]) == 2
    assert by_rid[rids[1]][0] == 14 and len(by_rid[rids[1]][1]) == 2
    assert teng.spill_acks == {rid: len(p) for rid, (_, p) in by_rid.items()}
    assert teng.drain_spill_acks() and teng.spill_acks == {}


def test_spill_ack_carries_sink_return_as_jax_engine(models):
    """The sink's return value is the ack; a non-scalar return is cut to
    its first word, as JAX's drain coerces it."""
    teng, rids, _ = _spill_pair(
        models, [([4, 2], 3)],
        lambda log: _recording(log, lambda rid, p: 1000 + int(rid)),
        batch_slots=1, max_len=32)
    assert teng.spill_acks == {rids[0]: 1000 + rids[0]}
    teng, rids, log = _spill_pair(
        models, [([4, 2], 3)],
        lambda log: _recording(log, lambda rid, p: p), batch_slots=1,
        max_len=32)
    assert teng.spill_acks == {rids[0]: log[0][2][0]}


def _flaky(fail_first):
    def make(log):
        calls = {}

        def sink(rid, n_tokens, pages):
            rid = int(rid)
            calls[rid] = calls.get(rid, 0) + 1
            log.append((rid, calls[rid]))
            if calls[rid] <= fail_first(rid):
                raise RuntimeError("spill store hiccup")
            return rid + 500
        return sink
    return make


def test_spill_flaky_sink_is_retried_as_jax_engine(models):
    """A sink that fails its first delivery is redriven by the carry:
    the ack lands and nothing degrades (spill_retries=2)."""
    teng, rids, log = _spill_pair(
        models, [([4, 2], 3), ([6, 1, 3], 2), ([2], 4)],
        _flaky(lambda rid: 1 if rid % 2 else 0), batch_slots=2,
        max_len=32, spill_retries=2)
    assert teng.spill_acks == {r: r + 500 for r in rids}
    assert teng.recompute_on_readmit == set()
    assert sorted(c for r, c in log if r == rids[1]) == [1, 2]


def test_spill_dead_sink_degrades_to_recompute_as_jax_engine(models):
    """A sink that always fails exhausts the budget: a None ack and the
    request in recompute_on_readmit; decoding is unaffected."""
    teng, rids, _ = _spill_pair(
        models, [([4, 2], 3)], _flaky(lambda rid: 99), batch_slots=1,
        max_len=32, spill_retries=1)
    assert teng.spill_acks == {rids[0]: None}
    assert teng.recompute_on_readmit == {rids[0]}
    assert len(teng.finished[rids[0]]) == 3


def test_spill_disabled_by_default():
    cfg = jcfg_to_port(CONFIGS["llama3.2-3b"].reduced())
    tmodel = build_model(cfg, device="cpu")
    teng = ServingEngine(tmodel, tmodel.init(seed=0), batch_slots=1,
                         max_len=32, page_size=8, device="cpu")
    assert teng.spill_q is None
    teng.submit([3, 1], max_new=2)
    assert len(teng.run_until_drained()[0]) == 2


def test_release_slot_matches_jax():
    """release_slot resets one chunk and zeroes its row and length, as
    the JAX cache's single-device release_slot does."""
    from repro.serving import kvcache as jkv
    jcfg = CONFIGS["llama3.2-3b"].reduced()
    jk = jkv.paged_cache_init(jcfg, 3, 64, page_size=8)
    tk = kvcache.paged_cache_init(jcfg_to_port(jcfg), 3, 64, page_size=8,
                                  device="cpu")
    act = np.array([True, True, False])
    for _ in range(11):
        jk = jkv.advance(jkv.ensure_pages(jk, jax.numpy.asarray(act)),
                         jax.numpy.asarray(act))
        tk = kvcache.advance(kvcache.ensure_pages(tk, torch.from_numpy(act)),
                             torch.from_numpy(act))
    _same_kv(jk, tk)
    for slot in (1, 2, 0):
        jk = jkv.release_slot(jk, slot)
        tk = kvcache.release_slot(tk, slot)
        _same_kv(jk, tk)
    assert tk.lengths.tolist() == [0, 0, 0]
