"""The plain reference against itself at a tiny size: batching sequences
changes nothing, positions are causal, each block choice shows, and the
float8 control differs from float32."""
import copy

import pytest
import torch

from harness import common, modelcfg
from reference import decoder

BENCH = common.load_benchmark()


def _tiny(name):
    c = next(c for c in BENCH["configs"] if c["name"] == name)
    conf = modelcfg.rehearsal(common.load_json(common.ROOT / c["file"]))
    conf["torch_dtype"] = "float32"
    return conf


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_batching_and_causality(name):
    conf = _tiny(name)
    w = modelcfg.make_weights(conf, 3, "cpu")
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(1, conf["vocab_size"], (n,), generator=g).tolist()
            for n in (5, 9, 2)]
    wanted = [list(range(len(s))) for s in seqs]
    together = decoder.logits_at(conf, w, seqs, wanted)
    for s, p, t in zip(seqs, wanted, together):
        alone, = decoder.logits_at(conf, w, [s], [p])
        torch.testing.assert_close(alone, t, rtol=1e-5, atol=1e-5)
    # a longer sequence leaves the earlier positions' logits alone
    longer, = decoder.logits_at(conf, w, [seqs[1] + [3, 4]], [wanted[1]])
    torch.testing.assert_close(longer, together[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_each_leaf_counts_and_the_control_differs(name):
    conf = _tiny(name)
    w = modelcfg.make_weights(conf, 4, "cpu")
    seq = [[5, 9, 11, 3, 7, 2]]
    pos = [list(range(6))]
    base, = decoder.logits_at(conf, w, seq, pos)
    for key in w:
        w2 = copy.copy(w)
        w2[key] = w[key] * 1.5 + 0.01
        moved, = decoder.logits_at(conf, w2, seq, pos)
        assert not torch.allclose(moved, base, atol=1e-4), key
    ctrl, = decoder.logits_at(conf, w, seq, pos, quant="fp8")
    assert (ctrl - base).abs().max() > 1e-3


def test_unknown_block_is_refused():
    conf = _tiny(BENCH["configs"][0]["name"])
    conf["harness"] = dict(conf["harness"], norm="layernorm")
    w = modelcfg.make_weights(conf, 1, "cpu")
    with pytest.raises(ValueError):
        decoder.logits_at(conf, w, [[1, 2]], [[0]])
