"""The one-launch decode kernel's plan on the CPU: its arrival count (the
splits of a row that hold a valid token, which the kernel's last-arriving
block waits for) against a brute-force count, the split plan at G <= 8, and
the plain split-and-merge twin at llama3.2-3b's decode shape (G 4, D 128,
cap 512) against the plain version and the JAX Pallas kernel in interpret
mode.  Tolerances are those of tests/test_kernels.py: fp32 2e-5, bf16
3e-2."""
import random

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro_torch.kernels import (_MAX_SPLIT, _MIN_SPLIT,  # noqa: E402
                                 decode_arrivals, decode_heads_per_block,
                                 split_plan)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_reference, decode_attention_split_reference)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _brute_arrivals(length, cap, window, split_len):
    """The splits that hold a token t < cap with t < length and, under a
    window, t >= length - window."""
    return len({t // split_len for t in range(cap)
                if t < length and (not window or t >= length - window)})


# -- (a) the arrival count --------------------------------------------------

@pytest.mark.parametrize("cap,split_len", [(512, 32), (512, 128), (4096, 128),
                                           (100, 32), (2048, 64), (33, 32)])
@pytest.mark.parametrize("window", [None, 1, 24, 64, 2048])
def test_arrivals_match_a_brute_force_count(cap, split_len, window):
    """Lengths 0, negative, 1, within one split, at split edges, at cap and
    past cap (by less and by more than the window)."""
    lengths = {-5, 0, 1, 2, split_len - 1, split_len, split_len + 1,
               cap // 2, cap - 1, cap, cap + 1, cap + 63, cap + 64,
               cap + 65, cap + 4096}
    for n in sorted(lengths):
        assert decode_arrivals(n, cap, window, split_len) == \
            _brute_arrivals(n, cap, window, split_len), (n, cap, window)


def _check_arrivals(length, cap, window, split_len):
    assert decode_arrivals(length, cap, window, split_len) == \
        _brute_arrivals(length, cap, window, split_len)


if HAVE_HYPOTHESIS:
    @settings(max_examples=200, deadline=None)
    @given(st.integers(-8, 700), st.integers(1, 600),
           st.one_of(st.none(), st.integers(1, 700)),
           st.sampled_from([32, 64, 96, 128, 256]))
    def test_arrivals_property(length, cap, window, split_len):
        _check_arrivals(length, cap, window, split_len)
else:
    @pytest.mark.parametrize("seed", range(20))
    def test_arrivals_property(seed):
        r = random.Random(seed)
        for _ in range(10):
            _check_arrivals(r.randint(-8, 700), r.randint(1, 600),
                            r.choice([None, r.randint(1, 700)]),
                            r.choice([32, 64, 96, 128, 256]))


# -- (b) the split plan at G <= 8 -------------------------------------------

@pytest.mark.parametrize("sms,B,Hkv,G,cap,es,chunks", [
    (132, 4, 8, 4, 512, 2, 1),       # llama3.2-3b serve, bf16
    (132, 4, 8, 4, 512, 4, 1),       # ... fp32
    (132, 8, 8, 4, 4096, 2, 1),      # the long shape
    (132, 8, 8, 4, 4096, 4, 1),
    (132, 32, 8, 4, 8192, 2, 1),     # 32 slots up to 8192 tokens
    (132, 2, 8, 8, 100000, 2, 1),    # a cap far past the card's fill
    (132, 3, 2, 2, 256, 4, 1),
    (132, 1, 1, 1, 33, 2, 1),
    (132, 64, 8, 8, 33, 2, 1),
    (16, 1, 1, 8, 100, 4, 1),
    (132, 2, 4, 8, 2048, 4, 2),      # fp32 at D 256: head chunks of 4
])
def test_plan_at_g8_covers_cap_in_multiples_of_32(sms, B, Hkv, G, cap, es,
                                                  chunks):
    """The splits cover cap, are multiples of 32 of ``_MIN_SPLIT`` to
    ``_MAX_SPLIT`` tokens (or the partial bound's length, if longer), and
    keep each split's fp32 partial (G x D x 4 bytes) within 1/8 of its K/V
    bytes (split x D x 2 x element size)."""
    split, n = split_plan(sms, B, Hkv, G, cap, es, chunks)
    assert split % 32 == 0 and split >= _MIN_SPLIT
    assert n * split >= cap > (n - 1) * split
    D = 128
    assert G * D * 4 <= split * D * 2 * es / 8
    assert split <= max(_MAX_SPLIT, -(-16 * G // es // 32) * 32)


@pytest.mark.parametrize("B,cap,plan", [(4, 512, (64, 8)),
                                         (8, 4096, (256, 16)),
                                         (32, 8192, (256, 32))],
                         ids=["serve", "long", "long_b32"])
def test_plan_at_g8_spreads_long_rows(B, cap, plan):
    """llama's serve shape takes one 64-token tile a split (the card fill
    alone would give 32); at the long shape (B 8, 8 KV heads of 4, 4096
    tokens, bf16) and at 32 slots of 8192 the card fill alone would give
    splits of 512 and 4096: the G <= 8 plan spreads a row over splits of
    256."""
    assert split_plan(132, B, 8, 4, cap, 2, 1) == plan


# -- (c) the split twin at llama3.2-3b's decode shape -----------------------

def _arr(rng, shape, dtype):
    return rng.standard_normal(shape).astype(np.float32).astype(NP_DT[dtype])


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(out, ref, dtype):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


#: lengths 0, 1, 216 (the serve shape's longest) and the full cap
LLAMA_LENS = [0, 1, 216, 512]


def _llama_case(seed, dtype):
    B, T, Hq, Hkv, D = 4, 512, 8, 2, 128        # G 4, D 128, cap 512
    rng = np.random.default_rng(seed)
    return (_arr(rng, (B, Hq, D), dtype), _arr(rng, (B, T, Hkv, D), dtype),
            _arr(rng, (B, T, Hkv, D), dtype),
            np.asarray(LLAMA_LENS, np.int32))


@pytest.mark.parametrize("split", [32, 64, 256],
                         ids=["fill_only", "serve_plan", "max_split"])
@pytest.mark.parametrize("window", [None, 64])
def test_split_twin_at_llama_shape_matches_plain_and_pallas(split, window):
    """fp32: the twin under the serve plan (64-token splits), under the
    longest G <= 8 split and under the card fill's 32, against the plain
    version and the Pallas kernel in interpret mode (2e-5); the row of
    length 0 is 0."""
    assert decode_heads_per_block(torch.float32, 128, 4) == 4
    assert split in (32, split_plan(132, 4, 8, 4, 512, 2, 1)[0], _MAX_SPLIT)
    q, k, v, lengths = _llama_case(11, "float32")
    twin = decode_attention_split_reference(_t(q), _t(k), _t(v), _t(lengths),
                                            split_len=split, window=window)
    plain = decode_attention_reference(_t(q), _t(k), _t(v), _t(lengths),
                                       window=window)
    _close(twin, plain.numpy(), "float32")
    pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     window=window, blk_t=128, interpret=True)
    _close(twin, pallas, "float32")
    assert not twin[LLAMA_LENS.index(0)].any()


@pytest.mark.parametrize("split", [32, 64, 256],
                         ids=["fill_only", "serve_plan", "max_split"])
@pytest.mark.parametrize("window", [None, 64])
def test_split_twin_at_llama_shape_in_bf16(split, window):
    """bf16: the twin (p rounded to bf16 before P V, as the kernel rounds
    it) within 3e-2 of the plain version."""
    q, k, v, lengths = _llama_case(12, "bfloat16")
    twin = decode_attention_split_reference(_t(q), _t(k), _t(v), _t(lengths),
                                            split_len=split, window=window)
    assert twin.dtype == torch.bfloat16
    plain = decode_attention_reference(_t(q), _t(k), _t(v), _t(lengths),
                                       window=window)
    _close(twin, plain.float().numpy(), "bfloat16")
    assert not twin[LLAMA_LENS.index(0)].any()
