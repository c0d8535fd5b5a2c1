"""Port's decode kernels on the CPU: the plain PyTorch versions (and the
plain twin of the kernels' split-and-merge, under the wrappers' split plan)
against the JAX references and the Pallas kernels in interpret mode, on the
same inputs (numpy, seeded).  Tolerances are those of tests/test_kernels.py: fp32 2e-5,
bf16 3e-2 (bf16 rounds p and the output at different places in the two
frameworks)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_reference  # noqa: E402
from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_decode_attention_pallas)
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_attention_reference)
from repro_torch.kernels import (decode_heads_per_block,  # noqa: E402
                                 split_plan)
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_reference as t_decode_ref)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_split_reference as t_split_ref)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.paged_attention.kernel import (  # noqa: E402
    paged_attention_cuda)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_attention_reference as t_paged_ref)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


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


@pytest.mark.parametrize("B,T,Hq,Hkv,D", [(3, 256, 4, 2, 32), (2, 128, 8, 8, 16),
                                          (2, 64, 4, 1, 64), (2, 64, 8, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_vs_jax(B, T, Hq, Hkv, D, dtype):
    """Sweep of tests/test_kernels.py plus G=4 at D=128 (llama3.2-3b's
    padded grouping)."""
    rng = np.random.default_rng(B * 1000 + T + D)
    q = _arr(rng, (B, Hq, D), dtype)
    k = _arr(rng, (B, T, Hkv, D), dtype)
    v = _arr(rng, (B, T, Hkv, D), dtype)
    lengths = np.asarray([T, max(T // 3, 1), 7][:B], np.int32)
    out = decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    assert out.dtype == _t(q).dtype and out.shape == (B, Hq, D)
    ref = decode_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths))
    _close(out, ref, dtype)
    pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     blk_t=32, interpret=True)
    _close(out, pallas, dtype)


def test_decode_plain_window_vs_jax():
    rng = np.random.default_rng(1)
    B, T, Hq, Hkv, D = 2, 128, 4, 2, 16
    q, k, v = (_arr(rng, s, "float32") for s in
               ((B, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    lengths = np.asarray([100, 33], np.int32)
    out = decode_attention(_t(q), _t(k), _t(v), _t(lengths), window=24)
    ref = decode_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     window=24)
    _close(out, ref, "float32")
    pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     window=24, blk_t=32, interpret=True)
    _close(out, pallas, "float32")


def test_decode_plain_length_zero_is_zero():
    """lengths == 0 gives 0, as the Pallas kernel gives (the JAX reference
    averages masked entries instead)."""
    rng = np.random.default_rng(2)
    q, k, v = (_arr(rng, s, "float32") for s in
               ((2, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    lengths = np.asarray([0, 5], np.int32)
    out = decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    assert torch.all(out[0] == 0)
    pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     blk_t=32, interpret=True)
    _close(out, pallas, "float32")


@pytest.mark.parametrize("B,NP,page,Hkv,G,D,maxp", [
    (3, 24, 16, 2, 2, 32, 6),        # tests/test_kernels.py
    (3, 40, 8, 2, 2, 16, 10),        # page size 8 (examples/quickstart.py)
    (2, 16, 16, 2, 4, 128, 4),       # G=4, D=128
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_vs_jax(B, NP, page, Hkv, G, D, maxp, dtype):
    """Includes FAIL (-1) ids inside and past the length and garbage ids
    past the length: both versions clip ids to [0, NP-1] and mask by
    length."""
    rng = np.random.default_rng(NP + page + D)
    Hq = Hkv * G
    q = _arr(rng, (B, Hq, D), dtype)
    kp = _arr(rng, (NP, page, Hkv, D), dtype)
    vp = _arr(rng, (NP, page, Hkv, D), dtype)
    table = rng.permutation(NP)[:B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.asarray([maxp * page, page + 1, 3][:B], np.int32)
    table[1, 2:] = [-1, 10 ** 6][: maxp - 2] + [NP + 5] * (maxp - 4)
    table[0, -1] = -1                # a FAIL id inside the length
    table[-1, -1] = -1
    out = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(lengths))
    ref = paged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths))
    _close(out, ref, dtype)
    pallas = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), interpret=True)
    _close(out, pallas, dtype)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """Dispatch is by device: a CPU tensor never reaches the kernel."""
    def boom(*a, **k):
        raise AssertionError("kernel called for a CPU tensor")

    import repro_torch.kernels.decode_attention.ops as dops
    import repro_torch.kernels.paged_attention.ops as pops
    monkeypatch.setattr(dops, "decode_attention_cuda", boom)
    monkeypatch.setattr(pops, "paged_attention_cuda", boom)
    rng = np.random.default_rng(3)
    q, k = _t(_arr(rng, (1, 2, 16), "float32")), \
        _t(_arr(rng, (1, 8, 1, 16), "float32"))
    lengths = torch.tensor([8], dtype=torch.int32)
    torch.testing.assert_close(dops.decode_attention(q, k, k, lengths),
                               t_decode_ref(q, k, k, lengths))
    table = torch.zeros((1, 1), dtype=torch.int32)
    pages = k.reshape(1, 8, 1, 16)
    torch.testing.assert_close(
        pops.paged_decode_attention(q, pages, pages, table, lengths),
        t_paged_ref(q, pages, pages, table, lengths))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch on CUDA tensors or raise; they never fall
    back to the plain version."""
    q = torch.zeros((1, 2, 16))
    k = torch.zeros((1, 8, 1, 16))
    lengths = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q, k, k, lengths)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q, k, k, torch.zeros((1, 1), dtype=torch.int32),
                             lengths)
    assert decode_attention_cuda.launches == 0
    assert paged_attention_cuda.launches == 0


# -- the decode split plan and its plain twin ---------------------------------

def test_split_plan_keeps_the_llama_serve_plan():
    """llama3.2-3b's serve shape (4 slots, 8 KV heads of 4 query heads,
    cap 512, bf16) on 132 SMs: the one-launch kernel's plan is 8 splits of
    64 tokens, one tensor-core tile (the card fill alone gives 16 of 32);
    at the long shape (8 rows of 4096) it spreads a row over 16 splits of
    256 tokens (the card fill alone gives 8 of 512)."""
    assert decode_heads_per_block(torch.bfloat16, 128, 4) == 4
    assert split_plan(132, 4, 8, 4, 512, 2, 1) == (64, 8)
    assert split_plan(132, 8, 8, 4, 4096, 2, 1) == (256, 16)


@pytest.mark.parametrize("dtype,heads", [(torch.bfloat16, 16),
                                         (torch.float32, 4)])
def test_split_plan_bounds_the_partials_at_the_hybrid_shape(dtype, heads):
    """recurrentgemma-9b's decode shape (B 2, 1 KV head of 16 query heads,
    D 256, a 2048-slot ring): the fp32 partials (n_splits x G x D x 4
    bytes a row) stay within 1/8 of the K/V bytes the row reads
    (T x D x 2 x element size), and the head chunks count as blocks."""
    B, Hkv, G, D, T = 2, 1, 16, 256, 2048
    es = dtype.itemsize
    assert decode_heads_per_block(dtype, D, G) == heads
    split, n = split_plan(132, B, Hkv, G, T, es, -(-G // heads))
    assert n * split >= T > (n - 1) * split
    assert n * G * D * 4 <= T * D * 2 * es / 8
    assert (split, n) == ((128, 16) if dtype == torch.bfloat16 else (64, 32))


@pytest.mark.parametrize("sms,B,Hkv,G,cap,es,chunks", [
    (132, 4, 8, 4, 512, 2, 1), (132, 8, 8, 4, 4096, 2, 1),
    (132, 2, 1, 16, 2048, 2, 1), (132, 2, 1, 16, 2048, 4, 4),
    (132, 3, 2, 2, 256, 4, 1), (16, 1, 1, 32, 100, 2, 2),
    (132, 64, 8, 8, 33, 2, 1)])
def test_split_plan_splits_are_multiples_of_32(sms, B, Hkv, G, cap, es,
                                               chunks):
    split, n = split_plan(sms, B, Hkv, G, cap, es, chunks)
    assert split % 32 == 0 and split >= 32
    assert n == -(-cap // split)


def _ragged_case(seed, B, T, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    return (_arr(rng, (B, Hq, D), dtype), _arr(rng, (B, T, Hkv, D), dtype),
            _arr(rng, (B, T, Hkv, D), dtype))


@pytest.mark.parametrize("lens,window,split", [
    ([2048, 1, 0], 2048, 128),       # full cap, one token, none
    ([2048, 1500, 700], 100, 128),   # splits empty before the window
    ([2048, 900, 33], None, 64),     # the fp32 plan at this shape
], ids=["full_one_zero", "empty_before_window", "fp32_plan"])
def test_split_twin_matches_reference_and_pallas(lens, window, split):
    """The plain split-and-merge twin at G 16, D 256 over a 2048-slot
    cache, against the plain version and the JAX Pallas kernel in
    interpret mode (fp32, 2e-5)."""
    B, T, Hq, Hkv, D = 3, 2048, 16, 1, 256
    q, k, v = _ragged_case(7, B, T, Hq, Hkv, D, "float32")
    lengths = np.asarray(lens, np.int32)
    twin = t_split_ref(_t(q), _t(k), _t(v), _t(lengths), split_len=split,
                       window=window)
    plain = t_decode_ref(_t(q), _t(k), _t(v), _t(lengths), window=window)
    _close(twin, plain.numpy(), "float32")
    pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     window=window, blk_t=512,
                                     interpret=True)
    # Pallas averages nothing for a row of length 0 either: both give 0
    _close(twin, pallas, "float32")
    if 0 in lens:
        assert not twin[lens.index(0)].any()


def test_split_twin_rounds_p_like_the_kernels_in_bf16():
    """bf16 at the hybrid shape: the twin (p rounded to bf16 before P V, as
    the kernels round it) within 3e-2 of the plain version."""
    B, T, Hq, Hkv, D = 2, 2048, 16, 1, 256
    q, k, v = _ragged_case(8, B, T, Hq, Hkv, D, "bfloat16")
    lengths = np.asarray([2048, 700], np.int32)
    twin = t_split_ref(_t(q), _t(k), _t(v), _t(lengths), split_len=128)
    assert twin.dtype == torch.bfloat16
    _close(twin, t_decode_ref(_t(q), _t(k), _t(v), _t(lengths)).float()
           .numpy(), "bfloat16")
