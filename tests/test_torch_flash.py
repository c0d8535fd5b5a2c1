"""The port's flash-attention op on the CPU (its plain versions) against the
JAX package: the Pallas kernel in interpret mode over the divisible sweep
of tests/test_kernels.py, the dense reference at ragged Sq/Sk, the chunked
reference above the op's threshold, the q/k/v gradients against
``jax.vjp`` of the JAX op, and the CUDA wgmma and fp32 kernels' algorithm
in plain PyTorch (``attention_reference_tiled``: their tiles, their
classification and the exp2-domain softmax) against the JAX reference and
the Pallas kernel.

Tolerances: forward fp32 2e-5 and bf16 3e-2, those of tests/test_kernels.py
(the same arithmetic; sums run in another order).  Gradients fp32 1e-4:
the backward runs three products and the softmax's derivative, whose sums
over Sk run in another order in XLA and in PyTorch, so their rounding
differences add up to a few times the forward's.
Inputs come from numpy with a seed and go to both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference as j_ref, attention_reference_chunked as j_chunked)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    F32_TILES, WGMMA_TILES, flash_attention_cuda, flash_variant)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference_chunked as t_chunked,
    attention_reference_tiled as t_tiled, tile_plan)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-4
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here: with several test
    workers on the machine, waking eight threads per op costs more than
    the op (20 tiny training steps: ~30x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32))


def _both(arrs, dtype):
    """numpy fp32 arrays -> (jax arrays, torch tensors) of ``dtype``."""
    j = [jnp.asarray(a).astype(J_DT[dtype]) for a in arrs]
    t = [torch.from_numpy(a).to(T_DT[dtype]) for a in arrs]
    return j, t


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,blk", [
    (1, 128, 4, 4, 32, 64),      # G = 1
    (2, 256, 4, 2, 64, 64),      # G = 2
    (1, 128, 8, 2, 16, 64),      # G = 4, as llama3.2-3b at full width
    (2, 128, 8, 1, 16, 32),      # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_flash_op_vs_pallas_interpret(B, S, Hq, Hkv, D, blk, dtype, causal,
                                      window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S + D, B, S, S, Hq, Hkv, D),
                                       dtype)
    ref = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                 blk_q=blk, blk_k=blk, interpret=True)
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == T_DT[dtype] and out.shape == tq.shape
    _close(out, ref, TOL[dtype])


def test_flash_op_q_offset_vs_pallas_interpret():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 1, 64, 128, 2, 2, 16),
                                       "float32")
    ref = flash_attention_pallas(jq, jk, jv, causal=True, q_offset=64,
                                 blk_q=32, blk_k=32, interpret=True)
    _close(flash_attention(tq, tk, tv, causal=True, q_offset=64), ref,
           TOL["float32"])


@pytest.mark.parametrize("Sq,Sk,kw", [
    (100, 100, dict(causal=True)),
    (77, 77, dict(causal=False)),
    (1000, 1000, dict(causal=True, window=128)),
    (37, 100, dict(causal=True, q_offset=63)),
    (5, 9, dict(causal=True, window=3, q_offset=4)),
])
def test_flash_op_ragged_vs_reference(Sq, Sk, kw):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(Sq * 7 + Sk, 1, Sq, Sk, 4, 2, 16),
                                       "float32")
    _close(flash_attention(tq, tk, tv, **kw), j_ref(jq, jk, jv, **kw),
           TOL["float32"])


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=37),
                                dict(causal=False),
                                dict(causal=True, q_offset=64)])
def test_chunked_reference_vs_jax(kw):
    Sk = 256 + kw.get("q_offset", 0)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 2, 256, Sk, 4, 2, 16),
                                       "float32")
    _close(t_chunked(tq, tk, tv, blk_q=64, blk_k=64, **kw),
           j_chunked(jq, jk, jv, blk_q=64, blk_k=64, **kw), TOL["float32"])


def test_flash_op_above_threshold_takes_chunked(monkeypatch):
    """1024 x 5120 scores > 1 << 22: the op's plain path is the chunked one,
    as the JAX op's XLA path is."""
    Sq, Sk = 1024, 5120
    assert Sq * Sk > t_ops._CHUNKED_THRESHOLD
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 1, Sq, Sk, 2, 1, 16),
                                       "float32")
    calls = []
    real = t_ops.attention_reference_chunked
    monkeypatch.setattr(t_ops, "attention_reference_chunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = flash_attention(tq, tk, tv, causal=True, q_offset=Sk - Sq)
    assert calls
    _close(out, j_chunked(jq, jk, jv, causal=True, q_offset=Sk - Sq),
           TOL["float32"])


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,kw", [
    (2, 64, 64, 4, 2, dict(causal=True)),
    (1, 48, 48, 8, 2, dict(causal=True, window=16)),
    (2, 40, 40, 4, 4, dict(causal=False)),
    (1, 24, 72, 4, 1, dict(causal=True, q_offset=48)),
    (1, 512, 9216, 2, 1, dict(causal=True, q_offset=8704)),   # chunked
])
def test_flash_op_gradients_vs_jax_vjp(B, Sq, Sk, Hq, Hkv, kw):
    arrs = _qkv(Sq + Sk, B, Sq, Sk, Hq, Hkv, 16)
    g = np.random.default_rng(99).standard_normal(arrs[0].shape,
                                                  dtype=np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    out, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, **kw), jq, jk, jv)
    jgrads = vjp(jnp.asarray(g))
    tqkv = [t.requires_grad_() for t in (tq, tk, tv)]
    tout = flash_attention(*tqkv, **kw)
    _close(tout, out, TOL["float32"])
    tgrads = torch.autograd.grad(tout, tqkv, torch.from_numpy(g))
    for t, j in zip(tgrads, jgrads):
        _close(t, j, GRAD_TOL)


def test_cpu_op_launches_nothing_and_kernel_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 16, 16, 2, 1, 16))
    before = flash_attention_cuda.launches
    flash_attention(q, k, v)
    assert flash_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_cuda(q, k, v)


# ---------------------------------------------------------------------------
# The wgmma kernel's algorithm (attention_reference_tiled, tile_plan) and
# the wrapper's choice of variant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,B,Sq,Sk,Hq,Hkv,kw", [
    (64, 1, 300, 300, 4, 1, dict(causal=True)),
    (64, 2, 77, 333, 2, 2, dict(causal=False)),
    (64, 1, 300, 300, 4, 2, dict(causal=True, window=100)),
    (128, 1, 37, 300, 4, 2, dict(causal=True, q_offset=263)),
    (128, 1, 200, 515, 2, 1, dict(causal=True, window=150, q_offset=315)),
    (256, 1, 200, 333, 2, 1, dict(causal=True, window=70, q_offset=133)),
    (256, 1, 150, 150, 4, 1, dict(causal=True)),
    (128, 1, 5, 9, 2, 1, dict(causal=True, window=3, q_offset=4)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_reference_vs_jax_reference_ragged(D, B, Sq, Sk, Hq, Hkv, kw,
                                                 dtype):
    """Sq and Sk not multiples of the kernel's tiles (128 query rows, 128
    keys; 64 at D 256), window on and off, q_offset > 0."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _qkv(Sq + 3 * Sk + D, B, Sq, Sk, Hq, Hkv, D), dtype)
    out = t_tiled(tq, tk, tv, **kw)
    assert out.dtype == T_DT[dtype] and out.shape == tq.shape
    _close(out, j_ref(jq, jk, jv, **kw), TOL[dtype])


@pytest.mark.parametrize("D,S,Hq,Hkv,kw", [
    (64, 256, 4, 2, dict(causal=True)),
    (64, 256, 4, 2, dict(causal=True, window=40)),
    (128, 256, 2, 1, dict(causal=False)),
    (256, 128, 2, 1, dict(causal=True, window=70)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_reference_vs_pallas_interpret(D, S, Hq, Hkv, kw, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S + D, 1, S, S, Hq, Hkv, D),
                                       dtype)
    ref = flash_attention_pallas(jq, jk, jv, blk_q=64, blk_k=64,
                                 interpret=True, **kw)
    _close(t_tiled(tq, tk, tv, **kw), ref, TOL[dtype])


def test_tiled_reference_q_offset_vs_pallas_interpret():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 1, 128, 320, 2, 1, 64),
                                       "bfloat16")
    ref = flash_attention_pallas(jq, jk, jv, causal=True, q_offset=192,
                                 blk_q=64, blk_k=64, interpret=True)
    _close(t_tiled(tq, tk, tv, causal=True, q_offset=192), ref,
           TOL["bfloat16"])


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_reference_blind_rows_vs_pallas_interpret(D, causal, dtype):
    """Rows past Sk by more than the window see no key.  With the Pallas
    kernel's blocks set to the wgmma kernel's tiles, both average the V of
    the tiles that a blind row's block visits (every masked score is -1e30,
    so each weighs 1) and write 0 where the block visits none."""
    bm, bn = WGMMA_TILES[D]
    Sq = Sk = 2 * bm
    window, q_offset = 64, 200
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(D, 1, Sq, Sk, 2, 1, D), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = t_tiled(tq, tk, tv, **kw)
    _close(out, flash_attention_pallas(jq, jk, jv, blk_q=bm, blk_k=bn,
                                       interpret=True, **kw), TOL[dtype])
    blind = q_offset + torch.arange(Sq) - window + 1 > Sk - 1
    running = torch.arange(Sq) < bm          # only the first block runs
    assert bool((blind & running).any()) and bool((blind & ~running).any())
    assert bool((out[:, blind & running].abs().amax(dim=-1) > 0).all())
    assert bool((out[:, ~running] == 0).all())


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (1024, 1024, True, None, 0),
    (1000, 1000, True, None, 0),
    (1024, 1024, True, 128, 0),
    (200, 712, True, None, 512),
    (333, 517, False, None, 0),
    (3072, 3072, True, 2048, 0),
    (777, 1800, True, 2048, 1023),
    (300, 300, False, 77, 0),
    (5, 9, True, 3, 4),
])
def test_tile_plan_full_tiles_visible_and_visible_pairs_visited(
        D, Sq, Sk, causal, window, q_offset):
    """Every tile classed full has all its (row, key) pairs visible and no
    key past Sk; every visible pair lies in a visited tile."""
    _check_tile_plan(*WGMMA_TILES[D], Sq, Sk, causal, window, q_offset)


def _check_tile_plan(bm, bn, Sq, Sk, causal, window, q_offset):
    qpos = q_offset + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    vis = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= kpos > qpos - window
    covered = torch.zeros_like(vis)
    for q0 in range(0, Sq, bm):
        rows = slice(q0, min(q0 + bm, Sq))
        for k0, kind in tile_plan(q0, Sq, Sk, bm, bn, causal, window,
                                  q_offset):
            assert kind in ("full", "edge")
            if kind == "full":
                assert k0 + bn <= Sk
                assert bool(vis[rows, k0:k0 + bn].all())
            covered[rows, k0:k0 + bn] = True
    assert bool(covered[vis].all())


# ---------------------------------------------------------------------------
# The fp32 kernel's algorithm at its own tiles (F32_TILES)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (1024, 1024, True, None, 0),
    (1000, 1000, True, None, 0),
    (1024, 1024, True, 128, 0),
    (200, 712, True, None, 512),
    (333, 517, False, None, 0),
    (3072, 3072, True, 2048, 0),
    (777, 1800, True, 2048, 1023),
    (300, 300, False, 77, 0),
    (5, 9, True, 3, 4),
])
def test_tile_plan_at_f32_tiles(D, Sq, Sk, causal, window, q_offset):
    """The fp32 kernel's tiles (64 query rows, 32 at D 256; 64 keys):
    full tiles all visible, every visible pair visited."""
    _check_tile_plan(*F32_TILES[D], Sq, Sk, causal, window, q_offset)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("case", ["causal", "window", "q_offset", "blind"])
def test_f32_tiled_reference_vs_pallas_interpret(D, case):
    """The fp32 kernel's twin, at its tiles, against the Pallas kernel in
    interpret mode with blocks equal to those tiles, fp32 2e-5: causal, a
    window, q_offset with Sq < Sk, and rows that see no key (q_offset 100,
    window 32 over 128 keys: rows from 59 see none; a blind row of a block
    that runs tiles averages their V, and the blocks from row 64 run no
    tile and are 0)."""
    bm, bn = F32_TILES[D]
    Sq, Sk, kw = {
        "causal": (128, 128, dict(causal=True)),
        "window": (128, 128, dict(causal=True, window=40)),
        "q_offset": (bm, 3 * bn, dict(causal=True, q_offset=128)),
        "blind": (128, 128, dict(causal=True, window=32, q_offset=100)),
    }[case]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(D + Sq + Sk, 1, Sq, Sk, 2, 1, D),
                                       "float32")
    out = t_tiled(tq, tk, tv, tiles=(bm, bn), **kw)
    _close(out, flash_attention_pallas(jq, jk, jv, blk_q=bm, blk_k=bn,
                                       interpret=True, **kw),
           TOL["float32"])
    if case == "blind":
        blind = kw["q_offset"] + torch.arange(Sq) - kw["window"] + 1 > Sk - 1
        running = torch.tensor([bool(tile_plan(i - i % bm, Sq, Sk, bm, bn,
                                               **kw)) for i in range(Sq)])
        assert bool((blind & running).any()) and bool((blind & ~running).any())
        assert bool((out[:, blind & running].abs().amax(dim=-1) > 0).all())
        assert bool((out[:, ~running] == 0).all())


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,kw", [
    (1, 100, 100, 4, 1, dict(causal=True)),
    (2, 77, 150, 2, 2, dict(causal=True, window=50, q_offset=73)),
    (1, 37, 300, 4, 2, dict(causal=False)),
])
def test_f32_tiled_reference_vs_jax_reference_ragged(D, B, Sq, Sk, Hq, Hkv,
                                                     kw):
    """Sq and Sk no multiples of the fp32 tiles, every row seeing a key:
    the twin at the fp32 tiles against the dense JAX reference."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _qkv(Sq + 5 * Sk + D, B, Sq, Sk, Hq, Hkv, D), "float32")
    out = t_tiled(tq, tk, tv, tiles=F32_TILES[D], **kw)
    assert out.dtype == torch.float32 and out.shape == tq.shape
    _close(out, j_ref(jq, jk, jv, **kw), TOL["float32"])


@pytest.mark.parametrize("dtype,D,variant", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 32, "mma"), (torch.float32, 16, "fp32"),
    (torch.float32, 128, "fp32"), (torch.float32, 256, "fp32"),
])
def test_flash_variant_by_dtype_and_head_dim(dtype, D, variant):
    assert flash_variant(dtype, D) == variant
    with pytest.raises(ValueError, match="not supported"):
        flash_variant(torch.float16, D)
