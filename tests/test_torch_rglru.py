"""The port's RG-LRU scan on the CPU (its plain version) against the JAX
package: the Pallas kernel in interpret mode and JAX's reference over the
shapes of tests/test_kernels.py and two more sequence lengths, the op with
an initial state against JAX's ``linear_scan``, its gradients in a, b and
h0 against ``jax.vjp``, and the one-token update.  Also the CUDA kernel's
bit twin ``linear_scan_sequential_reference`` against the same oracles and
float64, and the kernel's launch plan ``scan_plan``.

Tolerances: forward fp32 2e-5 and bf16 3e-2, those of tests/test_kernels.py
(the same recurrence; the doubling scan here and XLA's associative scan
associate the products in other orders).  Gradients fp32 1e-4: the backward
runs the scan's derivative through both sides' autodiff, whose roundings
add up to a few times the forward's.  Inputs come from numpy with a seed
and go to both sides: a = sigmoid(normal), b = normal, as
tests/test_kernels.py draws them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan import linear_scan as j_scan  # noqa: E402
from repro.kernels.rglru_scan import (  # noqa: E402
    linear_scan_decode_step as j_decode)
from repro.kernels.rglru_scan.kernel import linear_scan_pallas  # noqa: E402
from repro.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_reference as j_ref)
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    linear_scan, linear_scan_decode_step)
from repro_torch.kernels.rglru_scan.kernel import (  # noqa: E402
    LANES, ROUNDS, STEP_CHOICES, WARPS, linear_scan_cuda, scan_plan)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_decode_reference, linear_scan_reference,
    linear_scan_sequential_reference)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-4
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here (see
    tests/test_torch_flash.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ab(seed, B, S, W):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    return a.astype(np.float32), \
        rng.standard_normal((B, S, W)).astype(np.float32)


def _both(arrs, dtype):
    """numpy fp32 arrays -> (jax arrays, torch tensors) of ``dtype``."""
    return ([jnp.asarray(x).astype(J_DT[dtype]) for x in arrs],
            [torch.from_numpy(x).to(T_DT[dtype]) for x in arrs])


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,W,blk", [(2, 128, 64, 32), (1, 64, 16, 16),
                                       (3, 96, 32, 32), (2, 33, 8, 33),
                                       (1, 100, 16, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_vs_pallas_and_jax_reference(B, S, W, blk, dtype):
    (ja, jb), (ta, tb) = _both(_ab(B * S + W, B, S, W), dtype)
    h, hl = linear_scan_reference(ta, tb)
    assert h.dtype == T_DT[dtype] and hl.dtype == torch.float32
    assert tuple(hl.shape) == (B, W)
    ph, phl = linear_scan_pallas(ja, jb, blk=blk, interpret=True)
    rh, rhl = j_ref(ja, jb)
    for want, want_last in ((ph, phl), (rh, rhl)):
        _close(h, want, TOL[dtype])
        _close(hl, want_last, TOL[dtype])


def test_plain_scan_matches_the_sequential_recurrence():
    a, b = _ab(5, 2, 77, 8)
    h, hl = linear_scan_reference(torch.from_numpy(a), torch.from_numpy(b))
    hs = np.zeros((2, 8), np.float64)
    for t in range(77):
        hs = a[:, t] * hs + b[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), hs, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hl.numpy(), hs, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_with_h0_matches_jax_and_leaves_b(dtype):
    a, b = _ab(7, 2, 40, 16)
    h0 = np.random.default_rng(8).standard_normal((2, 16)).astype(np.float32)
    (ja, jb, jh0), (ta, tb, th0) = _both([a, b, h0], dtype)
    th0 = th0.float()
    b_before = tb.clone()
    h, hl = linear_scan(ta, tb, th0)
    assert torch.equal(tb, b_before)
    jh, jhl = j_scan(ja, jb, jh0.astype(jnp.float32))
    _close(h, jh, TOL[dtype])
    _close(hl, jhl, TOL[dtype])
    # from zero, the op is the plain version
    h_z, hl_z = linear_scan(ta, tb)
    rh, rhl = linear_scan_reference(ta, tb)
    assert torch.equal(h_z, rh) and torch.equal(hl_z, rhl)


def test_op_gradients_in_a_b_h0_match_jax_vjp():
    a, b = _ab(9, 2, 50, 8)
    rng = np.random.default_rng(10)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    gh = rng.standard_normal((2, 50, 8)).astype(np.float32)
    ghl = rng.standard_normal((2, 8)).astype(np.float32)
    (_, jvjp) = jax.vjp(lambda x, y, z: j_scan(x, y, z), jnp.asarray(a),
                        jnp.asarray(b), jnp.asarray(h0))
    jgrads = jvjp((jnp.asarray(gh), jnp.asarray(ghl)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (a, b, h0)]
    h, hl = linear_scan(*ts)
    tgrads = torch.autograd.grad([h, hl], ts, [torch.from_numpy(gh),
                                               torch.from_numpy(ghl)])
    for t, j in zip(tgrads, jgrads):
        _close(t, j, GRAD_TOL)
    # h's cotangent alone (h_last unused), as the model's forward takes it
    (_, jvjp) = jax.vjp(lambda x, y: j_scan(x, y)[0], jnp.asarray(a),
                        jnp.asarray(b))
    jgrads = jvjp(jnp.asarray(gh))
    ts = [torch.from_numpy(x).requires_grad_() for x in (a, b)]
    tgrads = torch.autograd.grad(linear_scan(*ts)[0], ts,
                                 torch.from_numpy(gh))
    for t, j in zip(tgrads, jgrads):
        _close(t, j, GRAD_TOL)


def test_decode_step_matches_jax_and_the_scan():
    a, b = _ab(11, 3, 6, 16)
    h = np.zeros((3, 16), np.float32)
    th = torch.zeros((3, 16))
    full, _ = linear_scan_reference(torch.from_numpy(a), torch.from_numpy(b))
    for t in range(6):
        h = np.asarray(j_decode(jnp.asarray(a[:, t]), jnp.asarray(b[:, t]),
                                jnp.asarray(h)))
        th = linear_scan_decode_step(torch.from_numpy(a[:, t]),
                                     torch.from_numpy(b[:, t]), th)
        assert th.dtype == torch.float32
        _close(th, h, TOL["float32"])
        _close(th, full[:, t], TOL["float32"])
    bf = linear_scan_decode_reference(
        torch.from_numpy(a[:, 0]).bfloat16(),
        torch.from_numpy(b[:, 0]).bfloat16(), th)
    assert bf.dtype == torch.float32


def test_cpu_op_launches_nothing_and_kernel_refuses_cpu_tensors():
    ta, tb = (torch.from_numpy(x) for x in _ab(12, 1, 16, 8))
    before = linear_scan_cuda.launches
    linear_scan(ta, tb)
    assert linear_scan_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        linear_scan_cuda(ta, tb)
    with pytest.raises(ValueError, match="multiple of 4"):
        linear_scan_cuda(ta[..., :6].contiguous(), tb[..., :6].contiguous())


@pytest.mark.parametrize("B,S,W,blk", [(2, 128, 64, 32), (1, 64, 16, 16),
                                       (3, 96, 32, 32), (2, 33, 8, 33),
                                       (1, 100, 16, 100), (2, 1, 8, 1),
                                       (2, 77, 12, 77), (1, 1000, 16, 250)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequential_twin_vs_pallas_jax_and_plain(B, S, W, blk, dtype):
    """The kernel's bit twin, step by step and in the kernel's chunk orders
    (16 and 32 steps), against the Pallas kernel in interpret mode, JAX's
    reference and the port's doubling scan, at the existing shapes and
    ragged S (1, 77, 1000)."""
    (ja, jb), (ta, tb) = _both(_ab(B * S + W + 1, B, S, W), dtype)
    ph, phl = linear_scan_pallas(ja, jb, blk=blk, interpret=True)
    rh, rhl = j_ref(ja, jb)
    dh, dhl = linear_scan_reference(ta, tb)
    for chunk in (None, 16, 32):
        h, hl = linear_scan_sequential_reference(ta, tb, chunk=chunk)
        assert h.dtype == T_DT[dtype] and hl.dtype == torch.float32
        assert tuple(h.shape) == (B, S, W) and tuple(hl.shape) == (B, W)
        for want, want_last in ((ph, phl), (rh, rhl), (dh.float(), dhl)):
            _close(h, want, TOL[dtype])
            _close(hl, want_last, TOL[dtype])


def _chunk_order_numpy(a, b, L):
    """The kernel's chunk order in numpy float32, step by step: each
    chunk's (A, H) from zero, the carry folded c = A c + H, the chunk's h
    from its carry; every product and sum rounded to float32."""
    B, S, W = a.shape
    h = np.zeros((B, S, W), np.float32)
    c = np.zeros((B, W), np.float32)
    for t0 in range(0, S, L):
        A, H, x = np.ones_like(c), np.zeros_like(c), c
        for t in range(t0, min(t0 + L, S)):
            x = (a[:, t] * x).astype(np.float32) + b[:, t]
            h[:, t] = x
            A = (A * a[:, t]).astype(np.float32)
            H = (a[:, t] * H).astype(np.float32) + b[:, t]
        c = (A * c).astype(np.float32) + H
    return h, x


@pytest.mark.parametrize("B,S,W", [(2, 1000, 8), (3, 77, 4)])
@pytest.mark.parametrize("chunk", [None, 16, 32])
def test_sequential_twin_matches_float64_and_rounds_each_step(B, S, W,
                                                              chunk):
    """Within 1e-5 of the float64 recurrence, and bit-equal to an
    independent numpy float32 walk in the same order (step by step, or the
    kernel's chunk order)."""
    a, b = _ab(13 + S, B, S, W)
    h, hl = linear_scan_sequential_reference(torch.from_numpy(a),
                                             torch.from_numpy(b), chunk=chunk)
    h64 = np.zeros((B, W), np.float64)
    for t in range(S):
        h64 = a[:, t].astype(np.float64) * h64 + b[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), h64, atol=1e-5,
                                   rtol=1e-5)
    n32, n32_last = _chunk_order_numpy(a, b, S if chunk is None else chunk)
    np.testing.assert_array_equal(h.numpy(), n32)
    np.testing.assert_array_equal(hl.numpy(), n32_last)
    np.testing.assert_allclose(hl.numpy(), h64, atol=1e-5, rtol=1e-5)


_SERVE_SMS = 132


@pytest.mark.parametrize("sms,B,S,W,a_size,b_size,steps", [
    # recurrentgemma-9b's prefill (B 2, S 3072, W 4096) on 132 SMs: 256
    # blocks, 2 an SM; fp32 a and b take 16-step chunks, bf16 32
    (_SERVE_SMS, 2, 3072, 4096, 4, 4, 16),
    (_SERVE_SMS, 2, 3072, 4096, 2, 2, 32),
    # one prompt of 1000: 128 blocks, one an SM
    (_SERVE_SMS, 1, 1000, 4096, 4, 4, 16),
    # mixed dtypes: 6 bytes an element
    (_SERVE_SMS, 2, 3072, 4096, 4, 2, 16),
    (_SERVE_SMS, 8, 2048, 4096, 2, 4, 16),
    (_SERVE_SMS, 3, 77, 36, 2, 2, 32),
    (_SERVE_SMS, 1, 1, 4, 4, 4, 16),
    (16, 2, 999, 4096, 2, 2, 32),
])
def test_scan_plan_fills_the_card_and_covers_any_length(
        sms, B, S, W, a_size, b_size, steps):
    """The plan is a pure function of shapes and the SM count: one block
    for each 32 channels, the longest chunk of STEP_CHOICES that lets two
    blocks share an SM's shared memory, ceil(S / (8 steps)) rounds that
    cover S."""
    plan = scan_plan(sms, B, S, W, a_size, b_size)
    assert plan == scan_plan(sms, B, S, W, a_size, b_size)
    assert plan.steps == steps and plan.steps in STEP_CHOICES
    assert plan.blocks == -(-B * W // LANES)
    assert plan.blocks_per_sm == -(-plan.blocks // sms)
    assert plan.smem == (WARPS * ROUNDS * steps * LANES * (a_size + b_size)
                         + 2 * WARPS * LANES * 8)
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    longer = [k for k in STEP_CHOICES if k > plan.steps]
    assert all(2 * (WARPS * ROUNDS * k * LANES * (a_size + b_size)
                    + 2 * WARPS * LANES * 8 + 1024) > 228 * 1024
               for k in longer)
    rounds = -(-S // (WARPS * plan.steps))
    assert rounds * WARPS * plan.steps >= S > (rounds - 1) * WARPS * plan.steps
