"""The port's RG-LRU scan on the CPU (its plain version) against the JAX
package: the Pallas kernel in interpret mode and JAX's reference over the
shapes of tests/test_kernels.py and two more sequence lengths, the op with
an initial state against JAX's ``linear_scan``, its gradients in a, b and
h0 against ``jax.vjp``, and the one-token update.

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
    chunk_len, linear_scan_cuda)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_decode_reference, linear_scan_reference)

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


def test_chunk_len_fills_the_card_and_covers_any_length(monkeypatch):
    """The chunk plan depends on shapes alone: at the serving shape
    (B 2, W 4096) on 132 SMs, 96-step chunks (32 of them); at least 16
    steps, a multiple of 16, and enough chunks to cover S."""
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    assert chunk_len("cuda", 2, 3072, 4096) == 96
    for B, S, W in ((1, 1000, 4096), (2, 33, 8), (3, 96, 32), (1, 1, 4)):
        L = chunk_len("cuda", B, S, W)
        assert L >= 16 and L % 16 == 0 and -(-S // L) * L >= S
