"""Port's SSD chunked scan on the CPU: the plain PyTorch version and the op
against the JAX reference, the JAX op (through its recompute VJP for the
gradients) and the Pallas kernel in interpret mode, on the same inputs
(numpy, seeded, drawn as tests/test_kernels.py draws them: x in the tested
dtype, dt = softplus(normal), A = -exp(normal), B, C and D normal, all but x
in fp32).

The plain twin of the kernel's bf16 tensor-core path
(``ssd_scan_reference_tc``) is held against the Pallas kernel and the plain
version with bf16 x, B and C, as the model feeds them.

Tolerances: fp32 2e-5 and bf16 3e-2 (those of tests/test_kernels.py; bf16
rounds only y, at the same place in both frameworks); gradients 1e-4 (the
backward adds products of the recompute's fp32 terms, whose rounding
differences add up to a few times the forward's, as ``GRAD_TOL`` in
tests/test_torch_train.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_decode_reference, ssd_scan_reference)
from repro_torch.kernels.ssd_scan import ssd_decode_step, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import (  # noqa: E402
    ssd_scan_cuda, tensor_core_path)
from repro_torch.kernels.ssd_scan.ops import pad_to_chunk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_decode_reference as t_decode_ref)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_reference as t_scan_ref)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_reference_tc as t_scan_tc)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-4
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
# the shapes of tests/test_kernels.py: (B, S, H, P, N, chunk)
KERNEL_SHAPES = [(2, 64, 3, 8, 16, 16), (1, 32, 2, 4, 8, 8)]
REF_SHAPES = KERNEL_SHAPES + [(2, 48, 4, 16, 16, 16)]
# jitted, so that each JAX side compiles once instead of dispatching op by op
j_ref = jax.jit(ssd_scan_reference, static_argnames=("chunk",))
j_op = jax.jit(j_ssd_scan, static_argnames=("chunk",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here (see
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, S, H, P, N, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32).astype(
        NP_DT[dtype])
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(out, ref, tol):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", REF_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_jax_reference(B, S, H, P, N, chunk, dtype):
    args = _inputs(0, B, S, H, P, N, dtype)
    jy, jfs = j_ref(*map(jnp.asarray, args), chunk=chunk)
    ty, tfs = t_scan_ref(*map(_t, args), chunk=chunk)
    assert ty.dtype == _t(args[0]).dtype and tfs.dtype == torch.float32
    _close(ty, jy, TOL[dtype])
    _close(tfs, jfs, TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N,chunk", KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_pallas_interpret(B, S, H, P, N, chunk, dtype):
    args = _inputs(1, B, S, H, P, N, dtype)
    jy, jfs = ssd_scan_pallas(*map(jnp.asarray, args), chunk=chunk,
                              interpret=True)
    ty, tfs = ssd_scan(*map(_t, args), chunk=chunk)
    _close(ty, jy, TOL[dtype])
    _close(tfs, jfs, TOL[dtype])


@pytest.mark.parametrize("S,chunk", [(20, 8), (5, 8), (37, 16)],
                         ids=["padded", "shorter_than_chunk", "padded_odd"])
def test_op_pads_like_jax(S, chunk):
    """S not a multiple of the chunk is zero-padded and y sliced back; S
    below the chunk takes Q = S."""
    args = _inputs(2, 2, S, 3, 8, 16)
    jy, jfs = j_op(*map(jnp.asarray, args), chunk=chunk)
    ty, tfs = ssd_scan(*map(_t, args), chunk=chunk)
    assert tuple(ty.shape) == (2, S, 3, 8)
    _close(ty, jy, TOL["float32"])
    _close(tfs, jfs, TOL["float32"])


def test_initial_state_matches_jax():
    args = _inputs(3, 2, 24, 3, 8, 16)
    h0 = np.random.default_rng(4).standard_normal((2, 3, 8, 16)).astype(
        np.float32)
    jy, jfs = j_ssd_scan(*map(jnp.asarray, args), chunk=8,
                         initial_state=jnp.asarray(h0))
    ty, tfs = ssd_scan(*map(_t, args), chunk=8, initial_state=_t(h0))
    _close(ty, jy, TOL["float32"])
    _close(tfs, jfs, TOL["float32"])
    # the state carries: two halves with the state between equal the whole
    y1, s1 = ssd_scan(*(_t(a[:, :12]) if a.ndim > 1 else _t(a)
                        for a in args), chunk=8, initial_state=_t(h0))
    y2, s2 = ssd_scan(*(_t(a[:, 12:]) if a.ndim > 1 else _t(a)
                        for a in args), chunk=8, initial_state=s1)
    _close(torch.cat([y1, y2], dim=1), ty.numpy(), TOL["float32"])
    _close(s2, tfs.numpy(), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_reference_matches_jax_and_the_scan(dtype):
    B, S, H, P, N = 2, 16, 3, 8, 8
    x, dt, A, Bm, Cm, D = _inputs(5, B, S, H, P, N, dtype)
    y_full, _ = t_scan_ref(*map(_t, (x, dt, A, Bm, Cm, D)), chunk=8)
    jst = jnp.zeros((B, H, P, N))
    tst = torch.zeros((B, H, P, N))
    for t in range(S):
        step = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)
        jy, jst = ssd_decode_reference(*map(jnp.asarray, step), jst)
        oy, ost = ssd_decode_step(*map(_t, step), tst)
        ty, tst = t_decode_ref(*map(_t, step), tst)
        assert torch.equal(oy, ty) and torch.equal(ost, tst)
        assert ty.dtype == _t(x).dtype and tst.dtype == torch.float32
        _close(ty, jy, TOL[dtype])
        _close(tst, jst, TOL[dtype])
        _close(ty, y_full[:, t].float().numpy(), TOL[dtype])


@pytest.mark.parametrize("S,chunk", [(32, 8), (20, 8)],
                         ids=["chunked", "padded"])
def test_op_gradients_match_jax_vjp(S, chunk):
    """Gradients of x, dt, A, B, C and D through the op (recompute through
    the plain version) against ``jax.vjp`` of the JAX op, with cotangents
    on both y and the final state."""
    args = _inputs(6, 2, S, 3, 8, 16)
    rng = np.random.default_rng(7)
    gy = rng.standard_normal((2, S, 3, 8)).astype(np.float32)
    gfs = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    @jax.jit
    def j_grads(args, gy, gfs):
        _, vjp = jax.vjp(lambda *a: j_ssd_scan(*a, chunk=chunk), *args)
        return vjp((gy, gfs)), vjp((gy, jnp.zeros_like(gfs)))[0]

    jgrads, jgx = j_grads(tuple(map(jnp.asarray, args)), jnp.asarray(gy),
                          jnp.asarray(gfs))
    targs = [_t(a).requires_grad_() for a in args]
    y, fs = ssd_scan(*targs, chunk=chunk)
    tgrads = torch.autograd.grad((y, fs), targs, (_t(gy), _t(gfs)))
    for name, t, j in zip("x dt A B C D".split(), tgrads, jgrads):
        assert t.shape == tuple(j.shape), name
        _close(t, j, GRAD_TOL)
    # only y carries a cotangent, as in training
    (gx,) = torch.autograd.grad(ssd_scan(*targs, chunk=chunk)[0], targs[:1],
                                _t(gy))
    _close(gx, jgx, GRAD_TOL)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """Dispatch is by device: a CPU tensor never reaches the kernel."""
    def boom(*a, **k):
        raise AssertionError("kernel called for a CPU tensor")

    import repro_torch.kernels.ssd_scan.ops as sops
    monkeypatch.setattr(sops, "ssd_scan_cuda", boom)
    args = list(map(_t, _inputs(8, 1, 16, 2, 4, 8)))
    y, fs = sops.ssd_scan(*args, chunk=8)
    ry, rfs = t_scan_ref(*args, chunk=8)
    torch.testing.assert_close(y, ry)
    torch.testing.assert_close(fs, rfs)


def test_kernel_wrapper_refuses_what_it_cannot_run():
    """The CUDA wrapper launches on CUDA tensors or raises; it never falls
    back to the plain version, and refuses shapes it has no kernel for."""
    x, dt, A, Bm, Cm, D = map(_t, _inputs(9, 1, 16, 2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=8)
    with pytest.raises(ValueError, match="bfloat16 x"):
        ssd_scan_cuda(x, dt, A, Bm.bfloat16(), Cm.bfloat16(), D, chunk=8)
    with pytest.raises(ValueError, match="head_dim 5"):
        ssd_scan_cuda(torch.zeros((1, 16, 2, 5)), dt, A, Bm, Cm, D, chunk=8)
    with pytest.raises(ValueError, match="divide the sequence"):
        ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=6)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan_cuda(x, dt[:, :8], A, Bm, Cm, D, chunk=8)
    assert ssd_scan_cuda.launches == 0


def _bf16_inputs(seed, B, S, H, P, N):
    """bf16 x, B and C (what the model feeds the kernel's tensor-core
    path), fp32 dt, A and D."""
    x, dt, A, Bm, Cm, D = _inputs(seed, B, S, H, P, N, "bfloat16")
    return (x, dt, A, Bm.astype(ml_dtypes.bfloat16),
            Cm.astype(ml_dtypes.bfloat16), D)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 100, 2, 64, 128, 64),
                                             (1, 64, 1, 64, 128, 32)],
                         ids=["padded", "two_chunks"])
def test_rounding_twin_matches_pallas_and_reference(B, S, H, P, N, chunk):
    """The plain twin of the kernel's tensor-core path (w x, M and the
    entering state as two bf16 terms each) through the op's padding,
    against the JAX Pallas kernel in interpret mode on the same padding and
    against the plain version, at bf16 3e-2."""
    args = _bf16_inputs(5, B, S, H, P, N)
    assert tensor_core_path(torch.bfloat16, torch.bfloat16, P, N)
    x, dt, Bm, Cm, Q = pad_to_chunk(*(_t(args[i]) for i in (0, 1, 3, 4)),
                                    chunk)
    pa = (x, dt, _t(args[2]), Bm, Cm, _t(args[5]))
    ty, tfs = t_scan_tc(*pa, chunk=Q)
    assert ty.dtype == torch.bfloat16 and tfs.dtype == torch.float32
    ry, rfs = t_scan_ref(*pa, chunk=Q)
    _close(ty[:, :S], ry[:, :S].float().numpy(), TOL["bfloat16"])
    _close(tfs, rfs.numpy(), TOL["bfloat16"])
    pad = x.shape[1] - S
    jargs = [jnp.asarray(a) for a in args]
    for i in (0, 1, 3, 4):
        jargs[i] = jnp.pad(jargs[i], ((0, 0), (0, pad))
                           + ((0, 0),) * (jargs[i].ndim - 2))
    jy, jfs = ssd_scan_pallas(*jargs, chunk=Q, interpret=True)
    _close(ty[:, :S], np.asarray(jy, np.float32)[:, :S], TOL["bfloat16"])
    _close(tfs, jfs, TOL["bfloat16"])


def test_tensor_core_path_is_bf16_at_mamba2_widths():
    """The wrapper's mirror of the kernel's dispatch: bf16 x, B and C at
    P 64 and N 128; everything else the CUDA-core kernels."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tensor_core_path(bf, bf, 64, 128)
    assert not tensor_core_path(bf, bf, 64, 16)
    assert not tensor_core_path(bf, bf, 16, 16)
    assert not tensor_core_path(bf, f32, 64, 128)
    assert not tensor_core_path(f32, f32, 64, 128)
