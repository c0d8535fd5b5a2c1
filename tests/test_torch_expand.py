"""The port's parallelism expansion against the JAX package's, on the CPU:
``parallel_for`` (one ``torch.vmap``) and ``serial_for`` (a Python loop)
on the bodies of tests/test_core.py, ragged and empty iteration spaces
included, within 1e-6 of each other and of JAX's."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import importlib  # noqa: E402

# (``repro.core.expand`` the package attribute is the function ``expand``)
jexpand = importlib.import_module("repro.core.expand")
texpand = importlib.import_module("repro_torch.core.expand")

BODIES = {
    "square_plus_i": lambda i, a: a[i] ** 2 + i,
    "twice_minus_i": lambda i, a: a[i] * 2.0 - i,
    "row_dot": lambda i, a, m: (m[i] * a[:4]).sum() + a[i],
}


def _arrays(name):
    a = np.random.default_rng(0).standard_normal(32).astype(np.float32)
    if name != "row_dot":
        return (a,)
    m = np.random.default_rng(1).standard_normal((32, 4)).astype(np.float32)
    return (a, m)


@pytest.mark.parametrize("n", [0, 1, 7, 31, 32])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_parallel_and_serial_for_match_jax(name, n):
    body, arrays = BODIES[name], _arrays(name)
    jpar = np.asarray(jexpand.parallel_for(body, n, *map(jnp.asarray, arrays)))
    jser = np.asarray(jexpand.serial_for(body, n, *map(jnp.asarray, arrays)))
    targs = [torch.from_numpy(a) for a in arrays]
    tpar = texpand.parallel_for(body, n, *targs)
    tser = texpand.serial_for(body, n, *targs)
    assert tpar.shape == tser.shape == jpar.shape == (n,)
    assert tpar.dtype == tser.dtype == torch.float32
    for got in (tpar, tser):
        np.testing.assert_allclose(got.numpy(), jpar, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), jser, rtol=1e-6, atol=1e-6)


def test_single_team_vocabulary():
    assert texpand.num_teams() == texpand.num_threads() == 1
    assert int(texpand.team_id()) == 0 and int(texpand.thread_id(3)) == 3
    start, count = texpand.ws_range(12)
    assert (int(start), count) == (0, 12)
    texpand.barrier()
    for fn in (texpand.team_heap, texpand.team_queue, texpand.set_team_heap,
               texpand.set_team_queue, texpand.team_ptr):
        with pytest.raises(RuntimeError, match="region"):
            fn(*([None] if fn.__name__.startswith(("set_", "team_ptr"))
                 else []))
    with pytest.raises(TypeError, match="DeviceMesh"):
        texpand.expand(lambda: None, object(), (), texpand.P())
    with pytest.raises(TypeError, match="DeviceMesh"):
        texpand.parallel_for(lambda i: i, 4, mesh=object())


def _closure_blk(NB=4, BS=3, k=1):
    """A botsspar block update (``benchmarks/spec_bench.py:97-104``) that
    reaches its data only through the closure: no loop argument is a
    tensor."""
    A = torch.empty((NB, NB, BS, BS), device="meta")
    piv_inv = torch.empty((BS, BS), device="meta")

    def blk(i):
        r, c = i // NB, i % NB
        upd = A[r, k] @ piv_inv @ A[k, c]
        return torch.where((r > k) & (c > k), A[r, c] - upd, A[r, c])

    return blk, NB * NB, (BS, BS)


def test_parallel_for_lane_index_on_the_named_device():
    blk, n, shape = _closure_blk()
    out = texpand.parallel_for(blk, n, device="meta")
    assert out.device.type == "meta" and out.shape == (n,) + shape
    with torch.device("meta"):            # the default device
        assert texpand.parallel_for(blk, n).device.type == "meta"
    # no device named and none to infer: the index lies on the (CPU)
    # default device, and the body's mixed-device op raises
    with pytest.raises(RuntimeError, match="device"):
        texpand.parallel_for(blk, n)
    a = torch.arange(6.0)
    assert texpand.parallel_for(lambda i, a: a[i] * 2, 6, a).device == \
        a.device
