"""The port's host-RPC data feed (``data/pipeline.py``) against the JAX
package's, on the CPU: ``make_host_pipeline`` feeds a ``device_run`` loop
through an immediate ordered RPC with a tuple of results (tests/
test_system.py's ``test_host_rpc_data_pipeline_feeds_device_loop``), and
``host_feed_batch`` serves and shape-checks batches in JAX's key order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.device_main import device_run as j_device_run  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.core.device_main import device_run  # noqa: E402
from repro_torch.core.rpc import ShapeDtype, rpc_stats  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


def _gen():
    i = 0
    while True:
        yield {"x": np.full((4,), float(i), np.float32),
               "tok": np.arange(6, dtype=np.int64).reshape(2, 3) + i}
        i += 1


def test_host_pipeline_feeds_device_loop_like_jax():
    jfetch = jpipe.make_host_pipeline(
        _gen(), {"x": jax.ShapeDtypeStruct((4,), jnp.float32),
                 "tok": jax.ShapeDtypeStruct((2, 3), jnp.int32)},
        prefetch=2)
    tfetch = tpipe.make_host_pipeline(
        _gen(), {"x": ShapeDtype((4,), torch.float32),
                 "tok": ShapeDtype((2, 3), torch.int32)},
        prefetch=2, device="cpu")

    def jstep(i, acc):
        b = jfetch(i)
        return acc + b["x"].sum() + b["tok"].sum().astype(jnp.float32)

    def tstep(i, acc):
        b = tfetch(i)
        assert b["tok"].dtype == torch.int32 and b["x"].shape == (4,)
        return acc + b["x"].sum() + b["tok"].sum().to(torch.float32)

    jfinal = j_device_run(jstep, jnp.float32(0.0), 5, donate=False)
    tfinal = device_run(tstep, torch.tensor(0.0), 5)
    want = sum(4.0 * i + 15 + 6 * i for i in range(5))
    assert float(tfinal) == float(jfinal) == want
    assert rpc_stats(tfetch.rpc_name)["calls"] == 5
    jfetch.stop()
    tfetch.stop()


def test_host_pipeline_exhaustion_raises():
    fetch = tpipe.make_host_pipeline(
        iter([{"x": np.ones(2, np.float32)}]),
        {"x": ShapeDtype((2,), torch.float32)}, device="cpu")
    assert fetch(0)["x"].tolist() == [1.0, 1.0]
    with pytest.raises(StopIteration, match="exhausted"):
        fetch(1)


def test_host_feed_batch_like_jax():
    jhost, jkeys = jpipe.host_feed_batch(
        _gen(), {"x": jax.ShapeDtypeStruct((4,), jnp.float32),
                 "tok": jax.ShapeDtypeStruct((2, 3), jnp.int32)})
    thost, tkeys = tpipe.host_feed_batch(
        _gen(), {"x": ShapeDtype((4,), torch.float32),
                 "tok": ShapeDtype((2, 3), torch.int32)})
    assert tkeys == jkeys == ["tok", "x"]
    for step in range(3):
        jb, tb = jhost(step), thost(step)
        for j, t in zip(jb, tb):
            assert j.dtype == t.dtype and np.array_equal(j, t)
    bad, _ = tpipe.host_feed_batch(_gen(), {"x": ShapeDtype((5,),
                                                            torch.float32)})
    with pytest.raises(AssertionError):
        bad(0)
