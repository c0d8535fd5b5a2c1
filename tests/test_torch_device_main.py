"""The port's device main loop against the JAX package's, on the CPU:
immediate hooks fire on schedule with the same values, a 1000-step run
with a hook every 100 steps makes exactly 10 host calls and nothing else,
auto-named hooks get JAX's names and leave the registry at a constant
size, and the batched transport's options are refused."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import device_main as jdm  # noqa: E402
from repro_torch.core import device_main as tdm  # noqa: E402
from repro_torch.core.rpc import (REGISTRY, effects_barrier,  # noqa: E402
                                  reset_rpc_stats, rpc_stats)


def test_hooks_fire_on_schedule_like_jax():
    jseen, tseen = [], []
    jhook = jdm.HostHook(every=3, extract=lambda i, s: {"v": s},
                         host_fn=lambda i, v: jseen.append((i, float(v))))
    thook = tdm.HostHook(every=3, extract=lambda i, s: {"v": s},
                         host_fn=lambda i, v: tseen.append((i, float(v))))
    jfinal = jdm.device_run(lambda i, s: s * 1.5 + i, jnp.float32(1.0), 10,
                            hooks=[jhook], donate=False)
    jax.effects_barrier()
    tfinal = tdm.device_run(lambda i, s: s * 1.5 + i, torch.tensor(1.0), 10,
                            hooks=[thook])
    assert float(tfinal) == float(jfinal)
    assert [i for i, _ in tseen] == [3, 6, 9]
    assert tseen == jseen


def test_nonfiring_steps_are_host_free():
    """An every=100 hook over 1000 steps contacts the host exactly 10
    times: its firings, nothing else (tests/test_core.py's regression)."""
    effects_barrier()
    reset_rpc_stats()
    seen = []
    hook = tdm.HostHook(every=100, extract=lambda i, s: s,
                        host_fn=lambda i, v: seen.append((i, float(v))),
                        name="hook.torch_sparse")
    final = tdm.device_run(lambda i, s: s + 1.0, torch.tensor(0.0), 1000,
                           hooks=[hook])
    effects_barrier()
    assert float(final) == 1000.0
    assert seen == [(s, float(s)) for s in range(100, 1001, 100)]
    per_name = {k: v["calls"] for k, v in rpc_stats().items() if v["calls"]}
    assert per_name == {"hook.torch_sparse": 10}


def _shared_host_fn(i, v):
    return None


def test_auto_names_are_jax_names():
    for every in (2, 7):
        for hooks in ([jdm.HostHook(every=every, extract=lambda i, s: s,
                                    host_fn=_shared_host_fn)] * 2,):
            jnames = [n for _, n in jdm._name_hooks(hooks)]
            thooks = [tdm.HostHook(every=h.every, extract=h.extract,
                                   host_fn=h.host_fn) for h in hooks]
            assert [n for _, n in tdm._name_hooks(thooks)] == jnames
            assert jnames[1] == jnames[0] + ".2"


def test_device_run_retires_auto_named_hooks():
    def run_once():
        hook = tdm.HostHook(every=2, extract=lambda i, s: s,
                            host_fn=lambda i, v: None)
        tdm.device_run(lambda i, s: s + 1.0, torch.tensor(0.0), 4,
                       hooks=[hook])
        return (len(REGISTRY.hosts), len(REGISTRY.pads),
                len(REGISTRY.pad_wrappers), len(REGISTRY.stats))

    sizes = [run_once() for _ in range(3)]
    assert sizes[0] == sizes[1] == sizes[2], sizes


def test_device_run_refuses_the_batched_transport():
    hook = dict(every=1, extract=lambda i, s: s, host_fn=lambda i, v: None)
    for extra in ({"batched": True}, {"returns": 1},
                  {"consume": lambda *a: a}):
        with pytest.raises(NotImplementedError, match="3.2"):
            tdm.device_run(lambda i, s: s, torch.tensor(0.0), 1,
                           hooks=[tdm.HostHook(**hook, **extra)])
    with pytest.raises(NotImplementedError, match="3.2"):
        tdm.device_run(lambda i, s: s, torch.tensor(0.0), 1,
                       queue_capacity=8)
    with pytest.raises(NotImplementedError, match="item 5"):
        tdm.device_run(lambda i, s: s, torch.tensor(0.0), 1, mesh=object())
