"""The port's device main loop against the JAX package's, on the CPU:
immediate hooks fire on schedule with the same values, a 1000-step run
with a hook every 100 steps makes exactly 10 host calls and nothing else,
auto-named hooks get JAX's names and leave the registry at a constant
size; batched, returning (``consume``) and mixed immediate and batched
hooks give JAX's ``host_fn`` call sequence and JAX's final fp32 state, a
step may flush its queue mid-loop (``thread_queue``), an async queue
refuses returning hooks as JAX's does, and what is not ported (``mesh``)
is refused by its ROADMAP item."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import device_main as jdm  # noqa: E402
from repro_torch.core import device_main as tdm  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402
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
    """What of the batched transport is not ported is refused by its item
    (meshes, 5); a returning hook needs ``batched`` and ``consume`` and a
    synchronous queue (``queue_async`` lands replies an epoch late), as
    in JAX."""
    hook = dict(every=1, extract=lambda i, s: s, host_fn=lambda i, v: None)
    for mod in (jdm, tdm):
        with pytest.raises(ValueError, match="queue_async=True"):
            mod.device_run(lambda i, s: s, 0.0 if mod is jdm else
                           torch.tensor(0.0), 1,
                           hooks=[mod.HostHook(**hook, batched=True,
                                               returns=_F32 if mod is tdm
                                               else _JF32,
                                               consume=lambda *a: a[1])],
                           queue_async=True)
    with pytest.raises(ValueError, match="batched=True"):
        tdm.device_run(lambda i, s: s, torch.tensor(0.0), 1,
                       hooks=[tdm.HostHook(**hook, returns=_F32,
                                           consume=lambda *a: a[1])])
    with pytest.raises(ValueError, match="consume"):
        tdm.device_run(lambda i, s: s, torch.tensor(0.0), 1,
                       hooks=[tdm.HostHook(**hook, batched=True,
                                           returns=_F32)])
    with pytest.raises(NotImplementedError, match="item 5"):
        tdm.device_run(lambda i, s: s, torch.tensor(0.0), 1, mesh=object())


_F32 = trpc.ShapeDtype((), torch.float32)
_JF32 = jax.ShapeDtypeStruct((), jnp.float32)


def _both(hooks_of, step, n, *, jax_state, port_state, **kw):
    """Run the same hooks (``hooks_of(pkg, log)`` -> hooks) through JAX's
    device_run and the port's; returns the two logs and final states."""
    logs = {"jax": [], "port": []}
    jfinal = jdm.device_run(step, jax_state, n,
                            hooks=hooks_of("jax", logs["jax"]),
                            donate=False, **kw)
    jax.effects_barrier()
    tfinal = tdm.device_run(step, port_state, n,
                            hooks=hooks_of("port", logs["port"]), **kw)
    effects_barrier()
    return logs, jfinal, tfinal


def _hook(pkg, **kw):
    return (jdm if pkg == "jax" else tdm).HostHook(**kw)


def test_batched_hooks_fire_like_jax():
    def hooks(pkg, log):
        return [_hook(pkg, every=3, extract=lambda i, s: {"v": s},
                      host_fn=lambda i, v: log.append((i, v)),
                      name="hook.torch_batched", batched=True)]

    logs, jf, tf = _both(hooks, lambda i, s: s * 1.5 + i, 10,
                         jax_state=jnp.float32(1.0),
                         port_state=torch.tensor(1.0))
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 3
    assert all(isinstance(i, int) and isinstance(v, float)
               for i, v in logs["port"])
    assert float(tf) == float(jf)


def test_batched_hook_array_payload_like_jax():
    """Array leaves ride the arena and arrive as 1-D numpy arrays; scalar
    leaves as Python numbers, in JAX's order."""
    def hooks(pkg, log):
        def extract(i, s):
            return {"a": s["x"], "b": s["hist"], "c": s["n"]}

        return [_hook(pkg, every=2, extract=extract, batched=True,
                      host_fn=lambda i, *xs: log.append(
                          (i,) + tuple((x.dtype.str, x.tolist())
                                       if isinstance(x, np.ndarray) else x
                                       for x in xs)),
                      name="hook.torch_payload")]

    def step(i, s):
        return {"x": s["x"] + 0.5, "hist": s["hist"] * 2 + 1,
                "n": s["n"] + 1}

    logs, _, _ = _both(
        hooks, step, 7,
        jax_state={"x": jnp.float32(0.0), "hist": jnp.arange(3, dtype=jnp.int32),
                   "n": jnp.int32(0)},
        port_state={"x": torch.tensor(0.0),
                    "hist": torch.arange(3, dtype=torch.int32),
                    "n": torch.tensor(0, dtype=torch.int32)})
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 3


def test_returning_hook_consumes_like_jax():
    """A returning hook's reply is folded into the state on its firing
    steps; the final fp32 state is JAX's exactly."""
    def hooks(pkg, log):
        rt = _JF32 if pkg == "jax" else _F32
        xp = jnp if pkg == "jax" else torch

        def host_fn(i, v):
            log.append((i, v))
            return np.float32(v) * np.float32(0.25) + np.float32(i)

        def consume(i, s, value, ok):
            return xp.where(ok, s + value, s - 1.0)

        return [_hook(pkg, every=4, extract=lambda i, s: s, host_fn=host_fn,
                      batched=True, returns=rt, consume=consume,
                      name="hook.torch_returning")]

    logs, jf, tf = _both(hooks, lambda i, s: s * 1.25 + 0.5, 13,
                         jax_state=jnp.float32(1.0),
                         port_state=torch.tensor(1.0))
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 3
    assert np.float32(tf).tobytes() == np.float32(jf).tobytes()


def test_mixed_immediate_and_batched_hooks_like_jax():
    def hooks(pkg, log):
        return [_hook(pkg, every=2, extract=lambda i, s: s,
                      host_fn=lambda i, v: log.append(("now", i, float(v))),
                      name="hook.torch_now"),
                _hook(pkg, every=5, extract=lambda i, s: s,
                      host_fn=lambda i, v: log.append(("later", i, v)),
                      name="hook.torch_later", batched=True)]

    logs, jf, tf = _both(hooks, lambda i, s: s + 1.0, 10,
                         jax_state=jnp.float32(0.0),
                         port_state=torch.tensor(0.0))
    now = [e for e in logs["port"] if e[0] == "now"]
    later = [e for e in logs["port"] if e[0] == "later"]
    assert [e[1] for e in now] == [2, 4, 6, 8, 10]
    assert [e[1] for e in later] == [5, 10]
    jnow = [e for e in logs["jax"] if e[0] == "now"]
    jlater = [e for e in logs["jax"] if e[0] == "later"]
    assert now == jnow and later == jlater
    assert float(tf) == float(jf) == 10.0


def test_device_run_thread_queue_midloop_flush():
    """The step enqueues a ticketed record, flushes mid-loop and consumes
    the reply on the same step; return_queue hands back the queue."""
    trpc.REGISTRY.register("dr.torch_twice", lambda x: np.int32(x) * 2)
    i32 = trpc.ShapeDtype((), torch.int32)

    def step(i, s, q):
        _, t = q.enqueue_ticketed("dr.torch_twice", s.to(torch.int32),
                                  returns=i32)
        q.flush()
        return q.result(t).to(torch.float32) + 1.0, q

    final, q = tdm.device_run(step, torch.tensor(1.0), 4, thread_queue=True,
                              return_queue=True, queue_reply=8)
    assert float(final) == 31.0
    assert q.reply_capacity == 8 and int(q.head) == 0


def test_batched_every_step_makes_one_flush():
    """1000 firings of a batched hook reach the host in one flush."""
    effects_barrier()
    reset_rpc_stats()
    seen = []
    hook = tdm.HostHook(every=1, extract=lambda i, s: s.sum(),
                        host_fn=lambda i, v: seen.append(i),
                        name="hook.torch_every1", batched=True)
    tdm.device_run(lambda i, s: s + 1.0, torch.zeros(4), 1000, hooks=[hook])
    assert seen == list(range(1, 1001))
    assert trpc.flush_stats()["flushes"] == 1
    assert rpc_stats("hook.torch_every1")["calls"] == 1000


def test_idempotent_hook_retried_by_the_run_queue():
    """A transiently failing idempotent hook is redriven under
    ``queue_retry``; a non-idempotent one fails its record only."""
    calls = {"ok": 0, "bad": 0}

    def flaky(i, v):
        calls["ok"] += 1
        if calls["ok"] == 1:
            raise RuntimeError("transient")

    def broken(i, v):
        calls["bad"] += 1
        raise RuntimeError("always")

    trpc.clear_error_log()
    reset_rpc_stats()
    hooks = [tdm.HostHook(every=2, extract=lambda i, s: s, host_fn=flaky,
                          name="hook.torch_flaky", batched=True,
                          idempotent=True),
             tdm.HostHook(every=4, extract=lambda i, s: s, host_fn=broken,
                          name="hook.torch_broken", batched=True)]
    with pytest.warns(RuntimeWarning, match="isolated"):
        tdm.device_run(lambda i, s: s + 1.0, torch.tensor(0.0), 4,
                       hooks=hooks, queue_retry=trpc.RetryPolicy(3))
    assert calls == {"ok": 3, "bad": 1}
    st = trpc.flush_stats()
    assert st["retries"] == 1 and st["callee_errors"] == 1
    assert [(e["callee"], e["attempt"]) for e in trpc.error_log()] == \
        [("hook.torch_flaky", 1), ("hook.torch_broken", 1)]


# -- pytrees as jax.tree flattens them (None is an empty subtree) ----------

class _Pair(__import__("typing").NamedTuple):
    a: object
    b: object


_TREES = [
    {"a": 1, "b": None, "c": (2, None)},
    [None, {"z": 3, "y": [4, (5, None)]}, ()],
    _Pair(6, {"k": None, "j": _Pair(7, [8])}),
    (None,),
    {"b": {"c": None}, "a": [[], 9]},
]


@pytest.mark.parametrize("tree", _TREES, ids=range(len(_TREES)))
def test_tree_flattens_and_maps_like_jax_tree(tree):
    from repro_torch.tree import leaves, tree_map
    assert leaves(tree) == jax.tree.leaves(tree)
    out = tree_map(lambda x: x * 10, tree)
    assert out == jax.tree.map(lambda x: x * 10, tree)
    assert type(out) is type(tree)
    twin = tree_map(lambda x: x + 1, tree)
    assert tree_map(lambda x, y: x - y, twin, tree) == \
        jax.tree.map(lambda x, y: x - y, twin, tree)


def test_hook_extract_with_none_leaf_fires_like_jax():
    """A hook whose ``extract`` returns ``{"v": state, "n": None}`` ships
    only ``v`` (None is an empty subtree) and fires twice in 4 steps of
    every 2, as JAX's."""
    logs = {"jax": [], "port": []}
    for mod, state, log in ((jdm, jnp.float32(1.0), logs["jax"]),
                            (tdm, torch.tensor(1.0), logs["port"])):
        hook = mod.HostHook(every=2, extract=lambda i, s: {"v": s, "n": None},
                            host_fn=lambda i, *v, log=log: log.append(
                                (int(i), [float(x) for x in v])))
        kw = {"donate": False} if mod is jdm else {}
        mod.device_run(lambda i, s: s + 1.0, state, 4, hooks=[hook], **kw)
        jax.effects_barrier()
        effects_barrier()
    assert logs["port"] == logs["jax"] == [(2, [3.0]), (4, [5.0])]
