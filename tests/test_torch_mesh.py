"""The port's meshes, the runtime side (``core/expand.py``'s ``expand``,
team heaps and queues, ``parallel_for(mesh=)``, ``device_run(mesh=)``,
the sharded page heap), against the JAX package or, where JAX's own
multi-device tests are red, against the single-team oracles and the
values JAX's tests assert.

Multi-team runs are ``gloo`` worlds of 2 and 4 processes on the CPU
(``repro_torch.launch.world.run_world``: a ``FileStore`` in the test's
``tmp_path``, a collective timeout, a deadline on the world), several
checks a world.  In-process checks use a world of one (an in-process
``HashStore``), the JAX package's one-device mesh, or an int shard count
(the sharded page heap is a data layout on one device, as in JAX).
Integers, pointers, page tables, token streams and host records are
compared bit for bit; floats of the collectives within 1e-12 (float64)."""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_serving as tsrv  # noqa: E402
from test_torch_serving import jcfg_to_port, models  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import allocator_bench as jab  # noqa: E402
from repro.configs import CONFIGS  # noqa: E402
from repro.core.allocator import ShardedHeap as JShardedHeap  # noqa: E402
from repro.core import rpc as jrpc  # noqa: E402
from repro.core.expand import expand as j_expand  # noqa: E402
from repro.core.expand import set_team_queue as j_set_team_queue  # noqa: E402
from repro.core.expand import team_queue as j_team_queue  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro_torch.analysis import corpus  # noqa: E402
from repro_torch.analysis.capture import capture  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.core.allocator import STATE_FIELDS, ShardedHeap  # noqa: E402
from repro_torch.core.device_main import HostHook, device_run  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     one_device_mesh, production_shape)
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

texpand = importlib.import_module("repro_torch.core.expand")
SRC = str(ROOT / "src")


# ---------------------------------------------------------------------------
# The sharded page heap: mesh=1 against the single heap, mesh=2 against JAX
# ---------------------------------------------------------------------------

def _kv_cfgs():
    jcfg = dataclasses.replace(CONFIGS["llama3.2-3b"].reduced(), num_layers=1)
    return jcfg, jcfg_to_port(jcfg)


def _alloc_fields(alloc):
    st = alloc.shards if isinstance(alloc, (ShardedHeap, JShardedHeap)) \
        else alloc
    return {f: np.asarray(getattr(st, f)) for f in STATE_FIELDS}


def _same_kv_any(a, b):
    """Page tables, lengths and every allocator field (each shard's) equal,
    bit for bit; either side may be JAX's or the port's."""
    np.testing.assert_array_equal(np.asarray(a.page_table),
                                  np.asarray(b.page_table))
    np.testing.assert_array_equal(np.asarray(a.lengths),
                                  np.asarray(b.lengths))
    fa, fb = _alloc_fields(a.alloc), _alloc_fields(b.alloc)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(fa[f], fb[f], err_msg=f)


def test_paged_cache_mesh1_is_the_single_heap():
    """tests/test_sharded_runtime.py:508-531 in the port: the one-shard
    page heap gives the single heap's page tables and lengths through
    allocation, advance and release."""
    _, cfg = _kv_cfgs()
    kv1 = tkv.paged_cache_init(cfg, 4, 64, page_size=16, device="cpu")
    kv2 = tkv.paged_cache_init(cfg, 4, 64, page_size=16, device="cpu",
                               mesh=1)
    assert isinstance(kv2.alloc, ShardedHeap) and kv2.alloc.n_devices == 1
    active = torch.tensor([True, True, False, True])
    for _ in range(20):
        kv1 = tkv.advance(tkv.ensure_pages(kv1, active), active)
        kv2 = tkv.advance(tkv.ensure_pages(kv2, active), active)
    assert torch.equal(kv1.page_table, kv2.page_table)
    assert torch.equal(kv1.lengths, kv2.lengths)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(kv1.alloc, f),
                           getattr(kv2.alloc.shards, f)[0]), f
    mask = torch.tensor([True, False, False, True])
    kv1 = tkv.release_slots(kv1, mask)
    kv2 = tkv.release_slots(kv2, mask)
    assert torch.equal(kv1.page_table, kv2.page_table)
    kv1 = tkv.release_slot(kv1, 1)
    kv2 = tkv.release_slot(kv2, 1)
    assert torch.equal(kv1.page_table, kv2.page_table)
    assert torch.equal(kv1.lengths, kv2.lengths)


def test_paged_cache_mesh2_in_lockstep_with_jax():
    """tests/test_sharded_runtime.py:534-553 on both packages at once: the
    same (B 4, D 2) heap, every table and shard field equal after every
    tick; each slot's pages lie in its shard's span, all distinct; release
    and reallocation stay in the span."""
    jcfg, cfg = _kv_cfgs()
    B, D = 4, 2
    jk = jkv.paged_cache_init(jcfg, B, 64, page_size=16, mesh=D)
    tk = tkv.paged_cache_init(cfg, B, 64, page_size=16, device="cpu", mesh=D)
    span = tk.alloc.span
    assert span == jk.alloc.span == 8
    ja, ta = jnp.ones((B,), bool), torch.ones((B,), dtype=torch.bool)
    for _ in range(32):
        jk = jkv.advance(jkv.ensure_pages(jk, ja), ja)
        tk = tkv.advance(tkv.ensure_pages(tk, ta), ta)
        _same_kv_any(jk, tk)
    table, used = tk.page_table.numpy(), tk.lengths.numpy() // 16
    for b in range(B):
        dev = b // (B // D)
        pages = table[b, :used[b]]
        assert ((pages >= dev * span) & (pages < (dev + 1) * span)).all()
        assert torch.equal(tkv.live_pages(tk, b), tk.page_table[b, :used[b]])
    live = [int(p) for b in range(B) for p in table[b, :used[b]]]
    assert len(live) == len(set(live))
    jk = jkv.release_slots(jk, jnp.asarray([True, False, True, False]))
    tk = tkv.release_slots(tk, torch.tensor([True, False, True, False]))
    jk = jkv.release_slot(jk, 3)
    tk = tkv.release_slot(tk, 3)
    _same_kv_any(jk, tk)
    assert tk.lengths.tolist() == [0, 32, 0, 0]
    for _ in range(20):
        jk = jkv.advance(jkv.ensure_pages(jk, ja), ja)
        tk = tkv.advance(tkv.ensure_pages(tk, ta), ta)
    _same_kv_any(jk, tk)


def test_engine_mesh2_matches_jax_and_the_unsharded_engine(models,
                                                          monkeypatch):
    """tests/test_serving.py:193-212 in lock-step with JAX's engine at
    mesh=2 (test_torch_serving.py's ``_lockstep``: page tables, lengths and
    every shard field after every tick, then the streams), and the streams
    of the port's unsharded engine on the same traffic."""
    monkeypatch.setattr(tsrv, "_same_kv", _same_kv_any)
    traffic = [([5, 17, 42, 7], 6), ([9, 3], 4), ([1 + i for i in range(11)],
                                                  9), ([2, 5, 8], 10)]
    teng, rids, _ = tsrv._lockstep(models, traffic, batch_slots=2,
                                   jax_kw={"mesh": 2}, port_kw={"mesh": 2})
    assert isinstance(teng.kv.alloc, ShardedHeap)
    _, _, tmodel, tparams = models
    plain = ServingEngine(tmodel, tparams, batch_slots=2, max_len=64,
                          page_size=8, device="cpu")
    prids = [plain.submit(p, max_new=n) for p, n in traffic]
    res = plain.run_until_drained()
    assert [res[r] for r in prids] == [teng.finished[r] for r in rids]


def test_engine_sharded_artifact_cold_start(models, tmp_path):
    """``export_artifact`` of a mesh=2 engine and ``from_artifact(mesh=2)``
    in this process: the exported step carries the sharded page heap, and
    the cold-started engine decodes the live one's streams."""
    _, _, tmodel, tparams = models
    traffic = [([5, 17, 42, 7], 6), ([9, 3], 4), ([1, 2, 3], 5)]
    live = ServingEngine(tmodel, tparams, batch_slots=2, max_len=64,
                         page_size=8, device="cpu", mesh=2)
    lr = [live.submit(p, max_new=n) for p, n in traffic]
    lres = live.run_until_drained()
    live.export_artifact(str(tmp_path / "art"))
    cold = ServingEngine.from_artifact(str(tmp_path / "art"), tmodel.cfg,
                                       device="cpu", mesh=2)
    assert isinstance(cold.kv.alloc, ShardedHeap)
    cr = [cold.submit(p, max_new=n) for p, n in traffic]
    cres = cold.run_until_drained()
    assert [cres[r] for r in cr] == [lres[r] for r in lr]


# ---------------------------------------------------------------------------
# In process: the one-device mesh (a world of one)
# ---------------------------------------------------------------------------

SAN_RECS = {"jax": [], "port": []}
jrpc.REGISTRY.register("mesh.san_rec",
                       lambda *a: SAN_RECS["jax"].append(
                           [np.asarray(x).tolist() for x in a]))
trpc.REGISTRY.register("mesh.san_rec",
                       lambda *a: SAN_RECS["port"].append(
                           [np.asarray(x).tolist() for x in a]))


def _jax_sanitize_program(sanitize):
    """tests/test_sanitizer.py:134-160's program, in JAX (under
    ``jax.jit``: the eager shard_map takes seconds an op)."""
    from jax.sharding import Mesh, PartitionSpec as JP
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("d",))

    def region(x):
        q = j_team_queue()
        q = q.enqueue("mesh.san_rec", x * 2)
        q = q.enqueue("mesh.san_rec", jnp.float32(0.5))
        j_set_team_queue(q)
        return jnp.cumsum(x) + 1

    SAN_RECS["jax"].clear()
    f = j_expand(region, mesh, (JP("d"),), JP("d"), queue=True,
                 sanitize=sanitize)
    sq = jrpc.ShardedRpcQueue.create(1, 8, 4, 64)
    sq2, out = jax.jit(f)(sq, jnp.arange(4, dtype=jnp.int32))
    sq2.flush()
    jax.effects_barrier()
    return np.asarray(out), list(SAN_RECS["jax"])


def _port_sanitize_program(sanitize):
    """The same program through the port's ``expand``."""
    mesh = one_device_mesh("d", device="cpu")

    def region(x):
        q = texpand.team_queue()
        q = q.enqueue("mesh.san_rec", x * 2)
        q = q.enqueue("mesh.san_rec", 0.5)
        texpand.set_team_queue(q)
        return torch.cumsum(x, 0).to(torch.int32) + 1

    SAN_RECS["port"].clear()
    f = texpand.expand(region, mesh, (texpand.P("d"),), texpand.P("d"),
                       queue=True, sanitize=sanitize)
    sq = trpc.ShardedRpcQueue.create(1, 8, 4, 64, device="cpu")
    sq2, out = f(sq, torch.arange(4, dtype=torch.int32))
    assert sq2 is sq and sq.shards[0].sanitize == sanitize
    sq2.flush()
    trpc.effects_barrier()
    return out.numpy(), list(SAN_RECS["port"])


def test_expand_sanitize_matches_jax_one_device():
    """``expand(sanitize=True)`` against ``sanitize=False`` and against
    JAX's one-device program: the same outputs and the same records, no
    canary stomp or poison hit, one sharded epoch record."""
    got = {}
    for sanitize in (False, True):
        jout, jrecs = _jax_sanitize_program(sanitize)
        trpc.reset_sanitize_stats()
        tout, trecs = _port_sanitize_program(sanitize)
        np.testing.assert_array_equal(tout, jout)
        assert trecs == jrecs and len(trecs) == 2
        got[sanitize] = (tout, trecs)
    np.testing.assert_array_equal(got[True][0], got[False][0])
    assert got[True][1] == got[False][1]
    st = trpc.sanitize_stats()
    assert st["canary_stomps"] == 0 and st["poison_hits"] == 0
    assert len(st["epochs"]) == 1 and st["epochs"][0]["sharded"]


def test_one_device_mesh_is_the_unsharded_path():
    """The one-device mesh is bit-identical to the paths without one:
    ``device_run(mesh=)`` with batched and immediate hooks gives
    ``device_run``'s records and state, ``parallel_for(mesh=)`` the
    vmap's, and ``team_ptr`` pointers resolve through ``find_obj``."""
    from repro_torch.core.allocator import GenericAllocator as GA
    from repro_torch.core.allocator import find_obj, shard_heap
    from repro_torch.core.libc import LogRing, drain_log_lines
    mesh = one_device_mesh("dev", device="cpu")
    runs = []
    for m in (None, mesh):
        recs = []
        hooks = [HostHook(every=3, extract=lambda i, s: s[0],
                          host_fn=lambda i, v: recs.append((i, v)),
                          name="mesh.one.a", batched=True),
                 HostHook(every=2, extract=lambda i, s: s * 2.0,
                          host_fn=lambda i, v: recs.append(
                              (i, np.asarray(v).tolist())),
                          name="mesh.one.b", batched=True)]
        final = device_run(lambda i, s: s + float(i), torch.zeros((3,)), 10,
                           hooks=hooks, mesh=m)
        trpc.effects_barrier()
        runs.append((final, recs))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    arr = torch.arange(16.0)
    body = lambda i, a: a[i] * 3.0 + i  # noqa: E731
    assert torch.equal(texpand.parallel_for(body, 13, arr, mesh=mesh),
                       texpand.parallel_for(body, 13, arr))

    def region():
        st = texpand.team_heap()
        st, p = GA.malloc(st, 8 + texpand.team_id())
        texpand.set_team_heap(st)
        texpand.set_team_queue(texpand.team_queue().log(
            texpand.team_id(), p.to(torch.float32)))
        return texpand.team_ptr(p)[None]

    f = texpand.expand(region, mesh, (), texpand.P("dev"), heap=True,
                       queue=True)
    heap = shard_heap(GA.init(64, cap=8, device="cpu"), 1)
    ring = LogRing.create_sharded(1, 16, device="cpu")
    heap2, ring2, gptrs = f(heap, ring)
    assert heap.shards.count.tolist() == [0]        # the input is unchanged
    drain_log_lines()
    ring2.flush()
    trpc.effects_barrier()
    assert drain_log_lines() == [(0, 0.0)] and gptrs.tolist() == [0]
    fo, b, s = find_obj(heap2, gptrs[0])
    assert (int(fo), int(b), int(s)) == (1, 0, 8)
    # JAX's one-row protocol: the row as a plain state and back
    view = heap2.local_view()
    assert torch.equal(view.count, heap2.shards.count[0])
    back = heap2.with_local(view)
    assert all(torch.equal(getattr(back.shards, f), t)
               for f, t in vars(heap2.shards).items()
               if isinstance(t, torch.Tensor))


def test_expand_refusals():
    """Specs outside ``P()``/``P(axes)``, tensors off the mesh's device
    type, sharded objects of the wrong row count, a flush inside a region
    and returning hooks under a mesh all raise."""
    mesh = one_device_mesh("d", device="cpu")
    P = texpand.P
    with pytest.raises(ValueError, match="unsupported spec"):
        texpand.expand(lambda x: x, mesh, (P("d", None),), P())
    with pytest.raises(ValueError, match="unsupported spec"):
        texpand.expand(lambda x: x, mesh, (P("model"),), P())
    with pytest.raises(TypeError, match="not a repro_torch P"):
        texpand.expand(lambda x: x, mesh, (("d",),), P())
    f = texpand.expand(lambda x: x + 1, mesh, (P("d"),), P("d"))
    assert f(torch.zeros(2)).tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="for a mesh on cpu"):
        f(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="for a mesh on cpu"):
        texpand.parallel_for(lambda i: i, 4, mesh=mesh, device="meta")
    two = trpc.ShardedRpcQueue.create(2, 4, device="cpu")
    g = texpand.expand(lambda: None, mesh, (), P(), queue=True)
    with pytest.raises(ValueError, match="2 rows for a mesh of 1"):
        g(two)
    one = trpc.ShardedRpcQueue.create(1, 4, device="cpu")
    with pytest.raises(ValueError, match="synchronous"):
        texpand.expand(lambda: None, mesh, (), P(), queue=True,
                       queue_async=True)(one)

    def flushes():
        texpand.team_queue().flush()

    with pytest.raises(RuntimeError, match="inside an expanded region"):
        texpand.expand(flushes, mesh, (), P(), queue=True)(one)

    def flushes_sharded():
        one.flush()

    with pytest.raises(RuntimeError, match="inside an expanded region"):
        texpand.expand(flushes_sharded, mesh, (), P())()
    ret = HostHook(every=1, extract=lambda i, s: s, host_fn=print,
                   batched=True, returns=trpc.ShapeDtype((), torch.float32),
                   consume=lambda i, s, v, ok: s)
    with pytest.raises(ValueError, match="under mesh="):
        device_run(lambda i, s: s, torch.zeros(()), 2, hooks=[ret],
                   mesh=mesh)
    _, cfg = _kv_cfgs()
    with pytest.raises(ValueError, match="a mesh on cpu for a cache on cuda"):
        tkv.paged_cache_init(cfg, 4, 64, page_size=16, device="cuda",
                             mesh=mesh)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tkv.paged_cache_init(cfg, 4, 64, page_size=16, device="cpu",
                             mesh=object())
    with pytest.raises(RuntimeError, match="needs a world of 256 ranks"):
        make_production_mesh(device="cpu")
    assert production_shape(True) == ((2, 16, 16), ("pod", "data", "model"))
    assert texpand.num_teams() == 1 and not texpand.in_region()


def test_callback_in_mesh_from_the_walker_and_the_rules():
    """tests/test_analysis.py:183-199 in the port: the corpus case (mode
    ``trace``, the export-graph walker) gives ``CALLBACK_IN_MESH`` and not
    ``CALLBACK_IN_LOOP``; run under a capture, the event rules flag the
    same call (``rpc_immediate``'s ``in_mesh``); the same region with the
    call batched on the team queue, and a hooked ``device_run(mesh=)``,
    are clean."""
    case = {c.name: c for c in corpus.CASES}["callback_in_mesh"]
    assert case.mode == "trace"
    report = corpus.run_case(case, device="cpu")
    assert report.codes == ["CALLBACK_IN_MESH"]
    with capture() as cap:
        case.fn(device="cpu")
    assert cap.report().codes == ["CALLBACK_IN_MESH"]
    mesh = one_device_mesh("dev", device="cpu")
    h = HostHook(every=1, extract=lambda i, s: s, host_fn=lambda i, v: None,
                 name="mesh.clean")
    with capture() as cap:
        device_run(lambda i, s: s + 1.0, torch.zeros(()), 3, hooks=[h],
                   mesh=mesh)
    assert "CALLBACK_IN_MESH" not in cap.report().codes


# ---------------------------------------------------------------------------
# Worlds of 4 and 2 (gloo, one process a team)
# ---------------------------------------------------------------------------

_WORLD4 = r"""
import torch
from repro_torch.core.allocator import (GenericAllocator as GA, find_obj,
                                        shard_heap)
from repro_torch.core.device_main import HostHook, device_run
from repro_torch.core.expand import (P, expand, num_teams, num_threads,
                                     parallel_for, serial_for, set_team_heap,
                                     set_team_queue, team_heap, team_id,
                                     team_ptr, team_queue, thread_id,
                                     ws_range)
from repro_torch.core.libc import LogRing, drain_log_lines
from repro_torch.core.rpc import effects_barrier, reset_rpc_stats, rpc_stats
from repro_torch.launch.mesh import make_debug_mesh, make_mesh

mesh = make_debug_mesh(2, 2, device="cpu")
out = {}

def region():
    st = team_heap()
    st, p = GA.malloc(st, 8 + team_id())
    set_team_heap(st)
    set_team_queue(team_queue().log(team_id(), p.to(torch.float32)))
    return team_ptr(p)[None]

f = expand(region, mesh, in_specs=(), out_specs=P(("data", "model")),
           heap=True, queue=True)

def once():
    heap = shard_heap(GA.init(64, cap=8, device="cpu"), 4)
    ring = LogRing.create_sharded(4, 16, device="cpu")
    heap2, ring2, gptrs = f(heap, ring)
    drain_log_lines()
    ring2.flush()
    effects_barrier()
    return heap2, gptrs, drain_log_lines()

heap2, gptrs, recs1 = once()
out["gptrs"] = gptrs.tolist()
out["found"] = [[int(v) for v in find_obj(heap2, int(g))] for g in gptrs]
_, _, recs2 = once()
out["recs"] = [recs1, recs2]

def vocab(x):
    s, c = ws_range(8)
    return torch.stack([team_id(), thread_id(), torch.tensor(num_teams()),
                        torch.tensor(num_threads()), s, torch.tensor(c)]
                       ).to(torch.int32)[None] + 0 * x[:1, None]

v = expand(vocab, mesh, (P("data"),), P(("data", "model")))(
    torch.zeros(2, dtype=torch.int32))
out["vocab"] = v.tolist()

dev = make_mesh((4,), ("dev",), device="cpu")
recs = []
hook = HostHook(every=3,
                extract=lambda i, s: s[0] + team_id().to(torch.float32),
                host_fn=lambda i, x: recs.append((i, x)), name="hook.mesh")
reset_rpc_stats()
final = device_run(lambda i, s: s + 1.0, torch.zeros((2,)), 10,
                   hooks=[hook], mesh=dev)
effects_barrier()
out["hook"] = {"final": final.tolist(), "recs": recs,
               "calls": rpc_stats("hook.mesh")["calls"]}

arr = torch.arange(64.0)
body = lambda i, a: a[i] * 3.0 + i
out["ragged"] = []
for n in (30, 7, 64, 61, 3):
    pf = parallel_for(body, n, arr, mesh=mesh)
    sf = serial_for(body, n, arr)
    out["ragged"].append([n, list(pf.shape), bool(torch.equal(pf, sf))])
report(out)
"""


def test_world_of_four(tmp_path):
    """A (2, 2) ("data", "model") world: tests/test_sharded_runtime.py:
    559-600's team heap and queue program (sorted global pointers [0, 64,
    128, 192], ``find_obj`` sizes ``8 + d``, records ``(d, 0.0)`` replayed
    team by team, the same twice), the team vocabulary (row-major team
    ids, ``ws_range``), ``device_run(mesh=)``'s hooks (:603-629: 12 calls
    on the first rank, none elsewhere, every rank the final state) and
    ragged ``parallel_for`` against ``serial_for`` (:656-672, red in JAX,
    so held against ``serial_for``), every rank."""
    reports = run_world(_WORLD4, 4, str(tmp_path))
    expect_recs = [(i, float(i + d)) for d in range(4) for i in (3, 6, 9)]
    for rank, (rep,) in enumerate(reports):
        assert rep["gptrs"] == [0, 64, 128, 192]
        assert rep["found"] == [[1, 64 * d, 8 + d] for d in range(4)]
        first = [[d, 0.0] for d in range(4)]
        assert rep["recs"] == ([first, first] if rank == 0 else [[], []])
        assert rep["vocab"] == [[d, d, 4, 4, 2 * d, 2] for d in range(4)]
        assert rep["hook"]["final"] == [10.0, 10.0]
        assert rep["hook"]["calls"] == (12 if rank == 0 else 0)
        assert rep["hook"]["recs"] == ([list(r) for r in expect_recs]
                                       if rank == 0 else [])
        for n, shape, same in rep["ragged"]:
            assert shape == [n] and same, (n, shape)


_WORLD2 = r"""
import numpy as np, torch
from repro_torch.core.device_main import HostHook, device_run
from repro_torch.core.expand import team_id
from repro_torch.core.rpc import REGISTRY, ShapeDtype, effects_barrier
from repro_torch.evaluation.allocator import mesh_section
from repro_torch.launch.mesh import make_mesh, make_rank_mesh

mesh = make_mesh((2,), ("dev",), device="cpu")
out = {}
REGISTRY.register("mesh.sq", lambda x: np.int32(x) * np.int32(x))

def step(i, s, lq):
    lq, t = lq.enqueue_ticketed("mesh.sq", (s[0] + team_id()).to(torch.int32),
                                returns=ShapeDtype((), torch.int32))
    return s + 1.0, lq

final, q = device_run(step, torch.zeros((1,)), 3, mesh=mesh,
                      thread_queue=True, return_queue=True, queue_reply=16)
out["thread_queue"] = {"final": final.tolist(),
                       "got": [[int(q.result(d, t)) for t in range(3)]
                               for d in range(2)]}
for mode in ("sync", "async"):
    recs = []
    hook = HostHook(every=2,
                    extract=lambda i, s: s + team_id().to(torch.float32),
                    host_fn=lambda i, v: recs.append((i, v.tolist())),
                    name="hook.mesh_payload")
    f = device_run(lambda i, s: s + 1.0, torch.zeros((3,)), 4, hooks=[hook],
                   mesh=mesh, queue_async=mode == "async")
    effects_barrier()
    out["payload_" + mode] = {"final": f.tolist(), "recs": recs}
out["fig6"] = mesh_section(mesh, make_rank_mesh("dev", device="cpu"),
                           iters=2)

from repro_torch.core.expand import P, expand, team_queue
from repro_torch.core.rpc import ShardedRpcQueue
got = []
REGISTRY.register("mesh.only_team1", lambda x: got.append(int(x)))

def only_team1():
    if int(team_id()) == 1:
        team_queue().enqueue("mesh.only_team1", 7)

q1, _ = expand(only_team1, mesh, (), P(), queue=True)(
    ShardedRpcQueue.create(2, 4, device="cpu"))
q1.flush()
effects_barrier()
out["only_team1"] = got

# a sharded state (one row a team) against each team's run without a mesh
def sharded_step(i, s):
    return s * 3.0 + i + team_id().to(torch.float32)

rows = torch.tensor([[1.0, 2.0], [5.0, -1.0]])
srecs = []
shook = HostHook(every=2, extract=lambda i, s: s[0, 0], name="hook.sharded",
                 host_fn=lambda i, v: srecs.append((i, float(v))))
sfinal = device_run(sharded_step, rows, 4, hooks=[shook], mesh=mesh,
                    state_spec=P("dev"))
effects_barrier()
serial = [device_run(lambda i, s, d=d: s * 3.0 + i + d, rows[d:d + 1], 4)
          for d in range(2)]
out["state_spec"] = {"final": sfinal.tolist(),
                     "serial": torch.cat(serial).tolist(), "recs": srecs}

# the drain's fault policy set by expand: a record that fails once is
# redriven on the first rank
from repro_torch.core.rpc import RetryPolicy, flush_stats, reset_rpc_stats
flaky = {"calls": 0, "got": []}

def flaky_fn(x):
    flaky["calls"] += 1
    if flaky["calls"] == 1:
        raise RuntimeError("transient")
    flaky["got"].append(int(x))

REGISTRY.register("mesh.flaky", flaky_fn, idempotent=True)

def enqueue_flaky():
    team_queue().enqueue("mesh.flaky", team_id())

reset_rpc_stats()
q2, _ = expand(enqueue_flaky, mesh, (), P(), queue=True,
               queue_retry=RetryPolicy(3))(
    ShardedRpcQueue.create(2, 4, device="cpu"))
q2.flush()
effects_barrier()
out["retry"] = dict(flaky, retries=flush_stats()["retries"])
report(out)
"""


def _jax_mesh_child() -> subprocess.Popen:
    """JAX's Fig. 6 mesh child (benchmarks/allocator_bench.py:267-327) on
    2 forced host devices, started in the background."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    return subprocess.Popen([sys.executable, "-c", jab._MESH_CHILD],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _hook_rows(d):
    """``(step, s[0, 0])`` at steps 2 and 4 of team ``d``'s run of
    ``s = s * 3 + i + d`` from row ``d`` of the world's sharded state."""
    s, out = (1.0, 5.0)[d], []
    for i in range(4):
        s = s * 3.0 + i + d
        if (i + 1) % 2 == 0:
            out.append((i + 1, s))
    return out


def test_world_of_two_and_fig6_mesh_section(tmp_path):
    """A ("dev",) world of 2: ``device_run(mesh=, thread_queue=,
    return_queue=)`` replies ``[[0, 1, 4], [1, 4, 9]]`` on every rank
    (:467-505, red in JAX, so held against the values it asserts); the
    array-payload hook (:631-654), sync and async, replayed team by team
    on the first rank only; Fig. 6's mesh section equal to JAX's child's
    output but its times (per-team pointers bit-identical to the single
    heap, the one-device mesh's too, 2 records team by team); a record of
    a callee that only the second team enqueued drains on the first
    rank; ``device_run(mesh=, state_spec=P("dev"))`` on a state of one
    row a team gives each team's run without a mesh, gathered in team
    order; ``expand(queue_retry=)`` redrives a record that failed once,
    on the first rank alone."""
    child = _jax_mesh_child()
    try:
        reports = run_world(_WORLD2, 2, str(tmp_path))
        jout, jerr = child.communicate(timeout=560)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, jerr[-3000:]
    jinfo = json.loads(jout.strip().splitlines()[-1])
    expect = [[i, [float(i + d)] * 3] for d in range(2) for i in (2, 4)]
    keys = ("mesh_devices", "grid", "per_device_bit_identical_to_single_heap",
            "one_device_mesh_bit_identical", "queue_flush_records",
            "queue_flush_device_major")
    for rank, (rep,) in enumerate(reports):
        assert rep["thread_queue"] == {"final": [3.0],
                                       "got": [[0, 1, 4], [1, 4, 9]]}
        for mode in ("sync", "async"):
            assert rep["payload_" + mode]["final"] == [4.0] * 3
            assert rep["payload_" + mode]["recs"] == (expect if rank == 0
                                                      else [])
        fig6 = rep["fig6"]
        assert fig6["per_device_bit_identical_to_single_heap"]
        assert fig6["one_device_mesh_bit_identical"]
        assert fig6["mesh_us_per_region"] > 0
        assert fig6["one_device_us_per_region"] > 0
        if rank == 0:
            assert {k: fig6[k] for k in keys} == {k: jinfo[k] for k in keys}
        else:
            assert fig6["queue_flush_records"] == 0
        # a callee that only the second team enqueued drains on the first
        # rank, which registered it but never enqueued it
        assert rep["only_team1"] == ([7] if rank == 0 else [])
        # state_spec=P("dev"): every team's row is its own run's, gathered
        # in team order; the hook's records team by team on the first rank
        st = rep["state_spec"]
        assert st["final"] == st["serial"]
        assert st["recs"] == ([[i, st_i] for d in range(2)
                               for i, st_i in _hook_rows(d)]
                              if rank == 0 else [])
        assert rep["retry"] == ({"calls": 3, "got": [0, 1], "retries": 1}
                                if rank == 0 else
                                {"calls": 0, "got": [], "retries": 0})
