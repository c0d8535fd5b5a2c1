"""The port's RpcManifest (durable transport ids) against the JAX
package's, on the CPU.

In process: ``tests/test_rpc_transport.py``'s round trip, its tampered
signature (refused, naming the pad) and its unbound host (refused, naming
the callee; adopted with ``require_hosts=False``).  Across processes, in
three fresh interpreters: a port process makes the same registrations as
a JAX process (immediate calls that make landing pads of value, ref and
arena-ref signatures, queue callees, interned formats, a queue and a
sharded queue), and the two manifests' JSON must be byte-equal; each
process adopts the other package's manifest and resolves the same ids;
and JAX's ``test_cross_process_conformance`` on the port: one port
process runs the batched program (``fprintf`` and a ticketed remote
malloc) and exports its manifest, another adopts it before issuing the
same program, and the printf lines, heap pointers, watermark and
reply-arena pointers must be equal."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import rpc as jrpc  # noqa: E402
from repro_torch.core import libc as tlibc  # noqa: E402,F401 (formats)
from repro_torch.core import rpc as trpc  # noqa: E402

# The registrations both packages make in a fresh process, the package
# the second argument; writes ``reg_<pkg>.json``.
_REGISTER = r"""
import json, os, sys
outdir, pkg = sys.argv[1], sys.argv[2]
if pkg == "jax":
    import jax, jax.numpy as jnp
    from repro.core import libc, rpc
    from repro.core.allocator import GenericAllocator as GA
    I32, F32, BF16 = jnp.int32, jnp.float32, jnp.bfloat16
    num = lambda v, dt: jnp.asarray(v, dt)
    zeros = jnp.zeros
    heap = GA.init(64, cap=4)
    kw = {}
    run = lambda f: (jax.jit(f)(), jax.effects_barrier())
else:
    import torch
    from repro_torch.core import libc, rpc
    from repro_torch.core.allocator import GenericAllocator as GA
    I32, F32, BF16 = torch.int32, torch.float32, torch.bfloat16
    num = lambda v, dt: torch.tensor(v, dtype=dt)
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt)
    heap = GA.init(64, cap=4, device="cpu")
    kw = {"device": "cpu"}
    run = lambda f: (f(), rpc.effects_barrier())

for name in ("xf.alpha", "xf.beta"):
    rpc.REGISTRY.register(name, lambda *a: None)


def prog():
    rpc.rpc_call("xf.alpha", num(1, I32), result_shape=())
    rpc.rpc_call("xf.alpha", zeros((3,), F32),
                 rpc.Ref(zeros((2, 2), BF16)), result_shape=())
    rpc.rpc_call("xf.beta", rpc.ArenaRef(zeros((64,), I32), num(0, I32),
                                         heap, access=rpc.READ),
                 num(2.5, F32), result_shape=())
    return num(0, I32)


run(prog)
for name in ("xf.alpha", "xf.beta"):
    rpc.REGISTRY.batch_callee_id(name)
for text in ("xf %d", "xf %.2f and %d", "heap.xf"):
    libc._intern_fmt(text)
rpc.RpcQueue.create(8, width=4, payload_capacity=32, reply_capacity=8, **kw)
rpc.ShardedRpcQueue.create(4, 16, width=3, payload_capacity=64,
                           reply_capacity=16, **kw)
with open(os.path.join(outdir, f"reg_{pkg}.json"), "w") as f:
    f.write(rpc.export_manifest().to_json())
"""

# Adopt the other package's registration manifest (the registrations ran
# first: its callees are bound) and report how its ids resolve here.
_ADOPT_OTHER = r"""
other = "port" if pkg == "jax" else "jax"
m = rpc.RpcManifest.load(os.path.join(outdir, f"reg_{other}.json"))
rpc.adopt_manifest(m)
pads = rpc.pad_table()
seen = {"pads": {str(pid): pid in pads and pads[pid][0] == e["callee"]
                 and tuple(pads[pid][1:]) == rpc._sig_from_json(
                     e["signature"])
                 for pid, e in m.pads.items()},
        "callees": {str(cid): rpc.REGISTRY.batch_callee_id(name) == cid
                    for cid, name in m.callees.items()},
        "formats": {str(fid): libc._intern_fmt(text) == fid
                    for fid, text in m.formats.items()}}
with open(os.path.join(outdir, f"adopted_by_{pkg}.json"), "w") as f:
    json.dump(seen, f)
"""

# tests/test_rpc_transport.py's _XP_PROGRAM on the port (CPU queues),
# its mode the third argument.
_XP_PROGRAM = r"""
import torch
from repro_torch.core import libc
from repro_torch.core import rpc as rpc_mod
from repro_torch.core.allocator import GenericAllocator as GAlloc
from repro_torch.core.rpc import RpcQueue, RpcManifest

mode = sys.argv[3]
HEAP, FMT = "heap.xproc", "xp %d %.1f"
libc.remote_heap_register(HEAP, GAlloc.init(256, cap=16, device="cpu"))

if mode == "adopt":
    # fresh process: bind ids from the manifest before issuing anything
    rpc_mod.adopt_manifest(
        RpcManifest.load(os.path.join(outdir, "manifest.json")))

fid = libc._intern_fmt(FMT)       # content-hashed: same id either way
nid = libc._intern_fmt(HEAP)
i32 = lambda v: torch.tensor(v, dtype=torch.int32)
q = RpcQueue.create(8, width=4, payload_capacity=32, reply_capacity=8,
                    device="cpu")
libc.fprintf(q, FMT, i32(3), torch.tensor(1.5))
q, t = libc.remote_malloc_enqueue(q, HEAP, i32([8, 16]))
libc.fprintf(q, FMT, i32(4), torch.tensor(-0.5))
q.flush()
ptrs = q.result(t, (2,), torch.int32).tolist()
rpc_mod.effects_barrier()
state, host_ptrs = libc.remote_malloc_results(HEAP)
out = {"printf": libc.drain_printf(),
       "host_ptrs": [p.tolist() for p in host_ptrs],
       "watermark": int(state.watermark),
       "device_ptrs": ptrs}
with open(os.path.join(outdir, f"{mode}.json"), "w") as f:
    json.dump(out, f)
if mode == "export":
    rpc_mod.export_manifest().save(os.path.join(outdir, "manifest.json"))
"""


def _run(code: str, *args: str) -> None:
    env = dict(os.environ)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env["PYTHONPATH"] = os.path.join(root, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code, *args],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-4000:]


def test_cross_framework_manifests_are_byte_equal_and_adoptable(tmp_path):
    """A port process and a JAX process that register the same callees,
    pads, formats and queues write byte-equal manifests; each adopts the
    other's and resolves every id to the same callee, pad and string;
    then the port's cross-process conformance (export in one process,
    adopt in a fresh one) gives bit-equal effects and results."""
    _run(_REGISTER + _XP_PROGRAM, str(tmp_path), "port", "export")
    _run(_REGISTER + _ADOPT_OTHER, str(tmp_path), "jax")
    _run(_REGISTER + _ADOPT_OTHER + _XP_PROGRAM, str(tmp_path), "port",
         "adopt")
    reg = {p: (tmp_path / f"reg_{p}.json").read_bytes()
           for p in ("jax", "port")}
    assert reg["port"] == reg["jax"]
    doc = json.loads(reg["port"])
    assert len(doc["pads"]) == 3 and len(doc["callees"]) == 2
    assert len(doc["formats"]) == 3
    # a sharded queue notes its shard's geometry and its own, as JAX's
    assert [(g["capacity"], g["shards"]) for g in doc["queues"]] == \
        [(8, 1), (16, 1), (16, 4)]
    for pkg in ("jax", "port"):
        seen = json.loads((tmp_path / f"adopted_by_{pkg}.json").read_text())
        for section in ("pads", "callees", "formats"):
            assert seen[section] and all(seen[section].values()), \
                (pkg, section, seen[section])
    a, b = (json.loads((tmp_path / f"{m}.json").read_text())
            for m in ("export", "adopt"))
    assert a == b
    assert a["printf"] == ["xp 3 1.5", "xp 4 -0.5"]
    assert a["device_ptrs"] == a["host_ptrs"][0] == [0, 8]


def test_manifest_round_trips_ids():
    """export -> JSON -> from_json -> adopt re-derives identical ids."""
    name, sig = "conf.roundtrip", (("val", (), "int32"),)
    trpc.REGISTRY.register(name, lambda x: np.int32(x))
    pid, _ = trpc.REGISTRY.landing_pad(name, sig)
    assert pid == jrpc.stable_pad_id(name, sig)
    m = trpc.RpcManifest.from_json(trpc.export_manifest().to_json())
    assert m.pads[pid]["callee"] == name
    trpc.adopt_manifest(m)              # re-adoption in place is a no-op
    assert trpc.REGISTRY.landing_pad(name, sig)[0] == pid
    assert trpc.RpcManifest.from_json(m.to_json()).to_json() == m.to_json()


def test_adopt_manifest_rejects_mismatched_signature():
    """A manifest whose recorded signature no longer hashes to its pad id
    is refused with an error naming the pad's callee."""
    name, sig = "conf.mismatch", (("val", (), "int32"),)
    trpc.REGISTRY.register(name, lambda x: np.int32(x))
    trpc.REGISTRY.landing_pad(name, sig)
    doc = json.loads(trpc.export_manifest().to_json())
    for entry in doc["pads"].values():
        if entry["callee"] == name:
            entry["signature"][0][2] = "float32"    # tamper the dtype
    tampered = trpc.RpcManifest.from_json(json.dumps(doc))
    with pytest.raises(ValueError, match=name):
        trpc.adopt_manifest(tampered)


def test_adopt_manifest_requires_hosts():
    """A manifest callee with no registered host function is refused,
    naming the callee; ``require_hosts=False`` adopts it."""
    name = "conf.unbound_host"
    trpc.REGISTRY.register(name, lambda *a: None)
    cid = trpc.REGISTRY.batch_callee_id(name)
    m = trpc.RpcManifest.from_json(trpc.export_manifest().to_json())
    trpc.REGISTRY.unregister(name)
    try:
        with pytest.raises(ValueError, match=name):
            trpc.adopt_manifest(m)
        trpc.adopt_manifest(m, require_hosts=False)   # explicit opt-out
        assert trpc.REGISTRY.batch_names[cid] == name
    finally:
        trpc.REGISTRY.unregister(name)


def test_manifest_version_and_format_hash_are_checked():
    with pytest.raises(ValueError, match="version"):
        trpc.RpcManifest.from_json(json.dumps({"version": 2}))
    with pytest.raises(ValueError, match="version"):
        trpc.adopt_manifest(trpc.RpcManifest(version=0))
    with pytest.raises(ValueError, match="content hash"):
        trpc.adopt_manifest(trpc.RpcManifest(formats={7: "not its hash"}))
    # a format the process never interned is refused at the drain with
    # the manifest named
    with pytest.raises(KeyError, match="adopt_manifest"):
        tlibc._resolve_fmt(12345)
