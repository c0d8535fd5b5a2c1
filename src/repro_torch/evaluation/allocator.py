"""Paper Fig. 6: allocator throughput, v1 (request at a time) against v2
(vectorised) (the JAX package's ``benchmarks/allocator_bench.py``).

All threads of all teams allocate a region at a parallel region's entry
and free it at the exit, the SPEC-OMP-style stress pattern.  Contestants
a grid:

  generic         one shared structure, a request at a time (the paper's
                  single-lock serial baseline),
  balanced v1     chunked, each chunk's requests one at a time and frees
                  reclaimed by ``cap`` masked steps (``malloc_grid_scan``),
  balanced v2     chunked and vectorised: one prefix-sum step a chunk,
                  frees one suffix-scan reclaim (``malloc_grid``),
  sizeclass_bulk  the size-class heap's flat bulk path.

On a card the request-at-a-time contestants are Python loops of launches
(v1's free is ``cap`` steps a request), so ``serial_limit`` runs them only
up to that many requests.  Then ``find_obj`` (the paper's ``_FindObj``,
run on every ``ArenaRef`` the RPC layer marshals): the O(cap) linear scan
against the O(log cap) sorted index, the marshalled objects against the
linear scan's, and one ``ArenaRef`` round trip; then the
funneled-against-sharded heap and queue contrast.  Every section returns
its rows' numbers and its evidence: the pointers and records, which are
bit-equal on every device.  Last, :func:`mesh_section` (JAX's
``_mesh_section``): ``malloc_grid`` and a sharded ring's flush in a
region expanded over a real mesh (a ``gloo`` world of
:data:`MESH_DEVICES` processes on the CPU, :func:`run_mesh`; the
one-device mesh on the card), each team's pointers bit-identical to the
single heap's; a failure raises, it is never skipped.
"""
from __future__ import annotations

import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import rpc as rpc_mod
from repro_torch.core.allocator import BalancedAllocator as BA
from repro_torch.core.allocator import GenericAllocator as GA
from repro_torch.core.allocator import ShardedAllocator as SA
from repro_torch.core.allocator import SizeClassAllocator as SC
from repro_torch.core.allocator import find_obj, find_obj_linear, shard_heap
from repro_torch.core.expand import (P, expand, set_team_heap, set_team_queue,
                                     team_heap, team_id, team_queue)
from repro_torch.core.libc import LogRing, drain_log_lines
from repro_torch.evaluation.common import (contrast_best_of, emit,
                                           sharded_queue_contrast,
                                           time_drained, time_region)
from repro_torch.launch.mesh import init_world, make_mesh
from repro_torch.launch.world import run_world

GRIDS = [(1, 1), (8, 4), (16, 8), (32, 16)]
#: 128 threads x 132 teams: one team an SM of an H100.
CARD_GRID = (128, 132)
FIND_OBJ_CAPS = [256, 4096]
FIND_OBJ_PROBES = 256
SHARD_DEVICES = 4                 # logical shards, one device
SHARD_GRID = (32, 16)
QUEUE_PER_SHARD = 64
QUEUE_ITERS = 5                   # the queue contrast's timed iterations
MESH_DEVICES = 2                  # the CPU world of the mesh section
MESH_GRID = (8, 4)
MESH_SPAN = 4096                  # pages of each team's balanced heap


def grid_contestants(threads: int, teams: int, device,
                     serial: bool = True) -> Dict:
    """The grid's contestants, each ``() -> (ptrs, watermark)``; without
    the request-at-a-time ones when ``serial`` is False."""
    n = threads * teams
    n_slots, m_slots = min(threads, 8), min(teams, 4)
    cap = max(n // 4, 8) * 4
    sizes_grid = torch.full((threads, teams), 8, dtype=torch.int32,
                            device=device)
    sizes_flat = sizes_grid.reshape(n)

    def balanced_v2():
        st = BA.init(n * 64, n_slots, m_slots, cap=cap, device=device)
        st, ptrs = BA.malloc_grid(st, threads, teams, sizes_grid)
        st = BA.free_grid(st, threads, teams, ptrs)
        return ptrs, st.watermark

    def balanced_v1():
        st = BA.init(n * 64, n_slots, m_slots, cap=cap, device=device)
        st, ptrs = BA.malloc_grid_scan(st, threads, teams, sizes_grid)
        st = BA.free_grid_scan(st, threads, teams, ptrs)
        return ptrs, st.watermark

    def generic_serial():
        st = GA.init(n * 64, cap=4 * n, device=device)
        st, ptrs = GA.malloc_many_serial(st, sizes_flat)
        st = GA.free_many_serial(st, ptrs)
        return ptrs, st.watermark

    def sizeclass_bulk():
        st = SC.init(n * 64, cap=4 * n, device=device)
        st, ptrs = SC.malloc_many(st, sizes_flat)
        st = SC.free_many(st, ptrs)
        return ptrs, st.watermark

    out = {"balanced_v2": balanced_v2, "sizeclass_bulk": sizeclass_bulk}
    if serial:
        out.update(balanced_v1=balanced_v1, generic=generic_serial)
    return out


def grid_section(device, grids: Sequence[Tuple[int, int]] = GRIDS, *,
                 serial_limit: Optional[int] = None, warmup: int = 2,
                 iters: int = 5
                 ) -> Tuple[Dict, Dict]:
    """JAX's ``_grid_section``.  Returns the per-grid records (us an
    allocation) and the evidence (each contestant's pointers and
    watermarks as CPU tensors)."""
    recs, evidence = {}, {}
    for threads, teams in grids:
        n = threads * teams
        serial = serial_limit is None or n <= serial_limit
        fns = grid_contestants(threads, teams, device, serial)
        key = f"{threads}x{teams}"
        t = {name: time_region(fn, warmup=warmup, iters=iters, device=device)
             for name, fn in fns.items()}
        evidence[key] = {name: tuple(x.cpu() for x in fn())
                         for name, fn in fns.items()}
        t2, tsc = t["balanced_v2"], t["sizeclass_bulk"]
        rec = {"balanced_v2_us_per_alloc": t2 / n * 1e6,
               "sizeclass_bulk_us_per_alloc": tsc / n * 1e6,
               "request_at_a_time": serial}
        if serial:
            t1, tg = t["balanced_v1"], t["generic"]
            emit(f"fig6/alloc_{key}/generic", tg / n * 1e6,
                 f"total_us={tg * 1e6:.1f}")
            emit(f"fig6/alloc_{key}/balanced_v1", t1 / n * 1e6,
                 f"speedup_vs_generic={tg / t1:.2f}x")
            emit(f"fig6/alloc_{key}/balanced_v2", t2 / n * 1e6,
                 f"speedup_vs_v1={t1 / t2:.2f}x")
            emit(f"fig6/alloc_{key}/sizeclass_bulk", tsc / n * 1e6,
                 f"speedup_vs_generic={tg / tsc:.2f}x")
            rec.update(generic_us_per_alloc=tg / n * 1e6,
                       balanced_v1_us_per_alloc=t1 / n * 1e6,
                       v2_speedup_vs_v1=t1 / t2, v2_speedup_vs_generic=tg / t2)
        else:
            emit(f"fig6/alloc_{key}/balanced_v2", t2 / n * 1e6,
                 f"total_us={t2 * 1e6:.1f}")
            emit(f"fig6/alloc_{key}/sizeclass_bulk", tsc / n * 1e6,
                 f"speedup_vs_v2={t2 / tsc:.2f}x")
        recs[key] = rec
    return recs, evidence


def marshal_probe(arena, state, probes) -> torch.Tensor:
    """``(base, size, found)`` of every probe pointer as the RPC layer
    marshals an ``ArenaRef`` (``rpc._marshal``, under ``torch.vmap``):
    (probes, 3) int32."""
    device = arena.device

    def one(p):
        _, ops, _ = rpc_mod._marshal(
            [rpc_mod.ArenaRef(arena, p, state, access=rpc_mod.READ)],
            device)
        return ops[0][1:4]                     # (ptr, base, size, found)

    return torch.vmap(one)(probes)


def lookup_probe(state, probes, lookup) -> torch.Tensor:
    """``(base, size, found)`` of every probe pointer by ``lookup``
    (``find_obj`` or ``find_obj_linear``) alone, under ``torch.vmap``:
    (probes, 3) int32, as :func:`marshal_probe` lays them out."""
    def one(p):
        found, base, size = lookup(state, p)
        return torch.stack([base.to(torch.int32), size.to(torch.int32),
                            found.to(torch.int32)])

    return torch.vmap(one)(probes)


def find_obj_section(device, caps: Sequence[int] = FIND_OBJ_CAPS,
                     n_probes: int = FIND_OBJ_PROBES, *, warmup: int = 2,
                     iters: int = 5
                     ) -> Tuple[Dict, Dict]:
    """JAX's ``_find_obj_section``: per cap, the linear against the sorted
    lookup (JAX times both through its marshalling; here the lookups
    alone, since the marshalling's launches hide their difference on a
    card), the marshalled objects equal to the linear lookup's (asserted),
    and one ``ArenaRef`` round trip."""
    if "bench.noop" not in rpc_mod.REGISTRY.hosts:
        rpc_mod.REGISTRY.register("bench.noop", lambda *a: np.int32(0))
    recs, evidence = {}, {}
    for cap in caps:
        heap = 8 * cap
        st = GA.init(heap, cap=cap, device=device)
        st, ptrs = GA.malloc_many(st, torch.full((cap - 1,), 8,
                                                 dtype=torch.int32,
                                                 device=device))
        arena = torch.zeros((heap,), device=device)
        rng = np.random.default_rng(0)
        live = ptrs.cpu().numpy()
        probes = torch.from_numpy(
            (rng.choice(live, n_probes)
             + rng.integers(0, 8, n_probes)).astype(np.int32)).to(device)
        t_lin = time_region(lookup_probe, st, probes, find_obj_linear,
                            warmup=warmup, iters=iters)
        t_v2 = time_region(lookup_probe, st, probes, find_obj,
                           warmup=warmup, iters=iters)
        lin = lookup_probe(st, probes, find_obj_linear).cpu()
        v2 = marshal_probe(arena, st, probes).cpu()
        if not torch.equal(lin, v2):
            raise AssertionError(f"find_obj cap {cap}: the linear lookup "
                                 "and the marshalling find different "
                                 "objects")
        ref = rpc_mod.ArenaRef(arena, probes[0], st, access=rpc_mod.READ)
        spec = rpc_mod.ShapeDtype((), torch.int32)

        def roundtrip():
            return rpc_mod.rpc_call("bench.noop", ref, result_shape=spec)[0]

        t_rpc = time_drained(roundtrip, warmup=warmup, iters=iters,
                             device=device)
        lin_us = t_lin / n_probes * 1e6
        v2_us = t_v2 / n_probes * 1e6
        emit(f"fig6/find_obj_cap{cap}/linear_v1", lin_us,
             f"probes={n_probes}")
        emit(f"fig6/find_obj_cap{cap}/sorted_v2", v2_us,
             f"speedup_vs_linear={t_lin / t_v2:.2f}x")
        emit(f"fig6/find_obj_cap{cap}/rpc_roundtrip", t_rpc * 1e6,
             "one ArenaRef round trip")
        recs[f"cap{cap}"] = {"linear_us_per_lookup": lin_us,
                             "sorted_us_per_lookup": v2_us,
                             "v2_speedup_vs_linear": t_lin / t_v2,
                             "rpc_roundtrip_us": t_rpc * 1e6}
        evidence[f"cap{cap}"] = {"ptrs": ptrs.cpu(), "probes": probes.cpu(),
                                 "marshalled": v2,
                                 "rpc": int(roundtrip().cpu())}
    return recs, evidence


def sharded_section(device, *, n_shards: int = SHARD_DEVICES,
                    grid: Tuple[int, int] = SHARD_GRID,
                    per_shard: int = QUEUE_PER_SHARD, rounds: int = 3,
                    warmup: int = 2, iters: int = 15) -> Tuple[Dict, Dict]:
    """JAX's ``_sharded_section`` (logical shards on one device): one heap
    serving a grid against ``n_shards`` shards serving 1/D of it each,
    then the queue contrast.  JAX asserts the sharded heap within 0.9x of
    the funneled one; this prints the ratio beside that target."""
    T, G = grid
    D, n = n_shards, T * G
    cap = max(n // 4, 8) * 4
    sizes = torch.full((T, G), 8, dtype=torch.int32, device=device)

    def funneled():
        st = BA.init(n * 64, 8, 4, cap=cap, device=device)
        st, ptrs = BA.malloc_grid(st, T, G, sizes)
        st = BA.free_grid(st, T, G, ptrs)
        return ptrs, st.watermark

    def sharded():
        st = shard_heap(BA.init(n * 64 // D, 8, 4, cap=cap // D,
                                device=device), D, span=n * 64 // D)
        st, ptrs = SA.malloc_grid(st, T // D, G, sizes.reshape(D, T // D, G))
        st = SA.free_grid(st, T // D, G, ptrs)
        return ptrs, st.shards.watermark

    t_fun, t_sh = contrast_best_of(funneled, sharded, rounds=rounds,
                                   drained=True, warmup=warmup, iters=iters,
                                   device=device)
    key = f"{T}x{G}_d{D}"
    emit(f"sharded/heap_{key}/funneled", t_fun / n * 1e6,
         f"total_us={t_fun * 1e6:.1f}")
    emit(f"sharded/heap_{key}/sharded", t_sh / n * 1e6,
         f"speedup_vs_funneled={t_fun / t_sh:.2f}x target>=0.9x")
    tq = sharded_queue_contrast(D, per_shard, device=device, warmup=warmup,
                                iters=QUEUE_ITERS)
    K = per_shard
    emit(f"sharded/queue_{D}x{K}/funneled", tq["funneled"] / (D * K) * 1e6,
         "")
    emit(f"sharded/queue_{D}x{K}/sharded", tq["sharded"] / (D * K) * 1e6,
         f"speedup_vs_funneled={tq['funneled'] / tq['sharded']:.2f}x")
    rec = {"logical_devices": D, "heap_grid": key,
           "heap_funneled_us_per_alloc": t_fun / n * 1e6,
           "heap_sharded_us_per_alloc": t_sh / n * 1e6,
           "heap_sharded_speedup": t_fun / t_sh, "heap_target": 0.9,
           "queue_records": D * K,
           "queue_funneled_us_per_record": tq["funneled"] / (D * K) * 1e6,
           "queue_sharded_us_per_record": tq["sharded"] / (D * K) * 1e6,
           "queue_sharded_speedup": tq["funneled"] / tq["sharded"]}
    evidence = {"funneled": tuple(x.cpu() for x in funneled()),
                "sharded": tuple(x.cpu() for x in sharded()),
                "queue_records": tq["records"]}
    return rec, evidence


def run(device, *, grids: Sequence[Tuple[int, int]] = GRIDS,
        serial_limit: Optional[int] = None, warmup: int = 2,
        iters: int = 5) -> Tuple[Dict, Dict]:
    """Every single-device section of Fig. 6: ``(records, evidence)``."""
    g, ge = grid_section(device, grids, serial_limit=serial_limit,
                         warmup=warmup, iters=iters)
    f, fe = find_obj_section(device, warmup=warmup, iters=iters)
    s, se = sharded_section(device, warmup=warmup)
    return ({"grids": g, "find_obj": f, "sharded": s},
            {"grids": ge, "find_obj": fe, "sharded": se})


def mesh_section(mesh, one_mesh, *, iters: int = 10) -> Dict:
    """JAX's ``_MESH_CHILD`` on ``mesh`` and on ``one_mesh`` (a mesh of one
    device), both on axis ``dev``: each team runs ``malloc_grid`` of the
    8 x 4 grid on its heap and logs the sum of its pointers on its ring
    row; the rings flush after the region.  Returns JAX's keys: each
    team's pointers against the single heap's (bit for bit), the
    one-device mesh's, the records this host's flush drained (the
    mesh's first rank drains all of them; another rank none) and whether
    they come team by team, and the mean microseconds of a region
    (heap and ring made in it, as JAX's).  Raises unless the pointers are
    bit-identical."""
    T, G = MESH_GRID
    device = mesh.device_type
    sizes = (torch.arange(T * G, dtype=torch.int32,
                          device=device).reshape(T, G) % 7) + 1

    def one(m):
        D = m.size()

        def region():
            st = team_heap()
            st, ptrs = BA.malloc_grid(st, T, G, sizes)
            set_team_heap(st)
            total = torch.sum(torch.where(ptrs >= 0, ptrs, 0))
            set_team_queue(team_queue().log(team_id(),
                                            total.to(torch.float32)))
            return ptrs[None]

        f = expand(region, m, (), P("dev"), heap=True, queue=True)

        def once():
            heap = shard_heap(BA.init(MESH_SPAN, 4, 2, cap=64, device=device),
                              D, span=MESH_SPAN)
            return f(heap, LogRing.create_sharded(D, 16, device=device))

        _, ring, ptrs = once()
        dt = time_region(once, warmup=0, iters=iters, device=device)
        rpc_mod.effects_barrier()
        drain_log_lines()
        ring.flush()
        rpc_mod.effects_barrier()
        return ptrs.cpu(), drain_log_lines(), dt

    ptrs_mesh, recs, dt_mesh = one(mesh)
    ptrs_one, _, dt_one = one(one_mesh)
    st = BA.init(MESH_SPAN, 4, 2, cap=64, device=device)
    _, ptrs_ref = BA.malloc_grid(st, T, G, sizes)
    ptrs_ref = ptrs_ref.cpu()
    local_ok = all(torch.equal(ptrs_mesh[d] % MESH_SPAN, ptrs_ref)
                   for d in range(mesh.size()))
    one_ok = torch.equal(ptrs_one[0], ptrs_ref)
    info = {"mesh_devices": mesh.size(), "grid": f"{T}x{G}",
            "per_device_bit_identical_to_single_heap": bool(local_ok),
            "one_device_mesh_bit_identical": bool(one_ok),
            "queue_flush_records": len(recs),
            "queue_flush_device_major":
                recs == sorted(recs, key=lambda r: r[0]),
            "mesh_us_per_region": dt_mesh * 1e6,
            "one_device_us_per_region": dt_one * 1e6}
    if not (local_ok and one_ok):
        raise AssertionError(f"Fig. 6 mesh section: a team's pointers "
                             f"differ from the single heap's: {info}")
    return info


_MESH_WORLD = """
from repro_torch.evaluation.allocator import mesh_section
from repro_torch.launch.mesh import make_mesh, make_rank_mesh
report(mesh_section(make_mesh((WORLD,), ("dev",), device="cpu"),
                    make_rank_mesh("dev", device="cpu")))
"""


def run_mesh(device) -> Dict:
    """Fig. 6's mesh section, its row printed as JAX's: on a card in this
    process on the one-device mesh (a world of one), on the CPU in a
    ``gloo`` world of :data:`MESH_DEVICES` processes (JAX's child of as
    many forced host devices), whose first rank's numbers it returns."""
    if torch.device(device).type == "cuda":
        init_world(device="cuda")
        mesh = make_mesh((1,), ("dev",), device="cuda")
        info = mesh_section(mesh, mesh)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            info = run_world(_MESH_WORLD, MESH_DEVICES, tmp)[0][0]
    emit("sharded/mesh/us_per_region", info["mesh_us_per_region"],
         f"devices={info['mesh_devices']} "
         f"bit_identical={info['per_device_bit_identical_to_single_heap']}")
    return info
