"""The port's mesh collectives (``repro_torch/distributed/
collectives.py``) and meshes (``repro_torch/launch/mesh.py``) in a
``gloo`` world of 4 processes on the CPU, a ``(pod 2, data 2)`` mesh,
against numpy on the inputs every rank can rebuild from its seed:
``hierarchical_psum`` against a flat all-reduce and numpy (and its three
flat fall-backs), ``all_to_all_tokens`` (tiled, split and concat on the
same or different dims), ``global_norm_sq``, ``barrier``,
``gather_blocks`` row-major over two axes and ``broadcast_from_first``.
Float64 inputs; sums within 1e-12 relative, moves bit for bit."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402

_WORLD = r"""
import numpy as np, torch, torch.distributed as dist
from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import make_mesh

mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
coord = mesh.get_coordinate()

def x_of(rank, shape):
    return np.random.default_rng(100 + rank).standard_normal(shape)

def mine(shape):
    return torch.from_numpy(x_of(RANK, shape))

out = {"coord": list(coord), "team": C.team_index(mesh)}
ranks = range(WORLD)
for name, shape, kw in [("hier", (4, 3), {}),
                        ("flat_scalar", (), {}),
                        ("flat_ragged", (3, 2), {}),
                        ("intra_only", (4,), {"inter_axis": None}),
                        ("no_inter_axis", (4,), {"inter_axis": "x"})]:
    got = C.hierarchical_psum(mine(shape), mesh, **kw)
    if kw:
        # only the data axis: the ranks that share this rank's pod
        peers = [r for r in ranks if r // 2 == RANK // 2]
    else:
        peers = ranks
    want = sum(x_of(r, shape) for r in peers)
    flat = mine(shape).clone()
    group = mesh.get_group("data") if kw else None
    dist.all_reduce(flat, group=group)
    out[name] = [float(np.max(np.abs(got.numpy() - want))),
                 float(np.max(np.abs(got.numpy() - flat.numpy()))),
                 float(np.max(np.abs(want)))]

# tiled all-to-all over "data" (size 2): chunk j of rank (p, d) goes to
# (p, j); what arrives is concatenated in the sender's data order
for split, concat in [(0, 0), (0, 1), (1, 0)]:
    x = torch.arange(24, dtype=torch.float64).reshape(4, 6) + 1000 * RANK
    got = C.all_to_all_tokens(x, "data", split_dim=split, concat_dim=concat,
                              mesh=mesh)
    pod, d = coord
    parts = []
    for src_d in range(2):
        src = pod * 2 + src_d
        xs = np.arange(24.0).reshape(4, 6) + 1000 * src
        parts.append(np.split(xs, 2, axis=split)[d])
    want = np.concatenate(parts, axis=concat)
    out[f"a2a_{split}{concat}"] = bool(np.array_equal(got.numpy(), want))

tree = {"a": mine((3,)), "b": [mine((2, 2)).to(torch.float32)]}
local = float(torch.sum(mine((3,)) ** 2) + torch.sum(
    mine((2, 2)).to(torch.float32).to(torch.float64) ** 2))
g = C.global_norm_sq(tree, ("pod", "data"), mesh)
allsq = sum(float(np.sum(x_of(r, (3,)) ** 2) + np.sum(
    x_of(r, (2, 2)).astype(np.float32).astype(np.float64) ** 2))
    for r in ranks)
out["norm"] = [float(C.global_norm_sq(tree)), local, float(g), allsq]
C.barrier(mesh=mesh)
C.barrier("data", mesh)
blocks = C.gather_blocks(torch.tensor([[RANK, C.team_index(mesh)]]), mesh)
out["blocks"] = blocks.tolist()
out["blocks_data"] = C.gather_blocks(torch.tensor([RANK]), mesh,
                                     "data").tolist()
b = torch.full((3,), float(RANK))
C.broadcast_from_first(b, mesh)
out["bcast"] = b.tolist()
report(out)
"""


def test_collectives_in_a_world_of_four(tmp_path):
    reports = run_world(_WORLD, 4, str(tmp_path))
    for rank, (rep,) in enumerate(reports):
        assert rep["coord"] == [rank // 2, rank % 2] and rep["team"] == rank
        for name in ("hier", "flat_scalar", "flat_ragged", "intra_only",
                     "no_inter_axis"):
            err_np, err_flat, scale = rep[name]
            assert err_np <= 1e-12 * max(scale, 1.0), (name, rep[name])
            assert err_flat <= 1e-12 * max(scale, 1.0), (name, rep[name])
        for key in ("a2a_00", "a2a_01", "a2a_10"):
            assert rep[key], key
        mine, local, total, want = rep["norm"]
        assert mine == pytest.approx(local, rel=1e-6)
        assert total == pytest.approx(want, rel=1e-6)
        assert rep["blocks"] == [[r, r] for r in range(4)]
        assert rep["blocks_data"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert rep["bcast"] == [0.0, 0.0, 0.0]


def test_mesh_helpers_in_process():
    """The helpers that need no world of several: a world of one joined
    twice is the same world, a different rank or size raises, the
    production shapes and their refusal on a small world, a rank mesh of
    one device, and a collective outside a region without ``mesh=``."""
    from repro_torch.distributed import collectives as C
    tmesh.init_world(device="cpu")
    tmesh.init_world(0, 1, device="cpu")
    with pytest.raises(RuntimeError, match="not rank 1 of 2"):
        tmesh.init_world(1, 2, store_path="unused", device="cpu")
    assert tmesh.world_device() == "cpu"
    assert tmesh.production_shape() == ((16, 16), ("data", "model"))
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    one = tmesh.make_rank_mesh("dev", device="cpu")
    assert one.size() == 1 and tuple(one.mesh_dim_names) == ("dev",)
    dbg = tmesh.make_debug_mesh(1, 1, device="cpu")
    assert tuple(dbg.mesh_dim_names) == ("data", "model")
    x = torch.arange(4.0)
    assert torch.equal(C.hierarchical_psum(x, dbg, intra_axis="data",
                                           inter_axis="model"), x)
    assert torch.equal(C.gather_blocks(x, dbg), x)
    assert torch.equal(C.all_to_all_tokens(x.reshape(2, 2), "data",
                                           split_dim=0, concat_dim=1,
                                           mesh=dbg), x.reshape(2, 2))
    with pytest.raises(RuntimeError, match="needs mesh="):
        C.barrier()
