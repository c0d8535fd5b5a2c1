"""Expert parallelism (``repro_torch/models/moe.py``) on ``gloo`` worlds of
4 processes on the CPU, against the JAX package's expert-parallel bodies
run in one process under ``jax.vmap(axis_name="model")`` (a team a lane):

* ``_moe_local`` (the full path: capacity packing, two all-to-alls) at
  phi3.5-moe's ``reduced()`` width with 8 experts, top 2, ep 4: 64 tokens
  (nothing dropped) and 1024 tokens at ``capacity_factor`` 1.0 (JAX drops
  21, 34, 31 and 24 assignments in the four teams on these data);
* ``_moe_local_replicated`` (the decode path: a sum over ``model``);
* ``moe_apply`` under a (2, 2) mesh on the full, decode and dense paths,
  forward and gradients, against ``moe_reference`` at a capacity with no
  drops (the aux against the teams' mean or, on the dense path, the
  global one).

Drop counts are compared exactly, y and aux within fp32 2e-5."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as j_moe  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402

TOL = 2e-5
D, F, E, K, EP = 64, 128, 8, 2, 4


def _data(T, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((T, D)).astype(np.float32),
            "router": (rng.standard_normal((D, E)) * 0.5).astype(np.float32),
            "wg": (rng.standard_normal((E, D, F)) * D ** -0.5)
            .astype(np.float32),
            "wu": (rng.standard_normal((E, D, F)) * D ** -0.5)
            .astype(np.float32),
            "wo": (rng.standard_normal((E, F, D)) * F ** -0.5)
            .astype(np.float32)}


def _capacity(tokens, cf):
    c = int(np.ceil(tokens * K / E * cf))
    return max(8, ((c + 7) // 8) * 8)


CASES = [("t64", 64, 1.25), ("t1024_cf1", 1024, 1.0)]


def _jax_bodies(T, cf, seed):
    d = _data(T, seed)
    blocks = {k: jnp.asarray(d[k]).reshape((EP, -1) + d[k].shape[1:])
              for k in ("x", "wg", "wu", "wo")}
    C = _capacity(T // EP, cf)
    full = jax.vmap(functools.partial(j_moe._moe_local, E=E, K=K, C=C,
                                      ep_axis="model"),
                    in_axes=(0, None, 0, 0, 0), axis_name="model")
    y, aux, dropped = full(blocks["x"], jnp.asarray(d["router"]),
                           blocks["wg"], blocks["wu"], blocks["wo"])
    # the decode body: every team sees the same 24 tokens
    xr = jnp.asarray(d["x"][:24])
    rep = jax.vmap(functools.partial(
        j_moe._moe_local_replicated, E=E, K=K, C=_capacity(24, cf),
        ep_axis="model"), in_axes=(None, None, 0, 0, 0), axis_name="model")
    yr, auxr = rep(xr, jnp.asarray(d["router"]), blocks["wg"],
                   blocks["wu"], blocks["wo"])
    return {"y": np.asarray(y), "aux": np.asarray(aux).reshape(-1),
            "dropped": np.asarray(dropped).reshape(-1),
            "y_rep": np.asarray(yr), "aux_rep": np.asarray(auxr).reshape(-1)}


_BODIES = """
import functools, json
import numpy as np, torch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
D, F, E, K, EP = {D}, {F}, {E}, {K}, {EP}
mesh = make_mesh((1, EP), ("data", "model"), device="cpu")
for name, T, cf, seed in {cases}:
    rng = np.random.default_rng(seed)
    d = {{"x": rng.standard_normal((T, D)).astype(np.float32),
         "router": (rng.standard_normal((D, E)) * 0.5).astype(np.float32),
         "wg": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
         "wu": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
         "wo": (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32)}}
    t = {{k: torch.from_numpy(v) for k, v in d.items()}}
    e_loc, t_loc = E // EP, T // EP
    w = [t[k][RANK * e_loc:(RANK + 1) * e_loc] for k in ("wg", "wu", "wo")]
    cap = lambda n: max(8, ((int(np.ceil(n * K / E * cf)) + 7) // 8) * 8)
    y, aux, dropped = moe._moe_local(
        t["x"][RANK * t_loc:(RANK + 1) * t_loc], t["router"], *w, E=E, K=K,
        C=cap(t_loc), mesh=mesh)
    yr, auxr = moe._moe_local_replicated(t["x"][:24], t["router"], *w, E=E,
                                         K=K, C=cap(24), mesh=mesh)
    report({{"case": name, "y": y.tolist(), "aux": float(aux),
            "dropped": float(dropped), "y_rep": yr.tolist(),
            "aux_rep": float(auxr)}})
"""


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    cases = [(name, T, cf, i) for i, (name, T, cf) in enumerate(CASES)]
    reps = run_world(_BODIES.format(D=D, F=F, E=E, K=K, EP=EP, cases=cases),
                     EP, str(tmp_path_factory.mktemp("moe_ep")))
    return {name: [r[i] for r in reps] for i, (name, _, _) in
            enumerate(CASES)}


@pytest.mark.parametrize("name,T,cf", CASES)
def test_moe_local_matches_jax_vmap(bodies, name, T, cf):
    seed = [c[0] for c in CASES].index(name)
    want = _jax_bodies(T, cf, seed)
    got = bodies[name]
    assert [g["case"] for g in got] == [name] * EP
    np.testing.assert_array_equal([g["dropped"] for g in got],
                                  want["dropped"])
    if name == "t64":
        assert not want["dropped"].any()
    else:                      # JAX drops 21, 34, 31 and 24 on these data
        assert want["dropped"].all()
    np.testing.assert_allclose(np.array([g["y"] for g in got]), want["y"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose([g["aux"] for g in got], want["aux"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,T,cf", CASES)
def test_moe_local_replicated_matches_jax_vmap(bodies, name, T, cf):
    seed = [c[0] for c in CASES].index(name)
    want = _jax_bodies(T, cf, seed)
    got = bodies[name]
    for r in range(EP):
        np.testing.assert_allclose(np.array(got[r]["y_rep"]),
                                   want["y_rep"][r], rtol=TOL, atol=TOL)
    np.testing.assert_allclose([g["aux_rep"] for g in got], want["aux_rep"],
                               rtol=TOL, atol=TOL)


_APPLY = """
import dataclasses
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.collectives import (gather_blocks,
                                                 psum_autograd, team_index)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
base = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                           capacity_factor=8.0)
for name, E, B, S, rows, blocks in {cases}:
    cfg = dataclasses.replace(base, num_experts=E)
    rng = np.random.default_rng(E * 100 + B * 10 + S)
    d = cfg.d_model
    full = {{"router": rng.standard_normal((d, E)) * 0.5,
            "wi_gate": rng.standard_normal((E, d, cfg.d_ff)) * d ** -0.5,
            "wi_up": rng.standard_normal((E, d, cfg.d_ff)) * d ** -0.5,
            "wo": rng.standard_normal((E, cfg.d_ff, d)) * cfg.d_ff ** -0.5}}
    # the sharded step's expert blocks ("experts" -> model), or all
    e, j = (E // 2, team_index(mesh, "model")) if blocks else (E, 0)
    p = {{k: torch.tensor(v if k == "router" else v[j * e:(j + 1) * e],
                         dtype=torch.float32, requires_grad=True)
         for k, v in full.items()}}
    x = torch.tensor(rng.standard_normal((B, S, d)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((B, S, d)), dtype=torch.float32)
    n = sh.axis_size(mesh, rows)
    i = team_index(mesh, rows) if rows else 0
    xl = x[i * B // n:(i + 1) * B // n].clone().requires_grad_()
    with sh.ShardingCtx(mesh), sh.rows_over(rows, expert_blocks=blocks), \
            moe.record_drops() as dr:
        y, aux = moe.moe_apply(p, xl, cfg)
        loss = (y * g[i * B // n:(i + 1) * B // n]).sum() / (4 // n)
        loss.backward()
    grads = {{}}
    for k, v in p.items():
        if blocks and k != "router":
            grads[k] = gather_blocks(psum_autograd(v.grad, mesh, "data"),
                                     mesh, "model")
        else:
            grads[k] = psum_autograd(v.grad, mesh, ("data", "model"))
    report({{"case": name, "y": y.tolist(), "aux": float(aux),
            "drops": [float(t) for t in dr], "gx": xl.grad.tolist(),
            "grads": {{k: v.tolist() for k, v in grads.items()}}}})
"""

#: (name, experts, B, S, the rows' mesh axes, expert blocks given)
APPLY_CASES = [("full", 4, 4, 8, ("data", "model"), True),
               ("full_whole_experts", 4, 4, 8, ("data", "model"), False),
               ("full_rows_over_data", 4, 2, 8, ("data",), True),
               ("decode", 4, 2, 3, ("data",), True),
               ("dense_gathered", 4, 1, 5, (), True),
               ("dense_oracle", 3, 4, 5, ("data", "model"), False)]


def test_moe_apply_paths_match_reference_and_grads(tmp_path):
    """``moe_apply`` under a (2, 2) mesh, each rank its rows and its
    expert block (or every expert): the full path with the rows over both
    axes and over ``data`` alone, the decode path, the dense oracle on
    gathered experts (5 tokens on every rank divide neither path) and on
    3 experts, which ``model`` does not divide.  y and the gradients of
    ``sum(y * g)`` (each of the ranks that share rows counting its share)
    against ``moe_reference`` on the whole batch; the aux the same on
    every rank, and on the dense paths the global one.  Nothing is
    dropped at capacity factor 8."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as t_moe

    reps = run_world(_APPLY.format(cases=APPLY_CASES), 4, str(tmp_path))
    base = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                               capacity_factor=8.0)
    for ci, (name, E, B, S, rows, _) in enumerate(APPLY_CASES):
        got = [r[ci] for r in reps]
        assert {g["case"] for g in got} == {name}
        cfg = dataclasses.replace(base, num_experts=E)
        rng = np.random.default_rng(E * 100 + B * 10 + S)
        d = cfg.d_model
        p = {"router": rng.standard_normal((d, E)) * 0.5,
             "wi_gate": rng.standard_normal((E, d, cfg.d_ff)) * d ** -0.5,
             "wi_up": rng.standard_normal((E, d, cfg.d_ff)) * d ** -0.5,
             "wo": rng.standard_normal((E, cfg.d_ff, d)) * cfg.d_ff ** -0.5}
        p = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
             for k, v in p.items()}
        x = torch.tensor(rng.standard_normal((B, S, d)), dtype=torch.float32,
                         requires_grad=True)
        g = torch.tensor(rng.standard_normal((B, S, d)), dtype=torch.float32)
        y, aux = t_moe.moe_reference(p, x.reshape(B * S, d), cfg)
        (y.reshape(B, S, d) * g).sum().backward()
        # the ranks of each row block (rank r is at (r // 2, r % 2))
        blocks = {("data", "model"): [[0], [1], [2], [3]],
                  ("data",): [[0, 1], [2, 3]], (): [[0, 1, 2, 3]]}[rows]
        ys = np.concatenate([np.array(got[b[0]]["y"]) for b in blocks])
        np.testing.assert_allclose(ys, y.detach().reshape(B, S, d).numpy(),
                                   rtol=TOL, atol=TOL)
        for b in blocks:
            assert all(got[r]["y"] == got[b[0]]["y"] for r in b)
        gxs = np.concatenate([sum(np.array(got[r]["gx"]) for r in b)
                              for b in blocks])
        np.testing.assert_allclose(gxs, x.grad.numpy(), rtol=1e-4,
                                   atol=1e-4)
        assert len({g["aux"] for g in got}) == 1
        if name.startswith("dense"):
            np.testing.assert_allclose(got[0]["aux"], float(aux.detach()),
                                       rtol=TOL)
            assert got[0]["drops"] == []
        else:
            assert sum(sum(g["drops"]) for g in got) == 0
        for k in ("router", "wi_gate", "wi_up", "wo"):
            np.testing.assert_allclose(np.array(got[0]["grads"][k]),
                                       p[k].grad.numpy(), rtol=1e-4,
                                       atol=1e-4)
