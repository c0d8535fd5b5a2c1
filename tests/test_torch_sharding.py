"""The port's logical-axis sharding (``repro_torch/distributed/
sharding.py``), the parameter axes of every model and the train state's
shardings, against the JAX package's on meshes without devices (JAX's
``AbstractMesh``, the port's :class:`AbstractMesh`): (1, 1), (2, 2),
(16, 16) and the multi-pod (2, 16, 16).

Specs are compared entry for entry, a one-element tuple taken as its
element (JAX 0.9 prints ``('data',)`` as ``'data'``) and JAX's missing
trailing entries as None.  The stacked layers of JAX's trees are compared
through ``convert.py``'s layout: the leading ``"stack"`` axis dropped, one
entry a layer.  ZeRO-1 differs there by layout: on JAX's stacked leaves
``zero1_spec`` may shard the stack axis (whole layers a data rank), which
the port's per-layer lists do not have, so a layer's ZeRO-1 spec is held
against JAX's ``zero1_spec`` of that layer's spec and shape."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.distributed import sharding as js  # noqa: E402
from repro.models.model_zoo import batch_sharding_axes as j_batch_axes  # noqa: E402
from repro.models.model_zoo import build_model as j_build  # noqa: E402
from repro.train.step import train_state_shardings as j_shardings  # noqa: E402
from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import axes_from_jax  # noqa: E402
from repro_torch.core.expand import P, _spec_axes  # noqa: E402
from repro_torch.distributed import sharding as ts  # noqa: E402
from repro_torch.launch.mesh import production_shape  # noqa: E402
from repro_torch.models.model_zoo import (batch_sharding_axes,  # noqa: E402
                                          build_model, input_specs)
from repro_torch.train.step import train_state_shardings  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          production_shape(), production_shape(multi_pod=True)]
ARCHS = sorted(CONFIGS)
_STACKED = ("layers", "rec_layers", "attn_layers", "enc_layers",
            "dec_layers")


def _meshes(shape, axes):
    return JAbstractMesh(tuple(shape), tuple(axes)), \
        ts.AbstractMesh(tuple(shape), tuple(axes))


def _norm(spec, n=None):
    out = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                for e in spec)
    return out if n is None else out + (None,) * (n - len(out))


def _port_layout(jtree, jvalues, fn, stacked=None):
    """A JAX tree -> the port's layout of ``fn(leaf)``: a stacked group's
    ``stacked(leaf)`` (by default ``fn(leaf)`` without its stack entry)
    repeated for each layer."""
    stacked = stacked or (lambda s: fn(s)[1:])
    out = {}
    for k, v in jtree.items():
        if k in _STACKED:
            n = jax.tree.leaves(jvalues[k])[0].shape[0]
            out[k] = [jax.tree.map(stacked, v)] * n
        else:
            out[k] = jax.tree.map(fn, v)
    return out


def test_rules_table_is_jax_s():
    assert ts.LOGICAL_RULES == js.LOGICAL_RULES


@pytest.mark.parametrize("shape,axes", MESHES)
def test_logical_spec_matches_jax(shape, axes):
    """Every rule, with and without the divisibility guard, and the
    ``pod`` axis dropped on a mesh without it."""
    jm, tm = _meshes(shape, axes)
    names = [name for name, _ in js.LOGICAL_RULES]
    dims = [(4096, 32), (40, 5), (8, 3), (512, 16), (1, 1)]
    with js.ShardingCtx(jm), ts.ShardingCtx(tm):
        for a in names:
            for b in names + [None]:
                assert _norm(ts.logical_spec(a, b)) == \
                    _norm(js.logical_spec(a, b), 2), (a, b)
                for d in dims:
                    assert _norm(ts.logical_spec(a, b, shape=d)) == \
                        _norm(js.logical_spec(a, b, shape=d), 2), (a, b, d)
        # batch over ("pod", "data"): pod dropped on one pod
        want = ("data",) if "pod" not in axes else ("pod", "data")
        assert tuple(ts.logical_spec("batch")[0]) == want
        # custom rules update JAX's defaults
    rules = (("embed", "model"), ("batch", "data"))
    with js.ShardingCtx(jm, rules), ts.ShardingCtx(tm, rules):
        assert _norm(ts.logical_spec("batch", "embed")) == \
            _norm(js.logical_spec("batch", "embed"), 2)


@pytest.mark.parametrize("shape,axes", MESHES)
def test_zero1_spec_matches_jax(shape, axes):
    jm, tm = _meshes(shape, axes)
    cases = [((), (512, 128)), ((None, "model"), (64, 32)),
             (("data", None), (64, 32)), ((None, None), (3, 32)),
             (("model", None, None), (16, 3, 5)),
             ((("pod", "data"), None), (64, 64)), ((None,), (7,))]
    for entries, dims in cases:
        if any(a not in axes for e in entries
               for a in ts.entry_axes(e)):
            continue
        got = ts.zero1_spec(P(*entries), dims, tm)
        want = js.zero1_spec(jax.sharding.PartitionSpec(*entries), dims, jm)
        assert _norm(got, len(dims)) == _norm(want, len(dims)), \
            (entries, dims)
    assert ts.zero1_spec(P(None), (8,), None) == P(None)


def test_with_logical_constraint_validates():
    x = torch.zeros(4, 8)
    assert ts.with_logical_constraint(x, "batch", "whatever") is x
    with ts.ShardingCtx(ts.AbstractMesh((2, 2), ("data", "model"))):
        assert ts.with_logical_constraint(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="rank mismatch"):
            ts.with_logical_constraint(x, "batch")
        with pytest.raises(KeyError, match="unknown logical axis"):
            ts.with_logical_constraint(x, "batch", "nope")
    assert ts.current_mesh() is None


def test_device_axis_spec_and_full_specs_in_expand():
    """``P`` carries full per-dimension specs; ``expand`` still takes
    only ``P()`` and ``P(axes)`` over the leading dimension."""
    tm = ts.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    jm = JAbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tuple(ts.device_axis_spec(tm)) == tuple(js.device_axis_spec(jm))

    class _Mesh:
        mesh_dim_names = ("data", "model")

    assert _spec_axes(P(("data", "model")), _Mesh) == ("data", "model")
    for spec in (P("data", None), P(None), P(None, "model")):
        with pytest.raises(ValueError, match="supports P"):
            _spec_axes(spec, _Mesh)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_axes_match_jax(arch, full):
    """``Model.param_specs()``: shapes, dtypes and logical axes, leaf for
    leaf, against JAX's ``param_specs()`` (no allocation on either
    side)."""
    jcfg = JCONFIGS[arch] if full else JCONFIGS[arch].reduced()
    cfg = CONFIGS[arch] if full else CONFIGS[arch].reduced()
    jvalues, jaxes = j_build(jcfg).param_specs()
    values, axes = build_model(cfg, device="cpu").param_specs()
    assert axes == axes_from_jax(jaxes, jvalues)
    want = _port_layout(jvalues, jvalues,
                        lambda s: (tuple(s.shape), str(s.dtype)),
                        stacked=lambda s: (tuple(s.shape[1:]), str(s.dtype)))
    assert [(tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for v in leaves(values)] == jax.tree.leaves(
                want, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["1x1", "2x2", "16x16", "2x16x16"])
def test_train_state_shardings_match_jax(arch, shape, axes):
    """``train_state_shardings`` at ``reduced()``: value specs (with the
    divisibility guard, ``param_sharding_tree(like=)``), ZeRO-1 specs,
    the replicated step and the batch specs of a train cell."""
    jm, tm = _meshes(shape, axes)
    jcfg, cfg = JCONFIGS[arch].reduced(), CONFIGS[arch].reduced()
    jshape = JShapeConfig(name="t", kind="train", seq_len=32,
                          global_batch=64)
    tshape = ShapeConfig(name="t", kind="train", seq_len=32, global_batch=64)
    jvals, jv, jo, jb, _ = j_shardings(j_build(jcfg), jm, shape=jshape)
    tvals, tv, to, tb, _ = train_state_shardings(
        build_model(cfg, device="cpu"), tm, shape=tshape)

    ndims = [len(v.shape) for v in leaves(tvals)]

    def flat(tree):
        return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))

    def pad(specs):
        return [w + (None,) * (n - len(w)) for w, n in zip(specs, ndims)]

    want_v = flat(_port_layout(jv, jvals, lambda s: _norm(s.spec)))
    assert [_norm(s.spec, n) for s, n in zip(leaves(tv), ndims)] == \
        pad(want_v)
    # ZeRO-1: JAX's own leaves as they are; a stacked layer's through
    # JAX's zero1_spec on its per-layer spec and shape (on the stacked
    # layout JAX may put "data" on the stack axis instead)
    want_z = flat(_port_layout(
        jo.master, jvals, lambda s: _norm(s.spec),
        stacked=lambda s: ("stacked",)))
    shapes = [tuple(v.shape) for v in leaves(tvals)]
    want_z = [_norm(js.zero1_spec(jax.sharding.PartitionSpec(*v), d, jm))
              if z == ("stacked",) else z
              for z, v, d in zip(want_z, pad(want_v), shapes)]
    for tt in (to.master, to.mu, to.nu):
        assert [_norm(s.spec, n) for s, n in zip(leaves(tt), ndims)] == \
            pad(want_z)
    assert _norm(to.step.spec) == _norm(jo.step.spec) == ()
    assert set(tb) == set(jb)
    for k in tb:
        n = len(input_specs(cfg, tshape)[k].shape)
        assert _norm(tb[k].spec, n) == _norm(jb[k].spec, n), k
    assert batch_sharding_axes(cfg, tshape) == j_batch_axes(jcfg, jshape)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_batch_sharding_axes_match_jax(kind):
    for arch in ARCHS:
        jshape = JShapeConfig(name="t", kind=kind, seq_len=16,
                              global_batch=8)
        tshape = ShapeConfig(name="t", kind=kind, seq_len=16, global_batch=8)
        assert batch_sharding_axes(CONFIGS[arch], tshape) == \
            j_batch_axes(JCONFIGS[arch], jshape), arch


def test_block_shapes_and_replicas():
    """A block's shape and how many ranks hold it, from the spec alone."""
    tm = ts.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    s = ts.NamedSharding(tm, P(("pod", "data"), "model"))
    assert s.block_shape((64, 32, 7)) == (2, 2, 7)
    assert s.replicas() == 1
    assert ts.NamedSharding(tm, P(None, "model")).replicas() == 32
    assert ts.NamedSharding(tm, P()).block_shape((5,)) == (5,)


_REDUCE = """
import numpy as np
import torch
from repro_torch.core.expand import P
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
coord = {{r: (r // 2, r % 2) for r in range(4)}}
out = []
for comp, tgt in {cases}:
    computed = sh.NamedSharding(mesh, P(*comp))
    target = sh.NamedSharding(mesh, P(*tgt))
    full = [torch.tensor(np.random.default_rng(r).standard_normal((4, 8)),
                         dtype=torch.float32) for r in range(4)]
    got = sh.reduce_block(sh.block(full[RANK], computed), computed, target)
    # the ranks that hold this rank's block of the computed sharding
    held = [i for i, a in enumerate(("data", "model"))
            if any(a in (e if isinstance(e, tuple) else (e,))
                   for e in comp)]
    same = [r for r in range(4)
            if all(coord[r][i] == coord[RANK][i] for i in held)]
    want = sh.block(sum(full[r] for r in same), target)
    out.append({{"shape": list(got.shape),
                 "err": float((got - want).abs().max())}})
report(out)
"""

#: (computed spec, target spec): a dense leaf cut over one axis and over
#: both in one dim, an expert leaf (computed over ``model``), and one cut
#: over both axes in two dims
REDUCE_CASES = [((), ("data",)), ((), (None, ("data", "model"))),
                (("model",), ("model", "data")), ((), ("model", "data"))]


def test_reduce_block_is_the_sum_cut_to_the_block(tmp_path):
    """``reduce_block`` on a ``gloo`` world of 4 ((2, 2) mesh): each
    rank's block equals the sum of the gradients of the ranks that
    computed its block, cut to the target's block."""
    from repro_torch.launch.world import run_world
    reps = run_world(_REDUCE.format(cases=REDUCE_CASES), 4, str(tmp_path))
    shapes = [[2, 8], [4, 2], [2, 4], [2, 4]]
    for rep in reps:
        for case, shape, got in zip(REDUCE_CASES, shapes, rep[0]):
            assert got["shape"] == shape, case
            assert got["err"] <= 1e-6, case
