"""Training step factory: mixed precision, remat, microbatch gradient
accumulation, AdamW, and the sharded step over a mesh.

The JAX package builds one jittable function; here the step runs eagerly
on the parameters' device.  Gradients come from ``torch.autograd.grad``
against detached views of the parameters, so the caller's tensors gain no
``.grad`` and the optimizer can update them in place.

Under a mesh (``distributed/sharding.py::ShardingCtx``) JAX's GSPMD
partitions the one program; eager PyTorch has no partitioner, so the port
shards the state by hand (:class:`MeshPlan`):

* each rank keeps only its blocks of the parameters (by
  ``param_sharding_tree``) and of the fp32 master, mu and nu (by ZeRO-1,
  ``zero1_sharding_tree``);
* before the forward pass the step all-gathers the weights (once a
  microbatch, or once a step with ``gather_once``), except each rank's
  experts, which stay its own (expert parallelism, ``models/moe.py``):
  every other weight is whole on every rank, so the ``model`` axis does
  no tensor parallelism (it splits rows instead, below), and the weights
  and their gradients take a rank the unsharded model's memory;
* it takes the global batch, splits it into microbatches as JAX does, and
  gives each rank a disjoint share of each microbatch's rows: its block
  over the batch axes (``batch_sharding_axes``), cut further over the
  other axes when the rows divide the whole mesh (else those ranks repeat
  the rows, and each counts ``1 / repeats`` of their loss);
* each rank's loss is its share of the global loss (its tokens' cross
  entropy over the global token count, plus ``1 / mesh.size`` of the
  global aux), so the gradients summed over the ranks are the global
  gradients: each gradient, whole but for the experts, is summed in fp32
  and cut to the rank's ZeRO-1 block by reduce-scatters
  (``sharding.reduce_block``), AdamW updates the blocks, and the
  parameter blocks are all-gathered back from the master blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.expand import P
from repro_torch.core.rpc import ShapeDtype
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.collectives import team_index
from repro_torch.models.model_zoo import Model, batch_sharding_axes, input_specs
from repro_torch.train.optimizer import OptConfig, OptState, adamw_update
from repro_torch.tree import leaves, tree_map, unflatten


def _split_mb(batch: Dict[str, torch.Tensor], k: int):
    """The batch as k microbatches: M-RoPE ``positions`` (3, B, S) along
    axis 1, every other leaf along axis 0.

    The JAX package splits any 3-D leaf whose first dim is 3 (and whose
    second divides) on axis 1, which would also cut an ``embeds`` batch of
    three rows along its sequence; the port keys on the name instead."""
    for key, v in batch.items():
        if v.shape[_row_dim(key)] % k:
            raise ValueError(f"batch[{key!r}] of {v.shape[_row_dim(key)]} "
                             f"rows does not split into {k} microbatches")
    parts = {key: torch.chunk(v, k, dim=_row_dim(key))
             for key, v in batch.items()}
    return [{key: parts[key][i] for key in batch} for i in range(k)]


def _row_dim(key: str) -> int:
    return 1 if key == "positions" else 0


def _mean_metrics(per_mb: List[Dict[str, torch.Tensor]]):
    return {k: torch.mean(torch.stack([m[k] for m in per_mb]))
            for k in per_mb[0]}


# ---------------------------------------------------------------------------
# Shardings of the train state
# ---------------------------------------------------------------------------

def train_state_shardings(model: Model, mesh, shape=None, rules=None
                          ) -> Tuple[Any, Any, Any, Any, Any]:
    """(value specs, value shardings, optimizer shardings, batch
    shardings, axes tree) under ``mesh``, as JAX's: ZeRO-1 for the fp32
    master, mu and nu, the step replicated; batch shardings for the
    ``ShapeConfig`` ``shape`` (None without one)."""
    values, axes = model.param_specs()
    v_shard = sh.param_sharding_tree(axes, mesh, rules, like=values)
    z_shard = sh.zero1_sharding_tree(v_shard, values, mesh)
    o_shard = OptState(master=z_shard, mu=z_shard, nu=z_shard,
                       step=sh.NamedSharding(mesh, P()))
    b_shard = None
    if shape is not None:
        b_axes = batch_sharding_axes(model.cfg, shape)
        batch = input_specs(model.cfg, shape)
        with sh.ShardingCtx(mesh, rules):
            b_shard = {k: sh.logical_sharding(*a, shape=batch[k].shape)
                       for k, a in b_axes.items()}
    return values, v_shard, o_shard, b_shard, axes


@dataclasses.dataclass
class MeshPlan:
    """How one model's state lies on one mesh, leaf by leaf in
    :func:`~repro_torch.tree.leaves` order: the value, ZeRO-1 and compute
    shardings (compute: what a rank holds in the forward pass, its experts
    only along the expert dim, everything else whole) and the structure
    (the values' spec tree)."""
    specs: Any
    values: List[sh.NamedSharding]
    zero1: List[sh.NamedSharding]
    compute: List[sh.NamedSharding]

    @classmethod
    def build(cls, model: Model, mesh, rules=None) -> "MeshPlan":
        specs, v_tree, o_tree, _, axes = train_state_shardings(
            model, mesh, rules=rules)
        vs, zs = leaves(v_tree), leaves(o_tree.master)
        ax = sh.axes_leaves(axes)
        compute = [sh.NamedSharding(mesh, P(*(
            e if a == "experts" else None
            for a, e in zip(axis, v.entries(len(axis))))))
            for axis, v in zip(ax, vs)]
        return cls(specs, vs, zs, compute)

    def _tree(self, xs):
        return unflatten(self.specs, xs)

    def block_values(self, values) -> Any:
        """A full parameter tree -> this rank's value blocks."""
        return sh.shard_tree(values, self.value_shardings())

    def init_opt(self, value_blocks) -> OptState:
        """The fp32 master (this rank's ZeRO-1 block of the values) and
        zero moments, from this rank's value blocks."""
        master = [sh.block(v, sh.refinement(vs, zs, v.ndim))
                  .to(torch.float32, copy=True)
                  for v, vs, zs in zip(leaves(value_blocks), self.values,
                                       self.zero1)]
        zeros = lambda: [torch.zeros_like(m) for m in master]  # noqa: E731
        return OptState(self._tree(master), self._tree(zeros()),
                        self._tree(zeros()), 0)

    def value_shardings(self) -> Any:
        return self._tree(self.values)

    def opt_shardings(self) -> OptState:
        z = self._tree(self.zero1)
        return OptState(z, z, z, None)

    def opt_specs(self) -> OptState:
        """The full optimizer state's ShapeDtypes (fp32, step 0)."""
        f32 = tree_map(lambda s: ShapeDtype(s.shape, torch.float32),
                       self.specs)
        return OptState(f32, f32, f32, 0)

    def gather_for_compute(self, value_blocks) -> List[torch.Tensor]:
        """The weights a rank computes with: each value block gathered
        but along its expert dim."""
        return [sh.gather(v, sh.refinement(c, vs, v.ndim)) for v, vs, c in
                zip(leaves(value_blocks), self.values, self.compute)]

    def gather_state(self, values, opt: OptState) -> Dict[str, Any]:
        """Full tensors of this rank's value and optimizer blocks (a
        checkpoint's payload; every rank takes part)."""
        z = self._tree(self.zero1)
        return {"values": sh.gather_tree(values, self.value_shardings()),
                "opt": OptState(*(sh.gather_tree(t, z) for t in opt[:3]),
                                opt.step)}


def row_axes_for(mesh, rows: int) -> Tuple[str, ...]:
    """The mesh axes a batch of ``rows`` rows is split over: every axis
    when the rows divide the mesh, else the batch rule's axes (JAX's
    ``batch_sharding_axes`` with its divisibility guard), else none."""
    names = sh.mesh_axis_names(mesh)
    if rows % sh.mesh_size(mesh) == 0:
        return names
    batch = sh.entry_axes(sh.logical_spec("batch", shape=(rows,))[0])
    return tuple(a for a in names if a in batch)


def rows_block(batch: Dict[str, torch.Tensor], mesh,
               axes: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """This rank's block of a batch's rows over ``axes``."""
    if not axes:
        return batch
    n = sh.axis_size(mesh, axes)
    i = team_index(mesh, axes)
    out = {}
    for key, v in batch.items():
        k = v.shape[_row_dim(key)] // n
        out[key] = v.narrow(_row_dim(key), i * k, k)
    return out


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def make_train_step(model: Model, opt_cfg: OptConfig, *,
                    microbatches: int = 1, gather_once: bool = False,
                    plan: Optional[MeshPlan] = None) -> Callable:
    """Returns ``train_step(values, opt_state, batch) -> (values, opt_state,
    metrics)``.  ``values`` are the parameters; they and ``opt_state`` are
    updated in place (see :func:`~repro_torch.train.optimizer.adamw_update`).
    The JAX version also takes the logical-axes tree, which the port reads
    from ``model.param_axes()``.

    ``microbatches > 1`` accumulates fp32 gradients over equal slices of the
    batch and averages them, with the loss and metrics.  ``gather_once``
    instead differentiates the whole microbatch loop at once (each
    microbatch's forward checkpointed, so activation memory stays one
    microbatch's): under a mesh the weights are gathered once a step, not
    once a microbatch, and the gradients are reduced to the blocks once.

    Under a mesh (see the module docstring) ``values`` and ``opt_state``
    are this rank's blocks (``plan``, by default built from the first
    step's mesh and rules) and ``batch`` is the global batch, the same on
    every rank; the metrics are global, and the step's ``weight_gathers``
    counts its all-gathers of the weights."""
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} must be >= 1")

    def grads_of(structure, vals, loss_fn, batches):
        """(loss, metrics per batch, grads) of the mean of ``loss_fn`` over
        ``batches`` at parameters ``vals`` (the leaves of a tree shaped as
        ``structure``), each checkpointed when there are several."""
        params = [t.detach().requires_grad_() for t in vals]
        tree = unflatten(structure, params)
        total, per = 0.0, []
        for b in batches:
            if len(batches) > 1:
                l, m = checkpoint(loss_fn, tree, b, use_reentrant=False,
                                  context_fn=sh.checkpoint_contexts)
            else:
                l, m = loss_fn(tree, b)
            total = total + l
            per.append({k: v.detach() for k, v in m.items()})
        total = total / len(batches)
        # a parameter the batch does not reach (the vlm family's token
        # table under an embeddings batch) gets a zero gradient, as JAX's
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for g, v in zip(grads, params)]
        return total.detach(), per, grads

    def unsharded(values, opt_state, batch):
        vals = leaves(values)
        if microbatches == 1:
            loss, per, grads = grads_of(values, vals, model.loss, [batch])
        elif gather_once:
            loss, per, grads = grads_of(values, vals, model.loss,
                                        _split_mb(batch, microbatches))
        else:
            grads, loss, per = None, 0.0, []
            for mb in _split_mb(batch, microbatches):
                l, m, g = grads_of(values, vals, model.loss, [mb])
                if grads is None:
                    grads = [x.float() for x in g]
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x.float())
                loss = loss + l
                per += m
            grads = [g / microbatches for g in grads]
            loss = loss / microbatches
        new_values, opt_state, opt_metrics = adamw_update(
            grads, opt_state, opt_cfg, values)
        metrics = dict(_mean_metrics(per))
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_values, opt_state, metrics

    def sharded(mesh, values, opt_state, batch):
        nonlocal plan
        if plan is None:
            plan = MeshPlan.build(model, mesh, sh.current_rules())
        elif plan.values and plan.values[0].mesh is not mesh:
            raise ValueError("make_train_step(plan=) was built for another "
                             "mesh than the step's")
        n = sh.mesh_size(mesh)
        coef = model.cfg.router_aux_coef

        mbs = _split_mb(batch, microbatches) if microbatches > 1 \
            else [batch]
        key0 = next(iter(batch))
        rows = row_axes_for(mesh, mbs[0][key0].shape[_row_dim(key0)])

        def share(tree, mb):
            """This rank's share of the global loss of microbatch ``mb``
            (its rows), and the global metrics."""
            _, m = model.loss(tree, rows_block(mb, mesh, rows))
            total = sh.all_reduce_sum(m["tokens"].detach(), mesh)
            ce = m["ce"] * (m["tokens"].detach() / total)
            part = ce + coef * m["aux"] / n
            reps = n // sh.axis_size(mesh, rows)
            glob = {"ce": sh.all_reduce_sum(ce.detach(), mesh),
                    "aux": m["aux"].detach(), "tokens": total / reps}
            glob["loss"] = glob["ce"] + coef * glob["aux"]
            return part, glob

        def reduce(grads):
            return [sh.reduce_block(g, c, z) for g, c, z in
                    zip(grads, plan.compute, plan.zero1)]

        # the rows of this rank (a checkpointed layer's recompute, on
        # autograd's thread, gets them through checkpoint_contexts)
        def weights():
            train_step.weight_gathers += 1
            return plan.gather_for_compute(values)

        with sh.rows_over(rows, expert_blocks=True):
            if gather_once or microbatches == 1:
                _, per, grads = grads_of(plan.specs, weights(), share, mbs)
                blocks = reduce(grads)
            else:
                blocks, per = None, []
                for mb in mbs:
                    _, m, g = grads_of(plan.specs, weights(), share, [mb])
                    g = [x.float() for x in reduce(g)]
                    if blocks is None:
                        blocks = g
                    else:
                        for acc, x in zip(blocks, g):
                            acc.add_(x)
                    per += m
                blocks = [g / microbatches for g in blocks]
        norm_sq = sum(torch.sum(torch.square(g.float())) / z.replicas()
                      for g, z in zip(blocks, plan.zero1))
        gnorm = torch.sqrt(sh.all_reduce_sum(norm_sq, mesh))
        _, opt_state, opt_metrics = adamw_update(
            blocks, opt_state, opt_cfg, None, grad_norm=gnorm)
        with torch.no_grad():
            for v, m, vs, zs in zip(leaves(values), leaves(opt_state.master),
                                    plan.values, plan.zero1):
                v.copy_(sh.gather(m.to(v.dtype),
                                  sh.refinement(vs, zs, v.ndim)))
        metrics = dict(_mean_metrics(per))
        metrics.update(opt_metrics)
        return values, opt_state, metrics

    def train_step(values, opt_state: OptState, batch):
        mesh = sh.current_mesh()
        if mesh is None:
            return unsharded(values, opt_state, batch)
        return sharded(mesh, values, opt_state, batch)

    train_step.weight_gathers = 0
    return train_step
