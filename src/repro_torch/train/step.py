"""Training step factory: mixed precision, remat, microbatch gradient
accumulation, AdamW.

The JAX package builds one jittable function; here the step runs eagerly
on the parameters' device.  Gradients come from ``torch.autograd.grad``
against detached views of the parameters, so the caller's tensors gain no
``.grad`` and the optimizer can update them in place.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.model_zoo import Model
from repro_torch.train.optimizer import OptConfig, OptState, adamw_update
from repro_torch.tree import leaves, tree_map


def _split_mb(batch: Dict[str, torch.Tensor], k: int):
    """The batch as k microbatches: M-RoPE ``positions`` (3, B, S) along
    axis 1, every other leaf along axis 0.

    The JAX package splits any 3-D leaf whose first dim is 3 (and whose
    second divides) on axis 1, which would also cut an ``embeds`` batch of
    three rows along its sequence; the port keys on the name instead."""
    def axis(key):
        return 1 if key == "positions" else 0

    for key, v in batch.items():
        if v.shape[axis(key)] % k:
            raise ValueError(f"batch[{key!r}] of {v.shape[axis(key)]} rows "
                             f"does not split into {k} microbatches")
    parts = {key: torch.chunk(v, k, dim=axis(key)) for key, v in batch.items()}
    return [{key: parts[key][i] for key in batch} for i in range(k)]


def make_train_step(model: Model, opt_cfg: OptConfig, *,
                    microbatches: int = 1,
                    gather_once: bool = False) -> Callable:
    """Returns ``train_step(values, opt_state, batch) -> (values, opt_state,
    metrics)``.  ``values`` are the parameters; they and ``opt_state`` are
    updated in place (see :func:`~repro_torch.train.optimizer.adamw_update`).
    The JAX version also takes the logical-axes tree, which the port's plain
    parameter dicts do not have.

    ``microbatches > 1`` accumulates fp32 gradients over equal slices of the
    batch and averages them, with the loss and metrics.  ``gather_once`` is
    a mesh option (the FSDP all-gather hoisted out of the microbatch loop)
    and comes with the mesh paths."""
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} must be >= 1")
    if gather_once:
        raise NotImplementedError(
            "gather_once is a mesh path, not ported yet (ROADMAP queue 1, "
            "item 5.5: meshes, the model side)")

    def grads_of(values, batch):
        vals = tree_map(lambda t: t.detach().requires_grad_(), values)
        loss, metrics = model.loss(vals, batch)
        # a parameter the batch does not reach (the vlm family's token
        # table under an embeddings batch) gets a zero gradient, as JAX's
        grads = torch.autograd.grad(loss, leaves(vals), allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for g, v in zip(grads, leaves(vals))]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(values, opt_state: OptState, batch):
        if microbatches == 1:
            loss, metrics, grads = grads_of(values, batch)
        else:
            grads, loss, per_mb = None, 0.0, []
            for mb in _split_mb(batch, microbatches):
                l, m, g = grads_of(values, mb)
                if grads is None:
                    grads = [x.float() for x in g]
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x.float())
                loss = loss + l
                per_mb.append(m)
            grads = [g / microbatches for g in grads]
            loss = loss / microbatches
            metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                       for k in per_mb[0]}
        new_values, opt_state, opt_metrics = adamw_update(
            grads, opt_state, opt_cfg, values)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_values, opt_state, metrics

    return train_step

