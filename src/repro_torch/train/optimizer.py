"""AdamW: fp32 master weights and moments, cosine LR, global clip.

The JAX package's optimizer returns new trees; this one updates leaf by
leaf and in place, because at full width the state is most of the card
(llama3.2-3b: 3.78 B parameters x (2 bytes bf16 + 12 bytes fp32 master and
moments + 2 bytes gradient) = 61 GB).  :func:`adamw_update` overwrites the
moments, the master copy and the parameters it is given, and upcasts one
gradient leaf at a time, so no fp32 copy of all the gradients exists at
once.  Scalars of the schedule (lr, bias corrections) are computed in fp32
on the host from the step count, as JAX computes them in fp32 on the
device, so a step makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f(x: float) -> torch.Tensor:
    """A host fp32 scalar (the JAX schedule's arithmetic is fp32)."""
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: OptConfig, step: int) -> float:
    """Warmup then cosine decay to ``min_lr_ratio``; evaluated in fp32."""
    f = _f
    s = f(step)
    warm = s / f(max(cfg.warmup_steps, 1))
    prog = (s - f(cfg.warmup_steps)) / f(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = f(cfg.min_lr_ratio) + f(1 - cfg.min_lr_ratio) * f(0.5) * (
        f(1.0) + torch.cos(f(math.pi) * prog))
    return float(f(cfg.lr) * (warm if step < cfg.warmup_steps else cos))


class OptState(NamedTuple):
    master: Any      # fp32 copy of params
    mu: Any          # first moment (fp32)
    nu: Any          # second moment (fp32)
    step: int


def adamw_init(params: Any) -> OptState:
    """fp32 master copy (a copy even for fp32 parameters) and zero
    moments, on the parameters' devices."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    return OptState(master=master, mu=zeros(), nu=zeros(), step=0)


def global_clip(grads: List[torch.Tensor], clip_norm: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, global norm) as 0-d device tensors: the norm of all leaves in
    fp32 and the factor ``min(1, clip_norm / max(norm, 1e-9))``.  The JAX
    version returns the scaled fp32 gradients; :func:`adamw_update` applies
    the factor to each leaf as it upcasts that leaf instead."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return scale, gn


@torch.no_grad()
def adamw_update(grads: Any, opt: OptState, cfg: OptConfig, like: Any
                 ) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step.  ``grads`` is a tree matching ``like`` (the
    parameters), or its leaves in :func:`~repro_torch.tree.leaves` order.
    Returns (``like``, updated in place and cast leaf-wise to its dtypes,
    the new state, metrics); ``opt``'s master and moments are updated in
    place too and belong to the new state."""
    gl = leaves(grads)
    scale, gnorm = global_clip(gl, cfg.clip_norm)
    step = opt.step + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - _f(b1) ** _f(step))
    bc2 = float(1 - _f(b2) ** _f(step))
    for g, p, m, n, v in zip(gl, leaves(opt.master), leaves(opt.mu),
                             leaves(opt.nu), leaves(like)):
        g = g.float() if g.dtype != torch.float32 else g.clone()
        g.mul_(scale)
        m.mul_(b1).add_(g, alpha=1 - b1)
        n.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = m / bc1
        torch.div(n, bc2, out=g)                 # g is free: reuse it
        upd.div_(g.sqrt_().add_(cfg.eps))
        upd.add_(p, alpha=cfg.weight_decay)
        p.add_(upd, alpha=-lr)
        v.copy_(p)
        del g, upd          # free before the next leaf's temporaries
    return like, OptState(opt.master, opt.mu, opt.nu, step), \
        {"grad_norm": gnorm, "lr": lr}
