"""Mixture-of-Experts layer: top-k routing over SwiGLU experts.

The port of ``repro/models/moe.py`` without a mesh: ``moe_apply`` computes
what JAX's computes on one device, the dropless dense oracle
:func:`moe_reference`, which evaluates every expert for every token and
weights the top-k.  JAX's expert-parallel bodies (``_moe_local`` and
``_moe_local_replicated``: capacity packing, ``all_to_all`` and ``psum``
over the mesh's ``model`` axis) are ROADMAP item 5.5; ``moe_apply`` with a
mesh raises.

The expert products are batched matmuls over the expert axis
(``x[None] @ w``: (E, T, f)), which read the (E, d, f) weights where they
lie; an einsum may first permute them into a contiguous (d, E*f) copy, a
weight-sized temporary a layer.  They are plain large products that the
JAX package computes outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import normal, torch_dtype


def moe_init(gen: torch.Generator, cfg: ModelConfig
             ) -> Dict[str, torch.Tensor]:
    """JAX's shapes, dtypes and scales: the router fp32 (d, E) at 0.02,
    ``wi_gate``/``wi_up`` (E, d, f) and ``wo`` (E, f, d) in the parameter
    dtype."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    pd = torch_dtype(cfg.param_dtype)
    return {
        "router": normal(gen, (d, E), torch.float32, scale=0.02),
        "wi_gate": normal(gen, (E, d, f), pd),
        "wi_up": normal(gen, (E, d, f), pd),
        "wo": normal(gen, (E, f, d), pd, scale=f ** -0.5),
    }


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights (T, k) fp32 renormalised, ids (T, k), probs (T, E) fp32).
    The top k is taken from a stable descending sort, so that exact ties
    go to the lower expert id, as ``lax.top_k`` breaks them (``torch.topk``
    promises no order)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi, probs


def _expert_ffn(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """xe (E, C, d) or (T, d) (every expert sees every token); weights
    (E, d, f) / (E, f, d); -> (E, C or T, d) in xe's dtype."""
    dt = xe.dtype
    g = torch.matmul(xe, wg.to(dt))
    u = torch.matmul(xe, wu.to(dt))
    return torch.matmul(F.silu(g) * u, wo.to(dt))


def moe_reference(p: Dict[str, torch.Tensor], x_flat: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless oracle: every expert evaluated densely, (T, d) -> (y
    (T, d), aux), with JAX's dtype flow: routing in fp32, the expert
    products in the activation dtype, their outputs weighted in fp32 and
    y cast back.  ``aux`` is the load-balance loss E * sum(f_e * p_e)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    topv, topi, probs = _route(x_flat, p["router"], K)
    T = x_flat.shape[0]
    w_full = torch.zeros((T, E), dtype=torch.float32, device=x_flat.device)
    w_full = w_full.scatter(1, topi, topv)
    o = _expert_ffn(x_flat, p["wi_gate"], p["wi_up"], p["wo"])  # (E, T, d)
    y = torch.einsum("etd,te->td", o.float(), w_full).to(x_flat.dtype)
    counts = (w_full > 0).sum(0).float()
    f_e = counts / torch.clamp(counts.sum(), min=1.0)
    p_e = probs.mean(0)
    aux = E * torch.sum(f_e * p_e)
    return y, aux


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux scalar): :func:`moe_reference`,
    what JAX's ``moe_apply`` computes without a mesh."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_apply over a mesh (expert parallelism: _moe_local, "
            "_moe_local_replicated) is ROADMAP queue 1, item 5.5")
    B, S, d = x.shape
    y, aux = moe_reference(p, x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d), aux
