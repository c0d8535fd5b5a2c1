"""Mixture-of-Experts layer: top-k routing over SwiGLU experts, and its
expert-parallel (EP) dispatch over a mesh (``repro/models/moe.py``).

Without a mesh ``moe_apply`` computes what JAX's computes on one device,
the dropless dense oracle :func:`moe_reference`.  Under a mesh
(``distributed/sharding.py::ShardingCtx``) it runs JAX's expanded paths:

* **full** (the global token count divides the mesh): each team routes its
  block of ``T / mesh.size`` tokens (flattened B*S row-major; block ``r``
  is the team at row-major mesh coordinate ``r``), packs them into
  per-expert capacity buffers (:func:`capacity`), ships them to the
  experts' teams over the ``model`` axis (``all_to_all_tokens``), runs its
  ``E / ep`` experts and ships the outputs back (:func:`_moe_local`);
* **decode** (else, when the count divides the non-``model`` axes): tokens
  replicated over ``model``, each team evaluates the pairs routed to its
  local experts and a sum over ``model`` combines them
  (:func:`_moe_local_replicated`);
* else the dense oracle, with its load-balance statistics summed over the
  mesh.

A team holds only its experts (``"experts" -> model``) and never gathers
another team's on these two paths; what a team's capacity drops is
JAX's, token for token.  The collectives are differentiable, so the
sharded training step trains through the dispatch.

The expert products are batched matmuls over the expert axis
(``x[None] @ w``: (E, T, f)), which read the (E, d, f) weights where they
lie; an einsum may first permute them into a contiguous (d, E*f) copy, a
weight-sized temporary a layer.  They are plain large products that the
JAX package computes outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (
    all_to_all_tokens, gather_autograd, psum_autograd, team_index)
from repro_torch.distributed.sharding import (
    all_reduce_sum, axis_size, current_mesh, expert_blocks, mesh_axis_names,
    mesh_shape, mesh_size, row_axes)
from repro_torch.models.common import normal, torch_dtype

#: Logical axes of :func:`moe_init`'s leaves (JAX's ``Param.axes``): the
#: router replicated, the experts over ``model`` (EP).
MOE_AXES = {"router": (None, None),
            "wi_gate": ("experts", "fsdp", "expert_ffn"),
            "wi_up": ("experts", "fsdp", "expert_ffn"),
            "wo": ("experts", "expert_ffn", "fsdp")}


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


def _reference(p: Dict[str, torch.Tensor], x_flat: torch.Tensor,
               cfg: ModelConfig):
    """The oracle's (y, per-expert counts fp32, probs (T, E) fp32)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    topv, topi, probs = _route(x_flat, p["router"], K)
    T = x_flat.shape[0]
    w_full = torch.zeros((T, E), dtype=torch.float32, device=x_flat.device)
    w_full = w_full.scatter(1, topi, topv)
    o = _expert_ffn(x_flat, p["wi_gate"], p["wi_up"], p["wo"])  # (E, T, d)
    y = torch.einsum("etd,te->td", o.float(), w_full).to(x_flat.dtype)
    return y, (w_full > 0).sum(0).float(), probs


def moe_reference(p: Dict[str, torch.Tensor], x_flat: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless oracle: every expert evaluated densely, (T, d) -> (y
    (T, d), aux), with JAX's dtype flow: routing in fp32, the expert
    products in the activation dtype, their outputs weighted in fp32 and
    y cast back.  ``aux`` is the load-balance loss E * sum(f_e * p_e)."""
    y, counts, probs = _reference(p, x_flat, cfg)
    f_e = counts / torch.clamp(counts.sum(), min=1.0)
    return y, cfg.num_experts * torch.sum(f_e * probs.mean(0))


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """JAX's per-expert capacity for ``tokens`` routed tokens:
    ``max(8, ceil8(ceil(tokens * K / E * capacity_factor)))``."""
    E, K = cfg.num_experts, cfg.experts_per_token
    c = int(math.ceil(tokens * K / E * cfg.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


# ---------------------------------------------------------------------------
# Drop accounting (the full path's ``dropped``, which JAX's moe_apply drops)
# ---------------------------------------------------------------------------

_DROPS: List[List[torch.Tensor]] = []


@contextlib.contextmanager
def record_drops():
    """Collect the capacity drops of every full-path call made in the
    block (a 0-d fp32 tensor each; a remat recompute in the backward pass
    is not counted again).  Yields the list."""
    got: List[torch.Tensor] = []
    _DROPS.append(got)
    try:
        yield got
    finally:
        _DROPS.remove(got)


def _note_drops(dropped: torch.Tensor) -> None:
    if _DROPS and torch._C._current_graph_task_id() == -1:
        _DROPS[-1].append(dropped.detach())


# ---------------------------------------------------------------------------
# The expert-parallel bodies (one team's part, as inside JAX's shard_map)
# ---------------------------------------------------------------------------

def _scatter_rows(n: int, idx: torch.Tensor, rows: torch.Tensor
                  ) -> torch.Tensor:
    """(n, d) zeros with ``rows`` written at ``idx``; an index of ``n``
    is dropped (JAX's out-of-range ``.at[].set``)."""
    buf = torch.zeros((n + 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return buf.index_put((idx,), rows)[:n]


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in [0, n): int64 counts
    of a fixed length, so the layer also runs on meta and fake tensors
    (the dry run), where bincount's data-dependent length cannot."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def _moe_local(x_loc, router_w, wg, wu, wo, *, E: int, K: int, C: int,
               ep_axis: str = "model", mesh=None):
    """One team's body of the full path: ``x_loc`` (T_loc, d) its token
    block, ``wg``/``wu``/``wo`` its ``E / ep`` experts.  Returns (y
    (T_loc, d), aux of its block, dropped (T_loc * K assignments past
    capacity ``C``)), 0-d fp32."""
    T_loc, d = x_loc.shape
    dev = x_loc.device
    topv, topi, probs = _route(x_loc, router_w, K)
    # (token, choice) assignments sorted by expert id, stably
    e_f = topi.reshape(-1)
    w_f = topv.reshape(-1)
    t_f = torch.arange(T_loc, device=dev).repeat_interleave(K)
    order = torch.argsort(e_f, stable=True)
    se, st, sw = e_f[order], t_f[order], w_f[order]
    counts = _counts(e_f, E)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(se.numel(), device=dev) - offsets[se]
    keep = pos < C
    slot = se * C + pos
    buf = _scatter_rows(E * C, torch.where(keep, slot, E * C), x_loc[st])
    # ship to the experts' teams, compute, ship back
    recv = all_to_all_tokens(buf.reshape(E, C, d), ep_axis, split_dim=0,
                             concat_dim=1, mesh=mesh)
    out = _expert_ffn(recv, wg, wu, wo)              # (E/ep, C*ep, d)
    send = all_to_all_tokens(out, ep_axis, split_dim=1, concat_dim=0,
                             mesh=mesh)
    flat = send.reshape(E * C, d)
    gathered = flat[torch.clamp(slot, max=E * C - 1)].float() \
        * (keep * sw)[:, None]
    y = torch.zeros((T_loc, d), dtype=torch.float32, device=dev) \
        .index_add(0, st, gathered)
    f_e = counts.float() / max(se.numel(), 1)
    aux = E * torch.sum(f_e * probs.mean(0))
    dropped = (~keep).sum().float()
    return y.to(x_loc.dtype), aux, dropped


def _moe_local_replicated(x_row, router_w, wg, wu, wo, *, E: int, K: int,
                          C: int, ep_axis: str = "model", mesh=None):
    """One team's body of the decode path: ``x_row`` (T_row, d) replicated
    over ``ep_axis``; the team evaluates the (token, expert) pairs of its
    ``E / ep`` experts and a sum over ``ep_axis`` combines the outputs.
    Returns (y (T_row, d), aux)."""
    T_row, d = x_row.shape
    dev = x_row.device
    ep = mesh_shape(mesh)[ep_axis]
    my = team_index(mesh, ep_axis)
    E_loc = E // ep
    topv, topi, probs = _route(x_row, router_w, K)
    e_f = topi.reshape(-1)
    w_f = topv.reshape(-1)
    t_f = torch.arange(T_row, device=dev).repeat_interleave(K)
    local = (e_f >= my * E_loc) & (e_f < (my + 1) * E_loc)
    le = torch.where(local, e_f - my * E_loc, E_loc)   # E_loc: not ours
    order = torch.argsort(le, stable=True)           # ours first, by expert
    se, st, sw = le[order], t_f[order], w_f[order]
    counts = _counts(le, E_loc + 1)[:E_loc]
    offsets = torch.cumsum(counts, 0) - counts
    se_c = torch.clamp(se, max=E_loc - 1)
    pos = torch.arange(se.numel(), device=dev) - offsets[se_c]
    keep = (se < E_loc) & (pos < C)
    slot = se_c * C + pos
    buf = _scatter_rows(E_loc * C, torch.where(keep, slot, E_loc * C),
                        x_row[st])
    out = _expert_ffn(buf.reshape(E_loc, C, d), wg, wu, wo) \
        .reshape(E_loc * C, d)
    gathered = out[torch.clamp(slot, max=E_loc * C - 1)].float() \
        * (keep * sw)[:, None]
    y = torch.zeros((T_row, d), dtype=torch.float32, device=dev) \
        .index_add(0, st, gathered)
    y = psum_autograd(y, mesh, ep_axis)
    f_e = _counts(e_f, E).float() / max(e_f.numel(), 1)
    aux = E * torch.sum(f_e * probs.mean(0))
    return y.to(x_row.dtype), aux


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

def _local_experts(p, mesh, E: int, ep: int):
    """This team's experts: the weights as given under
    ``rows_over(expert_blocks=True)`` (the sharded step's blocks of ``E /
    ep`` experts), else this team's slice of all ``E``."""
    ws = [p["wi_gate"], p["wi_up"], p["wo"]]
    k = E // ep
    if expert_blocks():
        if ws[0].shape[0] != k:
            raise ValueError(f"expert blocks of {ws[0].shape[0]} experts "
                             f"on a model axis of {ep} ({E} experts)")
        return ws
    my = team_index(mesh, "model")
    return [w.narrow(0, my * k, k) for w in ws]


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux scalar).  Without a mesh the
    dropless :func:`moe_reference`.  Under a mesh (see the module
    docstring) ``x`` is this rank's rows (``sharding.row_axes()`` says
    which mesh axes they are split over; the rank's block along the
    others is the same), ``p``'s experts are all ``E`` or, under
    ``rows_over(expert_blocks=True)``, this rank's ``E / ep``, and
    ``aux`` is the global one (JAX's mean over teams), the same on every
    rank."""
    mesh = current_mesh()
    B, S, d = x.shape
    T = B * S
    if mesh is None:
        y, aux = moe_reference(p, x.reshape(T, d), cfg)
        return y.reshape(B, S, d), aux
    E, K = cfg.num_experts, cfg.experts_per_token
    names = mesh_axis_names(mesh)
    rows = row_axes()
    rep = tuple(a for a in names if a not in rows)
    n, n_rep = mesh_size(mesh), axis_size(mesh, rep)
    x_flat = x.reshape(T, d)
    ep = mesh_shape(mesh).get("model", 0)
    if ep and E % ep == 0:
        wg, wu, wo = _local_experts(p, mesh, E, ep)
        if T % n_rep == 0:
            # full path: this team's token block of the rank's rows
            T_loc = T // n_rep
            j = team_index(mesh, rep) if rep else 0
            y, aux, dropped = _moe_local(
                x_flat[j * T_loc:(j + 1) * T_loc], p["router"], wg, wu, wo,
                E=E, K=K, C=capacity(T_loc, cfg), mesh=mesh)
            _note_drops(dropped)
            if rep:
                y = gather_autograd(y, mesh, rep)
            aux = psum_autograd(aux, mesh, names) / n
            return y.reshape(B, S, d), aux
        dp = tuple(a for a in names if a != "model")
        sub = tuple(a for a in dp if a not in rows)
        if dp and "model" not in rows and T % axis_size(mesh, sub) == 0:
            # decode path: this team's data block of the tokens, the same
            # on every rank of the model axis
            T_row = T // axis_size(mesh, sub)
            j = team_index(mesh, sub) if sub else 0
            y, aux = _moe_local_replicated(
                x_flat[j * T_row:(j + 1) * T_row], p["router"], wg, wu, wo,
                E=E, K=K, C=capacity(T_row, cfg), mesh=mesh)
            if sub:
                y = gather_autograd(y, mesh, sub)
            aux = psum_autograd(aux, mesh, names) / n
            return y.reshape(B, S, d), aux
        if expert_blocks():
            p = dict(p, **{k: gather_autograd(p[k], mesh, "model")
                           for k in ("wi_gate", "wi_up", "wo")})
    # the dense oracle on the rank's rows, its statistics over the mesh
    y, counts, probs = _reference(p, x_flat, cfg)
    counts = all_reduce_sum(counts, mesh, rows)
    p_e = psum_autograd(probs.sum(0), mesh, rows) / (T * axis_size(mesh, rows))
    f_e = counts / torch.clamp(counts.sum(), min=1.0)
    return y.reshape(B, S, d), E * torch.sum(f_e * p_e)
