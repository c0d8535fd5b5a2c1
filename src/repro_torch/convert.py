"""Convert the JAX package's parameters into the port's, and the port's
trees into the JAX package's stacked layout and back.

The JAX ``values`` tree (nested dicts of numpy arrays, as
``repro.models.common.split_params`` yields them after ``np.asarray``) has
the same layouts as the port's parameters, except that the JAX package
stacks layers on axis 0 for ``lax.scan``: ``values["layers"]`` (and the
hybrid family's ``values["rec_layers"]`` and ``values["attn_layers"]``,
the encdec family's ``values["enc_layers"]`` and ``values["dec_layers"]``)
becomes a list of per-layer dicts (a moe layer's ``moe`` dict with them:
its fp32 ``router`` and its (E, d, f) and (E, f, d) experts, stacked
(L, E, ...) in JAX).  A vlm tree is the dense layout.  bf16 arrays arrive as
``ml_dtypes.bfloat16``; they go through float32 to ``torch.bfloat16``,
which is exact.

:func:`to_jax_layout` and :func:`from_jax_layout` move a whole tree (a
``values`` dict, an ``OptState`` of them, or a dict holding both, as a
training checkpoint does) between the two layouts, in tensors or in
:class:`~repro_torch.core.rpc.ShapeDtype` stand-ins; a checkpoint written
by the JAX package's trainer restores in the port through them, and one
the port writes in JAX's layout restores in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.rpc import ShapeDtype
from repro_torch.train.optimizer import OptState
from repro_torch.tree import leaves


def to_tensor(a, *, device) -> torch.Tensor:
    """A numpy (or ml_dtypes bf16) array -> a tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


_STACKED = ("layers", "rec_layers", "attn_layers", "enc_layers",
            "dec_layers")


def params_from_jax(values: Dict[str, Any], *, device) -> Dict[str, Any]:
    """JAX parameter values -> the port's parameter dict on ``device``."""
    out = {k: _map(v, lambda a: to_tensor(a, device=device))
           for k, v in values.items() if k not in _STACKED}
    for key in _STACKED:
        if key not in values:
            continue
        stacked = values[key]
        n_layers = np.asarray(stacked["ln1"]).shape[0]
        out[key] = [_map(stacked, lambda a, i=i: to_tensor(np.asarray(a)[i],
                                                          device=device))
                    for i in range(n_layers)]
    return out


def axes_from_jax(axes: Dict[str, Any], values: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """JAX's logical-axes tree (``split_params``'s second tree) -> the
    port's layout: each stacked group's axes, their leading ``"stack"``
    dropped, repeated for its layers (counted in ``values``, the matching
    JAX values or shapes)."""
    def unstack(a):
        if isinstance(a, dict):
            return {k: unstack(v) for k, v in a.items()}
        if a[:1] != ("stack",):
            raise ValueError(f"a stacked leaf's axes {a!r} lack 'stack'")
        return tuple(a[1:])

    out = {k: v for k, v in axes.items() if k not in _STACKED}
    for key in _STACKED:
        if key in axes:
            n = np.shape(values[key]["ln1"])[0]
            out[key] = [unstack(axes[key]) for _ in range(n)]
    return out


def _stack(layer_list):
    """A list of per-layer trees -> one tree of leaves stacked on axis 0."""
    first = layer_list[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layer_list]) for k in first}
    if isinstance(first, ShapeDtype):
        return ShapeDtype((len(layer_list),) + first.shape, first.dtype)
    return torch.stack(layer_list)


def _unstack(tree, n):
    """One tree stacked on axis 0 -> a list of ``n`` per-layer trees
    (views of the stacked tensors)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, ShapeDtype):
        return [ShapeDtype(tree.shape[1:], tree.dtype)] * n
    return list(torch.unbind(tree, 0))


def _is_values(tree) -> bool:
    return isinstance(tree, dict) and any(k in tree for k in _STACKED)


def to_jax_layout(tree: Any) -> Any:
    """The port's layout -> the JAX package's: every per-layer list of a
    ``values`` dict (wherever it sits in ``tree``) stacked on axis 0."""
    if isinstance(tree, OptState):
        return OptState(*(to_jax_layout(t) for t in tree))
    if _is_values(tree):
        return {k: _stack(v) if k in _STACKED else v
                for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: to_jax_layout(v) for k, v in tree.items()}
    return tree


def from_jax_layout(tree: Any) -> Any:
    """The inverse of :func:`to_jax_layout`."""
    if isinstance(tree, OptState):
        return OptState(*(from_jax_layout(t) for t in tree))
    if _is_values(tree):
        out = {}
        for k, v in tree.items():
            if k in _STACKED:
                n = leaves(v)[0].shape[0]
                v = _unstack(v, n)
            out[k] = v
        return out
    if isinstance(tree, dict):
        return {k: from_jax_layout(v) for k, v in tree.items()}
    return tree
