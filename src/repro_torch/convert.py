"""Convert the JAX package's parameters into the port's.

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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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
