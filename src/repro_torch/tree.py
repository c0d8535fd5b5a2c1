"""Nested containers of tensors (the port's parameter and state trees).

The port keeps parameters as nested dicts with ``params["layers"]`` a list
of per-layer dicts; these two functions take the place of ``jax.tree`` for
them.  They flatten as ``jax.tree`` does: dict keys in sorted order, so
leaves line up with the JAX package's; ``None`` is an empty subtree (no
leaf, kept as ``None`` by :func:`tree_map`); a NamedTuple is rebuilt by
its fields.
"""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    """Leaves of dicts, lists and tuples, depth first, dict keys sorted;
    ``None`` has none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure of ``tree``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if not isinstance(tree, tuple):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)
