"""Nested containers of tensors (the port's parameter and state trees).

The port keeps parameters as nested dicts with ``params["layers"]`` a list
of per-layer dicts; these functions take the place of ``jax.tree`` for
them.  They flatten as ``jax.tree`` does: dict keys in sorted order, so
leaves line up with the JAX package's; ``None`` is an empty subtree (no
leaf, kept as ``None`` by :func:`tree_map`); a NamedTuple is rebuilt by
its fields.

:func:`register_export_node` registers a state dataclass with
``torch.utils._pytree``, so a ``torch.export`` program takes and returns
it (the serving engine's :class:`~repro_torch.serving.kvcache.PagedKV`
and the allocator states).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Iterable, List, Tuple


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


_END = object()


def _children(tree: Any):
    """``(key, child)`` pairs in flattening order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), t) for i, t in enumerate(tree)]
    return None


def flatten_with_paths(tree: Any) -> Dict[str, Any]:
    """The leaves keyed by their paths, in :func:`leaves` order: the keys
    joined by ``/`` as the JAX package's checkpoints build them from
    ``tree_flatten_with_path`` (a dict key, a NamedTuple field's name, a
    list or tuple index), e.g. ``opt/master/layers/0/wq`` and
    ``opt/step``."""
    flat: Dict[str, Any] = {}

    def walk(t, prefix):
        if t is None:
            return
        kids = _children(t)
        if kids is None:
            flat["/".join(prefix)] = t
            return
        for k, child in kids:
            walk(child, prefix + [k])

    walk(tree, [])
    return flat


def unflatten(structure: Any, values: Iterable[Any]) -> Any:
    """``structure``'s tree with its leaves replaced, in :func:`leaves`
    order, by ``values`` (the inverse of :func:`leaves`)."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(x) for x in t]
            if not isinstance(t, tuple):
                return out
            return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
        return next(it)

    out = build(structure)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more values than the structure's leaves")
    return out


def register_export_node(cls: type, static: Tuple[str, ...]) -> None:
    """Register the dataclass ``cls`` as a ``torch.utils._pytree`` node: its
    fields other than ``static`` are its children, in declaration order;
    the values of ``static`` (ints) are its context, which a saved
    ``torch.export`` program keeps as a JSON list and reads back as a
    tuple.  Its serialized type name is ``<module>.<class>``, as the JAX
    package's ``register_pytree_node_serialization`` names its states
    (the counterpart of ``src/repro/core/allocator.py:1389-1414``)."""
    import torch.utils._pytree as pytree

    children = tuple(f.name for f in dataclasses.fields(cls)
                     if f.name not in static)

    def flatten(x):
        return ([getattr(x, f) for f in children],
                tuple(getattr(x, f) for f in static))

    def flatten_with_keys(x):
        values, context = flatten(x)
        return [(pytree.GetAttrKey(f), v)
                for f, v in zip(children, values)], context

    def unflatten(values, context):
        return cls(**dict(zip(children, values)), **dict(zip(static, context)))

    pytree.register_pytree_node(
        cls, flatten, unflatten,
        serialized_type_name=f"{cls.__module__}.{cls.__name__}",
        flatten_with_keys_fn=flatten_with_keys,
        to_dumpable_context=lambda context: json.dumps(list(context)),
        from_dumpable_context=lambda dumped: tuple(json.loads(dumped)))
