"""Export-graph descent: transport placement lints.

The port of ``repro/analysis/walker.py``.  The event rules see what the
runtime emits; the walker sees what an exported program contains: the
graph of ``torch.export.export(..., strict=False)`` and every subgraph a
higher-order node holds.  Its callback nodes are the transport's custom
ops (``kernels/rpc_*/ops.py``), the ones that reach the host:
``rpc_post`` (a round trip), ``rpc_async_post`` and
``rpc_async_collect`` (an async flush).  ``rpc_enqueue`` touches no host:
it is counted, never flagged (it is what the lint recommends).

* ``CALLBACK_IN_LOOP``, torch edition of JAX's scan-body rule.  A
  callback node inside a loop subgraph (``scan``, ``while_loop``,
  ``map_impl``) that is not confined to a ``cond`` branch syncs with the
  host every iteration.  The port's loops are Python loops, which export
  unrolls, so the rule also fires for a callback that one graph holds
  more than once on the same call path (every frame of its
  ``stack_trace`` outside the runtime and torch: one line, reached from
  one place), outside any ``cond`` branch: the unrolled loop.  A
  callback in a taken branch is exempt (firing is data-dependent).
* ``CALLBACK_IN_MESH``, the port's analogue of JAX's ``MESH_PRIMS``
  rule.  An expanded region is Python that export inlines (its
  collectives are ``_c10d_functional`` nodes, no region node), so the
  test is a frame test: a callback node whose call stack passes through
  ``core/expand.py::expand``'s region wrapper (:func:`region_frame`) sits
  inside a partitioned program.

A node's site is the last frame of its call stack (the one its op
wrapper annotates under export, else ``node.meta["stack_trace"]``)
outside ``repro_torch/core``, ``repro_torch/kernels``,
``repro_torch/analysis`` (but ``corpus.py``) and torch: the rule the
event sites use (``events.is_internal_frame``).
:func:`walk_graph` also counts the port's op nodes by name (``counts=``).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.model import Hazard, HazardReport
from repro_torch.core import events
from repro_torch.core.expand import region_frame
from repro_torch.kernels import OPS_NAMESPACE, STACK_KEY
from repro_torch.tree import leaves

#: The transport's ops, and those of them that reach the host.
TRANSPORT_OPS = frozenset({"rpc_post", "rpc_enqueue", "rpc_async_post",
                           "rpc_async_collect"})
CALLBACK_OPS = frozenset({"rpc_post", "rpc_async_post", "rpc_async_collect"})
LOOP_OPS = frozenset({"scan", "while_loop", "map_impl"})
COND_OPS = frozenset({"cond"})
#: Higher-order wrappers of a mutating op (args[0] is the op).
_WRAPPERS = frozenset({"auto_functionalized", "auto_functionalized_v2"})

_FRAME = re.compile(r'File "([^"]+)", line (\d+)')


def _user_frames(node: torch.fx.Node) -> List[str]:
    """``file:line`` of each frame of the node's call stack outside the
    runtime and torch, outermost first: the stack the transport op's
    wrapper annotated (``kernels/__init__.py::traced_stack``), else the
    node's ``stack_trace``."""
    stack = (node.meta.get("custom") or {}).get(STACK_KEY)
    if stack is None:
        stack = [f"{fn}:{line}" for fn, line in
                 _FRAME.findall(node.meta.get("stack_trace") or "")]
    return [site for site in stack
            if not events.is_internal_frame(site.rpartition(":")[0])]


def _in_region(node: torch.fx.Node) -> bool:
    """True iff the node's call stack (all of it, the runtime's frames
    included) passes through ``expand``'s region wrapper."""
    path, first, last = region_frame()
    stack = (node.meta.get("custom") or {}).get(STACK_KEY)
    frames = ([tuple(site.rsplit(":", 1)) for site in stack]
              if stack is not None else
              _FRAME.findall(node.meta.get("stack_trace") or ""))
    return any(fn == path and first <= int(line) <= last
               for fn, line in frames)


def _op_name(target) -> Tuple[str, str]:
    """``(namespace, name)`` of a node's target: an ``OpOverload``'s, or
    ``("higher_order", name)`` for a higher-order op."""
    if isinstance(target, torch._ops.OpOverload):
        ns, _, name = target._schema.name.partition("::")
        return ns, name
    if isinstance(target, torch._ops.HigherOrderOperator):
        return "higher_order", target.name()
    return "", getattr(target, "__name__", str(target))


def _subgraphs(node: torch.fx.Node, owner: torch.nn.Module):
    """Every graph module a higher-order node names through its args."""
    stack = list(node.args) + list(node.kwargs.values())
    while stack:
        a = stack.pop()
        if isinstance(a, (tuple, list)):
            stack.extend(a)
        elif isinstance(a, torch.fx.Node) and a.op == "get_attr":
            sub = getattr(owner, a.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                yield sub


def walk_graph(gm: torch.fx.GraphModule,
               report: Optional[HazardReport] = None, *,
               counts: Optional[Dict[str, int]] = None,
               in_loop: bool = False,
               in_cond: bool = False) -> HazardReport:
    """Collect transport placement hazards from ``gm`` (an exported
    program's ``graph_module``) and every subgraph under it; with
    ``counts``, add each of the port's op nodes to it by name."""
    if report is None:
        report = HazardReport()
    paths: Dict[Tuple[str, ...], List[Tuple[str, str]]] = {}
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        ns, name = _op_name(node.target)
        if ns == "higher_order" and name in _WRAPPERS and node.args:
            ns, name = _op_name(node.args[0])
        if ns == OPS_NAMESPACE:
            if counts is not None:
                counts[name] = counts.get(name, 0) + 1
            if name in CALLBACK_OPS:
                frames = _user_frames(node)
                site = frames[-1] if frames else "<unknown>"
                if _in_region(node):
                    report.add(Hazard.make(
                        "CALLBACK_IN_MESH",
                        f"host callback {name!r} inside an expanded region "
                        "— every team calls its host; enqueue on the team "
                        "queue and drain at the program boundary",
                        site, callback=name))
                if in_loop and not in_cond:
                    report.add(_in_loop(name, site))
                elif not in_cond:
                    paths.setdefault(tuple(frames), []).append((name, site))
            continue
        if ns != "higher_order":
            continue
        child_loop = in_loop or name in LOOP_OPS
        # a cond OUTSIDE a loop does not confine what is INSIDE it
        child_cond = False if name in LOOP_OPS else (
            in_cond or name in COND_OPS)
        for sub in _subgraphs(node, gm):
            walk_graph(sub, report, counts=counts, in_loop=child_loop,
                       in_cond=child_cond)
    for frames, calls in paths.items():
        if frames and len(calls) > 1:
            name, site = calls[0]
            report.add(_in_loop(name, site, unrolled_calls=len(calls)))
    return report


def _in_loop(name: str, site: str, **detail) -> Hazard:
    return Hazard.make(
        "CALLBACK_IN_LOOP",
        f"host callback {name!r} runs every iteration of an enclosing "
        "loop — batch through an RpcQueue and flush once",
        site, callback=name, **detail)


class _Program(torch.nn.Module):
    def __init__(self, fn, kwargs):
        super().__init__()
        self.fn, self.kw = fn, kwargs

    def forward(self, *args):
        out = self.fn(*args, **self.kw)
        tensors = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        return tuple(tensors) if tensors else torch.zeros(())


def analyze_graph(fn, *args, **kwargs) -> HazardReport:
    """Export ``fn(*args, **kwargs)`` (``torch.export``, non-strict: its
    Python runs on fake tensors, no kernel launches) and walk the
    result."""
    with torch.fx.traceback.preserve_node_meta():
        ep = torch.export.export(_Program(fn, kwargs), tuple(args),
                                 strict=False)
    return walk_graph(ep.graph_module).deduped()
