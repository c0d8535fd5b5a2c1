"""Op cost counter: the FLOPs, HBM bytes and collective bytes of a rank's
program, counted as its ops run (the port's counterpart of the JAX
package's ``repro/launch/hlocost.py``).

JAX's dry run reads its costs from the compiled, post-SPMD HLO text.
Eager PyTorch has no HLO, so :class:`OpCost` is a ``TorchDispatchMode``
that sees every op the rank dispatches, on real tensors, on
``FakeTensorMode`` tensors (enter the fake mode first, the counter inside
it) and on ``meta`` tensors alike, and counts:

* **the matmul family** (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the
  convolutions and their backward, torch's attention ops):
  ``2 * m * n * k``, by ``torch.utils.flop_counter``'s formulas;
* **elementwise ops** (ATen's ``pointwise`` tag): the result's ``numel``;
  **reductions** (:data:`REDUCTIONS`: sums, means, maxima, norms,
  softmax, cumulative sums, ``topk``): the input's ``numel``; ``sort``:
  ``n log2 n``.  These are ``hlocost.py``'s rules for XLA's elementwise,
  ``reduce`` and ``sort`` instructions; a dtype conversion, a copy or a
  fill (:data:`MOVES`, though ATen tags ``clone`` pointwise), an index or
  a concatenation moves bytes and does no FLOP, as there;
* **views and metadata ops** (aliasing ops, ``empty``, ``wait_tensor``,
  ``prim``'s device queries, :data:`METADATA`): nothing;
* **bytes**: the operand bytes plus the result bytes of every op that is
  not a view.  Eager PyTorch fuses nothing, so this is what the eager
  port moves through HBM, op by op; ``hlocost.py``'s bytes are XLA's
  fusion-boundary proxy, which a fused program would move instead;
* **the five kernel ops** (``torch.ops.repro_torch.{flash_attention,
  decode_attention, paged_attention, ssd_scan, rglru_scan}``): FLOPs and
  bytes from their shapes (:func:`kernel_cost`), since each is one
  kernel.  The flash op's bytes are JAX's ``flash_kernel_bytes`` for one
  pass of one layer; the decode ops read the cache's whole extent (its
  ``lengths`` are data a counter does not read).  Their backward passes
  recompute through the plain versions, so those ATen ops count as they
  run.  The RPC transport's ops move their operands and do no FLOP;
* **collectives**: the functional collectives of
  ``distributed/collectives.py`` (``_c10d_functional`` and its autograd
  twins) and ``c10d``'s in-place ones, by JAX's kinds (all-gather,
  all-reduce, reduce-scatter, all-to-all), each its operand bytes, as
  the JAX dry run's ``parse_collective_bytes`` reads them.

An eager loop runs every trip, so ``hlocost.py``'s trip counts have no
counterpart here, nor does its ``attention_region_bytes``: the kernel
ops' bytes are already the analytic ones.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: JAX's collective kinds (``dryrun.py::_COLLECTIVES``), in its order.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLL_NAMES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"),
               ("reducescatter", "reduce-scatter"),
               ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
               ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
               ("broadcast", "broadcast"))
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")

#: Reductions: FLOPs are the input's element count.
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "var_mean",
    "std", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum", "cumprod", "logcumsumexp",
    "argmax", "argmin", "any", "all", "topk", "nansum",
})
_SORTS = frozenset({"sort", "argsort"})
#: Ops that move no data although their schema does not alias.
METADATA = frozenset({
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
    "new_empty_strided", "_unsafe_view", "alias", "lift_fresh",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "set_", "resize_",
    "record_stream", "wait_tensor", "_wrap_tensor_autograd",
})
#: Copies and fills: bytes and no FLOP (XLA's ``copy`` and
#: ``broadcast``), though ATen tags some of them pointwise.
MOVES = frozenset({
    "clone", "copy", "copy_", "_copy_from", "_to_copy", "lift_fresh_copy",
    "fill", "fill_", "zero_", "zeros_like", "ones_like", "full_like",
})
#: The kernel ops counted from their shapes.
KERNEL_OPS = ("flash_attention", "decode_attention", "paged_attention",
              "ssd_scan", "rglru_scan")
_NAMESPACE = "repro_torch"
#: JAX's flash q block (``dryrun.py::flash_kernel_bytes(blk_q=2048)``).
FLASH_BLK_Q = 2048


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@functools.lru_cache(maxsize=4096)
def visible_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
                  q_offset: int) -> int:
    """(query, key) pairs a flash call scores: query ``i`` at position
    ``i + q_offset`` sees keys ``j <= i + q_offset`` (causal) and ``j >
    i + q_offset - window`` (windowed)."""
    total = 0
    for i in range(sq):
        pos = i + q_offset
        hi = min(sk, pos + 1) if causal else sk
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def kernel_cost(name: str, args, out) -> Dict[str, float]:
    """FLOPs and bytes of one call of kernel op ``name`` from its shapes."""
    if name == "flash_attention":
        q, k, v, causal, window, q_offset = args[:6]
        B, Sq, Hq, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        pairs = visible_pairs(Sq, Sk, bool(causal),
                              None if window is None else int(window),
                              int(q_offset))
        it = q.element_size()
        streams = it * (2 * Hq * Sq + 2 * Hkv * Sk) * B * D
        restream = it * (Sq / FLASH_BLK_Q) * Sk * Hkv * D * B
        return {"flops": 4.0 * B * Hq * D * pairs,
                "bytes": float(streams + restream)}
    if name in ("decode_attention", "paged_attention"):
        q, k, v = args[:3]
        B, Hq, D = q.shape
        if name == "decode_attention":
            T, window = k.shape[1], args[4]
        else:
            T, window = args[3].shape[1] * k.shape[1], args[5]
        keys = min(T, int(window)) if window else T
        kv_bytes = 2 * B * keys * k.shape[-2] * D * k.element_size()
        rest = sum(_nbytes(t) for t in _tensors(args[3:])) + 2 * _nbytes(q)
        return {"flops": 4.0 * B * Hq * D * keys,
                "bytes": float(kv_bytes + rest)}
    if name == "ssd_scan":
        x, dt, A, Bm, Cm, Dv, chunk = args[:7]
        bsz, S, H, P = x.shape
        N = Bm.shape[-1]
        L = min(int(chunk), S)
        n_chunks = math.ceil(S / L)
        per_chunk = 2 * L * L * N + H * (2 * L * L * P + 4 * L * N * P)
        return {"flops": float(bsz * n_chunks * per_chunk),
                "bytes": float(sum(_nbytes(t) for t in _tensors((args, out))))}
    if name == "rglru_scan":
        a, b = args[:2]
        return {"flops": 2.0 * a.numel(),
                "bytes": float(sum(_nbytes(t) for t in _tensors((args, out))))}
    raise KeyError(name)


def _positional(func, args, kwargs) -> list:
    """Every argument of a call in its schema's order."""
    return [args[i] if i < len(args) else kwargs.get(a.name, a.default_value)
            for i, a in enumerate(func._schema.arguments)]


def collective_kind(func) -> Optional[str]:
    """JAX's kind of a collective op, else None."""
    if func.namespace not in _COLL_NAMESPACES:
        return None
    name = func.__name__.split(".")[0]
    for part, kind in _COLL_NAMES:
        if part in name:
            return kind
    return None


class OpCost(TorchDispatchMode):
    """Counts a program's FLOPs, bytes and collective bytes (see the module
    docstring) while it runs inside ``with OpCost() as c:``; then
    :meth:`summary`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._matmul = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.flops_by_class: Dict[str, float] = {
            "matmul": 0.0, "elementwise": 0.0, "reduction": 0.0,
            "kernel": 0.0}
        self.kernel_calls: Dict[str, int] = {k: 0 for k in KERNEL_OPS}
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        name = func.__name__.split(".")[0]
        if func.namespace == "prim" or name in METADATA or func.is_view:
            return
        if func.namespace == _NAMESPACE and name in KERNEL_OPS:
            cost = kernel_cost(name, _positional(func, args, kwargs), out)
            self.flops += cost["flops"]
            self.bytes += cost["bytes"]
            self.flops_by_class["kernel"] += cost["flops"]
            self.kernel_calls[name] += 1
            return
        operands = _tensors((args, kwargs))
        moved = sum(_nbytes(t) for t in operands) + \
            sum(_nbytes(t) for t in _tensors(out))
        self.bytes += moved
        kind = collective_kind(func)
        if kind is not None:
            self.collectives[kind] = self.collectives.get(kind, 0.0) + \
                sum(_nbytes(t) for t in operands)
            return
        packet = func.overloadpacket
        if packet in self._matmul:
            flops, cls = float(self._matmul[packet](
                *args, **kwargs, out_val=out)), "matmul"
        elif name in REDUCTIONS and operands:
            flops, cls = float(operands[0].numel()), "reduction"
        elif name in _SORTS and operands:
            n = operands[0].numel()
            flops, cls = n * max(1.0, math.log2(max(n, 2))), "reduction"
        elif name in MOVES:
            return
        elif torch.Tag.pointwise in func.tags:
            res = _tensors(out)
            flops, cls = float(res[0].numel() if res else 0), "elementwise"
        else:
            return
        self.flops += flops
        self.flops_by_class[cls] += flops

    def summary(self) -> Dict[str, Any]:
        """``hlocost.analyze``'s keys (``flops``, ``bytes``,
        ``collectives``, ``collective_bytes``) and the counter's own
        breakdowns."""
        coll = dict(self.collectives)
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": coll,
                "collective_bytes": sum(coll.values()),
                "flops_by_class": dict(self.flops_by_class),
                "kernel_calls": dict(self.kernel_calls), "ops": self.ops}
