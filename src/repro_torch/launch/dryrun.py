"""The production dry run: every (architecture x input shape) cell on the
production mesh, counted on one rank, and its roofline terms (the JAX
package's ``repro/launch/dryrun.py``).

JAX lowers and compiles each cell for a forced 512-device CPU platform
and reads the costs off the compiled HLO.  Eager PyTorch has no compiler
to ask, so the port runs the cell, in one process, on the CPU, with no
card:

* **the world** is the ``fake`` process-group backend
  (``torch.testing._internal.distributed.fake_pg``): one process is rank
  0 of 256 ranks, or 512 with ``--multi-pod``, and
  ``launch/mesh.py::make_production_mesh`` builds the (16, 16) or (2,
  16, 16) mesh over it.  Its collectives move no data;
* **the tensors** are ``meta`` tensors: shapes and dtypes, no storage, so
  qwen3-moe-235b is never allocated.  ``FakeTensorMode`` would do the
  same, but its Python dispatch costs about six times the meta kernels'
  on a training step, which would make ``--all`` take hours; the counter
  works on both (``tests/test_torch_dryrun.py``), and the card's
  ``dryrun`` line of ``chip_smoke.py`` holds a step's count on the card
  against both;
* **the cells** run the port's own design for a rank: a train cell is
  ``train/step.py``'s sharded step (``MeshPlan``, ZeRO-1, ``gather_once``)
  on the rank's blocks; a prefill or decode cell gathers the compute
  weights and runs ``Model.prefill`` or ``Model.decode_step`` on the
  rank's rows under ``distributed/sharding.py::rows_over``.  The
  ``model`` axis does no tensor parallelism in the port, so where a
  batch does not divide over the whole mesh ranks repeat rows:
  ``row_replicas`` says how often, and ``useful_compute_ratio`` shows the
  waste;
* **the costs** are :class:`~repro_torch.launch.opcost.OpCost`'s count of
  the rank's ops (FLOPs, bytes, collective bytes by kind).  The fake
  world's collectives return no data, so the step's metrics are garbage:
  the dry run reads only shapes, counts and bytes;
* **memory** is counted from the shapes a rank holds: its value blocks,
  ZeRO-1 blocks (fp32 master, mu, nu), batch rows and cache rows
  (``argument_bytes``) and the weights it gathers for compute
  (``gathered_bytes``), against one H100's 80 GB.  XLA's
  ``memory_analysis`` (temporaries included) has no counterpart: no
  temporary is counted, so a cell whose held bytes exceed 80 GB cannot
  fit, and one within them may still not.

The roofline terms take the H100's constants where JAX's take the TPU
v5e's; ``memory_s_kernel_adj`` and ``roofline_fraction_kernel_adj``
equal the plain terms, since the kernel ops' bytes are already the
analytic ones (``launch/opcost.py``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--rules baseline] --out results/dryrun_torch/pod.json
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import CONFIGS, SHAPES, applicable, get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.launch.opcost import COLLECTIVES, OpCost
from repro_torch.models.model_zoo import build_model, input_specs
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import (MeshPlan, make_train_step, row_axes_for,
                                    rows_block)
from repro_torch.tree import leaves, tree_map, unflatten

# ---------------------------------------------------------------------------
# Hardware constants (NVIDIA H100 SXM 80 GB, the card "NVIDIA H100 80GB
# HBM3, 700 W" of nvidia-smi)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s (H100 SXM datasheet)
HBM_BW = 3.35e12             # HBM3 bytes/s (H100 SXM datasheet)
# NVLink 4: 900 GB/s bidirectional a GPU (H100 SXM datasheet), 450 GB/s a
# direction.  The multi-pod mesh's ``pod`` axis would cross InfiniBand,
# which this one figure ignores, as JAX's single ``LINK_BW`` does for its
# pods.
LINK_BW = 450e9
#: One card's memory, bytes.
HBM_BYTES = 80e9

# ---------------------------------------------------------------------------
# Rule sets (JAX's, entry for entry)
# ---------------------------------------------------------------------------
RULE_SETS: Dict[str, Optional[Tuple]] = {
    # the paper-faithful baseline: expansion by the default rules table
    "baseline": None,
    # replicate KV heads instead of uneven padding (GQA kv < tp)
    "kv_repl": (("kv_heads", None),),
    # sequence-parallel attention: shard seq, replicate heads
    "seq_attn": (("heads", None), ("kv_heads", None), ("qkv", None),
                 ("seq", "model")),
    # decode: shard the KV-cache sequence dim over model instead of kv heads
    "kv_seq": (("kv_heads", None),),
    # no FSDP (pure DP + TP): measures what ZeRO-3 sharding buys
    "no_fsdp": (("fsdp", None),),
    # batch over (data, model) for decode (more batch parallelism, no TP)
    "decode_dp": (("batch", ("pod", "data", "model")), ("heads", None),
                  ("kv_heads", None), ("vocab", None), ("ffn", None)),
}


def auto_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Pick grad-accum steps so per-device saved activations fit ~4 GB
    (JAX's rule)."""
    dims = sh.mesh_shape(mesh)
    dp = dims.get("data", 1) * dims.get("pod", 1)
    L = max(cfg.num_layers, 1)
    if cfg.family == "encdec":
        # decoder layers carry self-attn + cross-attn residuals
        L = cfg.encoder_layers + 2 * cfg.decoder_layers
    act = shape.global_batch * shape.seq_len * cfg.d_model * 2 * L
    k = max(1, math.ceil(act / (dp * 4e9)))
    k = 1 << (k - 1).bit_length()                     # round up to pow2
    return min(k, max(1, shape.global_batch // dp))


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

def fake_world(n: int) -> None:
    """Make this process rank 0 of a ``fake`` world of ``n`` ranks (an
    earlier fake world of another size is left first; a real world
    raises)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a fake world; this process "
                               "is in a real one")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_mesh(multi_pod: bool = False):
    """The production mesh over a fake world of its size."""
    shape, _ = production_shape(multi_pod)
    fake_world(math.prod(shape))
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def _meta(spec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _block_bytes(specs, shardings) -> int:
    return sum(math.prod(s.block_shape(v.shape)) * v.dtype.itemsize
               for v, s in zip(leaves(specs), shardings))


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules=None,
               microbatches: Optional[int] = None,
               gather_once: bool = False):
    """Returns ``(fn, args, extra)``: ``fn(*args)`` runs the cell's work
    for this rank on meta tensors; ``extra`` has the held bytes, the rows
    and, for a train cell, ``microbatches`` and (once ``fn`` ran) the
    step's ``weight_gathers``."""
    model = build_model(cfg, "meta")
    n = sh.mesh_size(mesh)
    with sh.ShardingCtx(mesh, rules):
        plan = MeshPlan.build(model, mesh, rules)
        values = plan.block_values(tree_map(_meta, plan.specs))
        batch = {k: _meta(s) for k, s in input_specs(cfg, shape).items()}
        B = shape.global_batch
        extra: Dict[str, Any] = {
            "gathered_bytes": _block_bytes(plan.specs, plan.compute)}
        if shape.kind == "train":
            mb = microbatches or auto_microbatches(cfg, shape, mesh)
            rows = row_axes_for(mesh, B // mb)
            opt = plan.init_opt(values)
            step = make_train_step(model, OptConfig(), microbatches=mb,
                                   gather_once=gather_once, plan=plan)

            def fn(values, opt, batch):
                with sh.ShardingCtx(mesh, rules):
                    out = step(values, opt, batch)
                extra["weight_gathers"] = step.weight_gathers
                return out

            args = (values, opt, batch)
            held = _nbytes(values) + _nbytes(opt[:3]) + \
                _nbytes(batch) // sh.axis_size(mesh, rows)
            extra["microbatches"] = mb
        else:
            rows = row_axes_for(mesh, B)
            b_loc = B // sh.axis_size(mesh, rows)

            def params_of(values):
                return unflatten(plan.specs, plan.gather_for_compute(values))

            if shape.kind == "prefill":
                def fn(values, batch):
                    with sh.ShardingCtx(mesh, rules):
                        params = params_of(values)
                        with sh.rows_over(rows, expert_blocks=True):
                            return model.prefill(
                                params, rows_block(batch, mesh, rows),
                                shape.seq_len)

                args = (values, batch)
                held = _nbytes(values) + _nbytes(batch) // \
                    sh.axis_size(mesh, rows)
            else:
                # decode / long_decode: one token a row against a cache of
                # seq_len, the rank's rows of it
                cache = model.init_cache(b_loc, shape.seq_len)

                def fn(values, cache, batch):
                    with sh.ShardingCtx(mesh, rules):
                        params = params_of(values)
                        with sh.rows_over(rows, expert_blocks=True):
                            tokens = rows_block(batch, mesh, rows)["tokens"]
                            return model.decode_step(params, cache, tokens)

                args = (values, cache, batch)
                held = _nbytes(values) + _nbytes(cache) + \
                    _nbytes(batch) // sh.axis_size(mesh, rows)
        extra.update(
            argument_bytes=held, rows_axes=list(rows),
            row_replicas=n // sh.axis_size(mesh, rows))
    return fn, args, extra


# ---------------------------------------------------------------------------
# Roofline extraction
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful-compute estimate: 6·N·D train (2·N·D inference) + attention
    (JAX's)."""
    n_active = cfg.active_params()
    hd = cfg.resolved_head_dim
    if shape.kind == "train":
        D = shape.tokens
        base = 6.0 * n_active * D
        attn = 6.0 * cfg.num_layers * shape.global_batch * \
            (shape.seq_len ** 2) * cfg.num_heads * hd          # causal, fwd+bwd
        return base + (attn if cfg.family not in ("ssm",) else 0.0)
    if shape.kind == "prefill":
        D = shape.tokens
        base = 2.0 * n_active * D
        attn = 2.0 * cfg.num_layers * shape.global_batch * \
            (shape.seq_len ** 2) * cfg.num_heads * hd / 2
        return base + (attn if cfg.family not in ("ssm",) else 0.0)
    # decode: one token per sequence
    base = 2.0 * n_active * shape.global_batch
    if cfg.family == "ssm":
        return base
    window = cfg.local_window or shape.seq_len
    kv_len = min(window, shape.seq_len)
    attn = 4.0 * cfg.num_layers * shape.global_batch * kv_len * \
        cfg.num_heads * hd
    return base + attn


def flash_kernel_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       blk_q: int = 2048) -> float:
    """JAX's analytic per-device HBM bytes of the attention kernels for
    this cell: q/k/v/o streams + the K/V restream per q block (fwd; x3 with
    the recompute backward), for the TP/DP sharding JAX's cell uses."""
    if cfg.family == "ssm":
        return 0.0
    dims = sh.mesh_shape(mesh)
    dp = dims.get("data", 1) * dims.get("pod", 1)
    tp = dims.get("model", 1)
    hq = max(cfg.padded_heads // tp, 1)
    hkv = max(cfg.num_kv_heads // tp, 1) if cfg.num_kv_heads % tp == 0 \
        else cfg.num_kv_heads                     # replicated kv
    hd = cfg.resolved_head_dim
    B_loc = max(shape.global_batch // dp, 1)
    if shape.kind in ("train", "prefill"):
        S = shape.seq_len
        L = cfg.num_layers if cfg.family != "encdec" \
            else cfg.encoder_layers + 2 * cfg.decoder_layers
        passes = 3.0 if shape.kind == "train" else 1.0
        streams = 2.0 * (2 * hq + 2 * hkv) * B_loc * S * hd
        restream = 2.0 * (S / blk_q) * S * hkv * hd * B_loc
        return passes * L * (streams + restream)
    # decode: one token vs the (seq-sharded) cache: k+v read, bf16
    S = min(cfg.local_window or shape.seq_len, shape.seq_len)
    L = cfg.num_layers if cfg.family != "encdec" else 2 * cfg.decoder_layers
    return 2.0 * L * B_loc * (S / tp) * cfg.num_kv_heads * hd * 2.0


def roofline(cost: Dict[str, float], coll: Dict[str, float], n_chips: int,
             cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """JAX's roofline terms from one rank's counted costs, against the
    H100's constants.  The kernel-adjusted terms equal the plain ones (the
    counter's kernel bytes are already analytic)."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes", 0.0))
    coll_dev = float(sum(coll.values()))
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    counted_global = flops_dev * n_chips
    fraction = (mf / n_chips / PEAK_FLOPS) / max(max(terms.values()), 1e-30)
    return {
        "attn_xla_bytes_per_device": None,
        "memory_s_kernel_adj": memory_s,
        "roofline_fraction_kernel_adj": fraction,
        **terms,
        "dominant": dominant,
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collective_breakdown": coll,
        "model_flops": mf,
        "useful_compute_ratio": (mf / counted_global) if counted_global
        else None,
        "bound_time_s": max(terms.values()),
        "roofline_fraction": fraction,
    }


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules_name: str = "baseline",
             microbatches: Optional[int] = None,
             gather_once: bool = False,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             mesh=None) -> Dict[str, Any]:
    """One cell's JSON.  ``cfg``, ``shape`` and ``mesh`` replace the named
    configuration, shape and production mesh (small cells in tests)."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    ok, reason = applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "rules": rules_name, "status": "skipped", "reason": reason,
    }
    if not ok:
        return result

    if mesh is None:
        mesh = production_mesh(multi_pod)
    else:
        result["mesh"] = "x".join(str(s) for s in
                                  sh.mesh_shape(mesh).values())
    rules = RULE_SETS[rules_name]
    t0 = time.time()
    fn, args, extra = build_cell(cfg, shape, mesh, rules=rules,
                                 microbatches=microbatches,
                                 gather_once=gather_once)
    t_build = time.time() - t0
    t0 = time.time()
    with OpCost() as counter:
        fn(*args)
    t_count = time.time() - t0
    cost = counter.summary()
    coll = {k: cost["collectives"].get(k, 0.0) for k in COLLECTIVES}
    n_chips = sh.mesh_size(mesh)
    held = extra.pop("argument_bytes")
    gathered = extra.pop("gathered_bytes")
    result.update({
        "status": "ok",
        "n_chips": n_chips,
        "build_s": round(t_build, 2),
        "count_s": round(t_count, 2),
        "memory_analysis": {
            "argument_bytes": held,
            "gathered_bytes": gathered,
            "held_bytes": held + gathered,
            "fits_80gb": held + gathered <= HBM_BYTES,
            "temp_bytes": None,
            "note": "no temporaries counted (XLA's memory_analysis has no "
                    "counterpart in eager PyTorch)",
        },
        "cost_analysis": {"flops": cost["flops"], "bytes": cost["bytes"]},
        "counter": {k: cost[k] for k in
                    ("flops_by_class", "kernel_calls", "ops")},
        "roofline": roofline(cost, coll, n_chips, cfg, shape),
        **extra,
    })
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="baseline", choices=sorted(RULE_SETS))
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--gather-once", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in sorted(CONFIGS):
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    results = []
    for arch, shape in cells:
        print(f"=== {arch} x {shape} mesh="
              f"{'2x16x16' if args.multi_pod else '16x16'} "
              f"rules={args.rules} ===", flush=True)
        try:
            r = run_cell(arch, shape, multi_pod=args.multi_pod,
                         rules_name=args.rules,
                         microbatches=args.microbatches,
                         gather_once=args.gather_once)
        except Exception as e:
            r = {"arch": arch, "shape": shape, "status": "error",
                 "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(r, indent=2, default=str), flush=True)
        results.append(r)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=str)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\n[dryrun] ok={n_ok} skipped={n_skip} errors={n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
