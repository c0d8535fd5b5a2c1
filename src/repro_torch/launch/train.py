"""End-to-end training entry point — the GPU First "loader".

The host builds the model and its optimizer state on the card and hands
control to the device loop (``core/device_main.py::device_run``): data
comes from the on-device synthetic stream, the step runs on the card, and
the host sees the loss through one immediate hook every ``log_every``
steps and the checkpoints through another every ``ckpt_every`` steps
(``ckpt/checkpoint.py``: the save is an RPC from inside the loop).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --preset tiny --device cpu --steps 30 --ckpt-dir /tmp/ckpt \
      --ckpt-every 10

Resume after a failure (from the newest manifest): the same with
``--resume``.  ``--preset full`` trains the architecture at its published
width and depth from random weights (seed 0); ``--device cuda`` (the
default) needs a card, ``--device cpu`` runs the plain PyTorch versions of
the kernels.

As in the JAX package, a resumed run labels its periodic saves with its
own step count (a run resumed at step 12 writes the state after step 18
as ``manifest-6`` when ``ckpt_every`` is 6) and its last save with the
global step; its data continue at the global step.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                        read_manifest, restore_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import from_jax_layout, to_jax_layout
from repro_torch.core.device_main import HostHook, device_run
from repro_torch.core.libc import rand_init
from repro_torch.core.rpc import ShapeDtype
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.collectives import barrier, team_index
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.step import MeshPlan, make_train_step
from repro_torch.tree import flatten_with_paths, tree_map


def tiny_preset(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg.reduced(), name=cfg.name + "-tiny", num_layers=4, d_model=128,
        d_ff=256, vocab_size=512)


def _restore(ckpt_dir: str, values, opt, device, plan=None):
    """``(step, values, opt)`` from the newest manifest in ``ckpt_dir``,
    written in the port's layout or in the JAX package's (its trainer's
    checkpoints).  With a :class:`~repro_torch.train.step.MeshPlan`
    ``values`` and ``opt`` are ShapeDtype trees of the full state and the
    result is this rank's blocks (the port's layout read block by block
    through ``shardings=``)."""
    def spec(t):
        return ShapeDtype(t.shape, t.dtype) if isinstance(t, torch.Tensor) \
            else t

    like = {"values": tree_map(spec, values), "opt": tree_map(spec, opt)}
    _, manifest = read_manifest(ckpt_dir)
    jax_layout = not set(flatten_with_paths(like)) <= set(manifest["entries"])
    shardings = None
    if jax_layout:
        if plan is not None:
            raise ValueError(
                f"{ckpt_dir} holds the JAX package's stacked layout: resume "
                "it without a mesh (a save then writes the port's layout, "
                "which restores onto any mesh)")
        like = to_jax_layout(like)
    elif plan is not None:
        shardings = {"values": plan.value_shardings(),
                     "opt": plan.opt_shardings()}
    step, restored = restore_checkpoint(ckpt_dir, like, shardings=shardings,
                                        device=device)
    if jax_layout:
        restored = from_jax_layout(restored)
    return step, restored["values"], restored["opt"]


def run(arch: str, *, preset: str = "tiny", steps: int = 50, batch: int = 8,
        seq_len: int = 64, lr: float = 1e-3, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0, log_every: int = 10, resume: bool = False,
        mesh=None, rules=None, device="cuda", keep_state: bool = False,
        total_steps: Optional[int] = None) -> Dict[str, Any]:
    """Train ``arch`` for ``steps`` steps on ``device``, from the random
    weights of ``Model.init(0)`` or, with ``resume``, from the newest
    checkpoint in ``ckpt_dir``; with ``ckpt_every`` it saves
    ``{"values", "opt"}`` there every ``ckpt_every`` steps from inside the
    device loop, and after the loop at ``final_step``.  The learning-rate
    schedule spans ``total_steps`` (``steps`` by default, as JAX's; a run
    resumed in parts gives every part the whole run's).  Returns the final
    loss, the logged ``(step, loss)`` pairs, the host clock at each log
    (``log_times``, after the device finished the step: the hook waits for
    it), the run's seconds, ``start_step`` and ``final_step``, the
    restore's seconds (``restore_s``), the saves' ``(step, writer
    seconds, bytes)`` (``ckpt_writes``), the checkpoint hook's ``(step,
    host seconds)`` (``ckpt_hook_s``) and, with ``keep_state``, the final
    ``{"values", "opt", "rng", "loss"}`` (``state``; by default the run
    lets go of it, which at full width is most of the card).

    ``mesh`` (a ``DeviceMesh`` over the world, every rank calling ``run``)
    and ``rules`` (logical-axis rules over JAX's defaults) train sharded
    (``train/step.py``): each rank initialises, or restores with
    ``shardings=``, only its blocks of the state, draws the same global
    batches and trains its share of each; the loop is one
    ``device_run(mesh=)``, so its loss hook stages records on the
    sharded queue, which the first rank drains after the loop (the logged
    losses, global, appear there alone; ``final_loss`` is global on every
    rank).  A save is no hook there: the step gathers the state and the
    first rank queues its write at once (``CheckpointManager.
    mesh_save``), so the files of a run cut short are there up to its
    last save."""
    cfg = get_config(arch)
    if preset == "tiny":
        cfg = tiny_preset(cfg)
    model = build_model(cfg, device=device)
    data = SyntheticLM(cfg.vocab_size, seq_len, batch)
    total = steps if total_steps is None else total_steps
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(total // 10, 1),
                        total_steps=total)
    with ShardingCtx(mesh, rules):
        plan = MeshPlan.build(model, mesh, rules) if mesh is not None \
            else None
        step_fn = make_train_step(model, opt_cfg, plan=plan)
        resuming = bool(resume and ckpt_dir and
                        latest_step(ckpt_dir) is not None)
        start_step, restore_s = 0, 0.0
        if resuming:
            t0 = time.perf_counter()
            if plan is None:
                values = model.init(0)
                opt = adamw_init(values)
            else:
                values, opt = plan.specs, plan.opt_specs()
            start_step, values, opt = _restore(ckpt_dir, values, opt,
                                               model.device, plan)
            restore_s = time.perf_counter() - t0
            print(f"[train] resumed from step {start_step}")
        elif plan is None:
            values = model.init(0)
            opt = adamw_init(values)
        else:
            values = plan.block_values(model.init(0))
            opt = plan.init_opt(values)
        out = _loop(model, data, step_fn, values, opt, steps, start_step,
                    ckpt_dir, ckpt_every, log_every, mesh, plan)
    out["restore_s"] = restore_s
    if not keep_state:
        del out["state"]
    return out


def _loop(model, data, step_fn, values, opt, steps, start_step, ckpt_dir,
          ckpt_every, log_every, mesh, plan) -> Dict[str, Any]:
    """:func:`run`'s device loop, its hooks and its last save."""
    first = plan is None or team_index(mesh) == 0

    def full_state(tree):
        if plan is None:
            return tree
        return plan.gather_state(tree["values"], tree["opt"])

    def payload(step, s):
        return {"values": s["values"], "opt": s["opt"]}

    mgr = CheckpointManager(ckpt_dir) if (ckpt_dir and ckpt_every) else None
    hooks, queue = [], {}
    if mgr is not None and plan is None:
        hooks.append(mgr.host_hook(ckpt_every, payload))
    losses: list = []
    log_times: list = []

    def log_loss(step, loss):
        log_times.append(time.perf_counter())
        losses.append((step, float(loss)))
        print(f"[train] step {step} loss {float(loss):.4f}", flush=True)

    if log_every:
        # the loss is global: the first team alone stages it under a mesh
        hooks.append(HostHook(
            every=log_every,
            extract=lambda step, s: {"loss": s["loss"]} if first else None,
            host_fn=log_loss))
    if plan is not None and log_every:
        # a record a logged step, one 0-d float word each
        logs = steps // log_every + 8
        queue.update(queue_capacity=max(1024, logs),
                     queue_payload=max(4096, logs))

    def step(i, state):
        rng, batch_d = data.batch_at(state["rng"], i + start_step)
        v, o, metrics = step_fn(state["values"], state["opt"], batch_d)
        if plan is not None and mgr is not None and \
                (i + 1) % ckpt_every == 0:
            mgr.mesh_save(i + 1, {"values": v, "opt": o}, full_state, first)
        return {"values": v, "opt": o, "rng": rng, "loss": metrics["loss"]}

    t0 = time.perf_counter()
    # under a mesh the state is this rank's blocks: device_run's default
    # P() hands the region what this rank passes and returns what it made
    try:
        state = device_run(
            step,
            {"values": values, "opt": opt,
             "rng": rand_init(1234, device=model.device),
             "loss": torch.zeros((), dtype=torch.float32,
                                 device=model.device)},
            steps, hooks=hooks, mesh=mesh, **queue)
        final_loss = float(state["loss"])      # waits for the device
    except BaseException:
        if mgr is not None:
            # a run that fails keeps the saves it made: finish their writes
            mgr.wait()
            mgr.close()
        raise
    dt = time.perf_counter() - t0
    if mgr is not None:
        last = full_state({"values": state["values"], "opt": state["opt"]})
        if first:
            mgr.submit(start_step + steps, last)
        del last
        mgr.wait()
        mgr.close()
        if mesh is not None:
            barrier(mesh=mesh)              # the files are there for all
        if mgr.errors:
            raise RuntimeError(f"a checkpoint save failed: "
                               f"{mgr.errors[0]!r}") from mgr.errors[0]
    return {"final_loss": final_loss, "losses": losses,
            "log_times": [t - t0 for t in log_times], "seconds": dt,
            "steps": steps, "start_step": start_step,
            "final_step": start_step + steps,
            "ckpt_writes": list(mgr.writes) if mgr is not None else [],
            "ckpt_hook_s": list(mgr.hook_s) if mgr is not None else [],
            "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.arch, preset=args.preset, steps=args.steps,
              batch=args.batch, seq_len=args.seq_len, lr=args.lr,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              log_every=args.log_every, resume=args.resume,
              device=args.device)
    print(f"[train] done: final_loss={out['final_loss']:.4f} "
          f"({out['steps']} steps in {out['seconds']:.1f}s)")


if __name__ == "__main__":
    main()
