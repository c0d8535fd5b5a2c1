"""End-to-end training entry point — the GPU First "loader".

The host builds the model and its optimizer state on the card and hands
control to the device loop (``core/device_main.py::device_run``): data
comes from the on-device synthetic stream, the step runs on the card, and
the host sees only the loss, through one immediate hook every
``log_every`` steps.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --preset tiny --device cpu

``--preset full`` trains the architecture at its published width and depth
from random weights (seed 0); ``--device cuda`` (the default) needs a card,
``--device cpu`` runs the plain PyTorch versions of the kernels.
Checkpoints (``--ckpt-dir``) come with ``ckpt/``, not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device_main import HostHook, device_run
from repro_torch.core.libc import rand_init
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.step import make_train_step


def tiny_preset(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg.reduced(), name=cfg.name + "-tiny", num_layers=4, d_model=128,
        d_ff=256, vocab_size=512)


def run(arch: str, *, preset: str = "tiny", steps: int = 50, batch: int = 8,
        seq_len: int = 64, lr: float = 1e-3, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0, log_every: int = 10, resume: bool = False,
        mesh=None, rules=None, device="cuda") -> Dict[str, Any]:
    """Train ``arch`` for ``steps`` steps on ``device``, from the random
    weights of ``Model.init(0)``.  Returns the final loss, the logged
    ``(step, loss)`` pairs, the host clock at each log (``log_times``, after
    the device finished the step: the hook waits for it) and the run's
    seconds."""
    if ckpt_dir or ckpt_every or resume:
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP "
                                  "queue 1, item 5: ckpt/checkpoint.py)")
    if mesh is not None or rules is not None:
        raise NotImplementedError("mesh runs are not ported yet (ROADMAP "
                                  "queue 1, item 5: scale-out)")
    cfg = get_config(arch)
    if preset == "tiny":
        cfg = tiny_preset(cfg)
    model = build_model(cfg, device=device)
    data = SyntheticLM(cfg.vocab_size, seq_len, batch)
    values = model.init(0)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                        total_steps=steps)
    opt = adamw_init(values)
    step_fn = make_train_step(model, opt_cfg)

    losses: list = []
    log_times: list = []

    def log_loss(step, loss):
        log_times.append(time.perf_counter())
        losses.append((step, float(loss)))
        print(f"[train] step {step} loss {float(loss):.4f}", flush=True)

    hooks = []
    if log_every:
        hooks.append(HostHook(every=log_every,
                              extract=lambda step, s: {"loss": s["loss"]},
                              host_fn=log_loss))

    def step(i, state):
        rng, batch_d = data.batch_at(state["rng"], i)
        v, o, metrics = step_fn(state["values"], state["opt"], batch_d)
        return {"values": v, "opt": o, "rng": rng, "loss": metrics["loss"]}

    t0 = time.perf_counter()
    state = device_run(
        step,
        {"values": values, "opt": opt, "rng": rand_init(1234,
                                                         device=model.device),
         "loss": torch.zeros((), dtype=torch.float32, device=model.device)},
        steps, hooks=hooks)
    final_loss = float(state["loss"])          # waits for the device
    dt = time.perf_counter() - t0
    return {"final_loss": final_loss, "losses": losses,
            "log_times": [t - t0 for t in log_times], "seconds": dt,
            "steps": steps, "final_step": steps}


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
