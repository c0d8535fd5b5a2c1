"""End-to-end training on the PyTorch/CUDA port: a ~125M-parameter
llama-family model trained with the GPU First stack -- the whole loop on
the card, on-device synthetic data, checkpoints and loss logs through host
RPCs from inside the loop, and a kill-and-resume from the newest manifest.

The default settings are the CPU preset (llama3.2-3b's ``tiny_preset``, a
few seconds with ``--device cpu``).  ``--preset full`` trains
``full_100m()`` (d 768, 12 layers, 12 heads over 4 of 64, d_ff 2048, vocab
32000, fp32) on the card:

  PYTHONPATH=src python examples/train_100m_torch.py --device cpu
  PYTHONPATH=src python examples/train_100m_torch.py --preset full \\
      --steps 40 --batch 8 --seq-len 1024
"""
import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch import configs as cfg_registry
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import run


def full_100m() -> ModelConfig:
    base = get_config("llama3.2-3b")
    return dataclasses.replace(
        base, name="llama-100m", num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        head_pad_multiple=1, dtype="float32", param_dtype="float32")


def two_phases(arch, preset, args, ckpt):
    """Phase 1 trains half the steps with checkpoints; phase 2, as a
    process that restarts after a failure would, resumes from the newest
    manifest and trains the rest.  Returns both runs' results (phase 2's
    with its final state, for a caller that goes on from it)."""
    half = args.steps // 2
    common = dict(preset=preset, batch=args.batch, seq_len=args.seq_len,
                  lr=3e-3, ckpt_dir=ckpt, ckpt_every=max(half // 2, 1),
                  log_every=max(half // 4, 1), device=args.device)
    out1 = run(arch, steps=half, **common)
    print(f"[100m] phase 1: loss {out1['final_loss']:.4f}")
    # simulate a node failure: restart from the latest manifest
    out2 = run(arch, steps=args.steps - half, resume=True, keep_state=True,
               **common)
    print(f"[100m] phase 2 (after restart): loss {out2['final_loss']:.4f} "
          f"at step {out2['final_step']}")
    return out1, out2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--preset", default="cpu", choices=["cpu", "full"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="keep the checkpoints here (by default in a "
                         "temporary directory, deleted at the end)")
    args = ap.parse_args(argv)

    if args.preset == "full":
        cfg = full_100m()
        # register it so launch.train can find it
        cfg_registry.CONFIGS[cfg.name] = cfg
        arch, preset = cfg.name, "full"
    else:
        arch, preset = "llama3.2-3b", "tiny"

    if args.ckpt_dir:
        out1, out2 = two_phases(arch, preset, args, args.ckpt_dir)
    else:
        with tempfile.TemporaryDirectory() as ckpt:
            out1, out2 = two_phases(arch, preset, args, ckpt)

    assert np.isfinite(out2["final_loss"])
    assert out2["final_loss"] < out1["final_loss"] + 0.5
    print("[100m] OK: loss descended across a simulated failure/restart")
    return out1, out2


if __name__ == "__main__":
    main()
