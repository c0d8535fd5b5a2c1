"""Quickstart on the PyTorch/CUDA port: build an assigned architecture,
train a few device-resident steps, then serve it with the paged-KV engine
(the JAX package's ``quickstart.py``, through ``repro_torch``).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--device`` defaults to ``cuda`` and refuses to run without a card;
``--device cpu`` runs the plain versions of the kernels.
"""
import argparse

from repro_torch.configs import get_config, list_configs
from repro_torch.launch.train import run as train_run
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("assigned architectures:", ", ".join(list_configs()))

    # 1) whole-loop-on-device training (GPU First execution model)
    out = train_run("llama3.2-3b", preset="tiny", steps=20, batch=4,
                    seq_len=32, lr=5e-3, log_every=5, device=args.device)
    print(f"[quickstart] trained 20 steps on {args.device}: "
          f"final_loss={out['final_loss']:.3f}")

    # 2) serving with the balanced-allocator paged KV cache
    cfg = get_config("llama3.2-3b").reduced()
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    engine = ServingEngine(model, params, batch_slots=2, max_len=64,
                           page_size=8, device=args.device)
    r = engine.submit([5, 17, 42], max_new=8)
    results = engine.run_until_drained()
    print(f"[quickstart] served request {r}: {results[r]}")


if __name__ == "__main__":
    main()
