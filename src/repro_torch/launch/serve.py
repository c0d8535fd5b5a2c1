"""Serving CLI: the paged-KV continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 8 --max-new 12

``--preset full`` (the default) serves the architecture at its published
width and depth with random weights from seed 0; ``--preset tiny``
serves the small preset of ``launch/train.py``.  ``--device cuda`` (the
default) needs a card; ``--device cpu`` runs the plain PyTorch versions of
the kernels.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import tiny_preset
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.engine import ServingEngine


def _serve_traffic(engine: ServingEngine, cfg, requests: int, max_new: int,
                   tag: str) -> None:
    rids = []
    for i in range(requests):
        prompt = [1 + (i * 7 + j) % (cfg.vocab_size - 1)
                  for j in range(4 + i % 5)]
        rids.append(engine.submit(prompt, max_new=max_new))

    t0 = time.perf_counter()
    results = engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in results.values())
    for rid in rids:
        print(f"[{tag}] request {rid}: {results[rid]}")
    print(f"[{tag}] {len(results)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens / dt:.1f} tok/s) on {engine.device}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--preset", choices=("full", "tiny"), default="full")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = tiny_preset(cfg)
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    engine = ServingEngine(model, params, batch_slots=args.batch_slots,
                           max_len=256, page_size=args.page_size,
                           device=args.device)
    _serve_traffic(engine, cfg, args.requests, args.max_new, "serve")


if __name__ == "__main__":
    main()
