"""Serving CLI: the paged-KV continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 8 --max-new 12

``--preset full`` (the default) serves the architecture at its published
width and depth with random weights from seed 0; an architecture whose
weights exceed the device's memory is refused (phi3.5-moe-42b-a6.6b: 32
layers of bf16 weights, 83.7 GB by its config's parameter count, more
than an 80 GB card holds; the serve CLI has no mesh option, as JAX's
has none).  ``--preset tiny`` serves the small preset of
``launch/train.py``, for any of the engine's families (dense, moe and
vlm: qwen2-vl-2b is served on token prompts, as JAX's engine serves
it).  A family the engine does not serve (ssm, hybrid, encdec) is refused
before its weights are built. ``--device cuda`` (the default) needs a
card; ``--device cpu`` runs the plain PyTorch versions of the kernels.

The durable artifact's round trip (cold start, as JAX's ``launch/serve.py``):

  # process A: build the model, serve, export the step, manifest, weights
  python -m repro_torch.launch.serve --arch llama3.2-3b --preset tiny \
      --device cpu --export-artifact /path/to/art

  # process B (fresh): adopt manifest.json, load serve_step.pt2 and the
  # step-0 weights, serve the same traffic (no model built, no tracing)
  python -m repro_torch.launch.serve --from-artifact /path/to/art \
      --device cpu

``--from-artifact`` reads the architecture and the preset from the
artifact's ``engine.json``; an artifact serves on the device it was
exported on.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import tiny_preset
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.engine import ServingEngine, check_servable


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


def weight_bytes(cfg) -> int:
    """The bytes of ``cfg``'s weights in its parameter dtype."""
    return cfg.num_params() * torch.empty(
        (), dtype=getattr(torch, cfg.param_dtype)).element_size()


def check_fits(cfg, device) -> None:
    """Refuse a model whose weights exceed the memory of ``device`` (the
    card's, or the host's for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.get_device_properties(dev).total_memory
    else:
        have = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    need = weight_bytes(cfg)
    if need > have:
        raise SystemExit(
            f"{cfg.name} at {cfg.num_layers} layers holds {need / 1e9:.1f} "
            f"GB of {cfg.param_dtype} weights, more than the "
            f"{have / 1e9:.1f} GB of one {dev.type} device: it does not fit "
            "one card, and this CLI serves on one device (it has no mesh "
            "option, as the JAX package's has none; use --preset tiny)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--preset", choices=("full", "tiny"), default="full")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--export-artifact", metavar="DIR", default=None,
                    help="after serving, export the decode step, the RPC "
                         "manifest and the weights as a cold-start artifact")
    ap.add_argument("--from-artifact", metavar="DIR", default=None,
                    help="cold start: adopt the artifact's manifest and "
                         "serve its exported step (no model built, nothing "
                         "traced); --arch and --preset come from its "
                         "engine.json")
    args = ap.parse_args(argv)

    if args.from_artifact:
        with open(os.path.join(args.from_artifact, "engine.json")) as f:
            meta = json.load(f)
        cfg = get_config(meta["arch"])
        if meta.get("tiny_preset"):
            cfg = tiny_preset(cfg)
        engine = ServingEngine.from_artifact(args.from_artifact, cfg,
                                             device=args.device)
        print(f"[serve] cold start from {args.from_artifact} "
              f"(arch={meta['arch']}, {engine._step_source} step, no "
              "model built)")
        _serve_traffic(engine, cfg, args.requests, args.max_new, "serve")
        return

    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = tiny_preset(cfg)
    check_servable(cfg)
    model = build_model(cfg, device=args.device)
    check_fits(cfg, args.device)
    params = model.init(0)
    engine = ServingEngine(model, params, batch_slots=args.batch_slots,
                           max_len=256, page_size=args.page_size,
                           device=args.device)
    _serve_traffic(engine, cfg, args.requests, args.max_new, "serve")

    if args.export_artifact:
        engine.export_artifact(
            args.export_artifact,
            extra_meta={"arch": args.arch,
                        "tiny_preset": args.preset == "tiny"})
        print(f"[serve] artifact exported to {args.export_artifact}")


if __name__ == "__main__":
    main()
