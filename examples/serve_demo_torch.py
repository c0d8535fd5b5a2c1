"""Continuous-batching serving demo on the PyTorch/CUDA port: mixed-length
requests through the paged-KV engine (balanced-allocator pages), verified
against step-by-step cached decode (the JAX package's ``serve_demo.py``,
through ``repro_torch``).

  PYTHONPATH=src python examples/serve_demo_torch.py [--device cpu]

``--device`` defaults to ``cuda`` and refuses to run without a card;
``--device cpu`` runs the plain versions of the kernels.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9],
           [2, 7, 1, 8], [2, 8, 1, 8], [31, 41, 59]]


def serve(model, params, device):
    """Serve ``PROMPTS`` and hold request 0 to plain cached greedy decode;
    returns ``(request ids, {id: tokens}, seconds)``."""
    engine = ServingEngine(model, params, batch_slots=4, max_len=128,
                           page_size=16, device=device)
    rids = [engine.submit(p, max_new=8 + i % 5)
            for i, p in enumerate(PROMPTS)]

    t0 = time.time()
    results = engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.time() - t0

    # verify one request against plain cached decode
    ref_cache = model.init_cache(1, 128)
    for t in PROMPTS[0][:-1]:
        _, ref_cache = model.decode_step(
            params, ref_cache, torch.tensor([t], device=model.device))
    out, cur = [], PROMPTS[0][-1]
    for _ in range(8):
        lg, ref_cache = model.decode_step(
            params, ref_cache, torch.tensor([cur], device=model.device))
        cur = int(lg[0].argmax())
        out.append(cur)
    assert results[rids[0]] == out, (results[rids[0]], out)
    return rids, results, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("qwen2.5-14b").reduced()
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    rids, results, dt = serve(model, params, args.device)
    total = sum(len(v) for v in results.values())
    for rid in rids:
        print(f"[serve] request {rid}: {results[rid]}")
    print(f"[serve] {len(results)} requests / {total} tokens in {dt:.1f}s "
          f"on {args.device} (verified vs reference decode)")


if __name__ == "__main__":
    main()
