"""Serving CLI: batched greedy generation with the ServeEngine on
seeded random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h1d-lm-53m \
        --requests 8 --slots 4 --new-tokens 16 --max-len 512

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path (use
it with ``--smoke``).  Prompt lengths are drawn from ``--seed`` in
``[--min-prompt, --max-prompt]``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h1d-lm-53m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when no card is present)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    params = get_model(cfg).init(cfg, seed=args.seed, device=dev)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        n = int(rng.integers(args.min_prompt, args.max_prompt + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        reqs.append(Request(uid=i, prompt=prompt,
                            max_new_tokens=args.new_tokens))
        eng.submit(reqs[-1])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[serve] {cfg.name} on {name}: {len(reqs)} requests, {total} "
          f"tokens, {dt:.3f}s ({total / dt:.1f} tok/s)")
    return reqs


if __name__ == "__main__":
    main()
