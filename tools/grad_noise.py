"""fp32 noise of a model's parameter gradient, leaf by leaf: the kernel
path on the card against the plain path on the card, beside the plain
path on the CPU against the same.

    PYTHONPATH=src python tools/grad_noise.py --arch zamba2-1.2b \
        --layers 12 --seq 4096

Draws the config's seed-0 weights (cut to ``--layers``), widens them to
fp32 and takes the ``lm_loss`` gradient of ``ZipfLM(seed=0)``'s first
sequence of ``--seq`` tokens three ways: on the card through the
kernels, on the card through the kernels' plain versions, and on the
CPU (plain).  Prints the losses and, for the ``--top`` leaves with the
largest distance, each distance over the leaf's largest |card plain
gradient|: kernel - plain, CPU - plain and kernel - CPU.  Two plain
paths differ only in their summation orders, so their distance is the
fp32 noise the kernel path's distance is read against.  Needs a CUDA
card; the CPU gradient of 12 zamba2 layers at 4096 tokens takes about a
minute on an 8-core host.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

from repro_torch import exact_products
from repro_torch.configs import get_config
from repro_torch.data import ZipfLM
from repro_torch.models import get_model
from repro_torch.tree import (tree_flatten_with_paths, tree_leaves, tree_map,
                              tree_unflatten_like)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import plain_kernels   # the kernel swap the smoke uses

    exact_products()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    fns = get_model(cfg)
    f32 = dataclasses.replace(cfg, dtype="float32")
    wide = tree_map(lambda p: p.float(), fns.init(cfg, seed=0, device=dev))
    tok = ZipfLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                 batch_per_host=1, seed=0).batch(0)["tokens"][:1]

    def grads(params, device, ctx=contextlib.nullcontext):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        batch = {"tokens": torch.as_tensor(tok, device=device)}
        with ctx():
            loss = fns.loss(tree_unflatten_like(params, leaves), f32,
                            batch)[0]
            g = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [x.cpu() for x in g]

    loss_k, g_k = grads(wide, dev)
    loss_p, g_p = grads(wide, dev, plain_kernels)
    cpu = tree_map(lambda p: p.cpu(), wide)
    del wide
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_c, g_c = grads(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    rows = []
    for (path, _), k, p, c in zip(tree_flatten_with_paths(cpu), g_k, g_p,
                                  g_c):
        top = float(p.abs().max())
        rows.append(dict(leaf=path, largest=top,
                         kernel_plain=float((k - p).abs().max()) / top,
                         cpu_plain=float((c - p).abs().max()) / top,
                         kernel_cpu=float((k - c).abs().max()) / top))
    rows.sort(key=lambda r: -r["kernel_plain"])
    print(json.dumps(dict(device=torch.cuda.get_device_name(dev),
                          arch=cfg.name, layers=cfg.num_layers,
                          seq=args.seq, loss_kernel=loss_k,
                          loss_plain=loss_p, loss_cpu=loss_c,
                          cpu_s=cpu_s)))
    for r in rows[:args.top]:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
