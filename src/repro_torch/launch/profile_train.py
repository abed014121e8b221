"""Where a training step's time goes on the card: ``torch.profiler`` over
the forward, backward and optimizer parts of an AdamW step of the paper
LM, or of another configuration the port trains.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch h1d-lm-53m] [--batch 8] [--seq 1024] [--sp N] [--out PATH]
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch gemma3-4b --layers 6 --batch 1 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch qwen2-moe-a2.7b --layers 4 --batch 1 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch mamba2-1.3b --layers 8 --batch 1 --seq 4096

The encoder-decoder (``seamless-m4t-medium``) trains on ``--batch``
clips of ``--seq`` seeded stub frames (every frame live) and
``DECODER_LEN`` (1024) ``ZipfLM`` target tokens; ``--layers`` cuts its
encoder and decoder alike, its cross-attention is a group ``xattn`` of
its own, and its tokens per second count frames and target tokens:

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch seamless-m4t-medium --batch 1 --seq 4096

A configuration runs in its published dtype (gemma3-4b, llama3.2-1b:
bfloat16), or in ``--dtype``'s (``--dtype float32`` as the port ran
gemma3-4b before bfloat16); ``--layers N`` cuts its depth to N layers
(gemma3-4b: the first N of its 5:1 local:global cadence), for this
profiler only.  The step's peak device memory is reported beside its
times.

Seeded random weights and ``ZipfLM`` tokens.  The method is
``profile_serve``'s: for each part, the host wall time per call (ending
in a synchronize, measured without the profiler), the summed device time
of the kernels it ran (measured under it), the busy share (device time
over wall time; one stream, so kernels do not overlap) and the device
time by group: matrix products, this package's band kernels of the
forward and of the backward, a MoE layer's routing, dispatch, combine
and expert products (``moe``: the kernels of its profiler range, and of
the backward of its ops where their forward ran in the same part, so
the ``step`` part holds the whole of it and the ``backward`` part only
the remat recompute), a Mamba2 layer's SSD core (``ssd``, the same
way), the encoder-decoder's cross-attention (``xattn``, the same way)
and the rest (eager elementwise ops, reductions,
copies).  The parts are the loss (forward), the gradient of
a fresh forward's loss (backward), and the optimizer's in-place update,
then the whole ``make_train_step`` step (each call updates the same
state again).  ``--sp N`` runs every part inside
``sp_scope`` of an ``N``-way one-axis mesh on the card, as ``train(...,
mesh=)`` does: each attention call splits its sequence into ``N``
shards, so the band kernels' groups count one launch a shard and the
halo exchange, edge terms and row merges land in "other".  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import exact_products, resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.seamless_m4t_medium import DECODER_LEN
from repro_torch.data import ZipfLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.profile_serve import profiled
from repro_torch.models import get_model
from repro_torch.models.encdec import stub_frames
from repro_torch.parallel.sp_attention import sp_scope
from repro_torch.train import (TrainConfig, batch_to_device, init_state,
                               make_optimizer, make_train_step)
from repro_torch.tree import tree_leaves, tree_unflatten_like


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h1d-lm-53m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp", type=int, default=1,
                    help="shards of a sequence-parallel mesh (1: none)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="weights (default: the config's)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    mesh = make_mesh((args.sp,), ("data",), device=dev)
    exact_products()
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype=args.dtype or cfg.dtype)
    encdec = cfg.family == "encdec"
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers, **(
            {"encoder_layers": args.layers} if encdec else {}))
    tc = TrainConfig(peak_lr=3e-4, warmup=5, ckpt_every=0)
    state = init_state(cfg, tc, seed=args.seed, device=dev)
    fns = get_model(cfg)
    opt = make_optimizer(tc)
    tokens = DECODER_LEN if encdec else args.seq
    batch = ZipfLM(vocab_size=cfg.vocab_size, seq_len=tokens,
                   batch_per_host=args.batch, seed=args.seed).batch(0)
    if encdec:
        batch["frames"], batch["frame_weight"] = stub_frames(
            cfg, args.batch, args.seq, seed=args.seed)
        tokens += args.seq
    batch = batch_to_device(batch, dev)
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(state.params)]
    params = tree_unflatten_like(state.params, leaves)
    graphs = []

    def loss():
        with sp_scope(mesh):
            return fns.loss(params, cfg, batch)[0]

    def forward():          # the graph is built, then freed with the loss
        loss()

    def backward():
        torch.autograd.grad(graphs.pop(), leaves)

    grads = tree_unflatten_like(
        state.params, list(torch.autograd.grad(loss(), leaves)))

    def optimizer():        # in place, as the step runs it
        opt.update_(grads, state.opt_state, state.params)

    step_fn = make_train_step(cfg, tc)

    def step():
        with sp_scope(mesh):
            step_fn(state, batch)

    res = {"device": torch.cuda.get_device_name(dev), "arch": cfg.name,
           "dtype": cfg.dtype, "layers": cfg.num_layers, "remat": cfg.remat,
           "remat_policy": cfg.remat_policy, "batch": args.batch,
           "seq": args.seq, "sp_shards": args.sp,
           **({"encoder_layers": cfg.encoder_layers,
               "target_tokens": DECODER_LEN} if encdec else {})}
    with torch.no_grad():
        optimizer()                                      # warm-up
        res["optimizer"] = profiled(optimizer, args.calls)
    del grads
    forward()                                            # warm-up
    res["forward"] = profiled(forward, args.calls)

    def build():
        graphs.extend(loss() for _ in range(args.calls))
    # each backward call consumes the graph of a forward run beforehand,
    # for the unprofiled and then the profiled calls
    build()
    res["backward"] = profiled(backward, args.calls, between=build)
    step()                                               # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    res["step"] = profiled(step, args.calls)
    res["step_peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    res["tokens_per_s"] = (args.batch * tokens
                           / (res["step"]["wall_ms"] / 1e3))
    text = json.dumps(res)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return res


if __name__ == "__main__":
    main()
