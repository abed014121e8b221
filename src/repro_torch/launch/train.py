"""Training CLI: a few AdamW steps of the paper LM on a synthetic token
stream, with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h1d-lm-53m \
        --steps 20 --batch 8 --seq 1024

runs ``repro_torch.train.loop.train`` on the CUDA card; ``--device cpu``
runs the plain PyTorch path (use it with ``--smoke``).  Weights are drawn
from ``--seed`` and so is the data (``--data zipf|hier``).  A run with a
checkpoint under ``--ckpt-dir`` resumes from it.

``--sp --mesh N`` trains with sequence parallelism: every step runs
inside ``sp_scope`` of an ``N``-way one-axis mesh (``launch.mesh``), so
each attention call splits its sequence into ``N`` shards on the one
device, runs the band kernels per shard (forward and backward) and
exchanges the shard-boundary blocks:

    PYTHONPATH=src python -m repro_torch.launch.train --sp --mesh 4 \
        --steps 20 --batch 8 --seq 1024

``--mesh`` takes one axis; a ``DATAxMODEL`` shape raises, as
``make_mesh`` does.  ``--arch`` takes every config of
``repro_torch.configs`` at its published dtype (llama3.2-1b, gemma3-4b,
mamba2-1.3b and zamba2-1.2b in bfloat16 with remat; AdamW keeps f32
moments and applies each update in the parameter's dtype); ``--smoke``
trains a config's fp32 smoke config and ``--layers N`` cuts its depth to
N layers.  The encoder-decoder (seamless-m4t-medium) is refused before
any weight is drawn: the data sources make no audio frames (the JAX
package has none either).  ``--telemetry`` turns on ``repro_torch.obs``
(a ``train.step`` span and the ``train.*`` metrics a step, every kernel
launch's accounting); ``--trace-out`` writes its Chrome trace at exit
and implies it.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch import exact_products, obs, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import HierarchicalLM, ZipfLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import TrainConfig, tokens_per_s, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h1d-lm-53m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when no card is present)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", default="none", choices=["none", "int8"])
    ap.add_argument("--data", default="zipf", choices=["zipf", "hier"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1",
                    help="shards of the one 'data' axis, e.g. 4 (a "
                         "DATAxMODEL shape raises)")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel attention: shard L over the "
                         "--mesh axis and run the band kernels per shard "
                         "with a halo exchange (needs --mesh N, N > 1)")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable repro_torch.obs metrics, train-step spans "
                         "and kernel-launch accounting (implied by "
                         "--trace-out)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON "
                         "(Perfetto-loadable) at exit")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    exact_products()
    if args.telemetry or args.trace_out:
        obs.enable()
    shape = tuple(int(x) for x in args.mesh.split("x"))
    mesh = make_mesh(shape, ("data", "model")[:len(shape)], device=dev)
    if args.sp and mesh.d < 2:
        ap.error("--sp needs --mesh N with N > 1 shards")
    if mesh.d > 1 and not args.sp:
        ap.error(f"--mesh {args.mesh} shards only the sequence: add --sp")
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if cfg.family == "encdec":     # refused before any weight is drawn
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder batch needs 'frames', and this "
            f"CLI's data sources (zipf, hier) make tokens only; train "
            f"family='encdec' through train.loop.make_train_step on batches "
            f"with frames")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    tc = TrainConfig(peak_lr=args.lr, total_steps=args.steps,
                     warmup=max(10, args.steps // 20),
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     grad_accum=args.grad_accum,
                     compress_grads=args.compress, seed=args.seed)
    src_cls = ZipfLM if args.data == "zipf" else HierarchicalLM
    data = src_cls(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   batch_per_host=args.batch, seed=args.seed)
    print(f"[train] {cfg.name} on {dev}, mesh {mesh.d} x '{mesh.axis}'"
          f"{' (sp)' if args.sp else ''}: batch {args.batch} x seq "
          f"{args.seq}")
    state, metrics = train(cfg, tc, data, args.steps, device=dev,
                           mesh=mesh if args.sp else None)
    hist = metrics["history"]
    rate = tokens_per_s(hist, args.batch * args.seq)
    print(f"[train] done: {len(hist)} steps"
          + (f", last loss {hist[-1]['loss']:.4f}, first step "
             f"{hist[0]['step_ms']:.1f} ms" if hist else "")
          + (f", {rate:.0f} tokens/s after it" if rate else ""))
    if args.trace_out:
        obs.export.write_trace(args.trace_out)
        print(f"[train] telemetry: trace -> {args.trace_out}")
    return state


if __name__ == "__main__":
    main()
