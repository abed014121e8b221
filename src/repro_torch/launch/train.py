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

Under ``torchrun`` (``python -m torch.distributed.run --nproc-per-node
N``) ``--sp --mesh N`` runs one shard a process (``parallel/group.py``):
every rank draws the same weights and batches, runs its shard of each
attention call and ends each step with the same parameters; rank 0
alone logs and writes checkpoints.  Each rank runs on its own card
(NCCL); ``--device cuda:0`` puts every rank on card 0 (gloo) and
``--device cpu`` on the CPU (gloo).  ``--rank-report PATH`` writes each
rank's losses, launches, collectives and a digest of its parameters
(``launch/ranks.py``):

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --sp --mesh 2 --steps 20 \
        --batch 8 --seq 1024

``--mesh DxM`` trains over a ``DATAxMODEL`` mesh of ``D * M`` ranks,
one shard a process (``parallel/tensor.py``): tensor parallelism over
the M ranks of a model row (column- and row-parallel products, the rank's
heads, a vocabulary split by rows), data parallelism over the D rows
(each takes its rows of the batch, the gradients summed once a step).
Every rank draws the whole tree from ``--seed`` and keeps its shards; a
checkpoint holds whole leaves (global rank 0 writes it) and restores on
any mesh.  Under a model axis larger than 1 only the dense family runs
and ``--sp`` is refused (ROADMAP A.14); ``--mesh Dx1 --sp`` is ``--mesh
D --sp``.  ``--rank-report`` then digests the gathered parameters and
counts the collectives by axis:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --mesh 2x2 --steps 20 --batch 8 \
        --seq 1024

``--arch`` takes every config of
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

from repro_torch import exact_products, kernels, obs, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import HierarchicalLM, ZipfLM
from repro_torch.kernels.tuning import canonical_impl
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import group as grp
from repro_torch.parallel.sharding import unshard_params
from repro_torch.train import TrainConfig, tokens_per_s, train
from repro_torch.train.loop import param_specs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h1d-lm-53m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu; default: cuda (raises when "
                         "no card is present; under torchrun each rank's "
                         "own card)")
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
                    help="DATAxMODEL, e.g. 4x2 (one shard a process under "
                         "torchrun), or N, the sequence shards of --sp")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel attention: shard L over the "
                         "--mesh axis and run the band kernels per shard "
                         "with a halo exchange (needs --mesh N, N > 1)")
    ap.add_argument("--attn-impl", default=None,
                    help="the reference's attention backend string (auto | "
                         "jnp | pallas | pallas_interpret): validated, "
                         "selects nothing (the device does); default: the "
                         "config's")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable repro_torch.obs metrics, train-step spans "
                         "and kernel-launch accounting (implied by "
                         "--trace-out)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON "
                         "(Perfetto-loadable) at exit")
    ap.add_argument("--rank-report", default=None, metavar="PATH",
                    help="under torchrun: each rank writes its losses, "
                         "launches, collectives and parameter digest to "
                         "PATH with {rank} replaced")
    args = ap.parse_args(argv)

    g, joined = ranks.join(args.device)
    try:
        return _train(ap, args, g)
    finally:
        if joined:
            grp.destroy()


def _train(ap, args, g):
    dev = g.device if g is not None else resolve_device(args.device)
    lead = g is None or g.rank == 0
    say = print if lead else (lambda *a, **k: None)
    exact_products()
    if args.telemetry or args.trace_out:
        obs.enable()
    shape = tuple(int(x) for x in args.mesh.split("x"))
    if len(shape) == 2 and args.sp:
        if shape[1] > 1:
            raise NotImplementedError(
                f"--sp with a model axis ({args.mesh}) is not ported: "
                f"sequence parallelism shards the one 'data' axis "
                f"(ROADMAP A.14)")
        shape = shape[:1]
    mesh = make_mesh(shape, ("data", "model")[:len(shape)], device=dev)
    tp = len(shape) == 2
    if not tp and args.sp and mesh.d < 2:
        ap.error("--sp needs --mesh N with N > 1 shards")
    if not tp and mesh.d > 1 and not args.sp:
        ap.error(f"--mesh {args.mesh} shards only the sequence: add --sp")
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    canonical_impl(cfg.attn_impl)     # before any weight is drawn
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
    where = (f"mesh {mesh.D}x{mesh.M} over ('data', 'model')" if tp else
             f"mesh {mesh.d} x '{mesh.axis}'")
    say(f"[train] {cfg.name} on {dev}, {where}"
        f"{' (sp)' if args.sp else ''}"
        f"{f' on {g.world} ranks ({g.backend})' if g is not None else ''}"
        f": batch {args.batch} x seq {args.seq}")
    report = g is not None and args.rank_report
    if report:                 # each collective timed between synchronizations
        kernels.reset_counts()
        grp.STATS.clear()
        grp.STATS.timed = True
    try:
        state, metrics = train(cfg, tc, data, args.steps, device=dev,
                               mesh=mesh if args.sp or tp else None,
                               log=print if lead else (lambda *a: None))
    finally:
        grp.STATS.timed = False
    hist = metrics["history"]
    if report:
        comm, params = ranks.collectives(), state.params
        if tp:      # the whole tree, gathered on every rank after the steps
            params = unshard_params(params, param_specs(cfg, mesh), mesh)
        ranks.write_report(args.rank_report, g, comm=comm, history=hist,
                           params=ranks.digest(params))
    rate = tokens_per_s(hist, args.batch * args.seq)
    say(f"[train] done: {len(hist)} steps"
        + (f", last loss {hist[-1]['loss']:.4f}, first step "
           f"{hist[0]['step_ms']:.1f} ms" if hist else "")
        + (f", {rate:.0f} tokens/s after it" if rate else ""))
    if args.trace_out and lead:
        obs.export.write_trace(args.trace_out)
        say(f"[train] telemetry: trace -> {args.trace_out}")
    return state


if __name__ == "__main__":
    main()
