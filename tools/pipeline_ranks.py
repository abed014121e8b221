"""``h1d-lm-53m`` through ``pipeline_apply`` one stage a rank, against the
same layers applied in sequence in each rank's own process.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tools/pipeline_ranks.py --device cuda:0 --out 'pipe.{rank}.json'

Rank s holds stage s (``--layers`` / S consecutive layers of the model at
full width, fp32, seeded weights); ``--micro`` microbatches of 1 x
``--seq`` tokens flow through the rank mesh's pipeline
(``parallel/pipeline.py``: the stream all-gathered, a ring ``ppermute``
a tick, a final ``psum``).  Each rank also applies every layer in
sequence to the same microbatches, and writes to ``--out`` ({rank}
replaced): the largest difference of the hidden states, of x's gradient
and of its own stage's gradient leaves (each over the leaf's largest
|sequential|), the band kernels' launches of both runs, and the
pipeline's host ms.  ``--device`` as the CLIs take it: each rank its
own card by default (NCCL), ``cuda:N`` all on card N (gloo).
"""
import argparse
import functools
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import exact_products, kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import group as grp  # noqa: E402
from repro_torch.parallel import pipeline_apply  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    g, joined = ranks.join(args.device)
    if g is None:
        raise SystemExit("run under torchrun: one stage a rank")
    try:
        run(args, g)
    finally:
        if joined:
            grp.destroy()


def run(args, g):
    exact_products()
    dev, S, s = g.device, g.world, g.rank
    cfg = get_config("h1d-lm-53m")
    per = args.layers // S
    if args.layers % S or args.micro % S:
        raise ValueError(f"{args.layers} layers and {args.micro} "
                         f"microbatches over {S} stages")
    params = T.lm_init(cfg, seed=0, device=dev)
    layers = [tree_map(lambda t: t.requires_grad_(True), lp)
              for lp in params["layers"][:args.layers]]
    gen = torch.Generator(device=dev).manual_seed(24)
    tokens = torch.randint(0, cfg.vocab_size, (args.micro, args.seq),
                           generator=gen, device=dev)
    x0 = T._embed_tokens(params, cfg, tokens).detach()[:, None]
    cot = torch.randn(x0.shape, generator=gen, device=dev)
    positions = torch.arange(args.seq, device=dev)[None]

    def layer(lp, h, i):
        return T._block_apply(lp, cfg, h, positions,
                              cfg.layer_uses_global_attn(i))[0]

    def stage_fn(sp, h):
        return functools.reduce(lambda h, j: layer(sp[j], h, j), range(per),
                                h)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def launches():
        return {k: v for k, v in ranks.counts().items()
                if k.split("[")[0] in kernels.TRAIN_KERNELS}

    def once(piped):
        kernels.reset_counts()
        x = x0.clone().requires_grad_(True)
        sync()
        t0 = time.perf_counter()
        if piped:
            stacked = [tree_map(lambda *ls: torch.stack(ls),
                                *[layers[t * per + j] for t in range(S)])
                       for j in range(per)]
            out = pipeline_apply(stage_fn, stacked, x,
                                 mesh=make_mesh((S,), ("stage",)))
        else:
            out = torch.stack([functools.reduce(
                lambda h, i: layer(layers[i], h, i), range(args.layers),
                x[m]) for m in range(args.micro)])
        own = [t for lp in layers[s * per:(s + 1) * per]
               for t in tree_leaves(lp)]
        grads = torch.autograd.grad((out * cot).sum(), [x] + own)
        sync()
        return (out.detach(), grads, launches(),
                (time.perf_counter() - t0) * 1e3)

    once(True)                  # warm-up: the first launches' host setup
    grp.STATS.clear()
    out, grads, counts, ms = once(True)
    comm = dict(grp.STATS.calls)
    seq_out, seq_grads, seq_counts, seq_ms = once(False)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    doc = dict(rank=s, world=S, backend=g.backend, device=str(dev),
               hidden=float((out - seq_out).abs().max()),
               x_grad=rel(grads[0], seq_grads[0]),
               stage_grad=max(rel(a, b) for a, b in zip(grads[1:],
                                                        seq_grads[1:])),
               launches=counts, sequential_launches=seq_counts,
               collectives=comm, ms=ms, sequential_ms=seq_ms)
    path = args.out.replace("{rank}", str(s))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(doc))


if __name__ == "__main__":
    main()
