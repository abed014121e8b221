"""Serving CLI: batched generation with the ServeEngine on seeded
random weights, greedy or sampled (``--sample``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h1d-lm-53m \
        --requests 8 --slots 4 --new-tokens 16 --max-len 512

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path (use
it with ``--smoke``).  ``--seed`` seeds three things: the weights, the
prompts (lengths drawn in ``[--min-prompt, --max-prompt]``, then their
tokens) and, with ``--sample``, the engine's sampling noise
(``ServeEngine(seed=)``: one stream per request, from the seed and the
request's uid).  ``--causal-mode coarse-q`` serves the model with
coarse-q prefill (unbucketed prompts) and the fine-q decode.
``--paged`` serves from the paged page pool (``--pool-pages``, prefix
sharing, copy on write, swap preemption) and ``--cache-dtype int8``
stores its pages as int8 (``--quant-levels``):

    PYTHONPATH=src python -m repro_torch.launch.serve --paged \
        --cache-dtype int8 --requests 8 --slots 4 --max-len 512

``--arch`` takes every config of ``repro_torch.configs``: the assigned
ones (yi-6b, qwen2.5-14b, llama3.2-1b, gemma3-4b with its 5:1
local:global stack, the MoE and VLM ones, mamba2-1.3b and zamba2-1.2b,
whose prompts are served unpadded and whose SSM states sit one row a
slot) run at their published bfloat16, weights and caches alike;
``--smoke`` runs a config's fp32 smoke config and ``--layers N`` cuts
its depth to N layers.  The encoder-decoder (seamless-m4t-medium) is
refused, as the engine refuses it, before any weight is drawn: its
prefill and decode step (``models/encdec.py``) serve it directly.
``--sp-data N`` splits each layer's cache along its sequence axis into
``N`` shards on the one device and serves through the sequence-parallel
kernels (``parallel/sp_attention.py``):

    PYTHONPATH=src python -m repro_torch.launch.serve --sp-data 4 \
        --requests 16 --slots 8 --new-tokens 32 --max-len 2048 \
        --max-prompt 1500

``--telemetry`` turns on ``repro_torch.obs`` (the engine's metrics and
spans, every kernel launch's accounting); ``--trace-out`` (a Chrome
trace, Perfetto-loadable), ``--prom-out`` (Prometheus text) and
``--metrics-jsonl`` (a snapshot line every ``--metrics-period`` seconds
while serving, and one at the end) write its documents and imply it:

    PYTHONPATH=src python -m repro_torch.launch.serve --telemetry \
        --trace-out trace.json --prom-out metrics.prom
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import exact_products, obs, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import ENCDEC_REFUSAL
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h1d-lm-53m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when no card is present)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the prompts and, with "
                         "--sample, the sampling noise")
    ap.add_argument("--sample", action="store_true",
                    help="sample each token (Gumbel-max over the logits) "
                         "instead of taking the argmax")
    ap.add_argument("--causal-mode", default=None,
                    choices=["fine-q", "coarse-q"],
                    help="override the config's causal_mode")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged hierarchical cache pool "
                         "(prefix sharing, copy on write, preemption) "
                         "instead of one dense cache slab per slot")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="paged pool size in nr-row level-0 pages "
                         "(default: dense-equivalent)")
    ap.add_argument("--cache-dtype", default=None, choices=["fp32", "int8"],
                    help="paged page storage (int8: per-row absmax scales; "
                         "requires --paged)")
    ap.add_argument("--quant-levels", type=int, default=None,
                    help="with --cache-dtype int8: quantize hierarchy "
                         "levels [0, n); -1 = all")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-tick token budget (decode slots + admitted "
                         "prefill chunks)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admit long prompts on a chunk of this many "
                         "tokens and stream the rest through decode")
    ap.add_argument("--lookahead", type=int, default=0,
                    help="admission may skip up to this many queued "
                         "requests that do not fit")
    ap.add_argument("--sp-data", type=int, default=1,
                    help="sequence-parallel degree: split the hierarchical "
                         "KV cache over an N-way 'data' axis and run the "
                         "decode kernels per shard")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable repro_torch.obs metrics, serve-tick spans "
                         "and kernel-launch accounting (implied by "
                         "--trace-out / --prom-out / --metrics-jsonl)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON "
                         "(Perfetto-loadable) at exit")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write a Prometheus text exposition at exit")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="append periodic metrics snapshots as JSON "
                         "lines while serving")
    ap.add_argument("--metrics-period", type=float, default=10.0,
                    help="--metrics-jsonl emission period in seconds")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    exact_products()
    telemetry = bool(args.telemetry or args.trace_out or args.prom_out
                     or args.metrics_jsonl)
    if telemetry:
        obs.enable()
    emitter = (obs.export.JsonlEmitter(args.metrics_jsonl,
                                       args.metrics_period)
               if args.metrics_jsonl else None)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.causal_mode is not None:
        cfg = dataclasses.replace(cfg, causal_mode=args.causal_mode)
    if cfg.family == "encdec":     # refused before any weight is drawn
        raise NotImplementedError(ENCDEC_REFUSAL)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    t_w = time.perf_counter()
    params = get_model(cfg).init(cfg, seed=args.seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, "
          f"{sum(p.numel() for p in tree_leaves(params)) / 1e9:.2f} B "
          f"parameters in {cfg.dtype}, drawn in "
          f"{time.perf_counter() - t_w:.1f}s")
    mesh = (make_mesh((args.sp_data,), ("data",), device=dev)
            if args.sp_data > 1 else None)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                      greedy=not args.sample, seed=args.seed, mesh=mesh,
                      paged=args.paged, pool_pages=args.pool_pages,
                      cache_dtype=args.cache_dtype,
                      quant_levels=args.quant_levels,
                      token_budget=args.token_budget,
                      prefill_chunk=args.prefill_chunk,
                      lookahead=args.lookahead)
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
    if emitter is None:
        eng.run()
    else:
        while eng.queue or eng.active.any():
            eng.step()
            emitter.maybe_emit()
        emitter.emit()       # short runs still get a line at the end
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    note = (f", {args.sp_data} shards" if args.sp_data > 1 else "") + (
        ", sampled" if args.sample else "") + f", {cfg.causal_mode}"
    print(f"[serve] {cfg.name} on {name}{note}: {len(reqs)} requests, "
          f"{total} tokens, {dt:.3f}s ({total / dt:.1f} tok/s)")
    if dev.type == "cuda":
        print(f"[serve] peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    if args.paged:
        st = eng.pool.stats
        print(f"[serve] paged ({eng.cache_dtype}): pages="
              f"{eng.pool.usable(0)} shared={st.shared_maps} "
              f"cow={st.cow_copies} evict={st.evictions} "
              f"preempt={eng.preemptions} hit_rate="
              f"{st.prefix_hit_rate():.3f}")
    if telemetry:
        if args.trace_out:
            obs.export.write_trace(args.trace_out)
            print(f"[serve] telemetry: trace -> {args.trace_out}")
        if args.prom_out:
            obs.export.write_prometheus(args.prom_out)
            print(f"[serve] telemetry: prometheus -> {args.prom_out}")
        c = obs.export.snapshot()["metrics"]["counters"]
        print(f"[serve] telemetry: ticks={c.get('serve.ticks', 0)} "
              f"finished={c.get('serve.finished', 0)}")
    return reqs


if __name__ == "__main__":
    main()
