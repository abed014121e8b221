"""Where a serving step's time goes on the card: ``torch.profiler`` over
one batched prefill and a run of decode steps of the paper LM (or of
another ported config, such as ``gemma3-4b``).

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch h1d-lm-53m] [--rows 8] [--prompt 1024] [--max-len 2048] \
        [--paged [--cache-dtype int8]] [--sp-data N] [--dtype float32] \
        [--layers N]

Seeded random weights and tokens, in the config's published dtype
(``--dtype`` overrides it: ``--dtype float32`` profiles a bfloat16 config
such as ``gemma3-4b`` in float32, as the port ran it before bfloat16).
``--paged`` also profiles a paged
decode tick over the same prompts (a dense-equivalent page pool filled
from the prefill; ``--cache-dtype int8`` quantizes every level): the
tick's host work (``prepare_tick``, page copies, ``build_tables`` and
the one table copy to the card) and its decode step, reported beside
the dense step as ``paged_decode_step``.  ``--sp-data N`` also profiles
a sequence-parallel decode tick: the prefilled caches split into ``N``
shards on the card, each call building the tick's shard geometry on the
host (one copy to the card) and running the decode step inside
``sp_scope``, reported as ``sp_decode_step``.  For each phase it
prints, per call, the host wall time (ending in a synchronize, measured
without the profiler), the summed device time of the kernels it ran
(measured under it), the device busy share (device time over wall time;
one stream, so kernels do not overlap) and the device time by kernel,
grouped into this package's kernels, matrix products and the rest; a
mixture-of-experts layer's routing, dispatch, combine and expert
products (every kernel launched inside its ``moe`` profiler range, and
by the backward of the ops run there) form a group ``moe`` of their own,
and a Mamba2 layer's SSD core (``mamba2-1.3b``, ``zamba2-1.2b``: its
``ssd`` range) a group ``ssd``.
``--layers N`` cuts the config's depth to N layers (``qwen2-moe-a2.7b``'s
24 take ~8 minutes to draw on the host).  The encoder-decoder
(``seamless-m4t-medium``, whose ``--layers`` cuts the encoder and the
decoder alike) prefills ``--rows`` clips of ``--frames`` seeded stub
frames (the encoder, then the decoder over a ``--prompt``-token target
prefix) and decodes from there; its cross-attention (``xattn``: the
encoder memory's projection, the queries' and the dense attention) is a
group of its own:

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch seamless-m4t-medium --rows 4 --frames 4096 --prompt 8 \
        --max-len 1024

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import exact_products, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import hierarchy as hc
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_model
from repro_torch.models.encdec import XATTN_RANGE, stub_frames
from repro_torch.models.ssm import SSD_RANGE
from repro_torch.parallel import sp_attention as sp
from repro_torch.serve import paged_cache as pc

# the sub-level kernels (sub_fwd_kernel, sub_bwd_kernel) also run #1 / #3
# in coarse_causal; the other band modes are band_*_kernel<mode>.  #7, #11,
# #8 and #5 run attend_staged_kernel<ADDR, VW, E> (ADDR 1, 2, 3 and 4), and
# #9, #12 and #6 update_chain_kernel<ADDR, E> (ADDR 1, 2 and 4), E the
# cache element (float or __nv_bfloat16).  The first key contained in a
# kernel's name wins.
OWN = {"band_stream_kernel": "band_attention_fwd[l0_causal_stream]",
       "stream_dq_kernel": "band_attention_bwd[l0_causal_stream]",
       "stream_dkvw_kernel": "band_attention_bwd[l0_causal_stream]",
       "sub_fwd_kernel<": "band_attention_sub_fwd",
       "band_fwd_kernel<": "band_attention_fwd",
       "sub_bwd_kernel<": "band_attention_sub_bwd",
       "band_dq_kernel<": "band_attention_bwd",
       "band_dkvw_kernel<": "band_attention_bwd",
       "attend_staged_kernel<1,": "decode_attend_paged",
       "attend_staged_kernel<3,": "decode_attend_paged_quant",
       "attend_staged_kernel<2,": "decode_attend_partial",
       "attend_staged_kernel<4,": "decode_attend_fused",
       "update_chain_kernel<4,": "update_cache_fused",
       "update_chain_kernel<2,": "update_cache_partial",
       "update_chain_kernel<1,": "update_cache_paged",
       "update_cache_quant_kernel": "update_cache_paged_quant"}


def _group(name: str) -> str:
    compact = name.replace(" ", "")
    for key, label in OWN.items():
        if key in compact:
            return label
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"     # nvjet: cuBLAS's bf16 tensor-core kernels
    return "other"


#: the profiler range (``record_function``) of a MoE layer's routed part
#: (``models.ffn.moe_apply``), whose kernels, and those of its ops'
#: backward, form a group of this name
MOE_RANGE = "moe"
#: the profiler ranges whose kernels form a group of their own: the
#: MoE's, the SSD core's (``models.ssm.SSD_RANGE``) and the
#: encoder-decoder's cross-attention (``models.encdec.XATTN_RANGE``)
RANGES = (MOE_RANGE, SSD_RANGE, XATTN_RANGE)


def range_device_us(events, name: str):
    """Device microseconds of the kernels the range ``name`` owns, by the
    group :func:`_group` would file them under: every kernel launched by
    an op inside the range, and by the backward of such an op (autograd
    runs a backward node under the sequence number of the forward op that
    made it).  ``events``: the profiler's ``FunctionEvent``s
    (``prof.events()``)."""
    out = defaultdict(float)
    owned, seen = set(), set()

    def walk(evt):
        if id(evt) in seen:
            return
        seen.add(id(evt))
        for k in evt.kernels:
            out[_group(k.name)] += k.duration
        if evt.sequence_nr >= 0:
            owned.add(evt.sequence_nr)
        for child in evt.cpu_children:
            walk(child)

    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    for evt in cpu:
        if evt.name == name:
            walk(evt)
    for evt in cpu:
        if (evt.name.startswith("autograd::engine::evaluate_function")
                and evt.sequence_nr in owned):
            walk(evt)
    return out


def _wall_ms(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def profiled(fn, calls: int, between=None):
    """Per-call numbers of ``fn``: the wall time of ``calls`` calls run
    without the profiler (its tracing slows the host), then the device
    time of ``calls`` more under it; ``between()``, where given, runs
    between the two, timed by neither."""
    wall_ms = _wall_ms(fn, calls)
    if between is not None:
        between()
    # CPU activity too: a range's ops, and the kernels they launch, come
    # from the CPU side of the trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = _wall_ms(fn, calls)
    by_group = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if (us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key in RANGES):  # a range's span on the stream
            continue
        by_group[_group(evt.key)] += us / calls / 1e3
        kernels.append((us / calls / 1e3, evt.count // calls, evt.key[:90]))
    device_ms = sum(by_group.values())
    events = prof.events()
    for name in RANGES:
        for group, us in range_device_us(events, name).items():
            by_group[group] -= us / calls / 1e3
            by_group[name] += us / calls / 1e3
    kernels.sort(reverse=True)
    return {"wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms,
            "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else 0.0,
            "device_ms_by_group": dict(sorted(by_group.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "launches": n, "name": k}
                            for ms, n, k in kernels[:12]]}


def paged_tick(params, cfg, fns, tokens, args, dev):
    """A paged decode tick over the prompts in ``tokens``: one slot per
    row in a dense-equivalent pool filled from a fresh prefill; each call
    prepares the write pages, applies their copies, builds and copies the
    tables and runs the decode step."""
    rows, Hkv = tokens.shape[0], cfg.num_kv_heads
    pool = pc.PagePool(
        slots=rows, max_len=args.max_len, nr=cfg.nr,
        pool_pages=rows * (hc.padded_length(args.max_len, cfg.nr) // cfg.nr),
        quant_levels=-1 if args.cache_dtype == "int8" else 0)
    caches = pc.init_paged_caches(cfg, pool, device=dev)
    with torch.inference_mode():
        logits, dense, pos = fns.prefill(params, cfg, {"tokens": tokens},
                                         args.max_len)
        host = tokens.cpu().numpy().astype(np.int32)
        writes = [(s, pool.admit(s, host[s])) for s in range(rows)]
        pc.scatter_prefill(caches, dense, writes, Hkv, cfg.nr)
    del dense
    state = {"tok": logits.argmax(-1), "pos": pos}
    pos_host = np.full((rows,), tokens.shape[1], np.int64)
    active = np.ones((rows,), bool)

    @torch.inference_mode()
    def tick():
        copies = {}
        for s in range(rows):
            pool.prepare_tick(s, int(pos_host[s]), copies)
        pc.apply_copies(caches, copies, Hkv)
        tabs = pc.tables_to_device(*pool.build_tables(pos_host, active, Hkv),
                                   dev)
        lg, _ = fns.decode_step(params, cfg, caches, state["tok"],
                                state["pos"], page_tables=tabs)
        state["tok"] = lg.argmax(-1)
        state["pos"] = state["pos"] + 1
        pos_host[:] += 1

    tick()                                              # warm-up
    return tick


def sp_tick(params, cfg, fns, tokens, args, dev):
    """A sequence-parallel decode tick over the prompts in ``tokens``:
    one slot per row, the prefilled caches split into ``--sp-data``
    shards; each call builds the tick's shard geometry on the host and
    copies it to the card once, then runs the decode step in the SP
    scope."""
    mesh = make_mesh((args.sp_data,), ("data",), device=dev)
    Lmax = hc.padded_length(args.max_len, cfg.nr)
    with torch.inference_mode():
        logits, dense, pos = fns.prefill(params, cfg, {"tokens": tokens},
                                         args.max_len)
        caches = [sp.shard_cache(c, mesh, cfg.nr) for c in dense]
    del dense
    state = {"tok": logits.argmax(-1), "pos": pos}
    pos_host = np.full((tokens.shape[0],), tokens.shape[1], np.int64)

    @torch.inference_mode()
    def tick():
        tabs = sp.sp_tables(np.repeat(pos_host, cfg.num_kv_heads),
                            nr=cfg.nr, Lmax=Lmax, d=args.sp_data, device=dev)
        with sp.sp_scope(mesh):
            lg, _ = fns.decode_step(params, cfg, caches, state["tok"],
                                    state["pos"], sp_tables=tabs)
        state["tok"] = lg.argmax(-1)
        state["pos"] = state["pos"] + 1
        pos_host[:] += 1

    tick()                                              # warm-up
    return tick


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h1d-lm-53m")
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--decode-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="also profile a paged decode tick")
    ap.add_argument("--cache-dtype", default="fp32", choices=["fp32", "int8"],
                    help="page storage of the --paged pool")
    ap.add_argument("--sp-data", type=int, default=1,
                    help="also profile a sequence-parallel decode tick over "
                         "N shards")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="weights and caches (default: the config's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--frames", type=int, default=4096,
                    help="encoder-decoder: stub frames per clip")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    exact_products()
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype=args.dtype or cfg.dtype)
    encdec = cfg.family == "encdec"
    if encdec and (args.paged or args.sp_data > 1):
        ap.error("the encoder-decoder decodes on dense caches only")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers, **(
            {"encoder_layers": args.layers} if encdec else {}))
    fns = get_model(cfg)
    params = fns.init(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (args.rows, args.prompt),
                           generator=gen, device=dev)
    batch = {"tokens": tokens}
    if encdec:
        batch["frames"] = torch.as_tensor(stub_frames(
            cfg, args.rows, args.frames, seed=args.seed)[0], device=dev)
    state = {}

    @torch.inference_mode()
    def prefill():
        state["out"] = fns.prefill(params, cfg, batch, args.max_len)

    prefill()                                           # warm-up
    res = {"device": torch.cuda.get_device_name(dev), "arch": cfg.name,
           "dtype": cfg.dtype, "layers": cfg.num_layers, "rows": args.rows,
           "prompt": args.prompt, "max_len": args.max_len,
           **({"frames": args.frames, "encoder_layers": cfg.encoder_layers}
              if encdec else {})}
    res["prefill"] = profiled(prefill, 3)

    logits, caches, pos = state["out"]
    tok = logits.argmax(-1)

    @torch.inference_mode()
    def decode():
        nonlocal tok, pos
        lg, _ = fns.decode_step(params, cfg, caches, tok, pos)
        tok = lg.argmax(-1)
        pos = pos + 1

    decode()                                            # warm-up
    res["decode_step"] = profiled(decode, args.decode_steps)
    if args.paged:
        res["cache_dtype"] = args.cache_dtype
        res["paged_decode_step"] = profiled(
            paged_tick(params, cfg, fns, tokens, args, dev),
            args.decode_steps)
    if args.sp_data > 1:
        res["sp_data"] = args.sp_data
        res["sp_decode_step"] = profiled(
            sp_tick(params, cfg, fns, tokens, args, dev), args.decode_steps)
    text = json.dumps(res)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return res


if __name__ == "__main__":
    main()
