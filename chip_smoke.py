#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, started together;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes of the serving path below, and time both with CUDA events
   around the call (``ms``, wrapper included) and the kernel alone with
   torch.profiler (``device_ms``);
3. serve the paper LM ``h1d-lm-53m`` at full width (seeded random
   weights) with ``ServeEngine(slots=8, max_len=2048)``: 16 requests with
   seeded prompt lengths in 64..1500 and 32 greedy tokens each; every
   kernel must have launched and no plain version may have run;
4. for two served requests, hold the teacher-forced logits of the kernel
   path against the plain path on the card, and the decode path against
   the full forward.

Tolerances.  Attention outputs: |kernel - plain| <= 1e-5 * max(1,
|plain|): both are fp32 with TF32 off and differ only in summation order
(~1e-7 relative), but the unnormalised (y, dn) of a coarse level grow
with 2**l because values and key weights are pairwise sums, so the bound
is relative above magnitude 1.  Cache update: bit-exact (the same fp32
adds and exact halvings in the same order).  Logits: 1e-3 absolute over
six layers and a 32768-way tied head.

Output: a ``{"kernels": [...]}`` line, the card's name and power limit
from nvidia-smi, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a result when no card is present or when the
package is missing beside this file.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores; the kernels run fp32 FMA on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

ATTN_TOL = 1e-5
LOGIT_TOL = 1e-3

# serving path of h1d-lm-53m: 8 prompts x 8 kv-heads, head_dim 64, nr 16
B, G, L, D, NR = 64, 1, 1024, 64, 16
R, LMAX = 64, 2048


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call: the summed time of the kernels it runs,
    from torch.profiler (the wrapper's host work excluded)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / iters / 1e3


def compare(name: str, got, want, tol: float):
    """Max absolute error, and the bound check scaled by max(1, |want|)."""
    worst_abs = worst_scaled = 0.0
    for x, y in zip(got, want):
        assert x.shape == y.shape, (name, x.shape, y.shape)
        assert torch.isfinite(x).all(), f"{name}: non-finite kernel output"
        diff = (x.double() - y.double()).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        scaled = diff / y.double().abs().clamp(min=1.0)
        worst_scaled = max(worst_scaled, float(scaled.max()))
    if worst_scaled > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: scaled error {worst_scaled:.3g} > "
                             f"{tol:g} (max abs {worst_abs:.3g})")
    return worst_abs


def phase_kernels(dev):
    from repro_torch.core import hierarchy as hc
    from repro_torch.core import h1d_decode as hd
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_decode_kernel as dk

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = randn(B, G, L, D) / math.sqrt(D)
    k = randn(B, L, D)
    w = torch.ones((B, L), device=dev)
    w[::3, L - 200:] = 0.0          # right-padded prompts, as in prefill
    v = randn(B, L, D) * w[..., None]
    f4 = 4

    rows = []

    # -- level 0 --------------------------------------------------------
    def pairs(mode, Lk, ratio, wk):
        """(query, key) pairs the band admits on this run's weights."""
        i = torch.arange(L, device=dev)[:, None]
        j = torch.arange(Lk, device=dev)[None, :]
        allow = hb.band_mask(i, j, NR, mode, Lk, ratio)
        return int((allow[None] & (wk > 0)[:, None, :]).sum()) * G

    ker = hb.band_attention_fwd(q, k, v, w, nr=NR)
    ref = hb.band_attention_fwd_ref(q, k, v, w, nr=NR)
    err = compare("band_attention_fwd", ker, ref, ATTN_TOL)
    nbytes = f4 * (q.numel() + k.numel() + v.numel() + w.numel()
                   + B * G * L * (D + 2))
    bms, by = bound(nbytes, pairs("l0_causal", L, 1, w) * (4 * D + 3))
    rows.append(dict(
        name="band_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_block.cu",
        replaces="src/repro/kernels/h1d_block.py:299",
        max_abs_err=err,
        ms=time_ms(lambda: hb.band_attention_fwd(q, k, v, w, nr=NR)),
        device_ms=device_ms(lambda: hb.band_attention_fwd(q, k, v, w,
                                                          nr=NR)),
        plain_ms=time_ms(lambda: hb.band_attention_fwd_ref(q, k, v, w,
                                                           nr=NR)),
        bound_ms=bms, bound_by=by, library_ms=None))
    log(f"band_attention_fwd: max abs err {err:.3g}")

    # -- sub levels 1..M-1 on the coarsened chain, as h1d_attention runs
    M = hc.num_levels(L, NR)
    kc, vc, wc = k, v, w
    sub = dict(err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0, nbytes=0,
               flops=0)
    for lvl in range(1, M):
        ratio = 1 << lvl
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        args = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        ker = hb.band_attention_sub_fwd(*args, nr=NR, ratio=ratio)
        ref = hb.band_attention_sub_fwd_ref(*args, nr=NR, ratio=ratio)
        e = compare(f"band_attention_sub_fwd ratio={ratio}", ker, ref,
                    ATTN_TOL)
        sub["err"] = max(sub["err"], e)
        sub["ms"] += time_ms(lambda: hb.band_attention_sub_fwd(
            *args, nr=NR, ratio=ratio))
        sub["device_ms"] += device_ms(lambda: hb.band_attention_sub_fwd(
            *args, nr=NR, ratio=ratio))
        sub["plain_ms"] += time_ms(lambda: hb.band_attention_sub_fwd_ref(
            *args, nr=NR, ratio=ratio))
        Lk = L // ratio
        sub["flops"] += pairs("sub", Lk, ratio, wc) * (4 * D + 3)
        sub["nbytes"] += f4 * (q.numel() + 2 * B * Lk * D + B * Lk
                               + B * G * L * (D + 2))
        log(f"band_attention_sub_fwd ratio {ratio}: max abs err {e:.3g}")
    bms, by = bound(sub["nbytes"], sub["flops"])
    rows.append(dict(
        name="band_attention_sub_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_block.cu",
        replaces="src/repro/kernels/h1d_block.py:245",
        max_abs_err=sub["err"], ms=sub["ms"], device_ms=sub["device_ms"],
        plain_ms=sub["plain_ms"],
        bound_ms=bms, bound_by=by, library_ms=None,
        note=f"sum over the {M - 1} sub levels (ratio 2..{1 << (M - 1)}) "
             f"of one L={L} prefill"))

    # -- decode attend and update on a filled cache ----------------------
    cache = hd.prefill_cache(randn(R, LMAX, D), randn(R, LMAX, D), LMAX, NR)
    qd = randn(R, G, D)
    t = torch.randint(0, LMAX, (R,), generator=gen, device=dev,
                      dtype=torch.int32)
    t[:4] = torch.tensor([0, NR - 1, NR, LMAX - 1], dtype=torch.int32)
    ker = dk.decode_attend_fused(cache, qd, t, nr=NR)
    ref = dk.decode_attend_ref(cache, qd, t, nr=NR)
    err = compare("decode_attend_fused", [ker], [ref], ATTN_TOL)
    Md = hc.num_levels(LMAX, NR)
    K = (Md + 1) * NR
    nbytes = f4 * (R * K * 2 * D + qd.numel() + R + R * G * D)
    bms, by = bound(nbytes, R * G * K * (4 * D + 4))
    rows.append(dict(
        name="decode_attend_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_decode.cu",
        replaces="src/repro/kernels/h1d_decode_kernel.py:154",
        max_abs_err=err,
        ms=time_ms(lambda: dk.decode_attend_fused(cache, qd, t, nr=NR)),
        device_ms=device_ms(lambda: dk.decode_attend_fused(cache, qd, t,
                                                           nr=NR)),
        plain_ms=time_ms(lambda: dk.decode_attend_ref(cache, qd, t, nr=NR)),
        bound_ms=bms, bound_by=by, library_ms=None))
    log(f"decode_attend_fused: max abs err {err:.3g}")

    kn, vn = randn(R, D), randn(R, D)

    def clone(c):
        return hd.H1DCache(c.k.clone(), c.v.clone(),
                           tuple(a.clone() for a in c.ck),
                           tuple(a.clone() for a in c.cv))
    ck_, cp_ = clone(cache), clone(cache)
    for step in range(3):        # chained writes: later ones read earlier
        tt = (t + step).clamp(max=LMAX - 1)
        dk.update_cache_fused(ck_, kn + step, vn - step, tt)
        dk.update_cache_ref(cp_, kn + step, vn - step, tt)
    for a, b in zip((ck_.k, ck_.v, *ck_.ck, *ck_.cv),
                    (cp_.k, cp_.v, *cp_.ck, *cp_.cv)):
        if not torch.equal(a, b):
            raise AssertionError("update_cache_fused is not bit-exact "
                                 "against update_cache_ref")
    nlev = 1 + len(cache.ck)
    nbytes = f4 * (2 * R * D + R + R * nlev * 2 * 2 * D)
    bms, by = bound(nbytes, R * nlev * 2 * D)
    rows.append(dict(
        name="update_cache_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_decode.cu",
        replaces="src/repro/kernels/h1d_decode_kernel.py:362",
        max_abs_err=0.0,
        ms=time_ms(lambda: dk.update_cache_fused(ck_, kn, vn, t)),
        device_ms=device_ms(lambda: dk.update_cache_fused(ck_, kn, vn, t)),
        plain_ms=time_ms(lambda: dk.update_cache_ref(cp_, kn, vn, t)),
        bound_ms=bms, bound_by=by, library_ms=None))
    log("update_cache_fused: bit-exact over 3 chained updates")
    return rows


@contextlib.contextmanager
def plain_kernels():
    """Route the four kernel call sites to their plain versions (the
    comparison path of phase 4; the port itself has no such switch)."""
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_decode_kernel as dk
    swaps = [(hb, "band_attention_fwd", hb.band_attention_fwd_ref),
             (hb, "band_attention_sub_fwd", hb.band_attention_sub_fwd_ref),
             (dk, "decode_attend_fused", dk.decode_attend_ref),
             (dk, "update_cache_fused", dk.update_cache_ref)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def phase_serve(dev):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("h1d-lm-53m")
    fns = get_model(cfg)
    params = fns.init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 1501, size=16)]

    # warm-up (cuBLAS handles, allocator) on a short request, not counted
    warm = ServeEngine(cfg, params, slots=8, max_len=2048)
    warm.submit(Request(uid=-1, prompt=prompts[0][:64], max_new_tokens=2))
    warm.run()
    del warm

    eng = ServeEngine(cfg, params, slots=8, max_len=2048)
    ticks = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ticks[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    eng.fns = eng.fns._replace(prefill=timed("prefill", eng.fns.prefill),
                               decode_step=timed("decode",
                                                 eng.fns.decode_step))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)

    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: k.launches for n, (k, _) in kernels.KERNELS.items()}
    plain = {n: p.calls for n, (_, p) in kernels.KERNELS.items()}

    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: "
                             f"{missing}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the serving path: "
                             f"{plain}")
    for r in reqs:
        if len(r.out_tokens) != 32 or not all(
                0 <= x < cfg.vocab_size for x in r.out_tokens):
            raise AssertionError(f"request {r.uid}: bad output "
                                 f"{r.out_tokens}")
    ntok = sum(len(r.out_tokens) for r in reqs)
    stats = dict(
        requests=len(reqs), tokens=ntok, wall_s=wall,
        tokens_per_s=ntok / wall,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        prefill_calls=len(ticks["prefill"]),
        prefill_ms_per_call=float(np.mean(ticks["prefill"])),
        decode_ticks=len(ticks["decode"]),
        decode_ms_per_tick=float(np.median(ticks["decode"])),
        launches=counts)
    log(f"serve: {json.dumps(stats)}")
    return cfg, params, fns, reqs, counts


def phase_logits(cfg, params, fns, reqs, dev):
    """Teacher-forced logits, kernel path vs plain path, for 2 requests."""
    worst = 0.0
    for r in reqs[:2]:
        seq = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1],
                                                   np.int32)])
        tok = torch.as_tensor(seq[None], dtype=torch.long, device=dev)
        S = len(r.prompt)

        def run():
            with torch.inference_mode():
                full, _ = fns.forward(params, cfg, tok)
                lg, caches, pos = fns.prefill(params, cfg,
                                              {"tokens": tok[:, :S]}, 2048)
                steps = [lg]
                for i in range(S, tok.shape[1]):
                    lg, caches = fns.decode_step(params, cfg, caches,
                                                 tok[:, i], pos)
                    pos = pos + 1
                    steps.append(lg)
                return full[0, S - 1:], torch.cat(steps)
        full_k, dec_k = run()
        with plain_kernels():
            full_p, dec_p = run()
        for name, a, b in (("forward", full_k, full_p),
                           ("prefill+decode", dec_k, dec_p),
                           ("decode vs forward", dec_k, full_k)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"request {r.uid} {name}: non-finite")
            e = float((a - b).abs().max())
            worst = max(worst, e)
            if e > LOGIT_TOL:
                raise AssertionError(f"request {r.uid} {name}: logits "
                                     f"differ by {e:.3g} > {LOGIT_TOL}")
        # the engine's greedy tokens must be the replay's argmax, up to
        # near-ties inside the logit tolerance (the engine ran batched
        # and bucket-padded shapes, the replay one unpadded row)
        for i, tk in enumerate(r.out_tokens):
            gap = float(dec_k[i].max() - dec_k[i, tk])
            if gap > LOGIT_TOL:
                raise AssertionError(f"request {r.uid} step {i}: engine "
                                     f"token {tk} trails the replay's "
                                     f"argmax by {gap:.3g}")
    log(f"logits: kernel vs plain path max abs diff {worst:.3g} "
        f"(<= {LOGIT_TOL})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN: the plain versions are full fp32")
    dev = torch.device("cuda")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build(_build.sources())
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")

    rows = phase_kernels(dev)
    cfg, params, fns, reqs, counts = phase_serve(dev)
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["kernel_ms"] = row["ms"]
    phase_logits(cfg, params, fns, reqs, dev)

    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
