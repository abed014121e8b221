"""Where a CTA of the sub-level backward kernel (#4, ``sub_bwd_kernel`` in
``kernels/csrc/h1d_block_bwd.cu``) spends its time, phase by phase.

    PYTHONPATH=src python -m repro_torch.launch.profile_band_phases \
        [--out PATH]

Builds a copy of ``h1d_block_bwd.cu`` with ``%globaltimer`` stamps
written by thread 0 of every CTA at its phase boundaries (start, key
weights read, key block copies issued, rows staged, delta, scores, dq,
dk/dv, end), runs it once at the LM path's shapes (64 rows = 8 sequences
x 8 kv heads, G=1, L=1024, d=64, nr=16, every third row padded by 200)
at every sub level, and prints for each phase the mean and 90th
percentile over the CTAs that reached the end, and the quartiles of the
CTAs' start times (waves of resident CTAs show as steps).  The stamps
are inserted at fixed lines of the source; the script fails if one is
not found.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import numpy as np
import torch

from repro_torch.core import hierarchy as hc
from repro_torch.kernels import _build
from repro_torch.kernels import h1d_block as hb
from repro_torch.kernels import h1d_block_bwd as hbb

PHASES = ("start", "weights", "keys issued", "rows staged", "delta",
          "scores", "dq", "dk/dv", "end")
MAX_CTAS = 1 << 17

# (text of the source, stamp index): the stamp goes before a comment
# line, after any other text
ANCHORS = [
    ("  int* id_s = row_s + tq;                     // the row's index in "
     "(B,G,Lq)\n", 0),
    ("    if (w_s[j] > 0.f) flag |= j < half ? 3 : 2;\n", 1),
    ("  const int nd4 = d4 / 4, nv4 = dv4 / 4;\n", 2),
    ("    cp_async_wait();\n    __syncthreads();\n", 3),
    ("    __syncthreads();                          // y is read: u_s takes "
     "a, ds\n", 4),
    ("    // dq = ds @ k", 5),
    ("    // dk += ds^T q", 6),
    ("    __syncthreads();                          // the next tile reuses "
     "the rows\n", 7),
    ("  if (S > 1) cg::this_cluster().sync();       // peers' P stays until "
     "read\n", 8),
]


def _stamp(k: int) -> str:
    return ("if (threadIdx.x == 0) g_stamp[blockIdx.y * gridDim.x + "
            f"blockIdx.x][{k}] = now_ns();\n")


def instrumented_source() -> str:
    src = (_build.CSRC / "h1d_block_bwd.cu").read_text()
    head = ("__device__ unsigned long long g_stamp[%d][%d];\n"
            "__device__ __forceinline__ unsigned long long now_ns() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %%0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n" % (MAX_CTAS, len(PHASES)))
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    for line, k in ANCHORS:
        if line not in src:
            raise RuntimeError(f"anchor for stamp {k} not found: {line!r}")
        if line.startswith("    // "):       # stamp before a comment line
            src = src.replace(line, _stamp(k) + line, 1)
        else:
            src = src.replace(line, line + _stamp(k), 1)
    return src + ('\nextern "C" int read_stamps(void* dst, int n) {\n'
                  '  return (int)cudaMemcpyFromSymbol(dst, g_stamp, '
                  '(size_t)n * %d * 8);\n}\n'
                  'extern "C" int clear_stamps() {\n'
                  '  void* p;\n'
                  '  cudaError_t e = cudaGetSymbolAddress(&p, g_stamp);\n'
                  '  return (int)(e ? e : cudaMemset(p, 0, sizeof(g_stamp)));'
                  '\n}\n' % len(PHASES))


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "h1d_block_bwd.cu").write_text(instrumented_source())
    shutil.copy(_build.CSRC / "h1d_band.cuh", out / "h1d_band.cuh")
    lib_path = out / "h1d_block_bwd_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out / "h1d_block_bwd.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.h1d_band_sub_bwd.argtypes = hbb._SIGNATURES["h1d_band_sub_bwd"]
    lib.h1d_band_sub_bwd.restype = ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.read_stamps.restype = ctypes.c_int
    lib.clear_stamps.restype = ctypes.c_int
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_band_phases needs a CUDA card")
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, G, L, D, NR = 64, 1, 1024, 64, 16
    q = torch.randn(B, G, L, D, generator=gen, device=dev) / D ** 0.5
    k = torch.randn(B, L, D, generator=gen, device=dev)
    w = torch.ones(B, L, device=dev)
    w[::3, L - 200:] = 0.0
    v = torch.randn(B, L, D, generator=gen, device=dev) * w[..., None]
    res = {"device": torch.cuda.get_device_name(0), "levels": []}
    kc, vc, wc = k, v, w
    for lvl in range(1, hc.num_levels(L, NR)):
        ratio = 1 << lvl
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        fwd = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        out = hb.band_attention_sub_fwd_ref(*fwd, nr=NR, ratio=ratio)
        cot = [torch.randn(t.shape, generator=gen, device=dev) for t in out]
        ins = (*fwd, *out, *cot)
        Lk = L // ratio
        grads = (torch.empty_like(q), torch.empty(B, G, L, device=dev),
                 torch.empty_like(fwd[1]), torch.empty_like(fwd[2]),
                 torch.empty_like(fwd[3]))
        ctas = Lk // NR * hb.sub_bwd_splits(G, NR * ratio) * B
        stamps = np.zeros((ctas, len(PHASES)), dtype=np.uint64)
        for run in range(2):                      # warm, then the one read
            if run:                               # dead CTAs stamp no end
                torch.cuda.synchronize()
                _build.check(lib.clear_stamps(), "clear_stamps")
            _build.check(lib.h1d_band_sub_bwd(
                *[t.data_ptr() for t in ins + grads], B, G, L, Lk, D, D, NR,
                ratio, _build.stream()), "h1d_band_sub_bwd (instrumented)")
        torch.cuda.synchronize()
        _build.check(lib.read_stamps(stamps.ctypes.data, ctas), "read_stamps")
        done = stamps[:, -1] > 0
        t = stamps[done].astype(np.int64)
        t0 = t[:, 0].min()
        row = {"ratio": ratio, "ctas": ctas, "ctas_live": int(done.sum()),
               "span_us": float(t[:, -1].max() - t0) / 1e3, "phases": {}}
        for a in range(1, len(PHASES)):
            us = (t[:, a] - t[:, a - 1]) / 1e3
            row["phases"][f"{PHASES[a - 1]} -> {PHASES[a]}"] = dict(
                mean_us=float(us.mean()), p90_us=float(np.percentile(us, 90)))
        row["start_quartiles_us"] = [
            float(x) for x in np.percentile((t[:, 0] - t0) / 1e3,
                                            [0, 25, 50, 75, 100])]
        res["levels"].append(row)
        print(f"ratio {ratio}: {row['ctas_live']} of {ctas} CTAs reach the "
              f"end; span {row['span_us']:.1f} us; start quartiles "
              f"{np.round(row['start_quartiles_us'], 1).tolist()} us")
        for name, p in row["phases"].items():
            print(f"  {name:26s} mean {p['mean_us']:6.2f} us  p90 "
                  f"{p['p90_us']:6.2f} us")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
