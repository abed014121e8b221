"""Where a CTA of a band kernel spends its time, phase by phase.

    PYTHONPATH=src python -m repro_torch.launch.profile_band_phases \
        [--kernel sub_bwd|band_fwd|band_bwd|band_stream_fwd|band_stream_bwd|
                  decode_paged|decode_partial|decode_paged_quant|
                  decode_dense|update_paged_quant|update_dense|
                  update_partial|update_paged] \
        [--csrc DIR] [--out PATH]

Builds a copy of the kernel's source with ``%globaltimer`` stamps taken
by thread 0 of every CTA at its phase boundaries, runs it once and
prints for each phase the mean and 90th percentile over the CTAs that
reached the end, and the quartiles of the CTAs' start times (waves of
resident CTAs show as steps).  A phase's time is the time since the
stamp before it, summed over the loop iterations that pass it; the sums
stay in registers until the last stamp, where thread 0 stores them.

* ``sub_bwd`` (default): #4's ``sub_bwd_kernel`` in
  ``kernels/csrc/h1d_block_bwd.cu`` at the LM path's shapes (64 rows = 8
  sequences x 8 kv heads, G=1, L=1024, d=64, nr=16, every third row
  padded by 200), every sub level: start, key weights read, key block
  copies issued, rows staged, delta, scores, dq, dk/dv, end.
* ``band_fwd``: #1's ``band_fwd_kernel`` (``h1d_block.cu``) and
  ``band_bwd``: #3's ``band_dq_kernel`` and ``band_dkvw_kernel``
  (``h1d_block_bwd.cu``), in ``l0_causal`` at the LM shapes above and in
  ``l0_bidir`` and ``coarse_bidir`` (level 1, L=1024) at the LRA path's
  (64 rows = 8 ListOps-length sequences x 8 heads, L=2048, true lengths
  500..2000).
* ``band_stream_fwd``: #1's streamed ``band_stream_kernel``
  (``h1d_block.cu``) and ``band_stream_bwd``: #3's ``stream_dq_kernel``
  and ``stream_dkvw_kernel`` (``h1d_block_bwd.cu``), at gemma3-4b's local
  layers (``STREAM_SHAPE``: 4 x 2 x 4096, nr 1024, d 256, keys live to
  3000), the backward from the built forward's outputs: the window
  listing, the copies, then per key tile (forward, dQ) or reader chunk
  (dK/dV/dW) the stage wait, the scores, the online softmax or the
  ds step, the a @ v or the ds / a products, and the stores.  Each row
  also carries the built wrapper's event ms.
* ``decode_paged``: #7 (``h1d_decode_attend_paged``) at the paged
  serving shapes of ``chip_smoke.py`` (64 rows = 8 slots x 8 kv heads,
  G=1, Lmax 2048, nr=16, d=64, 1026 pages a level; 6 slots at seeded
  positions, 2 inactive on the TRASH page), and ``decode_partial``: #11
  (``h1d_decode_attend_partial``) on shard 3 of a 4-way split of a
  prefilled 64-row cache at seeded positions.  In ``csrc/h1d_decode.cu``
  that is ``attend_staged_kernel``, step by step on thread 0's path
  (warp 0, key slot 0): t and bidx in hand, the key copies, the table and
  the value copies, setup; per chunk of its warp the wait for the keys,
  the scores, the sync; the max, the wait for the values, the weights,
  the keys of a @ v, the warp's reduction, the sync; the combine.
* ``decode_paged_quant``: #8 (``h1d_decode_attend_paged_quant``) at the
  same shapes on an int8 pool (every level int8, rows quantized per row
  from seeded normals), and ``decode_dense``: #5 (``h1d_decode_attend``)
  on ``chip_smoke.py``'s dense cache (R=64, G=1, Lmax 2048, d=64, nr=16)
  at seeded positions, both stamped in the staged body as above.
* ``update_paged_quant``: #10 (``h1d_update_cache_paged_quant``) on that
  int8 pool with ``chip_smoke.py``'s update tables (private write pages,
  2 inactive slots on TRASH), ``update_cache_quant_kernel``: t and utab
  read and every level's pair copy issued, the pairs staged, the carry
  chain over the levels (pass A), the scales and the block's sync (B),
  thread 0's share of the requantize and stores (C).
* ``update_dense``: #6 (``h1d_update_cache``) on ``chip_smoke.py``'s
  dense cache (R=64, Lmax 2048, d=64, nr=16, 7 levels) at seeded
  positions, then on the one level the SP deep tail updates at d=4 (32
  rows, ``t_deep``), and ``update_partial``: #12
  (``h1d_update_cache_partial``) on shard 3's 6 sharded levels of that
  cache split 4 ways, and ``update_paged``: #9
  (``h1d_update_cache_paged``) on the fp32 pool with
  ``update_paged_quant``'s tables.  ``update_chain_kernel``: t (and
  owned, or the page table) read, every level's pair copy issued, the
  pairs landed, the carry chain with its stores, the carry.  Where a
  phase ends on loaded values, the stamp first waits for them (a compare
  of the values that guards a store to ``g_sink``), so that it marks
  their arrival, not their issue.

``--csrc DIR`` stamps the sources in DIR instead of this package's
(e.g. a variant of the kernel, to compare the two in one call).  The
stamps are inserted at fixed lines of the sources, this tree's; the
script fails if one is not found.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import h1d_decode as hd
from repro_torch.core import hierarchy as hc
from repro_torch.kernels import _build
from repro_torch.kernels import h1d_block as hb
from repro_torch.kernels import h1d_block_bwd as hbb
from repro_torch.kernels import h1d_decode_kernel as dk

MAX_CTAS = 1 << 17

# Per instrumented kernel: its stamp array, its phases (the name of the
# phase that ends at each stamp; stamp 0 is the start) and the anchors
# (text of the source, stamp, where: "after" the text,
# "before" it or at an offset into it, and optionally code run before
# the stamp: a wait for the values the phase ends on).
SUB_BWD = dict(
    name="sub_bwd_kernel", array="g_sub",
    phases=("start", "weights", "keys issued", "rows staged", "delta",
            "scores", "dq", "dk/dv", "end"),
    anchors=[
        ("  int* id_s = row_s + tq;                     // the row's index "
         "in (B,G,Lq)\n", 0, "after"),
        ("    if (w_s[j] > 0.f) flag |= j < half ? 3 : 2;\n", 1, "after"),
        ("nullptr;\n  });\n  const int nd4 = d4 / 4, nv4 = dv4 / 4;\n", 2,
         "after"),
        ("    cp_async_wait();\n    __syncthreads();\n", 3, "after"),
        ("    __syncthreads();                          // y is read: u_s "
         "takes a, ds\n", 4, "after"),
        ("\n    // dq = ds @ k", 5, 1),
        ("\n    // dk += ds^T q", 6, 1),
        ("    __syncthreads();                          // the next tile "
         "reuses the rows\n", 7, "after"),
        ("  if (S > 1) cg::this_cluster().sync();       // peers' P stays "
         "until read\n", 8, "after"),
    ])
BAND_FWD = dict(
    name="band_fwd_kernel", array="g_fwd",
    phases=("start", "weights, live rows", "copies issued", "staged",
            "scores", "y, end"),
    anchors=[
        ("  // the window's key weights first: block info, then the live "
         "rows\n", 0, "before"),
        ("  stage_rows(q_s, qs, rows, d, vec_in & VEC_Q, [&](int r) -> "
         "const float* {\n    return row_s[r] ? q + (row0 + r) * d", 1,
         "before"),
        ("  cp_async_wait();\n  __syncthreads();\n\n  // scores, row max, "
         "a = exp(s - m) and dn per (row pair, lane slot, key\n", 2,
         "before"),
        ("  // scores, row max, a = exp(s - m) and dn per (row pair, lane "
         "slot, key\n", 3, "before"),
        ("  // y = a @ v: RY rows x 4 columns a thread, over each live "
         "band's\n", 4, "before"),
        ("vec_y, acc[rr]);\n  }\n}\n\ntemplate <int MODE, int RY>\nint "
         "launch_ry(", 5, len("vec_y, acc[rr]);\n  }\n")),
    ])
BAND_DQ = dict(
    name="band_dq_kernel", array="g_dq",
    phases=("start", "weights, live rows", "copies issued", "staged",
            "delta", "scores, ties", "dq, end"),
    anchors=[
        ("  int* row_s = blk_s + nwbm;                    // 1: the row is "
         "live\n  const size_t row0 = ((size_t)b * G + g) * Lq + t0;\n", 0,
         "after"),
        ("  auto src = [&](const float* base, int r, int n) -> const float* "
         "{\n    return row_s[r] ? base + (row0 + r) * n", 1, "before"),
        ("  cp_async_wait();\n  __syncthreads();\n\n  // gmh = gm", 2,
         "before"),
        ("\n  // gmh = gm - (gy . y + gdn * dn), two lanes a row\n", 3, 1),
        ("  __syncthreads();                              // y is read: u_s "
         "takes ds\n", 4, "after"),
        ("  // dq = ds @ k: RY rows x 4 columns a thread, over each live "
         "band's\n", 5, "before"),
        ("      store4(dq + (row0 + r0 + rr) * d, c, d, vec_out & VEC_DQ, "
         "acc[rr]);\n  }\n", 6, "after"),
    ])
BAND_DKVW = dict(
    name="band_dkvw_kernel", array="g_kv",
    phases=("start", "weights", "sums zeroed", "chunk: live rows",
            "chunk: staged", "chunk: dk/dv", "writes, end"),
    anchors=[
        ("  int* row_s = blk_s + nkb;                     // 1: reads a live "
         "key here\n", 0, "after"),
        ("  for (int e = tid; e < nk * (d4 + dv4 + 1); e += BAND_THREADS) "
         "P[e] = 0.f;\n", 1, "before"),
        ("  auto info = [&](int J) {", 2, "before"),
        ("      if (!__syncthreads_or(live)) continue;\n", 3, "after"),
        ("      cp_async_wait();\n      __syncthreads();\n", 4, "after"),
        ("      __syncthreads();                          // the next chunk "
         "reuses rows\n", 5, "after"),
        ("    dw[kb + t] = P[nk * (d4 + dv4) + t / nr * nk4 + t % nr];\n", 6,
         "after"),
    ])
ATTEND_STAGED = dict(
    name="attend_staged_kernel", array="g_att",
    phases=("start", "t used", "key copies", "table, value copies",
            "setup sync", "S: chunk, wait keys", "S: keys", "S: sync",
            "V: max", "V: chunk, wait values", "V: weights", "V: keys",
            "V: reduce, store", "V: sync", "combine, end"),
    anchors=[
        ("  // the live bands, their staged rows and chunks; resident and "
         "bulk:\n", 0, "before"),
        ("      const int cnt = tru ? min(nr, ceil_to(tru, p.quantum)) : 0;\n",
         1, "after"),
        ("                  cnt * D * ES, bar + b);\n", 2, "after"),
        ("                  cnt * Dv * ES, bar + nb + b);\n", 3, "after"),
        ("  __syncthreads();\n  // setup done\n", 4, "after"),
        ("      mbar_wait(bar + s, parity_of(c));\n      const float* kb = "
         "ring + (size_t)s * p.slot;\n", 5, "after"),
        ("      if constexpr (GC == 1) {\n        const float m = "
         "warp_max(mx[0]);", 6, "before"),
        ("  __syncthreads();\n  // scores done\n", 7, "after"),
        ("      for (int cv0 = 0; cv0 < ncv_v; cv0 += VL) {      // "
         "warp-uniform\n", 8, "before"),
        ("          mbar_wait(bar + s, parity_of(nch + c));\n          const "
         "float* vs = ring + (size_t)s * p.slot;\n", 9, "after"),
        ("            const int jn = min(32, ch.n - jb);\n", 10, "before"),
        ("            else values(std::false_type{});\n", 11, "after"),
        ("#pragma unroll\n      for (int i = 0; i < GC; ++i) {\n        "
         "const float d = warp_sum(dn[i]);", 12, "before"),
        ("  __syncthreads();\n  // output partials done\n", 13, "after"),
        ("      for (int e = 0; e < VW; ++e) acc.x[e] /= fmaxf(den, 1e-9f);\n"
         "      acc.store(dst);\n    }\n  }\n", 14, "after"),
    ])
# #10 with every level's pairs staged before the chain, in three passes
UPDATE_QUANT = dict(
    name="update_cache_quant_kernel", array="g_upd",
    phases=("start", "t, utab; pairs issued", "pairs staged",
            "A: carry chain", "B: scales, sync", "C: requantize, end"),
    anchors=[
        ("  const bool is_k = warp % 2 == 0;\n", 0, "before"),
        ('    asm volatile("cp.async.wait_all;" ::: "memory");\n'
         "    __syncwarp();\n", 1, "before"),
        ('    asm volatile("cp.async.wait_all;" ::: "memory");\n'
         "    __syncwarp();\n", 2, "after"),
        ("    __syncwarp();\n\n    // B: lane l", 3, "before"),
        ("  // C: this part's int8 levels requantized", 4, "before"),
        ("    l = ln;\n  }\n}\n", 5, len("    l = ln;\n  }\n")),
    ])
# #6 / #12 / #9: every level's pair staged before the carry chain
UPDATE_CHAIN = dict(
    name="update_chain_kernel", array="g_upd",
    phases=("start", "t (utab) read", "pairs issued", "pairs landed",
            "chain and stores", "carry, end"),
    anchors=[
        ("  const int t = tpos[r];\n  const bool own = ADDR != ADDR_LOCAL",
         0, "before"),
        ("  // first row of level l's pair in the k (is_k) or v array", 1,
         "before", "if ((t ^ (int)own) == -7) g_sink = 1;\n"),
        ("      stage_elem(pr + (2 * l + 1) * T + tid, p + W);\n    }\n", 2,
         "after"),
        ('    asm volatile("cp.async.wait_all;" ::: "memory");\n    float '
         "x0 = pr[tid]", 3,
         len('    asm volatile("cp.async.wait_all;" ::: "memory");\n')),
        ("      x0 = y0;\n      x1 = y1;\n    }\n", 4, "after",
         "if (carry == 1.5e-38f) g_sink = 1;\n"),
        ("    if (ADDR == ADDR_LOCAL)\n      (is_k ? carry_k : carry_v)"
         "[(size_t)r * W + col] = to_elem<E>(carry);\n  }\n", 5, "after"),
    ])
# The streamed l0_causal bodies: #1's band_stream_kernel, #3's
# stream_dq_kernel and stream_dkvw_kernel.
STREAM_FWD = dict(
    name="band_stream_kernel", array="g_sfwd",
    phases=("start", "window listed", "copies issued", "tile: keys wait",
            "tile: scores", "tile: online softmax", "tile: values wait",
            "tile: apply", "store, end"),
    anchors=[
        ("  // list the window's key tiles that hold a key with w > 0, in "
         "order\n", 0, "before"),
        ("  const int nlive = *nlive_s;\n", 1, "after"),
        ("    stage_keys(0);\n  }\n  cp_async_commit();\n", 2, "after"),
        ("    cp_async_wait();                            // keys of tile n\n"
         "    __syncthreads();                            // a @ v of n - 1 "
         "is done\n", 3, "after"),
        ("16 * qs, d4,\n                      sc);\n", 4, "after",
         "if (sc[3][3] == 1.5e-38f) g_sink = 1;\n"),
        ("    cp_async_wait();                            // values of tile "
         "n\n", 5, "before"),
        ("    __syncthreads();                            // a and rescales "
         "written\n", 6, "after"),
        ("        for (int c = 0; c < 8; ++c) acc[rr][c] += part[rr][c];\n"
         "    }\n  }\n\n#pragma unroll\n  for (int rr = 0; rr < RY; ++rr) {"
         "\n    const int r = lt.row0", 7,
         len("        for (int c = 0; c < 8; ++c) acc[rr][c] += "
             "part[rr][c];\n    }\n"),
         "if (acc[RY - 1][7] == 1.5e-38f) g_sink = 1;\n"),
        ("        m[row0 + row] = m_r[r];\n      }\n    }\n  }\n", 8,
         "after"),
    ])
STREAM_DQ = dict(
    name="stream_dq_kernel", array="g_sdq",
    phases=("start", "window listed", "rows staged, gmh", "tile: stage wait",
            "tile: scores", "tile: ds, ties", "tile: ds @ k", "dq stored",
            "tie term, end"),
    anchors=[
        ("  // list the window's key tiles that hold a key with w > 0, in "
         "order\n", 0, "before"),
        ("  const int nlive = *nlive_s;\n", 1, "after"),
        ("  // scores: warps 0-3 score s = q . k, warps 4-7 da = gy . v, each "
         "on\n  // the rows 16", 2, "before"),
        ("    cp_async_wait();                            // keys and values "
         "of n\n    __syncthreads();\n", 3, "after"),
        ("    __syncthreads();                            // s and da "
         "written\n", 4, "after"),
        ("    __syncthreads();                            // ds written\n", 5,
         "after"),
        ("    __syncthreads();                            // the keys are "
         "read\n", 6, "after"),
        ("  __syncthreads();                              // dq stored, "
         "counts in\n", 7, "after"),
        ("      if (lane + 32 * e < d) out[lane + 32 * e] += gmn_r * ts[e];\n"
         "  }\n", 8, "after"),
    ])
STREAM_DKVW = dict(
    name="stream_dkvw_kernel", array="g_skv",
    phases=("start", "weights, keys issued", "chunk: stage wait",
            "chunk: scores", "chunk: a, ds", "chunk: dk/dv/dw", "store, end"),
    anchors=[
        ("  float* w_s = ds_s + TK * ps;                  // TK\n", 0,
         "after"),
        ("  // reader rows k0 .. rhi - 1 of every group, in chunks of TR\n",
         1, "before"),
        ("    cp_async_wait();                            // chunk n (and k, "
         "v)\n    __syncthreads();\n", 2, "after"),
        ("    __syncthreads();                            // s and da, "
         "key-major\n", 3, "after"),
        ("    __syncthreads();                            // a and ds "
         "written\n", 4, "after"),
        ("    __syncthreads();                            // the chunk is "
         "read\n", 5, "after"),
        ("  if (tid < keys) dw[kb + tid] = accw;\n", 6, "after"),
    ])
TARGETS = {"sub_bwd": ("h1d_block_bwd", [SUB_BWD]),
           "band_fwd": ("h1d_block", [BAND_FWD]),
           "band_bwd": ("h1d_block_bwd", [BAND_DQ, BAND_DKVW]),
           "decode_paged": ("h1d_decode", [ATTEND_STAGED]),
           "decode_partial": ("h1d_decode", [ATTEND_STAGED]),
           "decode_paged_quant": ("h1d_decode", [ATTEND_STAGED]),
           "decode_dense": ("h1d_decode", [ATTEND_STAGED]),
           "update_paged_quant": ("h1d_decode", [UPDATE_QUANT]),
           "update_dense": ("h1d_decode", [UPDATE_CHAIN]),
           "update_partial": ("h1d_decode", [UPDATE_CHAIN]),
           "update_paged": ("h1d_decode", [UPDATE_CHAIN]),
           "band_stream_fwd": ("h1d_block", [STREAM_FWD]),
           "band_stream_bwd": ("h1d_block_bwd", [STREAM_DQ, STREAM_DKVW])}
SIGNATURES = {"h1d_block": hb._SIGNATURES, "h1d_block_bwd": hbb._SIGNATURES,
              "h1d_decode": dk._SIGNATURES}


def _stamp(spec, k: int) -> str:
    """Stamp k: every thread adds the time since its last stamp to a
    register; at the last stamp thread 0 stores its start and its sums
    (one store each, so the stamps add no memory round trip to the
    chain they measure)."""
    n = len(spec["phases"])
    if k == 0:
        return ("unsigned long long ph_last = now_ns(), ph_t0 = ph_last, "
                f"ph_acc[{n}] = {{}};\n")
    out = ("{ const unsigned long long ph_t = now_ns(); "
           f"ph_acc[{k}] += ph_t - ph_last; ph_last = ph_t; }}\n")
    if k == n - 1:
        slot = f"{spec['array']}[blockIdx.y * gridDim.x + blockIdx.x]"
        out += (f"if (threadIdx.x == 0) {{ {slot}[0] = ph_t0; "
                + "".join(f"{slot}[{i}] = ph_acc[{i}]; " for i in range(1, n))
                + "}\n")
    return out


def instrumented_source(src: str, specs) -> str:
    head = ("__device__ __forceinline__ unsigned long long now_ns() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n__device__ int g_sink;\n")
    for spec in specs:
        head += (f"__device__ unsigned long long {spec['array']}"
                 f"[{MAX_CTAS}][{len(spec['phases'])}];\n")
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    for spec in specs:
        for line, k, where, *wait in spec["anchors"]:
            if src.count(line) != 1:
                raise RuntimeError(f"{spec['name']}: anchor for stamp {k} "
                                   f"found {src.count(line)} times: "
                                   f"{line!r}")
            at = {"before": 0, "after": len(line)}.get(where, where)
            new = line[:at] + "".join(wait) + _stamp(spec, k) + line[at:]
            src = src.replace(line, new, 1)
    tail = ""
    for i, spec in enumerate(specs):
        arr, n = spec["array"], len(spec["phases"])
        tail += (f'\nextern "C" int read_stamps{i}(void* dst, int ctas) {{\n'
                 f'  return (int)cudaMemcpyFromSymbol(dst, {arr}, '
                 f'(size_t)ctas * {n} * 8);\n}}\n'
                 f'extern "C" int clear_stamps{i}() {{\n'
                 f'  void* p;\n'
                 f'  cudaError_t e = cudaGetSymbolAddress(&p, {arr});\n'
                 f'  return (int)(e ? e : cudaMemset(p, 0, sizeof({arr})));'
                 f'\n}}\n')
    return src + tail


def build(kernel: str, csrc: Path):
    """The instrumented library of ``kernel`` built from the sources in
    ``csrc``, and the specs it was stamped with."""
    stem, specs = TARGETS[kernel]
    src = (csrc / f"{stem}.cu").read_text()
    out = _build.BUILD_DIR / f"phases_{kernel}"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{stem}.cu").write_text(instrumented_source(src, specs))
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    lib_path = out / f"{stem}_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out / f"{stem}.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in SIGNATURES[stem].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    for i in range(len(specs)):
        getattr(lib, f"read_stamps{i}").argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int]
        getattr(lib, f"read_stamps{i}").restype = ctypes.c_int
        getattr(lib, f"clear_stamps{i}").restype = ctypes.c_int
    return lib, specs


def summarize(spec, stamps, label):
    """Per-phase mean and p90 over the CTAs that reached the end."""
    done = stamps[:, 0] > 0          # the start is stored at the end
    t = stamps[done].astype(np.int64)
    row = {"kernel": spec["name"], "case": label, "ctas": len(stamps),
           "ctas_live": int(done.sum()), "phases": {}}
    if not done.any():
        return row
    t0 = t[:, 0].min()
    row["span_us"] = float((t[:, 0] + t[:, 1:].sum(1)).max() - t0) / 1e3
    for a in range(1, len(spec["phases"])):
        us = t[:, a] / 1e3
        row["phases"][spec["phases"][a]] = dict(
            mean_us=float(us.mean()), p90_us=float(np.percentile(us, 90)))
    row["start_quartiles_us"] = [
        float(x) for x in np.percentile((t[:, 0] - t0) / 1e3,
                                        [0, 25, 50, 75, 100])]
    print(f"{spec['name']} {label}: {row['ctas_live']} of {row['ctas']} "
          f"CTAs reach the end; span {row['span_us']:.1f} us; start "
          f"quartiles {np.round(row['start_quartiles_us'], 1).tolist()} us")
    for name, p in row["phases"].items():
        print(f"  {name:22s} mean {p['mean_us']:6.2f} us  p90 "
              f"{p['p90_us']:6.2f} us")
    return row


def _lm_inputs(dev, gen):
    B, G, L, D = 64, 1, 1024, 64
    q = torch.randn(B, G, L, D, generator=gen, device=dev) / D ** 0.5
    k = torch.randn(B, L, D, generator=gen, device=dev)
    w = torch.ones(B, L, device=dev)
    w[::3, L - 200:] = 0.0
    v = torch.randn(B, L, D, generator=gen, device=dev) * w[..., None]
    return q, k, v, w


def _lra_inputs(dev, gen):
    B, G, L, D = 64, 1, 2048, 64
    lens = torch.randint(500, 2001, (B // 8,), generator=gen, device=dev)
    w = (torch.arange(L, device=dev)[None]
         < lens.repeat_interleave(8)[:, None]).float()
    q = torch.randn(B, G, L, D, generator=gen, device=dev) / D ** 0.5
    k = torch.randn(B, L, D, generator=gen, device=dev)
    v = torch.randn(B, L, D, generator=gen, device=dev) * w[..., None]
    return q, k, v, w


def _run(lib, specs, launch, label, ctas):
    """Warm, clear, run once, read every spec's stamps."""
    launch()
    torch.cuda.synchronize()
    for i in range(len(specs)):
        _build.check(getattr(lib, f"clear_stamps{i}")(), "clear_stamps")
    launch()
    torch.cuda.synchronize()
    rows = []
    for i, spec in enumerate(specs):
        st = np.zeros((ctas[i], len(spec["phases"])), dtype=np.uint64)
        _build.check(getattr(lib, f"read_stamps{i}")(st.ctypes.data,
                                                     ctas[i]), "read_stamps")
        rows.append(summarize(spec, st, label))
    return rows


def profile_sub_bwd(lib, dev, gen):
    NR = 16
    q, k, v, w = _lm_inputs(dev, gen)
    B, G, L, D = q.shape
    rows = []
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

        def launch():
            _build.check(lib.h1d_band_sub_bwd(
                *[t.data_ptr() for t in ins + grads], B, G, L, Lk, D, D, NR,
                ratio, 0, _build.stream()), "h1d_band_sub_bwd (instrumented)")
        rows += _run(lib, [SUB_BWD], launch, f"ratio {ratio}", [ctas])
    return rows


def _band_cases(dev, gen):
    """(mode, label, (q, k, v, w)) of the band kernels' profiled calls."""
    cases = [("l0_causal", "LM l0_causal L=1024", _lm_inputs(dev, gen))]
    q, k, v, w = _lra_inputs(dev, gen)
    cases.append(("l0_bidir", "LRA l0_bidir L=2048", (q, k, v, w)))
    kc, _ = hc.coarsen_weighted_mean(k, w)
    qc, _ = hc.coarsen_weighted_mean(q, w)
    vc = hc.coarsen_sum(v, axis=-2)
    wc = hc.coarsen_sum(w, axis=-1)
    cases.append(("coarse_bidir", "LRA coarse_bidir level 1 L=1024",
                  tuple(t.contiguous() for t in (qc, kc, vc, wc))))
    return cases


def profile_band(lib, dev, gen, backward):
    NR = 16
    rows = []
    for mode, label, args in _band_cases(dev, gen):
        q, k, v, w = args
        B, G, L, D = q.shape
        code = hb._MODE_CODES[mode]
        out = hb.band_attention_fwd_ref(q, k, v, w, nr=NR, mode=mode)
        tq = hb.band_fwd_tq(mode, B, G, L, D, D, NR, backward=backward)
        ctas = [G * -(-L // tq) * B]
        if not backward:
            def launch():
                _build.check(lib.h1d_band_fwd(
                    *[t.data_ptr() for t in (*args, *out)], B, G, L, D, D,
                    NR, code, 0, _build.stream()),
                    "h1d_band_fwd (instrumented)")
            rows += _run(lib, [BAND_FWD], launch, label, ctas)
            continue
        nkb, _ = hb.band_dkvw_tiles(mode, B, L, D, D, NR)
        ctas.append(-(-(L // NR) // nkb) * B)
        cot = [torch.randn(t.shape, generator=gen, device=dev) for t in out]
        grads = (torch.empty_like(q), torch.empty(B, G, L, device=dev),
                 torch.empty_like(k), torch.empty_like(v),
                 torch.empty_like(w),
                 torch.empty(B, G, L, 2 * hb.band_row_slots(mode, NR),
                             device=dev))

        def launch():
            _build.check(lib.h1d_band_bwd(
                *[t.data_ptr() for t in (*args, *out, *cot, *grads)], B, G,
                L, D, D, NR, code, None, _build.stream()),
                "h1d_band_bwd (instrumented)")
        rows += _run(lib, [BAND_DQ, BAND_DKVW], launch, label, ctas)
    return rows


#: (B, G, L, nr, d, keys with w > 0): gemma3-4b's local layers at a
#: 4096-token prefill of a 3000-token prompt (chip_smoke.STREAM_CASES[0])
STREAM_SHAPE = (4, 2, 4096, 1024, 256, 3000)


def _event_ms(fn, reps: int = 10) -> float:
    """Median ms of ``fn`` between CUDA events, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profile_stream(lib, specs, dev, gen, backward, time_wrapper=True):
    """#1's streamed body (``band_stream_fwd``) or #3's streamed backward
    (``band_stream_bwd``: the dQ pass and the dK/dV/dW pass) at
    ``STREAM_SHAPE``; the backward from the built forward's outputs (its
    m, so s == m finds the forward's maxima) and seeded cotangents.  Each
    row carries the uninstrumented wrapper's event ms beside the
    stamps (``time_wrapper``: the sources stamped are this tree's)."""
    B, G, L, nr, D, live = STREAM_SHAPE
    q = torch.randn(B, G, L, D, generator=gen, device=dev) / D ** 0.5
    k = torch.randn(B, L, D, generator=gen, device=dev)
    w = torch.ones(B, L, device=dev)
    w[:, live:] = 0.0
    v = torch.randn(B, L, D, generator=gen, device=dev) * w[..., None]
    label = f"gemma local {B}x{G}x{L} nr={nr} d={D} live {live}"
    out = hb.band_attention_fwd(q, k, v, w, nr=nr)
    tq = hb.STREAM_TQ
    if not backward:
        ctas = [G * -(-L // tq) * B]
        res = [torch.empty_like(t) for t in out]

        def launch():
            _build.check(lib.h1d_band_fwd_stream(
                *[t.data_ptr() for t in (q, k, v, w, *res)], B, G, L, D, D,
                nr, _build.stream()), "h1d_band_fwd_stream (instrumented)")
        rows = _run(lib, specs, launch, label, ctas)

        def call():
            return hb.band_attention_fwd(q, k, v, w, nr=nr)
    else:
        ctas = [G * -(-L // tq) * B, -(-L // hb.STREAM_KV_TK) * B]
        cot = [torch.randn(t.shape, generator=gen, device=dev) for t in out]
        args = (q, k, v, w, *out, *cot)
        grads = (torch.empty_like(q), torch.empty(B, G, L, device=dev),
                 torch.empty_like(k), torch.empty_like(v),
                 torch.empty_like(w))

        def launch():
            _build.check(lib.h1d_band_bwd_stream(
                *[t.data_ptr() for t in (*args, *grads)], B, G, L, D, D, nr,
                _build.stream()), "h1d_band_bwd_stream (instrumented)")
        rows = _run(lib, specs, launch, label, ctas)

        def call():
            return hbb.band_attention_bwd(*args, nr=nr)
    if time_wrapper:
        ms = _event_ms(call)
        print(f"{label}: built wrapper {ms:.3f} ms a call (CUDA events)")
        for r in rows:
            r["wrapper_event_ms"] = ms
    return rows


def profile_decode(lib, specs, dev, gen, kernel):
    """One call of #7, #11, #8, #5, #10 or #9 (``kernel`` as ``--kernel``)
    through its wrapper, with the instrumented library in place of the
    built one."""
    from repro_torch.core import quantization as qz
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    R, G, Lmax, D, NR, HKV, PAGES, TRASH = 64, 1, 2048, 64, 16, 8, 1024, 1
    M = hc.num_levels(Lmax, NR)
    q = torch.randn((R, G, D), generator=gen, device=dev)
    rng = np.random.default_rng(100)
    if kernel == "decode_partial":
        dense = hd.prefill_cache(
            torch.randn((R, Lmax, D), generator=gen, device=dev),
            torch.randn((R, Lmax, D), generator=gen, device=dev), Lmax, NR)
        sc = sp.shard_cache(dense, make_mesh((4,), ("data",), device=dev),
                            NR)
        t = rng.integers(0, Lmax + 1, R)
        tabs = sp.sp_tables(t, nr=NR, Lmax=Lmax, d=4, device=dev)
        args = (sc.shards[3], q, torch.as_tensor(t, dtype=torch.int32,
                                                 device=dev),
                tabs.bidx[3], tabs.owned[3])
        fn, label = dk.decode_attend_partial, "shard 3 of 4, R=64, Lmax 2048"
    elif kernel == "decode_dense":
        cache = hd.prefill_cache(
            torch.randn((R, Lmax, D), generator=gen, device=dev),
            torch.randn((R, Lmax, D), generator=gen, device=dev), Lmax, NR)
        t = rng.integers(0, Lmax, R)
        t[:4] = [0, NR - 1, NR, Lmax - 1]
        args = (cache, q, torch.as_tensor(t, dtype=torch.int32, device=dev))
        fn, label = dk.decode_attend_fused, "dense, R=64, Lmax 2048"
    else:
        rows = (PAGES + 2) * HKV
        ks = [torch.randn((rows, NR, D), generator=gen, device=dev)
              for _ in range(M)]
        vs = [torch.randn((rows, NR, D), generator=gen, device=dev)
              for _ in range(M)]
        pool = hd.PagedH1DCache(ks[0], vs[0], tuple(ks[1:]), tuple(vs[1:]))
        if kernel.endswith("_quant"):      # every level int8, per-row scales
            qk, qv = zip(*[(qz.quantize_int8(k, axis=-1),
                            qz.quantize_int8(v, axis=-1))
                           for k, v in zip(ks, vs)])
            data = [[x[0] for x in qk], [x[0] for x in qv]]
            sc = [[x[1][..., 0].contiguous() for x in y] for y in (qk, qv)]
            pool = hd.QuantPagedH1DCache(
                data[0][0], data[1][0], tuple(data[0][1:]),
                tuple(data[1][1:]), sc[0][0], sc[1][0], tuple(sc[0][1:]),
                tuple(sc[1][1:]))
        slots = R // HKV
        t = np.zeros(slots, np.int64)
        t[:6] = [0, NR - 1, Lmax - 1, *rng.integers(NR, Lmax - 1, 3)]
        pages = rng.integers(2, PAGES + 2, (slots, 1 + M))
        pages[6:] = TRASH
        upages = np.stack([rng.permutation(PAGES)[:slots] + 2
                           for _ in range(M)], 1)
        upages[6:] = TRASH

        def physical(pg):
            return torch.as_tensor(
                (pg[:, None, :] * HKV + np.arange(HKV)[None, :, None])
                .reshape(R, -1), dtype=torch.int32, device=dev)
        tt = torch.as_tensor(np.repeat(t, HKV), dtype=torch.int32,
                             device=dev)
        args = (pool, q, tt, physical(pages))
        fn, label = {
            "decode_paged": (dk.decode_attend_paged, "paged, R=64, Lmax "
                                                     "2048"),
            "decode_paged_quant": (dk.decode_attend_paged_quant,
                                   "int8 paged, R=64, Lmax 2048")}.get(
            kernel, (None, None))
        if kernel.startswith("update_"):
            kn = torch.randn((R, D), generator=gen, device=dev)
            args = (pool, kn, -kn, tt, physical(upages))
            update, label = {
                "update_paged": (dk.update_cache_paged,
                                 "paged update, R=64, Lmax 2048"),
                "update_paged_quant": (dk.update_cache_paged_quant,
                                       "int8 paged update, R=64, Lmax "
                                       "2048")}[kernel]

            def fn(*a, nr):
                return update(*a)
    with _loaded(lib):
        return _run(lib, specs, lambda: fn(*args, nr=NR), label, [R])


@contextlib.contextmanager
def _loaded(lib):
    """The decode wrappers launch from ``lib`` (the instrumented library)
    in place of the built one."""
    built = _build._LOADED.get("h1d_decode")
    _build._LOADED["h1d_decode"] = lib
    try:
        yield
    finally:
        if built is None:
            del _build._LOADED["h1d_decode"]
        else:
            _build._LOADED["h1d_decode"] = built


def profile_update(lib, specs, dev, gen, kernel):
    """#6 (``update_dense``: a dense 7-level cache, then the SP deep
    tail's one level at d=4) or #12 (``update_partial``: shard 3's
    sharded levels at d=4), one call each through its wrapper with the
    instrumented library; ``chip_smoke.py``'s shapes."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    R, Lmax, D, NR, d = 64, 2048, 64, 16, 4
    dense = hd.prefill_cache(
        torch.randn((R, Lmax, D), generator=gen, device=dev),
        torch.randn((R, Lmax, D), generator=gen, device=dev), Lmax, NR)
    t = np.random.default_rng(100).integers(0, Lmax + 1, R)
    t[:4] = [0, NR - 1, NR, Lmax - 1]
    tt = torch.as_tensor(t, dtype=torch.int32, device=dev)
    kn = torch.randn((R, D), generator=gen, device=dev)
    tabs = sp.sp_tables(t, nr=NR, Lmax=Lmax, d=d, device=dev)
    nsh = sp.sp_sharded_levels(Lmax, NR, d)
    if kernel == "update_dense":
        deep = hd.H1DCache(dense.ck[nsh - 1], dense.cv[nsh - 1],
                           dense.ck[nsh:], dense.cv[nsh:])
        cases = [(f"dense, R={R}, Lmax {Lmax}, {1 + len(dense.ck)} levels",
                  lambda: dk.update_cache_fused(dense, kn, -kn, tt)),
                 (f"SP deep tail at d={d}, {1 + len(deep.ck)} level",
                  lambda: dk.update_cache_fused(deep, kn, -kn, tabs.t_deep))]
    else:
        sh = sp.shard_cache(dense, make_mesh((d,), ("data",), device=dev),
                            NR).shards[d - 1]
        slab = hd.H1DCache(sh.k, sh.v, sh.ck[:nsh - 1], sh.cv[:nsh - 1])
        cases = [(f"shard {d - 1} of {d}, R={R}, {nsh} sharded levels",
                  lambda: dk.update_cache_partial(
                      slab, kn, -kn, tabs.t_loc[d - 1],
                      tabs.upd_owned[d - 1]))]
    rows = []
    with _loaded(lib):
        for label, launch in cases:
            rows += _run(lib, specs, launch, label, [R])
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(TARGETS), default="sub_bwd")
    ap.add_argument("--csrc", type=Path, default=_build.CSRC,
                    help="directory of the kernel sources to stamp")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_band_phases needs a CUDA card")
    lib, specs = build(args.kernel, args.csrc)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {"device": torch.cuda.get_device_name(0), "kernel": args.kernel,
           "csrc": str(args.csrc)}
    if args.kernel == "sub_bwd":
        res["levels"] = profile_sub_bwd(lib, dev, gen)
    elif args.kernel in ("update_dense", "update_partial"):
        res["cases"] = profile_update(lib, specs, dev, gen, args.kernel)
    elif args.kernel.startswith("band_stream"):
        res["cases"] = profile_stream(
            lib, specs, dev, gen, backward=args.kernel.endswith("bwd"),
            time_wrapper=args.csrc.resolve() == _build.CSRC)
    elif args.kernel.startswith(("decode_", "update_")):
        res["cases"] = profile_decode(lib, specs, dev, gen, args.kernel)
    else:
        res["cases"] = profile_band(lib, dev, gen,
                                    backward=args.kernel == "band_bwd")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
