// Banded block attention forward for H-Transformer-1D, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/h1d_block.py:
//   * h1d_band_fwd     <- band_attention_fwd (_fwd_kernel), every band
//     mode: l0_causal, l0_bidir, coarse_bidir, coarse_causal;
//   * h1d_band_sub_fwd <- band_attention_sub_fwd (_fwd_sub_kernel), the
//     fine-q causal level l >= 1 (fine queries x 2^l-coarser keys);
//   * h1d_band_fwd_stream <- band_attention_fwd in l0_causal where the key
//     window is too wide to stage (a sliding window's nr = 1024; its own
//     note is at band_stream_kernel below).
// All return the unnormalised float32 triple (y, dn, m) of one level:
//   s = q.k (q pre-scaled), s -> NEG_INF where band_mask fails or w <= 0,
//   m = max(rowmax s, -1e30), a = exp(s - m), y = a @ v, dn = sum a * w.
// A row with every key masked gives m = -1e30, y = 0, dn = 0.
//
// What bounds the first two on the H100: memory.  A query row attends at most 3*nr
// keys (2*nr causal, nr at a sub level and in coarse_causal), so one row
// costs ~4*nr*d FLOPs against ~2*d*4 bytes of q and y: at nr=16, d=64
// about 8-12 FLOP per byte, below the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20).  The level's least time is the bytes it must move (q
// of the rows that have a live key, the key blocks some row reads, every
// output written once) over the memory rate.
//
// One design in two kernels, both on tiles of rows in shared memory with
// 128 threads.  A tile's key weights come first: each key block's info
// (block_info: which halves hold a key with w > 0) decides which rows are
// live (band_row_live); a dead row is written as m = -1e30, y = 0, dn = 0
// without reading q, k or v, and a tile of dead rows returns after that.
// Live rows and live key blocks are copied into shared memory with
// cp.async (16 bytes a thread, no register staging; scalar loads where a
// row is not 16-byte aligned).  Scores are 2-row x 4-key register tiles
// of fmaf chains over float4 loads, in dot_tile's column order, so the
// backward's recomputed s is the forward's bit for bit; the row max and dn are
// shuffles among the lanes of a row pair; y = a @ v is a 4-row x 4-column
// register tile, stored as float4.
//   * l0_causal, l0_bidir, coarse_bidir (band_fwd_kernel): one CTA per
//     (b, g, tile of 16-32 rows; 16 where the grid would not fill the
//     card, band_fwd_tq) stages its window: the key blocks before, at and
//     (bidirectional) after its rows.  A row pair takes 2 * nr/4 lanes in
//     two slots; a lane scores one group of 4 keys in each band of its
//     slot (slot 0 the block before and, in l0_bidir, the block after;
//     slot 1 the other) and the bands combine in registers and over the
//     pair's lanes (a power of two, whatever the number of bands).  Lanes
//     sit so that an 8-lane phase of a 16-byte shared load reads key rows
//     in distinct banks (lane_item).  The mask is tested per band with the
//     block difference known (band_admits), and key groups it masks whole
//     are not computed: the own block above the diagonal (l0_causal), the
//     second half of the block before for first-half rows and the first
//     half of the block after for the others (coarse_bidir, which never
//     reads the own block: 1.5 nr keys a row).
//   * the sub level and coarse_causal (sub_fwd_kernel, the same structure
//     at ratio 1): query block I reads exactly key block I-1, so a CTA
//     takes a tile of SUB_TQ rows of one (b, g) and the one to SUB_TQ/nq
//     key blocks they read; first-half rows take only the key groups of
//     the first nr/2 keys.
// Plain fp32 FMA on CUDA cores (no TF32 and no wgmma: the port is held to
// fp32 parity), expf not __expf.
#include <cuda_runtime.h>
#include <math.h>

#include "h1d_band.cuh"
#include "launch_info.cuh"

namespace {

using namespace h1d;

// Input row layouts that may be copied 16 bytes at a time.
enum { VEC_Q = 1, VEC_K = 2, VEC_V = 4 };

// l0_causal, l0_bidir, coarse_bidir: one CTA per (b, g, tile of tq rows).
// RY: rows of a y register tile, 4 unless nr is 2.
template <int MODE, int RY>
__global__ void __launch_bounds__(BAND_THREADS)
band_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                float* __restrict__ y, float* __restrict__ dn,
                float* __restrict__ m, int G, int Lq, int Lk, int d, int dv,
                int nr, int tq, int vec_in, int vec_y) {
  constexpr int NB = MODE == L0_BIDIR ? 3 : 2;  // bands a row reads
  constexpr int SLOTS = BAND_SLOTS;
  constexpr int BPT = (NB + SLOTS - 1) / SLOTS; // bands a slot
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tiles = (Lq + tq - 1) / tq;
  const int g = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - g * tiles) * tq;
  const int rows = min(tq, Lq - t0);
  const int nkg = key_groups(nr), nk4 = 4 * nkg;
  const int d4 = round4(d), dv4 = round4(dv);
  const int qs = d4 + 4, as = NB * nk4 + 4;
  const int I0 = t0 / nr;                       // first query block
  // window blocks I0 - 1 .. the last row's block (+1 bidirectional)
  const int nwb = (t0 + rows - 1) / nr - I0 + (MODE == L0_CAUSAL ? 2 : 3);
  const int nwbm = band_window_blocks(MODE, tq, nr);
  const int nkw = nwbm * nr + 4;
  const int kb0 = (I0 - 1) * nr;                // first key of the window
  float* q_s = smem;                            // tq x qs
  float* k_s = q_s + tq * qs;                   // nkw x qs
  float* v_s = k_s + nkw * qs;                  // nkw x dv4
  float* a_s = v_s + nkw * dv4;                 // tq x as: a, band by band
  float* w_s = a_s + tq * as;                   // nkw
  int* blk_s = reinterpret_cast<int*>(w_s + nkw);   // block_info a block
  int* row_s = blk_s + nwbm;                    // 1: the row is live
  const size_t row0 = ((size_t)b * G + g) * Lq + t0;

  // the window's key weights first: block info, then the live rows
  for (int r = tid; r < nkw; r += BAND_THREADS) {
    const int j = kb0 + r;
    w_s[r] = (r < nwb * nr && j >= 0 && j < Lk) ? w[(size_t)b * Lk + j]
                                                : 0.f;
  }
  __syncthreads();
  if (tid < nwb) blk_s[tid] = block_info(w_s + tid * nr, nr);
  __syncthreads();
  int live = 0;
  for (int r = tid; r < rows; r += BAND_THREADS) {
    const int i = t0 + r, wb = i / nr - I0 + 1;
    const int f = band_row_live<MODE>(i - (i / nr) * nr, nr, blk_s[wb - 1],
                                      blk_s[wb],
                                      wb + 1 < nwb ? blk_s[wb + 1] : 0);
    row_s[r] = f;
    live |= f;
  }
  if (!__syncthreads_or(live)) {                // every row dead
    for (int e = tid; e < rows * dv; e += BAND_THREADS)
      y[row0 * dv + e] = 0.f;
    for (int r = tid; r < rows; r += BAND_THREADS) {
      dn[row0 + r] = 0.f;
      m[row0 + r] = MIN_M;
    }
    return;
  }

  stage_rows(q_s, qs, rows, d, vec_in & VEC_Q, [&](int r) -> const float* {
    return row_s[r] ? q + (row0 + r) * d : nullptr;
  });
  auto key_src = [&](int r, const float* base, int n) -> const float* {
    const bool lv = r < nwb * nr && (blk_s[r / nr] & 3);
    return lv ? base + ((size_t)b * Lk + kb0 + r) * n : nullptr;
  };
  stage_rows(k_s, qs, nwb * nr + 4, d, vec_in & VEC_K,
             [&](int r) { return key_src(r, k, d); });
  stage_rows(v_s, dv4, nwb * nr + 4, dv, vec_in & VEC_V,
             [&](int r) { return key_src(r, v, dv); });
  cp_async_wait();
  __syncthreads();

  // scores, row max, a = exp(s - m) and dn per (row pair, lane slot, key
  // group): W = SLOTS * nkg lanes a row pair, slot sl takes the bands sl,
  // sl + SLOTS, ..., combined in registers
  const int W = SLOTS * nkg;
  const int total = 32 * lane_groups(rows / 2, W);
  for (int base = 0; base < total; base += BAND_THREADS) {
    int pair, j;
    lane_item(base + tid, W, &pair, &j);
    const bool active = pair < rows / 2;
    const int r0 = active ? 2 * pair : 0, sl = j / nkg;
    const int kl = 4 * (j - sl * nkg);
    const int i0 = t0 + r0, p = i0 % nr, wb0 = i0 / nr - I0 + 1;
    const int f0 = active ? row_s[r0] : 0, f1 = active ? row_s[r0 + 1] : 0;
    float s[BPT][2][4];
    unsigned allow = 0;                         // bit (u * 2 + rr) * 4 + t
#pragma unroll
    for (int u = 0; u < BPT; ++u) {
      const int bb = sl + SLOTS * u;
      const int off = band_off(MODE, bb), wb = wb0 + off;
      int glo = 0, ghi = 0;
      if (bb < NB) band_group_range<MODE>(off, p, 2, nr, &glo, &ghi);
      const bool need = (f0 | f1) && bb < NB && (blk_s[wb] & 3) &&
                        kl >= 4 * glo && kl < 4 * ghi;
      if (need)
        dot_tile<2>(q_s + r0 * qs, qs, k_s + (wb * nr + kl) * qs, qs, d4,
                    s[u]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int jw = wb * nr + kl + t;
          const bool ok = need && (rr ? f1 : f0) && kl + t < nr &&
                          w_s[jw] > 0.f &&
                          band_admits<MODE>(off, p + rr, kl + t, nr);
          if (ok) allow |= 1u << ((u * 2 + rr) * 4 + t);
        }
    }
    float mrow[2], dsum[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < BPT; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool ok = (allow >> ((u * 2 + rr) * 4 + t)) & 1u;
          s[u][rr][t] = ok ? s[u][rr][t] : NEG_INF;
          mx = fmaxf(mx, s[u][rr][t]);
        }
      for (int o = 1; o < W; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, lane_xor(o, W)));
      mrow[rr] = fmaxf(mx, MIN_M);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BPT; ++u) {
        const int bb = sl + SLOTS * u;
        const float* wk = w_s + (wb0 + band_off(MODE, bb)) * nr + kl;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[u][rr][t] = expf(s[u][rr][t] - mrow[rr]);       // now a
          if (bb < NB) sum = fmaf(s[u][rr][t], wk[t], sum);
        }
      }
      for (int o = 1; o < W; o <<= 1)
        sum += __shfl_xor_sync(FULL, sum, lane_xor(o, W));
      dsum[rr] = sum;
    }
    if (active) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int u = 0; u < BPT; ++u)
          if (sl + SLOTS * u < NB)
            *reinterpret_cast<float4*>(a_s + (r0 + rr) * as +
                                       (sl + SLOTS * u) * nk4 + kl) =
                make_float4(s[u][rr][0], s[u][rr][1], s[u][rr][2],
                            s[u][rr][3]);
        if (j == 0) {
          m[row0 + r0 + rr] = mrow[rr];
          dn[row0 + r0 + rr] = dsum[rr];
        }
      }
    }
  }
  __syncthreads();

  // y = a @ v: RY rows x 4 columns a thread, over each live band's
  // admitted key groups
  const int ncg = dv4 / 4;
  for (int e = tid; e < rows / RY * ncg; e += BAND_THREADS) {
    const int rg = e / ncg, c = (e - rg * ncg) * 4;
    const int r0 = rg * RY, i0 = t0 + r0, p = i0 % nr;
    const int wb0 = i0 / nr - I0 + 1;
    float acc[RY][4];
    int any = 0;
#pragma unroll
    for (int rr = 0; rr < RY; ++rr) {
      any |= row_s[r0 + rr];
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[rr][t] = 0.f;
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      const int off = band_off(MODE, bb), wb = wb0 + off;
      int glo, ghi;
      band_group_range<MODE>(off, p, RY, nr, &glo, &ghi);
      if (any && (blk_s[wb] & 3) && glo < ghi)
        apply_tile_add<RY>(a_s + r0 * as + bb * nk4 + 4 * glo, as,
                           v_s + (wb * nr + 4 * glo) * dv4 + c, dv4,
                           4 * (ghi - glo), acc);
    }
#pragma unroll
    for (int rr = 0; rr < RY; ++rr)
      store4(y + (row0 + r0 + rr) * dv, c, dv, vec_y, acc[rr]);
  }
}

template <int MODE, int RY>
int launch_ry(const float* q, const float* k, const float* v, const float* w,
              float* y, float* dn, float* m, int B, int G, int L, int d,
              int dv, int nr, int tq, cudaStream_t stream) {
  const size_t smem = band_fwd_floats(MODE, tq, d, dv, nr) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        band_fwd_kernel<MODE, RY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec_in = (aligned16(q) && d % 4 == 0 ? VEC_Q : 0) |
                     (aligned16(k) && d % 4 == 0 ? VEC_K : 0) |
                     (aligned16(v) && dv % 4 == 0 ? VEC_V : 0);
  const int vec_y = aligned16(y) && dv % 4 == 0;
  const dim3 grid(G * ((L + tq - 1) / tq), B);
  note_grid(grid.x, grid.y);
  h1d_info::note(0, band_fwd_kernel<MODE, RY>, BAND_THREADS, smem);
  // Lq and Lk stay two arguments: as one, the body compiled to slower code
  band_fwd_kernel<MODE, RY><<<grid, BAND_THREADS, smem, stream>>>(
      q, k, v, w, y, dn, m, G, L, L, d, dv, nr, tq, vec_in, vec_y);
  return (int)cudaGetLastError();
}

// nr a power of two in [2, BAND_MAX_NR]; any d and dv whose 16-row tile
// fits the card's shared memory (band_fwd_tq).  tile: rows a tile, 16 or
// 32 within SMEM_MAX (the policy's choice, kernels/tuning.py), or 0 for
// band_fwd_tq's.
template <int MODE>
int launch(const float* q, const float* k, const float* v, const float* w,
           float* y, float* dn, float* m, int B, int G, int L, int d, int dv,
           int nr, int tile, cudaStream_t stream) {
  if (d < 1 || dv < 1 || nr < 2 || nr > BAND_MAX_NR || (nr & (nr - 1)) ||
      L % nr)
    return (int)cudaErrorInvalidValue;
  if (tile != 0 && ((tile != 16 && tile != BAND_TQ) ||
                    4 * band_fwd_floats(MODE, tile, d, dv, nr) > SMEM_MAX))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || G == 0 || L == 0) return 0;
  const int tq = tile ? tile : band_fwd_tq(MODE, B, G, L, d, dv, nr, false);
  if (tq == 0) return (int)cudaErrorInvalidValue;
  if (nr >= 4)
    return launch_ry<MODE, 4>(q, k, v, w, y, dn, m, B, G, L, d, dv, nr, tq,
                              stream);
  return launch_ry<MODE, 2>(q, k, v, w, y, dn, m, B, G, L, d, dv, nr, tq,
                            stream);
}

// ---------------------------------------------------------------------------
// sub level and coarse_causal
// ---------------------------------------------------------------------------

// RY: rows of a y register tile, 4 unless a query block has 2 rows.
template <int RY>
__global__ void __launch_bounds__(SUB_THREADS)
sub_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               float* __restrict__ y, float* __restrict__ dn,
               float* __restrict__ m, int G, int Lq, int Lk, int d, int dv,
               int nr, int ratio, int vec_in, int vec_y) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tiles = (Lq + SUB_TQ - 1) / SUB_TQ;
  const int g = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - g * tiles) * SUB_TQ;
  const int rows = min(SUB_TQ, Lq - t0);
  const int nq = nr * ratio, half = nr / 2, hs = nq / 2;
  const int nkg = key_groups(nr), nkgh = key_groups(half);
  const int d4 = round4(d), dv4 = round4(dv);
  const int qs = d4 + 4, as = 4 * nkg + 4;
  const int nkw = sub_fwd_window(nr, ratio);
  const int I0 = t0 / nq;                       // first query block
  const int nblk = (t0 + rows - 1) / nq - I0 + 1;
  const int kb0 = (I0 - 1) * nr;                // first key of the window
  float* q_s = smem;                            // SUB_TQ x qs
  float* k_s = q_s + SUB_TQ * qs;               // nkw x qs
  float* v_s = k_s + nkw * qs;                  // nkw x dv4
  float* a_s = v_s + nkw * dv4;                 // SUB_TQ x as
  float* w_s = a_s + SUB_TQ * as;               // nkw
  int* blk_s = reinterpret_cast<int*>(w_s + nkw);   // per block: live halves
  int* row_s = blk_s + SUB_TQ;                  // 1 live, 2 first half
  const size_t row0 = ((size_t)b * G + g) * Lq + t0;

  // the window's key weights; block flags: 1 = a key of the first half
  // has w > 0 (first-half rows live), 2 = some key has (the rest live)
  for (int r = tid; r < nkw; r += SUB_THREADS) {
    const int j = kb0 + r;
    w_s[r] = (r < nblk * nr && j >= 0 && j < Lk) ? w[(size_t)b * Lk + j]
                                                 : 0.f;
  }
  __syncthreads();
  int flag = 0;
  if (tid < nblk)
    for (int j = 0; j < nr; ++j)
      if (w_s[tid * nr + j] > 0.f) flag |= j < half ? 3 : 2;
  if (tid < SUB_TQ) blk_s[tid] = flag;
  if (!__syncthreads_or(flag)) {                // every row dead
    for (int e = tid; e < rows * dv; e += SUB_THREADS)
      y[row0 * dv + e] = 0.f;
    for (int r = tid; r < rows; r += SUB_THREADS) {
      dn[row0 + r] = 0.f;
      m[row0 + r] = MIN_M;
    }
    return;
  }
  for (int r = tid; r < SUB_TQ; r += SUB_THREADS) {
    int f = 0;
    if (r < rows) {
      const int i = t0 + r, blk = i / nq - I0;
      const bool first = i - (blk + I0) * nq < hs;
      f = (first ? 2 : 0) | ((blk_s[blk] & (first ? 1 : 2)) ? 1 : 0);
    }
    row_s[r] = f;
  }
  __syncthreads();

  stage_rows(q_s, qs, SUB_TQ, d, vec_in & VEC_Q, [&](int r) -> const float* {
    return (row_s[r] & 1) ? q + (row0 + r) * d : nullptr;
  });
  auto key_src = [&](int r, const float* base, int n) -> const float* {
    const bool live = r < nblk * nr && (blk_s[r / nr] & 2);
    return live ? base + ((size_t)b * Lk + kb0 + r) * n : nullptr;
  };
  stage_rows(k_s, qs, nkw, d, vec_in & VEC_K,
             [&](int r) { return key_src(r, k, d); });
  stage_rows(v_s, dv4, nkw, dv, vec_in & VEC_V,
             [&](int r) { return key_src(r, v, dv); });
  cp_async_wait();
  __syncthreads();

  // scores, row max, a = exp(s - m) and dn, per (row pair, key group)
  const int p0 = t0 % nq;
  const int total = sub_pair_total(rows, p0, nq, nkg, nkgh);
  for (int base = 0; base < total; base += SUB_THREADS) {
    const PairItem it = sub_pair_item(base + tid, rows, p0, nq, nkg, nkgh);
    const int r0 = it.row, kl = 4 * it.kg;
    const int blk = (t0 + r0) / nq - I0;
    const int* fl = row_s + r0;
    const float* wk = w_s + blk * nr + kl;
    float s[2][4];
    if (it.active && ((fl[0] | fl[1]) & 1)) {
      dot_tile<2>(q_s + r0 * qs, qs, k_s + (blk * nr + kl) * qs, qs, d4, s);
    }
    float mrow[2], dsum[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int f = it.active ? fl[rr] : 0;
      const int lim = (f & 2) ? half : nr;
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool allow = (f & 1) && kl + t < lim && wk[t] > 0.f;
        s[rr][t] = allow ? s[rr][t] : NEG_INF;
        mx = fmaxf(mx, s[rr][t]);
      }
      for (int off = 1; off < nkg; off <<= 1) {
        const float o = __shfl_xor_sync(FULL, mx, off);
        if (off < it.width) mx = fmaxf(mx, o);
      }
      mrow[rr] = fmaxf(mx, MIN_M);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        s[rr][t] = expf(s[rr][t] - mrow[rr]);          // now a
        sum = fmaf(s[rr][t], wk[t], sum);
      }
      for (int off = 1; off < nkg; off <<= 1) {
        const float o = __shfl_xor_sync(FULL, sum, off);
        if (off < it.width) sum += o;
      }
      dsum[rr] = sum;
    }
    if (it.active) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        *reinterpret_cast<float4*>(a_s + (r0 + rr) * as + kl) =
            make_float4(s[rr][0], s[rr][1], s[rr][2], s[rr][3]);
        if (it.kg == 0) {
          m[row0 + r0 + rr] = mrow[rr];
          dn[row0 + r0 + rr] = dsum[rr];
        }
      }
    }
  }
  __syncthreads();

  // y = a @ v: RY rows x 4 columns a thread; first-half rows stop at the
  // key groups they were scored on
  const int ncg = dv4 / 4;
  for (int e = tid; e < rows / RY * ncg; e += SUB_THREADS) {
    const int rg = e / ncg, c = (e - rg * ncg) * 4;
    const int r0 = rg * RY;
    const int blk = (t0 + r0) / nq - I0;
    const bool first = row_s[r0] & row_s[r0 + RY - 1] & 2;
    float acc[RY][4];
    apply_tile<RY>(a_s + r0 * as, as, v_s + blk * nr * dv4 + c, dv4,
                   4 * (first ? nkgh : nkg), acc);
#pragma unroll
    for (int rr = 0; rr < RY; ++rr)
      store4(y + (row0 + r0 + rr) * dv, c, dv, vec_y, acc[rr]);
  }
}

size_t sub_fwd_smem(int d, int dv, int nr, int ratio) {
  const int nkw = sub_fwd_window(nr, ratio);
  const size_t qs = round4(d) + 4, as = 4 * key_groups(nr) + 4;
  return ((size_t)SUB_TQ * qs + nkw * qs + (size_t)nkw * round4(dv) +
          SUB_TQ * as + nkw + 2 * SUB_TQ) * sizeof(float);
}

template <int RY>
int launch_sub_ry(const float* q, const float* k, const float* v,
                  const float* w, float* y, float* dn, float* m, int B, int G,
                  int Lq, int Lk, int d, int dv, int nr, int ratio,
                  cudaStream_t stream) {
  const size_t smem = sub_fwd_smem(d, dv, nr, ratio);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sub_fwd_kernel<RY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec_in = (aligned16(q) && d % 4 == 0 ? VEC_Q : 0) |
                     (aligned16(k) && d % 4 == 0 ? VEC_K : 0) |
                     (aligned16(v) && dv % 4 == 0 ? VEC_V : 0);
  const int vec_y = aligned16(y) && dv % 4 == 0;
  const dim3 grid(G * ((Lq + SUB_TQ - 1) / SUB_TQ), B);
  note_grid(grid.x, grid.y);
  h1d_info::note(0, sub_fwd_kernel<RY>, SUB_THREADS, smem);
  sub_fwd_kernel<RY><<<grid, SUB_THREADS, smem, stream>>>(
      q, k, v, w, y, dn, m, G, Lq, Lk, d, dv, nr, ratio, vec_in, vec_y);
  return (int)cudaGetLastError();
}

// nr a power of two in [2, 64], Lq = Lk * ratio.
int launch_sub(const float* q, const float* k, const float* v,
               const float* w, float* y, float* dn, float* m, int B, int G,
               int Lq, int Lk, int d, int dv, int nr, int ratio,
               cudaStream_t stream) {
  if (d < 1 || dv < 1 || nr < 2 || nr > SUB_TQ || (nr & (nr - 1)) ||
      ratio < 1 || Lq != Lk * ratio)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || G == 0 || Lq == 0) return 0;
  // a y tile's rows lie in one query block
  if ((nr * ratio < Lq ? nr * ratio : Lq) >= 4)
    return launch_sub_ry<4>(q, k, v, w, y, dn, m, B, G, Lq, Lk, d, dv, nr,
                            ratio, stream);
  return launch_sub_ry<2>(q, k, v, w, y, dn, m, B, G, Lq, Lk, d, dv, nr,
                          ratio, stream);
}

// ---------------------------------------------------------------------------
// l0_causal, streamed (h1d_band_fwd_stream)
// ---------------------------------------------------------------------------
//
// Replaces band_attention_fwd (repro/kernels/h1d_block.py:299) in
// l0_causal where band_fwd_kernel cannot stage the key window: a sliding
// window's block (nr = 1024 at d = 256 for gemma3-4b's local layers) puts
// 2 nr keys of d + dv floats behind a row, ~4 MB, against the 227 KB a CTA
// may hold.  Row i admits the keys (i / nr - 1) * nr .. i with w > 0,
// one contiguous range, so the tile of rows t0 .. t0 + 63 reads the keys
// from (t0 / nr - 1) * nr to its last row and nothing else.
//
// What bounds it: operations.  A row scores up to 2 nr keys at 4 d + 3
// FLOPs a key against ~4 (d + dv) bytes of its own, and every key row is
// read by nr rows: at nr = 1024, d = 256 some 500 FLOPs a byte, far past
// the fp32 ridge (20).  fp32 FMA on CUDA cores with no TF32 (the port is
// held to fp32 parity), so the floor is the admitted pairs' FLOPs over
// 67 TFLOP/s, and the design keeps the FMA pipes fed from shared memory
// with few barriers (its first form: 2 x 4 score tiles, 32-key
// stages, three CTA barriers and a serial softmax step a tile, ran at
// 4.0x the bound):
//   * one CTA per (b, g, tile of 64 rows), 256 threads, one CTA an SM;
//     tiles in stream_slot's order, the longest windows (rows late in
//     their block) first, so the last of the ~4 waves holds short ones;
//   * the rows' q stay resident; the window's live key tiles (64 keys:
//     tiles with no w > 0 are listed out first, and tiles past the last
//     row never formed) stream through one buffer of keys and one of
//     values with cp.async, each refilled while the other is read: the
//     values of tile n land during its scores, the keys of tile n + 1
//     during its a @ v, so two CTA barriers a tile and no load waits;
//   * scores are 4-row x 4-key register tiles (dot_tile_rk, dot_tile's
//     order: bit for bit the scores the backward recomputes), each warp
//     owning 8 whole rows of the tile, so the online softmax (row max,
//     sum over w, the running m and dn, kept in registers) is shuffles
//     inside the warp, with no barrier between the scores and it;
//   * y is a register tile of 8 rows x 8 columns a lane at d = 256
//     (lane_tile: 32 rows x 64 columns a warp, so a 16-byte load serves
//     8 FMAs a lane), a @ v 16 shared loads for 256 FMAs; each tile's two
//     32-key chunks are summed apart before they join y, the plain
//     version's chunks (h1d_block.SUM_KEYS).
// expf, not __expf.
template <int RY>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
band_stream_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   float* __restrict__ y, float* __restrict__ dn,
                   float* __restrict__ m, int B, int G, int L, int d, int dv,
                   int nr, int vec_in, int vec_y) {
  constexpr int TQ = STREAM_TQ, TK = STREAM_TK, NT = STREAM_THREADS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int bg, blk, rank, t0;
  if (nr >= TQ) {
    stream_slot(blockIdx.x, B * G, L / nr, nr / TQ, &bg, &blk, &rank);
    t0 = (blk + 1) % (L / nr) * nr + (nr / TQ - 1 - rank) * TQ;
  } else {
    const int tiles = (L + TQ - 1) / TQ;
    bg = blockIdx.x / tiles;
    t0 = (blockIdx.x - bg * tiles) * TQ;
  }
  const int b = bg / G;
  const int rows = min(TQ, L - t0);
  const int d4 = round4(d), dv4 = round4(dv);
  const int qs = d4 + 4, vs = dv4, ps = TK + 4;
  const int kw0 = max(0, (t0 / nr - 1) * nr);   // the window's first key
  const int kend = t0 + rows - 1;               // and its last
  const int nt = (kend - kw0 + TK) / TK;        // key tiles it spans
  float* q_s = smem;                            // TQ x qs
  float* k_s = q_s + TQ * qs;                   // TK x qs
  float* v_s = k_s + TK * qs;                   // TK x vs
  float* w_s = v_s + TK * vs;                   // TK
  float* p_s = w_s + TK;                        // TQ x ps: this tile's a
  float* sc_s = p_s + TQ * ps;                  // this tile's rescale
  int* live_s = reinterpret_cast<int*>(sc_s + TQ);  // live key tiles
  int* nlive_s = live_s + stream_max_tiles(nr);
  const size_t row0 = (size_t)bg * L + t0;
  const float* wb = w + (size_t)b * L;

  // list the window's key tiles that hold a key with w > 0, in order
  for (int n = warp; n < nt; n += NT / 32) {
    const int j = kw0 + n * TK + lane;
    const unsigned any = __ballot_sync(FULL, j <= kend && wb[j] > 0.f) |
                         __ballot_sync(FULL, j + 32 <= kend && wb[j + 32] > 0.f);
    if (lane == 0) live_s[n] = any != 0u;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int n = 0; n < nt; ++n)
      if (live_s[n]) live_s[c++] = n;
    *nlive_s = c;
  }
  __syncthreads();
  const int nlive = *nlive_s;

  // copies of live key tile n: its keys and weights, or its values (keys
  // past the last row zero)
  auto src = [&](int n, int r, const float* base, int width) -> const float* {
    const int j = kw0 + live_s[n] * TK + r;
    return j <= kend ? base + ((size_t)b * L + j) * width : nullptr;
  };
  auto stage_keys = [&](int n) {
    stage_rows(k_s, qs, TK, d, vec_in & VEC_K,
               [&](int r) { return src(n, r, k, d); });
    if (tid < TK) {
      const int j = kw0 + live_s[n] * TK + tid;
      if (j <= kend) cp_async4(w_s + tid, wb + j);
      else w_s[tid] = 0.f;
    }
  };
  auto stage_values = [&](int n) {
    stage_rows(v_s, vs, TK, dv, vec_in & VEC_V,
               [&](int r) { return src(n, r, v, dv); });
  };
  if (nlive > 0) {
    stage_rows(q_s, qs, TQ, d, vec_in & VEC_Q, [&](int r) -> const float* {
      return r < rows ? q + (row0 + r) * d : nullptr;
    });
    stage_keys(0);
  }
  cp_async_commit();

  // scores: warp w's rows 8w + rl + 2 r (r < 4) against keys kl + 16 t;
  // the row bit lowest, so the 16 lanes of a half-warp load 8 key rows,
  // 128 bytes in distinct banks
  const int rl = lane & 1, kl = lane >> 1;
  const int rs0 = warp * 8 + rl;
  float m_r[4], dn_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_r[r] = MIN_M;
    dn_r[r] = 0.f;
  }
  // a @ v: this lane's rows lt.row0 + lt.rstep * rr, units lt.u0, lt.u1
  const int units = 8 * RY, ncg = dv4 / 4;
  const LaneTile lt = lane_tile(tid, units, TQ);
  const int c0 = min(lt.u0, ncg - 1) * 4, c1 = min(lt.u1, ncg - 1) * 4;
  float acc[RY][8];
#pragma unroll
  for (int rr = 0; rr < RY; ++rr)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[rr][c] = 0.f;

  for (int n = 0; n < nlive; ++n) {
    cp_async_wait();                            // keys of tile n
    __syncthreads();                            // a @ v of n - 1 is done
    stage_values(n);
    cp_async_commit();
    const int ks = kw0 + live_s[n] * TK;

    float sc[4][4];
    dot_tile_rk<4, 4>(q_s + rs0 * qs, 2 * qs, k_s + kl * qs, 16 * qs, d4,
                      sc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rs0 + 2 * r, i = t0 + row, lo = (i / nr - 1) * nr;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = ks + kl + 16 * t;
        ok[t] = j >= lo && j <= i && w_s[kl + 16 * t] > 0.f;
        if (ok[t]) mx = fmaxf(mx, sc[r][t]);
      }
#pragma unroll
      for (int o = 2; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float mnew = fmaxf(m_r[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float a = ok[t] ? expf(sc[r][t] - mnew) : 0.f;
        p_s[row * ps + kl + 16 * t] = a;
        sum = fmaf(a, w_s[kl + 16 * t], sum);
      }
#pragma unroll
      for (int o = 2; o < 32; o <<= 1)
        sum += __shfl_xor_sync(FULL, sum, o);
      const float f = expf(m_r[r] - mnew);
      dn_r[r] = fmaf(dn_r[r], f, sum);
      m_r[r] = mnew;
      if (kl == 0) sc_s[row] = f;
    }
    cp_async_wait();                            // values of tile n
    __syncthreads();                            // a and rescales written
    if (n + 1 < nlive) stage_keys(n + 1);
    cp_async_commit();

    // y = y * rescale + (a @ v over each 32-key chunk, summed apart
    // first: one fp32 chain over the window's 2 nr keys drifts ~3e-5
    // from the exact sum)
    const float* pr = p_s + lt.row0 * ps;
#pragma unroll
    for (int rr = 0; rr < RY; ++rr) {
      const float f = sc_s[lt.row0 + lt.rstep * rr];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[rr][c] *= f;
    }
#pragma unroll
    for (int h = 0; h < TK; h += 32) {
      float part[RY][8];
      apply_tile8<RY>(pr + h, lt.rstep * ps, v_s + h * vs, vs, c0, c1, 32,
                      part);
#pragma unroll
      for (int rr = 0; rr < RY; ++rr)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[rr][c] += part[rr][c];
    }
  }

#pragma unroll
  for (int rr = 0; rr < RY; ++rr) {
    const int r = lt.row0 + lt.rstep * rr;
    if (r >= rows) continue;
    float* yr = y + (row0 + r) * dv;
    const float lo4[4] = {acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]};
    const float hi4[4] = {acc[rr][4], acc[rr][5], acc[rr][6], acc[rr][7]};
    if (lt.u0 < ncg) store4(yr, lt.u0 * 4, dv, vec_y, lo4);
    if (lt.u1 < ncg) store4(yr, lt.u1 * 4, dv, vec_y, hi4);
  }
  if (kl == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rs0 + 2 * r;
      if (row < rows) {
        dn[row0 + row] = dn_r[r];
        m[row0 + row] = m_r[r];
      }
    }
  }
}

size_t stream_smem(int d, int dv, int nr) {
  return stream_fwd_floats(d, dv, nr) * sizeof(float);
}

// nr a power of two >= 2 with L % nr == 0; d, dv up to STREAM_MAX_D; the
// shared-memory plan (which grows with nr) within SMEM_MAX.  y's register
// tile is laid out for stream_cols(dv) units.
int launch_stream(const float* q, const float* k, const float* v,
                  const float* w, float* y, float* dn, float* m, int B,
                  int G, int L, int d, int dv, int nr, cudaStream_t stream) {
  if (d < 1 || dv < 1 || d > STREAM_MAX_D || dv > STREAM_MAX_D || nr < 2 ||
      (nr & (nr - 1)) || L % nr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stream_smem(d, dv, nr);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (B == 0 || G == 0 || L == 0) return 0;
  const auto kernel =
      by_stream_cols(round4(dv), &band_stream_kernel<2>,
                     &band_stream_kernel<4>, &band_stream_kernel<8>);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec_in = (aligned16(q) && d % 4 == 0 ? VEC_Q : 0) |
                     (aligned16(k) && d % 4 == 0 ? VEC_K : 0) |
                     (aligned16(v) && dv % 4 == 0 ? VEC_V : 0);
  const int vec_y = aligned16(y) && dv % 4 == 0;
  const int ctas = B * G * ((L + STREAM_TQ - 1) / STREAM_TQ);
  note_grid(ctas, 1);
  h1d_info::note(0, kernel, STREAM_THREADS, smem);
  kernel<<<ctas, STREAM_THREADS, smem, stream>>>(
      q, k, v, w, y, dn, m, B, G, L, d, dv, nr, vec_in, vec_y);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,G,L,d) pre-scaled, k (B,L,d), v (B,L,dv) pre-weighted, w (B,L)
// -> y (B,G,L,dv), dn (B,G,L), m (B,G,L); mode is an h1d::Mode.
// coarse_causal reads only the block before a row's own: the sub body
// at ratio 1.  tile: rows a tile (16 or 32; coarse_causal: SUB_TQ), 0 for
// the launcher's own rule; a tile that does not fit is an error.
extern "C" int h1d_band_fwd(const float* q, const float* k, const float* v,
                            const float* w, float* y, float* dn, float* m,
                            int B, int G, int L, int d, int dv, int nr,
                            int mode, int tile, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  h1d::note_grid(0, 0);
  h1d_info::clear();
  switch (mode) {
    case h1d::L0_BIDIR:
      return launch<h1d::L0_BIDIR>(q, k, v, w, y, dn, m, B, G, L, d, dv, nr,
                                   tile, st);
    case h1d::L0_CAUSAL:
      return launch<h1d::L0_CAUSAL>(q, k, v, w, y, dn, m, B, G, L, d, dv, nr,
                                    tile, st);
    case h1d::COARSE_BIDIR:
      return launch<h1d::COARSE_BIDIR>(q, k, v, w, y, dn, m, B, G, L, d, dv,
                                       nr, tile, st);
    case h1d::COARSE_CAUSAL:
      if (tile != 0 && tile != h1d::SUB_TQ) return (int)cudaErrorInvalidValue;
      return launch_sub(q, k, v, w, y, dn, m, B, G, L, L, d, dv, nr, 1, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q (B,G,Lq,d), coarse k (B,Lk,d), v (B,Lk,dv), w (B,Lk), Lq = Lk*ratio
// -> y (B,G,Lq,dv), dn (B,G,Lq), m (B,G,Lq); mode sub.
extern "C" int h1d_band_sub_fwd(const float* q, const float* k,
                                const float* v, const float* w, float* y,
                                float* dn, float* m, int B, int G, int Lq,
                                int Lk, int d, int dv, int nr, int ratio,
                                void* stream) {
  h1d::note_grid(0, 0);
  h1d_info::clear();
  return launch_sub(q, k, v, w, y, dn, m, B, G, Lq, Lk, d, dv, nr, ratio,
                    (cudaStream_t)stream);
}

// l0_causal with the key window streamed through shared memory: q
// (B,G,L,d) pre-scaled, k (B,L,d), v (B,L,dv) pre-weighted, w (B,L) ->
// y (B,G,L,dv), dn (B,G,L), m (B,G,L), as h1d_band_fwd in l0_causal.
extern "C" int h1d_band_fwd_stream(const float* q, const float* k,
                                   const float* v, const float* w, float* y,
                                   float* dn, float* m, int B, int G, int L,
                                   int d, int dv, int nr, void* stream) {
  h1d::note_grid(0, 0);
  h1d_info::clear();
  return launch_stream(q, k, v, w, y, dn, m, B, G, L, d, dv, nr,
                       (cudaStream_t)stream);
}

// Bytes of the streamed body's shared-memory plan (held by the card tests
// to repro_torch.kernels.h1d_block.stream_fwd_floats).
extern "C" int h1d_band_stream_smem(int d, int dv, int nr) {
  return (int)stream_smem(d, dv, nr);
}

// The grids of this library's last launch on the calling thread
// (h1d::note_grid) into out[4]: what the wrappers' launch records carry.
extern "C" int h1d_band_fwd_last_grid(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = h1d::last_grid[i];
  return 0;
}

// The dynamic shared memory of this library's last launch on the calling
// thread, and its kernel's registers, static shared memory, most threads
// and CTAs an SM (launch_info.cuh), for the wrappers' launch records.
extern "C" int h1d_band_fwd_last_smem(int* out) {
  return h1d_info::last_smem(out);
}

extern "C" int h1d_band_fwd_last_attrs(int* out) {
  return h1d_info::last_attrs(out);
}
