// Banded block attention backward for H-Transformer-1D, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/h1d_block_bwd.py:
//   * h1d_band_bwd     <- band_attention_bwd (_dq_kernel, _dkvw_kernel),
//     every band mode: l0_causal, l0_bidir, coarse_bidir and
//     coarse_causal (the last on the sub body at ratio 1);
//   * h1d_band_sub_bwd <- band_attention_sub_bwd (_dq_sub_kernel and both
//     the wide and the deep dK/dV/dW kernels), the fine-q causal level;
//   * h1d_band_bwd_stream <- band_attention_bwd in l0_causal where the key
//     window is too wide to stage (a sliding window's nr = 1024; its own
//     note is at stream_dq_kernel below).
// Math (h1d_block_bwd.py:10-30), per level and query row i, from the
// saved forward inputs and outputs (q, k, v, w, y, dn, m) and the
// cotangents (gy, gdn, gm):
//   delta_i = gy_i . y_i + gdn_i * dn_i,   gmh_i = gm_i - delta_i
//   a_ij  = exp(s_ij - m_i)   (s recomputed; NEG_INF where masked)
//   da_ij = gy_i . v_j + gdn_i * w_j
//   ds_ij = a_ij * da_ij + (gmh_i / c_i) * 1[s_ij == m_i]
//   dq_i = sum_j ds_ij k_j;  dk_j = sum_{g,i} ds_ij q_i;
//   dv_j = sum_{g,i} a_ij gy_i;  dw_j = sum_{g,i} a_ij gdn_i
// with c_i the number of keys of row i's whole band that tie at the max
// (JAX's reduce_max VJP splits the max's cotangent equally among ties);
// gmn_i = gmh_i / c_i, or 0 when c_i == 0 (a fully masked row).  The
// scores are recomputed in the forward's own fmaf order (dot_tile in
// h1d_band.cuh), so s == m finds exactly the forward's maximum.
//
// What bounds it on the H100: memory, as the forward.  A (query, key)
// pair costs ~6d + 4dv FLOPs against the rows' bytes read once: at nr=16,
// d=64 about 10-20 FLOP per byte, below the fp32 ridge of ~20.  The
// least time counts q, gy, y of the rows that have a live key, the key
// blocks some row reads, and every output written once.
//
// No atomics anywhere: two runs give identical bits.  Both designs stage
// only live rows and live key blocks (block_info, band_row_live in
// h1d_band.cuh) with cp.async and score on 2-row x 4-key register tiles
// in dot_tile's order (dot_tile2 runs q.k and gy.v side by side).
//   * l0_causal, l0_bidir, coarse_bidir: two kernels per call on one
//     stream (layout (b) of the two the design allowed).  A key block is
//     read by 2 (l0_causal: J, J+1; coarse_bidir: J-1, J+1) or 3 query
//     blocks, and G groups, so a fused kernel would have to sum every key
//     block over neighbouring CTAs: a cluster holds at most 8 CTAs in a
//     fixed partition, so a run of tiles would still share its edge blocks
//     with the next cluster.  Two kernels keep every sum inside one CTA in
//     a fixed order.  The dQ pass (band_dq_kernel) has the forward's grid,
//     window and lane layout and computes, per row, delta, the tie count
//     over the row's whole band (the bands combined in registers, then
//     over the row pair's lanes), gmn, ds and dq = ds @ k; dead rows get dq
//     = 0, gmn = 0 unread.  It also writes each live row's a and ds (every
//     band, key groups of 4) to a scratch tensor the wrapper allocates, so
//     every score is computed once.  The dK/dV/dW pass (band_dkvw_kernel)
//     takes one CTA per run of up to 32 keys (whole blocks; fewer where
//     the grid would not fill the card), streams its reader blocks' q, gy,
//     a and ds through shared memory, group by group, in chunks of 16-32
//     rows, skipping rows that read no live key of the CTA, and each
//     thread owns a 4-key x 4-column tile of dk or dv (and dw) summed in
//     shared memory, band by band, over the admitted rows.
//   * the sub level and coarse_causal (sub_bwd_kernel, one kernel): key
//     block J is read by query block J+1 alone, so one CTA per (b, J)
//     owns the rows of that query block (nq = nr * ratio per group) and
//     computes everything from one recomputation of each score: per row
//     delta, the tie count and gmn (the row's band is block J), dq; for
//     block J dk, dv and dw.  A dead block (no key with w > 0, and query
//     block 0) writes dq = 0, gmn = 0 and zero key gradients without
//     reading its rows; first-half rows skip the masked quadrant.  At deep
//     levels (nq >= 128 at G = 1) a block's rows split over up to 8 CTAs
//     of one thread block cluster, which add their partial dk, dv, dw
//     through distributed shared memory in rank order, so the sum is
//     fixed.
// fp32 FMA on CUDA cores (no TF32, no wgmma), expf not __expf.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "h1d_band.cuh"

namespace {

using namespace h1d;
namespace cg = cooperative_groups;

// Row layouts that may be read or written 16 bytes at a time.
enum { VEC_Q = 1, VEC_K = 2, VEC_V = 4, VEC_Y = 8, VEC_GY = 16 };
enum { VEC_DQ = 1, VEC_DK = 2, VEC_DV = 4, VEC_DW = 8 };

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// dQ pass of l0_causal, l0_bidir, coarse_bidir: the forward's grid and
// window (one CTA per (b, g, tile of tq rows)).  Per row: delta, gmh, the
// tie count over the row's whole band (every band, combined in registers
// and then over the row pair's lanes), gmn, ds and dq = ds @ k; each live
// row's a and ds go to dsa for the dK/dV/dW pass.  RY: rows of a dq
// register tile, 4 unless nr is 2.
template <int MODE, int RY>
__global__ void __launch_bounds__(BAND_THREADS)
band_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ y, const float* __restrict__ dn,
               const float* __restrict__ m, const float* __restrict__ gy,
               const float* __restrict__ gdn, const float* __restrict__ gm,
               float* __restrict__ dq, float* __restrict__ gmn,
               float* __restrict__ dsa, int G, int Lq, int Lk, int d, int dv,
               int nr, int tq, int vec_in, int vec_out) {
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
  const int qs = d4 + 4, gs = dv4 + 4, as = NB * nk4 + 4, S = NB * nk4;
  const int I0 = t0 / nr;
  const int nwb = (t0 + rows - 1) / nr - I0 + (MODE == L0_CAUSAL ? 2 : 3);
  const int nwbm = band_window_blocks(MODE, tq, nr);
  const int nkw = nwbm * nr + 4;
  const int kb0 = (I0 - 1) * nr;
  float* q_s = smem;                            // tq x qs
  float* g_s = q_s + tq * qs;                   // tq x gs: gy
  float* u_s = g_s + tq * gs;                   // tq x gs: y, then ds
  float* ds_s = u_s;                            // tq x as
  float* k_s = u_s + max(tq * gs, tq * as);     // nkw x qs
  float* v_s = k_s + nkw * qs;                  // nkw x gs
  float* w_s = v_s + nkw * gs;                  // nkw
  float* m_s = w_s + nkw;                       // tq each: m, gdn, gm / gmh, dn
  float* gdn_s = m_s + tq;
  float* gm_s = gdn_s + tq;
  float* dn_s = gm_s + tq;
  int* blk_s = reinterpret_cast<int*>(dn_s + tq);   // block_info a block
  int* row_s = blk_s + nwbm;                    // 1: the row is live
  const size_t row0 = ((size_t)b * G + g) * Lq + t0;

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
    for (int e = tid; e < rows * d; e += BAND_THREADS)
      dq[row0 * d + e] = 0.f;
    for (int r = tid; r < rows; r += BAND_THREADS) gmn[row0 + r] = 0.f;
    return;
  }

  auto src = [&](const float* base, int r, int n) -> const float* {
    return row_s[r] ? base + (row0 + r) * n : nullptr;
  };
  stage_rows(q_s, qs, rows, d, vec_in & VEC_Q,
             [&](int r) { return src(q, r, d); });
  stage_rows(g_s, gs, rows, dv, vec_in & VEC_GY,
             [&](int r) { return src(gy, r, dv); });
  stage_rows(u_s, gs, rows, dv, vec_in & VEC_Y,
             [&](int r) { return src(y, r, dv); });
  auto key_src = [&](int r, const float* base, int n) -> const float* {
    const bool lv = r < nwb * nr && (blk_s[r / nr] & 3);
    return lv ? base + ((size_t)b * Lk + kb0 + r) * n : nullptr;
  };
  stage_rows(k_s, qs, nwb * nr + 4, d, vec_in & VEC_K,
             [&](int r) { return key_src(r, k, d); });
  stage_rows(v_s, gs, nwb * nr + 4, dv, vec_in & VEC_V,
             [&](int r) { return key_src(r, v, dv); });
  // the row scalars load while the copies are in flight
  for (int r = tid; r < tq; r += BAND_THREADS) {
    const bool lv = r < rows && row_s[r];
    m_s[r] = lv ? m[row0 + r] : 0.f;
    gdn_s[r] = lv ? gdn[row0 + r] : 0.f;
    gm_s[r] = lv ? gm[row0 + r] : 0.f;
    dn_s[r] = lv ? dn[row0 + r] : 0.f;
  }
  cp_async_wait();
  __syncthreads();

  // gmh = gm - (gy . y + gdn * dn), two lanes a row
  for (int e = tid; e < 2 * tq; e += BAND_THREADS) {
    const int r = e / 2, h = e % 2;
    float part = 0.f;
    if (r < rows)
      for (int c = 4 * h; c < dv4; c += 8) {
        const float4 x = ld4(g_s + r * gs + c), z = ld4(u_s + r * gs + c);
        part = fmaf(x.x, z.x, part);
        part = fmaf(x.y, z.y, part);
        part = fmaf(x.z, z.z, part);
        part = fmaf(x.w, z.w, part);
      }
    part += __shfl_xor_sync(FULL, part, 1);
    if (h == 0 && r < rows) gm_s[r] = gm_s[r] - (part + gdn_s[r] * dn_s[r]);
  }
  __syncthreads();                              // y is read: u_s takes ds

  // scores and gy . v per (row pair, lane slot, key group): W = SLOTS *
  // nkg lanes a row pair, slot sl takes the bands sl, sl + SLOTS, ...; the
  // tie count over the whole band (the thread's bands, then the row pair's
  // lanes), gmn and ds
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
    float s[BPT][2][4], da[BPT][2][4];
    unsigned allow = 0;                         // bit (u * 2 + rr) * 4 + t
#pragma unroll
    for (int u = 0; u < BPT; ++u) {
      const int bb = sl + SLOTS * u;
      const int off = band_off(MODE, bb), wb = wb0 + off;
      int glo = 0, ghi = 0;
      if (bb < NB) band_group_range<MODE>(off, p, 2, nr, &glo, &ghi);
      const bool need = (f0 | f1) && bb < NB && (blk_s[wb] & 3) &&
                        kl >= 4 * glo && kl < 4 * ghi;
      if (need) {
        const int kr = wb * nr + kl;
        if (d4 == dv4) {
          dot_tile2<2>(q_s + r0 * qs, qs, k_s + kr * qs, qs, g_s + r0 * gs,
                       gs, v_s + kr * gs, gs, d4, s[u], da[u]);
        } else {
          dot_tile<2>(q_s + r0 * qs, qs, k_s + kr * qs, qs, d4, s[u]);
          dot_tile<2>(g_s + r0 * gs, gs, v_s + kr * gs, gs, dv4, da[u]);
        }
      }
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
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_r = m_s[r0 + rr], gdn_r = gdn_s[r0 + rr];
      unsigned hit = 0;
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < BPT; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const unsigned bit = 1u << ((u * 2 + rr) * 4 + t);
          const float sc = (allow & bit) ? s[u][rr][t] : NEG_INF;
          s[u][rr][t] = expf(sc - m_r);                    // now a
          if (sc == m_r) {
            hit |= bit;
            ++cnt;
          }
        }
      for (int o = 1; o < W; o <<= 1)
        cnt += __shfl_xor_sync(FULL, cnt, lane_xor(o, W));
      const float gmn_r = cnt > 0 ? gm_s[r0 + rr] / (float)cnt : 0.f;
#pragma unroll
      for (int u = 0; u < BPT; ++u) {
        const int bb = sl + SLOTS * u;
        if (bb >= NB) continue;
        const float* wk = w_s + (wb0 + band_off(MODE, bb)) * nr + kl;
        float ds[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const unsigned bit = 1u << ((u * 2 + rr) * 4 + t);
          ds[t] = (allow & bit)
                      ? s[u][rr][t] * (da[u][rr][t] + gdn_r * wk[t]) +
                            ((hit & bit) ? gmn_r : 0.f)
                      : 0.f;
        }
        if (active) {
          const float4 d4v = make_float4(ds[0], ds[1], ds[2], ds[3]);
          *reinterpret_cast<float4*>(ds_s + (r0 + rr) * as + bb * nk4 + kl) =
              d4v;
          if (rr ? f1 : f0) {                   // for the dK/dV/dW pass
            float* xr = dsa + (row0 + r0 + rr) * (2 * S) + bb * nk4 + kl;
            *reinterpret_cast<float4*>(xr) = d4v;
            *reinterpret_cast<float4*>(xr + S) =
                make_float4(s[u][rr][0], s[u][rr][1], s[u][rr][2],
                            s[u][rr][3]);
          }
        }
      }
      if (active && j == 0) gmn[row0 + r0 + rr] = gmn_r;
    }
  }
  __syncthreads();

  // dq = ds @ k: RY rows x 4 columns a thread, over each live band's
  // admitted key groups
  const int ncg = d4 / 4;
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
        apply_tile_add<RY>(ds_s + r0 * as + bb * nk4 + 4 * glo, as,
                           k_s + (wb * nr + 4 * glo) * qs + c, qs,
                           4 * (ghi - glo), acc);
    }
#pragma unroll
    for (int rr = 0; rr < RY; ++rr)
      store4(dq + (row0 + r0 + rr) * d, c, d, vec_out & VEC_DQ, acc[rr]);
  }
}

// dK/dV/dW pass of l0_causal, l0_bidir, coarse_bidir: one CTA per (b, run
// of nkb key blocks J0 ..).  Its readers are the query blocks J0 - 1 (not
// in l0_causal) to J0 + nkb, every group g; the CTA streams them through
// shared memory in chunks of tq rows (g, then rows, in order): q, gy and
// the a and ds the dQ pass wrote for the row (dsa: ds then a of every
// band), and adds ds^T q, a^T gy and a^T gdn into its keys' sums in
// shared memory, each key's sum in one fixed order.  Rows with no live
// key among the CTA's are not read.
template <int MODE>
__global__ void __launch_bounds__(BAND_THREADS)
band_dkvw_kernel(const float* __restrict__ q, const float* __restrict__ w,
                 const float* __restrict__ gy, const float* __restrict__ gdn,
                 const float* __restrict__ dsa, float* __restrict__ dk,
                 float* __restrict__ dvo, float* __restrict__ dw, int G,
                 int Lq, int Lk, int d, int dv, int nr, int nkb, int tq,
                 int vec_in, int vec_out) {
  constexpr int NB = MODE == L0_BIDIR ? 3 : 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int nbk = Lk / nr, nbq = Lq / nr;
  const int J0 = blockIdx.x * nkb;
  const int nkh = min(nkb, nbk - J0);           // key blocks of this CTA
  const int keys = nkh * nr;
  const int nkg = key_groups(nr), nk4 = 4 * nkg;
  const int d4 = round4(d), dv4 = round4(dv);
  const int qs = d4 + 4, gs = dv4 + 4;
  const int S = NB * nk4, xs = 2 * S + 4;       // a row of dsa: ds | a
  const int nk = nkb * nk4;
  const size_t kb = (size_t)b * Lk + (size_t)J0 * nr;   // first key
  float* P = smem;                    // dk nk x d4, dv nk x dv4, dw nk
  float* q_s = P + nk * (d4 + dv4 + 1);         // tq x qs
  float* g_s = q_s + tq * qs;                   // tq x gs: gy
  float* x_s = g_s + tq * gs;                   // tq x xs: ds | a
  float* w_s = x_s + tq * xs;                   // nkb * nr
  float* gdn_s = w_s + nkb * nr;                // tq
  int* blk_s = reinterpret_cast<int*>(gdn_s + tq);  // block_info a block
  int* row_s = blk_s + nkb;                     // 1: reads a live key here

  for (int r = tid; r < nkb * nr; r += BAND_THREADS)
    w_s[r] = r < keys ? w[kb + r] : 0.f;
  __syncthreads();
  int flag = 0;
  if (tid < nkb) {
    flag = tid < nkh ? block_info(w_s + tid * nr, nr) : 0;
    blk_s[tid] = flag;
  }
  if (!__syncthreads_or(flag & 3)) {
    // no key here has w > 0: every gradient of these keys is 0
    for (int e = tid; e < keys * d; e += BAND_THREADS) dk[kb * d + e] = 0.f;
    for (int e = tid; e < keys * dv; e += BAND_THREADS)
      dvo[kb * dv + e] = 0.f;
    for (int e = tid; e < keys; e += BAND_THREADS) dw[kb + e] = 0.f;
    return;
  }
  for (int e = tid; e < nk * (d4 + dv4 + 1); e += BAND_THREADS) P[e] = 0.f;
  auto info = [&](int J) { return J >= J0 && J < J0 + nkh ? blk_s[J - J0]
                                                           : 0; };

  const int rlo = max(0, J0 - (MODE == L0_CAUSAL ? 0 : 1)) * nr;
  const int rhi = min(nbq, J0 + nkh + 1) * nr;
  const int nd4 = d4 / 4, nv4 = dv4 / 4;
  for (int g = 0; g < G; ++g) {
    const size_t rowg = ((size_t)b * G + g) * Lq;
    for (int f0 = rlo; f0 < rhi; f0 += tq) {
      const int rows = min(tq, rhi - f0);
      int live = 0;
      for (int r = tid; r < rows; r += BAND_THREADS) {
        const int i = f0 + r, I = i / nr;
        const int f = band_row_live<MODE>(i - I * nr, nr, info(I - 1),
                                          info(I), info(I + 1));
        row_s[r] = f;
        live |= f;
      }
      if (!__syncthreads_or(live)) continue;
      auto src = [&](const float* base, int r, int n) -> const float* {
        return row_s[r] ? base + (rowg + f0 + r) * n : nullptr;
      };
      stage_rows(q_s, qs, rows, d, vec_in & VEC_Q,
                 [&](int r) { return src(q, r, d); });
      stage_rows(g_s, gs, rows, dv, vec_in & VEC_GY,
                 [&](int r) { return src(gy, r, dv); });
      stage_rows(x_s, xs, rows, 2 * S, true,
                 [&](int r) { return src(dsa, r, 2 * S); });
      for (int r = tid; r < rows; r += BAND_THREADS)
        gdn_s[r] = row_s[r] ? gdn[rowg + f0 + r] : 0.f;
      cp_async_wait();
      __syncthreads();

      // dk += ds^T q, dv += a^T gy, dw += a^T gdn: a thread owns 4 keys x 4
      // columns of dk or dv (the dv tile of columns 0..3 also keeps dw);
      // per band, the reader block's rows that band_mask admits, in order.
      // Dead rows add exact zeros (their q, gy, a and ds are zero).
      for (int e = tid; e < nkh * nkg * (nd4 + nv4); e += BAND_THREADS) {
        const bool isk = e < nkh * nkg * nd4;
        const int e2 = isk ? e : e - nkh * nkg * nd4;
        const int n4 = isk ? nd4 : nv4;
        const int grp = e2 / n4, c = (e2 - grp * n4) * 4;
        const int rel = grp / nkg, kg = grp - rel * nkg;
        if (!(blk_s[rel] & 3)) continue;        // dead block: sums stay 0
        const float* sp = x_s + (isk ? 0 : S) + 4 * kg;
        const float* xp = (isk ? q_s : g_s) + c;
        const int rs = isk ? qs : gs, ps = isk ? d4 : dv4;
        float* pp = (isk ? P : P + nk * d4) + (rel * nk4 + 4 * kg) * ps + c;
        float* pw = P + nk * (d4 + dv4) + rel * nk4 + 4 * kg;
        float acc[4][4], accw[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 x = ld4(pp + t * ps);
          acc[t][0] = x.x;
          acc[t][1] = x.y;
          acc[t][2] = x.z;
          acc[t][3] = x.w;
          accw[t] = pw[t];
        }
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
          const int off = band_off(MODE, bb), I = J0 + rel - off;
          int plo, phi;
          band_row_range<MODE>(off, kg, nr, &plo, &phi);
          const int lo = max(I * nr + plo, f0) - f0;
          const int hi = min(I * nr + phi, f0 + rows) - f0;
#pragma unroll 4
          for (int i = lo; i < hi; ++i) {
            const float4 sv = ld4(sp + i * xs + bb * nk4);
            const float4 xv = ld4(xp + i * rs);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const float st = lane4(sv, t);
              acc[t][0] = fmaf(st, xv.x, acc[t][0]);
              acc[t][1] = fmaf(st, xv.y, acc[t][1]);
              acc[t][2] = fmaf(st, xv.z, acc[t][2]);
              acc[t][3] = fmaf(st, xv.w, acc[t][3]);
            }
            if (!isk && c == 0) {               // dw rides on the dv tile
              const float gd = gdn_s[i];
#pragma unroll
              for (int t = 0; t < 4; ++t)
                accw[t] = fmaf(lane4(sv, t), gd, accw[t]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          *reinterpret_cast<float4*>(pp + t * ps) =
              make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
          if (!isk && c == 0) pw[t] = accw[t];
        }
      }
      __syncthreads();                          // the next chunk reuses rows
    }
  }

  // this CTA's keys: dk and dv rows 4 columns an item, then dw
  for (int e = tid; e < keys * (nd4 + nv4); e += BAND_THREADS) {
    const bool isk = e < keys * nd4;
    const int e2 = isk ? e : e - keys * nd4, n4 = isk ? nd4 : nv4;
    const int t = e2 / n4, c = (e2 - t * n4) * 4;
    const int pr = t / nr * nk4 + t % nr;       // the key's row of P
    float x[4];
    const float4 p4 = ld4((isk ? P + pr * d4 : P + nk * d4 + pr * dv4) + c);
    x[0] = p4.x;
    x[1] = p4.y;
    x[2] = p4.z;
    x[3] = p4.w;
    if (isk)
      store4(dk + (kb + t) * d, c, d, vec_out & VEC_DK, x);
    else
      store4(dvo + (kb + t) * dv, c, dv, vec_out & VEC_DV, x);
  }
  for (int t = tid; t < keys; t += BAND_THREADS)
    dw[kb + t] = P[nk * (d4 + dv4) + t / nr * nk4 + t % nr];
}

template <int MODE, int RY>
int launch_ry(const float* q, const float* k, const float* v, const float* w,
              const float* y, const float* dn, const float* m,
              const float* gy, const float* gdn, const float* gm, float* dq,
              float* gmn, float* dk, float* dv_out, float* dw, float* dsa,
              int B, int G, int L, int d, int dv, int nr, int tq, int nkb,
              int tk, cudaStream_t stream) {
  const size_t smem_dq = band_dq_floats(MODE, tq, d, dv, nr) * sizeof(float);
  const size_t smem_kv =
      band_dkvw_floats(MODE, nkb, tk, d, dv, nr) * sizeof(float);
  int e = set_smem(band_dq_kernel<MODE, RY>, smem_dq);
  if (e) return e;
  e = set_smem(band_dkvw_kernel<MODE>, smem_kv);
  if (e) return e;
  const int vec_in = (aligned16(q) && d % 4 == 0 ? VEC_Q : 0) |
                     (aligned16(k) && d % 4 == 0 ? VEC_K : 0) |
                     (aligned16(v) && dv % 4 == 0 ? VEC_V : 0) |
                     (aligned16(y) && dv % 4 == 0 ? VEC_Y : 0) |
                     (aligned16(gy) && dv % 4 == 0 ? VEC_GY : 0);
  const int vec_out = (aligned16(dq) && d % 4 == 0 ? VEC_DQ : 0) |
                      (aligned16(dk) && d % 4 == 0 ? VEC_DK : 0) |
                      (aligned16(dv_out) && dv % 4 == 0 ? VEC_DV : 0);
  const int nbk = L / nr;
  const dim3 grid_dq(G * ((L + tq - 1) / tq), B);
  const dim3 grid_kv((nbk + nkb - 1) / nkb, B);
  note_grid(grid_dq.x, grid_dq.y, grid_kv.x, grid_kv.y);
  // Lq and Lk stay two arguments: as one, the body compiled to slower code
  band_dq_kernel<MODE, RY><<<grid_dq, BAND_THREADS, smem_dq, stream>>>(
      q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, dsa, G, L, L, d, dv, nr, tq,
      vec_in, vec_out);
  e = (int)cudaGetLastError();
  if (e) return e;
  band_dkvw_kernel<MODE><<<grid_kv, BAND_THREADS, smem_kv, stream>>>(
      q, w, gy, gdn, dsa, dk, dv_out, dw, G, L, L, d, dv, nr, nkb, tk, vec_in,
      vec_out);
  return (int)cudaGetLastError();
}

// nr a power of two in [2, BAND_MAX_NR]; any d and dv whose 16-row tiles
// fit the card's shared memory (band_fwd_tq, band_dkvw_tiles).
template <int MODE>
int launch(const float* q, const float* k, const float* v, const float* w,
           const float* y, const float* dn, const float* m, const float* gy,
           const float* gdn, const float* gm, float* dq, float* gmn,
           float* dk, float* dv_out, float* dw, float* dsa, int B, int G,
           int L, int d, int dv, int nr, cudaStream_t stream) {
  if (d < 1 || dv < 1 || nr < 2 || nr > BAND_MAX_NR || (nr & (nr - 1)) ||
      L % nr || dsa == nullptr || !aligned16(dsa))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || G == 0 || L == 0) return 0;
  const int tq = band_fwd_tq(MODE, B, G, L, d, dv, nr, true);
  int nkb, tk;
  band_dkvw_tiles(MODE, B, L, d, dv, nr, &nkb, &tk);
  if (tq == 0 || tk == 0) return (int)cudaErrorInvalidValue;
  if (nr >= 4)
    return launch_ry<MODE, 4>(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, dk,
                              dv_out, dw, dsa, B, G, L, d, dv, nr, tq, nkb,
                              tk, stream);
  return launch_ry<MODE, 2>(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, dk,
                            dv_out, dw, dsa, B, G, L, d, dv, nr, tq, nkb, tk,
                            stream);
}

// ---------------------------------------------------------------------------
// sub level and coarse_causal
// ---------------------------------------------------------------------------

// Shared floats of sub_bwd_kernel at tq rows a tile (layout below).
size_t sub_bwd_floats(int tq, int d, int dv, int nr) {
  const size_t d4 = round4(d), dv4 = round4(dv), nk4 = 4 * key_groups(nr);
  const size_t qs = d4 + 4, gs = dv4 + 4, as = nk4 + 4;
  const size_t uni = tq * gs > 2 * tq * as ? tq * gs : 2 * tq * as;
  return tq * qs + tq * gs + uni + nk4 * qs + nk4 * gs +
         nk4 * (d4 + dv4 + 1) + nk4 + 6 * (size_t)tq;
}

// Grid (NB * S, B), NB query blocks, S CTAs a block (one cluster): CTA
// (I, split) owns rows [split * Rs, (split + 1) * Rs) of the G * nq rows
// (g, p) of query block I, in tiles of tq, and key block J = I - 1.
// RY: rows of a dq register tile, 4 unless a query block has 2 rows.
template <int RY>
__global__ void __launch_bounds__(SUB_THREADS)
sub_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ y, const float* __restrict__ dn,
               const float* __restrict__ m, const float* __restrict__ gy,
               const float* __restrict__ gdn, const float* __restrict__ gm,
               float* __restrict__ dq, float* __restrict__ gmn,
               float* __restrict__ dk, float* __restrict__ dvo,
               float* __restrict__ dw, int G, int Lq, int Lk, int d, int dv,
               int nr, int ratio, int S, int tq, int vec_in, int vec_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int I = blockIdx.x / S, split = blockIdx.x - I * S;
  const int J = I - 1;
  const int nq = nr * ratio, half = nr / 2, hs = nq / 2;
  const int nkg = key_groups(nr), nkgh = key_groups(half), nk4 = 4 * nkg;
  const int d4 = round4(d), dv4 = round4(dv);
  const int qs = d4 + 4, gs = dv4 + 4, as = nk4 + 4;
  const int Rs = G * nq / S;
  const int f_begin = split * Rs;
  const size_t kb = (size_t)b * Lk;           // first key of batch row b

  float* q_s = smem;                          // tq x qs
  float* g_s = q_s + tq * qs;                 // tq x gs: gy
  float* u_s = g_s + tq * gs;                 // tq x gs: y, then a and ds
  float* a_s = u_s;                           // tq x as
  float* ds_s = a_s + tq * as;                // tq x as
  float* k_s = u_s + max(tq * gs, 2 * tq * as);   // nk4 x qs
  float* v_s = k_s + nk4 * qs;                // nk4 x gs
  float* P = v_s + nk4 * gs;                  // dk nk4 x d4, dv nk4 x dv4, dw
  float* w_s = P + nk4 * (d4 + dv4 + 1);      // nk4
  float* m_s = w_s + nk4;                     // tq each: m, gdn, gm / gmh, dn
  float* gdn_s = m_s + tq;
  float* gm_s = gdn_s + tq;
  float* dn_s = gm_s + tq;
  int* row_s = reinterpret_cast<int*>(dn_s + tq);   // 1 live, 2 first half
  int* id_s = row_s + tq;                     // the row's index in (B,G,Lq)

  // key block J's weights; 1 = a first-half key has w > 0, 2 = some key
  for (int r = tid; r < nk4; r += SUB_THREADS) {
    const int j = J * nr + r;
    w_s[r] = (J >= 0 && r < nr && j < Lk) ? w[kb + j] : 0.f;
  }
  __syncthreads();
  int flag = 0;
  for (int j = 0; j < nr; ++j)
    if (w_s[j] > 0.f) flag |= j < half ? 3 : 2;

  if (flag == 0) {
    // no row of block I has a key: dq = 0, gmn = 0 on this CTA's rows,
    // and zero gradients for key block J (for I = 0: the last key block,
    // which no query block reads), this CTA's share
    const int nq_here = min(nq, Lq - I * nq);
    for (int e = tid; e < Rs * (d + 1); e += SUB_THREADS) {
      const int r = e / (d + 1), c = e - r * (d + 1);
      const int f = f_begin + r, g = f / nq, p = f - g * nq;
      if (p >= nq_here) continue;
      const size_t id = ((size_t)b * G + g) * Lq + I * nq + p;
      if (c < d)
        dq[id * d + c] = 0.f;
      else
        gmn[id] = 0.f;
    }
    const int zb = I == 0 ? (Lk + nr - 1) / nr - 1 : J;
    const int nkeys = min(nr, Lk - zb * nr);
    const int E = nkeys * (d + dv + 1);      // dk rows, dv rows, dw
    for (int e = split * E / S + tid; e < (split + 1) * E / S;
         e += SUB_THREADS) {
      if (e < nkeys * d)
        dk[(kb + zb * nr) * d + e] = 0.f;
      else if (e < nkeys * (d + dv))
        dvo[(kb + zb * nr) * dv + e - nkeys * d] = 0.f;
      else
        dw[kb + zb * nr + e - nkeys * (d + dv)] = 0.f;
    }
    return;
  }

  for (int e = tid; e < nk4 * (d4 + dv4 + 1); e += SUB_THREADS) P[e] = 0.f;
  stage_rows(k_s, qs, nk4, d, vec_in & VEC_K, [&](int r) -> const float* {
    return r < nr ? k + (kb + J * nr + r) * d : nullptr;
  });
  stage_rows(v_s, gs, nk4, dv, vec_in & VEC_V, [&](int r) -> const float* {
    return r < nr ? v + (kb + J * nr + r) * dv : nullptr;
  });
  const int nd4 = d4 / 4, nv4 = dv4 / 4;

  for (int f0 = f_begin; f0 < f_begin + Rs; f0 += tq) {
    const int rows = min(tq, f_begin + Rs - f0);
    for (int r = tid; r < tq; r += SUB_THREADS) {
      int fl = 0;
      if (r < rows) {
        const int f = f0 + r, g = f / nq, p = f - g * nq;
        const bool first = p < hs;
        fl = (first ? 2 : 0) | ((flag & (first ? 1 : 2)) ? 1 : 0);
        id_s[r] = (b * G + g) * Lq + I * nq + p;
      }
      row_s[r] = fl;
    }
    __syncthreads();
    auto src = [&](const float* base, int r, int n) -> const float* {
      return (row_s[r] & 1) ? base + (size_t)id_s[r] * n : nullptr;
    };
    stage_rows(q_s, qs, tq, d, vec_in & VEC_Q,
               [&](int r) { return src(q, r, d); });
    stage_rows(g_s, gs, tq, dv, vec_in & VEC_GY,
               [&](int r) { return src(gy, r, dv); });
    stage_rows(u_s, gs, tq, dv, vec_in & VEC_Y,
               [&](int r) { return src(y, r, dv); });
    // the row scalars load while the copies are in flight
    for (int r = tid; r < tq; r += SUB_THREADS) {
      const bool live = row_s[r] & 1;
      const int id = live ? id_s[r] : 0;
      m_s[r] = live ? m[id] : 0.f;
      gdn_s[r] = live ? gdn[id] : 0.f;
      gm_s[r] = live ? gm[id] : 0.f;
      dn_s[r] = live ? dn[id] : 0.f;
    }
    cp_async_wait();
    __syncthreads();

    // gmh = gm - (gy . y + gdn * dn), two lanes a row
    for (int e = tid; e < 2 * tq; e += SUB_THREADS) {
      const int r = e / 2, h = e % 2;
      float part = 0.f;
      for (int c = 4 * h; c < dv4; c += 8) {
        const float4 x = ld4(g_s + r * gs + c), z = ld4(u_s + r * gs + c);
        part = fmaf(x.x, z.x, part);
        part = fmaf(x.y, z.y, part);
        part = fmaf(x.z, z.z, part);
        part = fmaf(x.w, z.w, part);
      }
      part += __shfl_xor_sync(FULL, part, 1);
      if (h == 0) gm_s[r] = gm_s[r] - (part + gdn_s[r] * dn_s[r]);
    }
    __syncthreads();                          // y is read: u_s takes a, ds

    // scores and gy . v per (row pair, key group); tie count, gmn, a, ds
    const int p0 = f0 % nq;
    const int total = sub_pair_total(rows, p0, nq, nkg, nkgh);
    for (int base = 0; base < total; base += SUB_THREADS) {
      const PairItem it = sub_pair_item(base + tid, rows, p0, nq, nkg, nkgh);
      const int r0 = it.row, kl = 4 * it.kg;
      const int* fl = row_s + r0;
      float s[2][4], da[2][4];
      if (it.active && ((fl[0] | fl[1]) & 1)) {
        if (d4 == dv4) {
          dot_tile2<2>(q_s + r0 * qs, qs, k_s + kl * qs, qs, g_s + r0 * gs,
                       gs, v_s + kl * gs, gs, d4, s, da);
        } else {
          dot_tile<2>(q_s + r0 * qs, qs, k_s + kl * qs, qs, d4, s);
          dot_tile<2>(g_s + r0 * gs, gs, v_s + kl * gs, gs, dv4, da);
        }
      } else {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int t = 0; t < 4; ++t) s[rr][t] = da[rr][t] = 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int f = it.active ? fl[rr] : 0;
        const int lim = (f & 2) ? half : nr;
        const float m_r = m_s[r0 + rr], gdn_r = gdn_s[r0 + rr];
        bool hit[4];
        int cnt = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool allow = (f & 1) && kl + t < lim && w_s[kl + t] > 0.f;
          const float sc = allow ? s[rr][t] : NEG_INF;
          s[rr][t] = expf(sc - m_r);                       // now a
          hit[t] = sc == m_r;
          cnt += hit[t];
        }
        for (int off = 1; off < nkg; off <<= 1) {
          const int o = __shfl_xor_sync(FULL, cnt, off);
          if (off < it.width) cnt += o;
        }
        const float gmn_r = cnt > 0 ? gm_s[r0 + rr] / (float)cnt : 0.f;
        float ds[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float dat = da[rr][t] + gdn_r * w_s[kl + t];
          ds[t] = s[rr][t] * dat + gmn_r * (hit[t] ? 1.f : 0.f);
        }
        if (it.active) {
          *reinterpret_cast<float4*>(a_s + (r0 + rr) * as + kl) =
              make_float4(s[rr][0], s[rr][1], s[rr][2], s[rr][3]);
          *reinterpret_cast<float4*>(ds_s + (r0 + rr) * as + kl) =
              make_float4(ds[0], ds[1], ds[2], ds[3]);
          if (it.kg == 0) gmn[id_s[r0 + rr]] = gmn_r;
        }
      }
    }
    __syncthreads();

    // dq = ds @ k: RY rows x 4 columns a thread
    for (int e = tid; e < rows / RY * nd4; e += SUB_THREADS) {
      const int rg = e / nd4, c = (e - rg * nd4) * 4;
      const int r0 = rg * RY;
      const bool first = row_s[r0] & row_s[r0 + RY - 1] & 2;
      float acc[RY][4];
      apply_tile<RY>(ds_s + r0 * as, as, k_s + c, qs,
                     4 * (first ? nkgh : nkg), acc);
#pragma unroll
      for (int rr = 0; rr < RY; ++rr)
        store4(dq + (size_t)id_s[r0 + rr] * d, c, d, vec_out & VEC_DQ,
               acc[rr]);
    }

    // dk += ds^T q, dv += a^T gy, dw += a^T gdn: a thread owns 4 keys x 4
    // columns of dk or dv (the dv tile of columns 0..3 also keeps dw)
    for (int e = tid; e < nkg * (nd4 + nv4); e += SUB_THREADS) {
      const bool isk = e < nkg * nd4;
      const int e2 = isk ? e : e - nkg * nd4;
      const int n4 = isk ? nd4 : nv4;
      const int kg = e2 / n4, c = (e2 - kg * n4) * 4;
      const float* sp = (isk ? ds_s : a_s) + 4 * kg;
      const float* xp = (isk ? q_s : g_s) + c;
      const int xs = isk ? qs : gs, ps = isk ? d4 : dv4;
      float* pp = (isk ? P : P + nk4 * d4) + 4 * kg * ps + c;
      float* pw = P + nk4 * (d4 + dv4) + 4 * kg;
      float acc[4][4], accw[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 x = ld4(pp + t * ps);
        acc[t][0] = x.x;
        acc[t][1] = x.y;
        acc[t][2] = x.z;
        acc[t][3] = x.w;
        accw[t] = pw[t];
      }
      // the rows that scored this key group: every row, or for a group
      // past the first half's only the second-half rows.  Dead rows add
      // exact zeros (their q, gy, a and ds are zero).
      int s0 = 0, step = rows, len = rows;
      if (kg >= nkgh) {
        if (hs < rows) {
          s0 = hs;
          step = 2 * hs;
          len = hs;
        } else if (p0 < hs) {
          len = 0;
        }
      }
      for (int seg = s0; seg < rows; seg += step) {
#pragma unroll 4
        for (int i = seg; i < seg + len; ++i) {
          const float4 sv = ld4(sp + i * as), xv = ld4(xp + i * xs);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float st = lane4(sv, t);
            acc[t][0] = fmaf(st, xv.x, acc[t][0]);
            acc[t][1] = fmaf(st, xv.y, acc[t][1]);
            acc[t][2] = fmaf(st, xv.z, acc[t][2]);
            acc[t][3] = fmaf(st, xv.w, acc[t][3]);
          }
          if (!isk) {                         // dw rides on the dv tiles
            const float gd = gdn_s[i];
#pragma unroll
            for (int t = 0; t < 4; ++t)
              accw[t] = fmaf(lane4(sv, t), gd, accw[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        *reinterpret_cast<float4*>(pp + t * ps) =
            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
        if (!isk && c == 0) pw[t] = accw[t];
      }
    }
    __syncthreads();                          // the next tile reuses the rows
  }

  // key block J's gradients, 4 floats an item (dk rows, dv rows, dw):
  // this CTA's P, or the cluster's sum in rank order through distributed
  // shared memory, each CTA writing a share
  const int nki = nr * nd4, nvi = nr * nv4, E4 = nki + nvi + key_groups(nr);
  auto item = [&](int e, int* t, int* c) -> int {   // P offset
    if (e < nki) {
      *t = e / nd4;
      *c = (e - *t * nd4) * 4;
      return *t * d4 + *c;
    }
    if (e < nki + nvi) {
      *t = (e - nki) / nv4;
      *c = (e - nki - *t * nv4) * 4;
      return nk4 * d4 + *t * dv4 + *c;
    }
    *t = 0;
    *c = (e - nki - nvi) * 4;
    return nk4 * (d4 + dv4) + *c;
  };
  auto write = [&](int e, int t, int c, const float (&x)[4]) {
    if (e < nki)
      store4(dk + (kb + J * nr + t) * d, c, d, vec_out & VEC_DK, x);
    else if (e < nki + nvi)
      store4(dvo + (kb + J * nr + t) * dv, c, dv, vec_out & VEC_DV, x);
    else
      store4(dw + kb + J * nr, c, nr, vec_out & VEC_DW, x);
  };
  int lo = 0, hi = E4, rank = 0;
  if (S > 1) {
    cg::this_cluster().sync();
    rank = (int)cg::this_cluster().block_rank();
    lo = rank * E4 / S;
    hi = (rank + 1) * E4 / S;
  }
  for (int e = lo + tid; e < hi; e += SUB_THREADS) {
    int t, c;
    const int off = item(e, &t, &c);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < S; ++r) {
      const float* pr = S > 1 ? cg::this_cluster().map_shared_rank(P, r) : P;
      const float4 p = ld4(pr + off);
      x[0] += p.x;
      x[1] += p.y;
      x[2] += p.z;
      x[3] += p.w;
    }
    write(e, t, c, x);
  }
  if (S > 1) cg::this_cluster().sync();       // peers' P stays until read
}

template <int RY>
int launch_sub_ry(const float* q, const float* k, const float* v,
                  const float* w, const float* y, const float* dn,
                  const float* m, const float* gy, const float* gdn,
                  const float* gm, float* dq, float* gmn, float* dk,
                  float* dv_out, float* dw, int B, int G, int Lq, int Lk,
                  int d, int dv, int nr, int ratio, int S, int tq,
                  size_t smem, cudaStream_t stream) {
  int e = set_smem(sub_bwd_kernel<RY>, smem);
  if (e) return e;
  const int vec_in = (aligned16(q) && d % 4 == 0 ? VEC_Q : 0) |
                     (aligned16(k) && d % 4 == 0 ? VEC_K : 0) |
                     (aligned16(v) && dv % 4 == 0 ? VEC_V : 0) |
                     (aligned16(y) && dv % 4 == 0 ? VEC_Y : 0) |
                     (aligned16(gy) && dv % 4 == 0 ? VEC_GY : 0);
  const int vec_out = (aligned16(dq) && d % 4 == 0 ? VEC_DQ : 0) |
                      (aligned16(dk) && d % 4 == 0 ? VEC_DK : 0) |
                      (aligned16(dv_out) && dv % 4 == 0 ? VEC_DV : 0) |
                      (aligned16(dw) && nr % 4 == 0 ? VEC_DW : 0);
  const int nb = (Lk + nr - 1) / nr;          // query blocks = key blocks
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * S, B);
  note_grid(cfg.gridDim.x, cfg.gridDim.y);
  cfg.blockDim = dim3(SUB_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  e = (int)cudaLaunchKernelEx(&cfg, sub_bwd_kernel<RY>, q, k, v, w, y, dn, m,
                              gy, gdn, gm, dq, gmn, dk, dv_out, dw, G, Lq, Lk,
                              d, dv, nr, ratio, S, tq, vec_in, vec_out);
  if (e) return e;
  return (int)cudaGetLastError();
}

// nr a power of two in [2, 64], Lq = Lk * ratio; tiles of 64 rows, or 32
// or 16 where the shared memory of 64 exceeds the card's 227 KB.
int launch_sub(const float* q, const float* k, const float* v,
               const float* w, const float* y, const float* dn,
               const float* m, const float* gy, const float* gdn,
               const float* gm, float* dq, float* gmn, float* dk,
               float* dv_out, float* dw, int B, int G, int Lq, int Lk, int d,
               int dv, int nr, int ratio, cudaStream_t stream) {
  if (d < 1 || dv < 1 || nr < 2 || nr > SUB_TQ || (nr & (nr - 1)) ||
      ratio < 1 || Lq != Lk * ratio)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || G == 0 || Lq == 0) return 0;
  // tiles of a power of two rows in [16, 64]: no more than a CTA's rows,
  // and within the card's 227 KB of shared memory
  const int S = sub_bwd_splits(G, nr * ratio);
  int tq = SUB_TQ;
  while (tq > 16 && (tq / 2 >= G * nr * ratio / S ||
                     sub_bwd_floats(tq, d, dv, nr) * sizeof(float) > 232448))
    tq /= 2;
  const size_t smem = sub_bwd_floats(tq, d, dv, nr) * sizeof(float);
  if ((nr * ratio < Lq ? nr * ratio : Lq) >= 4)
    return launch_sub_ry<4>(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, dk,
                            dv_out, dw, B, G, Lq, Lk, d, dv, nr, ratio, S, tq,
                            smem, stream);
  return launch_sub_ry<2>(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, dk,
                          dv_out, dw, B, G, Lq, Lk, d, dv, nr, ratio, S, tq,
                          smem, stream);
}

// ---------------------------------------------------------------------------
// l0_causal, streamed (h1d_band_bwd_stream)
// ---------------------------------------------------------------------------
//
// Replaces band_attention_bwd (repro/kernels/h1d_block_bwd.py:541) in
// l0_causal where the staged bodies cannot hold the key window: a sliding
// window's block (nr = 1024 at d = 256, gemma3-4b's local layers), the
// backward of band_stream_kernel (h1d_block.cu).  Row i admits the keys
// (i / nr - 1) * nr .. i with w > 0, one contiguous range; key j is read
// by the rows j .. (j / nr + 2) * nr - 1 of every group.
//
// What bounds it: operations, as the streamed forward (a key row is read
// by up to 2 nr rows of each group; some 500 FLOPs a byte at nr = 1024,
// d = 256 against the fp32 ridge of 20).  Two kernels on one stream, the
// reference's own two passes (_dq_kernel, _dkvw_kernel), with no scratch
// between them but gmn (B, G, L), no atomics and every sum in a fixed
// order, so two calls give identical bits.  Their first form
// swept the dQ window twice (the tie count c comes before any ds) on
// 1-row x 4-key score tiles and ran at 8.6x the bound; the phase trace
// put 30 % of dQ in the tie sweep and most of both passes in scores.
//   * stream_dq_kernel: one CTA per (b, g, tile of STREAM_TQ rows), 256
//     threads, the forward's stream_slot order.  q and gy stay resident;
//     gmh = gm - (gy . y + gdn * dn) reads y once from device memory.  The
//     window's live key tiles (STREAM_DQ_TK keys, listed as the forward
//     lists them) stream through once.  Warps 0-3 score q . k and warps
//     4-7 gy . v, each on 4-row x 4-key register tiles (dot_tile_rk; a
//     warp doing both on 2 x 4 tiles would load half again as many words
//     a FMA: tools/fma_probe.py runs 2 x 4 tiles at 38 % of the fp32
//     peak on the H100, 4 x 4 at 57 %) into shared memory, s and
//     da + gdn w; then every warp forms ds = a (da + gdn w) of its 8 rows
//     and counts their ties, and all 8 warps add ds @ k into a register
//     tile of 8 rows x 8 columns a lane (lane_tile), each key tile's terms
//     summed apart before they join dq (the plain version's
//     SUM_KEYS chunks).  The tie term (gmh / c) 1[s == m] needs c, known
//     only at the window's end, so it is added after the sweep as gmn *
//     (sum of the tied k): each row counts its ties and lists the first
//     STREAM_TIES tied keys in key order (ballots inside the scoring
//     warp); a row with more ties (rare past the argmax itself) rescans
//     its window, scoring each key in dot_tile's order.  The values of
//     tile n + 1 load during ds @ k of tile n, the keys after it.
//   * stream_dkvw_kernel: one CTA per (b, STREAM_KV_TK keys), the longest
//     reader ranges (keys early in their block) first.  Its keys and
//     values stay resident while the reader rows of every group (g, then
//     rows in order) stream through in chunks of STREAM_KV_TR rows (q,
//     gy, m, gdn, gmn).  Warps 0-3 score q . k, warps 4-7 gy . v (4 x 4
//     tiles, as in dQ), every warp forms a and ds of 8 rows, kept
//     key-major in shared memory; ds^T q (the first 128 threads) and a^T
//     gy (the others) are register tiles of 8 keys x 8 columns a lane,
//     each chunk's two halves of 32 rows summed apart, and a^T gdn one
//     key a thread.  A chunk of 64 rows and the resident keys fill the
//     shared memory, so the next chunk loads after this one is read.
//     Overlapping the copies bought nothing in two forms tried (two warp
//     groups, one copying q and the other gy while the other computed;
//     the next chunk's first 32 rows copied while the last 32 of this one
//     were summed): the sums slowed by as much as the wait they hid.  A
//     CTA whose keys all have w <= 0 writes zeros without reading a row.
// Both score in dot_tile's order, the order band_stream_kernel scored in,
// so s == m finds the forward's maximum bit for bit.  expf, not __expf.
template <int RY>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
stream_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ y, const float* __restrict__ dn,
                 const float* __restrict__ m, const float* __restrict__ gy,
                 const float* __restrict__ gdn, const float* __restrict__ gm,
                 float* __restrict__ dq, float* __restrict__ gmn, int B,
                 int G, int L, int d, int dv, int nr, int vec_in,
                 int vec_out) {
  constexpr int TQ = STREAM_TQ, TK = STREAM_DQ_TK, NT = STREAM_THREADS;
  constexpr int NTIE = STREAM_TIES;
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
  const int qs = d4 + 4, gs = dv4 + 4, ps = TK + 4;
  const int kw0 = max(0, (t0 / nr - 1) * nr);   // the window's first key
  const int kend = t0 + rows - 1;               // and its last
  const int nt = (kend - kw0 + TK) / TK;        // key tiles it spans
  float* q_s = smem;                            // TQ x qs
  float* g_s = q_s + TQ * qs;                   // TQ x gs: gy
  float* k_s = g_s + TQ * gs;                   // TK x qs
  float* v_s = k_s + TK * qs;                   // TK x gs
  float* w_s = v_s + TK * gs;                   // TK
  float* p_s = w_s + TK;                        // TQ x ps: this tile's ds
  float* s_s = p_s + TQ * ps;                   // TQ x ps: this tile's s
  float* m_s = s_s + TQ * ps;                   // TQ each: m, gdn, gmh
  float* gdn_s = m_s + TQ;
  float* gmh_s = gdn_s + TQ;
  int* cnt_s = reinterpret_cast<int*>(gmh_s + TQ);  // TQ: ties a row
  int* tie_s = cnt_s + TQ;                      // TQ x NTIE: tied keys
  int* live_s = tie_s + TQ * NTIE;              // live key tiles
  int* nlive_s = live_s + stream_dq_tiles(nr);
  const size_t row0 = (size_t)bg * L + t0;
  const float* wb = w + (size_t)b * L;

  // list the window's key tiles that hold a key with w > 0, in order
  for (int n = warp; n < nt; n += NT / 32) {
    const int j = kw0 + n * TK + lane;
    const unsigned any = __ballot_sync(FULL, j <= kend && wb[j] > 0.f);
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
  if (nlive == 0) {                             // no row has a live key
    for (int e = tid; e < rows * d; e += NT) dq[row0 * d + e] = 0.f;
    for (int r = tid; r < rows; r += NT) gmn[row0 + r] = 0.f;
    return;
  }

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
    stage_rows(v_s, gs, TK, dv, vec_in & VEC_V,
               [&](int r) { return src(n, r, v, dv); });
  };
  stage_rows(q_s, qs, TQ, d, vec_in & VEC_Q, [&](int r) -> const float* {
    return r < rows ? q + (row0 + r) * d : nullptr;
  });
  stage_rows(g_s, gs, TQ, dv, vec_in & VEC_GY, [&](int r) -> const float* {
    return r < rows ? gy + (row0 + r) * dv : nullptr;
  });
  stage_keys(0);
  stage_values(0);
  cp_async_commit();
  for (int r = tid; r < TQ; r += NT) {
    m_s[r] = r < rows ? m[row0 + r] : 0.f;
    gdn_s[r] = r < rows ? gdn[row0 + r] : 0.f;
  }
  cp_async_wait();
  __syncthreads();
  // gmh = gm - (gy . y + gdn * dn): a warp a row, y read once
  for (int r = warp; r < TQ; r += NT / 32) {
    float part = 0.f;
    if (r < rows) {
      const float* yr = y + (row0 + r) * dv;
      for (int c = lane; c < dv; c += 32) part = fmaf(g_s[r * gs + c], yr[c], part);
    }
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
    if (lane == 0)
      gmh_s[r] = r < rows ? gm[row0 + r] - (part + gdn_s[r] * dn[row0 + r])
                          : 0.f;
  }

  // scores: warps 0-3 score s = q . k, warps 4-7 da = gy . v, each on
  // the rows 16 (w % 4) + rl + 4 r (r < 4) against keys kl + 8 t; then
  // every warp forms ds of its 8 rows, 8 w + rl + 4 r (r < 2)
  const bool sw = warp < NT / 64;
  const int rl = lane >> 3, kl = lane & 7;
  const int rs0 = (warp & 3) * 16 + rl, rd0 = warp * 8 + rl;
  float x_r[4], m_r[2];                         // s warps: gdn unused
  int cnt_r[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 4; ++r) x_r[r] = gdn_s[rs0 + 4 * r];
#pragma unroll
  for (int r = 0; r < 2; ++r) m_r[r] = m_s[rd0 + 4 * r];
  // ds @ k: this lane's rows lt.row0 + lt.rstep * rr, units lt.u0, lt.u1
  const int ncg = d4 / 4;
  const LaneTile lt = lane_tile(tid, 8 * RY, TQ);
  const int c0 = min(lt.u0, ncg - 1) * 4, c1 = min(lt.u1, ncg - 1) * 4;
  float acc[RY][8];
#pragma unroll
  for (int rr = 0; rr < RY; ++rr)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[rr][c] = 0.f;

  for (int n = 0; n < nlive; ++n) {
    cp_async_wait();                            // keys and values of n
    __syncthreads();
    const int ks = kw0 + live_s[n] * TK;
    {
      float sc[4][4];
      if (sw)
        dot_tile_rk<4, 4>(q_s + rs0 * qs, 4 * qs, k_s + kl * qs, 8 * qs, d4,
                          sc);
      else
        dot_tile_rk<4, 4>(g_s + rs0 * gs, 4 * gs, v_s + kl * gs, 8 * gs,
                          dv4, sc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int at = (rs0 + 4 * r) * ps + kl + 8 * t;
          if (sw) s_s[at] = sc[r][t];
          else p_s[at] = fmaf(x_r[r], w_s[kl + 8 * t], sc[r][t]);  // da + gdn w
        }
    }
    __syncthreads();                            // s and da written
    if (n + 1 < nlive) stage_values(n + 1);
    cp_async_commit();
    // ds without the tie term; the ties counted and listed
    bool tie[2][4], anytie = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rd0 + 4 * r, i = t0 + row, lo = (i / nr - 1) * nr;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int kk = kl + 8 * t, j = ks + kk;
        const float x = s_s[row * ps + kk];
        const bool ok = row < rows && j >= lo && j <= i && w_s[kk] > 0.f;
        float* ds = p_s + row * ps + kk;
        *ds = ok ? expf(x - m_r[r]) * *ds : 0.f;
        tie[r][t] = ok && x == m_r[r];
        anytie |= tie[r][t];
      }
    }
    if (__any_sync(FULL, anytie)) {
      // in key order: t, then the row's 8 lanes (keys kl + 8 t)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const unsigned sub =
              (__ballot_sync(FULL, tie[r][t]) >> (rl * 8)) & 0xffu;
          const int pos = cnt_r[r] + __popc(sub & ((1u << kl) - 1u));
          if (tie[r][t] && pos < NTIE)
            tie_s[(rd0 + 4 * r) * NTIE + pos] = ks + kl + 8 * t;
          cnt_r[r] += __popc(sub);
        }
    }
    __syncthreads();                            // ds written
    // dq += ds @ k over this tile's keys, summed apart first
    {
      float part[RY][8];
      apply_tile8<RY>(p_s + lt.row0 * ps, lt.rstep * ps, k_s, qs, c0, c1, TK,
                      part);
#pragma unroll
      for (int rr = 0; rr < RY; ++rr)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[rr][c] += part[rr][c];
    }
    __syncthreads();                            // the keys are read
    if (n + 1 < nlive) stage_keys(n + 1);
    cp_async_commit();
  }

#pragma unroll
  for (int rr = 0; rr < RY; ++rr) {
    const int r = lt.row0 + lt.rstep * rr;
    if (r >= rows) continue;
    float* out = dq + (row0 + r) * d;
    const float lo4[4] = {acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]};
    const float hi4[4] = {acc[rr][4], acc[rr][5], acc[rr][6], acc[rr][7]};
    if (lt.u0 < ncg) store4(out, lt.u0 * 4, d, vec_out & VEC_DQ, lo4);
    if (lt.u1 < ncg) store4(out, lt.u1 * 4, d, vec_out & VEC_DQ, hi4);
  }
  if (kl == 0) {
    cnt_s[rd0] = cnt_r[0];
    cnt_s[rd0 + 4] = cnt_r[1];
  }
  __syncthreads();                              // dq stored, counts in

  // the tie term: dq += gmn * (sum of the row's tied k, in key order), a
  // warp a row, lanes over the columns; gmn = gmh / c
  constexpr int CL = STREAM_MAX_D / 32;         // columns a lane
  for (int r = warp; r < rows; r += NT / 32) {
    const int c = cnt_s[r];
    const float gmn_r = c > 0 ? gmh_s[r] / (float)c : 0.f;
    if (lane == 0) gmn[row0 + r] = gmn_r;
    if (c == 0) continue;
    float ts[CL];
#pragma unroll
    for (int e = 0; e < CL; ++e) ts[e] = 0.f;
    auto add_key = [&](int j) {
      const float* kr = k + ((size_t)b * L + j) * d;
#pragma unroll
      for (int e = 0; e < CL; ++e)
        if (lane + 32 * e < d) ts[e] += kr[lane + 32 * e];
    };
    if (c <= NTIE) {
      for (int e = 0; e < c; ++e) add_key(tie_s[r * NTIE + e]);
    } else {
      // more ties than the list holds: rescan the window in key order,
      // a lane a key, each score one fmaf chain over the columns
      const int i = t0 + r, lo = max(0, (i / nr - 1) * nr);
      const float* qr = q_s + r * qs;
      for (int j0 = lo; j0 <= i; j0 += 32) {
        const int j = j0 + lane;
        bool hit = false;
        if (j <= i && wb[j] > 0.f) {
          const float* kr = k + ((size_t)b * L + j) * d;
          float x = 0.f;
          for (int cc = 0; cc < d; ++cc) x = fmaf(qr[cc], kr[cc], x);
          hit = x == m_s[r];
        }
        for (unsigned hits = __ballot_sync(FULL, hit); hits;
             hits &= hits - 1u)
          add_key(j0 + __ffs(hits) - 1);
      }
    }
    float* out = dq + (row0 + r) * d;
#pragma unroll
    for (int e = 0; e < CL; ++e)
      if (lane + 32 * e < d) out[lane + 32 * e] += gmn_r * ts[e];
  }
}

template <int RK>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
stream_dkvw_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ m, const float* __restrict__ gy,
                   const float* __restrict__ gdn,
                   const float* __restrict__ gmn, float* __restrict__ dk,
                   float* __restrict__ dvo, float* __restrict__ dw, int B,
                   int G, int L, int d, int dv, int nr, int vec_in,
                   int vec_out) {
  constexpr int TK = STREAM_KV_TK, TR = STREAM_KV_TR, NT = STREAM_THREADS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int b, blk, rank, k0;
  if (nr >= TK) {
    stream_slot(blockIdx.x, B, L / nr, nr / TK, &b, &blk, &rank);
    k0 = blk * nr + rank * TK;
  } else {
    const int tiles = (L + TK - 1) / TK;
    b = blockIdx.x / tiles;
    k0 = (blockIdx.x - b * tiles) * TK;
  }
  const int keys = min(TK, L - k0);
  const int d4 = round4(d), dv4 = round4(dv);
  const int qs = d4 + 4, gs = dv4 + 4, ps = TR + 4;
  const size_t kb = (size_t)b * L + k0;         // the CTA's first key
  float* k_s = smem;                            // TK x qs
  float* v_s = k_s + TK * qs;                   // TK x gs
  float* q_s = v_s + TK * gs;                   // TR x qs
  float* g_s = q_s + TR * qs;                   // TR x gs: gy
  float* x_s = g_s + TR * gs;                   // 3 x TR: m, gdn, gmn
  float* a_s = x_s + 3 * TR;                    // TK x ps: s, then a
  float* ds_s = a_s + TK * ps;                  // TK x ps: da, then ds
  float* w_s = ds_s + TK * ps;                  // TK

  float wk = 0.f;
  if (tid < TK) {
    wk = tid < keys ? w[kb + tid] : 0.f;
    w_s[tid] = wk;
  }
  if (!__syncthreads_or(wk > 0.f)) {
    // no key here has w > 0: every gradient of these keys is 0
    for (int e = tid; e < keys * d; e += NT) dk[kb * d + e] = 0.f;
    for (int e = tid; e < keys * dv; e += NT) dvo[kb * dv + e] = 0.f;
    for (int e = tid; e < keys; e += NT) dw[kb + e] = 0.f;
    return;
  }
  stage_rows(k_s, qs, TK, d, vec_in & VEC_K, [&](int r) -> const float* {
    return r < keys ? k + (kb + r) * d : nullptr;
  });
  stage_rows(v_s, gs, TK, dv, vec_in & VEC_V, [&](int r) -> const float* {
    return r < keys ? v + (kb + r) * dv : nullptr;
  });

  // reader rows k0 .. rhi - 1 of every group, in chunks of TR
  const int rhi = min(L, ((k0 + keys - 1) / nr + 2) * nr);
  const int nch = (rhi - k0 + TR - 1) / TR, total = G * nch;
  auto stage = [&](int n) {
    const int gg = n / nch, f0 = k0 + (n - gg * nch) * TR;
    const size_t rowg = ((size_t)b * G + gg) * L + f0;
    auto src = [&](int r, const float* base, int width) -> const float* {
      return f0 + r < rhi ? base + (rowg + r) * width : nullptr;
    };
    stage_rows(q_s, qs, TR, d, vec_in & VEC_Q,
               [&](int r) { return src(r, q, d); });
    stage_rows(g_s, gs, TR, dv, vec_in & VEC_GY,
               [&](int r) { return src(r, gy, dv); });
    if (tid < 3 * TR) {
      const int which = tid / TR, r = tid - which * TR;
      const float* base = which == 0 ? m : which == 1 ? gdn : gmn;
      float* dst = x_s + which * TR + r;
      if (f0 + r < rhi) cp_async4(dst, base + rowg + r);
      else *dst = 0.f;
    }
  };

  // scores: warps 0-3 score s = q . k, warps 4-7 da = gy . v, each on
  // the chunk rows 16 (w % 4) + rl + 4 r (r < 4) against keys kl + 8 t;
  // then every warp forms a and ds of its 8 rows, 8 w + rl + 4 r (r < 2)
  const bool sw = warp < NT / 64;
  const int rl = lane >> 3, kl = lane & 7;
  const int rs0 = (warp & 3) * 16 + rl, rd0 = warp * 8 + rl;
  // ds^T q (threads 0-127) or a^T gy (128-255): keys lt.row0 + lt.rstep *
  // rr, units lt.u0, lt.u1
  const bool isk = tid < NT / 2;
  const int ncg = (isk ? d4 : dv4) / 4;
  const LaneTile lt = lane_tile(isk ? tid : tid - NT / 2, 8 * RK, TK);
  const int c0 = min(lt.u0, ncg - 1) * 4, c1 = min(lt.u1, ncg - 1) * 4;
  const float* pa = (isk ? ds_s : a_s) + lt.row0 * ps;
  const float* xb = isk ? q_s : g_s;
  const int xs = isk ? qs : gs;
  float acc[RK][8], accw = 0.f;
#pragma unroll
  for (int rr = 0; rr < RK; ++rr)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[rr][c] = 0.f;
  stage(0);
  cp_async_commit();
  for (int n = 0; n < total; ++n) {
    cp_async_wait();                            // chunk n (and k, v)
    __syncthreads();
    const int f0 = k0 + (n - n / nch * nch) * TR;
    {
      float sc[4][4];
      if (sw)
        dot_tile_rk<4, 4>(q_s + rs0 * qs, 4 * qs, k_s + kl * qs, 8 * qs, d4,
                          sc);
      else
        dot_tile_rk<4, 4>(g_s + rs0 * gs, 4 * gs, v_s + kl * gs, 8 * gs,
                          dv4, sc);
      // s, or da + gdn w, key-major
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float gdn_i = x_s[TR + rs0 + 4 * r];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int at = (kl + 8 * t) * ps + rs0 + 4 * r;
          if (sw) a_s[at] = sc[r][t];
          else ds_s[at] = fmaf(gdn_i, w_s[kl + 8 * t], sc[r][t]);
        }
      }
    }
    __syncthreads();                            // s and da, key-major
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rd0 + 4 * r, i = f0 + row, lo = (i / nr - 1) * nr;
      const float m_i = x_s[row], gmn_i = x_s[2 * TR + row];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int kk = kl + 8 * t, j = k0 + kk;
        float* as = a_s + kk * ps + row;
        float* ds = ds_s + kk * ps + row;
        const float x = *as;
        const bool ok = i < rhi && kk < keys && w_s[kk] > 0.f && j <= i &&
                        j >= lo;
        const float a = ok ? expf(x - m_i) : 0.f;
        *as = a;
        *ds = ok ? a * *ds + (x == m_i ? gmn_i : 0.f) : 0.f;
      }
    }
    __syncthreads();                            // a and ds written
    // this chunk's rows into dk (ds^T q), dv (a^T gy) and dw (a^T gdn),
    // each half of 32 rows summed apart first
#pragma unroll
    for (int h = 0; h < TR; h += 32) {
      float part[RK][8];
      apply_tile8<RK>(pa + h, lt.rstep * ps, xb + h * xs, xs, c0, c1, 32,
                      part);
#pragma unroll
      for (int rr = 0; rr < RK; ++rr)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[rr][c] += part[rr][c];
      if (tid < TK) {
        float pw = 0.f;
        for (int rr = 0; rr < 32; ++rr)
          pw = fmaf(a_s[tid * ps + h + rr], x_s[TR + h + rr], pw);
        accw += pw;
      }
    }
    __syncthreads();                            // the chunk is read
    if (n + 1 < total) stage(n + 1);
    cp_async_commit();
  }

  float* out = isk ? dk : dvo;
  const int width = isk ? d : dv;
  const int vec = vec_out & (isk ? VEC_DK : VEC_DV);
#pragma unroll
  for (int rr = 0; rr < RK; ++rr) {
    const int t = lt.row0 + lt.rstep * rr;
    if (t >= keys) continue;
    float* o = out + (kb + t) * width;
    const float lo4[4] = {acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]};
    const float hi4[4] = {acc[rr][4], acc[rr][5], acc[rr][6], acc[rr][7]};
    if (lt.u0 < ncg) store4(o, lt.u0 * 4, width, vec, lo4);
    if (lt.u1 < ncg) store4(o, lt.u1 * 4, width, vec, hi4);
  }
  if (tid < keys) dw[kb + tid] = accw;
}

size_t stream_bwd_smem(int d, int dv, int nr, int pass) {
  return (pass == 0 ? stream_dq_floats(d, dv, nr) : stream_dkvw_floats(d, dv))
         * sizeof(float);
}

// nr a power of two >= 2 with L % nr == 0; d, dv up to STREAM_MAX_D; both
// passes' shared-memory plans within SMEM_MAX.  The register tiles are
// laid out for stream_cols(d) units in dQ, stream_cols of the wider of d
// and dv in dK/dV/dW.
int launch_stream(const float* q, const float* k, const float* v,
                  const float* w, const float* y, const float* dn,
                  const float* m, const float* gy, const float* gdn,
                  const float* gm, float* dq, float* gmn, float* dk,
                  float* dv_out, float* dw, int B, int G, int L, int d,
                  int dv, int nr, cudaStream_t stream) {
  if (d < 1 || dv < 1 || d > STREAM_MAX_D || dv > STREAM_MAX_D || nr < 2 ||
      (nr & (nr - 1)) || L % nr)
    return (int)cudaErrorInvalidValue;
  const size_t smem_dq = stream_bwd_smem(d, dv, nr, 0);
  const size_t smem_kv = stream_bwd_smem(d, dv, nr, 1);
  if (smem_dq > SMEM_MAX || smem_kv > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || G == 0 || L == 0) return 0;
  const auto dq_kernel =
      by_stream_cols(round4(d), &stream_dq_kernel<2>, &stream_dq_kernel<4>,
                     &stream_dq_kernel<8>);
  const auto kv_kernel = by_stream_cols(
      max(round4(d), round4(dv)), &stream_dkvw_kernel<2>,
      &stream_dkvw_kernel<4>, &stream_dkvw_kernel<8>);
  int e = set_smem(dq_kernel, smem_dq);
  if (e) return e;
  e = set_smem(kv_kernel, smem_kv);
  if (e) return e;
  const int vec_in = (aligned16(q) && d % 4 == 0 ? VEC_Q : 0) |
                     (aligned16(k) && d % 4 == 0 ? VEC_K : 0) |
                     (aligned16(v) && dv % 4 == 0 ? VEC_V : 0) |
                     (aligned16(gy) && dv % 4 == 0 ? VEC_GY : 0);
  const int vec_out = (aligned16(dq) && d % 4 == 0 ? VEC_DQ : 0) |
                      (aligned16(dk) && d % 4 == 0 ? VEC_DK : 0) |
                      (aligned16(dv_out) && dv % 4 == 0 ? VEC_DV : 0);
  const int ctas_dq = B * G * ((L + STREAM_TQ - 1) / STREAM_TQ);
  const int ctas_kv = B * ((L + STREAM_KV_TK - 1) / STREAM_KV_TK);
  note_grid(ctas_dq, 1, ctas_kv, 1);
  dq_kernel<<<ctas_dq, STREAM_THREADS, smem_dq, stream>>>(
      q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, B, G, L, d, dv, nr, vec_in,
      vec_out);
  e = (int)cudaGetLastError();
  if (e) return e;
  kv_kernel<<<ctas_kv, STREAM_THREADS, smem_kv, stream>>>(q, k, v, w, m, gy, gdn, gmn, dk, dv_out, dw,
                                 B, G, L, d, dv, nr, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Saved q (B,G,L,d), k (B,L,d), v (B,L,dv), w (B,L), y (B,G,L,dv),
// dn/m (B,G,L) and cotangents gy (B,G,L,dv), gdn/gm (B,G,L)
// -> dq (B,G,L,d), gmn (B,G,L), dk (B,L,d), dv (B,L,dv), dw (B,L);
// mode is an h1d::Mode (coarse_causal on the sub body at ratio 1).  dsa:
// scratch of B*G*L rows of 2 * band_count(mode) * 4 * key_groups(nr)
// floats, 16-byte aligned, for l0_causal, l0_bidir and coarse_bidir
// (unused in coarse_causal).
extern "C" int h1d_band_bwd(const float* q, const float* k, const float* v,
                            const float* w, const float* y, const float* dn,
                            const float* m, const float* gy,
                            const float* gdn, const float* gm, float* dq,
                            float* gmn, float* dk, float* dv_out, float* dw,
                            float* dsa, int B, int G, int L, int d, int dv,
                            int nr, int mode, void* stream) {
  h1d::note_grid(0, 0);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case h1d::L0_BIDIR:
      return launch<h1d::L0_BIDIR>(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn,
                                   dk, dv_out, dw, dsa, B, G, L, d, dv, nr,
                                   st);
    case h1d::L0_CAUSAL:
      return launch<h1d::L0_CAUSAL>(q, k, v, w, y, dn, m, gy, gdn, gm, dq,
                                    gmn, dk, dv_out, dw, dsa, B, G, L, d, dv,
                                    nr, st);
    case h1d::COARSE_BIDIR:
      return launch<h1d::COARSE_BIDIR>(q, k, v, w, y, dn, m, gy, gdn, gm, dq,
                                       gmn, dk, dv_out, dw, dsa, B, G, L, d,
                                       dv, nr, st);
    case h1d::COARSE_CAUSAL:
      return launch_sub(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, dk,
                        dv_out, dw, B, G, L, L, d, dv, nr, 1, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same for mode sub: fine q (B,G,Lq,d) against coarse k (B,Lk,d),
// v (B,Lk,dv), w (B,Lk), Lq = Lk * ratio.
extern "C" int h1d_band_sub_bwd(const float* q, const float* k,
                                const float* v, const float* w,
                                const float* y, const float* dn,
                                const float* m, const float* gy,
                                const float* gdn, const float* gm, float* dq,
                                float* gmn, float* dk, float* dv_out,
                                float* dw, int B, int G, int Lq, int Lk,
                                int d, int dv, int nr, int ratio,
                                void* stream) {
  h1d::note_grid(0, 0);
  return launch_sub(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, dk, dv_out,
                    dw, B, G, Lq, Lk, d, dv, nr, ratio, (cudaStream_t)stream);
}

// l0_causal with the key window streamed (the shapes the staged bodies
// refuse; repro_torch.kernels.h1d_block.check_window_bwd): the operands and
// results of h1d_band_bwd, no scratch.
extern "C" int h1d_band_bwd_stream(const float* q, const float* k,
                                   const float* v, const float* w,
                                   const float* y, const float* dn,
                                   const float* m, const float* gy,
                                   const float* gdn, const float* gm,
                                   float* dq, float* gmn, float* dk,
                                   float* dv_out, float* dw, int B, int G,
                                   int L, int d, int dv, int nr,
                                   void* stream) {
  h1d::note_grid(0, 0);
  return launch_stream(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, dk,
                       dv_out, dw, B, G, L, d, dv, nr, (cudaStream_t)stream);
}

// Bytes of the streamed backward's shared-memory plan, pass 0 (dQ) or 1
// (dK/dV/dW) (held by the card tests to repro_torch.kernels.h1d_block's
// stream_dq_floats and stream_dkvw_floats).
extern "C" int h1d_band_bwd_stream_smem(int d, int dv, int nr, int pass) {
  return (int)stream_bwd_smem(d, dv, nr, pass);
}

// The grids of this library's last launch on the calling thread
// (h1d::note_grid) into out[4]: what the wrappers' launch records carry.
extern "C" int h1d_band_bwd_last_grid(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = h1d::last_grid[i];
  return 0;
}
