// Banded block attention backward for H-Transformer-1D, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/h1d_block_bwd.py:
//   * h1d_band_bwd     <- band_attention_bwd (_dq_kernel, _dkvw_kernel),
//     every band mode: l0_causal, l0_bidir, coarse_bidir and
//     coarse_causal (the last on the sub body at ratio 1);
//   * h1d_band_sub_bwd <- band_attention_sub_bwd (_dq_sub_kernel and both
//     the wide and the deep dK/dV/dW kernels), the fine-q causal level.
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
// scores are recomputed in the forward's own fmaf order (dot_qk and
// dot_tile in h1d_band.cuh), so s == m finds exactly the forward's
// maximum.
//
// What bounds it on the H100: memory, as the forward.  A (query, key)
// pair costs ~6d + 4dv FLOPs against the rows' bytes read once: at nr=16,
// d=64 about 10-20 FLOP per byte, below the fp32 ridge of ~20.  The
// least time counts q, gy, y of the rows that have a live key, the key
// blocks some row reads, and every output written once.
//
// No atomics anywhere: two runs give identical bits.
//   * l0_causal, l0_bidir, coarse_bidir: two kernels per level on one
//     stream.  The dQ pass (band_dq_kernel) has the forward's layout: one
//     CTA per (b, tile of TQ query rows) stages the key window and loops
//     over the GQA groups; a warp takes one query row, lane j holds key
//     j, and the row's delta, tie count and gmn are warp reductions.  The
//     dK/dV/dW pass (band_dkvw_kernel) takes one CTA per (b, tile of
//     keys): every key j is read by a contiguous run of query rows
//     ([j, end of the next nr-block) in l0_causal, the blocks J-1, J and
//     J+1 in a bidirectional mode), which the CTA streams through shared
//     memory in chunks of QC for each group g in turn; a warp owns some
//     keys and lane i holds query i of a 32-row slice.
//   * the sub level and coarse_causal (sub_bwd_kernel, one kernel): key
//     block J is read by query block J+1 alone, so one CTA per (b, J)
//     owns the rows of that query block (nq = nr * ratio per group) and
//     computes everything from one recomputation of each score: per row
//     delta, the tie count and gmn (the row's band is block J), dq; for
//     block J dk, dv and dw.  q, gy and y of a row are read once, with
//     cp.async into shared memory, and only for rows with a live key; a
//     dead block (no key with w > 0, and query block 0) writes dq = 0,
//     gmn = 0 and zero key gradients without reading its rows.  Scores
//     and gy . v are 2-row x 4-key register tiles in dot_tile's order
//     (first-half rows skip the masked quadrant), dq a 4-row x 4-column
//     tile, and each thread owns a 4-key x 4-column tile of dk or dv (and
//     dw) accumulated in shared memory over the CTA's row tiles.  At deep
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

constexpr int TQ = 64;                // dQ pass: query rows per CTA
constexpr int QC = 64;                // dK/dV/dW pass: query rows per chunk
constexpr int TK = 32;                // dK/dV/dW pass: keys per CTA
constexpr int WARPS = 8;
constexpr int MAXC = 4;               // key chunks of 32 per row: nk <= 128
constexpr int MAXU = 4;               // column chunks of 32: d, dv <= 128

// Query rows [lo, hi) that read key j (the transpose of key_start and
// band_keys); both bounds grow with j.  As in the forward, every kernel
// here has one instantiation per band mode.
template <int MODE>
__device__ __forceinline__ void query_range(int j, int nr, int L, int* lo,
                                            int* hi) {
  const int J = j / nr;
  if (MODE == L0_CAUSAL) {
    *lo = j;
    *hi = min(L, (J + 2) * nr);
  } else {
    *lo = max(0, (J - 1) * nr);
    *hi = min(L, (J + 2) * nr);
  }
}

template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
band_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ y, const float* __restrict__ dn,
               const float* __restrict__ m, const float* __restrict__ gy,
               const float* __restrict__ gdn, const float* __restrict__ gm,
               float* __restrict__ dq, float* __restrict__ gmn, int G,
               int L, int d, int dv, int nr) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TQ;
  const int rows = min(TQ, L - t0);
  const int nk = band_keys(MODE, nr);
  const int kbase = key_start(t0, nr);
  const int nwin = key_start(t0 + rows - 1, nr) + nk - kbase;
  const int ks = d + 1, vs = dv + 1;
  float* k_s = smem;
  float* v_s = k_s + nwin * ks;
  float* w_s = v_s + nwin * vs;
  float* q_w = w_s + nwin;
  float* g_w = q_w + WARPS * d;

  // key window; rows outside [0, L) read as zero (masked by weight 0
  // and band_mask's in-range test)
  for (int e = threadIdx.x; e < nwin * d; e += blockDim.x) {
    const int r = e / d, c = e % d, j = kbase + r;
    k_s[r * ks + c] = (j >= 0 && j < L) ? k[((size_t)b * L + j) * d + c]
                                        : 0.f;
  }
  for (int e = threadIdx.x; e < nwin * dv; e += blockDim.x) {
    const int r = e / dv, c = e % dv, j = kbase + r;
    v_s[r * vs + c] = (j >= 0 && j < L) ? v[((size_t)b * L + j) * dv + c]
                                        : 0.f;
  }
  for (int r = threadIdx.x; r < nwin; r += blockDim.x) {
    const int j = kbase + r;
    w_s[r] = (j >= 0 && j < L) ? w[(size_t)b * L + j] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = q_w + warp * d;
  float* gw = g_w + warp * dv;
  for (int item = warp; item < G * rows; item += WARPS) {
    const int g = item / rows;
    const int i = t0 + item % rows;
    const size_t row = ((size_t)b * G + g) * L + i;
    for (int c = lane; c < d; c += 32) qw[c] = q[row * d + c];
    float part = 0.f;
    for (int c = lane; c < dv; c += 32) {
      const float gv = gy[row * dv + c];
      gw[c] = gv;
      part = fmaf(gv, y[row * dv + c], part);
    }
    __syncwarp();
    for (int off = 16; off; off >>= 1)
      part += __shfl_xor_sync(FULL, part, off);
    const float gdn_i = gdn[row], m_i = m[row];
    const float gmh = gm[row] - (part + gdn_i * dn[row]);
    const int k0 = key_start(i, nr) - kbase;                 // window offset

    float a[MAXC], da[MAXC];
    bool hit[MAXC];
    int cnt = 0;
#pragma unroll
    for (int ch = 0; ch < MAXC; ++ch) {
      const int jj = lane + 32 * ch;
      a[ch] = 0.f;
      da[ch] = 0.f;
      hit[ch] = false;
      if (jj < nk) {
        const int r = k0 + jj;
        const bool allow = band_mask(i, kbase + r, nr, MODE, L) &&
                           w_s[r] > 0.f;
        const float s = allow ? dot_qk(qw, k_s + r * ks, d) : NEG_INF;
        a[ch] = expf(s - m_i);
        hit[ch] = s == m_i;
        float acc = 0.f;
        const float* vr = v_s + r * vs;
        for (int c = 0; c < dv; ++c) acc = fmaf(gw[c], vr[c], acc);
        da[ch] = acc + gdn_i * w_s[r];
        cnt += hit[ch];
      }
    }
    for (int off = 16; off; off >>= 1)
      cnt += __shfl_xor_sync(FULL, cnt, off);
    const float gmn_i = cnt > 0 ? gmh / (float)cnt : 0.f;

    float acc_q[MAXU];
#pragma unroll
    for (int u = 0; u < MAXU; ++u) acc_q[u] = 0.f;
#pragma unroll
    for (int ch = 0; ch < MAXC; ++ch) {
      if (32 * ch >= nk) break;
      const float ds = a[ch] * da[ch] + gmn_i * (hit[ch] ? 1.f : 0.f);
      const int n = min(32, nk - 32 * ch);
      for (int src = 0; src < n; ++src) {
        const float dsj = __shfl_sync(FULL, ds, src);
        const float* kr = k_s + (k0 + 32 * ch + src) * ks;
#pragma unroll
        for (int u = 0; u < MAXU; ++u) {
          const int c = lane + 32 * u;
          if (c < d) acc_q[u] = fmaf(dsj, kr[c], acc_q[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MAXU; ++u) {
      const int c = lane + 32 * u;
      if (c < d) dq[row * d + c] = acc_q[u];
    }
    if (lane == 0) gmn[row] = gmn_i;
    __syncwarp();
  }
}

template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
band_dkvw_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ m, const float* __restrict__ gy,
                 const float* __restrict__ gdn, const float* __restrict__ gmn,
                 float* __restrict__ dk, float* __restrict__ dvo,
                 float* __restrict__ dw, int G, int L, int d, int dv,
                 int nr, int tk) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * tk;
  const int keys = min(tk, L - j0);
  const int ks = d + 1, vs = dv + 1;
  float* k_s = smem;                       // tk x (d+1)
  float* v_s = k_s + tk * ks;              // tk x (dv+1)
  float* w_s = v_s + tk * vs;              // tk
  float* dk_s = w_s + tk;                  // tk x d    accumulators
  float* dv_s = dk_s + tk * d;             // tk x dv
  float* dw_s = dv_s + tk * dv;            // tk
  float* q_s = dw_s + tk;                  // QC x (d+1)  query chunk
  float* g_s = q_s + QC * ks;              // QC x (dv+1)
  float* m_s = g_s + QC * vs;              // QC
  float* gdn_s = m_s + QC;                 // QC
  float* gmn_s = gdn_s + QC;               // QC

  for (int e = threadIdx.x; e < keys * d; e += blockDim.x) {
    const int r = e / d, c = e % d;
    k_s[r * ks + c] = k[((size_t)b * L + j0 + r) * d + c];
    dk_s[e] = 0.f;
  }
  for (int e = threadIdx.x; e < keys * dv; e += blockDim.x) {
    const int r = e / dv, c = e % dv;
    v_s[r * vs + c] = v[((size_t)b * L + j0 + r) * dv + c];
    dv_s[e] = 0.f;
  }
  for (int r = threadIdx.x; r < keys; r += blockDim.x) {
    w_s[r] = w[(size_t)b * L + j0 + r];
    dw_s[r] = 0.f;
  }
  // the query rows of this key tile: lo and hi grow with j
  int qlo, qhi, unused;
  query_range<MODE>(j0, nr, L, &qlo, &unused);
  query_range<MODE>(j0 + keys - 1, nr, L, &unused, &qhi);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = 0; g < G; ++g) {
    const size_t base_row = ((size_t)b * G + g) * L;
    for (int c0 = qlo; c0 < qhi; c0 += QC) {
      const int nqc = min(QC, qhi - c0);
      __syncthreads();              // the previous chunk is consumed
      for (int e = threadIdx.x; e < nqc * d; e += blockDim.x) {
        const int r = e / d, c = e % d;
        q_s[r * ks + c] = q[(base_row + c0 + r) * d + c];
      }
      for (int e = threadIdx.x; e < nqc * dv; e += blockDim.x) {
        const int r = e / dv, c = e % dv;
        g_s[r * vs + c] = gy[(base_row + c0 + r) * dv + c];
      }
      for (int r = threadIdx.x; r < nqc; r += blockDim.x) {
        m_s[r] = m[base_row + c0 + r];
        gdn_s[r] = gdn[base_row + c0 + r];
        gmn_s[r] = gmn[base_row + c0 + r];
      }
      __syncthreads();

      for (int kk = warp; kk < keys; kk += WARPS) {
        // a key of weight <= 0 is masked for every row: a = 0, no tie
        if (!(w_s[kk] > 0.f)) continue;
        const int j = j0 + kk;
        int lo, hi;
        query_range<MODE>(j, nr, L, &lo, &hi);
        lo = max(lo, c0);
        hi = min(hi, c0 + nqc);
        if (lo >= hi) continue;
        const float* kr = k_s + kk * ks;
        const float* vr = v_s + kk * vs;
        float adk[MAXU], adv[MAXU];
#pragma unroll
        for (int u = 0; u < MAXU; ++u) adk[u] = adv[u] = 0.f;
        float adw = 0.f;
        for (int base = lo; base < hi; base += 32) {
          const int i = base + lane;
          float a = 0.f, ds = 0.f;
          if (i < hi) {
            const int r = i - c0;
            const bool allow = band_mask(i, j, nr, MODE, L);
            const float s = allow ? dot_qk(q_s + r * ks, kr, d) : NEG_INF;
            const float m_i = m_s[r];
            a = expf(s - m_i);
            const float* gr = g_s + r * vs;
            float acc = 0.f;
            for (int c = 0; c < dv; ++c) acc = fmaf(gr[c], vr[c], acc);
            const float da = acc + gdn_s[r] * w_s[kk];
            ds = a * da + gmn_s[r] * (s == m_i ? 1.f : 0.f);
            adw = fmaf(a, gdn_s[r], adw);
          }
          const int n = min(32, hi - base);
          for (int src = 0; src < n; ++src) {
            const float dsi = __shfl_sync(FULL, ds, src);
            const float ai = __shfl_sync(FULL, a, src);
            const int r = base + src - c0;
            const float* qr = q_s + r * ks;
            const float* gr = g_s + r * vs;
#pragma unroll
            for (int u = 0; u < MAXU; ++u) {
              const int c = lane + 32 * u;
              if (c < d) adk[u] = fmaf(dsi, qr[c], adk[u]);
              if (c < dv) adv[u] = fmaf(ai, gr[c], adv[u]);
            }
          }
        }
        for (int off = 16; off; off >>= 1)
          adw += __shfl_xor_sync(FULL, adw, off);
#pragma unroll
        for (int u = 0; u < MAXU; ++u) {
          const int c = lane + 32 * u;
          if (c < d) dk_s[kk * d + c] += adk[u];
          if (c < dv) dv_s[kk * dv + c] += adv[u];
        }
        if (lane == 0) dw_s[kk] += adw;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < keys * d; e += blockDim.x)
    dk[((size_t)b * L + j0) * d + e] = dk_s[e];
  for (int e = threadIdx.x; e < keys * dv; e += blockDim.x)
    dvo[((size_t)b * L + j0) * dv + e] = dv_s[e];
  for (int r = threadIdx.x; r < keys; r += blockDim.x)
    dw[(size_t)b * L + j0 + r] = dw_s[r];
}


template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int MODE>
int launch(const float* q, const float* k, const float* v, const float* w,
           const float* y, const float* dn, const float* m, const float* gy,
           const float* gdn, const float* gm, float* dq, float* gmn,
           float* dk, float* dv_out, float* dw, int B, int G, int L, int d,
           int dv, int nr, cudaStream_t stream) {
  const int nk = band_keys(MODE, nr);
  if (d < 1 || dv < 1 || d > 32 * MAXU || dv > 32 * MAXU ||
      nk > 32 * MAXC || TQ % nr != 0)
    return (int)cudaErrorInvalidValue;
  const int nwin_max = TQ - nr + nk;    // as the forward's key window
  const size_t smem_dq = ((size_t)nwin_max * (d + 1) +
                          (size_t)nwin_max * (dv + 1) + nwin_max +
                          (size_t)WARPS * (d + dv)) * sizeof(float);
  int e = set_smem(band_dq_kernel<MODE>, smem_dq);
  if (e) return e;
  band_dq_kernel<MODE><<<dim3((L + TQ - 1) / TQ, B), WARPS * 32, smem_dq,
                         stream>>>(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn,
                                   G, L, d, dv, nr);
  e = (int)cudaGetLastError();
  if (e) return e;

  const size_t smem_kv = ((size_t)TK * (d + 1) + (size_t)TK * (dv + 1) + TK +
                          (size_t)TK * (d + dv) + TK +
                          (size_t)QC * (d + 1) + (size_t)QC * (dv + 1) +
                          3 * QC) * sizeof(float);
  e = set_smem(band_dkvw_kernel<MODE>, smem_kv);
  if (e) return e;
  band_dkvw_kernel<MODE><<<dim3((L + TK - 1) / TK, B), WARPS * 32, smem_kv,
                           stream>>>(q, k, v, w, m, gy, gdn, gmn, dk, dv_out,
                                     dw, G, L, d, dv, nr, TK);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// sub level and coarse_causal
// ---------------------------------------------------------------------------

// Row layouts that may be read or written 16 bytes at a time.
enum { VEC_Q = 1, VEC_K = 2, VEC_V = 4, VEC_Y = 8, VEC_GY = 16 };
enum { VEC_DQ = 1, VEC_DK = 2, VEC_DV = 4, VEC_DW = 8 };

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

}  // namespace

// Saved q (B,G,L,d), k (B,L,d), v (B,L,dv), w (B,L), y (B,G,L,dv),
// dn/m (B,G,L) and cotangents gy (B,G,L,dv), gdn/gm (B,G,L)
// -> dq (B,G,L,d), gmn (B,G,L), dk (B,L,d), dv (B,L,dv), dw (B,L);
// mode is an h1d::Mode (coarse_causal on the sub body at ratio 1).
extern "C" int h1d_band_bwd(const float* q, const float* k, const float* v,
                            const float* w, const float* y, const float* dn,
                            const float* m, const float* gy,
                            const float* gdn, const float* gm, float* dq,
                            float* gmn, float* dk, float* dv_out, float* dw,
                            int B, int G, int L, int d, int dv, int nr,
                            int mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case h1d::L0_BIDIR:
      return launch<h1d::L0_BIDIR>(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn,
                                   dk, dv_out, dw, B, G, L, d, dv, nr, st);
    case h1d::L0_CAUSAL:
      return launch<h1d::L0_CAUSAL>(q, k, v, w, y, dn, m, gy, gdn, gm, dq,
                                    gmn, dk, dv_out, dw, B, G, L, d, dv, nr,
                                    st);
    case h1d::COARSE_BIDIR:
      return launch<h1d::COARSE_BIDIR>(q, k, v, w, y, dn, m, gy, gdn, gm, dq,
                                       gmn, dk, dv_out, dw, B, G, L, d, dv,
                                       nr, st);
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
  return launch_sub(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn, dk, dv_out,
                    dw, B, G, Lq, Lk, d, dv, nr, ratio, (cudaStream_t)stream);
}
