// Banded block attention backward for H-Transformer-1D, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/h1d_block_bwd.py:
//   * h1d_band_bwd     <- band_attention_bwd (_dq_kernel, _dkvw_kernel),
//     every band mode: l0_causal, l0_bidir, coarse_bidir and
//     coarse_causal (the last on the sub bodies at ratio 1);
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
// scores are recomputed with the forward's own fmaf chain (dot_qk in
// h1d_band.cuh), so s == m finds exactly the forward's maximum.
//
// What bounds it on the H100: memory, as the forward.  A (query, key)
// pair costs ~6d + 4dv FLOPs against the rows' bytes read once: at nr=16,
// d=64 about 10-20 FLOP per byte, below the fp32 ridge of ~20.
//
// Design: two kernels per level on one stream, no atomics, so two runs
// give identical bits.
//   * dQ pass (band_dq_kernel): the forward's layout.  One CTA per (batch
//     row b, tile of TQ query rows) stages the key window in shared
//     memory once and loops over the GQA groups; a warp takes one query
//     row, lane j holds key j, and the row's delta, tie count and gmn are
//     warp reductions.  It writes dq and gmn.
//   * dK/dV/dW pass (band_dkvw_kernel): one CTA per (b, tile of keys).
//     Every key j is read by a contiguous run of query rows: [j, end of
//     the next nr-block) in l0_causal (its own block from row j on, plus
//     the next block that sees it as "prev"), the blocks J-1, J and J+1
//     in a bidirectional mode (J = j / nr; band_mask then decides each
//     pair), and the nq = nr*ratio fine rows of block J+1 at a sub level
//     -- at ratio 32 that is 512 rows for 16 keys.  The CTA streams those
//     rows through shared
//     memory in chunks of QC, for each group g in turn; a warp owns some
//     keys, lane i holds query i of a 32-row slice, and dk/dv accumulate
//     per lane over output columns in shared memory owned by that warp.
//     The GQA sum is this loop over g: K/V gradients are never copied
//     per group.
// Rows in shared memory are padded to width+1 floats so 32 lanes reading
// 32 different rows hit 32 different banks.  fp32 FMA on CUDA cores (no
// TF32), expf not __expf.
#include <cuda_runtime.h>
#include <math.h>

#include "h1d_band.cuh"

namespace {

using namespace h1d;

constexpr int TQ = 64;                // dQ pass: query rows per CTA
constexpr int QC = 64;                // dK/dV/dW pass: query rows per chunk
constexpr int TK_L0 = 32;             // dK/dV/dW pass: keys per CTA, level 0
constexpr int WARPS = 8;
constexpr int MAXC = 4;               // key chunks of 32 per row: nk <= 128
constexpr int MAXU = 4;               // column chunks of 32: d, dv <= 128

// Query rows [lo, hi) that read key j (the transpose of key_start and
// band_keys); both bounds grow with j.  As in the forward, every kernel
// here has one instantiation per band mode and coarse_causal is the sub
// body (at ratio 1 for the coarse-q level, 2**l for a fine-q sub level).
template <int MODE>
__device__ __forceinline__ void query_range(int j, int nr, int ratio, int Lq,
                                            int* lo, int* hi) {
  const int J = j / nr;
  if (MODE == COARSE_CAUSAL) {
    const int nq = nr * ratio;
    *lo = (J + 1) * nq;
    *hi = min(Lq, (J + 2) * nq);
  } else if (MODE == L0_CAUSAL) {
    *lo = j;
    *hi = min(Lq, (J + 2) * nr);
  } else {
    *lo = max(0, (J - 1) * nr);
    *hi = min(Lq, (J + 2) * nr);
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
               int Lq, int Lk, int d, int dv, int nr, int ratio) {
  constexpr bool SUB = MODE == COARSE_CAUSAL;
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TQ;
  const int rows = min(TQ, Lq - t0);
  const int nk = band_keys(MODE, nr);
  const int kbase = key_start<SUB>(t0, nr, ratio);
  const int nwin = key_start<SUB>(t0 + rows - 1, nr, ratio) + nk - kbase;
  const int ks = d + 1, vs = dv + 1;
  float* k_s = smem;
  float* v_s = k_s + nwin * ks;
  float* w_s = v_s + nwin * vs;
  float* q_w = w_s + nwin;
  float* g_w = q_w + WARPS * d;

  // key window; rows outside [0, Lk) read as zero (masked by weight 0
  // and band_mask's in-range test)
  for (int e = threadIdx.x; e < nwin * d; e += blockDim.x) {
    const int r = e / d, c = e % d, j = kbase + r;
    k_s[r * ks + c] = (j >= 0 && j < Lk) ? k[((size_t)b * Lk + j) * d + c]
                                         : 0.f;
  }
  for (int e = threadIdx.x; e < nwin * dv; e += blockDim.x) {
    const int r = e / dv, c = e % dv, j = kbase + r;
    v_s[r * vs + c] = (j >= 0 && j < Lk) ? v[((size_t)b * Lk + j) * dv + c]
                                         : 0.f;
  }
  for (int r = threadIdx.x; r < nwin; r += blockDim.x) {
    const int j = kbase + r;
    w_s[r] = (j >= 0 && j < Lk) ? w[(size_t)b * Lk + j] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = q_w + warp * d;
  float* gw = g_w + warp * dv;
  for (int item = warp; item < G * rows; item += WARPS) {
    const int g = item / rows;
    const int i = t0 + item % rows;
    const size_t row = ((size_t)b * G + g) * Lq + i;
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
    const int k0 = key_start<SUB>(i, nr, ratio) - kbase;   // window offset
    const int qm = SUB ? i / ratio : i;                      // mask row

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
        const bool allow = band_mask(qm, kbase + r, nr, MODE, Lk) &&
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
                 float* __restrict__ dw, int G, int Lq, int Lk, int d,
                 int dv, int nr, int ratio, int tk) {
  constexpr bool SUB = MODE == COARSE_CAUSAL;
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * tk;
  const int keys = min(tk, Lk - j0);
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
    k_s[r * ks + c] = k[((size_t)b * Lk + j0 + r) * d + c];
    dk_s[e] = 0.f;
  }
  for (int e = threadIdx.x; e < keys * dv; e += blockDim.x) {
    const int r = e / dv, c = e % dv;
    v_s[r * vs + c] = v[((size_t)b * Lk + j0 + r) * dv + c];
    dv_s[e] = 0.f;
  }
  for (int r = threadIdx.x; r < keys; r += blockDim.x) {
    w_s[r] = w[(size_t)b * Lk + j0 + r];
    dw_s[r] = 0.f;
  }
  // the query rows of this key tile: lo and hi grow with j
  int qlo, qhi, unused;
  query_range<MODE>(j0, nr, ratio, Lq, &qlo, &unused);
  query_range<MODE>(j0 + keys - 1, nr, ratio, Lq, &unused, &qhi);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = 0; g < G; ++g) {
    const size_t base_row = ((size_t)b * G + g) * Lq;
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
        query_range<MODE>(j, nr, ratio, Lq, &lo, &hi);
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
            const bool allow =
                band_mask(SUB ? i / ratio : i, j, nr, MODE, Lk);
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
    dk[((size_t)b * Lk + j0) * d + e] = dk_s[e];
  for (int e = threadIdx.x; e < keys * dv; e += blockDim.x)
    dvo[((size_t)b * Lk + j0) * dv + e] = dv_s[e];
  for (int r = threadIdx.x; r < keys; r += blockDim.x)
    dw[(size_t)b * Lk + j0 + r] = dw_s[r];
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
           float* dk, float* dv_out, float* dw, int B, int G, int Lq, int Lk,
           int d, int dv, int nr, int ratio, cudaStream_t stream) {
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
  band_dq_kernel<MODE><<<dim3((Lq + TQ - 1) / TQ, B), WARPS * 32, smem_dq,
                         stream>>>(q, k, v, w, y, dn, m, gy, gdn, gm, dq, gmn,
                                   G, Lq, Lk, d, dv, nr, ratio);
  e = (int)cudaGetLastError();
  if (e) return e;

  // a sub level (and coarse_causal) takes one coarse block per CTA (at
  // least a key per warp)
  const int tk = MODE == COARSE_CAUSAL ? (nr > WARPS ? nr : WARPS) : TK_L0;
  const size_t smem_kv = ((size_t)tk * (d + 1) + (size_t)tk * (dv + 1) + tk +
                          (size_t)tk * (d + dv) + tk +
                          (size_t)QC * (d + 1) + (size_t)QC * (dv + 1) +
                          3 * QC) * sizeof(float);
  e = set_smem(band_dkvw_kernel<MODE>, smem_kv);
  if (e) return e;
  band_dkvw_kernel<MODE><<<dim3((Lk + tk - 1) / tk, B), WARPS * 32, smem_kv,
                           stream>>>(q, k, v, w, m, gy, gdn, gmn, dk, dv_out,
                                     dw, G, Lq, Lk, d, dv, nr, ratio, tk);
  return (int)cudaGetLastError();
}

}  // namespace

// Saved q (B,G,L,d), k (B,L,d), v (B,L,dv), w (B,L), y (B,G,L,dv),
// dn/m (B,G,L) and cotangents gy (B,G,L,dv), gdn/gm (B,G,L)
// -> dq (B,G,L,d), gmn (B,G,L), dk (B,L,d), dv (B,L,dv), dw (B,L);
// mode is an h1d::Mode (coarse_causal on the sub bodies at ratio 1).
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
                                   dk, dv_out, dw, B, G, L, L, d, dv, nr, 1,
                                   st);
    case h1d::L0_CAUSAL:
      return launch<h1d::L0_CAUSAL>(q, k, v, w, y, dn, m, gy, gdn, gm, dq,
                                    gmn, dk, dv_out, dw, B, G, L, L, d, dv,
                                    nr, 1, st);
    case h1d::COARSE_BIDIR:
      return launch<h1d::COARSE_BIDIR>(q, k, v, w, y, dn, m, gy, gdn, gm, dq,
                                       gmn, dk, dv_out, dw, B, G, L, L, d,
                                       dv, nr, 1, st);
    case h1d::COARSE_CAUSAL:
      return launch<h1d::COARSE_CAUSAL>(q, k, v, w, y, dn, m, gy, gdn, gm, dq,
                                        gmn, dk, dv_out, dw, B, G, L, L, d,
                                        dv, nr, 1, st);
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
  return launch<h1d::COARSE_CAUSAL>(q, k, v, w, y, dn, m, gy, gdn, gm, dq,
                                    gmn, dk, dv_out, dw, B, G, Lq, Lk, d, dv,
                                    nr, ratio, (cudaStream_t)stream);
}
