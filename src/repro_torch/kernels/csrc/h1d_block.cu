// Banded block attention forward for H-Transformer-1D, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/h1d_block.py:
//   * h1d_band_fwd     <- band_attention_fwd (_fwd_kernel), every band
//     mode: l0_causal, l0_bidir, coarse_bidir, coarse_causal;
//   * h1d_band_sub_fwd <- band_attention_sub_fwd (_fwd_sub_kernel), the
//     fine-q causal level l >= 1 (fine queries x 2^l-coarser keys).
// Both return the unnormalised float32 triple (y, dn, m) of one level:
//   s = q.k (q pre-scaled), s -> NEG_INF where band_mask fails or w <= 0,
//   m = max(rowmax s, -1e30), a = exp(s - m), y = a @ v, dn = sum a * w.
// A row with every key masked gives m = -1e30, y = 0, dn = 0.
//
// What bounds it on the H100: memory.  A query row attends at most 3*nr
// keys (2*nr causal, nr for a causal coarse level), so one row costs
// ~6*nr*d FLOPs against ~2*d*4 bytes of q and y: at nr=16, d=64 that is
// ~12 FLOP per byte, below the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20).  The level's least time is its bytes (q, k, v, w
// read once; y, dn, m written once) over the memory rate.
//
// Design: one CTA per (batch row b, tile of TQ query rows).  The CTA
// stages the tile's key window (its own keys plus the nr-row prev halo
// at level 0, and the nr-row next halo in a bidirectional mode; the
// coarse blocks I-1 of its query blocks at a sub level and in
// coarse_causal, which runs the sub body at ratio 1) in shared memory
// once and reuses it for every GQA group g, so K/V are
// read from HBM about once per tile and never copied per group.  A warp
// takes one query row at a time: lane j scores key j (keys in chunks of
// 32), the softmax max and the dn sum are warp shuffles, and each lane
// accumulates y for output columns lane, lane+32, ....  coarse_bidir
// stages and scores its own block, which band_mask then drops entirely
// (skipping it is left to a later optimisation).  The k rows in
// shared memory are padded to d+1 floats so the 32 lanes reading 32
// different keys hit 32 different banks.  Plain fp32 FMA on CUDA cores
// (no TF32: the port is held to fp32 parity), expf not __expf.
#include <cuda_runtime.h>
#include <math.h>

#include "h1d_band.cuh"

namespace {

using namespace h1d;

constexpr int TQ = 64;                // query rows per CTA
constexpr int WARPS = 8;
constexpr int MAXC = 4;               // key chunks of 32 per row: nk <= 128
constexpr int MAXU = 4;               // output column chunks: dv <= 128

// One instantiation per band mode, so band_mask folds to that mode's
// tests; coarse_causal is the sub body (SUB) at any ratio, ratio 1 for
// the coarse-q level, ratio 2**l for a fine-q sub level.
template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
band_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                float* __restrict__ y, float* __restrict__ dn,
                float* __restrict__ m, int G, int Lq, int Lk, int d, int dv,
                int nr, int ratio) {
  constexpr bool SUB = MODE == COARSE_CAUSAL;
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TQ;
  const int rows = min(TQ, Lq - t0);
  const int nk = band_keys(MODE, nr);
  const int kbase = key_start<SUB>(t0, nr, ratio);
  const int nwin = key_start<SUB>(t0 + rows - 1, nr, ratio) + nk - kbase;
  const int ks = d + 1;
  float* k_s = smem;
  float* v_s = k_s + nwin * ks;
  float* w_s = v_s + nwin * dv;
  float* q_s = w_s + nwin;

  // stage the key window; rows outside [0, Lk) read as zero (their
  // weight 0 and band_mask's in-range test mask them out)
  for (int e = threadIdx.x; e < nwin * d; e += blockDim.x) {
    const int r = e / d, c = e % d, j = kbase + r;
    k_s[r * ks + c] = (j >= 0 && j < Lk) ? k[((size_t)b * Lk + j) * d + c]
                                         : 0.f;
  }
  for (int e = threadIdx.x; e < nwin * dv; e += blockDim.x) {
    const int r = e / dv, c = e % dv, j = kbase + r;
    v_s[e] = (j >= 0 && j < Lk) ? v[((size_t)b * Lk + j) * dv + c] : 0.f;
  }
  for (int r = threadIdx.x; r < nwin; r += blockDim.x) {
    const int j = kbase + r;
    w_s[r] = (j >= 0 && j < Lk) ? w[(size_t)b * Lk + j] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = q_s + warp * d;
  for (int item = warp; item < G * rows; item += WARPS) {
    const int g = item / rows;
    const int i = t0 + item % rows;
    const size_t row = ((size_t)b * G + g) * Lq + i;
    for (int c = lane; c < d; c += 32) qw[c] = q[row * d + c];
    __syncwarp();
    const int k0 = key_start<SUB>(i, nr, ratio) - kbase;   // window offset
    const int qm = SUB ? i / ratio : i;                      // mask row

    float s[MAXC];
    float mx = NEG_INF;
#pragma unroll
    for (int ch = 0; ch < MAXC; ++ch) {
      const int jj = lane + 32 * ch;
      s[ch] = NEG_INF;
      if (jj < nk) {
        const float acc = dot_qk(qw, k_s + (k0 + jj) * ks, d);
        const bool allow = band_mask(qm, kbase + k0 + jj, nr, MODE, Lk) &&
                           w_s[k0 + jj] > 0.f;
        s[ch] = allow ? acc : NEG_INF;
      }
      mx = fmaxf(mx, s[ch]);
    }
    for (int off = 16; off; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float mrow = fmaxf(mx, MIN_M);

    float a[MAXC];
    float dsum = 0.f;
#pragma unroll
    for (int ch = 0; ch < MAXC; ++ch) {
      const int jj = lane + 32 * ch;
      a[ch] = 0.f;
      if (jj < nk) {
        a[ch] = expf(s[ch] - mrow);
        dsum = fmaf(a[ch], w_s[k0 + jj], dsum);
      }
    }
    for (int off = 16; off; off >>= 1)
      dsum += __shfl_xor_sync(FULL, dsum, off);

    float acc_y[MAXU];
#pragma unroll
    for (int u = 0; u < MAXU; ++u) acc_y[u] = 0.f;
#pragma unroll
    for (int ch = 0; ch < MAXC; ++ch) {
      if (32 * ch >= nk) break;
      const int n = min(32, nk - 32 * ch);
      for (int src = 0; src < n; ++src) {
        const float aj = __shfl_sync(FULL, a[ch], src);
        const float* vr = v_s + (k0 + 32 * ch + src) * dv;
#pragma unroll
        for (int u = 0; u < MAXU; ++u) {
          const int c = lane + 32 * u;
          if (c < dv) acc_y[u] = fmaf(aj, vr[c], acc_y[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MAXU; ++u) {
      const int c = lane + 32 * u;
      if (c < dv) y[row * dv + c] = acc_y[u];
    }
    if (lane == 0) {
      dn[row] = dsum;
      m[row] = mrow;
    }
    __syncwarp();
  }
}

// The key window of a CTA spans at most TQ - nr + nk keys: its query
// rows cover TQ / nr blocks and each reads nk keys from its first one.
template <int MODE>
int launch(const float* q, const float* k, const float* v, const float* w,
           float* y, float* dn, float* m, int B, int G, int Lq, int Lk, int d,
           int dv, int nr, int ratio, cudaStream_t stream) {
  const int nk = band_keys(MODE, nr);
  if (d < 1 || dv < 1 || dv > 32 * MAXU || nk > 32 * MAXC || TQ % nr != 0)
    return (int)cudaErrorInvalidValue;
  const int nwin_max = TQ - nr + nk;
  const size_t smem = ((size_t)nwin_max * (d + 1) + (size_t)nwin_max * dv +
                       nwin_max + (size_t)WARPS * d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        band_fwd_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Lq + TQ - 1) / TQ, B);
  band_fwd_kernel<MODE><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, w, y, dn, m, G, Lq, Lk, d, dv, nr, ratio);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,G,L,d) pre-scaled, k (B,L,d), v (B,L,dv) pre-weighted, w (B,L)
// -> y (B,G,L,dv), dn (B,G,L), m (B,G,L); mode is an h1d::Mode.
// coarse_causal reads only the block before a row's own: the sub body
// at ratio 1.
extern "C" int h1d_band_fwd(const float* q, const float* k, const float* v,
                            const float* w, float* y, float* dn, float* m,
                            int B, int G, int L, int d, int dv, int nr,
                            int mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case h1d::L0_BIDIR:
      return launch<h1d::L0_BIDIR>(q, k, v, w, y, dn, m, B, G, L, L, d, dv,
                                   nr, 1, st);
    case h1d::L0_CAUSAL:
      return launch<h1d::L0_CAUSAL>(q, k, v, w, y, dn, m, B, G, L, L, d, dv,
                                    nr, 1, st);
    case h1d::COARSE_BIDIR:
      return launch<h1d::COARSE_BIDIR>(q, k, v, w, y, dn, m, B, G, L, L, d,
                                       dv, nr, 1, st);
    case h1d::COARSE_CAUSAL:
      return launch<h1d::COARSE_CAUSAL>(q, k, v, w, y, dn, m, B, G, L, L, d,
                                        dv, nr, 1, st);
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
  return launch<h1d::COARSE_CAUSAL>(q, k, v, w, y, dn, m, B, G, Lq, Lk, d,
                                    dv, nr, ratio, (cudaStream_t)stream);
}
