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
// keys (2*nr causal, nr at a sub level and in coarse_causal), so one row
// costs ~4*nr*d FLOPs against ~2*d*4 bytes of q and y: at nr=16, d=64
// about 8-12 FLOP per byte, below the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20).  The level's least time is the bytes it must move (q
// of the rows that have a live key, the key blocks some row reads, every
// output written once) over the memory rate.
//
// Two designs:
//   * l0_causal, l0_bidir, coarse_bidir (band_fwd_kernel): one CTA per
//     (batch row b, tile of TQ query rows) stages the tile's key window
//     (own keys, the nr-row prev halo, and the next halo in a
//     bidirectional mode) in shared memory once and reuses it for every
//     GQA group g.  A warp takes one query row at a time: lane j scores
//     key j, the softmax max and the dn sum are warp shuffles, and each
//     lane accumulates y for output columns lane, lane+32, ....  k rows
//     are padded to d+1 floats so 32 lanes reading 32 keys hit 32 banks.
//   * the sub level and coarse_causal (sub_fwd_kernel, the same structure
//     at ratio 1): query block I reads exactly key block I-1, so a CTA
//     takes a tile of SUB_TQ rows of one (b, g) and the one to SUB_TQ/nq
//     key blocks they read.  The tile's key weights come first: a block
//     none of whose keys has w > 0 (and query block 0, which has none) is
//     dead, its rows written as m = -1e30, y = 0, dn = 0 without reading q,
//     k or v; a tile of dead rows returns after that.  Live rows and
//     blocks are copied into shared memory with cp.async (16 bytes a
//     thread, no register staging).  Scores are 2-row x 4-key register
//     tiles of fmaf chains over float4 loads, in dot_qk's order, so m is
//     the row-per-warp body's bit for bit; first-half rows take only the
//     key groups of the first nr/2 keys (the masked quadrant is not
//     computed); the row max and dn are shuffles among the lanes of a row
//     pair.  y = a @ v is a 4-row x 4-column register tile over float4
//     loads of a and v, stored as float4.
// Plain fp32 FMA on CUDA cores (no TF32 and no wgmma: the port is held to
// fp32 parity), expf not __expf.
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
// tests.  Lq (the rows) and Lk (the keys) are equal in these modes; as
// one argument the body compiled to slower code on the H100.
template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
band_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                float* __restrict__ y, float* __restrict__ dn,
                float* __restrict__ m, int G, int Lq, int Lk, int d, int dv,
                int nr) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TQ;
  const int rows = min(TQ, Lq - t0);
  const int nk = band_keys(MODE, nr);
  const int kbase = key_start(t0, nr);
  const int nwin = key_start(t0 + rows - 1, nr) + nk - kbase;
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
    const int k0 = key_start(i, nr) - kbase;                 // window offset

    float s[MAXC];
    float mx = NEG_INF;
#pragma unroll
    for (int ch = 0; ch < MAXC; ++ch) {
      const int jj = lane + 32 * ch;
      s[ch] = NEG_INF;
      if (jj < nk) {
        const float acc = dot_qk(qw, k_s + (k0 + jj) * ks, d);
        const bool allow = band_mask(i, kbase + k0 + jj, nr, MODE, Lk) &&
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
           float* y, float* dn, float* m, int B, int G, int L, int d, int dv,
           int nr, cudaStream_t stream) {
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
  const dim3 grid((L + TQ - 1) / TQ, B);
  band_fwd_kernel<MODE><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, w, y, dn, m, G, L, L, d, dv, nr);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// sub level and coarse_causal
// ---------------------------------------------------------------------------

// Input row layouts that may be copied 16 bytes at a time.
enum { VEC_Q = 1, VEC_K = 2, VEC_V = 4 };

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
      return launch<h1d::L0_BIDIR>(q, k, v, w, y, dn, m, B, G, L, d, dv, nr,
                                   st);
    case h1d::L0_CAUSAL:
      return launch<h1d::L0_CAUSAL>(q, k, v, w, y, dn, m, B, G, L, d, dv, nr,
                                    st);
    case h1d::COARSE_BIDIR:
      return launch<h1d::COARSE_BIDIR>(q, k, v, w, y, dn, m, B, G, L, d, dv,
                                       nr, st);
    case h1d::COARSE_CAUSAL:
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
  return launch_sub(q, k, v, w, y, dn, m, B, G, Lq, Lk, d, dv, nr, ratio,
                    (cudaStream_t)stream);
}
