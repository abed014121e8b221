// Single-token decode kernels for the hierarchical KV cache, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/h1d_decode_kernel.py:
//   * h1d_decode_attend <- decode_attend_fused (_attend_kernel);
//   * h1d_update_cache  <- update_cache_fused (_update_kernel).
//
// decode_attend: each cache row r (slots x kv-heads) attends, at position
// t[r], its own level-0 block (causal), the previous level-0 block, and
// one coarse block I_l - 1 per level l = 1..M-1 under the quadrant mask,
// with weight 2^l in the denominator only.  One max over all bands, then
// o = (a @ v) / max(a . w, 1e-9).  Block reads are clamped as the TPU
// kernel's index maps are, so no read leaves its array.
//
// update_cache: per level l = 0..nlev-1 the token's ancestor t >> l sits
// in sibling pair min(t >> (l+1), npairs-1), at row (t >> l) & 1; that row
// takes the carried value, and the next level's carry is the pair's mean
// (k) or sum (v).  Writes are in place: only the pair's selected rows
// change.  Bit-exact against the plain version: the same two-operand
// fp32 add and the same exact halving.
//
// What bounds them on the H100: neither bytes nor FLOPs.  At 64 rows and
// Lmax 2048, attend reads (M+1)*nr key and value rows per row, ~4 MB in
// all, and update touches ~2*nlev rows per row, well under 1 MB: a few
// microseconds of memory traffic, so each launch is bound by its launch
// latency and the serial chain inside one CTA.  Design: one CTA per
// cache row, no staging beyond the row's scores; every thread scores
// whole keys (dot over D from device memory, which the L1 keeps), the
// max and the denominator are block reductions over a few hundred
// scores, and the output columns are computed by one thread each.  The
// update kernel gives each thread one column and walks the ancestor chain
// in registers, so the levels need no synchronisation.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -3.4028234663852886e38f;   // hierarchy.NEG_INF
constexpr float MIN_M = -1e30f;
constexpr int MAXLEV = 32;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Levels {            // coarse levels l = 1..nlev (index l-1)
  const float* k[MAXLEV];
  const float* v[MAXLEV];
};

struct MutLevels {         // every level l = 0..nlev-1, level 0 = fine
  float* k[MAXLEV];
  float* v[MAXLEV];
};

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__global__ void __launch_bounds__(THREADS)
decode_attend_kernel(const float* __restrict__ q, const float* __restrict__ kf,
                     const float* __restrict__ vf, Levels lv,
                     const int* __restrict__ tpos, float* __restrict__ out,
                     int G, int Lmax, int D, int Dv, int nr, int ncoarse,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  const int t = tpos[r];
  const int K = (2 + ncoarse) * nr;
  const float** vrow = reinterpret_cast<const float**>(smem);  // (K,)
  float* q_s = reinterpret_cast<float*>(vrow + K);   // (G, D) scaled query
  float* s_s = q_s + G * D;          // (G, K) masked scores, then weights a
  float* w_s = s_s + G * K;          // (K,) band weights, 0 where masked
  float* den_s = w_s + K;            // (G,)

  for (int e = threadIdx.x; e < G * D; e += blockDim.x)
    q_s[e] = q[(size_t)r * G * D + e] * scale;
  __syncthreads();

  const int b0 = t / nr;
  const int nb0 = Lmax / nr;
  for (int kk = threadIdx.x; kk < K; kk += blockDim.x) {
    const int band = kk / nr, j = kk % nr;
    const float* krow;
    bool mask;
    float wgt;
    if (band < 2) {
      const int blk = band == 0 ? min(max(b0, 0), nb0 - 1) : max(b0 - 1, 0);
      const size_t off = ((size_t)r * Lmax + (size_t)blk * nr + j);
      krow = kf + off * D;
      vrow[kk] = vf + off * Dv;
      mask = band == 0 ? b0 * nr + j <= t : b0 >= 1;
      wgt = 1.f;
    } else {
      const int l = band - 1;
      const int span = nr << l;
      const int Il = t / span;
      const int nbl = (Lmax >> l) / nr;
      const int blk = min(max(Il - 1, 0), nbl - 1);
      const size_t off = ((size_t)r * (Lmax >> l) + (size_t)blk * nr + j);
      krow = lv.k[l - 1] + off * D;
      vrow[kk] = lv.v[l - 1] + off * Dv;
      const bool first_half_q = (t % span) < (span / 2);
      const bool key_last_half = j >= nr / 2;
      mask = Il >= 1 && !(first_half_q && key_last_half);
      wgt = (float)(1 << l);
    }
    w_s[kk] = mask ? wgt : 0.f;
    for (int g = 0; g < G; ++g) {
      const float* qg = q_s + g * D;
      float acc = 0.f;
      for (int c = 0; c < D; ++c) acc = fmaf(qg[c], krow[c], acc);
      s_s[g * K + kk] = mask ? acc : NEG_INF;
    }
  }
  __syncthreads();

  // one warp per group: single max, weights a = exp(s - m), denominator
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += blockDim.x / 32) {
    float* sg = s_s + g * K;
    float mx = NEG_INF;
    for (int kk = lane; kk < K; kk += 32) mx = fmaxf(mx, sg[kk]);
    const float m = fmaxf(warp_max(mx), MIN_M);
    float den = 0.f;
    for (int kk = lane; kk < K; kk += 32) {
      const float a = expf(sg[kk] - m);
      sg[kk] = a;
      den = fmaf(a, w_s[kk], den);
    }
    den = warp_sum(den);
    if (lane == 0) den_s[g] = den;
  }
  __syncthreads();

  for (int o = threadIdx.x; o < G * Dv; o += blockDim.x) {
    const int g = o / Dv, c = o % Dv;
    const float* ag = s_s + g * K;
    float acc = 0.f;
    for (int kk = 0; kk < K; ++kk) acc = fmaf(ag[kk], vrow[kk][c], acc);
    out[(size_t)r * G * Dv + o] = acc / fmaxf(den_s[g], 1e-9f);
  }
}

__global__ void update_cache_kernel(const float* __restrict__ knew,
                                    const float* __restrict__ vnew,
                                    const int* __restrict__ tpos,
                                    MutLevels lv, int Lmax, int D, int Dv,
                                    int nlev) {
  const int r = blockIdx.x;
  const int t = tpos[r];
  for (int c = threadIdx.x; c < D + Dv; c += blockDim.x) {
    const bool is_k = c < D;
    const int col = is_k ? c : c - D;
    const int width = is_k ? D : Dv;
    float carry = is_k ? knew[(size_t)r * D + col] : vnew[(size_t)r * Dv + col];
    for (int l = 0; l < nlev; ++l) {
      const int Ll = Lmax >> l;
      const int pair = max(min(t >> (l + 1), Ll / 2 - 1), 0);
      const int sel = (t >> l) & 1;
      float* base = (is_k ? lv.k[l] : lv.v[l]) +
                    ((size_t)r * Ll + 2 * (size_t)pair) * width + col;
      const float other = base[(size_t)(1 - sel) * width];
      base[(size_t)sel * width] = carry;
      if (l + 1 < nlev) {
        const float lo = sel ? other : carry;
        const float hi = sel ? carry : other;
        carry = is_k ? (lo + hi) * 0.5f : lo + hi;
      }
    }
  }
}

}  // namespace

// q (R,G,D), fine k (R,Lmax,D), v (R,Lmax,Dv), coarse ck[l-1]
// (R,Lmax>>l,D) and cv[l-1] for l = 1..ncoarse, t (R,) int32
// -> out (R,G,Dv), normalised.
extern "C" int h1d_decode_attend(const float* q, const float* k,
                                 const float* v, const void* const* ck,
                                 const void* const* cv, const int* t,
                                 float* out, int R, int G, int Lmax, int D,
                                 int Dv, int nr, int ncoarse, float scale,
                                 void* stream) {
  if (ncoarse < 0 || ncoarse > MAXLEV || R < 1) return (int)cudaErrorInvalidValue;
  Levels lv{};
  for (int l = 0; l < ncoarse; ++l) {
    lv.k[l] = static_cast<const float*>(ck[l]);
    lv.v[l] = static_cast<const float*>(cv[l]);
  }
  const int K = (2 + ncoarse) * nr;
  const size_t smem = (size_t)K * sizeof(const float*) +
                      (size_t)(G * D + G * K + K + G) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attend_kernel<<<R, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, lv, t, out, G, Lmax, D, Dv, nr, ncoarse, scale);
  return (int)cudaGetLastError();
}

// k_new (R,D), v_new (R,Dv), t (R,) int32; ks[l]/vs[l] are level l's
// (R, Lmax>>l, D/Dv) arrays for l = 0..nlev-1, updated in place.
extern "C" int h1d_update_cache(const float* knew, const float* vnew,
                                const int* t, void* const* ks,
                                void* const* vs, int R, int Lmax, int D,
                                int Dv, int nlev, void* stream) {
  if (nlev < 1 || nlev > MAXLEV || R < 1) return (int)cudaErrorInvalidValue;
  MutLevels lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.k[l] = static_cast<float*>(ks[l]);
    lv.v[l] = static_cast<float*>(vs[l]);
  }
  const int threads = min(1024, ((D + Dv + 31) / 32) * 32);
  update_cache_kernel<<<R, threads, 0, (cudaStream_t)stream>>>(
      knew, vnew, t, lv, Lmax, D, Dv, nlev);
  return (int)cudaGetLastError();
}
