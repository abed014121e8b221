// Single-token decode kernels for the hierarchical KV cache, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/h1d_decode_kernel.py:
//   * h1d_decode_attend             <- decode_attend_fused (_attend_kernel);
//   * h1d_decode_attend_paged       <- decode_attend_paged;
//   * h1d_decode_attend_paged_quant <- decode_attend_paged_quant;
//   * h1d_update_cache              <- update_cache_fused (_update_kernel);
//   * h1d_update_cache_paged        <- update_cache_paged;
//   * h1d_update_cache_paged_quant  <- update_cache_paged_quant
//                                      (_update_paged_quant_kernel);
//   * h1d_decode_attend_partial     <- decode_attend_partial
//                                      (_attend_partial_kernel);
//   * h1d_update_cache_partial      <- update_cache_partial
//                                      (_update_partial_kernel).
//
// decode_attend: each cache row r (slots x kv-heads) attends, at position
// t[r], its own level-0 block (causal), the previous level-0 block, and
// one coarse block I_l - 1 per level l = 1..M-1 under the quadrant mask,
// with weight 2^l in the denominator only.  One max over all bands, then
// o = (a @ v) / max(a . w, 1e-9).  The dense, the paged and the
// sequence-parallel kernels share this body; only the addressor
// `band_row` differs: dense reads block (row, level, block) of the row's
// own slab (clamped as the TPU kernel's index maps are), paged reads pool
// row bidx[r, band] * nr + j, and local reads block bidx[r, band] of the
// row's slab in one shard's level array, whose row count per level the
// caller passes (a sharded level holds (Lmax >> l) / d rows, a replicated
// one Lmax >> l).  The local variant (#11) also masks each band by its
// ownership bit owned[r, band], reads nothing of a band that is unowned
// or masked whole and no key row that is masked, and writes the
// unnormalised partial num = a @ v, den = a . w and m = max(rowmax,
// -1e30) for the cross-shard merge; t stays global, so every mask
// compares global positions.  The int8 variant dequantizes each key and
// value row with its per-row scale before the dot product (float(q) *
// scale, as the plain version does); fp32 levels of a mixed pool never
// read their scales.
//
// update_cache: per level l = 0..nlev-1 the token's ancestor t >> l sits
// in one sibling pair at row (t >> l) & 1; that row takes the carried
// value, and the next level's carry is the pair's mean (k) or sum (v).
// Dense: pair min(t >> (l+1), npairs-1) of the row's slab; paged: pair
// (t >> (l+1)) & (nr/2 - 1) of page utab[r, l].  Writes are in place.
// The partial update (#12) is the dense one on one shard's sharded levels
// at the shard-local t_loc (clamped low only, so the pair index clamps and
// the sibling parity (t_loc >> l) & 1 stays the unclamped one): only rows
// with owned[r] != 0 write, and every row emits the pair mean / sum after
// its last level, the carried row of the first replicated level (on a
// non-owner row it comes from the unchanged pair, finite, and the caller
// masks it out).
// The int8 variant dequantizes the pair, puts in the new row, and
// requantizes both rows with fresh absmax per-row scales (the rounding of
// core/quantization.py: scale = max(amax, 1e-12) * float32(1/127), q =
// clamp(rint(x / scale), -127, 127), IEEE division, round half to even);
// its carry is the f32 pair before quantization.  Every product and sum
// of the update path is an explicitly rounded intrinsic, so no FMA
// contraction can leave the plain version's bits.
//
// Page tables: inactive engine rows all point their update rows at the
// TRASH page, so several CTAs may write the same TRASH rows; the TPU ran
// them one after another, here they race.  Outputs do not depend on it:
// every band that reads TRASH is masked (weight 0, exp(NEG_INF - m) = 0)
// and the racing writes are whole finite values.  Every other write
// target is private to one cache row (the engine copies shared pages on
// write and allocates fresh ones before the tick).
//
// What bounds them on the H100: neither bytes nor FLOPs.  At 64 rows and
// Lmax 2048, attend reads (M+1)*nr key and value rows per row, ~4 MB in
// all (int8: a quarter), and update touches ~2*nlev rows per row, well
// under 1 MB: a few microseconds of memory traffic, so each launch is
// bound by its launch latency and the serial chain inside one CTA.
// Design: one CTA per cache row, no staging beyond the row's scores;
// every thread scores whole keys (dot over D from device memory, which
// the L1 keeps), the max and the denominator are warp reductions over a
// few hundred scores, and the output columns are computed by one thread
// each.  The update kernels give each thread one column and walk the
// ancestor chain in registers; the int8 one adds a block absmax per
// level (warp maxima combined by an integer atomicMax on the non-negative
// float bits, which is exact and order-free).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -3.4028234663852886e38f;   // hierarchy.NEG_INF
constexpr float MIN_M = -1e30f;
constexpr int MAXLEV = 32;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// core/quantization.py's Python constants, rounded to float32 as a
// float32 tensor times a Python float rounds them
constexpr float QMAX = 127.0f;
constexpr float RECIP_QMAX = (float)(1.0 / 127.0);
constexpr float QEPS = (float)1e-12;
// band addressors of the attend body
constexpr int ADDR_DENSE = 0, ADDR_PAGED = 1, ADDR_LOCAL = 2;

struct Levels {            // every level l = 0..nlev-1, level 0 = fine
  const void* k[MAXLEV];
  const void* v[MAXLEV];
  const float* ksc[MAXLEV];   // per-row scales of int8 levels
  const float* vsc[MAXLEV];
  int rows[MAXLEV];           // LOCAL: rows of level l in a shard's slab
  unsigned qmask;             // bit l set: level l stores int8 rows
};

struct MutLevels {
  void* k[MAXLEV];
  void* v[MAXLEV];
  float* ksc[MAXLEV];
  float* vsc[MAXLEV];
  unsigned qmask;
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

__device__ __forceinline__ int band_level(int band) {
  return band < 2 ? 0 : band - 1;
}

// Row, in its level's (rows, width) array, of key j of `band` for cache
// row r at position t; `rows_l` is the LOCAL slab's row count of the
// band's level.
template <int ADDR>
__device__ __forceinline__ size_t band_row(int r, int band, int j, int t,
                                           const int* bidx, int nbands,
                                           int Lmax, int nr, int rows_l) {
  if (ADDR == ADDR_PAGED)
    return (size_t)bidx[(size_t)r * nbands + band] * nr + j;
  if (ADDR == ADDR_LOCAL)
    return (size_t)r * rows_l +
           (size_t)bidx[(size_t)r * nbands + band] * nr + j;
  const int l = band_level(band);
  const int Ll = Lmax >> l;
  const int nbl = Ll / nr;
  int blk;
  if (band == 0) blk = min(max(t / nr, 0), nbl - 1);
  else if (band == 1) blk = max(t / nr - 1, 0);
  else blk = min(max(t / (nr << l) - 1, 0), nbl - 1);
  return (size_t)r * Ll + (size_t)blk * nr + j;
}

// LOCAL: whether any key of `band` counts for a row at position t whose
// band ownership bits are own_r: the band is owned, and not masked whole
// (band 1 before the second fine block, a coarse band before I_l = 1).
__device__ __forceinline__ bool band_live(int band, int t, int nr,
                                          const int* own_r) {
  if (own_r[band] <= 0) return false;
  if (band == 0) return true;
  return t / (band == 1 ? nr : nr << band_level(band)) >= 1;
}

// First row of the sibling pair that holds ancestor t >> l.
template <bool PAGED>
__device__ __forceinline__ size_t pair_row(int r, int l, int t,
                                           const int* utab, int nlev,
                                           int Lmax, int nr) {
  if (PAGED)
    return (size_t)utab[(size_t)r * nlev + l] * nr +
           2 * (size_t)((t >> (l + 1)) & (nr / 2 - 1));
  const int Ll = Lmax >> l;
  const int pair = max(min(t >> (l + 1), Ll / 2 - 1), 0);
  return (size_t)r * Ll + 2 * (size_t)pair;
}

// out: normalised (R, G, Dv); LOCAL: the partial num there, den and m
// (R, G) in den_out / m_out.
template <int ADDR, bool QUANT>
__global__ void __launch_bounds__(THREADS)
decode_attend_kernel(const float* __restrict__ q, Levels lv,
                     const int* __restrict__ tpos,
                     const int* __restrict__ bidx,
                     const int* __restrict__ owned, float* __restrict__ out,
                     float* __restrict__ den_out, float* __restrict__ m_out,
                     int G, int Lmax, int D, int Dv, int nr, int nlev,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  const int t = tpos[r];
  const int nbands = nlev + 1;
  const int K = nbands * nr;
  // value rows as pointers; the output loop reads them with the row type
  // fixed per band (a branch per key, or a row index multiply per key,
  // serializes the loads of the dependent fmaf chain and ran markedly
  // slower)
  const void** vrow = reinterpret_cast<const void**>(smem);   // (K,)
  float* q_s = reinterpret_cast<float*>(vrow + K);   // (G, D) scaled query
  float* s_s = q_s + G * D;          // (G, K) masked scores, then weights a
  float* w_s = s_s + G * K;          // (K,) band weights, 0 where masked
  float* vsc_s = w_s + K;            // (K,) value row scales (int8 rows)
  float* den_s = vsc_s + K;          // (G,)

  for (int e = threadIdx.x; e < G * D; e += blockDim.x)
    q_s[e] = q[(size_t)r * G * D + e] * scale;
  __syncthreads();

  const int b0 = t / nr;
  for (int kk = threadIdx.x; kk < K; kk += blockDim.x) {
    const int band = kk / nr, j = kk % nr;
    const int l = band_level(band);
    if (ADDR == ADDR_LOCAL &&
        !band_live(band, t, nr, owned + (size_t)r * nbands)) {
      // nothing of the band counts on this shard: read none of it (its
      // weights a = exp(NEG_INF - m) are exactly 0 either way)
      w_s[kk] = 0.f;
      vrow[kk] = nullptr;
      for (int g = 0; g < G; ++g) s_s[g * K + kk] = NEG_INF;
      continue;
    }
    const size_t row = band_row<ADDR>(r, band, j, t, bidx, nbands, Lmax, nr,
                                      lv.rows[l]);
    bool mask;
    float wgt;
    if (band == 0) {
      mask = b0 * nr + j <= t;
      wgt = 1.f;
    } else if (band == 1) {
      mask = b0 >= 1;
      wgt = 1.f;
    } else {
      const int span = nr << l;
      const int Il = t / span;
      const bool first_half_q = (t % span) < (span / 2);
      const bool key_last_half = j >= nr / 2;
      mask = Il >= 1 && !(first_half_q && key_last_half);
      wgt = (float)(1 << l);
    }
    w_s[kk] = mask ? wgt : 0.f;
    const bool qz = QUANT && ((lv.qmask >> l) & 1u);
    if (qz) {
      vrow[kk] = static_cast<const int8_t*>(lv.v[l]) + row * Dv;
      vsc_s[kk] = lv.vsc[l][row];
    } else {
      vrow[kk] = static_cast<const float*>(lv.v[l]) + row * Dv;
    }
    if (ADDR == ADDR_LOCAL && !mask) {   // a masked key of a live band
      for (int g = 0; g < G; ++g) s_s[g * K + kk] = NEG_INF;
      continue;
    }
    for (int g = 0; g < G; ++g) {
      const float* qg = q_s + g * D;
      float acc = 0.f;
      if (qz) {
        const int8_t* krow = static_cast<const int8_t*>(lv.k[l]) + row * D;
        const float ks = lv.ksc[l][row];
        for (int c = 0; c < D; ++c)
          acc = fmaf(qg[c], __fmul_rn((float)krow[c], ks), acc);
      } else {
        const float* krow = static_cast<const float*>(lv.k[l]) + row * D;
        for (int c = 0; c < D; ++c) acc = fmaf(qg[c], krow[c], acc);
      }
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
    if (lane == 0) {
      den_s[g] = den;
      if (ADDR == ADDR_LOCAL) {
        den_out[(size_t)r * G + g] = den;
        m_out[(size_t)r * G + g] = m;
      }
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < G * Dv; o += blockDim.x) {
    const int g = o / Dv, c = o % Dv;
    const float* ag = s_s + g * K;
    float acc = 0.f;
    if (QUANT) {
      int kk = 0;
      for (int band = 0; band < nbands; ++band) {
        if ((lv.qmask >> band_level(band)) & 1u) {
          for (int j = 0; j < nr; ++j, ++kk)
            acc = fmaf(ag[kk], __fmul_rn(
                (float)static_cast<const int8_t*>(vrow[kk])[c], vsc_s[kk]),
                acc);
        } else {
          for (int j = 0; j < nr; ++j, ++kk)
            acc = fmaf(ag[kk], static_cast<const float*>(vrow[kk])[c], acc);
        }
      }
    } else if (ADDR == ADDR_LOCAL) {
      for (int k0 = 0; k0 < K; k0 += nr) {
        if (!vrow[k0]) continue;     // a band that is not live adds 0
        for (int kk = k0; kk < k0 + nr; ++kk)
          acc = fmaf(ag[kk], static_cast<const float*>(vrow[kk])[c], acc);
      }
    } else {
      for (int kk = 0; kk < K; ++kk)
        acc = fmaf(ag[kk], static_cast<const float*>(vrow[kk])[c], acc);
    }
    out[(size_t)r * G * Dv + o] =
        ADDR == ADDR_LOCAL ? acc : acc / fmaxf(den_s[g], 1e-9f);
  }
}

// PARTIAL: only rows with owned[r] != 0 write; every row's carry after
// the last level goes to carry_k / carry_v (R, D / Dv).
template <bool PAGED, bool PARTIAL>
__global__ void update_cache_kernel(const float* __restrict__ knew,
                                    const float* __restrict__ vnew,
                                    const int* __restrict__ tpos,
                                    const int* __restrict__ utab,
                                    const int* __restrict__ owned,
                                    MutLevels lv, int Lmax, int D, int Dv,
                                    int nr, int nlev,
                                    float* __restrict__ carry_k,
                                    float* __restrict__ carry_v) {
  const int r = blockIdx.x;
  const int t = tpos[r];
  const bool own = !PARTIAL || owned[r] != 0;
  for (int c = threadIdx.x; c < D + Dv; c += blockDim.x) {
    const bool is_k = c < D;
    const int col = is_k ? c : c - D;
    const int width = is_k ? D : Dv;
    float carry = is_k ? knew[(size_t)r * D + col] : vnew[(size_t)r * Dv + col];
    for (int l = 0; l < nlev; ++l) {
      const size_t row0 = pair_row<PAGED>(r, l, t, utab, nlev, Lmax, nr);
      const int sel = (t >> l) & 1;
      float* base = static_cast<float*>(is_k ? lv.k[l] : lv.v[l]) +
                    row0 * width + col;
      const float other = base[(size_t)(1 - sel) * width];
      float mine = carry;
      if (own) base[(size_t)sel * width] = carry;
      else mine = base[(size_t)sel * width];
      if (PARTIAL || l + 1 < nlev) {
        const float lo = sel ? other : mine;
        const float hi = sel ? mine : other;
        carry = is_k ? __fmul_rn(__fadd_rn(lo, hi), 0.5f) : __fadd_rn(lo, hi);
      }
    }
    if (PARTIAL) (is_k ? carry_k : carry_v)[(size_t)r * width + col] = carry;
  }
}

__device__ __forceinline__ int8_t quantize(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -QMAX), QMAX);
}

// One column per thread (blockDim.x >= D + Dv, a multiple of 32).
__global__ void update_cache_quant_kernel(const float* __restrict__ knew,
                                          const float* __restrict__ vnew,
                                          const int* __restrict__ tpos,
                                          const int* __restrict__ utab,
                                          MutLevels lv, int D, int Dv, int nr,
                                          int nlev) {
  __shared__ unsigned amax_s[4];     // float bits: k row 0, 1; v row 0, 1
  const int r = blockIdx.x;
  const int t = tpos[r];
  const int c = threadIdx.x;
  const bool live = c < D + Dv;
  const bool is_k = c < D;
  const int col = is_k ? c : c - D;
  const int width = is_k ? D : Dv;
  const int lane = threadIdx.x % 32;
  float carry = 0.f;
  if (live)
    carry = is_k ? knew[(size_t)r * D + col] : vnew[(size_t)r * Dv + col];
  for (int l = 0; l < nlev; ++l) {
    const size_t row0 = pair_row<true>(r, l, t, utab, nlev, 0, nr);
    const int sel = (t >> l) & 1;
    const bool qz = (lv.qmask >> l) & 1u;       // uniform over the block
    float x0 = 0.f, x1 = 0.f;
    if (live) {
      if (qz) {
        const int8_t* b = static_cast<const int8_t*>(is_k ? lv.k[l] : lv.v[l])
                          + row0 * width + col;
        const float* sc = (is_k ? lv.ksc[l] : lv.vsc[l]) + row0;
        x0 = __fmul_rn((float)b[0], sc[0]);
        x1 = __fmul_rn((float)b[width], sc[1]);
      } else {
        const float* b = static_cast<const float*>(is_k ? lv.k[l] : lv.v[l])
                         + row0 * width + col;
        x0 = b[0];
        x1 = b[width];
      }
      if (sel) x1 = carry; else x0 = carry;
    }
    if (qz) {
      if (threadIdx.x < 4) amax_s[threadIdx.x] = 0u;
      __syncthreads();
      const float a[4] = {live && is_k ? fabsf(x0) : 0.f,
                          live && is_k ? fabsf(x1) : 0.f,
                          live && !is_k ? fabsf(x0) : 0.f,
                          live && !is_k ? fabsf(x1) : 0.f};
      for (int i = 0; i < 4; ++i) {
        const float m = warp_max(a[i]);
        if (lane == 0) atomicMax(&amax_s[i], __float_as_uint(m));
      }
      __syncthreads();
      if (live) {
        const int i = is_k ? 0 : 2;
        const float s0 = __fmul_rn(fmaxf(__uint_as_float(amax_s[i]), QEPS),
                                   RECIP_QMAX);
        const float s1 = __fmul_rn(fmaxf(__uint_as_float(amax_s[i + 1]),
                                         QEPS), RECIP_QMAX);
        int8_t* b = static_cast<int8_t*>(is_k ? lv.k[l] : lv.v[l]) +
                    row0 * width + col;
        b[0] = quantize(x0, s0);
        b[width] = quantize(x1, s1);
        if (col == 0) {
          float* sc = (is_k ? lv.ksc[l] : lv.vsc[l]) + row0;
          sc[0] = s0;
          sc[1] = s1;
        }
      }
      __syncthreads();               // amax_s is reset at the next level
    } else if (live) {
      float* b = static_cast<float*>(is_k ? lv.k[l] : lv.v[l]) +
                 row0 * width + col;
      b[0] = x0;
      b[width] = x1;
    }
    carry = is_k ? __fmul_rn(__fadd_rn(x0, x1), 0.5f) : __fadd_rn(x0, x1);
  }
}

size_t attend_smem(int G, int D, int nlev, int nr) {
  const int K = (nlev + 1) * nr;
  return (size_t)K * sizeof(void*) +
         (size_t)(G * D + G * K + 2 * K + G) * sizeof(float);
}

template <int ADDR, bool QUANT>
int launch_attend(const float* q, const Levels& lv, const int* t,
                  const int* bidx, const int* owned, float* out, float* den,
                  float* m, int R, int G, int Lmax, int D, int Dv, int nr,
                  int nlev, float scale, void* stream) {
  if (nlev < 1 || nlev > MAXLEV || R < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = attend_smem(G, D, nlev, nr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attend_kernel<ADDR, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attend_kernel<ADDR, QUANT>
      <<<R, THREADS, smem, (cudaStream_t)stream>>>(
          q, lv, t, bidx, owned, out, den, m, G, Lmax, D, Dv, nr, nlev,
          scale);
  return (int)cudaGetLastError();
}

Levels read_levels(const void* const* ks, const void* const* vs,
                   const void* const* kscs, const void* const* vscs,
                   unsigned qmask, int nlev) {
  Levels lv{};
  for (int l = 0; l < nlev && l < MAXLEV; ++l) {
    lv.k[l] = ks[l];
    lv.v[l] = vs[l];
    if (kscs) lv.ksc[l] = static_cast<const float*>(kscs[l]);
    if (vscs) lv.vsc[l] = static_cast<const float*>(vscs[l]);
  }
  lv.qmask = qmask;
  return lv;
}

MutLevels write_levels(void* const* ks, void* const* vs, void* const* kscs,
                       void* const* vscs, unsigned qmask, int nlev) {
  MutLevels lv{};
  for (int l = 0; l < nlev && l < MAXLEV; ++l) {
    lv.k[l] = ks[l];
    lv.v[l] = vs[l];
    if (kscs) lv.ksc[l] = static_cast<float*>(kscs[l]);
    if (vscs) lv.vsc[l] = static_cast<float*>(vscs[l]);
  }
  lv.qmask = qmask;
  return lv;
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
  if (ncoarse < 0 || ncoarse + 1 > MAXLEV) return (int)cudaErrorInvalidValue;
  Levels lv{};
  lv.k[0] = k;
  lv.v[0] = v;
  for (int l = 0; l < ncoarse; ++l) {
    lv.k[l + 1] = ck[l];
    lv.v[l + 1] = cv[l];
  }
  return launch_attend<ADDR_DENSE, false>(q, lv, t, nullptr, nullptr, out,
                                          nullptr, nullptr, R, G, Lmax, D,
                                          Dv, nr, ncoarse + 1, scale, stream);
}

// Paged pools: ks[l]/vs[l] level l's (NP_l, nr, D/Dv) f32 pages for
// l = 0..nlev-1; bidx (R, nlev+1) int32 physical pool rows per band.
extern "C" int h1d_decode_attend_paged(const float* q, const void* const* ks,
                                       const void* const* vs, const int* t,
                                       const int* bidx, float* out, int R,
                                       int G, int D, int Dv, int nr,
                                       int nlev, float scale, void* stream) {
  if (nlev < 1 || nlev > MAXLEV) return (int)cudaErrorInvalidValue;
  const Levels lv = read_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  return launch_attend<ADDR_PAGED, false>(q, lv, t, bidx, nullptr, out,
                                          nullptr, nullptr, R, G, 0, D, Dv,
                                          nr, nlev, scale, stream);
}

// As h1d_decode_attend_paged; level l stores int8 pages when bit l of
// qmask is set, with per-row f32 scales kscs[l]/vscs[l] (NP_l, nr).
extern "C" int h1d_decode_attend_paged_quant(
    const float* q, const void* const* ks, const void* const* vs,
    const void* const* kscs, const void* const* vscs, int qmask,
    const int* t, const int* bidx, float* out, int R, int G, int D, int Dv,
    int nr, int nlev, float scale, void* stream) {
  if (nlev < 1 || nlev > MAXLEV) return (int)cudaErrorInvalidValue;
  const Levels lv = read_levels(ks, vs, kscs, vscs, (unsigned)qmask, nlev);
  return launch_attend<ADDR_PAGED, true>(q, lv, t, bidx, nullptr, out,
                                         nullptr, nullptr, R, G, 0, D, Dv, nr,
                                         nlev, scale, stream);
}

// k_new (R,D), v_new (R,Dv), t (R,) int32; ks[l]/vs[l] are level l's
// (R, Lmax>>l, D/Dv) arrays for l = 0..nlev-1, updated in place.
extern "C" int h1d_update_cache(const float* knew, const float* vnew,
                                const int* t, void* const* ks,
                                void* const* vs, int R, int Lmax, int D,
                                int Dv, int nlev, void* stream) {
  if (nlev < 1 || nlev > MAXLEV || R < 1) return (int)cudaErrorInvalidValue;
  const MutLevels lv = write_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  const int threads = min(1024, ((D + Dv + 31) / 32) * 32);
  update_cache_kernel<false, false><<<R, threads, 0, (cudaStream_t)stream>>>(
      knew, vnew, t, nullptr, nullptr, lv, Lmax, D, Dv, 0, nlev, nullptr,
      nullptr);
  return (int)cudaGetLastError();
}

// Paged pools: ks[l]/vs[l] level l's (NP_l, nr, D/Dv) f32 pages; utab
// (R, nlev) int32 physical pool rows of the ancestor pages.
extern "C" int h1d_update_cache_paged(const float* knew, const float* vnew,
                                      const int* t, const int* utab,
                                      void* const* ks, void* const* vs,
                                      int R, int D, int Dv, int nr, int nlev,
                                      void* stream) {
  if (nlev < 1 || nlev > MAXLEV || R < 1 || nr < 2)
    return (int)cudaErrorInvalidValue;
  const MutLevels lv = write_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  const int threads = min(1024, ((D + Dv + 31) / 32) * 32);
  update_cache_kernel<true, false><<<R, threads, 0, (cudaStream_t)stream>>>(
      knew, vnew, t, utab, nullptr, lv, 0, D, Dv, nr, nlev, nullptr,
      nullptr);
  return (int)cudaGetLastError();
}

// As h1d_update_cache_paged with int8 levels (bit l of qmask) and their
// per-row scales kscs[l]/vscs[l] (NP_l, nr), rewritten in place.
extern "C" int h1d_update_cache_paged_quant(
    const float* knew, const float* vnew, const int* t, const int* utab,
    void* const* ks, void* const* vs, void* const* kscs, void* const* vscs,
    int qmask, int R, int D, int Dv, int nr, int nlev, void* stream) {
  const int threads = ((D + Dv + 31) / 32) * 32;
  if (nlev < 1 || nlev > MAXLEV || R < 1 || nr < 2 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  const MutLevels lv = write_levels(ks, vs, kscs, vscs, (unsigned)qmask,
                                    nlev);
  update_cache_quant_kernel<<<R, threads, 0, (cudaStream_t)stream>>>(
      knew, vnew, t, utab, lv, D, Dv, nr, nlev);
  return (int)cudaGetLastError();
}

// One shard's slab: ks[l]/vs[l] level l's (R, rows[l], D/Dv) f32 arrays
// for l = 0..nlev-1 (rows: host array, each a multiple of nr); bidx and
// owned (R, nlev+1) int32 local block index and ownership bit per band; t
// (R,) global positions -> num (R,G,Dv), den (R,G), m (R,G), unnormalised.
extern "C" int h1d_decode_attend_partial(
    const float* q, const void* const* ks, const void* const* vs,
    const int* rows, const int* t, const int* bidx, const int* owned,
    float* num, float* den, float* m, int R, int G, int D, int Dv, int nr,
    int nlev, float scale, void* stream) {
  if (nlev < 1 || nlev > MAXLEV) return (int)cudaErrorInvalidValue;
  Levels lv = read_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  for (int l = 0; l < nlev; ++l) lv.rows[l] = rows[l];
  return launch_attend<ADDR_LOCAL, false>(q, lv, t, bidx, owned, num, den, m,
                                          R, G, 0, D, Dv, nr, nlev, scale,
                                          stream);
}

// One shard's sharded levels: ks[l]/vs[l] (R, Lloc>>l, D/Dv) for
// l = 0..nlev-1, updated in place on rows with owned[r] != 0; t_loc (R,)
// shard-local positions (may exceed Lloc) -> carry_k (R,D), carry_v
// (R,Dv).
extern "C" int h1d_update_cache_partial(const float* knew, const float* vnew,
                                        const int* t_loc, const int* owned,
                                        void* const* ks, void* const* vs,
                                        float* carry_k, float* carry_v,
                                        int R, int Lloc, int D, int Dv,
                                        int nlev, void* stream) {
  if (nlev < 1 || nlev > MAXLEV || R < 1) return (int)cudaErrorInvalidValue;
  const MutLevels lv = write_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  const int threads = min(1024, ((D + Dv + 31) / 32) * 32);
  update_cache_kernel<false, true><<<R, threads, 0, (cudaStream_t)stream>>>(
      knew, vnew, t_loc, nullptr, owned, lv, Lloc, D, Dv, 0, nlev, carry_k,
      carry_v);
  return (int)cudaGetLastError();
}
