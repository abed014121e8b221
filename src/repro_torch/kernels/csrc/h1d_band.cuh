// Band structure shared by the forward (h1d_block.cu) and backward
// (h1d_block_bwd.cu) kernels of the banded block attention, so the two
// passes cannot drift apart: the mask, the first key of a query row, the
// masking constants, the score's summation order and the launch geometry
// of the fine-q sub level.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace h1d {

constexpr float NEG_INF = -3.0e38f;   // h1d_block.NEG_INF
constexpr float MIN_M = -1e30f;       // h1d_block._MIN_M
constexpr unsigned FULL = 0xffffffffu;

enum Mode { L0_BIDIR = 0, L0_CAUSAL = 1, COARSE_BIDIR = 2, COARSE_CAUSAL = 3 };

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (q * b > a) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

// Port of repro/kernels/h1d_block.py band_mask for global row/col indices.
__device__ __forceinline__ bool band_mask(int qi, int ki, int nr, int mode,
                                          int lk) {
  const bool inb = ki >= 0 && ki < lk;
  const int diff = floordiv(qi, nr) - floordiv(ki, nr);
  bool allow;
  if (mode == L0_BIDIR) {
    allow = abs(diff) <= 1;
  } else if (mode == L0_CAUSAL) {
    allow = (diff == 0 && ki <= qi) || diff == 1;
  } else {
    const int half = nr / 2;
    const bool base = mode == COARSE_CAUSAL ? diff == 1 : abs(diff) == 1;
    const bool sub_excl = diff == 1 && floormod(qi, nr) < half &&
                          floormod(ki, nr) >= half;
    const bool sup_excl = diff == -1 && floormod(qi, nr) >= half &&
                          floormod(ki, nr) < half;
    allow = base && !sub_excl && !sup_excl;
  }
  return allow && inb;
}

// Keys of a query row's band from its first key on, in the modes of the
// row-per-warp bodies: l0_causal reads the block before the row's own and
// its own, a bidirectional mode those two and the block after.
__host__ __device__ __forceinline__ int band_keys(int mode, int nr) {
  return mode == L0_CAUSAL ? 2 * nr : 3 * nr;
}

// First key of query row i: the first key of the block before its own.
__device__ __forceinline__ int key_start(int i, int nr) {
  return (i / nr) * nr - nr;
}

// The score s = q . k, as one fmaf chain in column order.  Every pass
// computes it in this order (here, or four keys at a time in dot_tile and
// dot_tile2), so the backward's recomputed s is bit for bit the forward's
// and the argmax test s == m finds the forward's maximum.
__device__ __forceinline__ float dot_qk(const float* qr, const float* kr,
                                        int d) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc = fmaf(qr[c], kr[c], acc);
  return acc;
}

// ---------------------------------------------------------------------------
// Fine-q sub level (and coarse_causal, the same structure at ratio 1)
// ---------------------------------------------------------------------------
//
// Query block I (nq = nr * ratio fine rows) reads exactly one coarse key
// block, J = I - 1, and key block J is read by query block J + 1 alone.
// A row at position p of its block is in the "first half" when
// p / ratio < nr / 2, i.e. p < nq / 2: band_mask's sub_excl then drops
// the last nr / 2 keys of its band.  Query block 0 has no key.
//
// Both passes work on tiles of rows in shared memory with 128 threads.
// The score pass gives each thread a pair of rows and a group of 4 keys
// (a 2 x 4 register tile of dot products); the threads of one row pair
// sit in adjacent lanes, so the row max and the row sums are a few
// shuffles.  First-half rows get only the key groups that cover the
// first nr / 2 keys: the masked quadrant is not computed.

constexpr int SUB_THREADS = 128;
constexpr int SUB_TQ = 64;        // query rows a tile (at most, backward)
constexpr int SUB_MAX_SPLIT = 8;  // backward: CTAs (one cluster) per key block

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
// groups of 4 keys covering n keys
__host__ __device__ __forceinline__ int key_groups(int n) {
  return (n + 3) / 4;
}

// Key rows of the forward's shared window: the blocks a tile of SUB_TQ
// rows spans, plus one group of 4 for the last key group's overrun.
__host__ __device__ __forceinline__ int sub_fwd_window(int nr, int ratio) {
  const int nq = nr * ratio;
  return (nq >= SUB_TQ ? 1 : SUB_TQ / nq) * nr + 4;
}

// Backward CTAs per key block: the rows of its query block (G * nq) split
// in runs of a multiple of SUB_TQ, at most SUB_MAX_SPLIT, one cluster.
// Mirrored by repro_torch.kernels.h1d_block.sub_bwd_splits.
__host__ __device__ __forceinline__ int sub_bwd_splits(int G, int nq) {
  if (nq < SUB_TQ) return 1;
  int s = 1;
  const int units = G * (nq / SUB_TQ);
  while (2 * s <= SUB_MAX_SPLIT && units % (2 * s) == 0) s *= 2;
  return s;
}

// One item of the score pass: rows (row, row + 1) of the tile against keys
// 4 kg .. 4 kg + 3 of their block; `width` lanes share the row pair.
struct PairItem {
  int row, kg, width;
  bool active;
};

// The tile holds `rows` rows from position p0 of its query block on.  With
// split key groups (nkgh < nkg) the first-half row pairs come first, nkgh
// lanes each, then the others with nkg lanes each.  A tile lies inside one
// half of a block (nq / 2 >= rows, its type then from p0) or starts a
// block and alternates halves of nq / 2 rows (p0 == 0, rows a multiple of
// nq).  Mirrored by repro_torch.kernels.h1d_block.sub_pair_items.
__device__ __forceinline__ int sub_first_pairs(int rows, int p0, int nq) {
  const int hs = nq / 2;
  return hs < rows ? rows / 4 : (p0 < hs ? rows / 2 : 0);
}

__device__ __forceinline__ int sub_pair_total(int rows, int p0, int nq,
                                              int nkg, int nkgh) {
  if (nkgh == nkg) return rows / 2 * nkg;
  const int nf = sub_first_pairs(rows, p0, nq);
  return nf * nkgh + (rows / 2 - nf) * nkg;
}

__device__ __forceinline__ PairItem sub_pair_item(int it, int rows, int p0,
                                                  int nq, int nkg, int nkgh) {
  PairItem x;
  x.width = nkg;
  if (nkgh == nkg) {
    x.kg = it % nkg;
    x.active = it < rows / 2 * nkg;
    x.row = x.active ? 2 * (it / nkg) : 0;
    return x;
  }
  const int hs = nq / 2;
  const int nf = sub_first_pairs(rows, p0, nq);
  const bool first = it < nf * nkgh;
  const int idx = first ? it : it - nf * nkgh;
  x.width = first ? nkgh : nkg;
  const int k = idx / x.width;
  x.kg = idx % x.width;
  x.active = first || k < rows / 2 - nf;
  if (hs < rows) {
    const int per = hs / 2;                 // row pairs per half block
    x.row = (2 * (k / per) + (first ? 0 : 1)) * hs + 2 * (k % per);
  } else {
    x.row = 2 * k;
  }
  if (!x.active) x.row = 0;
  return x;
}

__device__ __forceinline__ float lane4(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

__device__ __forceinline__ const float4& ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][t] = a_r . b_t for R rows of a (stride as) and 4 rows of b
// (stride bs) over n4 columns (a multiple of 4): each one fmaf chain over
// c = 0, 1, ... in order from 0.f -- dot_qk's order.  Columns past d are
// zero in both operands and add exact zeros.
template <int R>
__device__ __forceinline__ void dot_tile(const float* a, int as,
                                         const float* b, int bs, int n4,
                                         float (&acc)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[r][t] = 0.f;
#pragma unroll 4
  for (int c = 0; c < n4; c += 4) {
    float4 x[R], y[4];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = ld4(a + r * as + c);
#pragma unroll
    for (int t = 0; t < 4; ++t) y[t] = ld4(b + t * bs + c);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc[r][t] = fmaf(x[r].x, y[t].x, acc[r][t]);
        acc[r][t] = fmaf(x[r].y, y[t].y, acc[r][t]);
        acc[r][t] = fmaf(x[r].z, y[t].z, acc[r][t]);
        acc[r][t] = fmaf(x[r].w, y[t].w, acc[r][t]);
      }
  }
}

// dot_tile of (a, b) into acc and of (e, f) into acc2 in one loop over
// the same n4 columns: two independent sets of chains, each in dot_qk's
// order.
template <int R>
__device__ __forceinline__ void dot_tile2(const float* a, int as,
                                          const float* b, int bs,
                                          const float* e, int es,
                                          const float* f, int fs, int n4,
                                          float (&acc)[R][4],
                                          float (&acc2)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[r][t] = acc2[r][t] = 0.f;
#pragma unroll 2
  for (int c = 0; c < n4; c += 4) {
    float4 x[R], y[4], x2[R], y2[4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] = ld4(a + r * as + c);
      x2[r] = ld4(e + r * es + c);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      y[t] = ld4(b + t * bs + c);
      y2[t] = ld4(f + t * fs + c);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc[r][t] = fmaf(x[r].x, y[t].x, acc[r][t]);
        acc2[r][t] = fmaf(x2[r].x, y2[t].x, acc2[r][t]);
        acc[r][t] = fmaf(x[r].y, y[t].y, acc[r][t]);
        acc2[r][t] = fmaf(x2[r].y, y2[t].y, acc2[r][t]);
        acc[r][t] = fmaf(x[r].z, y[t].z, acc[r][t]);
        acc2[r][t] = fmaf(x2[r].z, y2[t].z, acc2[r][t]);
        acc[r][t] = fmaf(x[r].w, y[t].w, acc[r][t]);
        acc2[r][t] = fmaf(x2[r].w, y2[t].w, acc2[r][t]);
      }
  }
}

// acc[r][c] = sum_j p[r][j] * x[j][c] for R rows of p (stride ps), 4
// columns of x (stride xs), j < jl (a multiple of 4).
template <int R>
__device__ __forceinline__ void apply_tile(const float* p, int ps,
                                           const float* x, int xs, int jl,
                                           float (&acc)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < jl; j += 4) {
    float4 a[R], v[4];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = ld4(p + r * ps + j);
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = ld4(x + (j + t) * xs);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float at = lane4(a[r], t);
        acc[r][0] = fmaf(at, v[t].x, acc[r][0]);
        acc[r][1] = fmaf(at, v[t].y, acc[r][1]);
        acc[r][2] = fmaf(at, v[t].z, acc[r][2]);
        acc[r][3] = fmaf(at, v[t].w, acc[r][3]);
      }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy nrows rows of n floats into shared rows of stride ss, columns
// [n, round4(n)) zero.  row(r) gives the source row, or nullptr for a row
// to zero-fill without reading.  vec: every source row is 16-byte aligned
// (cp.async, 16 bytes a thread, no register staging); else scalar loads.
// The caller waits with cp_async_wait() and __syncthreads().
template <class Row>
__device__ __forceinline__ void stage_one(float* dst, int ss, int n,
                                          bool vec, int r, int c, Row row) {
  const float* src = row(r);
  float* out = dst + r * ss + c;
  if (src == nullptr) {
    *reinterpret_cast<float4*>(out) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else if (vec) {
    cp_async16(out, src + c);
  } else {
    float4 x;
    x.x = src[c];
    x.y = c + 1 < n ? src[c + 1] : 0.f;
    x.z = c + 2 < n ? src[c + 2] : 0.f;
    x.w = c + 3 < n ? src[c + 3] : 0.f;
    *reinterpret_cast<float4*>(out) = x;
  }
}

template <class Row>
__device__ __forceinline__ void stage_rows(float* dst, int ss, int nrows,
                                           int n, bool vec, Row row) {
  const int n4 = round4(n) / 4;
  if (blockDim.x % n4 == 0) {       // a fixed column per thread
    const int step = blockDim.x / n4, c = threadIdx.x % n4 * 4;
    for (int r = threadIdx.x / n4; r < nrows; r += step)
      stage_one(dst, ss, n, vec, r, c, row);
    return;
  }
  for (int e = threadIdx.x; e < nrows * n4; e += blockDim.x) {
    const int r = e / n4;
    stage_one(dst, ss, n, vec, r, (e - r * n4) * 4, row);
  }
}

// Store 4 columns c .. c+3 (c < n) of a row of n floats.
__device__ __forceinline__ void store4(float* row, int c, int n, bool vec,
                                       const float (&x)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(row + c) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (c + t < n) row[c + t] = x[t];
}

}  // namespace h1d
