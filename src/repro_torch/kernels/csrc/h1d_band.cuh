// Band structure shared by the forward (h1d_block.cu) and backward
// (h1d_block_bwd.cu) kernels of the banded block attention, so the two
// passes cannot drift apart: the mask (band_admits, the port of
// repro/kernels/h1d_block.py band_mask with the block difference known),
// the masking constants, the score's summation order and the launch
// geometry of every band body.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace h1d {

constexpr float NEG_INF = -3.0e38f;   // h1d_block.NEG_INF
constexpr float MIN_M = -1e30f;       // h1d_block._MIN_M
constexpr unsigned FULL = 0xffffffffu;

enum Mode { L0_BIDIR = 0, L0_CAUSAL = 1, COARSE_BIDIR = 2, COARSE_CAUSAL = 3 };

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
// c = 0, 1, ... in order from 0.f.  Every pass computes a score s = q . k
// in this order (here or in dot_tile2), so the backward's recomputed s is
// bit for bit the forward's and the argmax test s == m finds the
// forward's maximum.  Columns past d are zero in both operands and add
// exact zeros.
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
// the same n4 columns: two independent sets of chains, each in
// dot_tile's order.
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

// acc[r][c] += sum_j p[r][j] * x[j][c] for R rows of p (stride ps), 4
// columns of x (stride xs), j < jl (a multiple of 4).
template <int R>
__device__ __forceinline__ void apply_tile_add(const float* p, int ps,
                                               const float* x, int xs, int jl,
                                               float (&acc)[R][4]) {
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

// acc[r][c] = sum_j p[r][j] * x[j][c], as apply_tile_add from zero.
template <int R>
__device__ __forceinline__ void apply_tile(const float* p, int ps,
                                           const float* x, int xs, int jl,
                                           float (&acc)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  apply_tile_add<R>(p, ps, x, xs, jl, acc);
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Close this thread's group of cp.async copies; wait until at most N of
// its groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// l0_causal, l0_bidir, coarse_bidir
// ---------------------------------------------------------------------------
//
// Query block I reads the key blocks I + off for the band offsets of its
// mode: l0_causal -1, 0; l0_bidir -1, 0, +1; coarse_bidir -1, +1 (its own
// block is masked whole there).  Band b of a row is the key block at
// offset band_off(mode, b).  A key block's info comes from its weights;
// a row is live when a key its mask admits has w > 0, and a dead row is
// never read.  The score pass gives a row pair 2 * nr / 4 lanes in two
// slots (a power of two, whatever the number of bands), each lane one
// group of 4 keys in each band of its slot, and combines the bands in
// registers and over the pair's lanes; groups the mask masks whole for
// both rows are not computed.  Mirrored by repro_torch.kernels.h1d_block
// (band_row_live, band_admits, band_group_range, band_row_range,
// lane_item, band_fwd_tq, band_dkvw_tiles).

constexpr int BAND_THREADS = 128;
constexpr int BAND_TQ = 32;       // query rows a tile, at most
constexpr int BAND_KEYS = 32;     // backward dK/dV/dW: keys a CTA, at most
constexpr int BAND_KV_TQ = 32;    // backward dK/dV/dW: reader rows a chunk
constexpr int BAND_MAX_NR = 64;   // the largest block the bodies take
// Lane slots a row pair of the score pass takes, W = BAND_SLOTS * nr / 4
// lanes: slot sl computes the bands sl, sl + BAND_SLOTS, ...
constexpr int BAND_SLOTS = 2;
constexpr int FILL_CTAS = 264;    // two CTAs for each of the H100's 132 SMs
constexpr size_t SMEM_MAX = 232448;   // a CTA's shared memory on the H100

__host__ __device__ __forceinline__ int band_count(int mode) {
  return mode == L0_BIDIR ? 3 : 2;
}

__host__ __device__ __forceinline__ int band_off(int mode, int b) {
  return mode == COARSE_BIDIR ? 2 * b - 1 : b - 1;
}

// Item `it` of a score pass with W lanes a row pair (W a power of two up
// to 32): its row pair and its lane j (0 .. W-1) among the pair's.  In
// each warp the lanes of a pair differ in lane bit 0 and in the bits above
// the pair's, so the 8 lanes of one phase of a 16-byte shared load hold
// the lanes j, j ^ 1 of four pairs: their key rows, 4 apart at a stride of
// d + 4 floats, fall in different banks (consecutive lanes would put j
// and j ^ 2 in one phase, in the same banks).  The items cover
// lane_groups(npairs, W) warps.
__device__ __forceinline__ void lane_item(int it, int W, int* pair, int* j) {
  if (W == 1) {
    *pair = it;
    *j = 0;
    return;
  }
  const int P = 32 / W, l = it & 31;
  *pair = (it >> 5) * P + ((l >> 1) & (P - 1));
  *j = (l & 1) | ((l >> 1) / P << 1);
}

__device__ __forceinline__ int lane_groups(int npairs, int W) {
  return W == 1 ? (npairs + 31) / 32 : (npairs * W + 31) / 32;
}

// Lane offset of the o-th xor step (o = 1, 2, 4, ... < W) among a pair's
// lanes.
__device__ __forceinline__ int lane_xor(int o, int W) {
  return o == 1 ? 1 : o * (32 / W);
}

// Key blocks of a tile's window (the forward and the dQ pass): the blocks
// its rows lie in, the one before and, in a bidirectional mode, the one
// after.
__host__ __device__ __forceinline__ int band_window_blocks(int mode, int tq,
                                                           int nr) {
  return (tq > nr ? tq / nr : 1) + (mode == L0_CAUSAL ? 1 : 2);
}

// A key block's info: bit 0 a key of its first half (the first nr / 2)
// has w > 0, bit 1 a key of its second half has; bits 8 on: the first key
// with w > 0 (nr if none).  0 stands for a block out of range too.
__device__ __forceinline__ int block_info(const float* wb, int nr) {
  int bits = 0, first = nr;
  for (int j = nr - 1; j >= 0; --j)
    if (wb[j] > 0.f) {
      bits |= j < nr / 2 ? 1 : 2;
      first = j;
    }
  return bits | first << 8;
}

// Whether the row at position p of its block has a key with w > 0 that
// band_mask admits, from the info of the blocks before, at and after its
// own.
template <int MODE>
__device__ __forceinline__ bool band_row_live(int p, int nr, int prev,
                                              int own, int next) {
  if (MODE == L0_CAUSAL) return (prev & 3) || ((own & 3) && (own >> 8) <= p);
  if (MODE == L0_BIDIR) return ((prev | own | next) & 3) != 0;
  return p < nr / 2 ? ((prev & 1) || (next & 3)) : ((prev & 3) || (next & 2));
}

// band_mask for a row at position pq of its block and the key at position
// pk of the block at offset `off` from the row's (both positions in [0,
// nr), the key block in range): the mask with the block difference known.
template <int MODE>
__host__ __device__ __forceinline__ bool band_admits(int off, int pq, int pk,
                                                     int nr) {
  if (MODE == L0_CAUSAL) return off < 0 || pk <= pq;
  if (MODE == COARSE_BIDIR)
    return off < 0 ? !(pq < nr / 2 && pk >= nr / 2)
                   : !(pq >= nr / 2 && pk < nr / 2);
  return true;
}

// Key groups [lo, hi) of band offset `off` that band_mask admits for some
// of the rows at positions p .. p + rows - 1 of one block.
template <int MODE>
__host__ __device__ __forceinline__ void band_group_range(int off, int p,
                                                          int rows, int nr,
                                                          int* lo, int* hi) {
  const int half = nr / 2;
  *lo = 0;
  *hi = key_groups(nr);
  if (MODE == L0_CAUSAL && off == 0 && key_groups(p + rows) < *hi)
    *hi = key_groups(p + rows);
  if (MODE == COARSE_BIDIR && off < 0 && p + rows <= half)
    *hi = key_groups(half);
  if (MODE == COARSE_BIDIR && off > 0 && p >= half) *lo = half / 4;
}

// Positions [lo, hi) of the rows of a reader block that band_mask admits
// for some key of group kg of the key block at offset `off` from theirs.
template <int MODE>
__host__ __device__ __forceinline__ void band_row_range(int off, int kg,
                                                        int nr, int* lo,
                                                        int* hi) {
  const int half = nr / 2;
  *lo = 0;
  *hi = nr;
  if (MODE == L0_CAUSAL && off == 0) *lo = 4 * kg;
  if (MODE == COARSE_BIDIR && off < 0 && 4 * kg >= half) *lo = half;
  if (MODE == COARSE_BIDIR && off > 0 && 4 * kg + 3 < half) *hi = half;
}

// Shared floats of the forward at tq rows a tile.
__host__ __device__ __forceinline__ size_t band_fwd_floats(int mode, int tq,
                                                           int d, int dv,
                                                           int nr) {
  const size_t nwb = band_window_blocks(mode, tq, nr), nkw = nwb * nr + 4;
  const size_t qs = round4(d) + 4;
  const size_t as = band_count(mode) * 4 * key_groups(nr) + 4;
  return tq * qs + nkw * qs + nkw * round4(dv) + tq * as + nkw + nwb + tq;
}

// Shared floats of the dQ pass at tq rows a tile.
__host__ __device__ __forceinline__ size_t band_dq_floats(int mode, int tq,
                                                          int d, int dv,
                                                          int nr) {
  const size_t nwb = band_window_blocks(mode, tq, nr), nkw = nwb * nr + 4;
  const size_t qs = round4(d) + 4, gs = round4(dv) + 4;
  const size_t as = band_count(mode) * 4 * key_groups(nr) + 4;
  const size_t uni = tq * gs > tq * as ? tq * gs : tq * as;
  return tq * qs + tq * gs + uni + nkw * qs + nkw * gs + nkw + 4 * tq + nwb +
         tq;
}

// Shared floats of the dK/dV/dW pass: nkb key blocks, tq reader rows a
// chunk.
__host__ __device__ __forceinline__ size_t band_dkvw_floats(int mode, int nkb,
                                                            int tq, int d,
                                                            int dv, int nr) {
  const size_t nk = (size_t)nkb * 4 * key_groups(nr);
  const size_t d4 = round4(d), dv4 = round4(dv), qs = d4 + 4, gs = dv4 + 4;
  const size_t xs = 2 * band_count(mode) * 4 * key_groups(nr) + 4;
  return nk * (d4 + dv4 + 1) + tq * qs + tq * gs + tq * xs + nkb * nr + tq +
         nkb + tq;
}

// Rows a tile of the forward (backward = false) or the dQ pass: BAND_TQ,
// halved down to 16 while the grid has fewer than FILL_CTAS CTAs or the
// tile's shared memory exceeds SMEM_MAX; 0 when 16 rows do not fit.
__host__ __forceinline__ int band_fwd_tq(int mode, int B, int G, int L,
                                         int d, int dv, int nr,
                                         bool backward) {
  auto bytes = [&](int t) {
    return 4 * (backward ? band_dq_floats(mode, t, d, dv, nr)
                         : band_fwd_floats(mode, t, d, dv, nr));
  };
  int tq = BAND_TQ;
  while (tq > 16 && (bytes(tq) > SMEM_MAX ||
                     (long long)B * G * ((L + tq - 1) / tq) < FILL_CTAS))
    tq /= 2;
  return bytes(tq) <= SMEM_MAX ? tq : 0;
}

// Key blocks a CTA of the dK/dV/dW pass (up to BAND_KEYS keys, halved
// while the grid has fewer than FILL_CTAS CTAs) and reader rows a chunk
// (BAND_KV_TQ, halved while half of them still hold a group's readers or
// the shared memory exceeds SMEM_MAX); *tq = 0 when nothing fits.
__host__ __forceinline__ void band_dkvw_tiles(int mode, int B, int L, int d,
                                              int dv, int nr, int* nkb,
                                              int* tq) {
  const int nb = L / nr;
  int n = BAND_KEYS > nr ? BAND_KEYS / nr : 1;
  while (n > nb) n /= 2;
  while (n > 1 && (long long)B * ((nb + n - 1) / n) < FILL_CTAS) n /= 2;
  const int readers = (n + (mode == L0_CAUSAL ? 1 : 2)) * nr;
  int t = BAND_KV_TQ;
  auto bytes = [&](int kb, int tt) {
    return 4 * band_dkvw_floats(mode, kb, tt, d, dv, nr);
  };
  while (t > 16 && (t / 2 >= readers || bytes(n, t) > SMEM_MAX)) t /= 2;
  while (n > 1 && bytes(n, t) > SMEM_MAX) n /= 2;
  *nkb = n;
  *tq = bytes(n, t) <= SMEM_MAX ? t : 0;
}

// ---------------------------------------------------------------------------
// l0_causal, streamed
// ---------------------------------------------------------------------------
//
// The shapes the staged body above cannot hold (nr past BAND_MAX_NR, or a
// window whose 16-row tile exceeds SMEM_MAX): a tile of STREAM_TQ query
// rows stays in shared memory while its key window, keys (I - 1) * nr ..
// its last row, streams through in tiles of STREAM_TK keys.  Every stream
// body runs STREAM_THREADS threads, one CTA an SM, and takes its tiles in
// stream_slot's order.  Mirrored by repro_torch.kernels.h1d_block
// (stream_max_tiles, stream_fwd_floats, stream_dq_floats,
// stream_dkvw_floats).

constexpr int STREAM_THREADS = 256;
constexpr int STREAM_TQ = 64;      // query rows a tile
constexpr int STREAM_TK = 64;      // forward: keys a streamed tile
constexpr int STREAM_MAX_D = 256;  // d and dv: y stays in registers

// Tile x of a stream grid, longest work first: the grid covers nbg (b, g)
// planes (or b alone) of nb blocks of tpb tiles each.  The heavy blocks
// (every block but one light block) come first, rank 0 of every heavy
// block, then rank 1, ...; the light block's tiles, rank by rank, last.
// *blk is the heavy block's index in [0, nb - 1), or nb - 1 for the light
// block: the caller maps ranks and blocks to its tiles.
__host__ __device__ __forceinline__ void stream_slot(int x, int nbg, int nb,
                                                     int tpb, int* bg,
                                                     int* blk, int* rank) {
  const int heavy = nbg * (nb - 1);
  if (x < tpb * heavy) {
    *rank = x / heavy;
    const int u = x - *rank * heavy;
    *bg = u / (nb - 1);
    *blk = u - *bg * (nb - 1);
  } else {
    x -= tpb * heavy;
    *rank = x / nbg;
    *bg = x - *rank * nbg;
    *blk = nb - 1;
  }
}

// Column units (4 floats) a CTA's y, dq or dk/dv register tiles are laid
// out for: 16, 32 or 64, the least that covers n4 / 4.  A lane holds RY =
// units / 8 rows x 2 units, so 256 lanes (128 a gradient in dK/dV/dW with
// 32 keys) cover 64 rows.
__host__ __device__ __forceinline__ int stream_cols(int n4) {
  return n4 <= 64 ? 16 : n4 <= 128 ? 32 : 64;
}

// Of a streamed kernel's three register-tile layouts (RY or RK = 2, 4, 8),
// the one stream_cols(n4) gives.
template <typename Kernel>
inline Kernel by_stream_cols(int n4, Kernel k2, Kernel k4, Kernel k8) {
  const int u = stream_cols(n4);
  return u == 16 ? k2 : u == 32 ? k4 : k8;
}

// Key tiles a query tile's window spans at most: nr keys of the block
// before, up to nr - 1 of its own block before its first row, its rows.
__host__ __device__ __forceinline__ int stream_max_tiles(int nr) {
  return (2 * nr + STREAM_TQ + STREAM_TK - 1) / STREAM_TK;
}

// Shared floats of the streamed forward: the query tile, one tile of keys,
// one of values and the keys' weights, the tile's a, each row's rescale,
// the list of live key tiles and its length.
__host__ __device__ __forceinline__ size_t stream_fwd_floats(int d, int dv,
                                                             int nr) {
  const size_t qs = round4(d) + 4, vs = round4(dv);
  return STREAM_TQ * qs + STREAM_TK * (qs + vs + 1) +
         STREAM_TQ * (STREAM_TK + 4) + STREAM_TQ + stream_max_tiles(nr) + 1;
}

// The streamed backward (h1d_block_bwd.cu), two passes.  dQ: a tile of
// STREAM_TQ rows keeps q and gy resident while its key window streams
// through once in tiles of STREAM_DQ_TK keys, each row listing up to
// STREAM_TIES keys that tie at its max.  dK/dV/dW: a CTA keeps
// STREAM_KV_TK keys and values resident while their reader rows stream
// through in chunks of STREAM_KV_TR.
constexpr int STREAM_DQ_TK = 32;   // dQ pass: keys a streamed tile
constexpr int STREAM_TIES = 4;     // dQ pass: tied keys a row lists
constexpr int STREAM_KV_TK = 32;   // dK/dV/dW pass: keys a CTA
constexpr int STREAM_KV_TR = 64;   // dK/dV/dW pass: reader rows a chunk

__host__ __device__ __forceinline__ int stream_dq_tiles(int nr) {
  return (2 * nr + STREAM_TQ + STREAM_DQ_TK - 1) / STREAM_DQ_TK;
}

// Shared floats of the dQ pass: q and gy of the tile, one tile of keys,
// values and key weights, this tile's s and ds, each row's m, gdn and gmh,
// its tie count and list, the list of live key tiles and its length.
__host__ __device__ __forceinline__ size_t stream_dq_floats(int d, int dv,
                                                            int nr) {
  const size_t qs = round4(d) + 4, gs = round4(dv) + 4;
  return STREAM_TQ * (qs + gs) + STREAM_DQ_TK * (qs + gs + 1) +
         2 * STREAM_TQ * (STREAM_DQ_TK + 4) + 3 * STREAM_TQ +
         STREAM_TQ * (1 + STREAM_TIES) + stream_dq_tiles(nr) + 1;
}

// Shared floats of the dK/dV/dW pass: the CTA's keys and values, one
// chunk of reader rows (q, gy and the rows' m, gdn, gmn), this chunk's a
// and ds (key-major), the keys' weights.
__host__ __device__ __forceinline__ size_t stream_dkvw_floats(int d, int dv) {
  const size_t qs = round4(d) + 4, gs = round4(dv) + 4;
  return STREAM_KV_TK * (qs + gs) + STREAM_KV_TR * (qs + gs + 3) +
         2 * STREAM_KV_TK * (STREAM_KV_TR + 4) + STREAM_KV_TK;
}

// acc[r][t] = a_r . b_t for R rows of a (stride as) and K rows of b
// (stride bs) over n4 columns: dot_tile's order (one fmaf chain a pair
// over c = 0, 1, ... from 0.f) on an R x K outer-product tile.
template <int R, int K>
__device__ __forceinline__ void dot_tile_rk(const float* a, int as,
                                            const float* b, int bs, int n4,
                                            float (&acc)[R][K]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < K; ++t) acc[r][t] = 0.f;
#pragma unroll 4
  for (int c = 0; c < n4; c += 4) {
    float4 x[R], y[K];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = ld4(a + r * as + c);
#pragma unroll
    for (int t = 0; t < K; ++t) y[t] = ld4(b + t * bs + c);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < K; ++t) {
        acc[r][t] = fmaf(x[r].x, y[t].x, acc[r][t]);
        acc[r][t] = fmaf(x[r].y, y[t].y, acc[r][t]);
        acc[r][t] = fmaf(x[r].z, y[t].z, acc[r][t]);
        acc[r][t] = fmaf(x[r].w, y[t].w, acc[r][t]);
      }
  }
}

// part[r][0..3] and part[r][4..7] = sum_j p[r][j] * x[j][u0 .. u0+3] and
// x[j][u1 .. u1+3] for R rows of p (stride ps) and j < jl (a multiple of
// 4): one fmaf chain a term from 0.f, over j in order.
template <int R>
__device__ __forceinline__ void apply_tile8(const float* p, int ps,
                                            const float* x, int xs, int u0,
                                            int u1, int jl,
                                            float (&part)[R][8]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) part[r][c] = 0.f;
#pragma unroll 2
  for (int j = 0; j < jl; j += 4) {
    float4 v[4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[t][0] = ld4(x + (j + t) * xs + u0);
      v[t][1] = ld4(x + (j + t) * xs + u1);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = ld4(p + r * ps + j);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float at = lane4(a, t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          part[r][4 * h + 0] = fmaf(at, v[t][h].x, part[r][4 * h + 0]);
          part[r][4 * h + 1] = fmaf(at, v[t][h].y, part[r][4 * h + 1]);
          part[r][4 * h + 2] = fmaf(at, v[t][h].z, part[r][4 * h + 2]);
          part[r][4 * h + 3] = fmaf(at, v[t][h].w, part[r][4 * h + 3]);
        }
      }
    }
  }
}

// A lane's register tile of a 64-row x (units x 4)-column product (y, dq;
// dk or dv over 32 keys with half the lanes): rows row0 + G * rr (rr <
// RY, G = 64 / RY row groups) and the units u0 and u0 + units / 2.  Lanes
// 8 apart in a warp take the next row group, neighbouring lanes the next
// unit, so the 8 lanes of a phase read 128 contiguous bytes of x and the
// rows of p they read lie in distinct banks.
struct LaneTile {
  int row0, rstep, u0, u1;
};

__device__ __forceinline__ LaneTile lane_tile(int lane_id, int units,
                                              int rows) {
  const int npb = units / 16;                 // 8-unit blocks of a half
  const int w = lane_id >> 5, l = lane_id & 31;
  const int wr = w / npb, wp = w - wr * npb;
  LaneTile t;
  t.rstep = rows / (units / 8);               // row groups
  t.row0 = wr * 4 + (l >> 3);
  t.u0 = wp * 8 + (l & 7);
  t.u1 = t.u0 + units / 2;
  return t;
}

}  // namespace h1d
