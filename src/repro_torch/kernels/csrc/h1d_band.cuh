// Band structure shared by the forward (h1d_block.cu) and backward
// (h1d_block_bwd.cu) kernels of the banded block attention, so the two
// passes cannot drift apart: the mask, the first key of a query row and
// the masking constants.
#pragma once

#include <cuda_runtime.h>

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

// Keys of a query row's band from its first key on: coarse_causal and a
// sub level (which masks as coarse_causal) read the block before the
// row's own, l0_causal that block and its own, a bidirectional mode
// those two and the block after (prev, own, next).
__host__ __device__ __forceinline__ int band_keys(int mode, int nr) {
  return mode == COARSE_CAUSAL ? nr : mode == L0_CAUSAL ? 2 * nr : 3 * nr;
}

// First key of query row i: the first key of the block before the row's
// own (level 0, and a coarse level with coarsened queries); a sub level
// (ratio >= 2) reads coarse block I-1 of its fine query block
// I = i / (nr * ratio), which at ratio 1 is the same rule.
template <bool SUB>
__device__ __forceinline__ int key_start(int i, int nr, int ratio) {
  return SUB ? (i / (nr * ratio) - 1) * nr : (i / nr) * nr - nr;
}

// The score s = q . k, as one fmaf chain in column order.  Both passes
// compute it here, so the backward's recomputed s is bit for bit the
// forward's and the argmax test s == m finds the forward's maximum.
__device__ __forceinline__ float dot_qk(const float* qr, const float* kr,
                                        int d) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc = fmaf(qr[c], kr[c], acc);
  return acc;
}

}  // namespace h1d
