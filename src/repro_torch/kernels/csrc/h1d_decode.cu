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
// o = (a @ v) / max(a . w, 1e-9).  One body computes it for all four
// attends, attend_staged_kernel<ADDR, VW, E> (#5 ADDR_DENSE, #7
// ADDR_PAGED, #11 ADDR_LOCAL, #8 ADDR_QPAGED): each live band's block is
// one contiguous run of rows (#5: the block the TPU kernel's index maps name
// from t alone, clamped into the level, of the row's own slab, whose
// Lmax >> l rows a level the caller passes; #7, #8: page bidx[r, band] of
// the pool; #11: block bidx[r, band] of the row's slab in one shard's
// level array, whose row count per level the caller passes: a sharded
// level holds (Lmax >> l) / d rows, a replicated one Lmax >> l), staged
// in shared memory by bulk copies before any compute.  #11 also masks
// each band by its ownership bit owned[r, band] and writes the
// unnormalised partial num = a @ v, den = a . w and m = max(rowmax,
// -1e30) for the cross-shard merge; t stays global, so every mask
// compares global positions.  #8's int8 bands stage their int8 rows with
// the block's run of per-row scales in the slot an f32 block takes, and
// are dequantized on the read from shared memory (float(q) * scale,
// rounded, then the fmaf, as the plain version orders it); fp32 levels of
// a mixed pool take the f32 path in the same launch and never read their
// scales.
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
// The int8 variant (#10) dequantizes the pair, puts in the new row, and
// requantizes both rows with fresh absmax per-row scales (the rounding of
// core/quantization.py: scale = max(amax, 1e-12) * float32(1/127), q =
// clamp(rint(x / scale), -127, 127), IEEE division, round half to even);
// its carry is the f32 pair before quantization.  Every product and sum
// of the update path is an explicitly rounded intrinsic, so no FMA
// contraction can leave the plain version's bits.
//
// Cache element.  Every body also takes bf16 levels (the reference keeps
// its decode caches in the model's dtype; #10 beside its int8 ones): the
// staged attend, attend_staged_kernel<ADDR, VW, E>, copies a bf16 block
// as it is into the slot an f32 block takes and widens each value on the
// read (exact), so its arithmetic is the f32 one; update_chain_kernel<
// ADDR, E> and update_cache_quant_kernel (its `half` argument) read each
// stored row widened, run the carry chain unrounded in f32 and round each
// stored row (and #12's carry) to nearest even, as the reference's Pallas
// updates do (_update_kernel, _update_paged_quant_kernel: pk.astype(dtype)
// on the store, the f32 pair carried).  q, k_new and v_new arrive f32
// (the wrappers widen bf16 operands, exactly) and the attends write f32.
//
// Page tables: inactive engine rows all point their update rows at the
// TRASH page, so several CTAs may write the same TRASH rows; the TPU ran
// them one after another, here they race.  Outputs do not depend on it:
// every band that reads TRASH is masked (weight 0, exp(NEG_INF - m) = 0)
// and the racing writes are whole finite values (#9 and #10 read every
// level's TRASH pair before their first store, so which garbage lands
// there depends on the order the CTAs run in).  Every other write
// target is private to one cache row (the engine copies shared pages on
// write and allocates fresh ones before the tick).
//
// What bounds them on the H100: neither bytes nor FLOPs.  At 64 rows and
// Lmax 2048, attend reads at most (M+1)*nr key and value rows per row, ~4
// MB in all (int8: a quarter), and update touches ~2*nlev rows per row,
// well under 1 MB: a few microseconds of memory traffic, so each launch
// is bound by its launch latency and the chain of dependent steps inside
// one CTA.
// The staged attend body cuts that chain to three memory round trips
// (the first parameter read, t and bidx, one bulk copy; #5 reads no
// bidx, its blocks follow from t) and a few shared-memory steps: warp 0
// reads t, bidx and owned, keeps of each band only the prefix of rows its
// mask lets through (band 0 the rows up to t, a coarse band in its first
// quadrant the first half, nothing of a band masked whole or not owned;
// #5's two level-0 bands name one block while t < nr, and band 1 is then
// masked whole, so nothing is staged twice) and, with everything
// resident, issues every live band's key copy, then its value copy
// (cp.async.bulk onto one mbarrier per slot, an int8 block's rows and
// scales as two copies on one arrival; where a block is not 16-byte
// aligned, 4-byte cp.async of f32 rows or plain loads of int8 ones), so
// the values arrive while the keys are scored.  One warp per
// band (or chunk of rows): scores with a few lanes per key and float4
// loads, the vector order rotated per key so that the keys of a quarter
// warp hit distinct banks, each key vector reused across up to 4 query
// groups, a running max per warp; one block-wide max; then a @ v with
// lane j computing the weight of key j (and a . w) once and handing it
// to the warp's lane groups by shuffle, each group adding every P-th key
// over its column vectors, the groups summed by xor-shuffles; the warps'
// partials and denominators are added in warp order (no atomics: two
// calls give the same bits).  Where all live bands do not fit in shared
// memory, chunks of rows stream through a ring of stages, keys first
// (all scores, so the single max stays exact), then values (attend_plan,
// mirrored by the wrappers' plan_attend_stages).
// The update kernels give each thread one column (f32) or one warp a
// chain (int8), and are bound by the same latency: every level's pair
// sits where t (and utab[r]) alone say, and within one call no two
// levels share storage, so reading every pair before the first store
// changes no bit.  The three f32 updates, #6, #12 and #9, run
// update_chain_kernel<ADDR, E> (ADDR_DENSE, ADDR_LOCAL, ADDR_PAGED): t (and
// owned, or the row's page table utab[r, :]) read, both rows of every
// level's pair put in flight at once (cp.async into shared memory), then
// the carry chain and its stores: two memory round trips before the
// chain, where a walk of the levels costs one a level.  #10
// (update_cache_quant_kernel) puts every level's pair (and
// scales) in flight at once into shared memory, and then runs the chain
// with no memory round trip between levels: one warp per chain (k or v;
// the two never meet), C columns a lane; the carry chain itself is a
// select and an add a level, and what hangs off it -- each row's absmax
// over the warp (exact and order-free), the IEEE divisions and the
// stores -- runs after it: one lane a level for the maxima, four warps a
// chain for the requantize, so no level waits on another's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "launch_info.cuh"

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
// addressors: a paged pool of f32 levels (#7, #9), one shard's slab (#11,
// #12), a paged pool whose levels may be int8 (#8), dense slabs (#5, #6)
constexpr int ADDR_PAGED = 1, ADDR_LOCAL = 2, ADDR_QPAGED = 3, ADDR_DENSE = 4;

struct Levels {            // every level l = 0..nlev-1, level 0 = fine
  const void* k[MAXLEV];
  const void* v[MAXLEV];
  const float* ksc[MAXLEV];   // per-row scales of int8 levels
  const float* vsc[MAXLEV];
  int rows[MAXLEV];           // LOCAL, DENSE: rows of level l in a slab
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

// Block of `band` that a dense slab of nbl blocks a level holds for a row
// at position t, from b0 = t / nr (#5): the TPU kernel's index maps,
// clamped into the level, with t / (nr << l) = b0 >> l (band 0 at t =
// Lmax reads the last block, of which band_rows counts one row, as the
// plain version does).
__device__ __forceinline__ int dense_block(int band, int b0, int nbl) {
  if (band == 0) return min(b0, nbl - 1);
  if (band == 1) return max(b0 - 1, 0);
  return min(max((b0 >> (band - 1)) - 1, 0), nbl - 1);
}

// Rows of `band` that count for a row at position t: a prefix of the
// band's nr rows (band 0: those up to t; band 1: all once t passes the
// first block; a coarse band: none before I_l = 1, then the first half
// while t is in the first half of its span, else all).
__host__ __device__ __forceinline__ int band_rows(int band, int t, int nr) {
  if (band == 0) return t % nr + 1;
  if (band == 1) return t / nr >= 1 ? nr : 0;
  const int span = nr << (band - 1);
  if (t / span < 1) return 0;
  return (t % span) < span / 2 ? nr / 2 : nr;
}

// First row of the sibling pair of level l that holds ancestor t >> l in
// row r's slab, an (R, Lmax >> l, W) array: pair min(t >> (l + 1),
// Ll / 2 - 1), floored at 0 (a shift by 32 is 0 here, not undefined).
template <typename E>
__device__ __forceinline__ E* dense_pair(const MutLevels& lv, bool is_k, int l,
                                        int r, int t, int Lmax, int W) {
  const int Ll = Lmax >> l;
  const int pair = max(min(l < 31 ? t >> (l + 1) : 0, Ll / 2 - 1), 0);
  return static_cast<E*>(is_k ? lv.k[l] : lv.v[l]) +
         ((size_t)r * Ll + 2 * (size_t)pair) * W;
}

// ---------------------------------------------------------------------------
// staged attend (#5, #7, #8, #11)
// ---------------------------------------------------------------------------

constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use (H100)
constexpr int WARPS = THREADS / 32;
static_assert(MAXLEV + 1 <= 64, "the set-up reads two bands a lane");

// Shared memory of one CTA of attend_staged_kernel, in bytes from the
// start: `stages` mbarriers; a ring of `stages` slots of `cr` rows x
// max(D, Dv) floats; the scaled query (Gq x D, Gq = G rounded up to the
// 4 groups a key vector serves, zeros past G); scores (G x K); each
// warp's output partial (WARPS x G x Dv); each group's running max per
// warp and each warp's partial denominator (2 x WARPS x G); the
// live-band table.  The partials and the maxima start 16-byte aligned.
// K = (nlev + 1) * nr.  vw: 4 where D and Dv are multiples of 4 (float4
// loads, or 4 int8 values), else 1; team: lanes that score one key;
// vlanes: lanes that share one key in a @ v (a power of two >= Dv / vw,
// at most 32).  A slot of an int8 band holds the block's per-row scales
// (cr floats) and, `qoff` floats in, its int8 rows; the slot is never
// smaller than an f32 block's, so the plan keeps the f32 plan's shape.
struct AttendPlan {
  int stages, cr, slot, quantum, resident, vw, team, vlanes, qoff;
  int off_ring, off_q, off_s, off_red, off_gs, off_tab, smem;
};

__host__ __device__ __forceinline__ int ceil_to(int n, int m) {
  return (n + m - 1) / m * m;
}

// Rows of width W int8 values whose bytes are a multiple of 16.
__host__ __device__ __forceinline__ int rows16(int W) {
  int q = 1;
  while ((q * W) % 16) q *= 2;
  return q;
}

inline AttendPlan attend_layout(int G, int D, int Dv, int nr, int nlev,
                                int stages, int cr, int quantum, bool quant) {
  AttendPlan p{};
  const int nb = nlev + 1, K = nb * nr;
  p.stages = stages;
  p.cr = cr;
  p.quantum = quantum;
  p.resident = stages == 2 * nb && cr == nr;
  p.vw = D % 4 == 0 && Dv % 4 == 0 ? 4 : 1;
  p.slot = ceil_to(cr * max(D, Dv), 4);
  if (quant) {
    p.qoff = ceil_to(cr, 4);
    p.slot = max(p.slot, p.qoff + ceil_to((cr * max(D, Dv) + 3) / 4, 4));
  }
  const int nc = D / p.vw;     // key vectors; a lane scores >= 4 of them
  p.team = 1;
  while (p.team < 8 && nc % (2 * p.team) == 0 && nc / (2 * p.team) >= 4)
    p.team *= 2;
  p.vlanes = 1;
  while (p.vlanes < Dv / p.vw && p.vlanes < 32) p.vlanes *= 2;
  long off = ceil_to(stages * 8, 16);
  p.off_ring = (int)off;
  off += 4L * stages * p.slot;
  p.off_q = (int)off;
  off += 4L * (G == 1 ? 1 : ceil_to(G, 4)) * D;
  p.off_s = (int)off;
  off += 4L * G * K;
  off = ceil_to((int)off, 16);
  p.off_red = (int)off;
  off += 4L * WARPS * G * Dv;
  off = ceil_to((int)off, 16);
  p.off_gs = (int)off;
  off += 4L * 2 * WARPS * G;
  p.off_tab = (int)off;
  off += 4L * (6 * (nb + 1) + 3);
  p.smem = off > SMEM_LIMIT ? SMEM_LIMIT + 1 : (int)off;
  return p;
}

// The launch plan: every live band's keys and values resident at once
// (2 (nlev + 1) slots of nr rows) where that fits; else a ring of as many
// stages as fit, its chunks halved from nr rows while fewer than 2 fit
// (never below `quantum` rows, the granule that keeps every bulk copy a
// multiple of 16 bytes: 4 rows when D or Dv is not a multiple of 4; with
// bf16 levels (`half`) the rows whose 2D- and 2Dv-byte rows are
// multiples of 16; with int8 levels (`quant`) the rows whose 4-byte
// scales and D- and Dv-byte rows are all multiples of 16, 4 or more,
// which covers bf16 and f32 rows too; 1 where nr is not a multiple, and
// then no bulk copies).  A bf16 block takes the slot an f32 block takes,
// so the plan's shape is the f32 plan's.  stages = 0: not even one chunk
// fits.  chunk_rows (the policy's choice, kernels/tuning.py; 0 for the
// rule above): rows a chunk, nr halved j >= 0 times to a multiple of the
// quantum; every band resident where cr = nr and that fits, else a ring of
// as many stages of cr rows as fit (stages = 0 where none does, or cr is
// not such a chunk).
inline AttendPlan attend_plan(int G, int D, int Dv, int nr, int nlev,
                              bool quant, bool half, int chunk_rows = 0) {
  const int nb = nlev + 1;
  int quantum = (D % 4 == 0 && Dv % 4 == 0) || nr % 4 ? 1 : 4;
  if (half) {                      // bf16 rows: 2-byte values
    quantum = max(rows16(2 * D), rows16(2 * Dv));
    if (nr % quantum) quantum = 1;
  }
  if (quant) {
    quantum = max(4, max(rows16(D), rows16(Dv)));
    if (nr % quantum) quantum = 1;
  }
  AttendPlan p = attend_layout(G, D, Dv, nr, nlev, 2 * nb, nr, quantum,
                               quant);
  if (chunk_rows != 0) {
    const int cr = chunk_rows;
    bool chunk = false;
    for (int c = nr; c >= 1 && c % quantum == 0; c /= 2) {
      chunk = chunk || c == cr;
      if (c % 2) break;
    }
    if (!chunk) {
      p.stages = 0;
      return p;
    }
    if (cr == nr && p.smem <= SMEM_LIMIT) return p;
    const int most = 2 * nb * ((nr + cr - 1) / cr);
    const AttendPlan none =
        attend_layout(G, D, Dv, nr, nlev, 0, cr, quantum, quant);
    const int per = 4 * none.slot + 8;
    const int fit = none.smem > SMEM_LIMIT ? 0 : (SMEM_LIMIT - none.smem) / per;
    int S = fit < most ? fit : most;
    while (S > 0 && attend_layout(G, D, Dv, nr, nlev, S, cr, quantum,
                                  quant).smem > SMEM_LIMIT)
      --S;
    p = attend_layout(G, D, Dv, nr, nlev, S, cr, quantum, quant);
    p.resident = 0;
    return p;
  }
  if (p.smem <= SMEM_LIMIT) return p;
  for (int cr = nr;; cr /= 2) {
    const int most = 2 * nb * ((nr + cr - 1) / cr);
    const AttendPlan none =
        attend_layout(G, D, Dv, nr, nlev, 0, cr, quantum, quant);
    const int per = 4 * none.slot + 8;
    const int fit = none.smem > SMEM_LIMIT ? 0 : (SMEM_LIMIT - none.smem) / per;
    int S = fit < most ? fit : most;
    while (S > 0 && attend_layout(G, D, Dv, nr, nlev, S, cr, quantum,
                                  quant).smem > SMEM_LIMIT)
      --S;
    p = attend_layout(G, D, Dv, nr, nlev, S, cr, quantum, quant);
    p.resident = 0;
    if (S >= 2 || cr % 2 || (cr / 2) % quantum) return p;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// This thread's arrival on `bar`, announcing `bytes` of bulk copies
// that complete on it.
__device__ __forceinline__ void bulk_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) that completes its bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One bulk copy that completes on `bar`, after announcing its bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  bulk_expect(bar, bytes);
  bulk_load(dst, src, bytes, bar);
}

// An int8 block of `rows` rows of width W, row `row` on, into a slot: its
// scales at the slot's start, its rows `qoff` floats in; one arrival
// announces both copies.
__device__ __forceinline__ void bulk_copy8(float* slot, const void* data,
                                           const float* sc, size_t row,
                                           int rows, int W, int qoff,
                                           uint64_t* bar) {
  bulk_expect(bar, rows * (W + 4));
  bulk_load(slot, sc + row, rows * 4, bar);
  bulk_load(slot + qoff, static_cast<const int8_t*>(data) + row * W,
            rows * W, bar);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// This thread's arrival on `bar` (its earlier shared-memory stores
// released to the threads that wait on it).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// This thread's arrival on `bar` once its earlier cp.async are done.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

template <int N>
using Groups = std::integral_constant<int, N>;

static_assert(THREADS / 32 == 8, "group_max reads 8 warp maxima");

// The single max of one group from its 8 warp maxima (16-byte aligned),
// floored at MIN_M.
__device__ __forceinline__ float group_max(const float* wm) {
  const float4 a = *reinterpret_cast<const float4*>(wm);
  const float4 b = *reinterpret_cast<const float4*>(wm + 4);
  return fmaxf(fmaxf(fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)),
                     fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w))), MIN_M);
}

// VW floats from p (16-byte aligned where VW = 4).
template <int VW>
struct Vec {
  float x[VW];
  __device__ __forceinline__ static Vec load(const float* p) {
    Vec v;
    if constexpr (VW == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      v.x[0] = f.x; v.x[1] = f.y; v.x[2] = f.z; v.x[3] = f.w;
    } else {
      v.x[0] = *p;
    }
    return v;
  }
  // VW int8 values from p (4-byte aligned where VW = 4), each dequantized
  // as the plain version does: float(q) * scale, rounded.  float(q) comes
  // exactly from a byte permute that puts q + 128 into the mantissa of
  // 2^23, less 2^23 + 128 (full-rate integer and add instructions where a
  // conversion instruction runs at a quarter of their rate)
  __device__ __forceinline__ static Vec load8(const int8_t* p, float sc) {
    Vec v;
    if constexpr (VW == 4) {
      const unsigned w = *reinterpret_cast<const unsigned*>(p) ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v.x[e] = __fmul_rn(
            __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | e)),
                      8388736.f), sc);
    } else {
      v.x[0] = __fmul_rn((float)*p, sc);
    }
    return v;
  }
  // VW bf16 values from p (8-byte aligned where VW = 4), each widened
  // exactly (a bf16 is the high half of the f32 it widens to: the shifts
  // and masks are __bfloat162float)
  __device__ __forceinline__ static Vec loadh(const __nv_bfloat16* p) {
    Vec v;
    if constexpr (VW == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      v.x[0] = __uint_as_float(w.x << 16);
      v.x[1] = __uint_as_float(w.x & 0xffff0000u);
      v.x[2] = __uint_as_float(w.y << 16);
      v.x[3] = __uint_as_float(w.y & 0xffff0000u);
    } else {
      v.x[0] = __bfloat162float(*p);
    }
    return v;
  }
  // VW values from element i of a staged slot that holds E rows
  template <typename E>
  __device__ __forceinline__ static Vec row(const float* slot, size_t i) {
    if constexpr (std::is_same<E, float>::value)
      return load(slot + i);
    else
      return loadh(reinterpret_cast<const __nv_bfloat16*>(slot) + i);
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (VW == 4)
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    else
      *p = x[0];
  }
};

// out: normalised (R, G, Dv); LOCAL: the partial num there, den and m
// (R, G) in den_out / m_out.  DENSE reads neither bidx nor owned (null):
// band b's block follows from t (dense_block).  bulk: every block
// 16-byte aligned (the launcher checks the level and scale pointers and
// the plan's quantum).
// VW = the plan's vw.  QPAGED: level l holds int8 rows where bit l of
// lv.qmask is set (whole bands, so every branch on it is warp-uniform).
// E: the element of the levels that are not int8 (float, or
// __nv_bfloat16 staged as it is, in the first half of an f32 slot, and
// widened on the read).  The parameters the first warp reads come first,
// the level pointers last (other constant-cache lines).
template <int ADDR, int VW, typename E>
__global__ void __launch_bounds__(THREADS, 1)
attend_staged_kernel(const int* __restrict__ tpos,
                     const int* __restrict__ bidx,
                     const int* __restrict__ owned,
                     const float* __restrict__ q, float* __restrict__ out,
                     float* __restrict__ den_out, float* __restrict__ m_out,
                     int G, int D, int Dv, int nr, int nlev, float scale,
                     int bulk, AttendPlan p, Levels lv) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + p.off_ring);
  float* q_s = reinterpret_cast<float*>(smem + p.off_q);
  float* s_s = reinterpret_cast<float*>(smem + p.off_s);
  float* red = reinterpret_cast<float*>(smem + p.off_red);   // (WARPS, G, Dv)
  float* wmax = reinterpret_cast<float*>(smem + p.off_gs);   // (G, WARPS)
  float* dpart = wmax + WARPS * G;                             // (WARPS, G)
  int* tab = reinterpret_cast<int*>(smem + p.off_tab);
  const int nb = nlev + 1, K = nb * nr, NB = nb + 1;
  // per live band i: band, first row of its block in the level array,
  // first key, staged rows, rows that count, first chunk; then the
  // live-band, key and chunk counts
  int* tb_band = tab;
  int* tb_row = tab + NB;
  int* tb_kst = tab + 2 * NB;
  int* tb_cnt = tab + 3 * NB;
  int* tb_tru = tab + 4 * NB;
  int* tb_ch0 = tab + 5 * NB;
  int* tb_n = tab + 6 * NB;
  const int r = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int S = p.stages, cr = p.cr, Gq = G == 1 ? 1 : ceil_to(G, 4);
  constexpr int ES = sizeof(E);
  auto is8 = [&](int l) {
    return ADDR == ADDR_QPAGED && ((lv.qmask >> l) & 1u);
  };

  // resident: the keys of band b (key chunk c, the c-th live band
  // tb_band[c]) in slot b, its values in slot nb + b, each slot used
  // once; else item i (key chunk i < nch, value chunk i - nch) in slot
  // i % S, used for the (i / S)-th time.  ib: the item's live band.
  auto slot_of = [&](int item, int nch, int ib) {
    return p.resident ? (item < nch ? 0 : nb) + tb_band[ib] : item % S;
  };
  auto parity_of = [&](int item) { return p.resident ? 0 : (item / S) & 1; };
  auto issue = [&](int i, int nl, int nch) {
    const bool isv = i >= nch;
    const int c = isv ? i - nch : i;
    int ib = 0;
    while (ib + 1 < nl && tb_ch0[ib + 1] <= c) ++ib;
    const int part = c - tb_ch0[ib];
    const int rows = min(cr, tb_cnt[ib] - part * cr);
    const int l = band_level(tb_band[ib]);
    const int width = isv ? Dv : D;
    const size_t row = (size_t)tb_row[ib] + (size_t)part * cr;
    const int s = slot_of(i, nch, ib);
    float* dst = ring + (size_t)s * p.slot;
    if (is8(l)) {
      const void* data = isv ? lv.v[l] : lv.k[l];
      const float* sc = isv ? lv.vsc[l] : lv.ksc[l];
      if (bulk) {
        bulk_copy8(dst, data, sc, row, rows, width, p.qoff, bar + s);
      } else {                     // plain loads: rows of any width
        const int8_t* src = static_cast<const int8_t*>(data) + row * width;
        int8_t* d8 = reinterpret_cast<int8_t*>(dst + p.qoff);
        for (int e = tid; e < rows * width; e += THREADS) d8[e] = src[e];
        for (int e = tid; e < rows; e += THREADS) dst[e] = sc[row + e];
        mbar_arrive(bar + s);
      }
      return;
    }
    const E* src = static_cast<const E*>(isv ? lv.v[l] : lv.k[l]) +
                   row * width;
    if (bulk) {
      bulk_copy(dst, src, rows * width * ES, bar + s);
    } else if constexpr (ES == 4) {
      for (int e = tid; e < rows * width; e += THREADS)
        cp_async4(dst + e, src + e);
      cp_async_arrive(bar + s);
    } else {                       // bf16 rows of any width: plain loads
      E* dh = reinterpret_cast<E*>(dst);
      for (int e = tid; e < rows * width; e += THREADS) dh[e] = src[e];
      mbar_arrive(bar + s);
    }
  };
  // bulk: warp 0's lanes issue one item each; else every thread copies
  auto fill = [&](int i0, int i1, int nl, int nch) {
    if (bulk) {
      if (warp == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (int i = i0 + lane; i < i1; i += 32) issue(i, nl, nch);
      }
    } else {
      for (int i = i0; i < i1; ++i) issue(i, nl, nch);
    }
  };

  // the live bands, their staged rows and chunks; resident and bulk:
  // each live band's lane issues its key copy as soon as it knows its
  // rows, and its value copy after the table.  Every load of t, bidx,
  // owned and the level pointers (nb <= 33: two bands a lane) is issued
  // before the barrier set-up, whose asm the compiler does not move loads
  // across; DENSE's blocks are arithmetic on t after it.
  if (warp == 0) {
    const int t = tpos[r];
    int blk2[2] = {0, 0}, own2[2] = {1, 1}, lev2[2];
    const E* kl2[2];
    const E* vl2[2];
    const float* ks2[2] = {nullptr, nullptr};
    const float* vs2[2] = {nullptr, nullptr};
    int rows2[2], nbl2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = h * 32 + lane, l = band_level(min(b, nb - 1));
      if (b < nb) {
        if (ADDR != ADDR_DENSE) blk2[h] = bidx[(size_t)r * nb + b];
        if (ADDR == ADDR_LOCAL) own2[h] = owned[(size_t)r * nb + b];
      }
      lev2[h] = l;
      kl2[h] = static_cast<const E*>(lv.k[l]);
      vl2[h] = static_cast<const E*>(lv.v[l]);
      if (ADDR == ADDR_QPAGED) {
        ks2[h] = lv.ksc[l];
        vs2[h] = lv.vsc[l];
      }
      rows2[h] = ADDR == ADDR_LOCAL || ADDR == ADDR_DENSE ? lv.rows[l] : 0;
      nbl2[h] = ADDR == ADDR_DENSE ? rows2[h] / nr : 0;
    }
    for (int s = lane; s < S; s += 32) mbar_init(bar + s, bulk ? 1 : THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    __syncwarp();
    int nk = 0, nc = 0, nl = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int h = b0 / 32, b = b0 + lane;
      const int blk = ADDR == ADDR_DENSE
                          ? dense_block(min(b, nb - 1), t / nr, nbl2[h])
                          : blk2[h];
      const E* kl = kl2[h];
      const E* vl = vl2[h];
      int tru = 0;
      if (b < nb) {
        tru = band_rows(b, t, nr);
        if (own2[h] <= 0) tru = 0;
      }
      const int cnt = tru ? min(nr, ceil_to(tru, p.quantum)) : 0;
      const int row = r * rows2[h] + blk * nr;
      const bool early = bulk && p.resident && tru > 0;
      const bool q8 = is8(lev2[h]);
      if (early && q8)
        bulk_copy8(ring + (size_t)b * p.slot, kl, ks2[h], row, cnt, D,
                   p.qoff, bar + b);
      else if (early)                   // keys first: the scores wait on them
        bulk_copy(ring + (size_t)b * p.slot, kl + (size_t)row * D,
                  cnt * D * ES, bar + b);
      const int nchk = (cnt + cr - 1) / cr;
      int kc = cnt, cc = nchk;                  // inclusive scans
      for (int off = 1; off < 32; off <<= 1) {
        const int a = __shfl_up_sync(FULL, kc, off);
        const int c = __shfl_up_sync(FULL, cc, off);
        if (lane >= off) {
          kc += a;
          cc += c;
        }
      }
      const unsigned live = __ballot_sync(FULL, tru > 0);
      if (tru > 0) {
        const int i = nl + __popc(live & ((1u << lane) - 1));
        tb_band[i] = b;
        tb_row[i] = row;
        tb_kst[i] = nk + kc - cnt;
        tb_cnt[i] = cnt;
        tb_tru[i] = tru;
        tb_ch0[i] = nc + cc - nchk;
      }
      if (early && q8)
        bulk_copy8(ring + (size_t)(nb + b) * p.slot, vl, vs2[h], row, cnt, Dv,
                   p.qoff, bar + nb + b);
      else if (early)
        bulk_copy(ring + (size_t)(nb + b) * p.slot, vl + (size_t)row * Dv,
                  cnt * Dv * ES, bar + nb + b);
      nk += __shfl_sync(FULL, kc, 31);
      nc += __shfl_sync(FULL, cc, 31);
      nl += __popc(live);
    }
    if (lane == 0) {
      tb_kst[nl] = nk;
      tb_ch0[nl] = nc;
      tb_n[0] = nl;
      tb_n[1] = nk;
      tb_n[2] = nc;
    }
    __syncwarp();
    if (bulk && !p.resident)
      for (int i = lane; i < min(S, 2 * nc); i += 32) issue(i, nl, nc);
  } else {
    for (int e = tid - 32; e < Gq * D; e += THREADS - 32) {
      const int g = e / D;
      q_s[e] = g < G ? q[(size_t)r * G * D + e] * scale : 0.f;
    }
    for (int e = tid - 32; e < WARPS * G * Dv; e += THREADS - 32) red[e] = 0.f;
    for (int e = tid - 32; e < 2 * WARPS * G; e += THREADS - 32)
      wmax[e] = e < WARPS * G ? NEG_INF : 0.f;
  }
  __syncthreads();
  // setup done

  const int nl = tb_n[0], nch = tb_n[2], nitems = 2 * nch;
  int issued = p.resident ? nitems : min(S, nitems);
  if (!bulk) fill(0, issued, nl, nch);
  // after a batch that ends at item `end`, the next S items may be issued
  auto refill = [&](int end) {
    const int want = min(end + S, nitems);
    if (want <= issued) return;
    __syncthreads();
    fill(issued, want, nl, nch);
    issued = want;
  };
  // chunk c: its band ib (the c-th live band in the resident plan, else
  // scanned for), first row in the band, rows staged, rows that count,
  // first key
  struct Chunk { int ib, j0, n, tru, k0; };
  auto chunk = [&](int c) {
    int ib = p.resident ? c : 0;
    while (ib + 1 < nl && tb_ch0[ib + 1] <= c) ++ib;
    Chunk ch;
    ch.ib = ib;
    ch.j0 = (c - tb_ch0[ib]) * cr;
    ch.n = min(cr, tb_cnt[ib] - ch.j0);
    ch.tru = tb_tru[ib] - ch.j0;
    ch.k0 = tb_kst[ib] + ch.j0;
    return ch;
  };
  const int batch = p.resident ? nch : S;

  // scores: one warp per key chunk; `team` lanes per key, each over the
  // key's vectors lt, lt + team, ... in an order rotated by the key, so
  // that the keys of a quarter warp read distinct banks; an int8 chunk's
  // keys dequantized on the read
  const int T = p.team, KP = 32 / T, lt = lane % T, kq = lane / T;
  const int ncv = D / VW, ncl = ncv / T;
  auto score = [&](auto groups, int c0, int c1) {
    constexpr int GC = decltype(groups)::value;
    for (int c = c0 + warp; c < c1; c += WARPS) {
      const Chunk ch = chunk(c);
      const int s = slot_of(c, nch, ch.ib);
      mbar_wait(bar + s, parity_of(c));
      const float* kb = ring + (size_t)s * p.slot;
      const bool q8 = is8(band_level(tb_band[ch.ib]));
      const int8_t* kb8 = reinterpret_cast<const int8_t*>(kb + p.qoff);
      float mx[GC];
#pragma unroll
      for (int i = 0; i < GC; ++i) mx[i] = NEG_INF;
      // the chunk's dtype a compile-time branch (a run-time one is
      // if-converted: both loads issued)
      auto keys = [&](auto int8) {
        for (int j0 = 0; j0 < ch.n; j0 += KP) {     // warp-uniform
          const int j = j0 + kq;
          const bool mask = j < ch.tru && j < ch.n;
          const int rot = j % ncl;
          for (int g0 = 0; g0 < G; g0 += GC) {
            float acc[GC];
#pragma unroll
            for (int i = 0; i < GC; ++i) acc[i] = 0.f;
            if (mask) {
              const float ks = decltype(int8)::value ? kb[j] : 0.f;
              for (int cc = 0; cc < ncl; ++cc) {
                const int ci = cc + rot < ncl ? cc + rot : cc + rot - ncl;
                const int cv = ci * T + lt;
                const Vec<VW> kv =
                    decltype(int8)::value
                        ? Vec<VW>::load8(kb8 + j * D + cv * VW, ks)
                        : Vec<VW>::template row<E>(
                              kb, (size_t)j * D + cv * VW);
#pragma unroll
                for (int i = 0; i < GC; ++i) {
                  const Vec<VW> qv =
                      Vec<VW>::load(q_s + (g0 + i) * D + cv * VW);
#pragma unroll
                  for (int e = 0; e < VW; ++e)
                    acc[i] = fmaf(qv.x[e], kv.x[e], acc[i]);
                }
              }
            }
#pragma unroll
            for (int i = 0; i < GC; ++i) {
              for (int off = T / 2; off; off >>= 1)
                acc[i] += __shfl_xor_sync(FULL, acc[i], off);
              if (g0 + i < G) {
                const float sc = mask ? acc[i] : NEG_INF;
                if (j < ch.n && lt == 0) s_s[(g0 + i) * K + ch.k0 + j] = sc;
                if constexpr (GC == 1) mx[0] = fmaxf(mx[0], sc);
                else wmax[(g0 + i) * WARPS + warp] = fmaxf(
                    warp_max(sc), wmax[(g0 + i) * WARPS + warp]);
              }
            }
          }
        }
      };
      if (q8) keys(std::true_type{});
      else keys(std::false_type{});
      if constexpr (GC == 1) {
        const float m = warp_max(mx[0]);
        if (lane == 0) wmax[warp] = fmaxf(wmax[warp], m);
      }
    }
  };
  for (int c0 = 0; c0 < nch; c0 += batch) {
    const int c1 = min(c0 + batch, nch);
    if (G == 1) score(Groups<1>{}, c0, c1);
    else score(Groups<4>{}, c0, c1);
    refill(c1);
  }
  __syncthreads();
  // scores done

  // a @ v: one warp per value chunk.  Lane j holds the weights a =
  // exp(s - m) of the chunk's keys j, j + 32, ... and adds a . w to the
  // warp's denominator; the warp's lanes form P = 32 / vlanes groups, group
  // h takes keys j = h (mod P) (their weights by shuffle) and its lanes
  // the column vectors lane % vlanes, + vlanes, ...; the groups' sums are
  // added by xor-shuffles, and the warp's partial accumulates in red.
  const int VL = p.vlanes, P = 32 / VL, grp = lane / VL, ncv_v = Dv / VW;
  auto accumulate = [&](auto groups, int c0, int c1) {
    constexpr int GC = decltype(groups)::value;
    for (int g0 = 0; g0 < G; g0 += GC) {
      float m[GC], dn[GC];
#pragma unroll
      for (int i = 0; i < GC; ++i) {
        m[i] = g0 + i < G ? group_max(wmax + (g0 + i) * WARPS) : MIN_M;
        dn[i] = 0.f;
      }
      for (int cv0 = 0; cv0 < ncv_v; cv0 += VL) {      // warp-uniform
        const int cv = cv0 + lane % VL;
        const bool act = cv < ncv_v;
        Vec<VW> acc[GC];
#pragma unroll
        for (int i = 0; i < GC; ++i) acc[i] = Vec<VW>{};
        for (int c = c0 + warp; c < c1; c += WARPS) {
          const Chunk ch = chunk(c);
          const int s = slot_of(nch + c, nch, ch.ib);
          mbar_wait(bar + s, parity_of(nch + c));
          const float* vs = ring + (size_t)s * p.slot;
          const bool q8 = is8(band_level(tb_band[ch.ib]));
          const int8_t* vb8 = reinterpret_cast<const int8_t*>(vs + p.qoff) +
                              cv * VW;
          const float wgt = (float)(1 << band_level(tb_band[ch.ib]));
          for (int jb = 0; jb < ch.n; jb += 32) {
            const int jl = jb + lane;             // this lane's key
            float a[GC];
#pragma unroll
            for (int i = 0; i < GC; ++i) {
              a[i] = jl < ch.n && g0 + i < G
                  ? expf(s_s[(g0 + i) * K + ch.k0 + jl] - m[i]) : 0.f;
              if (cv0 == 0 && jl < ch.tru) dn[i] = fmaf(a[i], wgt, dn[i]);
            }
            const int jn = min(32, ch.n - jb);
            auto values = [&](auto int8) {
#pragma unroll 4
              for (int j = grp; j < ((jn + P - 1) / P) * P; j += P) {
                Vec<VW> v{};
                if (act && j < jn)
                  v = decltype(int8)::value
                          ? Vec<VW>::load8(vb8 + (jb + j) * Dv, vs[jb + j])
                          : Vec<VW>::template row<E>(
                                vs, (size_t)(jb + j) * Dv + cv * VW);
#pragma unroll
                for (int i = 0; i < GC; ++i) {
                  const float aj = __shfl_sync(FULL, a[i], j & 31);
#pragma unroll
                  for (int e = 0; e < VW; ++e)
                    acc[i].x[e] = fmaf(aj, v.x[e], acc[i].x[e]);
                }
              }
            };
            if (q8) values(std::true_type{});
            else values(std::false_type{});
          }
        }
#pragma unroll
        for (int i = 0; i < GC; ++i) {
#pragma unroll
          for (int e = 0; e < VW; ++e)
            for (int off = 16; off >= VL; off >>= 1)
              acc[i].x[e] += __shfl_xor_sync(FULL, acc[i].x[e], off);
          if (grp == 0 && act && g0 + i < G) {
            float* dst = red + (warp * G + g0 + i) * Dv + cv * VW;
            if (!p.resident) {             // a later batch adds to it
              const Vec<VW> x = Vec<VW>::load(dst);
#pragma unroll
              for (int e = 0; e < VW; ++e) acc[i].x[e] += x.x[e];
            }
            acc[i].store(dst);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < GC; ++i) {
        const float d = warp_sum(dn[i]);
        if (lane == 0 && g0 + i < G) dpart[warp * G + g0 + i] += d;
      }
    }
  };
  for (int c0 = 0; c0 < nch; c0 += batch) {
    const int c1 = min(c0 + batch, nch);
    if (G == 1) accumulate(Groups<1>{}, c0, c1);
    else accumulate(Groups<4>{}, c0, c1);
    refill(nch + c1);
  }
  __syncthreads();
  // output partials done

  // the warps' partials and denominators added in warp order, VW outputs
  // a thread
  for (int o = tid * VW; o < G * Dv; o += THREADS * VW) {
    const int g = o / Dv;
    Vec<VW> acc = Vec<VW>::load(red + o);
    float den = dpart[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const Vec<VW> x = Vec<VW>::load(red + w * G * Dv + o);
#pragma unroll
      for (int e = 0; e < VW; ++e) acc.x[e] += x.x[e];
      den += dpart[w * G + g];
    }
    float* dst = out + (size_t)r * G * Dv + o;
    if (ADDR == ADDR_LOCAL) {
      acc.store(dst);
      if (o % Dv == 0) {
        den_out[(size_t)r * G + g] = den;
        m_out[(size_t)r * G + g] = group_max(wmax + g * WARPS);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) acc.x[e] /= fmaxf(den, 1e-9f);
      acc.store(dst);
    }
  }
}

// half: the levels that are not int8 hold bf16 rows.
template <int ADDR>
int launch_staged(const float* q, const Levels& lv, const int* t,
                  const int* bidx, const int* owned, float* out, float* den,
                  float* m, int R, int G, int D, int Dv, int nr, int nlev,
                  float scale, int half, int cr, void* stream) {
  if (nlev < 1 || nlev > MAXLEV || R < 1 || G < 1 || D < 1 || Dv < 1 ||
      nr < 1)
    return (int)cudaErrorInvalidValue;
  if (ADDR == ADDR_LOCAL || ADDR == ADDR_DENSE)   // a block's first row: int
    for (int l = 0; l < nlev; ++l)
      if ((long long)R * lv.rows[l] > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
  const bool quant = ADDR == ADDR_QPAGED && lv.qmask != 0;
  const AttendPlan p = attend_plan(G, D, Dv, nr, nlev, quant, half != 0, cr);
  if (p.stages < 1) return (int)cudaErrorInvalidValue;
  auto at16 = [](const void* a) {
    return reinterpret_cast<uintptr_t>(a) % 16 == 0;
  };
  bool aligned = true;
  for (int l = 0; l < nlev; ++l) {
    aligned = aligned && at16(lv.k[l]) && at16(lv.v[l]);
    if (quant && ((lv.qmask >> l) & 1u))
      aligned = aligned && at16(lv.ksc[l]) && at16(lv.vsc[l]);
  }
  const int vec = half ? 8 : 4;   // values in 16 bytes
  const int bulk = aligned && (p.quantum > 1 || (!quant && D % vec == 0 &&
                                                 Dv % vec == 0)) ? 1 : 0;
  using BF = __nv_bfloat16;
  auto kernel = half ? (p.vw == 4 ? attend_staged_kernel<ADDR, 4, BF>
                                  : attend_staged_kernel<ADDR, 1, BF>)
                     : (p.vw == 4 ? attend_staged_kernel<ADDR, 4, float>
                                  : attend_staged_kernel<ADDR, 1, float>);
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  h1d_info::note(0, kernel, THREADS, p.smem, R);
  kernel<<<R, THREADS, p.smem, (cudaStream_t)stream>>>(
      t, bidx, owned, q, out, den, m, G, D, Dv, nr, nlev, scale, bulk, p, lv);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 paged update (#10)
// ---------------------------------------------------------------------------

// Bytes of one level in a chain's shared memory: its sibling pair as
// staged (two rows of W int8, f32 or, where `half`, bf16 values); an
// int8 level then its two staged scales, the f32 pair after the carry is
// put in, and each lane's absmax of both rows (2 x 32 floats).  Every
// part 16-byte aligned.
__host__ __device__ __forceinline__ int pair_bytes(int W, bool q8,
                                                   bool half) {
  return q8 ? ceil_to(2 * W, 16) + 16 + ceil_to(8 * W, 16) + 256
            : ceil_to((half ? 4 : 8) * W, 16);
}

__host__ __device__ __forceinline__ int chain_bytes(int W, unsigned qmask,
                                                    int nlev, bool half) {
  int n = 0;
  for (int l = 0; l < nlev; ++l)
    n += pair_bytes(W, (qmask >> l) & 1u, half);
  return n;
}

__device__ __forceinline__ int8_t quantize(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -QMAX), QMAX);
}

// First row, in its page, of the sibling pair that holds ancestor t >> l
// (l up to 31: a shift by 32 is 0 here, not undefined).
__device__ __forceinline__ int pair_in_page(int t, int l, int nr) {
  return 2 * ((l < 31 ? t >> (l + 1) : 0) & (nr / 2 - 1));
}

// `bytes` from src into dst (16-byte aligned) by one thread: 16-byte
// cp.async where src and bytes allow it, else 4-byte, else plain byte
// loads (int8 rows of odd width or at an odd address).
__device__ __forceinline__ void lane_stage(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(src) |
                     (unsigned)bytes;
  if (a % 16 == 0)
    for (int e = 0; e < bytes; e += 16) cp_async16(dst + e, src + e);
  else if (a % 4 == 0)
    for (int e = 0; e < bytes; e += 4) cp_async4(dst + e, src + e);
  else
    for (int e = 0; e < bytes; ++e) dst[e] = src[e];
}

// One CTA per cache row; warps 2i and 2i + 1 serve the row's k and v
// chains (the two never meet).  Lane i holds columns i, i + 32, ... (C of
// them).  The sibling pairs of every level (and an int8 level's two
// scales) sit where t and utab[r] alone say, so lane l of warps 0 and 1
// reads t and utab[r, l] and puts level l's pair in flight at once with
// every other lane's.  Then, with no memory round trip between levels:
//   A. warps 0 and 1 run the carry chain: per level the pair dequantized
//      (an int8 level) or widened (a bf16 one), the carry put in, an f32
//      level stored, a bf16 level stored rounded to nearest even (the
//      reference's Pallas update: pk.astype(dtype) on the store, the f32
//      pair carried), an int8 level's f32 pair
//      and each lane's absmax of both rows kept in shared memory, the
//      pair's mean (k) or sum (v) carried;
//   B. lane l takes int8 level l's row maxima over the 32 lanes (exact,
//      in any order) and its two fresh scales, and stores the scales;
//   C. every int8 level is requantized and stored, level l by the warps
//      of part l % UPD_PARTS, no level waiting on another (the IEEE
//      divisions are most of the work).
constexpr int UPD_PARTS = 4;

template <int C>
__global__ void __launch_bounds__(64 * UPD_PARTS)
update_cache_quant_kernel(const float* __restrict__ knew,
                          const float* __restrict__ vnew,
                          const int* __restrict__ tpos,
                          const int* __restrict__ utab, MutLevels lv, int D,
                          int Dv, int nr, int nlev, int half) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool is_k = warp % 2 == 0;
  const int part = warp / 2;
  const int W = is_k ? D : Dv;
  const int t = tpos[r];
  const int upage = lane < nlev ? utab[(size_t)r * nlev + lane] : 0;
  unsigned char* buf =
      smem + (is_k ? 0 : chain_bytes(D, lv.qmask, nlev, half));
  const int q2 = ceil_to(2 * W, 16), f8 = ceil_to(8 * W, 16);
  if (part == 0) {
    const float* fresh = (is_k ? knew : vnew) + (size_t)r * W;
    float carry[C];
#pragma unroll
    for (int i = 0; i < C; ++i)
      carry[i] = lane + 32 * i < W ? fresh[lane + 32 * i] : 0.f;
    // lane l: level l's first pair row and its offset
    const bool q8l = lane < nlev && ((lv.qmask >> lane) & 1u);
    const size_t row0l = (size_t)upage * nr + pair_in_page(t, lane, nr);
    const int offl = chain_bytes(W, lv.qmask, lane < nlev ? lane : 0, half);
    if (lane < nlev) {
      const int es = q8l ? 1 : half ? 2 : 4;
      lane_stage(buf + offl,
                 static_cast<const unsigned char*>(is_k ? lv.k[lane]
                                                        : lv.v[lane]) +
                     row0l * W * es,
                 2 * W * es);
      if (q8l) {
        const float* sc = (is_k ? lv.ksc[lane] : lv.vsc[lane]) + row0l;
        cp_async4(buf + offl + q2, sc);
        cp_async4(buf + offl + q2 + 4, sc + 1);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();

    // A: the carry chain.  Level l + 1's pair is read (and dequantized)
    // before level l's stores, which the compiler must otherwise keep
    // ahead of any later shared-memory read.
    auto pair_at = [&](int l, int off, float (&x0)[C], float (&x1)[C]) {
      if ((lv.qmask >> l) & 1u) {
        const int8_t* pr = reinterpret_cast<const int8_t*>(buf + off);
        const float* sc = reinterpret_cast<const float*>(buf + off + q2);
        const float s0 = sc[0], s1 = sc[1];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int c = lane + 32 * i;
          x0[i] = c < W ? __fmul_rn((float)pr[c], s0) : 0.f;
          x1[i] = c < W ? __fmul_rn((float)pr[W + c], s1) : 0.f;
        }
      } else if (half) {              // bf16: widened, exactly
        const __nv_bfloat16* pr =
            reinterpret_cast<const __nv_bfloat16*>(buf + off);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int c = lane + 32 * i;
          x0[i] = c < W ? __bfloat162float(pr[c]) : 0.f;
          x1[i] = c < W ? __bfloat162float(pr[W + c]) : 0.f;
        }
      } else {
        const float* pr = reinterpret_cast<const float*>(buf + off);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int c = lane + 32 * i;
          x0[i] = c < W ? pr[c] : 0.f;
          x1[i] = c < W ? pr[W + c] : 0.f;
        }
      }
    };
    float y0[C], y1[C];
    pair_at(0, 0, y0, y1);
    for (int l = 0, off = 0; l < nlev; ++l) {
      const bool q8 = (lv.qmask >> l) & 1u;
      const int sel = (t >> l) & 1;
      const int next = off + pair_bytes(W, q8, half);
      float x0[C], x1[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {   // columns past W: carry 0, stay 0
        x0[i] = sel ? y0[i] : carry[i];
        x1[i] = sel ? carry[i] : y1[i];
      }
      if (l + 1 < nlev) pair_at(l + 1, next, y0, y1);
      if (q8) {
        float* xs = reinterpret_cast<float*>(buf + off + q2 + 16);
        float m0 = 0.f, m1 = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int c = lane + 32 * i;
          if (c < W) {
            xs[c] = x0[i];
            xs[W + c] = x1[i];
          }
          m0 = fmaxf(m0, fabsf(x0[i]));
          m1 = fmaxf(m1, fabsf(x1[i]));
        }
        float* pm = reinterpret_cast<float*>(buf + off + q2 + 16 + f8);
        pm[lane] = m0;
        pm[32 + lane] = m1;
      } else {
        const size_t row0 =
            (size_t)__shfl_sync(FULL, upage, l) * nr + pair_in_page(t, l, nr);
        void* base = is_k ? lv.k[l] : lv.v[l];
        if (half) {
          __nv_bfloat16* b = static_cast<__nv_bfloat16*>(base) + row0 * W;
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const int c = lane + 32 * i;
            if (c < W) {
              b[c] = __float2bfloat16_rn(x0[i]);
              b[W + c] = __float2bfloat16_rn(x1[i]);
            }
          }
        } else {
          float* b = static_cast<float*>(base) + row0 * W;
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const int c = lane + 32 * i;
            if (c < W) {
              b[c] = x0[i];
              b[W + c] = x1[i];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < C; ++i)
        carry[i] = is_k ? __fmul_rn(__fadd_rn(x0[i], x1[i]), 0.5f)
                        : __fadd_rn(x0[i], x1[i]);
      off = next;
    }
    __syncwarp();

    // B: lane l, int8 level l's scales (its maxima read in a rotated
    // order, so the 32 lanes hit 32 banks), in place of the staged ones
    if (q8l) {
      const float* pm =
          reinterpret_cast<const float*>(buf + offl + q2 + 16 + f8);
      float m0 = 0.f, m1 = 0.f;
      for (int i = 0; i < 32; ++i) {
        const int j = (i + lane) % 32;
        m0 = fmaxf(m0, pm[j]);
        m1 = fmaxf(m1, pm[32 + j]);
      }
      const float s0 = __fmul_rn(fmaxf(m0, QEPS), RECIP_QMAX);
      const float s1 = __fmul_rn(fmaxf(m1, QEPS), RECIP_QMAX);
      float* ss = reinterpret_cast<float*>(buf + offl + q2);
      ss[0] = s0;
      ss[1] = s1;
      float* sc = (is_k ? lv.ksc[lane] : lv.vsc[lane]) + row0l;
      sc[0] = s0;
      sc[1] = s1;
    }
  }
  __syncthreads();

  // C: this part's int8 levels requantized and stored, the next one's f32
  // pair and scales read before this one's stores
  auto next8 = [&](int l, int& off) {    // this part's first int8 level >= l
    for (; l < nlev && !(((lv.qmask >> l) & 1u) && l % UPD_PARTS == part);
         ++l)
      off += pair_bytes(W, (lv.qmask >> l) & 1u, half);
    return l;
  };
  auto f32_pair = [&](int off, float (&z0)[C], float (&z1)[C], float& s0,
                      float& s1) {
    const float* ss = reinterpret_cast<const float*>(buf + off + q2);
    s0 = ss[0];
    s1 = ss[1];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
      z0[i] = c < W ? ss[4 + c] : 0.f;
      z1[i] = c < W ? ss[4 + W + c] : 0.f;
    }
  };
  int off = 0;
  int l = next8(0, off);
  float z0[C], z1[C], s0 = 1.f, s1 = 1.f;
  if (l < nlev) f32_pair(off, z0, z1, s0, s1);
  while (l < nlev) {
    int8_t q0[C], q1[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      q0[i] = quantize(z0[i], s0);
      q1[i] = quantize(z1[i], s1);
    }
    const size_t row0 =
        (size_t)__shfl_sync(FULL, upage, l) * nr + pair_in_page(t, l, nr);
    int8_t* b = static_cast<int8_t*>(is_k ? lv.k[l] : lv.v[l]) + row0 * W;
    off += pair_bytes(W, true, half);
    const int ln = next8(l + 1, off);
    if (ln < nlev) f32_pair(off, z0, z1, s0, s1);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
      if (c < W) {
        b[c] = q0[i];
        b[W + c] = q1[i];
      }
    }
    l = ln;
  }
}

// ---------------------------------------------------------------------------
// f32 dense, partial and paged updates (#6, #12, #9)
// ---------------------------------------------------------------------------

// Shared memory a CTA of update_chain_kernel stages its pairs (and #9 its
// page table) in, at most: the threads are cut to fit it (a column loop
// takes the rest).
constexpr int CHAIN_SMEM = 48 * 1024;

// The cache element E: float, or __nv_bfloat16 (read widened, stored
// rounded to nearest even, the chain itself in f32: the reference's
// Pallas update).  A bf16 pair is read by plain loads into the f32
// slots (cp.async copies 4 bytes at least).
template <typename E>
__device__ __forceinline__ E to_elem(float x) {
  if constexpr (std::is_same<E, float>::value)
    return x;
  else
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void stage_elem(float* dst, const float* src) {
  cp_async4(dst, src);
}

__device__ __forceinline__ void stage_elem(float* dst,
                                           const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

// #6 (ADDR_DENSE: dense slabs), #12 (ADDR_LOCAL: one shard's sharded
// levels at the shard-local t; only rows with owned[r] != 0 write, and
// every row's carry past its last level goes to carry_k / carry_v (R, D /
// Dv), rounded to E as the reference stores it) and #9 (ADDR_PAGED: level
// l's pair on page utab[r, l] of the pool, at pair_in_page).  One CTA per
// cache row, a column a thread (k's D columns, then v's Dv).  Every
// level's pair sits where t (and utab[r]) alone say and no two levels
// share storage, so, in this order:
//   1. t and owned, or t and the row's page table utab[r, :] (one lane a
//      level, into shared memory, one barrier), read, all in flight;
//   2. both rows of every level's pair put in flight at once, by
//      cp.async into the thread's own slots of shared memory, (2 nlev,
//      T) floats (a non-owner carries the pair as stored);
//   3. the carry chain: an owner row's carry takes row (t >> l) & 1 of
//      level l's pair and is stored there, the next carry is the pair's
//      mean (k) or sum (v) in the plain version's rounding (no FMA
//      contraction); level l + 1's pair is read from shared memory
//      before level l's store, which the compiler must keep ahead of
//      later shared-memory reads;
//   4. #12's carry stored.
// The level loops stay loops: the chain unrolled into registers
// (levels to a compile-time bound), level 0 alone in registers, a warp
// a level for the copies and the stores all ran slower on the card.  No
// thread reads another's pair slots.
template <int ADDR, typename E>
__global__ void __launch_bounds__(1024)
update_chain_kernel(const float* __restrict__ knew,
                    const float* __restrict__ vnew,
                    const int* __restrict__ tpos,
                    const int* __restrict__ owned,
                    const int* __restrict__ utab, MutLevels lv, int Lmax,
                    int nr, int D, int Dv, int nlev, E* __restrict__ carry_k,
                    E* __restrict__ carry_v) {
  extern __shared__ __align__(16) float pr[];
  const int r = blockIdx.x, T = blockDim.x, tid = threadIdx.x;
  int* page = reinterpret_cast<int*>(pr + 2 * nlev * T);   // PAGED: utab[r]
  const int t = tpos[r];
  const bool own = ADDR != ADDR_LOCAL || owned[r] != 0;
  if constexpr (ADDR == ADDR_PAGED) {
    if (tid < nlev) page[tid] = utab[(size_t)r * nlev + tid];
    __syncthreads();
  }
  // first row of level l's pair in the k (is_k) or v array of width W
  auto pair = [&](bool is_k, int l, int W) {
    if constexpr (ADDR == ADDR_PAGED)
      return static_cast<E*>(is_k ? lv.k[l] : lv.v[l]) +
             ((size_t)page[l] * nr + pair_in_page(t, l, nr)) * W;
    else
      return dense_pair<E>(lv, is_k, l, r, t, Lmax, W);
  };
  for (int c = tid; c < D + Dv; c += T) {
    const bool is_k = c < D;
    const int W = is_k ? D : Dv;
    const int col = is_k ? c : c - D;
    float carry = is_k ? knew[(size_t)r * D + col] : vnew[(size_t)r * Dv + col];
    for (int l = 0; l < nlev; ++l) {
      const E* p = pair(is_k, l, W) + col;
      stage_elem(pr + 2 * l * T + tid, p);
      stage_elem(pr + (2 * l + 1) * T + tid, p + W);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    float x0 = pr[tid], x1 = pr[T + tid];
    for (int l = 0; l < nlev; ++l) {
      const int sel = (t >> l) & 1;
      if (own) {
        if (sel) x1 = carry;
        else x0 = carry;
      }
      const float y0 = l + 1 < nlev ? pr[(2 * l + 2) * T + tid] : 0.f;
      const float y1 = l + 1 < nlev ? pr[(2 * l + 3) * T + tid] : 0.f;
      if (own)
        pair(is_k, l, W)[(size_t)sel * W + col] = to_elem<E>(sel ? x1 : x0);
      carry = is_k ? __fmul_rn(__fadd_rn(x0, x1), 0.5f) : __fadd_rn(x0, x1);
      x0 = y0;
      x1 = y1;
    }
    if (ADDR == ADDR_LOCAL)
      (is_k ? carry_k : carry_v)[(size_t)r * W + col] = to_elem<E>(carry);
  }
}

// Threads: a column each, at most 1024 and as many as CHAIN_SMEM stages
// (2 nlev floats a thread, after #9's page table), in whole warps.
// half: the levels (and #12's carries) hold bf16.
template <int ADDR>
int launch_chain(const float* knew, const float* vnew, const int* t,
                 const int* owned, const int* utab, const MutLevels& lv,
                 int R, int Lmax, int nr, int D, int Dv, int nlev,
                 void* carry_k, void* carry_v, int half, void* stream) {
  const int tab = ADDR == ADDR_PAGED ? 4 * nlev : 0;
  const int fit = (CHAIN_SMEM - tab) / (8 * nlev) / 32 * 32;
  const int threads = min(min(1024, fit), (D + Dv + 31) / 32 * 32);
  const int smem = 8 * nlev * threads + tab;
  using BF = __nv_bfloat16;
  h1d_info::note(0, half ? (const void*)update_chain_kernel<ADDR, BF>
                         : (const void*)update_chain_kernel<ADDR, float>,
                 threads, smem, R);
  if (half)
    update_chain_kernel<ADDR, BF><<<R, threads, smem, (cudaStream_t)stream>>>(
        knew, vnew, t, owned, utab, lv, Lmax, nr, D, Dv, nlev,
        static_cast<BF*>(carry_k), static_cast<BF*>(carry_v));
  else
    update_chain_kernel<ADDR, float>
        <<<R, threads, smem, (cudaStream_t)stream>>>(
            knew, vnew, t, owned, utab, lv, Lmax, nr, D, Dv, nlev,
            static_cast<float*>(carry_k), static_cast<float*>(carry_v));
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

// Every level array below holds f32, or bf16 where half != 0; q, k_new,
// v_new and the attends' outputs are f32.
//
// q (R,G,D), fine k (R,Lmax,D), v (R,Lmax,Dv), coarse ck[l-1]
// (R,Lmax>>l,D) and cv[l-1] for l = 1..ncoarse, t (R,) int32
// -> out (R,G,Dv), normalised.
extern "C" int h1d_decode_attend(const float* q, const void* k,
                                 const void* v, const void* const* ck,
                                 const void* const* cv, const int* t,
                                 float* out, int R, int G, int Lmax, int D,
                                 int Dv, int nr, int ncoarse, float scale,
                                 int half, int cr, void* stream) {
  h1d_info::clear();
  if (ncoarse < 0 || ncoarse + 1 > MAXLEV || R < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv{};
  lv.k[0] = k;
  lv.v[0] = v;
  lv.rows[0] = Lmax;
  for (int l = 0; l < ncoarse; ++l) {
    lv.k[l + 1] = ck[l];
    lv.v[l + 1] = cv[l];
    lv.rows[l + 1] = Lmax >> (l + 1);
  }
  return launch_staged<ADDR_DENSE>(q, lv, t, nullptr, nullptr, out, nullptr,
                                   nullptr, R, G, D, Dv, nr, ncoarse + 1,
                                   scale, half, cr, stream);
}

// Paged pools: ks[l]/vs[l] level l's (NP_l, nr, D/Dv) pages for
// l = 0..nlev-1; bidx (R, nlev+1) int32 physical pool rows per band.
extern "C" int h1d_decode_attend_paged(const float* q, const void* const* ks,
                                       const void* const* vs, const int* t,
                                       const int* bidx, float* out, int R,
                                       int G, int D, int Dv, int nr,
                                       int nlev, float scale, int half,
                                       int cr, void* stream) {
  h1d_info::clear();
  if (nlev < 1 || nlev > MAXLEV) return (int)cudaErrorInvalidValue;
  const Levels lv = read_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  return launch_staged<ADDR_PAGED>(q, lv, t, bidx, nullptr, out, nullptr,
                                   nullptr, R, G, D, Dv, nr, nlev, scale,
                                   half, cr, stream);
}

// As h1d_decode_attend_paged; level l stores int8 pages when bit l of
// qmask is set, with per-row f32 scales kscs[l]/vscs[l] (NP_l, nr); the
// other levels f32, or bf16 where half != 0.
extern "C" int h1d_decode_attend_paged_quant(
    const float* q, const void* const* ks, const void* const* vs,
    const void* const* kscs, const void* const* vscs, int qmask,
    const int* t, const int* bidx, float* out, int R, int G, int D, int Dv,
    int nr, int nlev, float scale, int half, int cr, void* stream) {
  h1d_info::clear();
  if (nlev < 1 || nlev > MAXLEV) return (int)cudaErrorInvalidValue;
  const Levels lv = read_levels(ks, vs, kscs, vscs, (unsigned)qmask, nlev);
  return launch_staged<ADDR_QPAGED>(q, lv, t, bidx, nullptr, out, nullptr,
                                    nullptr, R, G, D, Dv, nr, nlev, scale,
                                    half, cr, stream);
}

// k_new (R,D), v_new (R,Dv), t (R,) int32; ks[l]/vs[l] are level l's
// (R, Lmax>>l, D/Dv) arrays for l = 0..nlev-1, updated in place.
extern "C" int h1d_update_cache(const float* knew, const float* vnew,
                                const int* t, void* const* ks,
                                void* const* vs, int R, int Lmax, int D,
                                int Dv, int nlev, int half, void* stream) {
  h1d_info::clear();
  if (nlev < 1 || nlev > MAXLEV || R < 1) return (int)cudaErrorInvalidValue;
  const MutLevels lv = write_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  return launch_chain<ADDR_DENSE>(knew, vnew, t, nullptr, nullptr, lv, R,
                                  Lmax, 0, D, Dv, nlev, nullptr, nullptr,
                                  half, stream);
}

// Paged pools: ks[l]/vs[l] level l's (NP_l, nr, D/Dv) pages; utab
// (R, nlev) int32 physical pool rows of the ancestor pages.
extern "C" int h1d_update_cache_paged(const float* knew, const float* vnew,
                                      const int* t, const int* utab,
                                      void* const* ks, void* const* vs,
                                      int R, int D, int Dv, int nr, int nlev,
                                      int half, void* stream) {
  h1d_info::clear();
  if (nlev < 1 || nlev > MAXLEV || R < 1 || nr < 2)
    return (int)cudaErrorInvalidValue;
  const MutLevels lv = write_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  return launch_chain<ADDR_PAGED>(knew, vnew, t, nullptr, utab, lv, R, 0, nr,
                                  D, Dv, nlev, nullptr, nullptr, half,
                                  stream);
}

// As h1d_update_cache_paged with int8 levels (bit l of qmask) and their
// per-row scales kscs[l]/vscs[l] (NP_l, nr), rewritten in place; the
// other levels f32, or bf16 where half != 0 (one unrounded f32 carry
// chain through every level, each stored bf16 row rounded once).  D and
// Dv up to 1024 (32 columns a lane), and one row's staged pairs, every
// level's k and v pair and scales (chain_bytes), within SMEM_LIMIT.
extern "C" int h1d_update_cache_paged_quant(
    const float* knew, const float* vnew, const int* t, const int* utab,
    void* const* ks, void* const* vs, void* const* kscs, void* const* vscs,
    int qmask, int R, int D, int Dv, int nr, int nlev, int half,
    void* stream) {
  h1d_info::clear();
  if (nlev < 1 || nlev > MAXLEV || R < 1 || nr < 2 || D < 1 || Dv < 1 ||
      D > 1024 || Dv > 1024)
    return (int)cudaErrorInvalidValue;
  const MutLevels lv = write_levels(ks, vs, kscs, vscs, (unsigned)qmask,
                                    nlev);
  const int smem = chain_bytes(D, lv.qmask, nlev, half != 0) +
                   chain_bytes(Dv, lv.qmask, nlev, half != 0);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int cols = (max(D, Dv) + 31) / 32;
  auto kernel = cols <= 1 ? update_cache_quant_kernel<1>
              : cols <= 2 ? update_cache_quant_kernel<2>
              : cols <= 4 ? update_cache_quant_kernel<4>
              : cols <= 8 ? update_cache_quant_kernel<8>
              : cols <= 16 ? update_cache_quant_kernel<16>
                           : update_cache_quant_kernel<32>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  h1d_info::note(0, kernel, 64 * UPD_PARTS, smem, R);
  kernel<<<R, 64 * UPD_PARTS, smem, (cudaStream_t)stream>>>(
      knew, vnew, t, utab, lv, D, Dv, nr, nlev, half != 0);
  return (int)cudaGetLastError();
}

// One shard's slab: ks[l]/vs[l] level l's (R, rows[l], D/Dv) arrays
// for l = 0..nlev-1 (rows: host array, each a multiple of nr); bidx and
// owned (R, nlev+1) int32 local block index and ownership bit per band; t
// (R,) global positions -> num (R,G,Dv), den (R,G), m (R,G), unnormalised.
extern "C" int h1d_decode_attend_partial(
    const float* q, const void* const* ks, const void* const* vs,
    const int* rows, const int* t, const int* bidx, const int* owned,
    float* num, float* den, float* m, int R, int G, int D, int Dv, int nr,
    int nlev, float scale, int half, int cr, void* stream) {
  h1d_info::clear();
  if (nlev < 1 || nlev > MAXLEV) return (int)cudaErrorInvalidValue;
  Levels lv = read_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  for (int l = 0; l < nlev; ++l) lv.rows[l] = rows[l];
  return launch_staged<ADDR_LOCAL>(q, lv, t, bidx, owned, num, den, m, R, G,
                                   D, Dv, nr, nlev, scale, half, cr, stream);
}

// One shard's sharded levels: ks[l]/vs[l] (R, Lloc>>l, D/Dv) for
// l = 0..nlev-1, updated in place on rows with owned[r] != 0; t_loc (R,)
// shard-local positions (may exceed Lloc) -> carry_k (R,D), carry_v
// (R,Dv) in the levels' element type.
extern "C" int h1d_update_cache_partial(const float* knew, const float* vnew,
                                        const int* t_loc, const int* owned,
                                        void* const* ks, void* const* vs,
                                        void* carry_k, void* carry_v, int R,
                                        int Lloc, int D, int Dv, int nlev,
                                        int half, void* stream) {
  h1d_info::clear();
  if (nlev < 1 || nlev > MAXLEV || R < 1) return (int)cudaErrorInvalidValue;
  const MutLevels lv = write_levels(ks, vs, nullptr, nullptr, 0u, nlev);
  return launch_chain<ADDR_LOCAL>(knew, vnew, t_loc, owned, nullptr, lv, R,
                                  Lloc, 0, D, Dv, nlev, carry_k, carry_v,
                                  half, stream);
}

// The staged attend's launch plan (#5, #7, #8, #11) for the host's mirror
// (kernels/h1d_decode_kernel.plan_attend_stages): quant != 0 for a pool
// with int8 levels, half != 0 for bf16 levels; out[0..3] = stages, rows a
// chunk, row quantum, shared memory bytes.
extern "C" int h1d_decode_attend_plan(int G, int D, int Dv, int nr, int nlev,
                                      int quant, int half, int* out) {
  if (nlev < 1 || nlev > MAXLEV || G < 1 || D < 1 || Dv < 1 || nr < 1)
    return (int)cudaErrorInvalidValue;
  const AttendPlan p = attend_plan(G, D, Dv, nr, nlev, quant != 0,
                                   half != 0);
  out[0] = p.stages;
  out[1] = p.cr;
  out[2] = p.quantum;
  out[3] = p.smem;
  return 0;
}

// The grid ((R, 1): one CTA a row) and dynamic shared memory of this
// library's last launch on the calling thread, and its kernel's
// registers, static shared memory, most threads and CTAs an SM
// (launch_info.cuh), for the wrappers' launch records.
extern "C" int h1d_decode_last_grid(int* out) {
  return h1d_info::last_grid(out);
}

extern "C" int h1d_decode_last_smem(int* out) {
  return h1d_info::last_smem(out);
}

extern "C" int h1d_decode_last_attrs(int* out) {
  return h1d_info::last_attrs(out);
}
