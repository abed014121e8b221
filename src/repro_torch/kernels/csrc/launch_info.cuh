// Per-launch accounting for the wrappers' launch records
// (repro_torch.analysis.contracts): the kernels that a library's last
// launch on the calling thread ran, with each one's block size and the
// dynamic shared memory its launcher set.  Each library (each .cu file)
// keeps its own copy and exports two readers (the decode library also a
// third, <lib>_last_grid, its one kernel's grid: the band libraries keep
// theirs in h1d_band.cuh):
//   * <lib>_last_smem(int out[2]): the dynamic shared memory of the first
//     and second kernel (0 where the launch ran one);
//   * <lib>_last_attrs(int out[8]): per kernel, cudaFuncGetAttributes'
//     numRegs, sharedSizeBytes (static) and maxThreadsPerBlock, then
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's block
//     and dynamic shared memory (zeros where no kernel ran).
#pragma once

#include <cuda_runtime.h>

namespace h1d_info {

struct Launched {
  const void* fn;
  int threads;
  int smem;
  int gx, gy;
};

static thread_local Launched launched[2];

__host__ inline void clear() {
  launched[0] = Launched{nullptr, 0, 0, 0, 0};
  launched[1] = Launched{nullptr, 0, 0, 0, 0};
}

template <typename Kernel>
__host__ inline void note(int i, Kernel kernel, int threads, size_t smem,
                          int gx = 0, int gy = 1) {
  launched[i] = Launched{(const void*)kernel, threads, (int)smem, gx, gy};
}

// {x, y} of the first kernel's grid, then of the second's ({0, 0} where
// none ran), as h1d::note_grid keeps them
__host__ inline int last_grid(int* out) {
  for (int i = 0; i < 2; ++i) {
    out[2 * i] = launched[i].fn ? launched[i].gx : 0;
    out[2 * i + 1] = launched[i].fn ? launched[i].gy : 0;
  }
  return 0;
}

__host__ inline int last_smem(int* out) {
  out[0] = launched[0].smem;
  out[1] = launched[1].smem;
  return 0;
}

__host__ inline int last_attrs(int* out) {
  for (int i = 0; i < 2; ++i) {
    int* o = out + 4 * i;
    o[0] = o[1] = o[2] = o[3] = 0;
    if (launched[i].fn == nullptr) continue;
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, launched[i].fn);
    if (e != cudaSuccess) return (int)e;
    int ctas = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, launched[i].fn, launched[i].threads,
        (size_t)launched[i].smem);
    if (e != cudaSuccess) return (int)e;
    o[0] = a.numRegs;
    o[1] = (int)a.sharedSizeBytes;
    o[2] = a.maxThreadsPerBlock;
    o[3] = ctas;
  }
  return 0;
}

}  // namespace h1d_info
