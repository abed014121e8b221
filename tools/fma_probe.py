"""fp32 FMA throughput on the card, alone and from shared-memory register
tiles at the streamed band kernels' occupancy.

    PYTHONPATH=src python tools/fma_probe.py

Builds a small CUDA program with ``nvcc`` (into ``build/fma_probe/``) and
runs it: first 16 independent fmaf chains a thread on every SM (the
card's reachable fp32 rate), then the score loop of the streamed bodies,
an R-row x K-key register tile of fmaf chains over 256 columns read as
float4 from shared memory, at one 256-thread CTA an SM (the streamed
kernels' occupancy), for the tile shapes the bodies could take.  Each
line gives TFLOP/s and the share of the 66.9 TFLOP/s fp32 peak.  Needs a
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import subprocess

import torch

from repro_torch.kernels import _build

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) chains(float* out, int iters) {
  float a[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = threadIdx.x * 1e-3f + j;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) a[j] = fmaf(a[j], 0.99999f, 1e-6f);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += a[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// lanes: 4 row groups (rows lr + 4 i) x 8 key groups (keys lk + 8 t), as
// the streamed bodies lay out their score tiles; rows of 260 floats
template <int R, int K>
__global__ void __launch_bounds__(256, 1) tile(float* out, int reps) {
  constexpr int QS = 260;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  for (int e = threadIdx.x; e < 128 * QS; e += 256) sm[e] = (e % 7) * 0.01f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* a = sm + ((warp * 4 + (lane >> 3)) % 64) * QS;
  const float* b = sm + (64 + (lane & 7)) * QS;
  float acc[R][K] = {};
  for (int it = 0; it < reps; ++it) {
#pragma unroll 4
    for (int c = 0; c < 256; c += 4) {
      float4 x[R], y[K];
#pragma unroll
      for (int r = 0; r < R; ++r)
        x[r] = *reinterpret_cast<const float4*>(a + (4 * r % 64) * QS + c);
#pragma unroll
      for (int t = 0; t < K; ++t)
        y[t] = *reinterpret_cast<const float4*>(b + 8 * t * QS + c);
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
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < K; ++t) s += acc[r][t];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

float time_ms(void (*launch)(float*), float* out) {
  launch(out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  launch(out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

int sms;
void run_chains(float* out) { chains<<<sms * 8, 256>>>(out, 1 << 16); }

template <int R, int K>
void run_tile(float* out) {
  tile<R, K><<<sms, 256, 200 * 1024>>>(out, 2000);
}

template <int R, int K>
void report_tile(float* out) {
  cudaFuncSetAttribute(tile<R, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       200 * 1024);
  const float ms = time_ms(run_tile<R, K>, out);
  const double tf = 2.0 * R * K * 256 * 2000.0 * 256 * sms / ms / 1e9;
  printf("tile %dx%d: %.3f ms, %.1f TFLOP/s, %.0f %% of 66.9\n", R, K, ms,
         tf, tf / 66.9 * 100);
}

int main() {
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 8 * 256 * sizeof(float));
  const float ms = time_ms(run_chains, out);
  const double tf = 2.0 * 16 * (1 << 16) * (double)sms * 8 * 256 / ms / 1e9;
  printf("fmaf chains: %.3f ms, %.1f TFLOP/s, %.0f %% of 66.9\n", ms, tf,
         tf / 66.9 * 100);
  report_tile<2, 4>(out);
  report_tile<4, 4>(out);
  report_tile<8, 4>(out);
  report_tile<4, 8>(out);
  report_tile<8, 8>(out);
  const cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) {
    printf("CUDA error %d\n", (int)e);
    return 1;
  }
  return 0;
}
"""


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("fma_probe needs a CUDA card")
    out = _build.BUILD_DIR.parent / "fma_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fma_probe.cu").write_text(SOURCE)
    exe = out / "fma_probe"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", str(exe),
                    str(out / "fma_probe.cu")], check=True)
    print(torch.cuda.get_device_name(0))
    subprocess.run([str(exe)], check=True)


if __name__ == "__main__":
    main()
