// The divergence and the gradient subtraction shared by the pressure
// kernels (H4, H5 in pressure.cu) and the multigrid ends (H6 in
// multigrid.cu).  Every tap clamps.
#pragma once

#include "fluid_common.cuh"

// (uR - uL) + (vT - vB) at (x, y), times 0.5 when half (GPUFluidSim.cu:297-310)
__device__ __forceinline__ float fluid_divergence_at(const float* __restrict__ u,
                                                     const float* __restrict__ v,
                                                     int x, int y, int h, int w,
                                                     int half) {
  const int row = y * w;
  const float ul = u[row + fluid_clamp(x - 1, w)];
  const float ur = u[row + fluid_clamp(x + 1, w)];
  const float vb = v[fluid_clamp(y - 1, h) * w + x];
  const float vt = v[fluid_clamp(y + 1, h) * w + x];
  const float d = (ur - ul) + (vt - vb);
  return half ? 0.5f * d : d;
}

// u2 = u - 0.5*(pR - pL), v2 = v - 0.5*(pT - pB) (GPUFluidSim.cu:498-516);
// when stats is not null, [max|u2|, max|v2|] by block max + atomicMax
// (stats must hold 0 before the launch).
__global__ void project_kernel(const float* __restrict__ p,
                               const float* __restrict__ u,
                               const float* __restrict__ v,
                               float* __restrict__ u2,
                               float* __restrict__ v2,
                               float* __restrict__ stats, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  float mu = 0.f, mv = 0.f;
  if (x < w && y < h) {
    const int row = y * w;
    const float pl = p[row + fluid_clamp(x - 1, w)];
    const float pr = p[row + fluid_clamp(x + 1, w)];
    const float pb = p[fluid_clamp(y - 1, h) * w + x];
    const float pt = p[fluid_clamp(y + 1, h) * w + x];
    const float a = u[row + x] - 0.5f * (pr - pl);
    const float b = v[row + x] - 0.5f * (pt - pb);
    u2[row + x] = a;
    v2[row + x] = b;
    mu = fabsf(a);
    mv = fabsf(b);
  }
  if (stats != nullptr) fluid_block_max2_atomic(mu, mv, stats);
}

// Zero stats on the stream, then launch project_kernel; stats may be null.
static inline cudaError_t fluid_launch_project(const float* p, const float* u,
                                               const float* v, float* u2,
                                               float* v2, float* stats, int h,
                                               int w, cudaStream_t s) {
  if (stats != nullptr) {
    const cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(float), s);
    if (e != cudaSuccess) return e;
  }
  project_kernel<<<fluid_grid2d(h, w), dim3(FLUID_BX, FLUID_BY), 0, s>>>(
      p, u, v, u2, v2, stats, h, w);
  return cudaGetLastError();
}
