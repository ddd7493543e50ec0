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
// (stats must hold 0 before the launch).  BATCH: nb members, member b =
// blockIdx.z (and every gridDim.z after it) with u and v at b * u_ms,
// b * v_ms floats, p, u2, v2 at b * h * w and its stats at 2b; a single call
// (BATCH false) is member 0 without the loop.
template <bool BATCH>
__global__ void project_kernel(const float* __restrict__ p,
                               const float* __restrict__ u,
                               const float* __restrict__ v,
                               float* __restrict__ u2,
                               float* __restrict__ v2,
                               float* __restrict__ stats, int h, int w, int nb,
                               long long u_ms, long long v_ms) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = static_cast<size_t>(h) * w;
  const int n = BATCH ? nb : 1;
#pragma unroll 1
  for (int b = BATCH ? blockIdx.z : 0; b < n; b += BATCH ? gridDim.z : 1) {
    const float* pb_ = p + b * hw;
    float mu = 0.f, mv = 0.f;
    if (x < w && y < h) {
      const int row = y * w;
      const float pl = pb_[row + fluid_clamp(x - 1, w)];
      const float pr = pb_[row + fluid_clamp(x + 1, w)];
      const float pb = pb_[fluid_clamp(y - 1, h) * w + x];
      const float pt = pb_[fluid_clamp(y + 1, h) * w + x];
      const float a = u[b * u_ms + row + x] - 0.5f * (pr - pl);
      const float c = v[b * v_ms + row + x] - 0.5f * (pt - pb);
      u2[b * hw + row + x] = a;
      v2[b * hw + row + x] = c;
      mu = fabsf(a);
      mv = fabsf(c);
    }
    if (stats != nullptr) {
      fluid_block_max2_atomic(mu, mv, stats + 2 * b);
      if (BATCH) __syncthreads();  // the block max's slots, before the next member
    }
  }
}

// Zero stats (2 floats a member) on the stream, then launch project_kernel;
// stats may be null.  nb members at the strides project_kernel takes.
static inline cudaError_t fluid_launch_project(const float* p, const float* u,
                                               const float* v, float* u2,
                                               float* v2, float* stats, int h,
                                               int w, int nb, long long u_ms,
                                               long long v_ms, cudaStream_t s) {
  if (stats != nullptr) {
    const cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(float) * nb, s);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid = fluid_grid2d(h, w, fluid_grid_z(nb)), block(FLUID_BX, FLUID_BY);
  if (nb > 1)
    project_kernel<true><<<grid, block, 0, s>>>(p, u, v, u2, v2, stats, h, w, nb, u_ms, v_ms);
  else
    project_kernel<false><<<grid, block, 0, s>>>(p, u, v, u2, v2, stats, h, w, 1, 0, 0);
  return cudaGetLastError();
}
