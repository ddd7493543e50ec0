// H2: vorticity confinement, curl and force in one pass.
//
// Replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py
// vorticity_confinement -> _vorticity_kernel (_curl_taps, _confinement).
// The curl is 0.5*(vR - vL - uT + uB) with clamped taps.  Each block
// computes the curl of its 32x8 tile and a one-cell ring into shared
// memory; a ring cell outside the domain holds the curl of the clamped cell
// (ops/ref.py clamps the curl field itself), then each thread applies the
// confinement force to its cell.  The curl never goes to device memory.
//
// gpu variant (GPUFluidSim.cu:536-573): f = 0.5*(|wT|-|wB|, |wL|-|wR|),
//   normalised by (len + 1e-3), scaled by w*vorticity, not negated.
// cpu variant (cpuFluidSim.cpp:271-296): f = 0.5*(|wT|-|wB|, |wR|-|wL|),
//   normalised by (len + 1e-4), scaled by w*vorticity, negated.
//
// Bound by bytes: u, v in, u', v' out; the ring's extra curl work reads
// through L1.
#include "fluid_common.cuh"

#define TW (FLUID_BX + 2)
#define TH (FLUID_BY + 2)

__device__ __forceinline__ float curl_at(const float* __restrict__ u,
                                         const float* __restrict__ v, int y,
                                         int x, int h, int w) {
  const int row = y * w;
  const float vl = __ldg(v + row + fluid_clamp(x - 1, w));
  const float vr = __ldg(v + row + fluid_clamp(x + 1, w));
  const float ub = __ldg(u + fluid_clamp(y - 1, h) * w + x);
  const float ut = __ldg(u + fluid_clamp(y + 1, h) * w + x);
  return 0.5f * (vr - vl - ut + ub);
}

template <bool CPU>
__global__ void vorticity_kernel(const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 float* __restrict__ u2,
                                 float* __restrict__ v2, int h, int w,
                                 float dt, float vorticity) {
  __shared__ float tile[TH][TW];
  const int x0 = blockIdx.x * FLUID_BX;
  const int y0 = blockIdx.y * FLUID_BY;
  const int tid = threadIdx.y * FLUID_BX + threadIdx.x;
  for (int k = tid; k < TH * TW; k += FLUID_BX * FLUID_BY) {
    const int gy = fluid_clamp(y0 - 1 + k / TW, h);
    const int gx = fluid_clamp(x0 - 1 + k % TW, w);
    tile[k / TW][k % TW] = curl_at(u, v, gy, gx, h, w);
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const int ty = threadIdx.y + 1, tx = threadIdx.x + 1;
  const float wc = tile[ty][tx];
  const float wl = fabsf(tile[ty][tx - 1]);
  const float wr = fabsf(tile[ty][tx + 1]);
  const float wb = fabsf(tile[ty - 1][tx]);
  const float wt = fabsf(tile[ty + 1][tx]);
  float fx = 0.5f * (wt - wb);
  float fy = CPU ? 0.5f * (wr - wl) : 0.5f * (wl - wr);
  const float ln = sqrtf(fx * fx + fy * fy) + (CPU ? 1e-4f : 1e-3f);
  const float s = wc * vorticity / ln;
  if (CPU) {
    fx = -fx * s;
    fy = -fy * s;
  } else {
    fx = fx * s;
    fy = fy * s;
  }
  const int i = y * w + x;
  u2[i] = u[i] + fx * dt;
  v2[i] = v[i] + fy * dt;
}

FLUID_API int fluid_vorticity(const float* u, const float* v, float* u2,
                              float* v2, int h, int w, int cpu_variant,
                              float dt, float vorticity, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1) return cudaErrorInvalidValue;
  const dim3 block(FLUID_BX, FLUID_BY);
  const dim3 grid = fluid_grid2d(h, w);
  if (cpu_variant) {
    vorticity_kernel<true><<<grid, block, 0, s>>>(u, v, u2, v2, h, w, dt,
                                                  vorticity);
  } else {
    vorticity_kernel<false><<<grid, block, 0, s>>>(u, v, u2, v2, h, w, dt,
                                                   vorticity);
  }
  return cudaGetLastError();
}
