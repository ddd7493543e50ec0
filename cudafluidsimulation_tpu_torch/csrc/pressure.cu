// H4: pressure projection — divergence, Jacobi sweeps from p = 0, gradient
// subtraction and the velocity bound — and its standalone solve; H5: the
// standalone divergence and projection.
//
// H4 replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py pressure_project
// -> _single_pressure_kernel, _first_pressure_kernel, _pressure_kernel,
// _last_pressure_kernel (and _first_/_last_pressure_kernel_tiled,
// _pressure_kernel_tiled), with _emit_vel_stats; its pressure_solve entry
// replaces jacobi_pallas.py pressure_solve -> _pressure_kernel.
//   div = (uR - uL) + (vT - vB), times 0.5 when half   (GPUFluidSim.cu:297-310)
//   p   = (pL + pR + pB + pT - div) * 0.25, iters sweeps from p = 0
//   u' = u - 0.5*(pR - pL), v' = v - 0.5*(pT - pB)     (GPUFluidSim.cu:498-516)
// All taps clamp.  The first sweep from p = 0 is (0 - div) * 0.25, written
// by the divergence kernel in fluid_pressure_project and by
// jacobi_zero_kernel in fluid_pressure_solve; iters - 1 sweep kernels
// ping-pong p with scratch so the last lands in p; the projection kernel
// emits [max|u'|, max|v'|] into stats.
//
// H5 replaces jacobi_pallas.py divergence -> _divergence_kernel and
// project -> _project_kernel: one launch each (fluid_divergence,
// fluid_project).
//
// Bound by bytes: each sweep reads p and div and writes p.
#include "fluid_common.cuh"
#include "projection.cuh"

// div, and the first sweep's p when p is not null
__global__ void divergence_kernel(const float* __restrict__ u,
                                  const float* __restrict__ v,
                                  float* __restrict__ div,
                                  float* __restrict__ p, int h, int w,
                                  int half, int first_sweep) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float d = fluid_divergence_at(u, v, x, y, h, w, half);
  div[y * w + x] = d;
  if (p != nullptr) p[y * w + x] = first_sweep ? (0.f - d) * 0.25f : 0.f;
}

// the first sweep from p = 0: every neighbour tap is zero
__global__ void jacobi_zero_kernel(const float* __restrict__ div,
                                   float* __restrict__ dst, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  dst[y * w + x] = (0.f - div[y * w + x]) * 0.25f;
}

__global__ void jacobi_kernel(const float* __restrict__ src,
                              const float* __restrict__ div,
                              float* __restrict__ dst, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int row = y * w;
  const float l = src[row + fluid_clamp(x - 1, w)];
  const float r = src[row + fluid_clamp(x + 1, w)];
  const float b = src[fluid_clamp(y - 1, h) * w + x];
  const float t = src[fluid_clamp(y + 1, h) * w + x];
  dst[row + x] = (l + r + b + t - div[row + x]) * 0.25f;
}

// Sweeps 1..last (0-based launch j) from cur, the iterate after launch 0;
// launch j writes p when (last - j) is even, so the last lands in p.
static cudaError_t jacobi_sweeps(const float* cur, const float* div, float* p,
                                 float* scratch, int h, int w, int last,
                                 cudaStream_t s) {
  for (int j = 1; j <= last; ++j) {
    float* dst = ((last - j) % 2 == 0) ? p : scratch;
    jacobi_kernel<<<fluid_grid2d(h, w), dim3(FLUID_BX, FLUID_BY), 0, s>>>(
        cur, div, dst, h, w);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    cur = dst;
  }
  return cudaSuccess;
}

// u, v in; u2, v2, p out; div, scratch: (h, w) work planes; stats: 2 floats.
FLUID_API int fluid_pressure_project(const float* u, const float* v,
                                     float* u2, float* v2, float* p,
                                     float* div, float* scratch,
                                     float* stats, int h, int w, int iters,
                                     int half, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || iters < 0) return cudaErrorInvalidValue;
  // launch 0 is the divergence (+ first sweep); last = max(iters-1, 0)
  const int last = iters > 0 ? iters - 1 : 0;
  float* cur = (last % 2 == 0) ? p : scratch;
  divergence_kernel<<<fluid_grid2d(h, w), dim3(FLUID_BX, FLUID_BY), 0, s>>>(
      u, v, div, cur, h, w, half, iters > 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = jacobi_sweeps(cur, div, p, scratch, h, w, last, s);
  if (e != cudaSuccess) return e;
  return fluid_launch_project(p, u, v, u2, v2, stats, h, w, s);
}

// div in; p out (zeros when iters == 0); scratch: (h, w), used when iters >= 2.
FLUID_API int fluid_pressure_solve(const float* div, float* p, float* scratch,
                                   int h, int w, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || iters < 0) return cudaErrorInvalidValue;
  if (iters == 0) return cudaMemsetAsync(p, 0, sizeof(float) * h * w, s);
  const int last = iters - 1;
  float* cur = (last % 2 == 0) ? p : scratch;
  jacobi_zero_kernel<<<fluid_grid2d(h, w), dim3(FLUID_BX, FLUID_BY), 0, s>>>(
      div, cur, h, w);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return jacobi_sweeps(cur, div, p, scratch, h, w, last, s);
}

FLUID_API int fluid_divergence(const float* u, const float* v, float* div,
                               int h, int w, int half, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1) return cudaErrorInvalidValue;
  divergence_kernel<<<fluid_grid2d(h, w), dim3(FLUID_BX, FLUID_BY), 0, s>>>(
      u, v, div, nullptr, h, w, half, 0);
  return cudaGetLastError();
}

// stats may be null (no velocity bound)
FLUID_API int fluid_project(const float* p, const float* u, const float* v,
                            float* u2, float* v2, float* stats, int h, int w,
                            void* stream) {
  if (h < 1 || w < 1) return cudaErrorInvalidValue;
  return fluid_launch_project(p, u, v, u2, v2, stats, h, w,
                              static_cast<cudaStream_t>(stream));
}
