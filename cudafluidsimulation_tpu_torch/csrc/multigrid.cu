// H6: the multigrid smoother ends — damped-Jacobi sweeps, the residual,
// and the divergence and projection folded into the fine level's ends.
//
// Replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py
//   smooth_damped       -> _smooth_kernel, _smooth_kernel_tiled
//   smooth_res          -> _smooth_res_kernel, _smooth_res_kernel_tiled
//                          (_damped_sweeps, _residual_rows)
//   first_smooth_res    -> _first_smooth_res_kernel (_divergence_ext)
//   last_smooth_project -> _last_smooth_project_kernel (_project_rows,
//                          _emit_vel_stats)
//   sweep      p' = p + omega * ((l + r + b + t + rhs) * 0.25 - p)
//   from zero  p' = omega * (rhs * 0.25)   (the neighbour taps are zero)
//   residual   res = rhs - (4 p - (l + r + b + t))
// term for term as the JAX expressions, all taps clamped.  The centre term
// is the current iterate, so a sweep never updates in place: the sweeps
// ping-pong the output and a scratch plane, the first chosen so the last
// lands in the output.  One launch per sweep; the residual and the
// projection are one launch each, reading the final p.
//
// Bound by bytes: at a 2048² level each sweep reads p and rhs and writes p
// (48 MiB), and so does the residual (p, rhs -> res).  The coarse levels
// fit in L2; the 16² bottom is bound by launch latency.
#include "fluid_common.cuh"
#include "projection.cuh"

__global__ void smooth_kernel(const float* __restrict__ src,
                              const float* __restrict__ rhs,
                              float* __restrict__ dst, int h, int w,
                              float omega) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int row = y * w;
  const float c = src[row + x];
  const float l = src[row + fluid_clamp(x - 1, w)];
  const float r = src[row + fluid_clamp(x + 1, w)];
  const float b = src[fluid_clamp(y - 1, h) * w + x];
  const float t = src[fluid_clamp(y + 1, h) * w + x];
  dst[row + x] = c + omega * ((l + r + b + t + rhs[row + x]) * 0.25f - c);
}

__global__ void smooth_zero_kernel(const float* __restrict__ rhs,
                                   float* __restrict__ dst, int h, int w,
                                   float omega) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  dst[y * w + x] = omega * (rhs[y * w + x] * 0.25f);
}

// rhs = -div(u, v) and the first sweep from zero
__global__ void first_sweep_kernel(const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   float* __restrict__ rhs,
                                   float* __restrict__ dst, int h, int w,
                                   int half, float omega) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float r = -fluid_divergence_at(u, v, x, y, h, w, half);
  rhs[y * w + x] = r;
  dst[y * w + x] = omega * (r * 0.25f);
}

__global__ void residual_kernel(const float* __restrict__ p,
                                const float* __restrict__ rhs,
                                float* __restrict__ res, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int row = y * w;
  const float l = p[row + fluid_clamp(x - 1, w)];
  const float r = p[row + fluid_clamp(x + 1, w)];
  const float b = p[fluid_clamp(y - 1, h) * w + x];
  const float t = p[fluid_clamp(y + 1, h) * w + x];
  res[row + x] = rhs[row + x] - (4.f * p[row + x] - (l + r + b + t));
}

// The plane sweep j of `sweeps` (1-based) writes: out when (sweeps - j) is
// even, so the last sweep lands in out.
static inline float* sweep_dst(int j, int sweeps, float* out, float* scratch) {
  return ((sweeps - j) % 2 == 0) ? out : scratch;
}

// Sweeps from..sweeps from cur, the iterate after sweep from - 1.
static cudaError_t damped_sweeps(const float* cur, const float* rhs,
                                 float* out, float* scratch, int h, int w,
                                 int from, int sweeps, float omega,
                                 cudaStream_t s) {
  for (int j = from; j <= sweeps; ++j) {
    float* dst = sweep_dst(j, sweeps, out, scratch);
    smooth_kernel<<<fluid_grid2d(h, w), dim3(FLUID_BX, FLUID_BY), 0, s>>>(
        cur, rhs, dst, h, w, omega);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    cur = dst;
  }
  return cudaSuccess;
}

static cudaError_t launch_residual(const float* p, const float* rhs,
                                   float* res, int h, int w, cudaStream_t s) {
  residual_kernel<<<fluid_grid2d(h, w), dim3(FLUID_BX, FLUID_BY), 0, s>>>(
      p, rhs, res, h, w);
  return cudaGetLastError();
}

// p, rhs in; out: p after `sweeps` >= 1 sweeps; scratch used when sweeps >= 2.
FLUID_API int fluid_smooth_damped(const float* p, const float* rhs, float* out,
                                  float* scratch, int h, int w, int sweeps,
                                  float omega, void* stream) {
  if (h < 1 || w < 1 || sweeps < 1) return cudaErrorInvalidValue;
  return damped_sweeps(p, rhs, out, scratch, h, w, 1, sweeps, omega,
                       static_cast<cudaStream_t>(stream));
}

// (p, rhs) -> (out, res); with from_zero the sweeps start from p = 0 and p
// is not read (it may be null).
FLUID_API int fluid_smooth_res(const float* p, const float* rhs, float* out,
                               float* res, float* scratch, int h, int w,
                               int sweeps, float omega, int from_zero,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || sweeps < 1) return cudaErrorInvalidValue;
  int from = 1;
  if (from_zero) {
    float* dst = sweep_dst(1, sweeps, out, scratch);
    smooth_zero_kernel<<<fluid_grid2d(h, w), dim3(FLUID_BX, FLUID_BY), 0, s>>>(
        rhs, dst, h, w, omega);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    p = dst;
    from = 2;
  }
  const cudaError_t e = damped_sweeps(p, rhs, out, scratch, h, w, from, sweeps,
                                      omega, s);
  if (e != cudaSuccess) return e;
  return launch_residual(out, rhs, res, h, w, s);
}

// (u, v) -> (p, rhs, res) with rhs = -div(u, v) and `sweeps` sweeps from 0.
FLUID_API int fluid_first_smooth_res(const float* u, const float* v, float* p,
                                     float* rhs, float* res, float* scratch,
                                     int h, int w, int sweeps, int half,
                                     float omega, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || sweeps < 1) return cudaErrorInvalidValue;
  float* dst = sweep_dst(1, sweeps, p, scratch);
  first_sweep_kernel<<<fluid_grid2d(h, w), dim3(FLUID_BX, FLUID_BY), 0, s>>>(
      u, v, rhs, dst, h, w, half, omega);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = damped_sweeps(dst, rhs, p, scratch, h, w, 2, sweeps, omega, s);
  if (e != cudaSuccess) return e;
  return launch_residual(p, rhs, res, h, w, s);
}

// (p, rhs, u, v) -> (u2, v2, p2[, stats]); stats may be null.
FLUID_API int fluid_last_smooth_project(const float* p, const float* rhs,
                                        const float* u, const float* v,
                                        float* u2, float* v2, float* p2,
                                        float* scratch, float* stats, int h,
                                        int w, int sweeps, float omega,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || sweeps < 1) return cudaErrorInvalidValue;
  const cudaError_t e = damped_sweeps(p, rhs, p2, scratch, h, w, 1, sweeps,
                                      omega, s);
  if (e != cudaSuccess) return e;
  return fluid_launch_project(p2, u, v, u2, v2, stats, h, w, s);
}
