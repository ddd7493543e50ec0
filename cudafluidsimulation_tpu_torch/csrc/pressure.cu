// H4: pressure projection — divergence, Jacobi sweeps from p = 0, gradient
// subtraction and the velocity bound.
//
// Replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py pressure_project ->
// _single_pressure_kernel, _first_pressure_kernel, _pressure_kernel,
// _last_pressure_kernel (and _first_/_last_pressure_kernel_tiled,
// _pressure_kernel_tiled), with _emit_vel_stats.
//   div = (uR - uL) + (vT - vB), times 0.5 when half   (GPUFluidSim.cu:297-310)
//   p   = (pL + pR + pB + pT - div) * 0.25, iters sweeps from p = 0
//   u' = u - 0.5*(pR - pL), v' = v - 0.5*(pT - pB)     (GPUFluidSim.cu:498-516)
// All taps clamp.  The divergence kernel also writes the first sweep's p
// ((0 - div) * 0.25, exactly the sweep from zero); iters - 1 sweep kernels
// ping-pong p with scratch so the last lands in p; the projection kernel
// emits [max|u'|, max|v'|] into stats.
//
// Bound by bytes: each sweep reads p and div and writes p.
#include "fluid_common.cuh"

__global__ void divergence_kernel(const float* __restrict__ u,
                                  const float* __restrict__ v,
                                  float* __restrict__ div,
                                  float* __restrict__ p, int h, int w,
                                  int half, int first_sweep) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int row = y * w;
  const float ul = u[row + fluid_clamp(x - 1, w)];
  const float ur = u[row + fluid_clamp(x + 1, w)];
  const float vb = v[fluid_clamp(y - 1, h) * w + x];
  const float vt = v[fluid_clamp(y + 1, h) * w + x];
  float d = (ur - ul) + (vt - vb);
  if (half) d = 0.5f * d;
  div[row + x] = d;
  p[row + x] = first_sweep ? (0.f - d) * 0.25f : 0.f;
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
  fluid_block_max2_atomic(mu, mv, stats);
}

// u, v in; u2, v2, p out; div, scratch: (h, w) work planes; stats: 2 floats.
FLUID_API int fluid_pressure_project(const float* u, const float* v,
                                     float* u2, float* v2, float* p,
                                     float* div, float* scratch,
                                     float* stats, int h, int w, int iters,
                                     int half, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || iters < 0) return cudaErrorInvalidValue;
  const dim3 block(FLUID_BX, FLUID_BY);
  const dim3 grid = fluid_grid2d(h, w);
  cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(float), s);
  if (e != cudaSuccess) return e;
  // launch j = 0 (divergence + first sweep) .. last = max(iters-1, 0);
  // launch j writes p when (last - j) is even, so the last lands in p
  const int last = iters > 0 ? iters - 1 : 0;
  float* cur = (last % 2 == 0) ? p : scratch;
  divergence_kernel<<<grid, block, 0, s>>>(u, v, div, cur, h, w, half,
                                           iters > 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  for (int j = 1; j <= last; ++j) {
    float* dst = ((last - j) % 2 == 0) ? p : scratch;
    jacobi_kernel<<<grid, block, 0, s>>>(cur, div, dst, h, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    cur = dst;
  }
  project_kernel<<<grid, block, 0, s>>>(p, u, v, u2, v2, stats, h, w);
  return cudaGetLastError();
}
