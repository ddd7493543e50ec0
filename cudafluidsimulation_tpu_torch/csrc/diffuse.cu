// H3: Jacobi diffusion sweeps, optional splat tail on the last one.
//
// Replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py _diffuse_bursts ->
// _diffuse_kernel and _diffuse_kernel_tiled (entries diffuse, diffuse_multi,
// diffuse_multi_splat).  A sweep is x' = (L + R + B + T + alpha*x) / beta
// with clamped taps and alpha, 1/beta per channel; the centre term is the
// current iterate, so sweeps ping-pong between two buffers (an in-place
// update would be a different operator).  The gpu-variant splat
// f[c] += amp[c] * exp(-d2(last)/radius) rides the last sweep.
//
// Bound by bytes: each sweep reads and writes every channel plane.  This
// first design launches one kernel per sweep over all channels (grid z =
// channel); temporal blocking in shared memory is later work.
#include "fluid_common.cuh"

#define FLUID_MAX_CHANNELS 8

struct DiffuseParams {
  float alpha[FLUID_MAX_CHANNELS];
  float inv_beta[FLUID_MAX_CHANNELS];
  float amp[FLUID_MAX_CHANNELS];
  float lx, ly, radius;
};

// sweep: apply one Jacobi sweep (else copy); splat: add the Gaussian tail.
__global__ void diffuse_kernel(const float* __restrict__ src,
                               float* __restrict__ dst, int h, int w,
                               DiffuseParams p, int sweep, int splat) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int ch = blockIdx.z;
  if (x >= w || y >= h) return;
  const size_t plane = static_cast<size_t>(ch) * h * w;
  const float* f = src + plane;
  const int row = y * w;
  const float c = f[row + x];
  float val = c;
  if (sweep) {
    const float l = f[row + fluid_clamp(x - 1, w)];
    const float r = f[row + fluid_clamp(x + 1, w)];
    const float b = f[fluid_clamp(y - 1, h) * w + x];
    const float t = f[fluid_clamp(y + 1, h) * w + x];
    val = (l + r + b + t + c * p.alpha[ch]) * p.inv_beta[ch];
  }
  if (splat) {
    const float dx = static_cast<float>(x) - p.lx;
    const float dy = static_cast<float>(y) - p.ly;
    const float d2 = dx * dx + dy * dy;
    val = val + p.amp[ch] * expf(-d2 / p.radius);
  }
  dst[plane + row + x] = val;
}

// in, out, scratch: (c, h, w) planes; scratch is needed when iters >= 2.
// alpha, inv_beta: c host floats; amp: c host floats or null (no splat).
FLUID_API int fluid_diffuse(const float* in, float* out, float* scratch,
                            int c, int h, int w, int iters,
                            const float* alpha, const float* inv_beta,
                            const float* amp, float lx, float ly,
                            float radius, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > FLUID_MAX_CHANNELS || h < 1 || w < 1 || iters < 0)
    return cudaErrorInvalidValue;
  if (iters >= 2 && scratch == nullptr) return cudaErrorInvalidValue;
  if (iters == 0 && amp == nullptr) return cudaErrorInvalidValue;
  DiffuseParams p = {};
  for (int i = 0; i < c; ++i) {
    p.alpha[i] = alpha[i];
    p.inv_beta[i] = inv_beta[i];
    p.amp[i] = amp != nullptr ? amp[i] : 0.f;
  }
  p.lx = lx;
  p.ly = ly;
  p.radius = radius;
  const int splat = amp != nullptr;
  const dim3 block(FLUID_BX, FLUID_BY);
  const dim3 grid = fluid_grid2d(h, w, c);
  if (iters == 0) {
    diffuse_kernel<<<grid, block, 0, s>>>(in, out, h, w, p, 0, 1);
    return cudaGetLastError();
  }
  // sweep k writes out when (iters-1-k) is even, so the last lands in out
  const float* src = in;
  for (int k = 0; k < iters; ++k) {
    float* dst = ((iters - 1 - k) % 2 == 0) ? out : scratch;
    diffuse_kernel<<<grid, block, 0, s>>>(src, dst, h, w, p, 1,
                                          splat && k == iters - 1);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = dst;
  }
  return cudaSuccess;
}
