// H3: Jacobi diffusion sweeps, temporally blocked, with the optional splat
// tail on the last one.
//
// Replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py _diffuse_bursts ->
// _diffuse_kernel and _diffuse_burst_tiled -> _diffuse_kernel_tiled
// (entries diffuse, diffuse_multi, diffuse_multi_splat).  A sweep is
//   x' = (L + R + B + T + alpha*x) * (1/beta)
// with clamped taps and alpha, 1/beta per channel; the centre term is the
// current iterate, so sweeps ping-pong between two buffers (an in-place
// update would be a different operator).  The gpu-variant splat
// f[c] += amp[c] * exp(-d2(last)/radius) rides the last sweep.
//
// What bounds it on an H100: a sweep is 6 flops and 8 bytes of device
// traffic a cell, so a launch per sweep (the first design, 2.45 ms for 5
// channels x 20 sweeps at 2048²) is bound by device memory and its
// launches.  Here a launch is a burst of `depth` sweeps (burst.cuh): each
// block loads its channel's tile + depth-ring into shared memory once,
// sweeps there, and writes the tile once, so 20 sweeps cost 3 round trips
// to device memory.  A burst is then bound by the SMs' instruction issue
// and shared-memory traffic (4 columns a thread, 16-byte accesses) and by
// the halo's redundant cells, which the planner in ops/jacobi_cuda.py
// weighs against the number of round trips.  Measured 0.57 ms for 5
// channels x 20 sweeps with the splat at 2048² (3 launches) on an NVIDIA
// H100 80GB HBM3 at 700 W.  Arithmetic order is the plain version's, built
// without FMA contraction: bit-identical without the splat.
#include "burst.cuh"

#define FLUID_MAX_CHANNELS 8

struct DiffuseParams {
  float alpha[FLUID_MAX_CHANNELS];
  float inv_beta[FLUID_MAX_CHANNELS];
  float amp[FLUID_MAX_CHANNELS];
  float lx, ly, radius;
};

__device__ __forceinline__ float splat_tail(float val, int gx, int gy,
                                            const DiffuseParams& p, int ch) {
  const float dx = static_cast<float>(gx) - p.lx;
  const float dy = static_cast<float>(gy) - p.ly;
  const float d2 = dx * dx + dy * dy;
  return val + p.amp[ch] * expf(-d2 / p.radius);
}

// One burst of `depth` sweeps (halo = depth) over channel blockIdx.z; the
// last sweep goes to device memory, with the splat when `splat`.  depth 0
// is the splat alone.
__global__ void __launch_bounds__(BURST_THREADS, 4)
diffuse_burst_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     int h, int w, int tile_h, int tile_w, int depth,
                     DiffuseParams p, int splat) {
  extern __shared__ float4 smem4[];
  const int ch = blockIdx.z;
  const size_t plane = static_cast<size_t>(ch) * h * w;
  const float* f = src + plane;
  float* out = dst + plane;
  const BurstTile t = burst_tile(h, w, tile_h, tile_w, depth);
  if (depth == 0) {
    for (int y = t.ty0 + threadIdx.y; y < t.ty1; y += BURST_NY)
      for (int x = t.tx0 + threadIdx.x; x < t.tx1; x += 32)
        out[y * w + x] = splat_tail(f[y * w + x], x, y, p, ch);
    return;
  }
  float* a = reinterpret_cast<float*>(smem4);
  float* b = a + burst_rows(h, tile_h, depth) * t.stride;
  burst_fill(a, f, w, t);
  __syncthreads();
  const float alpha = p.alpha[ch], inv_beta = p.inv_beta[ch];
  auto op = [alpha, inv_beta](float l, float r, float bo, float to, float c,
                              float) { return (l + r + bo + to + c * alpha) * inv_beta; };
  const int st = t.stride;
  for (int s = 1; s < depth; ++s) {
    float* dst = b;
    burst_visit(a, h, w, t, depth - s,
                [&](int r, int c, bool on, float4 l, float4 rt, float4 bo, float4 to, float4 ce) {
                  if (on) burst_st4(dst + r * st + c, burst_map4(op, l, rt, bo, to, ce, ce));
                });
    __syncthreads();
    b = a;
    a = dst;
  }
  // the last sweep: the tile, to device memory, with the splat
  burst_visit(a, h, w, t, 0,
              [&](int r, int c, bool on, float4 l, float4 rt, float4 bo, float4 to, float4 ce) {
                if (!on) return;
                const int gx = t.ox + c, gy = t.y0 + r;
                float4 v = burst_map4(op, l, rt, bo, to, ce, ce);
                if (splat) {
                  v.x = splat_tail(v.x, gx, gy, p, ch);
                  v.y = splat_tail(v.y, gx + 1, gy, p, ch);
                  v.z = splat_tail(v.z, gx + 2, gy, p, ch);
                  v.w = splat_tail(v.w, gx + 3, gy, p, ch);
                }
                burst_store_tile(out, w, t, gy, gx, v);
              });
}

// in, out, scratch: (c, h, w) planes; scratch is needed when nbursts >= 2.
// tile_h x tile_w: a block's output tile; depths: nbursts host ints, the
// sweeps of each burst (ops/jacobi_cuda.py plan_bursts); a depth of 0 (one
// burst only) is the splat alone.  alpha, inv_beta: c host floats; amp: c
// host floats or null (no splat), added on the last burst.
FLUID_API int fluid_diffuse(const float* in, float* out, float* scratch,
                            int c, int h, int w, int tile_h, int tile_w,
                            const int* depths, int nbursts,
                            const float* alpha, const float* inv_beta,
                            const float* amp, float lx, float ly,
                            float radius, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > FLUID_MAX_CHANNELS || h < 1 || w < 1 || tile_h < 1 ||
      tile_w < 1 || nbursts < 1 || depths == nullptr)
    return cudaErrorInvalidValue;
  if (nbursts >= 2 && scratch == nullptr) return cudaErrorInvalidValue;
  size_t smem = 0;
  for (int j = 0; j < nbursts; ++j) {
    if (depths[j] < 0 || (depths[j] == 0 && (nbursts > 1 || amp == nullptr)))
      return cudaErrorInvalidValue;
    const size_t b = burst_smem_bytes(2, h, w, tile_h, tile_w, depths[j]);
    if (depths[j] > 0 && b > smem) smem = b;
  }
  cudaError_t e = burst_allow_smem(diffuse_burst_kernel, smem);
  if (e != cudaSuccess) return e;
  DiffuseParams p = {};
  for (int i = 0; i < c; ++i) {
    p.alpha[i] = alpha[i];
    p.inv_beta[i] = inv_beta[i];
    p.amp[i] = amp != nullptr ? amp[i] : 0.f;
  }
  p.lx = lx;
  p.ly = ly;
  p.radius = radius;
  // burst j writes out when (nbursts-1-j) is even, so the last lands in out
  const float* src = in;
  for (int j = 0; j < nbursts; ++j) {
    float* dst = ((nbursts - 1 - j) % 2 == 0) ? out : scratch;
    const size_t bytes =
        depths[j] > 0 ? burst_smem_bytes(2, h, w, tile_h, tile_w, depths[j]) : 0;
    diffuse_burst_kernel<<<burst_grid(h, w, tile_h, tile_w, c),
                           dim3(32, BURST_NY), bytes, s>>>(
        src, dst, h, w, tile_h, tile_w, depths[j], p,
        amp != nullptr && j == nbursts - 1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = dst;
  }
  return cudaSuccess;
}
