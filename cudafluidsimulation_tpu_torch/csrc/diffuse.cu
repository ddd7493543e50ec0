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
//
// Planes: a launch sweeps n planes, plane z = blockIdx.z (and every
// gridDim.z after it), with no cap on n.  A batch of B members of C
// channels (ensembles) is n = B*C planes, and each plane takes alpha,
// 1/beta and amp of its own and the splat centre of its member from row
// z / C of a device array, so a sweep over viscosities is one launch a
// burst.  A single call of at most 8 planes takes them by value instead.
#include "burst.cuh"

#define FLUID_MAX_CHANNELS 8

// The by-value parameters of a call of at most FLUID_MAX_CHANNELS planes.
struct DiffuseParams {
  float alpha[FLUID_MAX_CHANNELS];
  float inv_beta[FLUID_MAX_CHANNELS];
  float amp[FLUID_MAX_CHANNELS];
  float lx, ly, radius;
};

// Per-plane parameters in device memory: row b (prm_stride floats apart)
// holds member b's [alpha[0..C), inv_beta[0..C), amp[0..C), lx, ly].
struct DiffuseRows {
  const float* prm;
  int prm_stride, chans;
};

struct PlaneParams {
  float alpha, inv_beta, amp, lx, ly;
};

__device__ __forceinline__ PlaneParams plane_params(const DiffuseParams& p,
                                                    const DiffuseRows& r, int z) {
  if (r.prm == nullptr) return {p.alpha[z], p.inv_beta[z], p.amp[z], p.lx, p.ly};
  const int b = z / r.chans, ch = z - b * r.chans;
  const float* row = r.prm + static_cast<size_t>(b) * r.prm_stride;
  return {row[ch], row[r.chans + ch], row[2 * r.chans + ch], row[3 * r.chans],
          row[3 * r.chans + 1]};
}

__device__ __forceinline__ float splat_tail(float val, int gx, int gy,
                                            const PlaneParams& q, float radius) {
  const float dx = static_cast<float>(gx) - q.lx;
  const float dy = static_cast<float>(gy) - q.ly;
  const float d2 = dx * dx + dy * dy;
  return val + q.amp * expf(-d2 / radius);
}

// One plane of one burst of `depth` sweeps (halo = depth); the last sweep
// goes to device memory, with the splat when `splat`.  depth 0 is the
// splat alone.
__device__ __forceinline__ void diffuse_plane(float* smem, const float* __restrict__ f,
                                              float* __restrict__ out, int h, int w,
                                              int tile_h, int tile_w, int depth,
                                              const PlaneParams& q, float radius,
                                              int splat) {
  const BurstTile t = burst_tile(h, w, tile_h, tile_w, depth);
  if (depth == 0) {
    for (int y = t.ty0 + threadIdx.y; y < t.ty1; y += BURST_NY)
      for (int x = t.tx0 + threadIdx.x; x < t.tx1; x += 32)
        out[y * w + x] = splat_tail(f[y * w + x], x, y, q, radius);
    return;
  }
  float* a = smem;
  float* b = a + burst_rows(h, tile_h, depth) * t.stride;
  burst_fill(a, f, w, t);
  __syncthreads();
  const float alpha = q.alpha, inv_beta = q.inv_beta;
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
                  v.x = splat_tail(v.x, gx, gy, q, radius);
                  v.y = splat_tail(v.y, gx + 1, gy, q, radius);
                  v.z = splat_tail(v.z, gx + 2, gy, q, radius);
                  v.w = splat_tail(v.w, gx + 3, gy, q, radius);
                }
                burst_store_tile(out, w, t, gy, gx, v);
              });
}

// One burst over planes blockIdx.z, blockIdx.z + gridDim.z, ... < n.
__global__ void __launch_bounds__(BURST_THREADS, 4)
diffuse_burst_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     int n, int h, int w, int tile_h, int tile_w, int depth,
                     DiffuseParams p, DiffuseRows rows, int splat) {
  extern __shared__ float4 smem4[];
  const size_t hw = static_cast<size_t>(h) * w;
  // one plane at a time, the body's shape opaque (fluid_opaque)
#pragma unroll 1
  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    diffuse_plane(reinterpret_cast<float*>(smem4), src + z * hw, dst + z * hw,
                  fluid_opaque(h), fluid_opaque(w), fluid_opaque(tile_h),
                  fluid_opaque(tile_w), fluid_opaque(depth), plane_params(p, rows, z),
                  p.radius, splat);
    __syncthreads();  // the shared buffers, before the next plane's fill
  }
}

// in, out, scratch: n (h, w) planes; scratch is needed when nbursts >= 2.
// tile_h x tile_w: a block's output tile; depths: nbursts host ints, the
// sweeps of each burst (ops/jacobi_cuda.py plan_bursts); a depth of 0 (one
// burst only) is the splat alone, added on the last burst when splat != 0.
// Parameters: with prm null, n <= 8 and alpha, inv_beta (and amp with the
// splat) are n host floats, lx, ly the splat centre; with prm, plane z's
// come from row z / chans of the device array prm (DiffuseRows), and the
// host arrays are not read.  radius: the splat's, by value.
FLUID_API int fluid_diffuse(const float* in, float* out, float* scratch,
                            int n, int h, int w, int tile_h, int tile_w,
                            const int* depths, int nbursts,
                            const float* alpha, const float* inv_beta,
                            const float* amp, float lx, float ly,
                            float radius, int splat, const float* prm,
                            int prm_stride, int chans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || h < 1 || w < 1 || tile_h < 1 || tile_w < 1 || nbursts < 1 ||
      depths == nullptr)
    return cudaErrorInvalidValue;
  if (prm == nullptr ? (n > FLUID_MAX_CHANNELS || alpha == nullptr || inv_beta == nullptr ||
                        (splat && amp == nullptr))
                     : (chans < 1 || n % chans != 0 || prm_stride < 3 * chans + 2))
    return cudaErrorInvalidValue;
  if (nbursts >= 2 && scratch == nullptr) return cudaErrorInvalidValue;
  size_t smem = 0;
  for (int j = 0; j < nbursts; ++j) {
    if (depths[j] < 0 || (depths[j] == 0 && (nbursts > 1 || !splat)))
      return cudaErrorInvalidValue;
    const size_t b = burst_smem_bytes(2, h, w, tile_h, tile_w, depths[j]);
    if (depths[j] > 0 && b > smem) smem = b;
  }
  cudaError_t e = burst_allow_smem(diffuse_burst_kernel, smem);
  if (e != cudaSuccess) return e;
  DiffuseParams p = {};
  if (prm == nullptr) {
    for (int i = 0; i < n; ++i) {
      p.alpha[i] = alpha[i];
      p.inv_beta[i] = inv_beta[i];
      p.amp[i] = splat ? amp[i] : 0.f;
    }
    p.lx = lx;
    p.ly = ly;
  }
  p.radius = radius;
  const DiffuseRows rows = {prm, prm_stride, chans};
  // burst j writes out when (nbursts-1-j) is even, so the last lands in out
  const float* src = in;
  for (int j = 0; j < nbursts; ++j) {
    float* dst = ((nbursts - 1 - j) % 2 == 0) ? out : scratch;
    const size_t bytes =
        depths[j] > 0 ? burst_smem_bytes(2, h, w, tile_h, tile_w, depths[j]) : 0;
    diffuse_burst_kernel<<<burst_grid(h, w, tile_h, tile_w, fluid_grid_z(n)),
                           dim3(32, BURST_NY), bytes, s>>>(
        src, dst, n, h, w, tile_h, tile_w, depths[j], p, rows,
        splat && j == nbursts - 1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = dst;
  }
  return cudaSuccess;
}
