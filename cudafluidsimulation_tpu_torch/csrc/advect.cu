// H1 and H8: semi-Lagrangian advection, one thread per cell.
//
// H1 replaces cudafluidsimulation_tpu/ops/advect_pallas.py _advect_kernel
// and _advect_kernel_tiled (cores _advect_core, _advect_core_static, and
// _emit_stats).  The TPU kernel rewrites the gather as a shift-accumulation
// over a bounded displacement window because the TPU has no fast gather;
// here each thread backtraces its cell, truncates the corner toward zero
// (so negative coordinates extrapolate), clamps four taps to the domain and
// blends them, as ops/ref.py bilerp does.  The backtrace is unbounded.
//
// H8 (fluid_advect_packed) replaces the bf16-tap cores
// _advect_core_packed (dye) and _advect_core_packed_vel (velocity) and the
// dispatch around them (_fast_path_ok, the lax.cond in _advect_flat and
// _advect_tiled).  The TPU kernels pack the tap planes into bf16 to halve
// the volume of their rolls; the card gathers, so H8 keeps H1's gather and
// rounds each tap value as it is loaded, as bits(x) + 0x8000 masked to the
// top 16 bits (round half up in magnitude, not to nearest even).  Velocity
// rounds u and v; dye rounds channels 0 and 1, keeps channel 2 in f32, and
// clamps the blend to >= 0 before the pow (acc < 0 ? 0 : acc, which lets a
// NaN through to fminf's saturation, as jnp.maximum does).  A step whose
// bound [max|u|, max|v|] times dt is under one cell on both axes takes the
// exact branch, which is H1's arithmetic bit for bit; the bound is read on
// the device, so the branch costs no host read.
//
// Bound by bytes: u, v and C field planes in, C planes out; the taps sit
// near the cell and hit L1/L2.  The velocity mode also emits
// [max|u'|, max|v'|] into stats[0..1] (zeroed here on the stream first).
//
// H1 and H8 also take a batch of independent members (ensembles, the
// analog of the JAX package's vmap): member b = blockIdx.z (and every
// gridDim.z after it) reads its planes at b times each array's member
// stride, its dt and decay from row b of a device array when one is given,
// and reduces into stats[2b..2b+1].  H8 decides each member's quiet branch
// from that member's own bound bound[2b..2b+1] and dt, as the vmapped
// lax.cond of the JAX package becomes a per-member select.  A single call
// is the case B = 1 with the scalars by value; it compiles without the
// member loop (the BATCH template flag).
#include <stdint.h>

#include "fluid_common.cuh"

struct Planes {
  const float* in[3];
  float* out[3];
};

// bits(x) + 0x8000, & 0xFFFF0000, in unsigned arithmetic (wraps)
__device__ __forceinline__ float bf16_tap(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x8000u) & 0xFFFF0000u);
}

// One cell of both kernels: bit ch of round_mask rounds channel ch's taps;
// clamp clamps the dye blend to >= 0.  Writes the outputs and sets mu, mv
// to |u'|, |v'| in the velocity mode.
template <bool DYE>
__device__ __forceinline__ void advect_cell(
    const Planes& planes, int c, const float* __restrict__ u,
    const float* __restrict__ v, int h, int w, int x, int y, float dt,
    float decay, unsigned round_mask, bool clamp, float& mu, float& mv) {
  const int i = y * w + x;
  // departure point pos - dt*vel (GPUFluidSim.cu:267)
  const float px = static_cast<float>(x) - dt * u[i];
  const float py = static_cast<float>(y) - dt * v[i];
  const float x1 = truncf(px);
  const float y1 = truncf(py);
  const float tx = px - x1;
  const float ty = py - y1;
  const float wm = static_cast<float>(w - 1);
  const float hm = static_cast<float>(h - 1);
  const int xi1 = static_cast<int>(fminf(fmaxf(x1, 0.f), wm));
  const int xi2 = static_cast<int>(fminf(fmaxf(x1 + 1.f, 0.f), wm));
  const int yi1 = static_cast<int>(fminf(fmaxf(y1, 0.f), hm));
  const int yi2 = static_cast<int>(fminf(fmaxf(y1 + 1.f, 0.f), hm));
  const int i00 = yi1 * w + xi1, i01 = yi1 * w + xi2;
  const int i10 = yi2 * w + xi1, i11 = yi2 * w + xi2;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    if (ch >= c) break;
    const float* f = planes.in[ch];
    float f00 = __ldg(f + i00), f01 = __ldg(f + i01);
    float f10 = __ldg(f + i10), f11 = __ldg(f + i11);
    if ((round_mask >> ch) & 1u) {
      f00 = bf16_tap(f00);
      f01 = bf16_tap(f01);
      f10 = bf16_tap(f10);
      f11 = bf16_tap(f11);
    }
    const float top = f00 * (1.f - tx) + f01 * tx;
    const float bot = f10 * (1.f - tx) + f11 * tx;
    float s = top * (1.f - ty) + bot * ty;
    float r;
    if (DYE) {
      if (clamp) s = s < 0.f ? 0.f : s;
      // fminf(1, NaN) == 1: a negative extrapolated sample saturates
      r = fminf(1.f, powf(s, 1.005f) * decay);
    } else {
      r = s * decay;
      if (ch == 0) mu = fabsf(r);
      if (ch == 1) mv = fabsf(r);
    }
    planes.out[ch][i] = r;
  }
}

// Member strides (floats) of the field planes in and out and of u and v;
// prm: row b holds member b's [dt, decay] (row stride prm_stride), or null
// for the dt and decay given by value.
struct Members {
  int nb;
  long long in, out, u, v;
  const float* prm;
  int prm_stride;
};

// BATCH false (a single call) compiles the member loop away: member 0 once,
// the scalars by value.
template <bool DYE, bool BATCH>
__global__ void advect_kernel(Planes planes, int c, const float* __restrict__ u,
                              const float* __restrict__ v,
                              float* __restrict__ stats, int h, int w,
                              float dt, float decay, Members m) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int nb = BATCH ? m.nb : 1;
  // one member at a time
#pragma unroll 1
  for (int b = BATCH ? blockIdx.z : 0; b < nb; b += BATCH ? gridDim.z : 1) {
    Planes p = planes;
    if (BATCH) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (ch < c) {
          p.in[ch] += b * m.in;
          p.out[ch] += b * m.out;
        }
      }
    }
    float bdt = dt, bdecay = decay;
    if (BATCH && m.prm != nullptr) {
      bdt = m.prm[static_cast<size_t>(b) * m.prm_stride];
      bdecay = m.prm[static_cast<size_t>(b) * m.prm_stride + 1];
    }
    float mu = 0.f, mv = 0.f;
    if (x < w && y < h)
      advect_cell<DYE>(p, c, u + b * m.u, v + b * m.v, h, w, x, y, bdt, bdecay, 0u,
                       false, mu, mv);
    if (!DYE && stats != nullptr) {
      fluid_block_max2_atomic(mu, mv, stats + 2 * b);
      if (BATCH) __syncthreads();  // the block max's slots, before the next member
    }
  }
}

// bound: the device-side [max|u|, max|v|] of each member, 2 floats a member
// (null when fast_path is 0).
template <bool DYE, bool BATCH>
__global__ void advect_packed_kernel(Planes planes, int c,
                                     const float* __restrict__ u,
                                     const float* __restrict__ v,
                                     const float* __restrict__ bound,
                                     float* __restrict__ stats, int h, int w,
                                     float dt, float decay, int fast_path,
                                     Members m) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int nb = BATCH ? m.nb : 1;
  // one member at a time
#pragma unroll 1
  for (int b = BATCH ? blockIdx.z : 0; b < nb; b += BATCH ? gridDim.z : 1) {
    Planes p = planes;
    if (BATCH) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (ch < c) {
          p.in[ch] += b * m.in;
          p.out[ch] += b * m.out;
        }
      }
    }
    float bdt = dt, bdecay = decay;
    if (BATCH && m.prm != nullptr) {
      bdt = m.prm[static_cast<size_t>(b) * m.prm_stride];
      bdecay = m.prm[static_cast<size_t>(b) * m.prm_stride + 1];
    }
    // uniform across the member's blocks: realized displacement under one cell
    const bool quiet =
        fast_path && bound[2 * b] * bdt < 1.f && bound[2 * b + 1] * bdt < 1.f;
    float mu = 0.f, mv = 0.f;
    if (x < w && y < h)
      advect_cell<DYE>(p, c, u + b * m.u, v + b * m.v, h, w, x, y, bdt, bdecay,
                       quiet ? 0u : 3u, DYE && !quiet, mu, mv);
    if (!DYE && stats != nullptr) {
      fluid_block_max2_atomic(mu, mv, stats + 2 * b);
      if (BATCH) __syncthreads();  // the block max's slots, before the next member
    }
  }
}

// [max|u|, max|v|] of each member into out[2b..2b+1] (zeroed first)
template <bool BATCH>
__global__ void vel_bound_kernel(const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 float* __restrict__ out, int h, int w, Members m) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int nb = BATCH ? m.nb : 1;
#pragma unroll 1
  for (int b = BATCH ? blockIdx.z : 0; b < nb; b += BATCH ? gridDim.z : 1) {
    float a = 0.f, c = 0.f;
    if (x < w && y < h) {
      a = fabsf(u[b * m.u + y * w + x]);
      c = fabsf(v[b * m.v + y * w + x]);
    }
    fluid_block_max2_atomic(a, c, out + 2 * b);
    if (BATCH) __syncthreads();
  }
}

// fields: c <= 3 planes (f0..f2, outputs o0..o2) of member 0.  dye != 0
// selects the dye fade; otherwise stats (may be null) receives
// [max|o0|, max|o1|] of each member, 2 floats a member.  nb members; in_ms,
// out_ms, u_ms, v_ms: member strides (floats) of f*, o*, u and v; prm: nb
// rows of [dt, decay] in device memory, prm_stride floats apart, or null
// for dt and decay (the only member when nb = 1).
FLUID_API int fluid_advect(const float* f0, const float* f1, const float* f2,
                           float* o0, float* o1, float* o2, const float* u,
                           const float* v, float* stats, int c, int h, int w,
                           int dye, float dt, float decay, int nb, long long in_ms,
                           long long out_ms, long long u_ms, long long v_ms,
                           const float* prm, int prm_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > 3 || h < 1 || w < 1 || nb < 1) return cudaErrorInvalidValue;
  if (prm != nullptr && prm_stride < 2) return cudaErrorInvalidValue;
  Planes planes = {{f0, f1, f2}, {o0, o1, o2}};
  const Members m = {nb, in_ms, out_ms, u_ms, v_ms, prm, prm_stride};
  const dim3 block(FLUID_BX, FLUID_BY);
  const dim3 grid = fluid_grid2d(h, w, fluid_grid_z(nb));
  const bool batch = nb > 1 || prm != nullptr;
  if (!dye && stats != nullptr) {
    cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(float) * nb, s);
    if (e != cudaSuccess) return e;
  }
  float* st = dye ? nullptr : stats;
  if (dye && batch)
    advect_kernel<true, true><<<grid, block, 0, s>>>(planes, c, u, v, st, h, w, dt, decay, m);
  else if (dye)
    advect_kernel<true, false><<<grid, block, 0, s>>>(planes, c, u, v, st, h, w, dt, decay, m);
  else if (batch)
    advect_kernel<false, true><<<grid, block, 0, s>>>(planes, c, u, v, st, h, w, dt, decay, m);
  else
    advect_kernel<false, false><<<grid, block, 0, s>>>(planes, c, u, v, st, h, w, dt, decay, m);
  return cudaGetLastError();
}

// As fluid_advect, over bf16-rounded taps (channels 0 and 1) unless the
// member's step is quiet.  fast_path != 0 enables the quiet branch, decided
// from bound (device [max|u|, max|v|], 2 floats a member) or, when bound is
// null, from the maxima of each member's u and v, reduced into scratch (2
// floats a member) first.  nb, in_ms, out_ms, u_ms, v_ms, prm, prm_stride:
// the members, as fluid_advect's.
FLUID_API int fluid_advect_packed(const float* f0, const float* f1,
                                  const float* f2, float* o0, float* o1,
                                  float* o2, const float* u, const float* v,
                                  const float* bound, float* scratch,
                                  float* stats, int c, int h, int w, int dye,
                                  int fast_path, float dt, float decay, int nb,
                                  long long in_ms, long long out_ms, long long u_ms,
                                  long long v_ms, const float* prm, int prm_stride,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > 3 || h < 1 || w < 1 || nb < 1) return cudaErrorInvalidValue;
  if (prm != nullptr && prm_stride < 2) return cudaErrorInvalidValue;
  Planes planes = {{f0, f1, f2}, {o0, o1, o2}};
  const Members m = {nb, in_ms, out_ms, u_ms, v_ms, prm, prm_stride};
  const dim3 block(FLUID_BX, FLUID_BY);
  const dim3 grid = fluid_grid2d(h, w, fluid_grid_z(nb));
  const bool batch = nb > 1 || prm != nullptr;
  cudaError_t e;
  if (!fast_path) {
    bound = nullptr;
  } else if (bound == nullptr) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    e = cudaMemsetAsync(scratch, 0, 2 * sizeof(float) * nb, s);
    if (e != cudaSuccess) return e;
    if (batch)
      vel_bound_kernel<true><<<grid, block, 0, s>>>(u, v, scratch, h, w, m);
    else
      vel_bound_kernel<false><<<grid, block, 0, s>>>(u, v, scratch, h, w, m);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    bound = scratch;
  }
  float* st = dye ? nullptr : stats;
  if (st != nullptr) {
    e = cudaMemsetAsync(st, 0, 2 * sizeof(float) * nb, s);
    if (e != cudaSuccess) return e;
  }
  if (dye && batch)
    advect_packed_kernel<true, true><<<grid, block, 0, s>>>(
        planes, c, u, v, bound, st, h, w, dt, decay, fast_path, m);
  else if (dye)
    advect_packed_kernel<true, false><<<grid, block, 0, s>>>(
        planes, c, u, v, bound, st, h, w, dt, decay, fast_path, m);
  else if (batch)
    advect_packed_kernel<false, true><<<grid, block, 0, s>>>(
        planes, c, u, v, bound, st, h, w, dt, decay, fast_path, m);
  else
    advect_packed_kernel<false, false><<<grid, block, 0, s>>>(
        planes, c, u, v, bound, st, h, w, dt, decay, fast_path, m);
  return cudaGetLastError();
}
