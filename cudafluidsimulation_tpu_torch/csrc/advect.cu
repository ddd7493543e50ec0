// H1: semi-Lagrangian advection, one thread per cell.
//
// Replaces cudafluidsimulation_tpu/ops/advect_pallas.py _advect_kernel and
// _advect_kernel_tiled (cores _advect_core, _advect_core_static, and
// _emit_stats).  The TPU kernel rewrites the gather as a shift-accumulation
// over a bounded displacement window because the TPU has no fast gather;
// here each thread backtraces its cell, truncates the corner toward zero
// (so negative coordinates extrapolate), clamps four taps to the domain and
// blends them, as ops/ref.py bilerp does.  The backtrace is unbounded.
//
// Bound by bytes: u, v and C field planes in, C planes out; the taps sit
// near the cell and hit L1/L2.  The velocity mode also emits
// [max|u'|, max|v'|] into stats[0..1] (zeroed here on the stream first).
#include "fluid_common.cuh"

struct Planes {
  const float* in[3];
  float* out[3];
};

template <bool DYE>
__global__ void advect_kernel(Planes planes, int c, const float* __restrict__ u,
                              const float* __restrict__ v,
                              float* __restrict__ stats, int h, int w,
                              float dt, float decay) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  float mu = 0.f, mv = 0.f;
  if (x < w && y < h) {
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
      const float top = __ldg(f + i00) * (1.f - tx) + __ldg(f + i01) * tx;
      const float bot = __ldg(f + i10) * (1.f - tx) + __ldg(f + i11) * tx;
      const float s = top * (1.f - ty) + bot * ty;
      float r;
      if (DYE) {
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
  if (!DYE && stats != nullptr) fluid_block_max2_atomic(mu, mv, stats);
}

// fields: c <= 3 planes (f0..f2, outputs o0..o2).  dye != 0 selects the dye
// fade; otherwise stats (may be null) receives [max|o0|, max|o1|].
FLUID_API int fluid_advect(const float* f0, const float* f1, const float* f2,
                           float* o0, float* o1, float* o2, const float* u,
                           const float* v, float* stats, int c, int h, int w,
                           int dye, float dt, float decay, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > 3 || h < 1 || w < 1) return cudaErrorInvalidValue;
  Planes planes = {{f0, f1, f2}, {o0, o1, o2}};
  const dim3 block(FLUID_BX, FLUID_BY);
  const dim3 grid = fluid_grid2d(h, w);
  if (dye) {
    advect_kernel<true><<<grid, block, 0, s>>>(planes, c, u, v, nullptr, h, w,
                                               dt, decay);
  } else {
    if (stats != nullptr) {
      cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(float), s);
      if (e != cudaSuccess) return e;
    }
    advect_kernel<false><<<grid, block, 0, s>>>(planes, c, u, v, stats, h, w,
                                                dt, decay);
  }
  return cudaGetLastError();
}
