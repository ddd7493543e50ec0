// H7: separable fast diffusion, one block per 32x32 output tile.
//
// Replaces cudafluidsimulation_tpu/ops/fastdiffuse.py _sep_apply ->
// _sep_kernel and _sep_kernel_tiled (_sep_core, _splat_tail).  Per channel
// c and output cell (y, x):
//
//   out = sum_ranks sum_j ty_c[j] * (sum_i tx_c[i] * f[HS(y+j), HS(x+i)])
//         [+ amp_c * exp(-d2 / radius)]
//
// with half-sample symmetric edges HS (f[-1-k] = f[k], f[n+k] = f[n-1-k],
// periodic with period 2n, so any radius reflects correctly, also several
// times when r >= n).  The TPU kernels build the reflection from mirror
// padding and in-kernel ghost rows; here each block loads its tile plus an
// rmax-deep ring at reflected coordinates into shared memory, runs each
// rank's x pass over the tile's rows plus that rank's ring rows into shared
// memory, and its y pass into registers.  Sums run in the plain version's
// order (ops/fastdiffuse.py sep_apply): x from tap -r upward, y across the
// ranks in order, tap -r first.
//
// What bounds it: not its bytes (C planes in and C planes out, 160 MiB a
// call for 5 channels at 2048², ~50 us at HBM speed) but its shared-memory
// loads: each tap product reads its tap and its operand from shared
// memory, ~90 loads a cell at radii (5, 4).  Measured 0.48 ms a call on an
// NVIDIA H100 80GB HBM3 at 700 W, against 2.45 ms for H3's 20 sweeps.
// Keeping the taps in registers would cut that; this first version keeps
// the taps (a few dozen floats a channel) in the launch parameters, as
// H3's alphas ride, and copies them to shared memory.
#include "fluid_common.cuh"

#define SEP_TW 32  // tile width = FLUID_BX: one warp a row
#define SEP_TH 32  // tile height: 4 rows for each of the FLUID_BY thread rows
#define SEP_ROWS (SEP_TH / FLUID_BY)
#define SEP_MAX_CHANNELS 5
#define SEP_MAX_RANK 3
#define SEP_MAX_TAPS 160  // floats a channel; keeps SepParams under 4 KB

struct SepParams {
  float taps[SEP_MAX_CHANNELS][SEP_MAX_TAPS];
  float amp[SEP_MAX_CHANNELS];
  int radii[SEP_MAX_RANK];
  int rank, rmax, ntaps, splat;
  float lx, ly, radius;
};

__device__ __forceinline__ int hs_reflect(int i, int n) {
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

__global__ void __launch_bounds__(FLUID_BX * FLUID_BY)
sep_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
           int w, SepParams p) {
  extern __shared__ float smem[];
  const int R = p.rmax;
  const int ew = SEP_TW + 2 * R;
  const int eh = SEP_TH + 2 * R;
  float* tile = smem;                // eh x ew field at reflected coords
  float* xsum = tile + eh * ew;      // eh x SEP_TW x-pass sums
  float* stap = xsum + eh * SEP_TW;  // this channel's taps
  const int ch = blockIdx.z;
  const size_t plane = static_cast<size_t>(ch) * h * w;
  const float* f = in + plane;
  const int x0 = blockIdx.x * SEP_TW;
  const int y0 = blockIdx.y * SEP_TH;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  for (int i = tid; i < p.ntaps; i += nthr) stap[i] = p.taps[ch][i];
  for (int i = tid; i < eh * ew; i += nthr) {
    const int ty = i / ew;
    const int tx = i - ty * ew;
    const int gy = hs_reflect(y0 + ty - R, h);
    const int gx = hs_reflect(x0 + tx - R, w);
    tile[i] = __ldg(f + static_cast<size_t>(gy) * w + gx);
  }
  __syncthreads();

  float acc[SEP_ROWS];
  int off = 0;
  for (int k = 0; k < p.rank; ++k) {
    const int r = p.radii[k];
    const int n = 2 * r + 1;
    // x pass over tile rows [R - r, R + SEP_TH + r)
    const int rows = SEP_TH + 2 * r;
    for (int i = tid; i < rows * SEP_TW; i += nthr) {
      const int ty = i / SEP_TW + (R - r);
      const int tx = i % SEP_TW;
      const float* src = tile + ty * ew + tx + (R - r);
      float s = stap[off] * src[0];
      for (int j = 1; j < n; ++j) s = s + stap[off + j] * src[j];
      xsum[ty * SEP_TW + tx] = s;
    }
    __syncthreads();
    // y pass onto this thread's SEP_ROWS output rows
#pragma unroll
    for (int q = 0; q < SEP_ROWS; ++q) {
      const int oy = threadIdx.y + q * FLUID_BY;
      const float* src = xsum + (oy + R - r) * SEP_TW + threadIdx.x;
      const float t0 = stap[off + n] * src[0];
      float a = (k == 0) ? t0 : acc[q] + t0;
      for (int j = 1; j < n; ++j) a = a + stap[off + n + j] * src[j * SEP_TW];
      acc[q] = a;
    }
    __syncthreads();  // xsum is rewritten by the next rank
    off += 2 * n;
  }

  const int ox = x0 + threadIdx.x;
#pragma unroll
  for (int q = 0; q < SEP_ROWS; ++q) {
    const int oy = y0 + threadIdx.y + q * FLUID_BY;
    if (ox >= w || oy >= h) continue;
    float val = acc[q];
    if (p.splat) {
      const float dx = static_cast<float>(ox) - p.lx;
      const float dy = static_cast<float>(oy) - p.ly;
      const float d2 = dx * dx + dy * dy;
      val = val + p.amp[ch] * expf(-d2 / p.radius);
    }
    out[plane + static_cast<size_t>(oy) * w + ox] = val;
  }
}

// in, out: (c, h, w) planes, c <= SEP_MAX_CHANNELS.  taps: c rows of
// tap_len host floats, each row the ranks' x taps then y taps in rank
// order; radii: rank host ints; amp: c host floats or null (no splat).
FLUID_API int fluid_sep_diffuse(const float* in, float* out, int c, int h,
                                int w, const float* taps, int tap_len,
                                const int* radii, int rank, const float* amp,
                                float lx, float ly, float radius,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > SEP_MAX_CHANNELS || h < 1 || w < 1 || rank < 1 ||
      rank > SEP_MAX_RANK || tap_len > SEP_MAX_TAPS)
    return cudaErrorInvalidValue;
  SepParams p = {};
  int len = 0;
  for (int k = 0; k < rank; ++k) {
    if (radii[k] < 0) return cudaErrorInvalidValue;
    p.radii[k] = radii[k];
    if (radii[k] > p.rmax) p.rmax = radii[k];
    len += 2 * (2 * radii[k] + 1);
  }
  if (len != tap_len) return cudaErrorInvalidValue;
  p.rank = rank;
  p.ntaps = tap_len;
  for (int ch = 0; ch < c; ++ch) {
    for (int i = 0; i < tap_len; ++i) p.taps[ch][i] = taps[ch * tap_len + i];
    p.amp[ch] = amp != nullptr ? amp[ch] : 0.f;
  }
  p.splat = amp != nullptr;
  p.lx = lx;
  p.ly = ly;
  p.radius = radius;
  const int eh = SEP_TH + 2 * p.rmax;
  const int ew = SEP_TW + 2 * p.rmax;
  const size_t smem = sizeof(float) * (static_cast<size_t>(eh) * ew +
                                       static_cast<size_t>(eh) * SEP_TW +
                                       tap_len);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 block(FLUID_BX, FLUID_BY);
  const dim3 grid((w + SEP_TW - 1) / SEP_TW, (h + SEP_TH - 1) / SEP_TH, c);
  sep_kernel<<<grid, block, smem, s>>>(in, out, h, w, p);
  return cudaGetLastError();
}
