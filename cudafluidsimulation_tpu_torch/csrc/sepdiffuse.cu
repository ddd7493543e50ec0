// H7: separable fast diffusion.
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
// rmax-deep ring at reflected coordinates into shared memory.  Sums run in
// the plain version's order (ops/fastdiffuse.py sep_apply): x from tap -r
// upward; y across the ranks in order, tap -r first, the first product of
// rank 0 starting the sum and every later one added to it.
//
// What bounds it: not its bytes (C planes in and C planes out, 160 MiB a
// call for 5 channels at 2048², 0.050 ms at 3.35 TB/s) but the issue of its
// float32 operations: 40 products and 40 sums a cell at radii (5, 4), kept
// apart (-fmad=false) so that each rounds as the plain version's.  The first
// design (PR 4: taps and operands both from shared memory, ~90 shared loads
// a cell) took 0.48 ms on an NVIDIA H100 80GB HBM3 at 700 W, bound by those
// loads.  This one, sep_kernel_unrolled, is templated on the rank and the
// radii, so the shipped design (rank 2, radii 5 and 4, ops/fastdiffuse.py)
// is fully unrolled with each rank's taps in registers:
//   - a block takes a 64 x 128 tile of one channel; 8 warps of 32 lanes;
//   - x pass: a lane computes 4 neighbouring outputs of a row from one
//     register window of 16 floats (four 16-byte shared loads, no tap
//     loads), for the tile's rows plus the rank's ring (64 + 2r rows, so
//     the ring costs 16% at r = 5), into a shared buffer of x sums;
//   - y pass: a lane walks 8 output rows of its 4 columns down the x sums,
//     one 16-byte load a row (8 + 2r loads for 8 x (2r + 1) x 4 products),
//     adding each row's products to the 8 outputs it reaches, each output's
//     terms in tap order.
// Shared memory: the tile + ring (74 x 140 floats) and one rank's x sums
// (74 x 128), 79 KB a block: 2 blocks an SM.  Other radii (design_taps can
// give any, rank <= 3) run sep_kernel_generic, the first design: taps in
// shared memory, one output a thread in the x pass.
//
// Batches (ensembles, the analog of the JAX package's vmap): a launch takes
// n = B x C planes, plane z = blockIdx.z (and every gridDim.z after it),
// member z / C and channel z % C.  The taps are the channel's, the same for
// every member (designed at the nominal dt and coefficients), so they stay
// by value; each member's splat amplitudes and centre come from its row of
// a device array [amp[0..C), lx, ly] (ops/member_params.py diffuse_cols's
// columns from 2C on).  A single call (one member, everything by value)
// compiles without the plane loop (BATCH false).
#include <stdint.h>

#include "fluid_common.cuh"

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
  if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

// One plane's splat: amplitude and centre.
struct SepSplat {
  float amp, lx, ly;
};

// The members' splat rows in device memory: row b (prm_stride floats apart)
// holds [amp[0..chans), lx, ly].
struct SepRows {
  const float* prm;
  int prm_stride, chans;
};

// Plane z's channel and splat: from its member's row when rows are given,
// else from the launch parameters (no splat, or a single member's).
__device__ __forceinline__ SepSplat sep_plane_splat(const SepParams& p, const SepRows& r,
                                                    int z, int& ch) {
  const int b = z / r.chans;
  ch = z - b * r.chans;
  if (r.prm == nullptr) return {p.amp[ch], p.lx, p.ly};
  const float* row = r.prm + static_cast<size_t>(b) * r.prm_stride;
  return {row[ch], row[r.chans], row[r.chans + 1]};
}

// val + amp * exp(-d2 / radius) at (ox, oy), as the plain splat tail
__device__ __forceinline__ float sep_splat(float val, float amp, float lx, float ly,
                                           float radius, int ox, int oy) {
  const float dx = static_cast<float>(ox) - lx;
  const float dy = static_cast<float>(oy) - ly;
  const float d2 = dx * dx + dy * dy;
  return val + amp * expf(-d2 / radius);
}

// -- the unrolled kernel ---------------------------------------------------------

#define SEP_TW 128  // tile width: 32 lanes x 4 columns
#define SEP_TH 64   // tile height: 8 warps x SEP_Q output rows
#define SEP_WARPS 8
#define SEP_Q (SEP_TH / SEP_WARPS)
#define SEP_THREADS (32 * SEP_WARPS)

constexpr int sep_max(int a, int b) { return a > b ? a : b; }

template <int RANK, int R0, int R1, int R2>
struct SepDesign {
  static constexpr int rmax = sep_max(R0, sep_max(RANK > 1 ? R1 : 0, RANK > 2 ? R2 : 0));
  // float4 loads of a lane's rmax window, and the shared row stride: lane
  // 31's window ends there
  static constexpr int nv = (4 + 2 * rmax + 3) / 4;
  static constexpr int ew = 4 * (31 + nv);
  static constexpr int eh = SEP_TH + 2 * rmax;
  static constexpr size_t smem = sizeof(float) * (eh * ew + eh * SEP_TW);
};

// One rank: the x pass of tile rows into xs, then the y pass onto acc.
// The tile's column 0 is global column x0 - RM; the x sums of rank R start
// at tile row RM - R (global row y0 - R).
template <int R, bool FIRST, int RM, int EW>
__device__ __forceinline__ void sep_rank_pass(const float* tile, float* xs,
                                              const float (&taps)[2 * (2 * R + 1)],
                                              float (&acc)[SEP_Q][4], int lane,
                                              int warp) {
  constexpr int N = 2 * R + 1, SH = RM - R;
  constexpr int NW = (4 + SH + 2 * R + 3) / 4;  // float4 loads of the window
  for (int row = warp; row < SEP_TH + 2 * R; row += SEP_WARPS) {
    const float* src = tile + (row + SH) * EW + 4 * lane;
    float win[4 * NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float4 q = *reinterpret_cast<const float4*>(src + 4 * i);
      win[4 * i] = q.x;
      win[4 * i + 1] = q.y;
      win[4 * i + 2] = q.z;
      win[4 * i + 3] = q.w;
    }
    float s[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      s[o] = taps[0] * win[o + SH];
#pragma unroll
      for (int j = 1; j < N; ++j) s[o] = s[o] + taps[j] * win[o + SH + j];
    }
    *reinterpret_cast<float4*>(xs + row * SEP_TW + 4 * lane) = make_float4(s[0], s[1], s[2], s[3]);
  }
  __syncthreads();
  // x-sum row yy of this warp feeds its output row q with tap j = yy - q
  const float* col = xs + warp * SEP_Q * SEP_TW + 4 * lane;
#pragma unroll
  for (int yy = 0; yy < SEP_Q + 2 * R; ++yy) {
    const float4 x4 = *reinterpret_cast<const float4*>(col + yy * SEP_TW);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int q = 0; q < SEP_Q; ++q) {
      const int j = yy - q;
      if (j < 0 || j >= N) continue;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float term = taps[N + j] * xv[o];
        acc[q][o] = (FIRST && j == 0) ? term : acc[q][o] + term;
      }
    }
  }
  __syncthreads();  // xs is rewritten by the next rank
}

// this channel's taps of one rank, from the launch parameters into registers
#define SEP_LOAD_TAPS(t, R, OFF)                                     \
  float t[2 * (2 * (R) + 1)];                                        \
  _Pragma("unroll") for (int i = 0; i < 2 * (2 * (R) + 1); ++i)      \
      t[i] = p.taps[ch][(OFF) + i];

// One plane of the unrolled kernel: f, o the plane's input and output, ch
// its channel (taps), sp its splat.
template <int RANK, int R0, int R1, int R2>
__device__ __forceinline__ void sep_plane_unrolled(const float* __restrict__ f,
                                                   float* __restrict__ o, int h, int w,
                                                   int ch, SepSplat sp, const SepParams& p,
                                                   float* tile, float* xs) {
  using D = SepDesign<RANK, R0, R1, R2>;
  constexpr int RM = D::rmax, EW = D::ew, EH = D::eh;
  const int x0 = blockIdx.x * SEP_TW, y0 = blockIdx.y * SEP_TH;
  const int lane = threadIdx.x, warp = threadIdx.y;
  // the tile + ring: a warp takes every 8th row, a lane every 32nd column;
  // the loads of FB rows are issued before their stores, so each thread
  // keeps FB x FC loads in flight instead of waiting on each in turn
  // (indices past the tile's rows or columns load a clamped cell and are
  // not stored)
  constexpr int FC = (EW + 31) / 32, FR = (EH + SEP_WARPS - 1) / SEP_WARPS, FB = 5;
  int gx[FC];
#pragma unroll
  for (int j = 0; j < FC; ++j) gx[j] = hs_reflect(x0 + min(lane + 32 * j, EW - 1) - RM, w);
#pragma unroll
  for (int i0 = 0; i0 < FR; i0 += FB) {
    float v[FB][FC];
#pragma unroll
    for (int i = 0; i < FB; ++i) {
      const int r = min(warp + SEP_WARPS * (i0 + i), EH - 1);
      const float* row = f + static_cast<size_t>(hs_reflect(y0 + r - RM, h)) * w;
#pragma unroll
      for (int j = 0; j < FC; ++j) v[i][j] = __ldg(row + gx[j]);
    }
#pragma unroll
    for (int i = 0; i < FB; ++i) {
      const int r = warp + SEP_WARPS * (i0 + i);
#pragma unroll
      for (int j = 0; j < FC; ++j)
        if (r < EH && lane + 32 * j < EW) tile[r * EW + lane + 32 * j] = v[i][j];
    }
  }
  __syncthreads();

  float acc[SEP_Q][4];
  {
    SEP_LOAD_TAPS(t, R0, 0)
    sep_rank_pass<R0, true, RM, EW>(tile, xs, t, acc, lane, warp);
  }
  if constexpr (RANK > 1) {
    SEP_LOAD_TAPS(t, R1, 2 * (2 * R0 + 1))
    sep_rank_pass<R1, false, RM, EW>(tile, xs, t, acc, lane, warp);
  }
  if constexpr (RANK > 2) {
    SEP_LOAD_TAPS(t, R2, 2 * (2 * R0 + 1) + 2 * (2 * R1 + 1))
    sep_rank_pass<R2, false, RM, EW>(tile, xs, t, acc, lane, warp);
  }

  const int ox = x0 + 4 * lane;
  const float radius = p.radius;
  const bool splat = p.splat;
#pragma unroll
  for (int q = 0; q < SEP_Q; ++q) {
    const int oy = y0 + warp * SEP_Q + q;
    if (oy >= h) break;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = splat ? sep_splat(acc[q][k], sp.amp, sp.lx, sp.ly, radius, ox + k, oy) : acc[q][k];
    float* dst = o + static_cast<size_t>(oy) * w + ox;
    if (ox + 3 < w && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ox + k < w) dst[k] = v[k];
    }
  }
}

// n planes (BATCH) or the C channels of one call, plane z at z * h * w.
template <int RANK, int R0, int R1, int R2, bool BATCH>
__global__ void __launch_bounds__(SEP_THREADS, 2)
sep_kernel_unrolled(const float* __restrict__ in, float* __restrict__ out,
                    int h, int w, const __grid_constant__ SepParams p, SepRows rows, int n) {
  using D = SepDesign<RANK, R0, R1, R2>;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // EH x EW, reflected
  float* xs = tile + D::eh * D::ew;               // EH x SEP_TW x sums
  const size_t hw = static_cast<size_t>(h) * w;
  if (!BATCH) {
    const int ch = blockIdx.z;
    sep_plane_unrolled<RANK, R0, R1, R2>(in + ch * hw, out + ch * hw, h, w, ch,
                                         {p.amp[ch], p.lx, p.ly}, p, tile, xs);
    return;
  }
  // one plane at a time, the body's shape opaque (fluid_opaque)
#pragma unroll 1
  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    int ch;
    const SepSplat sp = sep_plane_splat(p, rows, z, ch);
    sep_plane_unrolled<RANK, R0, R1, R2>(in + z * hw, out + z * hw, fluid_opaque(h),
                                         fluid_opaque(w), ch, sp, p, tile, xs);
    __syncthreads();  // the tile, before the next plane's fill
  }
}

// -- the generic kernel: any rank <= 3 and radii ------------------------------------

#define GEN_TW 32  // tile width = FLUID_BX: one warp a row
#define GEN_TH 32  // tile height: 4 rows for each of the FLUID_BY thread rows
#define GEN_ROWS (GEN_TH / FLUID_BY)

// One plane of the generic kernel (f, o, ch, sp as sep_plane_unrolled's).
__device__ __forceinline__ void sep_plane_generic(const float* __restrict__ f,
                                                  float* __restrict__ o, int h, int w,
                                                  int ch, SepSplat sp, const SepParams& p,
                                                  float* smem) {
  const int R = p.rmax;
  const int ew = GEN_TW + 2 * R;
  const int eh = GEN_TH + 2 * R;
  float* tile = smem;                // eh x ew field at reflected coords
  float* xsum = tile + eh * ew;      // eh x GEN_TW x-pass sums
  float* stap = xsum + eh * GEN_TW;  // this channel's taps
  const int x0 = blockIdx.x * GEN_TW;
  const int y0 = blockIdx.y * GEN_TH;
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

  float acc[GEN_ROWS];
  int off = 0;
  for (int k = 0; k < p.rank; ++k) {
    const int r = p.radii[k];
    const int n = 2 * r + 1;
    // x pass over tile rows [R - r, R + GEN_TH + r)
    const int rows = GEN_TH + 2 * r;
    for (int i = tid; i < rows * GEN_TW; i += nthr) {
      const int ty = i / GEN_TW + (R - r);
      const int tx = i % GEN_TW;
      const float* src = tile + ty * ew + tx + (R - r);
      float s = stap[off] * src[0];
      for (int j = 1; j < n; ++j) s = s + stap[off + j] * src[j];
      xsum[ty * GEN_TW + tx] = s;
    }
    __syncthreads();
    // y pass onto this thread's GEN_ROWS output rows
#pragma unroll
    for (int q = 0; q < GEN_ROWS; ++q) {
      const int oy = threadIdx.y + q * FLUID_BY;
      const float* src = xsum + (oy + R - r) * GEN_TW + threadIdx.x;
      const float t0 = stap[off + n] * src[0];
      float a = (k == 0) ? t0 : acc[q] + t0;
      for (int j = 1; j < n; ++j) a = a + stap[off + n + j] * src[j * GEN_TW];
      acc[q] = a;
    }
    __syncthreads();  // xsum is rewritten by the next rank
    off += 2 * n;
  }

  const int ox = x0 + threadIdx.x;
#pragma unroll
  for (int q = 0; q < GEN_ROWS; ++q) {
    const int oy = y0 + threadIdx.y + q * FLUID_BY;
    if (ox >= w || oy >= h) continue;
    o[static_cast<size_t>(oy) * w + ox] =
        p.splat ? sep_splat(acc[q], sp.amp, sp.lx, sp.ly, p.radius, ox, oy) : acc[q];
  }
}

template <bool BATCH>
__global__ void __launch_bounds__(FLUID_BX * FLUID_BY)
sep_kernel_generic(const float* __restrict__ in, float* __restrict__ out, int h,
                   int w, const __grid_constant__ SepParams p, SepRows rows, int n) {
  extern __shared__ float smem[];
  const size_t hw = static_cast<size_t>(h) * w;
  if (!BATCH) {
    const int ch = blockIdx.z;
    sep_plane_generic(in + ch * hw, out + ch * hw, h, w, ch, {p.amp[ch], p.lx, p.ly}, p,
                      smem);
    return;
  }
#pragma unroll 1
  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    int ch;
    const SepSplat sp = sep_plane_splat(p, rows, z, ch);
    sep_plane_generic(in + z * hw, out + z * hw, fluid_opaque(h), fluid_opaque(w), ch, sp, p,
                      smem);
    __syncthreads();  // the tile and the taps, before the next plane's fill
  }
}

// The radii the unrolled kernel is instantiated for (ops/fastdiffuse_cuda.py
// UNROLLED): rank 2, radii 5 and 4.
template <class K>
static cudaError_t sep_allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return fluid_allow_smem(kernel, smem);
}

// in, out: n (h, w) planes, plane z of member z / chans and channel
// z % chans; chans <= SEP_MAX_CHANNELS.  taps: chans rows of tap_len host
// floats, each row the ranks' x taps then y taps in rank order; radii: rank
// host ints.  splat != 0 adds the splat tail: with prm null (then n ==
// chans, one member) amp holds chans host floats and lx, ly the centre;
// with prm, member b's [amp[0..chans), lx, ly] is row b of that device
// array (prm_stride floats apart).  Without the splat, prm and amp may be
// null at any n.  radius: the splat's, by value.
// unrolled: 1 runs sep_kernel_unrolled, which needs rank 2 and radii (5, 4);
// 0 runs sep_kernel_generic.
FLUID_API int fluid_sep_diffuse(const float* in, float* out, int n, int chans, int h,
                                int w, const float* taps, int tap_len,
                                const int* radii, int rank, const float* amp,
                                float lx, float ly, float radius, int splat,
                                const float* prm, int prm_stride, int unrolled,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chans < 1 || chans > SEP_MAX_CHANNELS || n < chans || n % chans != 0 || h < 1 ||
      w < 1 || rank < 1 || rank > SEP_MAX_RANK || tap_len > SEP_MAX_TAPS)
    return cudaErrorInvalidValue;
  if (splat && (prm == nullptr ? n != chans || amp == nullptr : prm_stride < chans + 2))
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
  for (int ch = 0; ch < chans; ++ch) {
    for (int i = 0; i < tap_len; ++i) p.taps[ch][i] = taps[ch * tap_len + i];
    p.amp[ch] = splat && prm == nullptr ? amp[ch] : 0.f;  // prm's rows otherwise
  }
  p.splat = splat != 0;
  p.lx = lx;
  p.ly = ly;
  p.radius = radius;
  const SepRows rows = {prm, prm_stride, chans};
  const bool batch = prm != nullptr || n > chans;
  cudaError_t e;
  if (unrolled) {
    if (rank != 2 || radii[0] != 5 || radii[1] != 4) return cudaErrorInvalidValue;
    auto kernel = batch ? sep_kernel_unrolled<2, 5, 4, 0, true>
                        : sep_kernel_unrolled<2, 5, 4, 0, false>;
    const size_t smem = SepDesign<2, 5, 4, 0>::smem;
    e = sep_allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((w + SEP_TW - 1) / SEP_TW, (h + SEP_TH - 1) / SEP_TH, fluid_grid_z(n));
    kernel<<<grid, dim3(32, SEP_WARPS), smem, s>>>(in, out, h, w, p, rows, n);
    return cudaGetLastError();
  }
  const int eh = GEN_TH + 2 * p.rmax;
  const int ew = GEN_TW + 2 * p.rmax;
  const size_t smem = sizeof(float) * (static_cast<size_t>(eh) * ew +
                                       static_cast<size_t>(eh) * GEN_TW + tap_len);
  auto kernel = batch ? sep_kernel_generic<true> : sep_kernel_generic<false>;
  e = sep_allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + GEN_TW - 1) / GEN_TW, (h + GEN_TH - 1) / GEN_TH, fluid_grid_z(n));
  kernel<<<grid, dim3(FLUID_BX, FLUID_BY), smem, s>>>(in, out, h, w, p, rows, n);
  return cudaGetLastError();
}
