// H2: vorticity confinement, curl and force in one pass.
//
// Replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py
// vorticity_confinement -> _vorticity_kernel (_curl_taps, _confinement).
// The curl is 0.5*(vR - vL - uT + uB) with clamped taps, and the force
// reads the curl field with clamped taps too: a ring cell outside the grid
// holds the curl of the clamped cell (ops/ref.py clamps the curl field).
//
// gpu variant (GPUFluidSim.cu:536-573): f = 0.5*(|wT|-|wB|, |wL|-|wR|),
//   normalised by (len + 1e-3), scaled by w*vorticity, not negated.
// cpu variant (cpuFluidSim.cpp:271-296): f = 0.5*(|wT|-|wB|, |wR|-|wL|),
//   normalised by (len + 1e-4), scaled by w*vorticity, negated.
//
// Bound by bytes: u, v in, u', v' out (16 bytes a cell).  The first design
// (32x8 tiles, 4 scalar loads per ring curl, u and v read again for the
// update) ran at half its bound, held back by L1 requests.  Here a block
// takes a 128 x VORT_TH tile and reads each plane once, with its halo:
//
// 1. fill: u rows y0-2 .. y0+TH+1 with one ring column each side, v rows
//    y0-1 .. y0+TH with two ring columns each side, into shared memory at
//    clamped coordinates; the tile's columns as 16-byte loads (every load a
//    thread issues before its first shared store), the ring columns as
//    scalars;
// 2. curl of the tile and its one-cell ring from shared memory, 4 columns
//    a thread (16-byte shared accesses);
// 3. force, 4 columns a thread: the curl's neighbours at clamped
//    coordinates, the centre u and v from the tile; 16-byte stores.
//
// Where W is not a multiple of 4 or a plane is not 16-byte aligned, the
// same kernel loads and stores each cell as a scalar (vec = 0).  Ring cells
// outside the grid hold values computed from clamped loads and are never
// read: the force's taps clamp against the grid first.  The outputs are two
// pointers, so the caller may hand it channels 0 and 1 of a larger pack.
//
// A batch of independent members (ensembles) runs in the same launch:
// member b = blockIdx.z (and every gridDim.z after it) takes its planes at
// b times each array's member stride and its dt from row b of a device
// array when one is given.  A single call is the case B = 1, dt by value.
#include <stdint.h>

#include "fluid_common.cuh"

#define VORT_TH 16        // tile rows (8 measured no faster, 24 slower)
#define VORT_TW 128      // tile columns: 32 threads x 4
#define VORT_THREADS 256  // 8 warps
#define VORT_PAD 4        // shared column of tile column 0 (16-byte aligned)
#define VORT_S (VORT_TW + 2 * VORT_PAD)  // floats a shared row

struct VortTile {
  float u[VORT_TH + 4][VORT_S];  // rows y0-2 .., columns x0-1 .. x0+TW
  float v[VORT_TH + 2][VORT_S];  // rows y0-1 .., columns x0-2 .. x0+TW+1
  float w[VORT_TH + 2][VORT_S];  // curl: rows y0-1 .., columns x0-1 .. x0+TW
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void st4(float* p, float4 a) { *reinterpret_cast<float4*>(p) = a; }

__device__ __forceinline__ float at(const float4& a, int j) {
  return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w;
}

// One member's tile: the three phases below.
template <bool CPU>
__device__ __forceinline__ void vorticity_tile(VortTile& t, const float* __restrict__ u,
                                               const float* __restrict__ v,
                                               float* __restrict__ u2,
                                               float* __restrict__ v2, int h, int w,
                                               int vec, float dt, float vorticity,
                                               int tid) {
  const int x0 = blockIdx.x * VORT_TW;
  const int y0 = blockIdx.y * VORT_TH;

  // -- 1. fill: 32 four-column groups a row, u's rows first, then v's
  constexpr int UG = (VORT_TH + 4) * 32;
  constexpr int NG = UG + (VORT_TH + 2) * 32;
  constexpr int PER = (NG + VORT_THREADS - 1) / VORT_THREADS;
  float4 buf[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * VORT_THREADS;
    if (i < NG) {
      const bool is_u = i < UG;
      const int j = is_u ? i : i - UG;
      const int gy = fluid_clamp(y0 + (j >> 5) - (is_u ? 2 : 1), h);
      const int gx = x0 + 4 * (j & 31);
      const float* src = (is_u ? u : v) + static_cast<size_t>(gy) * w;
      if (vec && gx < w) {
        buf[k] = __ldg(reinterpret_cast<const float4*>(src + gx));
      } else {
        buf[k] = make_float4(__ldg(src + min(gx, w - 1)), __ldg(src + min(gx + 1, w - 1)),
                             __ldg(src + min(gx + 2, w - 1)), __ldg(src + min(gx + 3, w - 1)));
      }
    }
  }
  // the ring columns: u's -1 and TW on each of its rows, v's -2, -1, TW and
  // TW + 1 on each of its rows
  constexpr int URING = (VORT_TH + 4) * 2;
  constexpr int NRING = URING + (VORT_TH + 2) * 4;
  static_assert(NRING <= VORT_THREADS, "one ring cell a thread");
  float ring = 0.f;
  float* ring_dst = nullptr;
  if (tid < NRING) {
    const bool is_u = tid < URING;
    const int j = is_u ? tid : tid - URING;
    const int r = is_u ? j >> 1 : j >> 2;
    const int c = is_u ? ((j & 1) ? VORT_TW : -1) : ((j & 3) < 2 ? (j & 3) - 2 : VORT_TW + (j & 3) - 2);
    const int gy = fluid_clamp(y0 + r - (is_u ? 2 : 1), h);
    ring = __ldg((is_u ? u : v) + static_cast<size_t>(gy) * w + fluid_clamp(x0 + c, w));
    ring_dst = (is_u ? t.u[r] : t.v[r]) + VORT_PAD + c;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * VORT_THREADS;
    if (i < NG) {
      const bool is_u = i < UG;
      const int j = is_u ? i : i - UG;
      st4((is_u ? t.u[j >> 5] : t.v[j >> 5]) + VORT_PAD + 4 * (j & 31), buf[k]);
    }
  }
  if (ring_dst != nullptr) *ring_dst = ring;
  __syncthreads();

  // -- 2. the curl of the tile and its ring; shared row r is grid row
  //    y0 - 1 + r (u's row r + 1)
  constexpr int CG = (VORT_TH + 2) * 32;
  for (int i = tid; i < CG; i += VORT_THREADS) {
    const int r = i >> 5, c = VORT_PAD + 4 * (i & 31);
    const float4 vc = ld4(&t.v[r][c]);
    const float vl = t.v[r][c - 1], vr = t.v[r][c + 4];
    const float4 ub = ld4(&t.u[r][c]), ut = ld4(&t.u[r + 2][c]);
    float4 cw;
    cw.x = 0.5f * (vc.y - vl - ut.x + ub.x);
    cw.y = 0.5f * (vc.z - vc.x - ut.y + ub.y);
    cw.z = 0.5f * (vc.w - vc.y - ut.z + ub.z);
    cw.w = 0.5f * (vr - vc.z - ut.w + ub.w);
    st4(&t.w[r][c], cw);
  }
  if (tid < (VORT_TH + 2) * 2) {
    const int r = tid >> 1, c = VORT_PAD + ((tid & 1) ? VORT_TW : -1);
    t.w[r][c] = 0.5f * (t.v[r][c + 1] - t.v[r][c - 1] - t.u[r + 2][c] + t.u[r][c]);
  }
  __syncthreads();

  // -- 3. the force on the tile, 4 columns a thread
  for (int i = tid; i < VORT_TH * 32; i += VORT_THREADS) {
    const int r = i >> 5, g = i & 31;
    const int gy = y0 + r, gx = x0 + 4 * g;
    if (gy >= h || gx >= w) continue;
    const int c = VORT_PAD + 4 * g;
    // the curl rows of the clamped neighbours (shared row of grid row y is
    // y - y0 + 1) and the clamped neighbour columns outside this group
    const int rt = min(gy + 1, h - 1) - y0 + 1, rb = max(gy - 1, 0) - y0 + 1;
    const float4 wc = ld4(&t.w[r + 1][c]);
    const float4 wt = ld4(&t.w[rt][c]), wb = ld4(&t.w[rb][c]);
    const float wl_edge = t.w[r + 1][VORT_PAD + max(gx - 1, 0) - x0];
    const float wr_edge = t.w[r + 1][VORT_PAD + min(gx + 4, w - 1) - x0];
    const float4 uc = ld4(&t.u[r + 2][c]), vc = ld4(&t.v[r + 1][c]);
    float ou[4], ov[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float left = j == 0 ? wl_edge : at(wc, j - 1);
      const float right = gx + j + 1 >= w ? at(wc, j) : j == 3 ? wr_edge : at(wc, j + 1);
      const float wl = fabsf(left), wr = fabsf(right);
      const float wbj = fabsf(at(wb, j)), wtj = fabsf(at(wt, j));
      float fx = 0.5f * (wtj - wbj);
      float fy = CPU ? 0.5f * (wr - wl) : 0.5f * (wl - wr);
      const float ln = sqrtf(fx * fx + fy * fy) + (CPU ? 1e-4f : 1e-3f);
      const float s = at(wc, j) * vorticity / ln;
      if (CPU) {
        fx = -fx * s;
        fy = -fy * s;
      } else {
        fx = fx * s;
        fy = fy * s;
      }
      ou[j] = at(uc, j) + fx * dt;
      ov[j] = at(vc, j) + fy * dt;
    }
    const size_t o = static_cast<size_t>(gy) * w + gx;
    if (vec) {
      st4(u2 + o, make_float4(ou[0], ou[1], ou[2], ou[3]));
      st4(v2 + o, make_float4(ov[0], ov[1], ov[2], ov[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gx + j < w) {
          u2[o + j] = ou[j];
          v2[o + j] = ov[j];
        }
      }
    }
  }
}

// Member strides (floats) of u, v, u2, v2; prm: row b holds member b's dt
// (row stride prm_stride), or null for the dt given by value.
struct VortMembers {
  int nb;
  long long u, v, u2, v2;
  const float* prm;
  int prm_stride;
};

// BATCH false (a single call) is member 0's tile alone, dt by value.
template <bool CPU, bool BATCH>
__global__ void __launch_bounds__(VORT_THREADS)
    vorticity_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     float* __restrict__ u2, float* __restrict__ v2, int h, int w,
                     int vec, float dt, float vorticity, VortMembers m) {
  __shared__ __align__(16) VortTile t;
  if (!BATCH) {
    vorticity_tile<CPU>(t, u, v, u2, v2, h, w, vec, dt, vorticity, threadIdx.x);
    return;
  }
  // one member at a time, the body's shape opaque (fluid_opaque)
#pragma unroll 1
  for (int b = blockIdx.z; b < m.nb; b += gridDim.z) {
    const float bdt = m.prm != nullptr ? m.prm[static_cast<size_t>(b) * m.prm_stride] : dt;
    vorticity_tile<CPU>(t, u + b * m.u, v + b * m.v, u2 + b * m.u2, v2 + b * m.v2,
                        fluid_opaque(h), fluid_opaque(w), vec, bdt, vorticity,
                        fluid_opaque(threadIdx.x));
    __syncthreads();  // the tile's shared memory, before the next member's fill
  }
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// u, v in, u2, v2 out: member 0's planes; nb members, each array's member
// stride (floats) u_ms, v_ms, u2_ms, v2_ms; prm: nb rows of [dt, ...] in
// device memory, prm_stride floats apart, or null for dt.  The 16-byte path
// needs W % 4 == 0, every plane of every member 16-byte aligned.
FLUID_API int fluid_vorticity(const float* u, const float* v, float* u2,
                              float* v2, int h, int w, int cpu_variant,
                              float dt, float vorticity, int nb, long long u_ms,
                              long long v_ms, long long u2_ms, long long v2_ms,
                              const float* prm, int prm_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || nb < 1) return cudaErrorInvalidValue;
  if (prm != nullptr && prm_stride < 1) return cudaErrorInvalidValue;
  const bool strides4 = nb == 1 || (u_ms % 4 == 0 && v_ms % 4 == 0 && u2_ms % 4 == 0 &&
                                    v2_ms % 4 == 0);
  const int vec = w % 4 == 0 && strides4 && aligned16(u) && aligned16(v) && aligned16(u2) &&
                  aligned16(v2);
  const VortMembers m = {nb, u_ms, v_ms, u2_ms, v2_ms, prm, prm_stride};
  const dim3 grid((w + VORT_TW - 1) / VORT_TW, (h + VORT_TH - 1) / VORT_TH,
                  fluid_grid_z(nb));
  const bool batch = nb > 1 || prm != nullptr;
  if (cpu_variant && batch)
    vorticity_kernel<true, true><<<grid, VORT_THREADS, 0, s>>>(u, v, u2, v2, h, w, vec, dt,
                                                               vorticity, m);
  else if (cpu_variant)
    vorticity_kernel<true, false><<<grid, VORT_THREADS, 0, s>>>(u, v, u2, v2, h, w, vec, dt,
                                                                vorticity, m);
  else if (batch)
    vorticity_kernel<false, true><<<grid, VORT_THREADS, 0, s>>>(u, v, u2, v2, h, w, vec, dt,
                                                                vorticity, m);
  else
    vorticity_kernel<false, false><<<grid, VORT_THREADS, 0, s>>>(u, v, u2, v2, h, w, vec,
                                                                 dt, vorticity, m);
  return cudaGetLastError();
}

// fluid_vorticity's parameters as one record, in their order: a prepared
// launch (ops/jacobi_cuda.py VortArgs, which mirrors this layout) fills it
// once and sets only the fields that change before each call.
struct FluidVorticityArgs {
  const float *u, *v;
  float *u2, *v2;
  int h, w, cpu_variant;
  float dt, vorticity;
  int nb;
  long long u_ms, v_ms, u2_ms, v2_ms;
  const float* prm;
  int prm_stride;
  void* stream;
};
static_assert(sizeof(FluidVorticityArgs) == 112, "ops/jacobi_cuda.py VortArgs mirrors it");

FLUID_API int fluid_vorticity_args(const FluidVorticityArgs* a) {
  return fluid_vorticity(a->u, a->v, a->u2, a->v2, a->h, a->w, a->cpu_variant, a->dt,
                         a->vorticity, a->nb, a->u_ms, a->v_ms, a->u2_ms, a->v2_ms, a->prm,
                         a->prm_stride, a->stream);
}
