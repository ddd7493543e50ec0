// H1 and H8: semi-Lagrangian advection, a run of cells of one row a thread.
//
// H1 replaces cudafluidsimulation_tpu/ops/advect_pallas.py _advect_kernel
// and _advect_kernel_tiled (cores _advect_core, _advect_core_static, and
// _emit_stats).  The TPU kernel rewrites the gather as a shift-accumulation
// over a bounded displacement window because the TPU has no fast gather;
// here each thread backtraces its cells, truncates the corner toward zero
// (so negative coordinates extrapolate), clamps four taps to the domain and
// blends them, as ops/ref.py bilerp does.  The backtrace is unbounded.
//
// H8 (packed != 0) replaces the bf16-tap cores _advect_core_packed (dye)
// and _advect_core_packed_vel (velocity) and the dispatch around them
// (_fast_path_ok, the lax.cond in _advect_flat and _advect_tiled).  The
// TPU kernels pack the tap planes into bf16 to halve the volume of their
// rolls; the card gathers, so H8 keeps H1's gather and rounds each tap
// value as it is loaded, as bits(x) + 0x8000 masked to the top 16 bits
// (round half up in magnitude, not to nearest even).  Velocity rounds u and
// v; dye rounds channels 0 and 1, keeps channel 2 in f32, and clamps the
// blend to >= 0 before the pow (acc < 0 ? 0 : acc, which lets a NaN through
// to fminf's saturation, as jnp.maximum does).  A step whose bound
// [max|u|, max|v|] times dt is under one cell on both axes takes the exact
// branch, which is H1's arithmetic bit for bit; the bound is read on the
// device, so the branch costs no host read.
//
// The entry fluid_advect_rows runs one of three modes:
//   velocity (1): u, v -> u', v', and [max|u'|, max|v'|] into stats;
//   dye (2):      C dye planes through the advected u', v' -> C planes;
//   both (3):     H1's velocity and dye in one launch, the step's call.
// Bound by bytes: each input read once, each output written once; the taps
// sit near the cell and hit L1/L2.  Velocity moves 4 planes (u, v in, u',
// v' out), dye 2 + 2C (u', v' and the dye in, the dye out), both 4 + 2C:
// the dye's backtrace reads u', v' only at its own cell, which the thread
// has just computed, so the fused launch reads neither back and writes
// them once (10 planes for 3 dye channels, against 12 for the two passes).
// H8's dye stays a pass of its own: its quiet branch reads the grid-wide
// max of u', v' (vel_stats, the lax.cond of the JAX package), which no
// block knows before every block of the velocity pass has finished.
//
// The design against that bound (ADVECT_CELLS, ADVECT_ROWS, ADVECT_TILES;
// PERF.md keeps the variants measured against it):
// - Each thread takes 4 consecutive cells of a row, a block 32 threads by
//   8 rows; where every plane's rows start on 16 bytes and the width is a
//   multiple of 4, u, v, u', v' and the dye move as one 16-byte access a
//   plane, else a scalar access a cell (the ragged edge, odd widths,
//   unaligned planes).  The gathers of all the thread's cells are
//   independent, so more bytes are in flight.
// - A block walks up to 4 tiles of rows (gridDim.y tiles apart; one where
//   the grid covers the rows), and each thread loads the next tile's u, v
//   before it computes this one's, so the stream's latency hides behind the
//   gathers; the dye's lines at the thread's cells are prefetched into L1
//   before the velocity is computed, so the dye's gathers, which wait on
//   u', v', mostly hit L1.
// - The velocity bound: each block reduces its cells' [max|u'|, max|v'|]
//   (NaN kept: fluid_nanmax) by warp shuffles into its own slot of
//   `slots`, then makes one arrival atomic on its member's count, in place
//   of two atomicMax a block on the member's two stats and a memset before
//   the launch; the last block of the member to arrive reduces the
//   member's slots into stats[2b..2b+1] and resets the count to 0.  So the
//   bound is the exact max.  The counts are the caller's: zero before the
//   launch, one int a member, and not shared with a launch that may overlap
//   this one (the wrapper keeps them per stream).

// Members: a batch of independent members (ensembles, the analog of the
// JAX package's vmap): member b = blockIdx.z (and every gridDim.z after it)
// reads its planes at b times each array's member stride, its dt and decay
// from row b of a device array when one is given, reduces into stats[2b..
// 2b+1] and decides H8's quiet branch from bound[2b..2b+1] and its own dt.
// A single call is the case B = 1 with the scalars by value; it compiles
// without the member loop (the BATCH template flag).
//
// The two passes apart (modes 1 and 2) serve the fast modes (H8), the
// decomposed stage report and the checks that hold the fused launch to
// them bit for bit.
//
// The window entry (fluid_advect_window, H1, or H8 with packed) serves the
// sharded rollout (the port's parallel/shardmap_step.py and shardmap2d.py),
// which advects each shard on a halo-padded local view, as the JAX package's
// sharded step calls advect_pallas.advect with y0, h_phys, x0, w_phys and
// d_x (advect_pallas.py _tap_setup).  A thread takes one cell of the view's
// interior (rows [yi, yi + h), columns [d_x, d_x + w); yi is d in a padded
// view), backtraces from the cell's global coordinates, truncates the corner
// toward zero, clamps it to the physical grid [0, h_phys - 1] x
// [0, w_phys - 1], bounds the tap's offset from the cell to +-d rows (and
// +-d_x columns when d_x > 0), and reads the tap in the padded planes.  The
// global step of the port's parallel/sharded.py passes the whole grid's
// rows as the view, the shard's first row as yi and d = h_phys, which no
// clamped tap reaches: its rows are unbounded.  The halo rows are never written: the
// TPU kernel advects the whole padded view and its caller slices the
// interior, which gives the same cells.  The velocity bound covers the
// interior alone, the cells the caller keeps (a block max and an atomic
// max a block, its stats zeroed first).
#include <stdint.h>

#include <initializer_list>

#include "fluid_common.cuh"

// The row kernels' design: cells a thread along a row, rows of 32 threads a
// block, tiles of rows a block walks (ops/advect_cuda.py mirrors them to
// size the bound's slots).
#define ADVECT_CELLS 4
#define ADVECT_ROWS 8
#define ADVECT_TILES 4

struct Planes {
  const float* in[3];
  float* out[3];
};

// bits(x) + 0x8000, & 0xFFFF0000, in unsigned arithmetic (wraps)
__device__ __forceinline__ float bf16_tap(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x8000u) & 0xFFFF0000u);
}

// The bilinear blend of plane f at four flat indices by the fractions tx,
// ty, each tap rounded first when round.
__device__ __forceinline__ float tap_blend(const float* f, int i00, int i01, int i10,
                                           int i11, float tx, float ty, bool round) {
  float f00 = __ldg(f + i00), f01 = __ldg(f + i01);
  float f10 = __ldg(f + i10), f11 = __ldg(f + i11);
  if (round) {
    f00 = bf16_tap(f00);
    f01 = bf16_tap(f01);
    f10 = bf16_tap(f10);
    f11 = bf16_tap(f11);
  }
  const float top = f00 * (1.f - tx) + f01 * tx;
  const float bot = f10 * (1.f - tx) + f11 * tx;
  return top * (1.f - ty) + bot * ty;
}

// The dye's fade of a blend, clamped to >= 0 first when clamp.
__device__ __forceinline__ float dye_fade(float s, float decay, bool clamp) {
  if (clamp) s = s < 0.f ? 0.f : s;
  // fminf(1, NaN) == 1: a negative extrapolated sample saturates
  return fminf(1.f, powf(s, 1.005f) * decay);
}

// The blend of one cell's four taps (flat indices i00..i11 into the field
// planes) by the fractions tx, ty, into output index io: bit ch of
// round_mask rounds channel ch's taps; clamp clamps the dye blend to >= 0.
// Writes the outputs and sets mu, mv to |u'|, |v'| in the velocity mode.
template <bool DYE>
__device__ __forceinline__ void advect_blend(
    const Planes& planes, int c, int i00, int i01, int i10, int i11, float tx,
    float ty, int io, float decay, unsigned round_mask, bool clamp, float& mu,
    float& mv) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    if (ch >= c) break;
    const float s = tap_blend(planes.in[ch], i00, i01, i10, i11, tx, ty,
                              (round_mask >> ch) & 1u);
    float r;
    if (DYE) {
      r = dye_fade(s, decay, clamp);
    } else {
      r = s * decay;
      if (ch == 0) mu = fabsf(r);
      if (ch == 1) mv = fabsf(r);
    }
    planes.out[ch][io] = r;
  }
}

// The four clamped taps of cell (x, y) with velocity (uc, vc): flat
// indices into an (h, w) plane and the corner's fractions.
struct Taps {
  int i00, i01, i10, i11;
  float tx, ty;
};

__device__ __forceinline__ Taps cell_taps(int x, int y, float uc, float vc, float dt,
                                          int h, int w) {
  // departure point pos - dt*vel (GPUFluidSim.cu:267)
  const float px = static_cast<float>(x) - dt * uc;
  const float py = static_cast<float>(y) - dt * vc;
  const float x1 = truncf(px);
  const float y1 = truncf(py);
  const float wm = static_cast<float>(w - 1);
  const float hm = static_cast<float>(h - 1);
  const int xi1 = static_cast<int>(fminf(fmaxf(x1, 0.f), wm));
  const int xi2 = static_cast<int>(fminf(fmaxf(x1 + 1.f, 0.f), wm));
  const int yi1 = static_cast<int>(fminf(fmaxf(y1, 0.f), hm));
  const int yi2 = static_cast<int>(fminf(fmaxf(y1 + 1.f, 0.f), hm));
  return {yi1 * w + xi1, yi1 * w + xi2, yi2 * w + xi1, yi2 * w + xi2, px - x1, py - y1};
}

__device__ __forceinline__ float blend_at(const float* f, const Taps& t, bool round) {
  return tap_blend(f, t.i00, t.i01, t.i10, t.i11, t.tx, t.ty, round);
}

// The 4 floats of a row from column x0 < w: one 16-byte access when VEC
// (the row starts aligned and w % 4 == 0), else 4 scalar ones, cells at or
// past w left 0.
static_assert(ADVECT_CELLS == 4, "the row accesses are float4");

template <bool VEC>
__device__ __forceinline__ void load_row(float (&r)[ADVECT_CELLS], const float* p, int x0,
                                         int w) {
  if constexpr (VEC) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + x0));
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < ADVECT_CELLS; ++k) r[k] = x0 + k < w ? __ldg(p + x0 + k) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_row(float* p, const float (&r)[ADVECT_CELLS], int x0,
                                          int w) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p + x0) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < ADVECT_CELLS; ++k)
      if (x0 + k < w) p[x0 + k] = r[k];
  }
}

// Bring the line of p into L1 ahead of the gathers that will read it.
__device__ __forceinline__ void prefetch_l1(const float* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

enum : int { MODE_VELOCITY = 1, MODE_DYE = 2, MODE_BOTH = 3 };

// What one launch reads and writes, member 0's planes: the velocity the
// cells backtrace through (u, v), the advected velocity (ou, ov: written
// by the velocity and both modes), and c dye planes in and out.
struct Rows {
  const float* u;
  const float* v;
  float* ou;
  float* ov;
  const float* din[3];
  float* dout[3];
  int c;
};

// Member strides (floats) of u, v, u' and v' (one stride), the dye in and
// out; prm: row b holds member b's [dt, decay] (row stride prm_stride), or
// null for the dt and decay given by value.
struct Members {
  int nb;
  long long u, v, ouv, din, dout;
  const float* prm;
  int prm_stride;
};

// The velocity bound: stats (2 floats a member, null: none), a slot a
// block a member, an arrival count a member.
struct Bound {
  float* stats;
  float2* slots;
  unsigned* counts;
};

__device__ __forceinline__ void warp_max2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = fluid_nanmax(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = fluid_nanmax(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
}

// Member b's bound: the block's max of (a, c) over its threads into its own
// slot; the member's last block to arrive reduces every slot of the member
// into stats[2b..2b+1] and resets the member's count.  Every thread of the
// block calls it; blockDim.x is 32.
__device__ __forceinline__ void block_bound(float a, float c, const Bound& bd, int b) {
  __shared__ float sa[32], sc[32];
  __shared__ bool last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int nblk = gridDim.x * gridDim.y;
  warp_max2(a, c);
  if ((tid & 31) == 0) {
    sa[tid >> 5] = a;
    sc[tid >> 5] = c;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < nthreads / 32; ++i) {
      a = fluid_nanmax(a, sa[i]);
      c = fluid_nanmax(c, sc[i]);
    }
    bd.slots[static_cast<size_t>(b) * nblk + blockIdx.y * gridDim.x + blockIdx.x] =
        make_float2(a, c);
    __threadfence();  // the slot, before the count that publishes it
    last = atomicAdd(bd.counts + b, 1u) == static_cast<unsigned>(nblk - 1);
  }
  __syncthreads();
  if (last) {  // uniform across the block
    __threadfence();
    const float2* s = bd.slots + static_cast<size_t>(b) * nblk;
    a = 0.f;
    c = 0.f;
    for (int i = tid; i < nblk; i += nthreads) {
      const float2 q = __ldcg(s + i);  // from L2: other blocks wrote them
      a = fluid_nanmax(a, q.x);
      c = fluid_nanmax(c, q.y);
    }
    warp_max2(a, c);
    if ((tid & 31) == 0) {
      sa[tid >> 5] = a;
      sc[tid >> 5] = c;
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 1; i < nthreads / 32; ++i) {
        a = fluid_nanmax(a, sa[i]);
        c = fluid_nanmax(c, sc[i]);
      }
      bd.stats[2 * b] = a;
      bd.stats[2 * b + 1] = c;
      bd.counts[b] = 0u;  // for the next launch on the stream
    }
  }
  __syncthreads();  // sa, sc and last, before the next member's
}

// MODE (velocity, dye or both) over ADVECT_CELLS cells a thread; VEC: the
// 16-byte row accesses; BATCH false (a single call) compiles the member
// loop away.  A block walks the tiles gridDim.y apart, each thread loading
// the next tile's u, v before it computes this one's; in the dye modes it
// brings the dye's lines at its cells into L1 before the gathers.
// bound: the device [max|u|, max|v|] of each member that decides H8's
// quiet branch (read when packed and fast_path).
template <int MODE, bool VEC, bool BATCH>
__global__ void __launch_bounds__(32 * ADVECT_ROWS)
    advect_rows_kernel(Rows r, Members m, Bound bd, const float* __restrict__ bound, int h,
                       int w, float dt, float decay, int packed, int fast_path) {
  constexpr int K = ADVECT_CELLS;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * K;
  const int y0 = blockIdx.y * blockDim.y + threadIdx.y;
  const int ystep = gridDim.y * blockDim.y;
  const int nb = BATCH ? m.nb : 1;
  // one member at a time
#pragma unroll 1
  for (int b = BATCH ? blockIdx.z : 0; b < nb; b += BATCH ? gridDim.z : 1) {
    float bdt = dt, bdecay = decay;
    if (BATCH && m.prm != nullptr) {
      bdt = m.prm[static_cast<size_t>(b) * m.prm_stride];
      bdecay = m.prm[static_cast<size_t>(b) * m.prm_stride + 1];
    }
    unsigned mask = 0u;
    bool clamp = false;
    if (packed) {
      // uniform across the member's blocks: realized displacement under one cell
      const bool quiet =
          fast_path && bound[2 * b] * bdt < 1.f && bound[2 * b + 1] * bdt < 1.f;
      mask = quiet ? 0u : 3u;
      clamp = MODE == MODE_DYE && !quiet;
    }
    float mu = 0.f, mv = 0.f;
    if (x0 < w && y0 < h) {
      const float* u = r.u + b * m.u;
      const float* v = r.v + b * m.v;
      float uu[K], vv[K];
      load_row<VEC>(uu, u + static_cast<size_t>(y0) * w, x0, w);
      load_row<VEC>(vv, v + static_cast<size_t>(y0) * w, x0, w);
#pragma unroll 1
      for (int y = y0; y < h; y += ystep) {
        const size_t row = static_cast<size_t>(y) * w;
        float nu[K], nv[K];
        if (y + ystep < h) {
          load_row<VEC>(nu, u + row + static_cast<size_t>(ystep) * w, x0, w);
          load_row<VEC>(nv, v + row + static_cast<size_t>(ystep) * w, x0, w);
        }
        if (MODE & MODE_DYE) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            if (ch >= r.c) break;
            prefetch_l1(r.din[ch] + b * m.din + row + x0);
          }
        }
        if (MODE & MODE_VELOCITY) {
          float ou[K], ov[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            ou[k] = 0.f;
            ov[k] = 0.f;
            if (VEC || x0 + k < w) {
              const Taps t = cell_taps(x0 + k, y, uu[k], vv[k], bdt, h, w);
              ou[k] = blend_at(u, t, mask & 1u) * bdecay;
              ov[k] = blend_at(v, t, (mask >> 1) & 1u) * bdecay;
              mu = fluid_nanmax(mu, fabsf(ou[k]));
              mv = fluid_nanmax(mv, fabsf(ov[k]));
            }
          }
          store_row<VEC>(r.ou + b * m.ouv + row, ou, x0, w);
          store_row<VEC>(r.ov + b * m.ouv + row, ov, x0, w);
          if (MODE == MODE_BOTH) {
            // the dye backtraces through the advected velocity: these very
            // floats, which the two-pass form writes and reads back
#pragma unroll
            for (int k = 0; k < K; ++k) {
              uu[k] = ou[k];
              vv[k] = ov[k];
            }
          }
        }
        if (MODE & MODE_DYE) {
          float od[3][K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) od[ch][k] = 0.f;
            if (VEC || x0 + k < w) {
              const Taps t = cell_taps(x0 + k, y, uu[k], vv[k], bdt, h, w);
#pragma unroll
              for (int ch = 0; ch < 3; ++ch)
                if (ch < r.c)
                  od[ch][k] = dye_fade(blend_at(r.din[ch] + b * m.din, t, (mask >> ch) & 1u),
                                       bdecay, clamp);
            }
          }
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            if (ch < r.c) store_row<VEC>(r.dout[ch] + b * m.dout + row, od[ch], x0, w);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          uu[k] = nu[k];
          vv[k] = nv[k];
        }
      }
    }
    if ((MODE & MODE_VELOCITY) && bd.stats != nullptr) block_bound(mu, mv, bd, b);
  }
}

// [max|u|, max|v|] of each member into out[2b..2b+1] (zeroed first): H8's
// bound when the caller has none
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

// A launch's grid and scalars, past the template choices.
struct Launch {
  dim3 grid;
  cudaStream_t s;
  int h, w;
  float dt, decay;
  int packed, fast_path;
};

template <int MODE, bool VEC, bool BATCH>
static void launch_rows(const Launch& l, const Rows& r, const Members& m, const Bound& bd,
                        const float* bound) {
  const dim3 block(32, ADVECT_ROWS);
  advect_rows_kernel<MODE, VEC, BATCH><<<l.grid, block, 0, l.s>>>(
      r, m, bd, bound, l.h, l.w, l.dt, l.decay, l.packed, l.fast_path);
}

template <int MODE>
static void launch_rows(bool vec, bool batch, const Launch& l, const Rows& r, const Members& m,
                        const Bound& bd, const float* bound) {
  if (vec && batch)
    launch_rows<MODE, true, true>(l, r, m, bd, bound);
  else if (vec)
    launch_rows<MODE, true, false>(l, r, m, bd, bound);
  else if (batch)
    launch_rows<MODE, false, true>(l, r, m, bd, bound);
  else
    launch_rows<MODE, false, false>(l, r, m, bd, bound);
}

static bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The grid of a launch over (h, w): a bound needs grid.x * grid.y slots a
// member.
static dim3 rows_grid(int h, int w, int nb) {
  const int tiles_y = (h + ADVECT_ROWS - 1) / ADVECT_ROWS;
  return dim3((w + 32 * ADVECT_CELLS - 1) / (32 * ADVECT_CELLS),
              (tiles_y + ADVECT_TILES - 1) / ADVECT_TILES, fluid_grid_z(nb));
}

// mode 1 velocity: u, v -> ou, ov; stats (may be null) receives each
// member's [max|ou|, max|ov|], with slots (slot_count >= the launch's
// blocks times nb pairs of floats) and counts (nb ints, zero; left zero).
// mode 2 dye: c <= 3 planes d0..d2 -> o0..o2 through u, v (the advected
// velocity).  mode 3 both: u, v -> ou, ov as mode 1, then the dye through
// ou, ov as mode 2.  packed selects H8 (modes 1 and 2): fast_path != 0
// enables the quiet branch, decided from bound (device [max|u|, max|v|], 2
// floats a member) or, when bound is null, from the maxima of each member's
// u and v, reduced into scratch (2 floats a member) first.  nb members;
// u_ms, v_ms, ouv_ms, din_ms, dout_ms: member strides (floats) of u, v, ou
// and ov, d*, o*; prm: nb rows of [dt, decay] in device memory, prm_stride
// floats apart, or null for dt and decay (the only member when nb = 1).
FLUID_API int fluid_advect_rows(const float* u, const float* v, float* ou, float* ov,
                                const float* d0, const float* d1, const float* d2, float* o0,
                                float* o1, float* o2, const float* bound, float* scratch,
                                float* stats, float* slots, int* counts, int c, int h, int w,
                                int mode, int packed, int fast_path, float dt, float decay,
                                int nb, long long u_ms, long long v_ms, long long ouv_ms,
                                long long din_ms, long long dout_ms, const float* prm,
                                int prm_stride, long long slot_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode < MODE_VELOCITY || mode > MODE_BOTH || h < 1 || w < 1 || nb < 1)
    return cudaErrorInvalidValue;
  if ((mode & MODE_DYE) && (c < 1 || c > 3)) return cudaErrorInvalidValue;
  if ((mode & MODE_VELOCITY) && (ou == nullptr || ov == nullptr)) return cudaErrorInvalidValue;
  if (mode == MODE_BOTH && packed) return cudaErrorInvalidValue;
  if (prm != nullptr && prm_stride < 2) return cudaErrorInvalidValue;
  const dim3 grid = rows_grid(h, w, nb);
  const bool want_bound = (mode & MODE_VELOCITY) && stats != nullptr;
  if (want_bound && (slots == nullptr || counts == nullptr || !aligned_to(slots, 8) ||
                     slot_count < static_cast<long long>(grid.x) * grid.y * nb))
    return cudaErrorInvalidValue;
  const bool batch = nb > 1 || prm != nullptr;
  const Members m = {nb, u_ms, v_ms, ouv_ms, din_ms, dout_ms, prm, prm_stride};
  cudaError_t e;
  if (!packed || !fast_path) {
    bound = nullptr;
  } else if (bound == nullptr) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    e = cudaMemsetAsync(scratch, 0, 2 * sizeof(float) * nb, s);
    if (e != cudaSuccess) return e;
    const dim3 g2 = fluid_grid2d(h, w, fluid_grid_z(nb));
    const dim3 b2(FLUID_BX, FLUID_BY);
    if (batch)
      vel_bound_kernel<true><<<g2, b2, 0, s>>>(u, v, scratch, h, w, m);
    else
      vel_bound_kernel<false><<<g2, b2, 0, s>>>(u, v, scratch, h, w, m);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    bound = scratch;
  }
  const Rows r = {u, v, ou, ov, {d0, d1, d2}, {o0, o1, o2}, c};
  const Bound bd = {want_bound ? stats : nullptr, reinterpret_cast<float2*>(slots),
                    reinterpret_cast<unsigned*>(counts)};
  // every plane's rows start on 16 bytes (unused planes are null)
  bool vec = w % ADVECT_CELLS == 0;
  for (const void* p : {static_cast<const void*>(u), static_cast<const void*>(v),
                        static_cast<const void*>(ou), static_cast<const void*>(ov),
                        static_cast<const void*>(d0), static_cast<const void*>(d1),
                        static_cast<const void*>(d2), static_cast<const void*>(o0),
                        static_cast<const void*>(o1), static_cast<const void*>(o2)})
    vec = vec && aligned_to(p, 4 * ADVECT_CELLS);
  for (long long st : {u_ms, v_ms, ouv_ms, din_ms, dout_ms}) vec = vec && st % ADVECT_CELLS == 0;
  const Launch l = {grid, s, h, w, dt, decay, packed, fast_path};
  if (mode == MODE_VELOCITY)
    launch_rows<MODE_VELOCITY>(vec, batch, l, r, m, bd, bound);
  else if (mode == MODE_DYE)
    launch_rows<MODE_DYE>(vec, batch, l, r, m, bd, bound);
  else
    launch_rows<MODE_BOTH>(vec, batch, l, r, m, bd, bound);
  return cudaGetLastError();
}

// fluid_advect_rows's parameters as one record, in their order: a prepared
// launch (ops/advect_cuda.py RowsArgs, which mirrors this layout) fills it
// once and sets only the fields that change before each call.
struct FluidAdvectRowsArgs {
  const float *u, *v;
  float *ou, *ov;
  const float *d0, *d1, *d2;
  float *o0, *o1, *o2;
  const float* bound;
  float *scratch, *stats, *slots;
  int* counts;
  int c, h, w, mode, packed, fast_path;
  float dt, decay;
  int nb;
  long long u_ms, v_ms, ouv_ms, din_ms, dout_ms;
  const float* prm;
  int prm_stride;
  long long slot_count;
  void* stream;
};
static_assert(sizeof(FluidAdvectRowsArgs) == 232, "ops/advect_cuda.py RowsArgs mirrors it");

FLUID_API int fluid_advect_rows_args(const FluidAdvectRowsArgs* a) {
  return fluid_advect_rows(a->u, a->v, a->ou, a->ov, a->d0, a->d1, a->d2, a->o0, a->o1, a->o2,
                           a->bound, a->scratch, a->stats, a->slots, a->counts, a->c, a->h, a->w,
                           a->mode, a->packed, a->fast_path, a->dt, a->decay, a->nb, a->u_ms,
                           a->v_ms, a->ouv_ms, a->din_ms, a->dout_ms, a->prm, a->prm_stride,
                           a->slot_count, a->stream);
}

// Where a shard's padded view lies in the global grid (ops/ref.py Window):
// the global row and column of its (0, 0), the global extents, the bounds
// on a tap's offset (d_x 0: columns unbounded), the interior's first row
// in the view, the padded width (the field planes' row pitch) and the row
// pitch of u and v.
struct Window {
  int y0, x0, h_phys, w_phys, d, d_x, yi, fw, uw;
};

// One interior cell (x, y) of the window: padded coordinates (x + d_x,
// y + yi), global (x0 + x + d_x, y0 + y + yi); output index y * w + x.
template <bool DYE>
__device__ __forceinline__ void advect_cell_window(
    const Planes& planes, int c, const float* __restrict__ u,
    const float* __restrict__ v, const Window& g, int w, int x, int y,
    float dt, float decay, unsigned round_mask, bool clamp, float& mu,
    float& mv) {
  const int ly = y + g.yi, lx = x + g.d_x;
  const int gy = g.y0 + ly, gx = g.x0 + lx;
  const int iu = y * g.uw + x;
  const float px = static_cast<float>(gx) - dt * u[iu];
  const float py = static_cast<float>(gy) - dt * v[iu];
  const float x1 = truncf(px);
  const float y1 = truncf(py);
  const float tx = px - x1;
  const float ty = py - y1;
  const float wm = static_cast<float>(g.w_phys - 1);
  const float hm = static_cast<float>(g.h_phys - 1);
  const int cx1 = static_cast<int>(fminf(fmaxf(x1, 0.f), wm));
  const int cx2 = static_cast<int>(fminf(fmaxf(x1 + 1.f, 0.f), wm));
  const int cy1 = static_cast<int>(fminf(fmaxf(y1, 0.f), hm));
  const int cy2 = static_cast<int>(fminf(fmaxf(y1 + 1.f, 0.f), hm));
  const int ry1 = ly + min(max(cy1 - gy, -g.d), g.d);
  const int ry2 = ly + min(max(cy2 - gy, -g.d), g.d);
  int rx1, rx2;
  if (g.d_x > 0) {
    rx1 = lx + min(max(cx1 - gx, -g.d_x), g.d_x);
    rx2 = lx + min(max(cx2 - gx, -g.d_x), g.d_x);
  } else {
    rx1 = cx1 - g.x0;
    rx2 = cx2 - g.x0;
  }
  advect_blend<DYE>(planes, c, ry1 * g.fw + rx1, ry1 * g.fw + rx2,
                    ry2 * g.fw + rx1, ry2 * g.fw + rx2, tx, ty, y * w + x,
                    decay, round_mask, clamp, mu, mv);
}

// H1 (PACKED false) or H8 on the interior of a window; bound: the device
// [max|u|, max|v|] that decides H8's quiet branch (read when PACKED and
// fast_path); stats, when not null, receives [max|u'|, max|v'|] of the
// interior in the velocity mode.
template <bool DYE, bool PACKED>
__global__ void advect_window_kernel(Planes planes, int c,
                                     const float* __restrict__ u,
                                     const float* __restrict__ v,
                                     const float* __restrict__ bound,
                                     float* __restrict__ stats, int h, int w,
                                     float dt, float decay, int fast_path,
                                     Window g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  unsigned mask = 0u;
  bool clamp = false;
  if (PACKED) {
    const bool quiet = fast_path && bound[0] * dt < 1.f && bound[1] * dt < 1.f;
    mask = quiet ? 0u : 3u;
    clamp = DYE && !quiet;
  }
  float mu = 0.f, mv = 0.f;
  if (x < w && y < h)
    advect_cell_window<DYE>(planes, c, u, v, g, w, x, y, dt, decay, mask, clamp, mu, mv);
  if (!DYE && stats != nullptr) fluid_block_max2_atomic(mu, mv, stats);
}

// [max|u|, max|v|] of the (h, w) cells at row pitch uw into out[0..1]
// (zeroed first)
__global__ void window_bound_kernel(const float* __restrict__ u,
                                    const float* __restrict__ v,
                                    float* __restrict__ out, int h, int w, int uw) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  float a = 0.f, b = 0.f;
  if (x < w && y < h) {
    a = fabsf(u[y * uw + x]);
    b = fabsf(v[y * uw + x]);
  }
  fluid_block_max2_atomic(a, b, out);
}

// The window entry.  fields: c <= 3 padded planes f0..f2 of at least
// yi + h + d rows (h + 2d when yi = d) by fw columns, fw >= w + 2 d_x;
// outputs o0..o2: (h, w); u, v: the (h, w) cells' velocity at row pitch uw.
// y0, x0, h_phys, w_phys, d, d_x, yi: the window (ops/ref.py Window and
// window_rows; w_phys > 0).  With d_x = 0 the taps' columns
// are global ones shifted by -x0, so [0, w_phys) must lie within the view.
// packed selects H8 (fast_path, bound and scratch as fluid_advect_rows');
// stats (velocity mode, may be null) receives the interior's bound.
FLUID_API int fluid_advect_window(const float* f0, const float* f1, const float* f2,
                                  float* o0, float* o1, float* o2, const float* u,
                                  const float* v, const float* bound, float* scratch,
                                  float* stats, int c, int h, int w, int dye, int packed,
                                  int fast_path, float dt, float decay, int y0, int x0,
                                  int h_phys, int w_phys, int d, int d_x, int yi, int fw,
                                  int uw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > 3 || h < 1 || w < 1 || d < 0 || d_x < 0 || yi < 0 || h_phys < 1 ||
      w_phys < 1 || fw < w + 2 * d_x || uw < w)
    return cudaErrorInvalidValue;
  if (d_x == 0 && (x0 > 0 || w_phys - x0 > fw)) return cudaErrorInvalidValue;
  Planes planes = {{f0, f1, f2}, {o0, o1, o2}};
  const Window g = {y0, x0, h_phys, w_phys, d, d_x, yi, fw, uw};
  const dim3 block(FLUID_BX, FLUID_BY);
  const dim3 grid = fluid_grid2d(h, w);
  cudaError_t e;
  if (!packed || !fast_path) {
    bound = nullptr;
  } else if (bound == nullptr) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    e = cudaMemsetAsync(scratch, 0, 2 * sizeof(float), s);
    if (e != cudaSuccess) return e;
    window_bound_kernel<<<grid, block, 0, s>>>(u, v, scratch, h, w, uw);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    bound = scratch;
  }
  float* st = dye ? nullptr : stats;
  if (st != nullptr) {
    e = cudaMemsetAsync(st, 0, 2 * sizeof(float), s);
    if (e != cudaSuccess) return e;
  }
  if (dye && packed)
    advect_window_kernel<true, true><<<grid, block, 0, s>>>(planes, c, u, v, bound, st, h, w, dt,
                                                            decay, fast_path, g);
  else if (dye)
    advect_window_kernel<true, false><<<grid, block, 0, s>>>(planes, c, u, v, bound, st, h, w, dt,
                                                             decay, fast_path, g);
  else if (packed)
    advect_window_kernel<false, true><<<grid, block, 0, s>>>(planes, c, u, v, bound, st, h, w, dt,
                                                             decay, fast_path, g);
  else
    advect_window_kernel<false, false><<<grid, block, 0, s>>>(planes, c, u, v, bound, st, h, w,
                                                              dt, decay, fast_path, g);
  return cudaGetLastError();
}
