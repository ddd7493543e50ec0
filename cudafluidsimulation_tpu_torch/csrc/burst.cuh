// Trapezoid temporal blocking shared by H3 (diffuse.cu) and H4
// (pressure.cu): one block per output tile, `depth` clamped 5-point sweeps
// on the tile plus a halo ring held in shared memory.
//
// A launch (one burst) gives each block a tile of tile_h x tile_w cells.
// The block loads the region tile +- halo (clipped to the grid) from device
// memory once, then runs its sweeps between two shared buffers.  Sweep s
// (1-based) computes tile +- (halo - s), clipped: one ring less each sweep,
// and each cell reads only cells the sweep before computed.  A cell's taps
// clamp against the grid, not the region: where the region meets a
// physical edge it holds the true edge cells, so the clamp is the plain
// version's own, and the region does not shrink there.  Where the region
// ends inside the grid, no tap ever reads past it.  So after `depth <=
// halo` sweeps the tile (and halo - depth rings around it) holds exactly
// the global iterate, at any depth, with no ghost cells: the Pallas
// kernels' mirror ghosts and edge fixes are not needed.
//
// Threads: blockDim = (32, BURST_NY).  In a sweep, a warp takes 128
// neighbouring columns of one row band and each thread 4 of them: per row
// it loads the row above as one 16-byte shared load (the rows at and below
// are in registers), gets its outer left and right taps from the
// neighbouring lanes by shuffle, and stores 16 bytes, about ten
// instructions a cell.  The band height is the region's rows over
// BURST_NY, so the threads stay busy as the region shrinks.  With tiles
// 112 wide and halos up to 8, every sweep's span fits one warp's 128
// columns.
#pragma once

#include <stdint.h>

#include "fluid_common.cuh"

#define BURST_NY 8
#define BURST_THREADS (32 * BURST_NY)

// Columns of padding left of the tile in a shared row: the halo rounded up
// to 4 floats (no deeper than the grid is wide), so the tile starts on a
// 16-byte boundary of every row.
static __host__ __device__ __forceinline__ int burst_pad(int w, int halo) {
  return ((halo < w ? halo : w) + 3) & ~3;
}

// Shared row stride (floats) and rows of one buffer, the same for every
// block of a launch.
static __host__ __device__ __forceinline__ int burst_stride(int w, int tile_w,
                                                           int halo) {
  return (((tile_w < w ? tile_w : w) + 3) & ~3) + 2 * burst_pad(w, halo);
}

static __host__ __device__ __forceinline__ int burst_rows(int h, int tile_h,
                                                         int halo) {
  const int n = tile_h + 2 * halo;
  return n < h ? n : h;
}

static inline size_t burst_smem_bytes(int nbuf, int h, int w, int tile_h,
                                      int tile_w, int halo) {
  return sizeof(float) * nbuf * burst_rows(h, tile_h, halo) *
         burst_stride(w, tile_w, halo);
}

// Grid of one burst: one block per tile (times z planes).
static inline dim3 burst_grid(int h, int w, int tile_h, int tile_w, int z = 1) {
  return dim3((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, z);
}

// Allow `bytes` of dynamic shared memory (above 48 KB only on request: the
// device's cap, fluid_allow_smem) and prefer the largest shared carveout,
// so several blocks fit on an SM.
template <class K>
static inline cudaError_t burst_allow_smem(K kernel, size_t bytes) {
  return fluid_allow_smem(kernel, bytes, cudaSharedmemCarveoutMaxShared);
}

// This block's tile and where its buffers sit: buffer cell (r, c) is
// global (y0 + r, ox + c); rows y0..y1 (tile +- halo, clipped) are loaded.
struct BurstTile {
  int tx0, tx1, ty0, ty1;  // the tile, clipped to the grid
  int ox, y0, y1;          // ox = tx0 - pad, may be negative
  int stride;
};

__device__ __forceinline__ BurstTile burst_tile(int h, int w, int tile_h,
                                                int tile_w, int halo) {
  BurstTile t;
  t.tx0 = blockIdx.x * tile_w;
  t.tx1 = min(t.tx0 + tile_w, w);
  t.ty0 = blockIdx.y * tile_h;
  t.ty1 = min(t.ty0 + tile_h, h);
  t.ox = t.tx0 - burst_pad(w, halo);
  t.y0 = max(t.ty0 - halo, 0);
  t.y1 = min(t.ty1 + halo, h);
  t.stride = burst_stride(w, tile_w, halo);
  return t;
}

// Copy plane g's rows y0..y1, over the buffer's width clipped to the grid,
// into buf: 16-byte loads when the rows and the start are 16-byte aligned
// (the last load of a row may run past the buffer's columns, never past the
// row or the buffer's stride), else one float a thread, 32 columns a warp.
__device__ __forceinline__ void burst_fill(float* buf,
                                           const float* __restrict__ g,
                                           int w, const BurstTile& t) {
  const int gx0 = max(t.ox, 0), c0 = gx0 - t.ox;
  const int nc = min(t.ox + t.stride, w) - gx0, nr = t.y1 - t.y0;
  if ((w & 3) == 0 && (gx0 & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int nv = (nc + 3) >> 2;
    const int tid = threadIdx.y * 32 + threadIdx.x;
    for (int i = tid; i < nr * nv; i += BURST_THREADS) {
      const int r = i / nv, c = (i - r * nv) << 2;
      const float4 val = __ldg(reinterpret_cast<const float4*>(
          g + static_cast<size_t>(t.y0 + r) * w + gx0 + c));
      *reinterpret_cast<float4*>(buf + r * t.stride + c0 + c) = val;
    }
    return;
  }
  for (int r = threadIdx.y; r < nr; r += BURST_NY)
    for (int c = threadIdx.x; c < nc; c += 32)
      buf[r * t.stride + c0 + c] = __ldg(g + static_cast<size_t>(t.y0 + r) * w + gx0 + c);
}

// Buffer bounds of tile +- grow, clipped to the grid.
struct BurstSpan {
  int c0, c1, r0, r1;
};

__device__ __forceinline__ BurstSpan burst_span(const BurstTile& t, int h,
                                                int w, int grow) {
  return {max(t.tx0 - grow, 0) - t.ox, min(t.tx1 + grow, w) - t.ox,
          max(t.ty0 - grow, 0) - t.y0, min(t.ty1 + grow, h) - t.y0};
}

__device__ __forceinline__ float4 burst_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void burst_st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ bool burst_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Visit tile +- grow in 4-column groups of buffer src:
//   visit(r, c, on, left, right, below, above, centre)
// for the group of cells (r, c..c+3), each argument a float4 of the four
// cells' taps, clamped against the grid.  `on` is false for a lane whose
// group lies past the span (its taps are garbage); a group that is on may
// still hold cells outside the span, whose taps are garbage too.  Groups
// start on the 4-column grid of the buffer.  A warp takes 128 columns of
// one row band, a thread 4 columns of it; the thread keeps the rows
// below, at and above in registers, and gets its outer left and right
// taps from the neighbouring lanes (lanes 0 and 31 from shared memory).
// No barrier inside.
template <class Visit>
__device__ __forceinline__ void burst_visit(const float* __restrict__ src,
                                            int h, int w, const BurstTile& t,
                                            int grow, Visit visit) {
  const BurstSpan sp = burst_span(t, h, w, grow);
  const int band = (sp.r1 - sp.r0 + BURST_NY - 1) / BURST_NY;
  const int r0 = sp.r0 + threadIdx.y * band;
  const int r1 = min(r0 + band, sp.r1);
  if (r0 >= r1) return;  // the same for the whole warp
  const int s = t.stride, lane = threadIdx.x;
  // buffer rows of the grid's first and last rows: the clamp of a tap
  const int rlo = -t.y0, rhi = h - 1 - t.y0;
  for (int cb = sp.c0 & ~3; cb < sp.c1; cb += 128) {
    const int cg = cb + 4 * lane;
    const bool on = cg < sp.c1;
    // a lane past the span still reads its own columns (its left neighbour
    // takes its first one as a right tap); past the buffer, its last ones
    const int c = min(cg, s - 4);
    const int gx = t.ox + c;
    const bool first_col = gx == 0;
    const int last_col = w - 1 - gx;  // which of the 4 is the grid's last
    const int cl = max(c - 1, 0), cr = min(c + 4, s - 1);
    float4 dn = burst_ld4(src + max(r0 - 1, rlo) * s + c);
    float4 ce = burst_ld4(src + r0 * s + c);
    for (int r = r0; r < r1; ++r) {
      const float4 up = burst_ld4(src + min(r + 1, rhi) * s + c);
      float left = __shfl_up_sync(0xffffffffu, ce.w, 1);
      float right = __shfl_down_sync(0xffffffffu, ce.x, 1);
      if (lane == 0) left = src[r * s + cl];
      if (lane == 31) right = src[r * s + cr];
      if (first_col) left = ce.x;
      const float4 l = make_float4(left, ce.x, ce.y, ce.z);
      const float4 rt = make_float4(last_col == 0 ? ce.x : ce.y,
                                    last_col == 1 ? ce.y : ce.z,
                                    last_col == 2 ? ce.z : ce.w,
                                    last_col == 3 ? ce.w : right);
      visit(r, c, on, l, rt, dn, up, ce);
      dn = ce;
      ce = up;
    }
  }
}

// A 5-point op applied to each of a group's four cells: op(left, right,
// below, above, centre, aux) with aux a fifth float4 (the divergence for
// the pressure sweep).
template <class Op>
__device__ __forceinline__ float4 burst_map4(Op op, float4 l, float4 r, float4 b,
                                             float4 t, float4 c, float4 a) {
  return make_float4(op(l.x, r.x, b.x, t.x, c.x, a.x), op(l.y, r.y, b.y, t.y, c.y, a.y),
                     op(l.z, r.z, b.z, t.z, c.z, a.z), op(l.w, r.w, b.w, t.w, c.w, a.w));
}

// Store a group's cells that lie in the tile into a device plane (global
// row gy, columns gx..gx+3): 16 bytes when the group is whole and aligned,
// else cell by cell.
__device__ __forceinline__ void burst_store_tile(float* plane, int w,
                                                 const BurstTile& t, int gy,
                                                 int gx, float4 v) {
  float* p = plane + static_cast<size_t>(gy) * w + gx;
  if (gx + 3 < t.tx1 && burst_aligned(p)) {
    burst_st4(p, v);
    return;
  }
  if (gx < t.tx1) p[0] = v.x;
  if (gx + 1 < t.tx1) p[1] = v.y;
  if (gx + 2 < t.tx1) p[2] = v.z;
  if (gx + 3 < t.tx1) p[3] = v.w;
}

// Load a group of a device plane, cells past the tile read as 0.
__device__ __forceinline__ float4 burst_load_tile(const float* __restrict__ plane,
                                                  int w, const BurstTile& t,
                                                  int gy, int gx) {
  const float* p = plane + static_cast<size_t>(gy) * w + gx;
  if (gx + 3 < t.tx1 && burst_aligned(p)) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(gx < t.tx1 ? p[0] : 0.f, gx + 1 < t.tx1 ? p[1] : 0.f,
                     gx + 2 < t.tx1 ? p[2] : 0.f, gx + 3 < t.tx1 ? p[3] : 0.f);
}

// Copy the tile's cells of buffer buf into a device plane.
__device__ __forceinline__ void burst_copy_tile(float* plane, const float* buf,
                                                int w, const BurstTile& t) {
  const int c0 = t.tx0 - t.ox, c1 = t.tx1 - t.ox;
  for (int y = t.ty0 + threadIdx.y; y < t.ty1; y += BURST_NY)
    for (int c = c0 + 4 * threadIdx.x; c < c1; c += 128)
      burst_store_tile(plane, w, t, y, t.ox + c, burst_ld4(buf + (y - t.y0) * t.stride + c));
}
