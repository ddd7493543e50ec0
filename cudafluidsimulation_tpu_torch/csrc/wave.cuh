// The row-streaming wavefront's geometry and its ring of input rows, shared
// by H3 (diffuse.cu) and H4 (pressure.cu).
//
// A pass carries its sweeps down a column strip in one warp's registers:
// lane l owns V neighbouring columns, and the warp marches down a chunk of
// rows, one row a step.  A strip's outer columns go stale one column a
// sweep (a lane at a strip's edge takes its neighbour's stale column), so a
// strip of 32 V columns keeps the 32 V - 2 reach in its middle, where reach
// is the most columns the pass's stencils reach in (at a physical edge the
// clamp is true, so nothing is lost there); a chunk likewise starts reach
// rows early and ends reach rows late.
//
// Strips (ops/jacobi_cuda.py strip_spans): strip j of n keeps the columns
// [exact(j), exact(j + 1)), each a multiple of the alignment (4 with 4
// cells a lane, else 1), the last ending at w; its lane 0 starts at column
// first(j): 0 for the first strip, w - 32 V for the last (so column w - 1 is
// a lane's last cell and column 0 a lane's first wherever a strip holds
// them, where the clamp is one select), and exact(j) - reach rounded down to
// the alignment between (at least 0, at most w - 32 V).  Chunk k of m keeps
// the rows [k h / m, (k+1) h / m).
//
// Input rows arrive by cp.async into a ring of slots in shared memory, each
// lane copying and reading back only its own columns, so no barrier is
// needed: the copy of a row starts WAVE_AHEAD steps before the step that
// reads it, and a slot is refilled two steps after it was read.
#pragma once

#include <stdint.h>

#include "fluid_common.cuh"

#define WAVE_AHEAD 3
#define WAVE_RING (WAVE_AHEAD + 2)

// -- strips -------------------------------------------------------------------

static __host__ __device__ __forceinline__ int wave_align(int cells) {
  return cells >= 4 ? 4 : 1;
}

// First column strip j of n keeps (j = n: the grid's width).
static __host__ __device__ __forceinline__ int wave_exact(int j, int n, int w, int cells) {
  if (j >= n) return w;
  const int a = wave_align(cells);
  return static_cast<int>(static_cast<long long>(j) * w / n) / a * a;
}

// Column of strip j's first cell (lane 0's).
static __host__ __device__ __forceinline__ int wave_first(int j, int n, int w, int width,
                                                         int reach, int cells) {
  if (j == 0) return 0;
  if (j == n - 1) return w - width;
  const int a = wave_align(cells);
  const int l = wave_exact(j, n, w, cells) - reach;
  const int f = l > 0 ? l / a * a : 0;
  return f < w - width ? f : w - width;
}

// Whether n strips of 32 * cells columns keep every column exactly at
// reach: each strip's span nonempty and inside the grid, reach stale
// columns on each side that is not the grid's edge.
static bool wave_strips_ok(int w, int cells, int reach, int n) {
  const int width = 32 * cells;
  if (n < 1 || (cells >= 4 && w % 4 != 0)) return false;
  if (n == 1) return w <= width && w % cells == 0;
  if (w < width) return false;
  for (int j = 0; j < n; ++j) {
    const int e0 = wave_exact(j, n, w, cells), e1 = wave_exact(j + 1, n, w, cells);
    const int f = wave_first(j, n, w, width, reach, cells);
    if (e1 <= e0 || f < 0 || f + width > w) return false;
    if ((f > 0 && f > e0 - reach) || (f + width < w && f + width < e1 + reach)) return false;
  }
  return true;
}

static bool wave_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// -- the ring of input rows -----------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void wave_cp_async(float* s, const float* g, bool on) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  const int n = on ? BYTES : 0;  // 0: fill with zeros, read nothing
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(g), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa), "l"(g), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void wave_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wave_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of a lane's V floats at g (zeros when !on) into ring slot
// s (32 V floats).  They sit as V / 4 16-byte pieces, piece k of every lane
// together, so the warp's reads and copies touch distinct banks.
template <int V>
__device__ __forceinline__ void wave_load(float* s, const float* g, bool on, int lane) {
  if constexpr (V == 1) {
    wave_cp_async<4>(s + lane, g, on);
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) wave_cp_async<16>(s + (k * 32 + lane) * 4, g + 4 * k, on);
  }
}

template <int V>
__device__ __forceinline__ void wave_read(const float* s, float (&v)[V], int lane) {
  if constexpr (V == 1) {
    v[0] = s[lane];
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 q = *reinterpret_cast<const float4*>(s + (k * 32 + lane) * 4);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  }
}

// A lane's V floats into ring slot s, as wave_load lays them out (a plain
// store: the same lane reads them back).
template <int V>
__device__ __forceinline__ void wave_put(float* s, const float (&v)[V], int lane) {
  if constexpr (V == 1) {
    s[lane] = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      *reinterpret_cast<float4*>(s + (k * 32 + lane) * 4) =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
}

// A lane's V floats o into row p (its first column x0), those of the
// columns [e0, e1) the strip keeps.
template <int V>
__device__ __forceinline__ void wave_store(float* p, const float (&o)[V], int x0, int e0,
                                           int e1) {
  if constexpr (V == 1) {
    if (x0 >= e0 && x0 < e1) p[0] = o[0];
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const int x = x0 + 4 * k;
      if (x >= e0 && x + 4 <= e1)
        *reinterpret_cast<float4*>(p + 4 * k) =
            make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
    }
  }
}

// The horizontal taps of a lane's row b: its neighbours' outer cells by
// shuffle, or its own at the grid's edge (a lane at a strip's inner edge
// takes a neighbour's stale column).
template <int V>
__device__ __forceinline__ void wave_sides(const float (&b)[V], bool at_left, bool at_right,
                                           float& left, float& right) {
  left = __shfl_up_sync(0xffffffffu, b[V - 1], 1);
  right = __shfl_down_sync(0xffffffffu, b[0], 1);
  left = at_left ? b[0] : left;
  right = at_right ? b[V - 1] : right;
}
