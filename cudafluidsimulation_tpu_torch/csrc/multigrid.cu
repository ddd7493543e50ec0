// H6: the multigrid smoother ends, temporally blocked (burst.cuh), with the
// grid transfers between levels fused into them.
//
// Replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py
//   smooth_damped       -> _smooth_kernel, _smooth_kernel_tiled
//   smooth_res          -> _smooth_res_kernel, _smooth_res_kernel_tiled
//                          (_damped_sweeps, _residual_rows)
//   first_smooth_res    -> _first_smooth_res_kernel (_divergence_ext)
//   last_smooth_project -> _last_smooth_project_kernel (_project_rows,
//                          _emit_vel_stats)
// and the restriction and prolongation that the JAX package leaves to XLA
// around them (cudafluidsimulation_tpu/ops/multigrid.py _restrict,
// _prolong), which here ride the same launch:
//   smooth_res_restrict, first_smooth_res_restrict: a pre-smooth whose
//     epilogue writes the residual restricted to the level below;
//   prolong_smooth, prolong_smooth_project: a post-smooth whose load adds
//     the prolonged correction of the level below.
// Term for term as the plain versions (ops/multigrid.py), every tap clamped:
//   sweep      p' = p + omega * ((l + r + b + t + rhs) * 0.25 - p)
//   from zero  p' = omega * (rhs * 0.25)   (the neighbour taps are zero)
//   residual   res = rhs - (4 p - (l + r + b + t))
//   restrict   rhs_c[i,j] = 4 * (((res[2i,2j] + res[2i+1,2j])
//                                 + (res[2i,2j+1] + res[2i+1,2j+1])) * 0.25)
//   prolong    p[y,x] + (9 c + 3 n_y + 3 n_x + n_xy) * (1/16), c the coarse
//              cell under (y, x), n_y its neighbour row toward y (up for an
//              even y, down for an odd one), n_x its neighbour column toward
//              x, n_xy the diagonal one, each clamped to the coarse grid
// plus rhs = -div(u, v) (first) and the projection with [max|u'|, max|v'|]
// (project), as H4's (csrc/pressure.cu).
//
// One kernel, mg_burst_kernel, runs every entry: a launch is a burst of
// `depth` sweeps on a tile + halo in shared memory, as H3 and H4 run theirs
// (burst.cuh: the region shrinks a ring a sweep, taps clamp against the
// grid, so any depth is exact with no ghost cells).  What a burst starts
// from (a loaded p, p plus the prolonged correction, a zero plane, the
// from-zero first sweep, or that sweep after the divergence of u and v) and
// what its tail does (store p; residual and restriction; projection) are
// launch arguments.  The one-launch-per-sweep design (PR 3) moved each
// plane through device memory once a sweep and left the transfers to ~30
// eager PyTorch launches a level; here a V-cycle is one launch a level on
// the way down, one at the bottom and one a level on the way up.
//
// Shared memory: three buffers of tile +- halo, two iterates and the
// right-hand side, as H4 keeps its divergence.  The sweep reads rhs beside
// the iterate as one 16-byte shared load; read through L1 instead it would
// need clamped global loads for the groups that stray past the grid, and
// the coarse levels' planes sit in L2 anyway.  That holds a 2048² block
// (48 x 112 tile, halo 3: 78 KB) to 2 blocks an SM, as H4.  The residual
// goes into the free iterate buffer, so the restriction needs no fourth.
// The prolongation reads p and the four coarse values of each region cell
// straight from device memory while filling the iterate buffer: the coarse
// plane is a quarter of the fine one and each of its values serves up to 16
// fine cells from L1.
//
// Batches (ensembles, the analog of the JAX package's vmap): a launch takes
// nb members, member b = blockIdx.z (and every gridDim.z after it), u and v
// at b times their own member strides (the planes of a (B, 5, H, W) pack),
// every other fine plane at b * h * w, the coarse planes (rhs_c, e_c) at
// b * (h / 2) * (w / 2) and stats at 2b.  Every member runs the same
// sweeps, so no scalar differs between members.  A single call compiles
// without the member loop (BATCH false).
//
// Restriction and prolongation need even extents, and tiles of even height
// and width on an even origin (48 x 112), so each 2x2 block lies in one
// tile, also in a clipped last tile; the wrapper checks the extents.
// Arithmetic order is the plain version's, without FMA contraction
// (-fmad=false): bit-identical.
#include "burst.cuh"

enum MgStart {
  MG_LOAD = 0,        // p_in, plus the prolonged e_c when e_c is set
  MG_ZERO_PLANE = 1,  // a plane of zeros, swept as given
  MG_FROM_ZERO = 2,   // sweep 1 from p = 0: omega * (rhs * 0.25)
  MG_FROM_UV = 3,     // rhs = -div(u, v), then sweep 1 from p = 0
};
enum MgTail {
  MG_STORE = 0,     // p of the tile
  MG_RESIDUAL = 1,  // p, and the residual (res_out) and its restriction (rhs_c)
  MG_PROJECT = 2,   // p, u', v' and the velocity bound
};

struct MgBurst {
  const float* u;       // velocity: MG_FROM_UV, MG_PROJECT
  const float* v;
  const float* p_in;    // MG_LOAD
  const float* e_c;     // MG_LOAD: the coarse correction, or null
  const float* rhs_in;  // read unless MG_FROM_UV
  float* rhs_out;       // MG_FROM_UV: -div of the tile
  float* p_out;         // the tile
  float* res_out;       // MG_RESIDUAL: the tile's residual, or null
  float* rhs_c;         // MG_RESIDUAL: the restricted residual, or null
  float* u2;            // MG_PROJECT
  float* v2;
  float* stats;         // MG_PROJECT: [max|u'|, max|v'|], or null
  int h, w, tile_h, tile_w, depth, halo, start, tail, half;
  float omega;
  int nb;                // members
  long long u_ms, v_ms;  // member strides (floats) of u and v
};

// The prolonged correction at fine cell (y, x) of a (2 hc, 2 wc) level.
__device__ __forceinline__ float mg_prolong_at(const float* __restrict__ e,
                                               int y, int x, int hc, int wc) {
  const int i = y >> 1, j = x >> 1;
  const int ni = (y & 1) ? min(i + 1, hc - 1) : max(i - 1, 0);
  const int nj = (x & 1) ? min(j + 1, wc - 1) : max(j - 1, 0);
  const float c = __ldg(e + static_cast<size_t>(i) * wc + j);
  const float cy = __ldg(e + static_cast<size_t>(ni) * wc + j);
  const float cx = __ldg(e + static_cast<size_t>(i) * wc + nj);
  const float cxy = __ldg(e + static_cast<size_t>(ni) * wc + nj);
  return (9.f * c + 3.f * cy + 3.f * cx + cxy) * 0.0625f;
}

// burst_fill of p plus the prolonged correction, over the same cells: a
// warp takes a row, a lane 4 of its cells 32 apart, whose 20 loads are all
// issued before the 4 stores (a column past the row loads its last cell
// and is not stored).
__device__ __forceinline__ void mg_fill_prolong(float* buf,
                                                const float* __restrict__ p,
                                                const float* __restrict__ e,
                                                int h, int w,
                                                const BurstTile& t) {
  const int gx0 = max(t.ox, 0), c0 = gx0 - t.ox;
  const int nc = min(t.ox + t.stride, w) - gx0, nr = t.y1 - t.y0;
  for (int r = threadIdx.y; r < nr; r += BURST_NY) {
    const int gy = t.y0 + r;
    for (int cb = 0; cb < nc; cb += 128) {
      float val[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gx = gx0 + min(cb + threadIdx.x + 32 * j, nc - 1);
        val[j] = __ldg(p + static_cast<size_t>(gy) * w + gx) +
                 mg_prolong_at(e, gy, gx, h >> 1, w >> 1);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cb + threadIdx.x + 32 * j;
        if (c < nc) buf[r * t.stride + c0 + c] = val[j];
      }
    }
  }
}

// The tile's 2x2 blocks of the residual in buffer res -> the coarse plane.
__device__ __forceinline__ void mg_restrict_tile(float* __restrict__ rhs_c,
                                                 const float* res, int w,
                                                 const BurstTile& t) {
  const int wc = w >> 1, s = t.stride;
  for (int i = (t.ty0 >> 1) + threadIdx.y; i < (t.ty1 >> 1); i += BURST_NY)
    for (int j = (t.tx0 >> 1) + threadIdx.x; j < (t.tx1 >> 1); j += 32) {
      const float* q = res + (2 * i - t.y0) * s + (2 * j - t.ox);
      const float r0 = q[0] + q[s];      // column 2j: rows 2i + 2i+1
      const float r1 = q[1] + q[s + 1];  // column 2j+1
      rhs_c[static_cast<size_t>(i) * wc + j] = 4.f * ((r0 + r1) * 0.25f);
    }
}

// One member's burst.
__device__ __forceinline__ void mg_burst_member(MgBurst k, float4* smem4) {
  const int h = k.h, w = k.w, halo = k.halo;
  const BurstTile t = burst_tile(h, w, k.tile_h, k.tile_w, halo);
  const int st = t.stride;
  const int nbuf = burst_rows(h, k.tile_h, halo) * st;
  float* a = reinterpret_cast<float*>(smem4);
  float* b = a + nbuf;
  float* f = b + nbuf;  // the right-hand side
  const float omega = k.omega;
  auto sweep = [omega](float l, float r, float bo, float to, float c, float q) {
    return c + omega * ((l + r + bo + to + q) * 0.25f - c);
  };
  auto residual = [](float l, float r, float bo, float to, float c, float q) {
    return q - (4.f * c - (l + r + bo + to));
  };

  // -- the start: rhs in f, and the iterate after sweep first - 1 in a
  int first = 1;
  if (k.start == MG_FROM_UV) {
    // u into a, v into b, then rhs = -div over tile +- (halo - 1): the
    // first sweep needs it there, and no later one further out
    burst_fill(a, k.u, w, t);
    burst_fill(b, k.v, w, t);
    __syncthreads();
    const float* vb = b;
    const int rlo = -t.y0, rhi = h - 1 - t.y0, half = k.half;
    burst_visit(a, h, w, t, halo - 1,
                [&](int r, int c, bool on, float4 ul, float4 ur, float4, float4, float4) {
                  if (!on) return;
                  const float4 vo = burst_ld4(vb + max(r - 1, rlo) * st + c);
                  const float4 vt = burst_ld4(vb + min(r + 1, rhi) * st + c);
                  float4 d = make_float4((ur.x - ul.x) + (vt.x - vo.x), (ur.y - ul.y) + (vt.y - vo.y),
                                         (ur.z - ul.z) + (vt.z - vo.z), (ur.w - ul.w) + (vt.w - vo.w));
                  if (half) d = make_float4(0.5f * d.x, 0.5f * d.y, 0.5f * d.z, 0.5f * d.w);
                  burst_st4(f + r * st + c, make_float4(-d.x, -d.y, -d.z, -d.w));
                });
    __syncthreads();
    if (k.rhs_out != nullptr) burst_copy_tile(k.rhs_out, f, w, t);
  } else {
    burst_fill(f, k.rhs_in, w, t);
    if (k.start == MG_LOAD) {
      if (k.e_c != nullptr)
        mg_fill_prolong(a, k.p_in, k.e_c, h, w, t);
      else
        burst_fill(a, k.p_in, w, t);
    } else if (k.start == MG_ZERO_PLANE) {
      for (int i = threadIdx.y * 32 + threadIdx.x; i < nbuf; i += BURST_THREADS) a[i] = 0.f;
    }
    __syncthreads();
  }
  if (k.start == MG_FROM_ZERO || k.start == MG_FROM_UV) {
    // sweep 1 from p = 0 over tile +- (halo - 1)
    const BurstSpan sp = burst_span(t, h, w, halo - 1);
    for (int r = sp.r0 + threadIdx.y; r < sp.r1; r += BURST_NY)
      for (int c = (sp.c0 & ~3) + 4 * threadIdx.x; c < sp.c1; c += 128) {
        const float4 q = burst_ld4(f + r * st + c);
        burst_st4(a + r * st + c, make_float4(omega * (q.x * 0.25f), omega * (q.y * 0.25f),
                                              omega * (q.z * 0.25f), omega * (q.w * 0.25f)));
      }
    __syncthreads();
    first = 2;
  }

  // -- sweeps first..depth in shared memory (a store tail takes the last
  // one straight to device memory); sweep j computes tile +- (halo - j)
  const int last_in_smem = k.tail == MG_STORE ? k.depth - 1 : k.depth;
  for (int j = first; j <= last_in_smem; ++j) {
    float* dst = b;
    burst_visit(a, h, w, t, halo - j,
                [&](int r, int c, bool on, float4 l, float4 rt, float4 bo, float4 to, float4 ce) {
                  if (on)
                    burst_st4(dst + r * st + c,
                              burst_map4(sweep, l, rt, bo, to, ce, burst_ld4(f + r * st + c)));
                });
    __syncthreads();
    b = a;
    a = dst;
  }

  // -- the tail
  if (k.tail == MG_STORE) {
    if (k.depth >= first) {
      burst_visit(a, h, w, t, 0,
                  [&](int r, int c, bool on, float4 l, float4 rt, float4 bo, float4 to, float4 ce) {
                    if (on)
                      burst_store_tile(k.p_out, w, t, t.y0 + r, t.ox + c,
                                       burst_map4(sweep, l, rt, bo, to, ce, burst_ld4(f + r * st + c)));
                  });
    } else {
      burst_copy_tile(k.p_out, a, w, t);
    }
    return;
  }
  if (k.tail == MG_RESIDUAL) {
    // p is exact one ring beyond the tile: the residual of the tile, kept
    // in the free buffer b for the restriction
    float* rb = b;
    burst_visit(a, h, w, t, 0,
                [&](int r, int c, bool on, float4 l, float4 rt, float4 bo, float4 to, float4 ce) {
                  if (!on) return;
                  const int gy = t.y0 + r, gx = t.ox + c;
                  const float4 res = burst_map4(residual, l, rt, bo, to, ce, burst_ld4(f + r * st + c));
                  burst_store_tile(k.p_out, w, t, gy, gx, ce);
                  if (k.res_out != nullptr) burst_store_tile(k.res_out, w, t, gy, gx, res);
                  if (k.rhs_c != nullptr) burst_st4(rb + r * st + c, res);
                });
    if (k.rhs_c != nullptr) {
      __syncthreads();
      mg_restrict_tile(k.rhs_c, rb, w, t);
    }
    return;
  }
  // MG_PROJECT: u' = u - 0.5 (pR - pL), v' = v - 0.5 (pT - pB) on the tile;
  // write p, u', v' and the maxima
  float mu = 0.f, mv = 0.f;
  burst_visit(a, h, w, t, 0,
              [&](int r, int c, bool on, float4 pl, float4 pr, float4 pb, float4 pt, float4 pc) {
                if (!on) return;
                const int gx = t.ox + c, gy = t.y0 + r;
                const float4 u = burst_load_tile(k.u, w, t, gy, gx);
                const float4 v = burst_load_tile(k.v, w, t, gy, gx);
                const float4 u2 = make_float4(u.x - 0.5f * (pr.x - pl.x), u.y - 0.5f * (pr.y - pl.y),
                                              u.z - 0.5f * (pr.z - pl.z), u.w - 0.5f * (pr.w - pl.w));
                const float4 v2 = make_float4(v.x - 0.5f * (pt.x - pb.x), v.y - 0.5f * (pt.y - pb.y),
                                              v.z - 0.5f * (pt.z - pb.z), v.w - 0.5f * (pt.w - pb.w));
                burst_store_tile(k.u2, w, t, gy, gx, u2);
                burst_store_tile(k.v2, w, t, gy, gx, v2);
                burst_store_tile(k.p_out, w, t, gy, gx, pc);
                const float au[4] = {u2.x, u2.y, u2.z, u2.w}, av[4] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  if (gx + j < t.tx1) {
                    mu = fluid_nanmax(fabsf(au[j]), mu);
                    mv = fluid_nanmax(fabsf(av[j]), mv);
                  }
              });
  if (k.stats != nullptr) fluid_block_max2_atomic(mu, mv, k.stats);
}

template <bool BATCH>
__global__ void __launch_bounds__(BURST_THREADS, 2)
mg_burst_kernel(MgBurst k) {
  extern __shared__ float4 smem4[];
  if (!BATCH) {
    mg_burst_member(k, smem4);
    return;
  }
  const size_t hw = static_cast<size_t>(k.h) * k.w;
  const size_t hwc = static_cast<size_t>(k.h >> 1) * (k.w >> 1);
  // one member at a time, the body's shape opaque (fluid_opaque)
#pragma unroll 1
  for (int b = blockIdx.z; b < k.nb; b += gridDim.z) {
    MgBurst m = k;
    m.u = fluid_shift(k.u, b * k.u_ms);
    m.v = fluid_shift(k.v, b * k.v_ms);
    m.p_in = fluid_shift(k.p_in, b * hw);
    m.e_c = fluid_shift(k.e_c, b * hwc);
    m.rhs_in = fluid_shift(k.rhs_in, b * hw);
    m.rhs_out = fluid_shift(k.rhs_out, b * hw);
    m.p_out = fluid_shift(k.p_out, b * hw);
    m.res_out = fluid_shift(k.res_out, b * hw);
    m.rhs_c = fluid_shift(k.rhs_c, b * hwc);
    m.u2 = fluid_shift(k.u2, b * hw);
    m.v2 = fluid_shift(k.v2, b * hw);
    m.stats = fluid_shift(k.stats, 2 * static_cast<size_t>(b));
    m.h = fluid_opaque(k.h);
    m.w = fluid_opaque(k.w);
    m.tile_h = fluid_opaque(k.tile_h);
    m.tile_w = fluid_opaque(k.tile_w);
    m.depth = fluid_opaque(k.depth);
    m.halo = fluid_opaque(k.halo);
    mg_burst_member(m, smem4);
    __syncthreads();  // shared memory, before the next member's fill
  }
}

// (u, v, p_in, e_c, rhs_in) -> (rhs_out, p_out, res_out, rhs_c, u2, v2,
// stats); null where the start or the tail does not use it.  scratch: an
// (h, w) plane a member, used when nbursts >= 2.  nb members, u and v at
// b * u_ms and b * v_ms floats, the other planes at their own size times b
// (mg_burst_kernel).  tile_h x tile_w: a block's output
// tile; depths: nbursts host ints, each >= 1 (ops/jacobi_cuda.py
// plan_bursts, kind "smooth" for the store tail, "smooth_res" for the
// others).  The first burst takes the start; the later ones load the p
// the one before wrote (and, after MG_FROM_UV, the rhs it wrote); the last
// takes the tail, one ring deeper unless it stores.  Burst j writes p_out
// when (nbursts - 1 - j) is even, else scratch, so the last lands in p_out.
FLUID_API int fluid_mg_smooth(const float* u, const float* v, const float* p_in,
                              const float* e_c, const float* rhs_in,
                              float* rhs_out, float* p_out, float* res_out,
                              float* rhs_c, float* u2, float* v2, float* stats,
                              float* scratch, int h, int w, int tile_h,
                              int tile_w, const int* depths, int nbursts,
                              int start, int tail, int half, float omega, int nb,
                              long long u_ms, long long v_ms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || tile_h < 1 || tile_w < 1 || nbursts < 1 || nb < 1 ||
      depths == nullptr || p_out == nullptr || start < MG_LOAD ||
      start > MG_FROM_UV || tail < MG_STORE || tail > MG_PROJECT)
    return cudaErrorInvalidValue;
  if (nbursts >= 2 && scratch == nullptr) return cudaErrorInvalidValue;
  if ((start == MG_LOAD && p_in == nullptr) ||
      (start == MG_FROM_UV && (u == nullptr || v == nullptr || rhs_out == nullptr)) ||
      (start != MG_FROM_UV && rhs_in == nullptr) ||
      (tail == MG_RESIDUAL && res_out == nullptr && rhs_c == nullptr) ||
      (tail == MG_PROJECT && (u == nullptr || v == nullptr || u2 == nullptr || v2 == nullptr)))
    return cudaErrorInvalidValue;
  // a 2x2 block of the fine level must lie in one tile
  const bool transfer = (start == MG_LOAD && e_c != nullptr) ||
                        (tail == MG_RESIDUAL && rhs_c != nullptr);
  if (transfer && ((h | w | tile_h | tile_w) & 1)) return cudaErrorInvalidValue;
  size_t smem = 0;
  for (int j = 0; j < nbursts; ++j) {
    if (depths[j] < 1) return cudaErrorInvalidValue;
    const int halo = depths[j] + (j == nbursts - 1 && tail != MG_STORE ? 1 : 0);
    const size_t bytes = burst_smem_bytes(3, h, w, tile_h, tile_w, halo);
    if (bytes > smem) smem = bytes;
  }
  const bool batch = nb > 1;
  auto kernel = batch ? mg_burst_kernel<true> : mg_burst_kernel<false>;
  cudaError_t e = burst_allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  if (tail == MG_PROJECT && stats != nullptr) {
    e = cudaMemsetAsync(stats, 0, 2 * sizeof(float) * nb, s);
    if (e != cudaSuccess) return e;
  }
  MgBurst k = {u, v, p_in, e_c, rhs_in, rhs_out, p_out, res_out, rhs_c, u2, v2,
               stats, h, w, tile_h, tile_w, 0, 0, start, tail, half, omega,
               nb, u_ms, v_ms};
  for (int j = 0; j < nbursts; ++j) {
    const int last = j == nbursts - 1;
    MgBurst b = k;
    b.depth = depths[j];
    if (j > 0) {
      b.start = MG_LOAD;
      b.e_c = nullptr;
      if (start == MG_FROM_UV) b.rhs_in = rhs_out;
      b.rhs_out = nullptr;
    }
    if (!last) b.tail = MG_STORE;
    b.halo = b.depth + (b.tail != MG_STORE ? 1 : 0);
    b.p_out = ((nbursts - 1 - j) % 2 == 0) ? p_out : scratch;
    kernel<<<burst_grid(h, w, tile_h, tile_w, fluid_grid_z(nb)), dim3(32, BURST_NY),
             burst_smem_bytes(3, h, w, tile_h, tile_w, b.halo), s>>>(b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    k.p_in = b.p_out;
  }
  return cudaSuccess;
}

// -- the stopping test's reduction ------------------------------------------------
//
// mean(res**2) of each of nb planes of n cells, in an order that depends on
// neither nb nor the device: pass 1 gives each MS_CHUNK-cell chunk of a
// plane a block, whose thread t adds the squares of cells t, t + MS_THREADS,
// ... of the chunk in turn from 0, and whose threads' sums meet in a tree
// (s[t] += s[t + off], off = MS_THREADS / 2, ..., 1); pass 2 adds a plane's
// chunk sums the same way in one block and divides by n.  The plain version
// (ops/multigrid.py mean_square) runs the same additions, so the two agree
// bit for bit, and a member of a batch gets the value of its single plane.
// (PyTorch's own reduction splits a plane across blocks by the shape of the
// whole call, so a batched mean may round otherwise than a single one.)
// Bound by bytes: n floats read once a plane.
#define MS_THREADS 256
#define MS_PER_THREAD 32
#define MS_CHUNK (MS_THREADS * MS_PER_THREAD)

// s[0..MS_THREADS) -> s[0], the tree of the plain version
__device__ __forceinline__ float ms_tree(float* s, float v) {
  const int t = threadIdx.x;
  s[t] = v;
  __syncthreads();
#pragma unroll
  for (int off = MS_THREADS / 2; off > 0; off >>= 1) {
    if (t < off) s[t] = s[t] + s[t + off];
    __syncthreads();
  }
  const float total = s[0];
  __syncthreads();  // s, before the next member's sums
  return total;
}

__global__ void __launch_bounds__(MS_THREADS)
mean_square_chunks(const float* __restrict__ r, float* __restrict__ part, long long n,
                   int nchunks, int nb, long long ms) {
  __shared__ float s[MS_THREADS];
  // members beyond the grid's y extent (65535): a block walks y
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* x = r + b * ms;
    const long long base = static_cast<long long>(blockIdx.x) * MS_CHUNK + threadIdx.x;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < MS_PER_THREAD; ++j) {
      const long long i = base + static_cast<long long>(j) * MS_THREADS;
      if (i < n) {
        const float v = __ldg(x + i);
        acc = acc + v * v;
      }
    }
    const float total = ms_tree(s, acc);
    if (threadIdx.x == 0) part[static_cast<size_t>(b) * nchunks + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(MS_THREADS)
mean_square_planes(const float* __restrict__ part, float* __restrict__ out, long long n,
                   int nchunks, int nb) {
  __shared__ float s[MS_THREADS];
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* q = part + static_cast<size_t>(b) * nchunks;
    float acc = 0.f;
    for (int i = threadIdx.x; i < nchunks; i += MS_THREADS) acc = acc + q[i];
    const float total = ms_tree(s, acc);
    if (threadIdx.x == 0) out[b] = total / static_cast<float>(n);
  }
}

// r: nb planes of n floats, member b at b * ms; part: nb * ceil(n / MS_CHUNK)
// floats of scratch; out: nb floats, mean(r_b**2).
FLUID_API int fluid_mean_square(const float* r, float* part, float* out, int nb, long long n,
                                long long ms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || n < 1 || r == nullptr || part == nullptr || out == nullptr)
    return cudaErrorInvalidValue;
  const long long chunks = (n + MS_CHUNK - 1) / MS_CHUNK;
  if (chunks > 0x7fffffff) return cudaErrorInvalidValue;
  const int nchunks = static_cast<int>(chunks);
  mean_square_chunks<<<dim3(nchunks, fluid_grid_z(nb)), MS_THREADS, 0, s>>>(
      r, part, n, nchunks, nb, ms);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mean_square_planes<<<dim3(1, fluid_grid_z(nb)), MS_THREADS, 0, s>>>(part, out, n,
                                                                       nchunks, nb);
  return cudaGetLastError();
}

