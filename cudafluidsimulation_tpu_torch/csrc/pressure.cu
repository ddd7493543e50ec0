// H4: pressure projection — divergence, Jacobi sweeps from p = 0, gradient
// subtraction and the velocity bound — and its standalone solve, both
// temporally blocked; H5: the standalone divergence and projection.
//
// H4 replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py pressure_project
// -> _single_pressure_kernel, _first_pressure_kernel, _pressure_kernel,
// _last_pressure_kernel (and _first_/_last_pressure_kernel_tiled,
// _pressure_kernel_tiled), with _emit_vel_stats; its pressure_solve entry
// replaces jacobi_pallas.py pressure_solve -> _pressure_kernel.
//   div = (uR - uL) + (vT - vB), times 0.5 when half   (GPUFluidSim.cu:297-310)
//   p   = (pL + pR + pB + pT - div) * 0.25, iters sweeps from p = 0
//   u' = u - 0.5*(pR - pL), v' = v - 0.5*(pT - pB)     (GPUFluidSim.cu:498-516)
// All taps clamp.
//
// What bounds it on an H100: a sweep reads p and div and writes p, so one
// launch per sweep (the first design, 0.96 ms for 40 sweeps at 2048²) is
// bound by device memory and launches.  Here each launch is a burst of
// `depth` sweeps on a tile + halo in shared memory (burst.cuh), fused as
// the Pallas kernels are: the first burst computes the divergence of its
// region from u and v, keeps it in shared memory beside p, and sweeps from
// p = 0 (the first sweep is (0 - div) * 0.25, no p to read); middle bursts
// load p and div; the last burst runs with halo depth + 1, so p is exact
// one ring beyond the tile, then subtracts the gradient and emits
// [max|u'|, max|v'|] by a block max and an atomic max.  40 sweeps are 5
// launches; the bound is then the instruction issue and shared-memory
// traffic of the sweeps (each row reads p above, div and writes p, 16
// bytes a thread) and the halo's redundant cells: 0.385 ms at 2048² on an
// NVIDIA H100 80GB HBM3 at 700 W.
// Arithmetic order is the plain version's, without FMA contraction:
// bit-identical.
//
// H4 also takes a batch of independent members (ensembles) in the same
// launches: member b = blockIdx.z (and every gridDim.z after it) reads u and
// v at b times their member strides and every other plane, and its 2-float
// stats slot, at b times its own size.  A single call is the case B = 1.
//
// H5 replaces jacobi_pallas.py divergence -> _divergence_kernel and
// project -> _project_kernel: one launch each (fluid_divergence,
// fluid_project), bound by bytes; a batch of members in one launch, member
// b on grid z with u and v at their own member strides (the planes of a
// (B, 5, H, W) pack), compiled apart from the single call (BATCH).
#include "burst.cuh"
#include "projection.cuh"

struct PressureBurst {
  const float* u;       // velocity, read when from_uv or project
  const float* v;
  const float* div_in;  // read unless from_uv
  const float* p_in;    // read unless from_zero
  float* div_out;       // written (the tile) when not null
  float* p_out;         // the tile
  float* u2;            // projected velocity, when project
  float* v2;
  float* stats;         // [max|u'|, max|v'|] when project
  int h, w, tile_h, tile_w, depth, half, from_uv, from_zero, project;
  int nb;               // members; u and v member b at b * u_ms, b * v_ms,
  long long u_ms, v_ms;  // the rest at b * h * w (stats at 2b)
};

// One member's burst: depth sweeps with halo depth (+1 when project).
// Shared memory: two iterates a, b and the divergence, each tile +- halo.
__device__ __forceinline__ void pressure_burst_member(const PressureBurst& k, float4* smem4) {
  const int h = k.h, w = k.w;
  const int halo = k.depth + (k.project ? 1 : 0);
  const BurstTile t = burst_tile(h, w, k.tile_h, k.tile_w, halo);
  const int st = t.stride;
  const int nbuf = burst_rows(h, k.tile_h, halo) * st;
  float* a = reinterpret_cast<float*>(smem4);
  float* b = a + nbuf;
  float* div = b + nbuf;
  auto op = [](float l, float r, float bo, float to, float, float d) {
    return (l + r + bo + to - d) * 0.25f;
  };
  if (k.from_uv) {
    // u into a, v into b, then the divergence over tile +- (halo - 1): the
    // first sweep needs p there, and no later one reads div further out
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
                  burst_st4(div + r * st + c, d);
                });
  } else {
    burst_fill(div, k.div_in, w, t);
  }
  if (!k.from_zero) burst_fill(a, k.p_in, w, t);
  __syncthreads();
  if (k.div_out != nullptr) burst_copy_tile(k.div_out, div, w, t);
  int first = 1;
  if (k.from_zero) {
    // the first sweep from p = 0 (every tap zero) over tile +- (halo - 1);
    // iters = 0 leaves p = 0 over the whole region
    const BurstSpan sp = burst_span(t, h, w, k.depth > 0 ? halo - 1 : halo);
    for (int r = sp.r0 + threadIdx.y; r < sp.r1; r += BURST_NY)
      for (int c = (sp.c0 & ~3) + 4 * threadIdx.x; c < sp.c1; c += 128) {
        const float4 d = burst_ld4(div + r * st + c);
        burst_st4(a + r * st + c,
                  k.depth > 0 ? make_float4((0.f - d.x) * 0.25f, (0.f - d.y) * 0.25f,
                                            (0.f - d.z) * 0.25f, (0.f - d.w) * 0.25f)
                              : make_float4(0.f, 0.f, 0.f, 0.f));
      }
    __syncthreads();
    first = 2;
  }
  // sweeps first..depth-1 in shared memory; the last one too when project
  const float* dv = div;
  const int last_in_smem = k.project ? k.depth : k.depth - 1;
  for (int j = first; j <= last_in_smem; ++j) {
    float* dst = b;
    burst_visit(a, h, w, t, halo - j,
                [&](int r, int c, bool on, float4 l, float4 rt, float4 bo, float4 to, float4 ce) {
                  if (on)
                    burst_st4(dst + r * st + c,
                              burst_map4(op, l, rt, bo, to, ce, burst_ld4(dv + r * st + c)));
                });
    __syncthreads();
    b = a;
    a = dst;
  }
  if (!k.project) {
    // the last sweep, the tile only, to device memory (depth 1 from zero
    // has done it: copy the tile)
    if (k.depth >= first) {
      burst_visit(a, h, w, t, 0,
                  [&](int r, int c, bool on, float4 l, float4 rt, float4 bo, float4 to, float4 ce) {
                    if (on)
                      burst_store_tile(k.p_out, w, t, t.y0 + r, t.ox + c,
                                       burst_map4(op, l, rt, bo, to, ce, burst_ld4(dv + r * st + c)));
                  });
    } else {
      burst_copy_tile(k.p_out, a, w, t);
    }
    return;
  }
  // p holds one ring beyond the tile: u' = u - 0.5 (pR - pL),
  // v' = v - 0.5 (pT - pB) on the tile; write p, u', v' and the maxima
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
  fluid_block_max2_atomic(mu, mv, k.stats);
}

__global__ void __launch_bounds__(BURST_THREADS, 2)
pressure_burst_kernel(PressureBurst k) {
  extern __shared__ float4 smem4[];
  const size_t hw = static_cast<size_t>(k.h) * k.w;
  // one member at a time, the body's shape opaque (fluid_opaque)
#pragma unroll 1
  for (int b = blockIdx.z; b < k.nb; b += gridDim.z) {
    PressureBurst m = k;
    m.u = fluid_shift(k.u, b * k.u_ms);
    m.v = fluid_shift(k.v, b * k.v_ms);
    m.div_in = fluid_shift(k.div_in, b * hw);
    m.p_in = fluid_shift(k.p_in, b * hw);
    m.div_out = fluid_shift(k.div_out, b * hw);
    m.p_out = fluid_shift(k.p_out, b * hw);
    m.u2 = fluid_shift(k.u2, b * hw);
    m.v2 = fluid_shift(k.v2, b * hw);
    m.stats = fluid_shift(k.stats, 2 * static_cast<size_t>(b));
    m.h = fluid_opaque(k.h);
    m.w = fluid_opaque(k.w);
    m.tile_h = fluid_opaque(k.tile_h);
    m.tile_w = fluid_opaque(k.tile_w);
    m.depth = fluid_opaque(k.depth);
    pressure_burst_member(m, smem4);
    __syncthreads();  // shared memory, before the next member's fill
  }
}

// Launch the bursts: depths[j] sweeps each (sum = iters); burst j writes p
// when (nbursts-1-j) is even, else scratch, so the last lands in p.
static cudaError_t pressure_bursts(PressureBurst k, const int* depths,
                                   int nbursts, float* p, float* scratch,
                                   float* div, cudaStream_t s) {
  if (k.h < 1 || k.w < 1 || k.tile_h < 1 || k.tile_w < 1 || nbursts < 1 ||
      k.nb < 1 || depths == nullptr)
    return cudaErrorInvalidValue;
  if (nbursts >= 2 && (scratch == nullptr || (k.from_uv && div == nullptr)))
    return cudaErrorInvalidValue;
  const int project = k.project;
  size_t smem = 0;
  for (int j = 0; j < nbursts; ++j) {
    if (depths[j] < 0 || (depths[j] == 0 && (nbursts > 1 || !project)))
      return cudaErrorInvalidValue;
    const int halo = depths[j] + (project && j == nbursts - 1 ? 1 : 0);
    const size_t b = burst_smem_bytes(3, k.h, k.w, k.tile_h, k.tile_w, halo);
    if (b > smem) smem = b;
  }
  cudaError_t e = burst_allow_smem(pressure_burst_kernel, smem);
  if (e != cudaSuccess) return e;
  if (project) {
    e = cudaMemsetAsync(k.stats, 0, 2 * sizeof(float) * k.nb, s);
    if (e != cudaSuccess) return e;
  }
  const int from_uv = k.from_uv;
  for (int j = 0; j < nbursts; ++j) {
    const int last = j == nbursts - 1;
    PressureBurst b = k;
    b.depth = depths[j];
    b.from_uv = from_uv && j == 0;
    b.from_zero = j == 0;
    b.project = project && last;
    b.div_out = (from_uv && j == 0 && !last) ? div : nullptr;
    if (j > 0) b.div_in = from_uv ? div : k.div_in;
    b.p_out = ((nbursts - 1 - j) % 2 == 0) ? p : scratch;
    const int halo = b.depth + (b.project ? 1 : 0);
    pressure_burst_kernel<<<burst_grid(k.h, k.w, k.tile_h, k.tile_w, fluid_grid_z(k.nb)),
                            dim3(32, BURST_NY),
                            burst_smem_bytes(3, k.h, k.w, k.tile_h, k.tile_w, halo),
                            s>>>(b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    k.p_in = b.p_out;
  }
  return cudaSuccess;
}

// u, v in; u2, v2, p out; div, scratch: (h, w) work planes (used when
// nbursts >= 2); stats: 2 floats.  tile_h x tile_w: a block's output tile;
// depths: nbursts host ints (ops/jacobi_cuda.py plan_bursts), one burst
// of depth 0 for iters = 0.  nb members: member b's u and v at b * u_ms and
// b * v_ms floats, its u2, v2, p, div and scratch at b * h * w, its stats
// at 2b.
FLUID_API int fluid_pressure_project(const float* u, const float* v,
                                     float* u2, float* v2, float* p,
                                     float* div, float* scratch,
                                     float* stats, int h, int w, int tile_h,
                                     int tile_w, const int* depths,
                                     int nbursts, int half, int nb,
                                     long long u_ms, long long v_ms, void* stream) {
  PressureBurst k = {};
  k.nb = nb;
  k.u_ms = u_ms;
  k.v_ms = v_ms;
  k.u = u;
  k.v = v;
  k.u2 = u2;
  k.v2 = v2;
  k.stats = stats;
  k.h = h;
  k.w = w;
  k.tile_h = tile_h;
  k.tile_w = tile_w;
  k.half = half;
  k.from_uv = 1;
  k.project = 1;
  return pressure_bursts(k, depths, nbursts, p, scratch, div,
                         static_cast<cudaStream_t>(stream));
}

// div in; p out; scratch: (h, w), used when nbursts >= 2.  nbursts = 0
// (iters = 0) zeroes p.
FLUID_API int fluid_pressure_solve(const float* div, float* p, float* scratch,
                                   int h, int w, int tile_h, int tile_w,
                                   const int* depths, int nbursts,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || nbursts < 0) return cudaErrorInvalidValue;
  if (nbursts == 0) return cudaMemsetAsync(p, 0, sizeof(float) * h * w, s);
  PressureBurst k = {};
  k.nb = 1;
  k.div_in = div;
  k.h = h;
  k.w = w;
  k.tile_h = tile_h;
  k.tile_w = tile_w;
  return pressure_bursts(k, depths, nbursts, p, scratch, nullptr, s);
}

template <bool BATCH>
__global__ void divergence_kernel(const float* __restrict__ u,
                                  const float* __restrict__ v,
                                  float* __restrict__ div, int h, int w,
                                  int half, int nb, long long u_ms, long long v_ms) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int n = BATCH ? nb : 1;
#pragma unroll 1
  for (int b = BATCH ? blockIdx.z : 0; b < n; b += BATCH ? gridDim.z : 1)
    div[static_cast<size_t>(b) * h * w + y * w + x] =
        fluid_divergence_at(u + b * u_ms, v + b * v_ms, x, y, h, w, half);
}

// nb members: member b's u and v at b * u_ms and b * v_ms floats, its div
// at b * h * w.
FLUID_API int fluid_divergence(const float* u, const float* v, float* div,
                               int h, int w, int half, int nb, long long u_ms,
                               long long v_ms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || nb < 1) return cudaErrorInvalidValue;
  const dim3 grid = fluid_grid2d(h, w, fluid_grid_z(nb)), block(FLUID_BX, FLUID_BY);
  if (nb > 1)
    divergence_kernel<true><<<grid, block, 0, s>>>(u, v, div, h, w, half, nb, u_ms, v_ms);
  else
    divergence_kernel<false><<<grid, block, 0, s>>>(u, v, div, h, w, half, 1, 0, 0);
  return cudaGetLastError();
}

// stats may be null (no velocity bound); nb members: u and v at b * u_ms,
// b * v_ms floats, p, u2 and v2 at b * h * w, stats at 2b.
FLUID_API int fluid_project(const float* p, const float* u, const float* v,
                            float* u2, float* v2, float* stats, int h, int w,
                            int nb, long long u_ms, long long v_ms, void* stream) {
  if (h < 1 || w < 1 || nb < 1) return cudaErrorInvalidValue;
  return fluid_launch_project(p, u, v, u2, v2, stats, h, w, nb, u_ms, v_ms,
                              static_cast<cudaStream_t>(stream));
}
