// H4: pressure projection — divergence, Jacobi sweeps from p = 0, gradient
// subtraction and the velocity bound — as a row-streaming wavefront, and its
// standalone solve in trapezoid bursts; H5: the standalone divergence and
// projection.
//
// H4 replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py pressure_project
// -> _single_pressure_kernel, _first_pressure_kernel, _pressure_kernel,
// _last_pressure_kernel (and _first_/_last_pressure_kernel_tiled,
// _pressure_kernel_tiled), with _emit_vel_stats; its pressure_solve entry
// replaces jacobi_pallas.py pressure_solve -> _pressure_kernel, from p = 0
// or from a given iterate (its init).
//   div = (uR - uL) + (vT - vB), times 0.5 when half   (GPUFluidSim.cu:297-310)
//   p   = (pL + pR + pB + pT - div) * 0.25, iters sweeps from p = 0
//   u' = u - 0.5*(pR - pL), v' = v - 0.5*(pT - pB)     (GPUFluidSim.cu:498-516)
// All taps clamp.
//
// What bounds it on an H100: a sweep reads p and div and writes p, so one
// launch per sweep (the first design, 0.96 ms for 40 sweeps at 2048²) is
// bound by device memory and launches.  Trapezoid bursts of up to 8 sweeps
// on a tile + halo in shared memory (burst.cuh; 5 launches and a memset,
// 0.37 ms) moved the bound to the SMs' issue: every sweep paid shared
// loads and stores of p and div and a block barrier, over a tile and halo
// 1.4x the cells kept.
//
// The projection now (fluid_pressure_project) is H3's design (diffuse.cu,
// wave.cuh): a pass carries d <= PRESSURE_DEPTH sweeps down a column strip
// in one warp's registers, stage k computing sweep k one row behind stage
// k - 1 from the three rows of sweep k - 1 it keeps and the outer
// horizontal taps by shuffle.  Stage k also needs div of its own row, k
// rows behind the input row: a register delay line of it (D x V floats)
// pushed the last pass past 255 registers into spills, so div rows sit in
// a ring of their own in shared memory (PRESSURE_DIV_RING rows a warp,
// each lane reading back only its own columns: no barrier), one 16-byte
// read a stage.  Input rows arrive through cp.async rings.  The first pass
// computes div = (uR - uL) + (vT - vB) from u and v as their rows stream
// in (it reaches as far as a sweep), sweeps from p = 0 (the first sweep is
// (0 - div) * 0.25, no p to read), writes div once for the later passes
// and zeroes the velocity bound's slot (the last pass runs after it on the
// stream).  Middle passes read p and div and write p.  The last pass runs
// one stage more: the gradient at the row its last sweep finishes (one
// more stale column and row), u and v read there through the ring, and
// writes p, u', v' and the [max|u'|, max|v'|] of its kept cells by a warp
// max and an atomic max.  A block is 2 warps, 4 blocks an SM (8 warps, as
// H3's), so the last pass's rings fit the 48 KB of static shared memory.
// 40 sweeps at 2048² are 4 passes, 17 plane-passes of device traffic.
// What bounds it now is the SMs' issue over 1.5x the cells kept (128-column
// strips keep 108; 50 chunks of 41 rows, each with 20 lead rows), as H3's;
// the last pass, with two more input rows and three output rows a step,
// takes 1.8x a middle one.  Measured 0.172 ms device for 40 sweeps at
// 2048² (4 launches: 0.040, 2 x 0.035, 0.062), 0.547 ms for 64 x 512², on
// an NVIDIA H100 80GB HBM3 at 700 W.  Arithmetic order is the plain
// version's, built without FMA contraction: bit-identical.
//
// The standalone solve (fluid_pressure_solve) keeps the trapezoid bursts:
// the sharded rollout's callers continue it from an iterate (init) across
// halo exchanges whose depth is a burst's halo (parallel/).
//
// Members: the projection takes a batch of independent members
// (ensembles) in the same launches: member b = blockIdx.z (and every
// gridDim.z after it) reads u and v at b times their member strides and
// every other plane, and its 2-float stats slot, at b times its own size.
// A single call is the case B = 1.
//
// H5 replaces jacobi_pallas.py divergence -> _divergence_kernel and
// project -> _project_kernel: one launch each (fluid_divergence,
// fluid_project), bound by bytes; a batch of members in one launch, member
// b on grid z with u and v at their own member strides (the planes of a
// (B, 5, H, W) pack), compiled apart from the single call (BATCH).
#include "burst.cuh"
#include "projection.cuh"
#include "wave.cuh"

// -- the projection: a row-streaming wavefront ------------------------------------

// the pipeline's stages: the most sweeps one pass carries
#define PRESSURE_DEPTH 10
// warps a block, each on a strip and chunk of its own, and the blocks an SM
// the registers are sized for (255 a thread)
#define PRESSURE_WARPS 2
#define PRESSURE_BLOCKS_PER_SM 4
// div's ring: row r - k for stage k, held until the last stage reads it, and
// the copies in flight ahead of the first
#define PRESSURE_DIV_RING (PRESSURE_DEPTH + WAVE_AHEAD)

// One launch (one pass of d sweeps).  Member b's u and v at b * u_ms and
// b * v_ms floats, its other planes at b * h * w, its stats at 2b.
struct PressurePass {
  const float* u;       // FIRST: the divergence's; LAST: the projection's
  const float* v;
  const float* p_in;    // read unless FIRST
  const float* div_in;  // read unless FIRST
  float* p_out;
  float* div_out;       // FIRST, when a later pass reads it
  float* u2;            // LAST
  float* v2;
  float* stats;         // LAST: [max|u'|, max|v'|]; FIRST and not LAST: zeroed
  int h, w, d, strips, chunks, half, nb;
  long long u_ms, v_ms;
};

// One warp's strip and chunk of one member.  Its rings in shared memory:
// `ring`, WAVE_RING slots a row apart of the rows a step reads (FIRST: u
// and v at the input row; else p; LAST adds u and v at the gradient's row,
// reach rows behind), and `dring`, PRESSURE_DIV_RING slots of div (row
// s0 + t - 1 in slot t mod PRESSURE_DIV_RING).
template <int V>
struct PWave {
  const float* u;
  const float* v;
  const float* p_in;
  const float* div_in;
  float* p_out;
  float* div_out;
  float* u2;
  float* v2;
  float* ring;
  float* dring;
  int h, w, d, reach, half;
  int x0;           // this lane's first column
  int e0, e1;       // the columns the strip keeps
  int y0, y1, s0;   // the rows the chunk keeps, and the first row it reads
  bool lane_in;     // the lane's columns lie in the grid
  bool at_left;     // its first column is the grid's first
  bool at_right;    // its last column is the grid's last
};

// The rings' floats a warp holds: the row rings, then div's.
template <int V, bool FIRST, bool LAST>
struct PWaveRings {
  static constexpr int rows = (FIRST ? 2 : 1) + (LAST ? 2 : 0);
  static constexpr int slot = 32 * V;
  static constexpr int floats = (rows * WAVE_RING + PRESSURE_DIV_RING) * slot;
};

// Start the copies that step t reads, into its slots: row r of u and v
// (FIRST) or of p and row r - 1 of div (into div's slot t); LAST, row
// r - reach of u and v, where the chunk keeps it (the gradient's other
// rows are never stored).  Rows outside the grid read as zeros.
template <int V, bool FIRST, bool LAST>
__device__ __forceinline__ void pw_load(const PWave<V>& c, int t, int lane) {
  using R = PWaveRings<V, FIRST, LAST>;
  const int r = c.s0 + t;
  float* s = c.ring + t % WAVE_RING * R::slot;
  auto one = [&](float* slot, const float* plane, int row, int y0, int y1) {
    const bool on = c.lane_in && row >= y0 && row < y1;
    wave_load<V>(slot, plane + (on ? static_cast<size_t>(row) * c.w + c.x0 : 0), on, lane);
  };
  if constexpr (FIRST) {
    one(s, c.u, r, 0, c.h);
    one(s + WAVE_RING * R::slot, c.v, r, 0, c.h);
  } else {
    one(s, c.p_in, r, 0, c.h);
    one(c.dring + t % PRESSURE_DIV_RING * R::slot, c.div_in, r - 1, 0, c.h);
  }
  if constexpr (LAST) {
    constexpr int k = FIRST ? 2 : 1;
    one(s + k * WAVE_RING * R::slot, c.u, r - c.reach, c.y0, c.y1);
    one(s + (k + 1) * WAVE_RING * R::slot, c.v, r - c.reach, c.y0, c.y1);
  }
}

// Where stage S writes its row: the next stage's newest slot, or o.
template <int S, int V, int D, int PHASE>
__device__ __forceinline__ auto& pw_stage_out(float (&W)[D][3][V], float (&o)[V]) {
  if constexpr (S + 1 < D)
    return W[S + 1][PHASE];
  else
    return o;
}

// Stage S + 1 of step t: sweep S + 1 at row r - (S + 1), from the rows
// r - S - 2 (a), r - S - 1 (b) and r - S (c) of sweep S in W[S] (the slots
// rotate with the step, PHASE = t mod 3) and div of its row, in div's slot
// dt - S (dt = t mod PRESSURE_DIV_RING; d1: FIRST's div of row r - 1, for
// its stage 1, the sweep from p = 0, (0 - div) / 4).  Stages past a pass's depth (FULL false) hand
// their input on unchanged.  CHECK: some stage of this step may meet the
// grid's first or last row, whose B or T tap is itself.
template <int S, int V, int D, bool FULL, bool FIRST, int PHASE, bool CHECK>
__device__ __forceinline__ void pw_stages(const PWave<V>& c, float (&W)[D][3][V],
                                          const float (&d1)[V], int dt, float (&o)[V], int r,
                                          int lane) {
  if constexpr (S < D) {
    constexpr int SLOT = 32 * V;
    auto& out = pw_stage_out<S, V, D, PHASE>(W, o);
    if (!FULL && S >= c.d) {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = W[S][PHASE][i];
    } else if constexpr (FIRST && S == 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = (0.f - d1[i]) * 0.25f;
    } else {
      // div's slot of row r - S - 1, S slots before row r - 1's
      const int ds = dt >= S ? dt - S : dt - S + PRESSURE_DIV_RING;
      float dv[V];
      wave_read<V>(c.dring + ds * SLOT, dv, lane);
      const float(&a)[V] = W[S][(PHASE + 1) % 3];
      const float(&b)[V] = W[S][(PHASE + 2) % 3];
      const float(&t)[V] = W[S][PHASE];
      float left, right;
      wave_sides<V>(b, c.at_left, c.at_right, left, right);
      bool top = false, bot = false;
      if constexpr (CHECK) {
        const int row = r - (S + 1);
        top = row == 0;
        bot = row == c.h - 1;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float L = i == 0 ? left : b[i > 0 ? i - 1 : 0];
        const float R = i == V - 1 ? right : b[i < V - 1 ? i + 1 : i];
        const float B = top ? b[i] : a[i];
        const float T = bot ? b[i] : t[i];
        out[i] = (L + R + B + T - dv[i]) * 0.25f;
      }
    }
    pw_stages<S + 1, V, D, FULL, FIRST, PHASE, CHECK>(c, W, d1, dt, o, r, lane);
  }
}

// A pass's registers: W[S] the three newest rows of sweep S (W[0] the input
// p), G the three newest rows of the last sweep (LAST), U and Vv the three
// newest input rows of u and v (FIRST).
template <int V, int D>
struct PWaveRegs {
  float W[D][3][V];
  float G[3][V];
  float U[3][V];
  float Vv[3][V];
};

// Step t: the rows of input row r = s0 + t from the ring, the copies step
// t + WAVE_AHEAD reads started; FIRST: div of row r - 1 into div's ring
// (and to device memory where the chunk keeps it, when a later pass reads
// it); every stage; then the last stage's row r - d written where the
// chunk keeps it, or LAST: the gradient at row r - d - 1 from the last
// sweep's rows, and p, u' and v' written there, with the maxima of |u'|
// and |v'| over the kept cells.
template <int V, int D, bool FULL, bool FIRST, bool LAST, int PHASE, bool CHECK>
__device__ __forceinline__ void pw_step(const PWave<V>& c, PWaveRegs<V, D>& g, int t, int lane,
                                        float& mu, float& mv) {
  using R = PWaveRings<V, FIRST, LAST>;
  const int r = c.s0 + t;
  wave_wait<WAVE_AHEAD - 1>();
  const float* s = c.ring + t % WAVE_RING * R::slot;
  const int dt = t % PRESSURE_DIV_RING;
  if constexpr (FIRST) {
    wave_read<V>(s, g.U[PHASE], lane);
    wave_read<V>(s + WAVE_RING * R::slot, g.Vv[PHASE], lane);
  } else {
    wave_read<V>(s, g.W[0][PHASE], lane);
  }
  // LAST: u and v of the gradient's row, read from the slot after the
  // stages (step t's copies into it were waited for above, and the next
  // copy into it starts two steps on)
  pw_load<V, FIRST, LAST>(c, t + WAVE_AHEAD, lane);
  wave_commit();
  float d1[V];
  if constexpr (FIRST) {
    // (uR - uL) + (vT - vB) at row r - 1, times 0.5 when half
    const float(&ub)[V] = g.U[(PHASE + 2) % 3];
    const float(&va)[V] = g.Vv[(PHASE + 1) % 3];
    const float(&vb)[V] = g.Vv[(PHASE + 2) % 3];
    const float(&vt)[V] = g.Vv[PHASE];
    float left, right;
    wave_sides<V>(ub, c.at_left, c.at_right, left, right);
    bool top = false, bot = false;
    if constexpr (CHECK) {
      top = r - 1 == 0;
      bot = r - 1 == c.h - 1;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float ul = i == 0 ? left : ub[i > 0 ? i - 1 : 0];
      const float ur = i == V - 1 ? right : ub[i < V - 1 ? i + 1 : i];
      const float vo = top ? vb[i] : va[i];
      const float vn = bot ? vb[i] : vt[i];
      const float dd = (ur - ul) + (vn - vo);
      d1[i] = c.half ? 0.5f * dd : dd;
    }
    wave_put<V>(c.dring + dt * R::slot, d1, lane);
    const int gy = r - 1;
    if (c.div_out != nullptr && gy >= c.y0 && gy < c.y1)
      wave_store<V>(c.div_out + static_cast<size_t>(gy) * c.w + c.x0, d1, c.x0, c.e0, c.e1);
  }
  float ol[V];
  float(&o)[V] = LAST ? g.G[PHASE] : ol;
  pw_stages<0, V, D, FULL, FIRST, PHASE, CHECK>(c, g.W, d1, dt, o, r, lane);
  if constexpr (!LAST) {
    const int gy = r - c.d;
    if (gy >= c.y0 && gy < c.y1)
      wave_store<V>(c.p_out + static_cast<size_t>(gy) * c.w + c.x0, o, c.x0, c.e0, c.e1);
  } else {
    // u' = u - 0.5 (pR - pL), v' = v - 0.5 (pT - pB) at row r - reach
    const float(&pa)[V] = g.G[(PHASE + 1) % 3];
    const float(&pb)[V] = g.G[(PHASE + 2) % 3];
    const float(&pt)[V] = g.G[PHASE];
    float left, right;
    wave_sides<V>(pb, c.at_left, c.at_right, left, right);
    const int gy = r - c.reach;
    bool top = false, bot = false;
    if constexpr (CHECK) {
      top = gy == 0;
      bot = gy == c.h - 1;
    }
    constexpr int k = FIRST ? 2 : 1;
    float uu[V], vv[V], u2[V], v2[V];
    wave_read<V>(s + k * WAVE_RING * R::slot, uu, lane);
    wave_read<V>(s + (k + 1) * WAVE_RING * R::slot, vv, lane);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float pl = i == 0 ? left : pb[i > 0 ? i - 1 : 0];
      const float pr = i == V - 1 ? right : pb[i < V - 1 ? i + 1 : i];
      const float pB = top ? pb[i] : pa[i];
      const float pT = bot ? pb[i] : pt[i];
      u2[i] = uu[i] - 0.5f * (pr - pl);
      v2[i] = vv[i] - 0.5f * (pT - pB);
    }
    if (gy >= c.y0 && gy < c.y1) {
      const size_t row = static_cast<size_t>(gy) * c.w + c.x0;
      wave_store<V>(c.p_out + row, pb, c.x0, c.e0, c.e1);
      wave_store<V>(c.u2 + row, u2, c.x0, c.e0, c.e1);
      wave_store<V>(c.v2 + row, v2, c.x0, c.e0, c.e1);
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (c.x0 + i >= c.e0 && c.x0 + i < c.e1) {
          mu = fluid_nanmax(fabsf(u2[i]), mu);
          mv = fluid_nanmax(fabsf(v2[i]), mv);
        }
    }
  }
}

// One strip and chunk of one member: steps three at a time (the slots'
// rotation), a triple whose stages meet neither the grid's first nor its
// last row on the path without the clamp's row checks.
template <int V, bool FULL, bool FIRST, bool LAST>
__device__ __forceinline__ void pw_plane(const PWave<V>& c, int lane, float& mu, float& mv) {
  constexpr int D = PRESSURE_DEPTH;
  PWaveRegs<V, D> g;
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int s = 0; s < D; ++s) g.W[s][k][i] = 0.f;
      g.G[k][i] = g.U[k][i] = g.Vv[k][i] = 0.f;
    }
  const int steps = c.y1 + c.reach - c.s0;
#pragma unroll
  for (int k = 0; k < WAVE_AHEAD; ++k) {
    pw_load<V, FIRST, LAST>(c, k, lane);
    wave_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; t += 3) {
    const int r = c.s0 + t;
    if (t + 3 <= steps && r - c.reach >= 1 && r + 2 <= c.h - 1) {
      pw_step<V, D, FULL, FIRST, LAST, 0, false>(c, g, t, lane, mu, mv);
      pw_step<V, D, FULL, FIRST, LAST, 1, false>(c, g, t + 1, lane, mu, mv);
      pw_step<V, D, FULL, FIRST, LAST, 2, false>(c, g, t + 2, lane, mu, mv);
    } else {
      pw_step<V, D, FULL, FIRST, LAST, 0, true>(c, g, t, lane, mu, mv);
      if (t + 1 < steps) pw_step<V, D, FULL, FIRST, LAST, 1, true>(c, g, t + 1, lane, mu, mv);
      if (t + 2 < steps) pw_step<V, D, FULL, FIRST, LAST, 2, true>(c, g, t + 2, lane, mu, mv);
    }
  }
  wave_wait<0>();  // the rings, before the next member refills them
}

// One pass over members blockIdx.z, blockIdx.z + gridDim.z, ... < nb; warp
// task = (strip, chunk), strips fastest.  FULL: d is PRESSURE_DEPTH.
template <int V, bool FULL, bool FIRST, bool LAST>
__global__ void __launch_bounds__(32 * PRESSURE_WARPS, PRESSURE_BLOCKS_PER_SM)
pressure_wave_kernel(PressurePass k) {
  using R = PWaveRings<V, FIRST, LAST>;
  __shared__ __align__(16) float ring[PRESSURE_WARPS * R::floats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (FIRST && !LAST && blockIdx.x == 0 && threadIdx.x == 0) {
    // the last pass, later on the stream, takes the maxima into these
    for (int b = blockIdx.z; b < k.nb; b += gridDim.z) k.stats[2 * b] = k.stats[2 * b + 1] = 0.f;
  }
  const long long task = static_cast<long long>(blockIdx.x) * PRESSURE_WARPS + warp;
  if (task >= static_cast<long long>(k.strips) * k.chunks) return;  // the whole warp
  const int j = static_cast<int>(task % k.strips), m = static_cast<int>(task / k.strips);
  PWave<V> c;
  c.ring = ring + warp * R::floats;
  c.dring = c.ring + R::rows * WAVE_RING * R::slot;
  c.h = k.h;
  c.w = k.w;
  c.d = k.d;
  c.reach = k.d + (LAST ? 1 : 0);
  c.half = k.half;
  c.x0 = wave_first(j, k.strips, k.w, 32 * V, c.reach, V) + V * lane;
  c.e0 = wave_exact(j, k.strips, k.w, V);
  c.e1 = wave_exact(j + 1, k.strips, k.w, V);
  c.y0 = static_cast<int>(static_cast<long long>(m) * k.h / k.chunks);
  c.y1 = static_cast<int>(static_cast<long long>(m + 1) * k.h / k.chunks);
  c.s0 = max(c.y0 - c.reach, 0);
  c.lane_in = c.x0 < k.w;
  c.at_left = c.x0 == 0;
  c.at_right = c.x0 + V - 1 == k.w - 1;
  const size_t hw = static_cast<size_t>(k.h) * k.w;
#pragma unroll 1
  for (int b = blockIdx.z; b < k.nb; b += gridDim.z) {
    c.u = fluid_shift(k.u, b * k.u_ms);
    c.v = fluid_shift(k.v, b * k.v_ms);
    c.p_in = fluid_shift(k.p_in, b * hw);
    c.div_in = fluid_shift(k.div_in, b * hw);
    c.p_out = fluid_shift(k.p_out, b * hw);
    c.div_out = fluid_shift(k.div_out, b * hw);
    c.u2 = fluid_shift(k.u2, b * hw);
    c.v2 = fluid_shift(k.v2, b * hw);
    float mu = 0.f, mv = 0.f;
    pw_plane<V, FULL, FIRST, LAST>(c, lane, mu, mv);
    if constexpr (LAST) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mu = fluid_nanmax(mu, __shfl_xor_sync(0xffffffffu, mu, off));
        mv = fluid_nanmax(mv, __shfl_xor_sync(0xffffffffu, mv, off));
      }
      // |x| >= 0 (or NaN with the sign bit clear): int order is float order
      if (lane == 0) {
        atomicMax(reinterpret_cast<int*>(k.stats) + 2 * b, __float_as_int(mu));
        atomicMax(reinterpret_cast<int*>(k.stats) + 2 * b + 1, __float_as_int(mv));
      }
    }
  }
}

template <int V, bool FULL, bool FIRST, bool LAST>
static cudaError_t pressure_pass(const PressurePass& k, cudaStream_t s) {
  const long long tasks = static_cast<long long>(k.strips) * k.chunks;
  const dim3 grid(static_cast<unsigned>((tasks + PRESSURE_WARPS - 1) / PRESSURE_WARPS), 1,
                  fluid_grid_z(k.nb));
  pressure_wave_kernel<V, FULL, FIRST, LAST><<<grid, 32 * PRESSURE_WARPS, 0, s>>>(k);
  return cudaGetLastError();
}

template <bool FIRST, bool LAST>
static cudaError_t pressure_dispatch(int cells, const PressurePass& k, cudaStream_t s) {
  if (cells == 1) return pressure_pass<1, false, FIRST, LAST>(k, s);
  return k.d == PRESSURE_DEPTH ? pressure_pass<4, true, FIRST, LAST>(k, s)
                               : pressure_pass<4, false, FIRST, LAST>(k, s);
}

// u, v in; u2, v2, p out; div, scratch: (h, w) work planes, used when
// npasses >= 2; stats: 2 floats.  cells: columns a lane (4 or 1; 4 takes
// 16-byte rows: w a multiple of 4, the planes 16-byte aligned and the
// member strides multiples of 4); depths, strips, chunks: npasses host
// ints, each pass's sweeps and its strips and chunks (ops/jacobi_cuda.py
// plan_pressure; the last pass reaches one column and row further, for the
// gradient); one pass of depth 0 for iters = 0.  Pass j writes p when
// (npasses-1-j) is even, else scratch, so the last lands in p.  nb members:
// member b's u and v at b * u_ms and b * v_ms floats, its u2, v2, p, div
// and scratch at b * h * w, its stats at 2b.
FLUID_API int fluid_pressure_project(const float* u, const float* v, float* u2, float* v2,
                                     float* p, float* div, float* scratch, float* stats, int h,
                                     int w, int cells, const int* depths, const int* strips,
                                     const int* chunks, int npasses, int half, int nb,
                                     long long u_ms, long long v_ms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || nb < 1 || npasses < 1 || depths == nullptr || strips == nullptr ||
      chunks == nullptr || (cells != 1 && cells != 4))
    return cudaErrorInvalidValue;
  if (npasses >= 2 && (div == nullptr || scratch == nullptr)) return cudaErrorInvalidValue;
  if (cells == 4) {
    const float* planes[] = {u, v, u2, v2, p, div, scratch};
    for (const float* q : planes)
      if (q != nullptr && !wave_aligned(q)) return cudaErrorInvalidValue;
    if (w % 4 != 0 || u_ms % 4 != 0 || v_ms % 4 != 0) return cudaErrorInvalidValue;
  }
  for (int j = 0; j < npasses; ++j) {
    const int d = depths[j], reach = d + (j == npasses - 1 ? 1 : 0);
    if (d < 0 || d > PRESSURE_DEPTH || (d == 0 && npasses > 1) || chunks[j] < 1 ||
        chunks[j] > h || !wave_strips_ok(w, cells, reach, strips[j]))
      return cudaErrorInvalidValue;
  }
  if (npasses == 1) {
    // no first pass before the last to zero the maxima
    const cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(float) * nb, s);
    if (e != cudaSuccess) return e;
  }
  PressurePass k = {u, v, nullptr, div, nullptr, nullptr, u2, v2, stats,
                    h, w, 0, 0, 0, half, nb, u_ms, v_ms};
  for (int j = 0; j < npasses; ++j) {
    const bool first = j == 0, last = j == npasses - 1;
    k.d = depths[j];
    k.strips = strips[j];
    k.chunks = chunks[j];
    k.p_out = ((npasses - 1 - j) % 2 == 0) ? p : scratch;
    k.div_out = first && !last ? div : nullptr;
    const cudaError_t e = first ? (last ? pressure_dispatch<true, true>(cells, k, s)
                                        : pressure_dispatch<true, false>(cells, k, s))
                                : (last ? pressure_dispatch<false, true>(cells, k, s)
                                        : pressure_dispatch<false, false>(cells, k, s));
    if (e != cudaSuccess) return e;
    k.p_in = k.p_out;
  }
  return cudaSuccess;
}

// fluid_pressure_project's parameters as one record, in their order: a
// prepared launch (ops/jacobi_cuda.py PressureArgs, which mirrors this
// layout) fills it once and sets only the fields that change before each
// call.
struct FluidPressureProjectArgs {
  const float *u, *v;
  float *u2, *v2, *p, *div, *scratch, *stats;
  int h, w, cells;
  const int *depths, *strips, *chunks;
  int npasses, half, nb;
  long long u_ms, v_ms;
  void* stream;
};
static_assert(sizeof(FluidPressureProjectArgs) == 144,
              "ops/jacobi_cuda.py PressureArgs mirrors it");

FLUID_API int fluid_pressure_project_args(const FluidPressureProjectArgs* a) {
  return fluid_pressure_project(a->u, a->v, a->u2, a->v2, a->p, a->div, a->scratch, a->stats,
                                a->h, a->w, a->cells, a->depths, a->strips, a->chunks,
                                a->npasses, a->half, a->nb, a->u_ms, a->v_ms, a->stream);
}

// -- the standalone solve: trapezoid bursts ------------------------------------

struct PressureBurst {
  const float* div_in;
  const float* p_in;    // read unless from_zero
  float* p_out;         // the tile
  int h, w, tile_h, tile_w, depth, from_zero;
};

// One burst: depth sweeps with halo depth.  Shared memory: two iterates a,
// b and the divergence, each tile +- halo.
__device__ __forceinline__ void pressure_burst_tile(const PressureBurst& k, float4* smem4) {
  const int h = k.h, w = k.w;
  const int halo = k.depth;
  const BurstTile t = burst_tile(h, w, k.tile_h, k.tile_w, halo);
  const int st = t.stride;
  const int nbuf = burst_rows(h, k.tile_h, halo) * st;
  float* a = reinterpret_cast<float*>(smem4);
  float* b = a + nbuf;
  float* div = b + nbuf;
  auto op = [](float l, float r, float bo, float to, float, float d) {
    return (l + r + bo + to - d) * 0.25f;
  };
  burst_fill(div, k.div_in, w, t);
  if (!k.from_zero) burst_fill(a, k.p_in, w, t);
  __syncthreads();
  int first = 1;
  if (k.from_zero) {
    // the first sweep from p = 0 (every tap zero) over tile +- (halo - 1)
    const BurstSpan sp = burst_span(t, h, w, halo - 1);
    for (int r = sp.r0 + threadIdx.y; r < sp.r1; r += BURST_NY)
      for (int c = (sp.c0 & ~3) + 4 * threadIdx.x; c < sp.c1; c += 128) {
        const float4 d = burst_ld4(div + r * st + c);
        burst_st4(a + r * st + c, make_float4((0.f - d.x) * 0.25f, (0.f - d.y) * 0.25f,
                                              (0.f - d.z) * 0.25f, (0.f - d.w) * 0.25f));
      }
    __syncthreads();
    first = 2;
  }
  // sweeps first..depth-1 in shared memory
  const float* dv = div;
  for (int j = first; j <= k.depth - 1; ++j) {
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
  // the last sweep, the tile only, to device memory (depth 1 from zero has
  // done it: copy the tile)
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
}

__global__ void __launch_bounds__(BURST_THREADS, 2)
pressure_burst_kernel(PressureBurst k) {
  extern __shared__ float4 smem4[];
  pressure_burst_tile(k, smem4);
}

// div in; p out; scratch: (h, w), used when nbursts >= 2.  init: the
// (h, w) iterate the sweeps continue from (the sharded rollout chains its
// bursts across halo exchanges, as jacobi_pallas.py pressure_solve's init
// does), or null to start from p = 0 with the first sweep's shortcut.
// depths: nbursts host ints (ops/jacobi_cuda.py plan_bursts, kind "solve"),
// burst j writing p when (nbursts-1-j) is even, else scratch, so the last
// lands in p.  nbursts = 0 (iters = 0) zeroes p, or copies init into it.
FLUID_API int fluid_pressure_solve(const float* div, float* p, float* scratch,
                                   int h, int w, int tile_h, int tile_w,
                                   const int* depths, int nbursts,
                                   const float* init, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || nbursts < 0) return cudaErrorInvalidValue;
  if (nbursts == 0)
    return init == nullptr
               ? cudaMemsetAsync(p, 0, sizeof(float) * h * w, s)
               : cudaMemcpyAsync(p, init, sizeof(float) * h * w, cudaMemcpyDeviceToDevice, s);
  if (tile_h < 1 || tile_w < 1 || depths == nullptr || (nbursts >= 2 && scratch == nullptr))
    return cudaErrorInvalidValue;
  size_t smem = 0;
  for (int j = 0; j < nbursts; ++j) {
    if (depths[j] < 1) return cudaErrorInvalidValue;
    const size_t b = burst_smem_bytes(3, h, w, tile_h, tile_w, depths[j]);
    if (b > smem) smem = b;
  }
  cudaError_t e = burst_allow_smem(pressure_burst_kernel, smem);
  if (e != cudaSuccess) return e;
  const float* p_in = init;
  for (int j = 0; j < nbursts; ++j) {
    PressureBurst b = {div, p_in, ((nbursts - 1 - j) % 2 == 0) ? p : scratch,
                       h, w, tile_h, tile_w, depths[j], p_in == nullptr};
    pressure_burst_kernel<<<burst_grid(h, w, tile_h, tile_w), dim3(32, BURST_NY),
                            burst_smem_bytes(3, h, w, tile_h, tile_w, depths[j]), s>>>(b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    p_in = b.p_out;
  }
  return cudaSuccess;
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
