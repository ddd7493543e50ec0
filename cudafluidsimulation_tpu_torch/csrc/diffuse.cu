// H3: Jacobi diffusion sweeps as a row-streaming wavefront, with the
// optional splat tail on the last one.
//
// Replaces cudafluidsimulation_tpu/ops/jacobi_pallas.py _diffuse_bursts ->
// _diffuse_kernel and _diffuse_burst_tiled -> _diffuse_kernel_tiled
// (entries diffuse, diffuse_multi, diffuse_multi_splat).  A sweep is
//   x' = (L + R + B + T + alpha*x) * (1/beta)
// with clamped taps and alpha, 1/beta per channel; the centre term is the
// current iterate, so a sweep reads only the sweep before it (an in-place
// update would be a different operator).  The gpu-variant splat
// f[c] += amp[c] * exp(-d2(last)/radius) rides the last sweep.
//
// What bounds it on an H100: a sweep is 6 flops and 8 bytes of device
// traffic a cell, so a launch per sweep (the first design, 2.45 ms for 5
// channels x 20 sweeps at 2048²) is bound by device memory.  The trapezoid
// bursts that followed (csrc/burst.cuh, 0.52 ms, 3 launches) moved the
// bound to the SMs' issue: every sweep of a tile in shared memory paid a
// 16-byte shared load and store, shuffles and a block barrier, over a tile
// and halo 1.29x the cells kept, at about half the issue rate.
//
// The design here (2.5-D temporal blocking, as AN5D): a pass carries d <=
// DIFFUSE_DEPTH sweeps down a column strip in one warp's registers.  Lane l
// owns V neighbouring columns; the warp marches down a chunk of rows, one
// row a step, and stage k (1..d) computes sweep k one row behind stage
// k - 1, from the three rows of sweep k - 1 it keeps in registers (the
// vertical taps cost nothing) and the two outer horizontal taps by shuffle.
// No shared-memory traffic or barrier is left in the sweep loop; shared
// memory holds only the input rows in flight (cp.async, a ring of
// WAVE_RING rows a warp; csrc/wave.cuh).  A strip's outer columns are its only halo:
// they go stale one column a sweep, so a strip of 32 V columns keeps the
// 32 V - 2d in the middle (at a physical edge the clamp is true, so nothing
// is lost there), and a chunk starts d rows early and ends d rows late.
// 20 sweeps are two passes over device memory.  A lane takes 4 cells (8
// would halve the stale columns' share but spill at 255 registers); 4
// warps a block, 2 blocks an SM (~200 registers a thread).  What bounds it
// now is the SMs' issue, ~7 instructions a cell-sweep (6 flops, the two
// shuffles and edge selects a lane's 4 cells share) over 1.37x the cells
// kept at 2048² (128-column strips keep 108; 10 chunks' lead-in rows), at
// about half the issue rate with 8 warps an SM, overlapped with the two
// passes' device traffic; the planner in ops/jacobi_cuda.py (plan_diffuse)
// fits the chunks to one wave of blocks where it can.  Measured 0.252 ms
// device for 5 channels x 20 sweeps with the splat at 2048² (2 launches),
// 1.09 ms for 64 x 5 planes of 512², on an NVIDIA H100 80GB HBM3 at 700 W.
// Arithmetic order is the plain version's, built without FMA contraction:
// bit-identical without the splat, and the splat is the trapezoid design's
// own expression.
//
// Strips and chunks: csrc/wave.cuh (ops/jacobi_cuda.py strip_spans).
//
// Planes: a launch sweeps n planes, plane z = blockIdx.z (and every
// gridDim.z after it), with no cap on n.  A batch of B members of C
// channels (ensembles) is n = B*C planes, and each plane takes alpha,
// 1/beta and amp of its own and the splat centre of its member from row
// z / C of a device array, so a sweep over viscosities is one launch a
// pass.  A single call of at most 8 planes takes them by value instead.
#include "wave.cuh"

#define FLUID_MAX_CHANNELS 8
// the pipeline's stages: the most sweeps one pass carries
#define DIFFUSE_DEPTH 10
// warps a block, each on a strip and chunk of its own, and the blocks an SM
// the registers are sized for (255 a thread: 4 cells a lane take ~200)
#define DIFFUSE_WARPS 4
#define DIFFUSE_BLOCKS_PER_SM 2

// The by-value parameters of a call of at most FLUID_MAX_CHANNELS planes.
struct DiffuseParams {
  float alpha[FLUID_MAX_CHANNELS];
  float inv_beta[FLUID_MAX_CHANNELS];
  float amp[FLUID_MAX_CHANNELS];
  float lx, ly, radius;
};

// Per-plane parameters in device memory: row b (prm_stride floats apart)
// holds member b's [alpha[0..C), inv_beta[0..C), amp[0..C), lx, ly].
struct DiffuseRows {
  const float* prm;
  int prm_stride, chans;
};

struct PlaneParams {
  float alpha, inv_beta, amp, lx, ly;
};

__device__ __forceinline__ PlaneParams plane_params(const DiffuseParams& p,
                                                    const DiffuseRows& r, int z) {
  if (r.prm == nullptr) return {p.alpha[z], p.inv_beta[z], p.amp[z], p.lx, p.ly};
  const int b = z / r.chans, ch = z - b * r.chans;
  const float* row = r.prm + static_cast<size_t>(b) * r.prm_stride;
  return {row[ch], row[r.chans + ch], row[2 * r.chans + ch], row[3 * r.chans],
          row[3 * r.chans + 1]};
}

__device__ __forceinline__ float splat_tail(float val, int gx, int gy,
                                            const PlaneParams& q, float radius) {
  const float dx = static_cast<float>(gx) - q.lx;
  const float dy = static_cast<float>(gy) - q.ly;
  const float d2 = dx * dx + dy * dy;
  return val + q.amp * expf(-d2 / radius);
}

// One warp's strip and chunk of one plane.
template <int V>
struct Wave {
  const float* src;
  float* dst;
  float* ring;      // WAVE_RING slots of 32 * V floats
  int h, w, d;
  int x0;           // this lane's first column
  int e0, e1;       // the columns the strip keeps
  int y0, y1, s0;   // the rows the chunk keeps, and the first row it loads
  bool lane_in;     // the lane's columns lie in the grid
  bool at_left;     // its first column is the grid's first
  bool at_right;    // its last column is the grid's last
  float alpha, inv_beta, radius;
  PlaneParams q;
  int splat;
};

// Start the copy of input row r (zeros past the grid) into a ring slot.
template <int V>
__device__ __forceinline__ void diffuse_load(const Wave<V>& c, int r, int slot, int lane) {
  const bool on = c.lane_in && r < c.h;
  wave_load<V>(c.ring + slot * 32 * V, c.src + (on ? static_cast<size_t>(r) * c.w + c.x0 : 0),
               on, lane);
}

// The last stage's row gy, with the splat, into the columns the strip keeps.
template <int V>
__device__ __forceinline__ void diffuse_store(const Wave<V>& c, float (&o)[V], int gy) {
  if (c.splat) {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = splat_tail(o[i], c.x0 + i, gy, c.q, c.radius);
  }
  wave_store<V>(c.dst + static_cast<size_t>(gy) * c.w + c.x0, o, c.x0, c.e0, c.e1);
}

// Where stage S writes its row: the next stage's newest slot, or o.
template <int S, int V, int D, int PHASE>
__device__ __forceinline__ auto& stage_out(float (&W)[D][3][V], float (&o)[V]) {
  if constexpr (S + 1 < D)
    return W[S + 1][PHASE];
  else
    return o;
}

// Stage S + 1 of one step: sweep S + 1 at row r - (S + 1), from the rows
// r - S - 2 (a), r - S - 1 (b) and r - S (c) of sweep S in W[S] (the slots
// rotate with the step, PHASE = step mod 3).  Stages past a pass's depth
// (FULL false) hand their input on unchanged.  CHECK: some stage of this
// step may meet the grid's first or last row, whose B or T tap is itself.
template <int S, int V, int D, bool FULL, int PHASE, bool CHECK>
__device__ __forceinline__ void diffuse_stages(const Wave<V>& c, float (&W)[D][3][V],
                                            float (&o)[V], int r) {
  if constexpr (S < D) {
    auto& out = stage_out<S, V, D, PHASE>(W, o);
    if (!FULL && S >= c.d) {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = W[S][PHASE][i];
    } else {
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
        out[i] = (L + R + B + T + b[i] * c.alpha) * c.inv_beta;
      }
    }
    diffuse_stages<S + 1, V, D, FULL, PHASE, CHECK>(c, W, o, r);
  }
}

// Step t: input row r = s0 + t from the ring into W[0], the copy of row
// r + WAVE_AHEAD started, every stage, and the last stage's row r - d
// stored when the chunk keeps it.
template <int V, int D, bool FULL, int PHASE, bool CHECK>
__device__ __forceinline__ void diffuse_step(const Wave<V>& c, float (&W)[D][3][V], int t,
                                          int lane) {
  const int r = c.s0 + t;
  wave_wait<WAVE_AHEAD - 1>();
  wave_read<V>(c.ring + t % WAVE_RING * 32 * V, W[0][PHASE], lane);
  diffuse_load<V>(c, r + WAVE_AHEAD, (t + WAVE_AHEAD) % WAVE_RING, lane);
  wave_commit();
  float o[V];
  diffuse_stages<0, V, D, FULL, PHASE, CHECK>(c, W, o, r);
  const int gy = r - c.d;
  if (gy >= c.y0 && gy < c.y1) diffuse_store<V>(c, o, gy);
}

// One strip and chunk of one plane: steps three at a time (the slots'
// rotation), a triple with no stage at the grid's first or last row on the
// path without the clamp's row checks.
template <int V, bool FULL>
__device__ __forceinline__ void diffuse_plane(const Wave<V>& c, int lane) {
  constexpr int D = DIFFUSE_DEPTH;
  float W[D][3][V];
#pragma unroll
  for (int s = 0; s < D; ++s)
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) W[s][k][i] = 0.f;
  const int steps = c.y1 + c.d - c.s0;
#pragma unroll
  for (int k = 0; k < WAVE_AHEAD; ++k) {
    diffuse_load<V>(c, c.s0 + k, k, lane);
    wave_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; t += 3) {
    const int r = c.s0 + t;
    if (t + 3 <= steps && r - c.d >= 1 && r + 2 <= c.h - 1) {
      diffuse_step<V, D, FULL, 0, false>(c, W, t, lane);
      diffuse_step<V, D, FULL, 1, false>(c, W, t + 1, lane);
      diffuse_step<V, D, FULL, 2, false>(c, W, t + 2, lane);
    } else {
      diffuse_step<V, D, FULL, 0, true>(c, W, t, lane);
      if (t + 1 < steps) diffuse_step<V, D, FULL, 1, true>(c, W, t + 1, lane);
      if (t + 2 < steps) diffuse_step<V, D, FULL, 2, true>(c, W, t + 2, lane);
    }
  }
  wave_wait<0>();  // the ring, before the next plane refills it
}

// One pass of d sweeps over planes blockIdx.z, blockIdx.z + gridDim.z, ...
// < n; warp task = (strip, chunk), strips fastest.  FULL: d is the
// template's depth.
template <int V, bool FULL>
__global__ void __launch_bounds__(32 * DIFFUSE_WARPS, DIFFUSE_BLOCKS_PER_SM)
diffuse_wave_kernel(const float* __restrict__ src, float* __restrict__ dst, int n, int h,
                    int w, int d, int strips, int chunks, DiffuseParams p, DiffuseRows rows,
                    int splat) {
  __shared__ __align__(16) float ring[DIFFUSE_WARPS * WAVE_RING * 32 * V];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long task = static_cast<long long>(blockIdx.x) * DIFFUSE_WARPS + warp;
  if (task >= static_cast<long long>(strips) * chunks) return;  // the whole warp
  const int j = static_cast<int>(task % strips), k = static_cast<int>(task / strips);
  Wave<V> c;
  c.ring = ring + warp * WAVE_RING * 32 * V;
  c.h = h;
  c.w = w;
  c.d = d;
  c.x0 = wave_first(j, strips, w, 32 * V, d, V) + V * lane;
  c.e0 = wave_exact(j, strips, w, V);
  c.e1 = wave_exact(j + 1, strips, w, V);
  c.y0 = static_cast<int>(static_cast<long long>(k) * h / chunks);
  c.y1 = static_cast<int>(static_cast<long long>(k + 1) * h / chunks);
  c.s0 = max(c.y0 - d, 0);
  c.lane_in = c.x0 < w;
  c.at_left = c.x0 == 0;
  c.at_right = c.x0 + V - 1 == w - 1;
  c.radius = p.radius;
  c.splat = splat;
  const size_t hw = static_cast<size_t>(h) * w;
#pragma unroll 1
  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    c.q = plane_params(p, rows, z);
    c.alpha = c.q.alpha;
    c.inv_beta = c.q.inv_beta;
    c.src = src + z * hw;
    c.dst = dst + z * hw;
    diffuse_plane<V, FULL>(c, lane);
  }
}

// The splat alone (no sweeps).
__global__ void __launch_bounds__(256)
diffuse_splat_kernel(const float* __restrict__ src, float* __restrict__ dst, int n, int h,
                     int w, DiffuseParams p, DiffuseRows rows) {
  const size_t hw = static_cast<size_t>(h) * w;
#pragma unroll 1
  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    const PlaneParams q = plane_params(p, rows, z);
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < hw;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
      const int y = static_cast<int>(i / w), x = static_cast<int>(i - static_cast<size_t>(y) * w);
      dst[z * hw + i] = splat_tail(src[z * hw + i], x, y, q, p.radius);
    }
  }
}

template <int V, bool FULL>
static cudaError_t diffuse_pass(const float* src, float* dst, int n, int h, int w, int d,
                                int strips, int chunks, const DiffuseParams& p,
                                const DiffuseRows& rows, int splat, cudaStream_t s) {
  const long long tasks = static_cast<long long>(strips) * chunks;
  const dim3 grid(static_cast<unsigned>((tasks + DIFFUSE_WARPS - 1) / DIFFUSE_WARPS), 1,
                  fluid_grid_z(n));
  diffuse_wave_kernel<V, FULL><<<grid, 32 * DIFFUSE_WARPS, 0, s>>>(src, dst, n, h, w, d, strips,
                                                                   chunks, p, rows, splat);
  return cudaGetLastError();
}

static cudaError_t diffuse_dispatch(int cells, const float* src, float* dst, int n, int h, int w,
                                    int d, int strips, int chunks, const DiffuseParams& p,
                                    const DiffuseRows& rows, int splat, cudaStream_t s) {
  if (cells == 1)
    return diffuse_pass<1, false>(src, dst, n, h, w, d, strips, chunks, p, rows, splat, s);
  return d == DIFFUSE_DEPTH
             ? diffuse_pass<4, true>(src, dst, n, h, w, d, strips, chunks, p, rows, splat, s)
             : diffuse_pass<4, false>(src, dst, n, h, w, d, strips, chunks, p, rows, splat, s);
}

// in, out, scratch: n (h, w) planes; scratch is needed when npasses >= 2.
// cells: columns a lane (4 or 1; 4 takes 16-byte rows: w a multiple of 4
// and the planes 16-byte aligned); depths, strips, chunks:
// npasses host ints, each pass's sweeps and its strips and chunks
// (ops/jacobi_cuda.py plan_diffuse); a depth of 0 (one pass only) is the
// splat alone, added on the last pass when splat != 0.  Parameters: with
// prm null, n <= 8 and alpha, inv_beta (and amp with the splat) are n host
// floats, lx, ly the splat centre; with prm, plane z's come from row z /
// chans of the device array prm (DiffuseRows), and the host arrays are not
// read.  radius: the splat's, by value.
FLUID_API int fluid_diffuse(const float* in, float* out, float* scratch, int n, int h, int w,
                            int cells, const int* depths, const int* strips, const int* chunks,
                            int npasses, const float* alpha, const float* inv_beta,
                            const float* amp, float lx, float ly, float radius, int splat,
                            const float* prm, int prm_stride, int chans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || h < 1 || w < 1 || npasses < 1 || depths == nullptr || strips == nullptr ||
      chunks == nullptr || (cells != 1 && cells != 4))
    return cudaErrorInvalidValue;
  if (prm == nullptr ? (n > FLUID_MAX_CHANNELS || alpha == nullptr || inv_beta == nullptr ||
                        (splat && amp == nullptr))
                     : (chans < 1 || n % chans != 0 || prm_stride < 3 * chans + 2))
    return cudaErrorInvalidValue;
  if (npasses >= 2 && scratch == nullptr) return cudaErrorInvalidValue;
  if (cells == 4 && (w % 4 != 0 || !wave_aligned(in) || !wave_aligned(out) ||
                     (scratch != nullptr && !wave_aligned(scratch))))
    return cudaErrorInvalidValue;
  for (int j = 0; j < npasses; ++j) {
    const int d = depths[j];
    if (d < 0 || d > DIFFUSE_DEPTH || (d == 0 && (npasses > 1 || !splat)))
      return cudaErrorInvalidValue;
    if (d > 0 && (chunks[j] < 1 || chunks[j] > h || !wave_strips_ok(w, cells, d, strips[j])))
      return cudaErrorInvalidValue;
  }
  DiffuseParams p = {};
  if (prm == nullptr) {
    for (int i = 0; i < n; ++i) {
      p.alpha[i] = alpha[i];
      p.inv_beta[i] = inv_beta[i];
      p.amp[i] = splat ? amp[i] : 0.f;
    }
    p.lx = lx;
    p.ly = ly;
  }
  p.radius = radius;
  const DiffuseRows rows = {prm, prm_stride, chans};
  if (depths[0] == 0) {
    const size_t hw = static_cast<size_t>(h) * w;
    const unsigned bx = static_cast<unsigned>(hw < 256 * 1024 ? (hw + 255) / 256 : 1024);
    diffuse_splat_kernel<<<dim3(bx, 1, fluid_grid_z(n)), 256, 0, s>>>(in, out, n, h, w, p, rows);
    return cudaGetLastError();
  }
  // pass j writes out when (npasses-1-j) is even, so the last lands in out
  const float* src = in;
  for (int j = 0; j < npasses; ++j) {
    float* dst = ((npasses - 1 - j) % 2 == 0) ? out : scratch;
    const cudaError_t e = diffuse_dispatch(cells, src, dst, n, h, w, depths[j], strips[j],
                                           chunks[j], p, rows, splat && j == npasses - 1, s);
    if (e != cudaSuccess) return e;
    src = dst;
  }
  return cudaSuccess;
}

// fluid_diffuse's parameters as one record, in their order: a prepared
// launch (ops/jacobi_cuda.py DiffuseArgs, which mirrors this layout) fills
// it once and sets only the fields that change before each call.
struct FluidDiffuseArgs {
  const float* in;
  float *out, *scratch;
  int n, h, w, cells;
  const int *depths, *strips, *chunks;
  int npasses;
  const float *alpha, *inv_beta, *amp;
  float lx, ly, radius;
  int splat;
  const float* prm;
  int prm_stride, chans;
  void* stream;
};
static_assert(sizeof(FluidDiffuseArgs) == 136, "ops/jacobi_cuda.py DiffuseArgs mirrors it");

FLUID_API int fluid_diffuse_args(const FluidDiffuseArgs* a) {
  return fluid_diffuse(a->in, a->out, a->scratch, a->n, a->h, a->w, a->cells, a->depths,
                       a->strips, a->chunks, a->npasses, a->alpha, a->inv_beta, a->amp, a->lx,
                       a->ly, a->radius, a->splat, a->prm, a->prm_stride, a->chans, a->stream);
}
