// Helpers shared by the stable-fluids kernels.
//
// Every kernel is a plain C entry point: it launches on the stream it is
// given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <vector>

#define FLUID_API extern "C" __attribute__((visibility("default")))

// Thread block of the 2-D kernels: 32 columns (one warp, coalesced rows)
// by 8 rows.
#define FLUID_BX 32
#define FLUID_BY 8

FLUID_API const char* fluid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ int fluid_clamp(int i, int n) {
  return min(max(i, 0), n - 1);
}

// max that keeps a NaN, so a NaN field gives a NaN bound, as the plain
// version's reduction does.
__device__ __forceinline__ float fluid_nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Block-wide max of two values, then one atomicMax each into out[0..1].
// The values are |x| >= 0 (or NaN with the sign bit clear), and for those
// the order of the int bits is the order of the floats, so an int atomicMax
// is a float max.  out[] must hold 0 before the first block arrives.
__device__ __forceinline__ void fluid_block_max2_atomic(float a, float b,
                                                        float* out) {
  __shared__ float sa[FLUID_BX * FLUID_BY / 32];
  __shared__ float sb[FLUID_BX * FLUID_BY / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a = fluid_nanmax(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = fluid_nanmax(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y) / 32;
  if ((tid & 31) == 0) {
    sa[tid >> 5] = a;
    sb[tid >> 5] = b;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < nwarps; ++i) {
      a = fluid_nanmax(a, sa[i]);
      b = fluid_nanmax(b, sb[i]);
    }
    atomicMax(reinterpret_cast<int*>(out), __float_as_int(a));
    atomicMax(reinterpret_cast<int*>(out) + 1, __float_as_int(b));
  }
}

// Let `kernel` take the most dynamic shared memory a block may have on the
// current device beside its static arrays, and with carveout >= 0 prefer
// that shared carveout; `bytes`, what this launch takes, is refused above
// the cap.
// Every caller sets the same cap: the shard threads of a mesh launch one
// kernel at once with plans of different sizes (two ens groups drift a
// burst apart), and a cap set to one plan's bytes could refuse another
// thread's larger launch between that thread's own set and its launch
// (cudaErrorInvalidValue).  The attributes are set once a (kernel, device)
// and the cap remembered, so a launch costs a cudaGetDevice and a lookup.
template <class K>
static inline cudaError_t fluid_allow_smem(K kernel, size_t bytes, int carveout = -1) {
  struct Cap {
    const void* kernel;
    int dev, dynamic;
  };
  static std::mutex mu;
  static std::vector<Cap> caps;
  const void* key = reinterpret_cast<const void*>(kernel);
  int dev = 0, dynamic = -1;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> g(mu);
    for (const Cap& c : caps)
      if (c.kernel == key && c.dev == dev) dynamic = c.dynamic;
  }
  if (dynamic < 0) {
    int cap = 0;
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return e;
    dynamic = cap - static_cast<int>(a.sharedSizeBytes);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (e != cudaSuccess) return e;
    if (carveout >= 0) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
      if (e != cudaSuccess) return e;
    }
    std::lock_guard<std::mutex> g(mu);
    caps.push_back({key, dev, dynamic});
  }
  return bytes > static_cast<size_t>(dynamic) ? cudaErrorInvalidValue : cudaSuccess;
}

static inline dim3 fluid_grid2d(int h, int w, int z = 1) {
  return dim3((w + FLUID_BX - 1) / FLUID_BX, (h + FLUID_BY - 1) / FLUID_BY, z);
}

// Batched kernels take their member (or plane) index from blockIdx.z.  The
// grid's z extent stops at 65535, so a block walks z, z + gridDim.z, ...:
// any count of members runs in one launch.
#define FLUID_MAX_GRID_Z 65535

static inline int fluid_grid_z(int n) {
  return n < FLUID_MAX_GRID_Z ? n : FLUID_MAX_GRID_Z;
}

// Hide v's value from the compiler for one loop iteration.  A kernel that
// walks members keeps its per-member body's register count only when the
// compiler cannot hoist the body's index arithmetic (loop-invariant, all of
// it derived from the shape and the thread index) out of the member loop
// and hold it live across every member.
__device__ __forceinline__ int fluid_opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// p moved by off floats, null staying null.
template <class T>
__device__ __forceinline__ T* fluid_shift(T* p, size_t off) {
  return p != nullptr ? p + off : p;
}
