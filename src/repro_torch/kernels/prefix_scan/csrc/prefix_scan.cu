// One-pass inclusive prefix sum along the rows of a [R, N] array, for
// NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/prefix_scan/kernel.py::prefix_scan_pallas (the
// TPU Pallas kernel): out[r, i] = x[r, 0] + ... + x[r, i], accumulated in
// fp32 for fp32 and bf16 inputs (each output rounded to the input's type)
// and in 32-bit integers for int32 inputs.  The integer sums are done in
// uint32, so an overflow wraps as jnp.cumsum's does instead of being
// undefined behaviour.
//
// The paper's one-pass strategy: one place walks a row's blocks in order
// and carries the running total, with no scan of block sums and no fix-up
// pass.  The TPU gets the order from its sequential grid axis.  CUDA gives
// no order between blocks, so here one block takes one row and walks its
// tiles in ascending order, with the carry in a register.  Each tile is
// loaded with coalesced reads into shared memory (padded against bank
// conflicts), every thread scans ITEMS consecutive elements, a warp-shuffle
// scan joins the threads of a warp, and one warp scans the warp totals.
// The next tile's loads are issued into registers before this tile is
// scanned, so their latency overlaps the scan.  The ragged end of a row is
// masked, not padded.  Two tiles: 1024 elements (128 threads) for rows of
// at most 1024, else 4096 (512 threads).
//
// What bounds it on an H100: bytes, x read once and the output written
// once (2 R N elements; 128 MB for R = N = 4096 in fp32, ~40 us at
// 3.35 TB/s); the R N additions are nothing beside them.  Many rows fill
// the card.  A few long rows do not: one row is one SM's sequential walk,
// the case that decoupled look-back (blocks take tiles in order from a
// counter and chain their carries through device memory) serves, a later
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ITEMS = 8;  // consecutive elements per thread

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ unsigned to_acc(int x) {
  return static_cast<unsigned>(x);
}

template <typename T, typename A>
__device__ __forceinline__ T from_acc(A x);
template <>
__device__ __forceinline__ float from_acc<float, float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(
    float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ int from_acc<int, unsigned>(unsigned x) {
  return static_cast<int>(x);
}

// shared index with one pad word every 32: thread t reads elements
// t * ITEMS + j, which then fall in 32 distinct banks across a warp
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <typename T, typename A, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
    prefix_scan_kernel(const T* __restrict__ x, T* __restrict__ out, long n) {
  constexpr int TILE = BLOCK * ITEMS;
  constexpr int NW = BLOCK / 32;
  __shared__ A tile[TILE + TILE / 32];
  __shared__ A warp_tot[NW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (long)blockIdx.x * n;
  T* orow = out + (long)blockIdx.x * n;

  A nxt[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long g = (long)i * BLOCK + tid;
    nxt[i] = g < n ? to_acc(xr[g]) : A(0);
  }
  A carry = A(0);
  for (long t0 = 0; t0 < n; t0 += TILE) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) tile[pad(i * BLOCK + tid)] = nxt[i];
    // the next tile's loads, in flight while this one is scanned
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long g = t0 + TILE + (long)i * BLOCK + tid;
      nxt[i] = g < n ? to_acc(xr[g]) : A(0);
    }
    __syncthreads();
    A a[ITEMS];
    A run = A(0);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      run = run + tile[pad(tid * ITEMS + j)];
      a[j] = run;
    }
    A incl = run;  // inclusive scan of the thread totals within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const A o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = incl + o;
    }
    A prev = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) prev = A(0);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      A wt = lane < NW ? warp_tot[lane] : A(0);
#pragma unroll
      for (int off = 1; off < NW; off <<= 1) {
        const A o = __shfl_up_sync(0xffffffffu, wt, off);
        if (lane >= off) wt = wt + o;
      }
      if (lane < NW) warp_tot[lane] = wt;
    }
    __syncthreads();
    const A base = carry + (warp > 0 ? warp_tot[warp - 1] : A(0)) + prev;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) tile[pad(tid * ITEMS + j)] = base + a[j];
    carry = carry + warp_tot[NW - 1];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long g = t0 + (long)i * BLOCK + tid;
      if (g < n) orow[g] = from_acc<T, A>(tile[pad(i * BLOCK + tid)]);
    }
    __syncthreads();  // tile and warp_tot are rewritten by the next tile
  }
}

template <typename T, typename A>
cudaError_t launch(const void* x, void* out, int rows, long n,
                   cudaStream_t stream) {
  if (n <= 128 * ITEMS)
    prefix_scan_kernel<T, A, 128><<<rows, 128, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n);
  else
    prefix_scan_kernel<T, A, 512><<<rows, 512, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int32.  x and out [rows, n],
// contiguous.  Returns cudaGetLastError() after the launch (0 = ok).
int prefix_scan_fwd(int dtype, const void* x, void* out, int rows, long n,
                    void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, float>(x, out, rows, n, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, float>(x, out, rows, n, st);
  if (dtype == 2) return (int)launch<int, unsigned>(x, out, rows, n, st);
  return (int)cudaErrorInvalidValue;
}

const char* prefix_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
