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
// The paper's one-pass strategy: tiles are taken in order from a global
// counter and each folds in the running total of the tiles before it, with
// no scan of tile sums and no fix-up pass.  The TPU gets the order from its
// sequential grid axis.  Here it is decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back"):
//
//   * Tiles.  The tiles of all rows are numbered row * tiles_per_row + j.
//     A block takes its tile from a device counter with atomicAdd, not from
//     blockIdx, so every tile it waits on was taken by a block that is
//     already running: the look-back cannot deadlock.
//   * Scan of a tile.  Coalesced loads into shared memory (padded against
//     bank conflicts), every thread scans ITEMS consecutive elements, a
//     warp-shuffle scan joins the threads of a warp, and one warp scans the
//     warp totals.  The ragged end of a row is masked, not padded.
//   * Publishing.  Each tile publishes its aggregate as soon as it is
//     known, and its inclusive prefix once its carry is known: flag (high 32
//     bits) and value (low 32 bits) in one 64-bit status word, stored with
//     st.release.gpu and read with ld.acquire.gpu.  The accumulator is 32
//     bits for every dtype, so it fits beside the flag.  A row's first tile
//     publishes its prefix at once.
//   * Look-back.  Warp 0 reads the status of 32 predecessors at a time,
//     waits until every word up to the nearest published prefix is set,
//     sums the aggregates up to and including that prefix, and stops there
//     (at the latest at the row's first tile).
//   * Rows of one tile (tiles_per_row == 1) take their tile from blockIdx,
//     publish nothing and need no scratch: the R = N = 4096 rows do the same
//     work as a kernel with one block a row.
//
// Numerics.  int32 is exact and wraps.  A float carry is a sum of tile
// aggregates whose grouping depends on how far each look-back went, which
// depends on timing: fp32 and bf16 results may differ in the last bits from
// run to run (within 1e-6 of the row's sum of |x|, plus one bf16 ulp).
//
// Tiles: 128 x 8 elements (threads x items) for rows of at most 1024,
// 512 x 8 for rows of at most 4096 (one tile a row), else 512 x 16: each
// look-back costs L2 round trips, so longer rows take half as many tiles.
//
// What bounds it on an H100: bytes, x read once and the output written
// once (2 R N elements; 128 MB for R = 1, N = 2^24 in fp32, ~40 us at
// 3.35 TB/s); the R N additions and the 8-byte status word a tile are
// nothing beside them.  With look-back a few long rows fill the card as
// many rows do; the chain of published prefixes (one L2 round trip per 32
// tiles a look-back walks) is what keeps a long row above the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// status word flags (high 32 bits); 0 = not yet published
constexpr unsigned kAggregate = 1u, kPrefix = 2u;

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

__device__ __forceinline__ unsigned bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned bits(unsigned x) { return x; }
template <typename A>
__device__ __forceinline__ A from_bits(unsigned x);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned x) {
  return __uint_as_float(x);
}
template <>
__device__ __forceinline__ unsigned from_bits<unsigned>(unsigned x) {
  return x;
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned flag, unsigned value) {
  const unsigned long long w =
      (static_cast<unsigned long long>(flag) << 32) | value;
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(word), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(word)
               : "memory");
  return w;
}

// shared index with one pad word every 32: thread t reads elements
// t * ITEMS + j, which then fall in 32 distinct banks across a warp
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// status: [rows * tiles_per_row] words, then the tile counter; both zeroed
// by the caller.  Null when tiles_per_row == 1.
// BLOCK threads scan a tile of BLOCK * ITEMS elements, ITEMS consecutive
// elements a thread.
template <typename T, typename A, int BLOCK, int ITEMS>
__global__ void __launch_bounds__(BLOCK, 2)
    prefix_scan_kernel(const T* __restrict__ x, T* __restrict__ out, long n,
                       long tiles_per_row,
                       unsigned long long* __restrict__ status) {
  constexpr int TILE = BLOCK * ITEMS;
  constexpr int NW = BLOCK / 32;
  __shared__ A tile[TILE + TILE / 32];
  __shared__ A warp_tot[NW];
  __shared__ long tile_id;
  __shared__ A carry_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  long id = blockIdx.x;
  if (tiles_per_row > 1) {
    if (tid == 0) {
      unsigned* counter = reinterpret_cast<unsigned*>(
          status + gridDim.x);
      tile_id = atomicAdd(counter, 1u);
    }
    __syncthreads();
    id = tile_id;
  }
  const long row = id / tiles_per_row, j = id % tiles_per_row;
  const long t0 = j * TILE;
  const T* xr = x + row * n;
  T* orow = out + row * n;

#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long g = t0 + (long)i * BLOCK + tid;
    tile[pad(i * BLOCK + tid)] = g < n ? to_acc(xr[g]) : A(0);
  }
  __syncthreads();
  A a[ITEMS];
  A run = A(0);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    run = run + tile[pad(tid * ITEMS + k)];
    a[k] = run;
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

  A carry = A(0);
  if (tiles_per_row > 1) {
    if (warp == 0) {
      const A agg = warp_tot[NW - 1];
      if (j == 0) {
        if (lane == 0) publish(status + id, kPrefix, bits(agg));
      } else {
        if (lane == 0) publish(status + id, kAggregate, bits(agg));
        const long first = row * tiles_per_row;  // the row's first tile
        A sum = A(0);
        for (long p = id - 1;; p -= 32) {
          // lane i looks at tile p - i; lanes before the row's first tile
          // read nothing (the first tile, a prefix, comes before them)
          const long q = p - lane;
          unsigned long long w = 0;
          unsigned pre, need;
          for (;;) {
            if (q >= first) w = observe(status + q);
            const unsigned flag =
                q >= first ? static_cast<unsigned>(w >> 32) : kAggregate;
            pre = __ballot_sync(0xffffffffu, flag == kPrefix);
            // the words up to and including the nearest prefix (all 32
            // when there is none) must all be published
            need = pre ? (pre ^ (pre - 1)) : 0xffffffffu;
            if (!(__ballot_sync(0xffffffffu, flag == 0u) & need)) break;
          }
          A v = ((need >> lane) & 1u) && q >= first
                    ? from_bits<A>(static_cast<unsigned>(w))
                    : A(0);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v = v + __shfl_xor_sync(0xffffffffu, v, off);
          sum = sum + v;
          if (pre) break;
        }
        if (lane == 0) {
          publish(status + id, kPrefix, bits(sum + agg));
          carry_s = sum;
        }
      }
    }
    __syncthreads();
    if (j > 0) carry = carry_s;
  }

  const A base = carry + (warp > 0 ? warp_tot[warp - 1] : A(0)) + prev;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) tile[pad(tid * ITEMS + k)] = base + a[k];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long g = t0 + (long)i * BLOCK + tid;
    if (g < n) orow[g] = from_acc<T, A>(tile[pad(i * BLOCK + tid)]);
  }
}

template <typename T, typename A, int BLOCK, int ITEMS>
cudaError_t launch_tile(const void* x, void* out, int rows, long n,
                        unsigned long long* status, cudaStream_t stream) {
  const long tiles_per_row = (n + BLOCK * ITEMS - 1) / (BLOCK * ITEMS);
  const long tiles = rows * tiles_per_row;
  if (tiles >= (1L << 31) || (tiles_per_row > 1) != (status != nullptr))
    return cudaErrorInvalidValue;
  prefix_scan_kernel<T, A, BLOCK, ITEMS>
      <<<(unsigned)tiles, BLOCK, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(out), n, tiles_per_row,
          status);
  return cudaGetLastError();
}

// The tiles (scan_plan in ops.py): 128 x 8 for rows of at most 1024,
// 512 x 8 for rows of at most 4096 (one tile a row), else 512 x 16.
template <typename T, typename A>
cudaError_t launch(const void* x, void* out, int rows, long n, int block,
                   int items, unsigned long long* status,
                   cudaStream_t stream) {
  if (block == 128 && items == 8)
    return launch_tile<T, A, 128, 8>(x, out, rows, n, status, stream);
  if (block == 512 && items == 8)
    return launch_tile<T, A, 512, 8>(x, out, rows, n, status, stream);
  if (block == 512 && items == 16)
    return launch_tile<T, A, 512, 16>(x, out, rows, n, status, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int32.  x and out [rows, n],
// contiguous.  block x items: the tile (128 x 8, 512 x 8 or 512 x 16).
// status: rows * tiles_per_row + 1 zeroed 64-bit words (status words, then
// the tile counter) when a row has more than one tile, else null.
// Returns cudaGetLastError() after the launch (0 = ok).
int prefix_scan_fwd(int dtype, const void* x, void* out, int rows, long n,
                    int block, int items, void* status, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<unsigned long long*>(status);
  if (dtype == 0)
    return (int)launch<float, float>(x, out, rows, n, block, items, words,
                                     st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, float>(x, out, rows, n, block, items,
                                             words, st);
  if (dtype == 2)
    return (int)launch<int, unsigned>(x, out, rows, n, block, items, words,
                                      st);
  return (int)cudaErrorInvalidValue;
}

const char* prefix_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
