// Grouped (per-expert) SwiGLU for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/moe_gmm/kernel.py::grouped_swiglu_pallas (the
// TPU Pallas kernel).  For x [E, C, D], w_gate and w_up [E, D, F] and
// w_down [E, F, D], all row-major, it computes what that kernel computes:
//
//   h[e] = (silu(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) cast to x's type
//   y[e] = (h[e] @ w_down[e]) cast to x's type
//
// with both products accumulated in fp32.  Inputs are bf16 or fp32.
//
// The TPU kernel carries an fp32 [bc, D] accumulator across its sequential
// F grid axis.  At D = 6144 that is 1.5 MB for bc = 64, far beyond an SM's
// shared memory, and CUDA blocks have no sequential grid axis.  So the same
// function runs in two phases, one launch each:
//
//   (a) h = silu(x Wg) * (x Wu), fp32 over D, SwiGLU and the cast in the
//       epilogue; h is materialised in x's type, the rounding point of the
//       TPU kernel's `h = (...).astype(x.dtype)`;
//   (b) y = h Wd, fp32 over F.
//
// Row skipping.  Under dropless dispatch each expert's slab is mostly empty
// rows, and the kept rows of expert e are the prefix [0, load[e]) of its
// slab.  With `load` given (a device pointer, read on the device), row tiles
// at or beyond load[e] do no work: an expert whose load is 0 reads none of
// its weights.  Phase (b) writes its skipped rows as zeros, which is what
// the plain version gives for the zero rows the dispatch leaves there, and
// what the combine (which multiplies every row by gate * valid) needs: a
// NaN there would survive the multiplication by 0.
//
// Design (first, simple version).  Each CTA computes a BM x BN output tile
// of one expert, looping over the reduction axis in BK steps: A [BM, BK]
// and B [BK, BN] tiles are staged in shared memory as fp32 (16-byte loads),
// and each thread accumulates a TM x TN micro-tile in fp32 registers with
// CUDA-core FMAs.  Each thread sums its elements over k in one fixed order,
// whatever the row's place in the slab: no atomics, so the result is
// deterministic.  Ragged C, F and D edges are masked here (no padding);
// D and F must be multiples of 16 bytes' worth of elements (the wrapper
// checks).  Two tiles:
//
//   * decode, C <= 8: BM = 8 rows cover the whole slab, so each expert's
//     weights are read once per step; BN = 64, 4 x 64 threads;
//   * otherwise BM = BN = 64, 16 x 16 threads with 4 x 4 micro-tiles.
//
// What bounds it on an H100.
//   * Decode (B = 8 tokens, top-2 of 8 experts) reads every loaded expert's
//     weights, 3 * D * F * 2 bytes each (4.83 GB for 8 Mixtral-8x22B
//     experts): ~1.44 ms at 3.35 TB/s.  This design keeps many CTAs in
//     flight per SM (2048 in phase (a), 768 in (b)) but does not prefetch
//     a tile while it computes the last one.
//   * Prefill (a few thousand kept rows) is bound by tensor-core FLOPs,
//     6 * rows * D * F; here the products run on CUDA cores, well under
//     the tensor-core rate.
// Next steps, in order: register prefetch of the next tile (decode), then
// mma.sync / wgmma with TMA loads for the prefill tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int BM_, int BN_, int TM_, int TN_, int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int RG = BM / TM;   // row groups: thread rows
  static constexpr int CG = BN / TN;   // column groups: thread columns
  static constexpr int NT = RG * CG;   // threads per CTA
};
using DecodeTile = Tile<8, 64, 2, 1, 32>;
using PrefillTile = Tile<64, 64, 4, 4, 32>;

// Stage a ROWS x COLS tile of a row-major matrix (tile origin `src`, row
// pitch `ld` elements) into shared memory as fp32 with row pitch LDS.
// Elements at row >= row_lim or column >= col_lim are zero.  col_lim, ld and
// the tile origin are multiples of the 16-byte vector, so a vector is all in
// or all out.
template <typename T, int ROWS, int COLS, int LDS, int NT>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long ld, int row_lim,
                                      int col_lim) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = COLS / kVec;
  static_assert(COLS % kVec == 0, "tile width is whole vectors");
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += NT) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float* d = dst + r * LDS + c;
    if (r < row_lim && c < col_lim) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (long long)r * ld + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = to_float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = 0.f;
    }
  }
}

// One phase over every expert: out[e] = epilogue(a[e] @ b0[e], a[e] @ b1[e])
// with a [E, C, K], b0/b1 [E, K, N], out [E, C, N].  GLU: phase (a), out =
// silu(a b0) * (a b1).  Otherwise phase (b), out = a b0 (b1 unused), and rows
// at or beyond the expert's load are written as zeros.
template <typename T, class Tl, bool GLU>
__global__ void __launch_bounds__(Tl::NT)
gmm_kernel(const T* __restrict__ a, const T* __restrict__ b0,
           const T* __restrict__ b1, const int* __restrict__ load,
           T* __restrict__ out, int C, int K, int N) {
  constexpr int BM = Tl::BM, BN = Tl::BN, TM = Tl::TM, TN = Tl::TN;
  constexpr int BK = Tl::BK, RG = Tl::RG, CG = Tl::CG, NT = Tl::NT;
  constexpr int LDA = BK + 1;  // padded: a warp's rows hit distinct banks
  constexpr int NB = GLU ? 2 : 1;
  __shared__ float As[BM * LDA];
  __shared__ float Bs[NB][BK * BN];

  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = load == nullptr ? C : min(load[e], C);
  const int live = min(BM, rows - m0);  // live rows of this tile (may be <= 0)
  const int tid = threadIdx.x, ty = tid / CG, tx = tid % CG;
  const long long a_off = ((long long)e * C + m0) * K;
  const long long b_off = (long long)e * K * N + n0;
  T* o = out + ((long long)e * C + m0) * N + n0;

  if (live <= 0) {  // an empty row tile: no weight is read
    if (!GLU) {
      for (int i = tid; i < BM * BN; i += NT) {
        const int r = i / BN, c = i % BN;
        if (m0 + r < C && n0 + c < N)
          o[(long long)r * N + c] = from_float<T>(0.f);
      }
    }
    return;
  }

  float acc[NB][TM][TN];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[q][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kl = min(BK, K - k0);
    stage<T, BM, BK, LDA, NT>(As, a + a_off + k0, K, live, kl);
    stage<T, BK, BN, BN, NT>(Bs[0], b0 + b_off + (long long)k0 * N, N, kl,
                             N - n0);
    if (GLU)
      stage<T, BK, BN, BN, NT>(Bs[NB - 1], b1 + b_off + (long long)k0 * N, N,
                               kl, N - n0);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float bv[NB][TN];
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[q][j] = Bs[q][kk * BN + tx + CG * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + RG * i;
        if (r < live) {
          const float av = As[r * LDA + kk];
#pragma unroll
          for (int q = 0; q < NB; ++q)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[q][i][j] += av * bv[q][j];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + RG * i;
    if (m0 + r >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + CG * j;
      if (n0 + c >= N) continue;
      T* dst = o + (long long)r * N + c;
      if (r >= live) {
        if (!GLU) *dst = from_float<T>(0.f);  // phase (a) leaves it unread
      } else if (GLU) {
        const float g = acc[0][i][j];
        *dst = from_float<T>(g / (1.f + expf(-g)) * acc[NB - 1][i][j]);
      } else {
        *dst = from_float<T>(acc[0][i][j]);
      }
    }
  }
}

template <typename T, class Tl, bool GLU>
cudaError_t launch_phase(const void* a, const void* b0, const void* b1,
                         const int* load, void* out, int E, int C, int K,
                         int N, cudaStream_t stream) {
  const dim3 grid((N + Tl::BN - 1) / Tl::BN, (C + Tl::BM - 1) / Tl::BM, E);
  gmm_kernel<T, Tl, GLU><<<grid, Tl::NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b0),
      static_cast<const T*>(b1), load, static_cast<T*>(out), C, K, N);
  return cudaGetLastError();
}

template <typename T, class Tl>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const int* load, void* h, void* y, int E,
                   int C, int D, int F, cudaStream_t stream) {
  const cudaError_t err =
      launch_phase<T, Tl, true>(x, wg, wu, load, h, E, C, D, F, stream);
  if (err != cudaSuccess) return err;
  return launch_phase<T, Tl, false>(h, wd, nullptr, load, y, E, C, F, D,
                                    stream);
}

template <typename T>
cudaError_t launch_tile(const void* x, const void* wg, const void* wu,
                        const void* wd, const int* load, void* h, void* y,
                        int E, int C, int D, int F, cudaStream_t stream) {
  if (C <= DecodeTile::BM)
    return launch<T, DecodeTile>(x, wg, wu, wd, load, h, y, E, C, D, F,
                                 stream);
  return launch<T, PrefillTile>(x, wg, wu, wd, load, h, y, E, C, D, F,
                                stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x [E, C, D], w_gate/w_up [E, D, F],
// w_down [E, F, D], scratch h [E, C, F], output y [E, C, D], all contiguous
// and 16-byte aligned, D and F multiples of 16 bytes' worth of elements.
// load: [E] int32 on the device, or null (= every row is live).  Returns
// cudaGetLastError() after the launches (0 = ok).
int grouped_swiglu_fwd(int dtype, const void* x, const void* w_gate,
                       const void* w_up, const void* w_down, const void* load,
                       void* h, void* y, int E, int C, int D, int F,
                       void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const int* ld = static_cast<const int*>(load);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_tile<float>(x, w_gate, w_up, w_down, ld, h, y, E, C,
                                   D, F, st);
  if (dtype == 1)
    return (int)launch_tile<__nv_bfloat16>(x, w_gate, w_up, w_down, ld, h, y,
                                           E, C, D, F, st);
  return (int)cudaErrorInvalidValue;
}

const char* grouped_swiglu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
