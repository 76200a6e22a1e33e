// WKV-6, the RWKV-6 ("Finch") recurrence, for NVIDIA Hopper (sm_90a), plain
// C interface.
//
// Replaces src/repro/kernels/wkv6/kernel.py::wkv6_pallas (the TPU Pallas
// kernel).  Per batch row b and head h, with the fp32 state S [N, N] (rows
// k, columns v) starting at s0 (or 0), for t = 0 .. T-1:
//
//   y_t[v] = sum_k r_t[k] S[k][v] + (sum_k r_t[k] u[k] k_t[k]) v_t[v]
//   S[k][v] = w_t[k] S[k][v] + k_t[k] v_t[v]
//
// y from the state before the step, then the update, as the TPU kernel's
// `step` does.  r, k, v, y: [B, T, H, N] in bf16 or fp32 (y in r's type);
// w: [B, T, H, N] fp32 decay in (0, 1); u: [H, N] fp32; s0, s_end:
// [B, H, N, N] fp32.  Everything is computed in fp32.
//
// The TPU kernel walks time chunks on a sequential grid axis with the state
// in VMEM scratch.  CUDA blocks have no order, so here a loop inside one
// block walks all T steps and the state lives in registers.
//
// Design (first, simple version).  The columns of S are independent: y_t[v]
// and S[:, v] read only column v and the shared r_t, k_t, w_t vectors.  So
// a block is one warp that owns 8 columns of one (b, h): the grid is
// (N / 8, H, B), 320 warps at B = 1, H = 40, N = 64, which spreads one
// prefill over all 132 SMs.  In the warp, 8 lanes share a pair of columns
// and each holds N / 8 rows of them (16 fp32 registers at N = 64): the dot
// product r_t . S[:, v] is 8 partial sums joined by 3 xor-shuffles, and
// sum r u k is split the same way.  The block stages r, k, w and its v
// columns for 16 steps at a time in shared memory with cp.async, double
// buffered, so the next chunk's loads overlap this chunk's FMAs.  Each
// output is one fixed sequence of fp32 operations: no atomics, so the
// result is deterministic.  Ragged T needs no padding: the last chunk is
// shorter.
//
// What bounds it on an H100.  The bytes are r, k, v, y once each and w in
// fp32 (12 B per element in bf16: 31.5 MB at B = 1, T = 1024, H = 40,
// N = 64, ~9.8 us at 3.35 TB/s); the FLOPs are ~4 N^2 per step and head
// (0.67 GFLOP, ~10 us on the fp32 CUDA cores).  This design does not come
// near either: each warp walks T dependent steps, and a step's latency (the
// shared loads, an 8-long FMA chain, 3 shuffles, the state update) is paid
// T times with ~2.4 warps per SM to hide it.  The way past that is the
// chunked form on the tensor cores (intra-chunk products as matrix
// multiplies, the state carried between chunks), a later kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KG = 8;             // lanes that share one pair of columns
constexpr int VT = 2;             // columns per lane
constexpr int VB = 32 / KG * VT;  // columns per block (one warp)
constexpr int CH = 16;            // time steps per staged chunk

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One chunk of CH steps for one block, double buffered.
template <typename T, int N>
struct Stage {
  T r[2][CH][N];
  T k[2][CH][N];
  float w[2][CH][N];
  T v[2][CH][VB];
};

// Issue the cp.async copies of `steps` steps from t0 into buffer `buf`.
// base: element offset of (b, t = 0, h, 0); tstride: elements per step.
template <typename T, int N>
__device__ __forceinline__ void load_chunk(Stage<T, N>& sm, int buf,
                                           const T* r, const T* k, const T* v,
                                           const float* w, long base,
                                           long tstride, int t0, int steps,
                                           int col0, int lane) {
  constexpr int RE = 16 / sizeof(T);          // elements per 16-byte piece
  constexpr int RP = N / RE;                  // pieces in a row of r or k
  for (int i = lane; i < steps * RP; i += 32) {
    const int s = i / RP, p = i % RP;
    const long off = base + (long)(t0 + s) * tstride + p * RE;
    cp_async16(&sm.r[buf][s][p * RE], r + off);
    cp_async16(&sm.k[buf][s][p * RE], k + off);
  }
  constexpr int WP = N / 4;                   // pieces in a row of w
  for (int i = lane; i < steps * WP; i += 32) {
    const int s = i / WP, p = i % WP;
    cp_async16(&sm.w[buf][s][p * 4],
               w + base + (long)(t0 + s) * tstride + p * 4);
  }
  constexpr int VP = VB / RE;                 // pieces of the block's v
  for (int i = lane; i < steps * VP; i += 32) {
    const int s = i / VP, p = i % VP;
    cp_async16(&sm.v[buf][s][p * RE],
               v + base + (long)(t0 + s) * tstride + col0 + p * RE);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(32)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ s_end, int Tn, int H) {
  constexpr int KT = N / KG;  // state rows per lane
  __shared__ __align__(16) Stage<T, N> sm;
  const int lane = threadIdx.x;
  const int kg = lane % KG;               // which KT rows: kg * KT + i
  const int col0 = blockIdx.x * VB;       // the block's first column
  const int c0 = (lane / KG) * VT;        // the lane's columns in the block
  const int h = blockIdx.y, b = blockIdx.z;
  const long tstride = (long)H * N;
  const long base = (long)b * Tn * tstride + (long)h * N;
  const long sbase = ((long)b * H + h) * N * N;

  float S[KT][VT], uu[KT];
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const int row = kg * KT + i;
    uu[i] = u[h * N + row];
#pragma unroll
    for (int j = 0; j < VT; ++j)
      S[i][j] = s0 ? s0[sbase + (long)row * N + col0 + c0 + j] : 0.f;
  }

  const int nchunks = (Tn + CH - 1) / CH;
  load_chunk(sm, 0, r, k, v, w, base, tstride, 0, min(CH, Tn), col0, lane);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1;
    const int t0 = ch * CH;
    if (ch + 1 < nchunks)
      load_chunk(sm, buf ^ 1, r, k, v, w, base, tstride, t0 + CH,
                 min(CH, Tn - t0 - CH), col0, lane);
    cp_async_commit();   // possibly empty: keeps the wait count uniform
    cp_async_wait_1();   // chunk ch has landed
    __syncwarp();
    const int steps = min(CH, Tn - t0);
    for (int s = 0; s < steps; ++s) {
      float rr[KT], kk[KT], ww[KT], vv[VT];
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        rr[i] = to_float(sm.r[buf][s][kg * KT + i]);
        kk[i] = to_float(sm.k[buf][s][kg * KT + i]);
        ww[i] = sm.w[buf][s][kg * KT + i];
      }
#pragma unroll
      for (int j = 0; j < VT; ++j) vv[j] = to_float(sm.v[buf][s][c0 + j]);
      float bonus = 0.f;  // this lane's part of sum_k r u k
#pragma unroll
      for (int i = 0; i < KT; ++i) bonus = fmaf(rr[i] * uu[i], kk[i], bonus);
      float acc[VT];
#pragma unroll
      for (int j = 0; j < VT; ++j) {
        acc[j] = 0.f;
#pragma unroll
        for (int i = 0; i < KT; ++i) acc[j] = fmaf(rr[i], S[i][j], acc[j]);
        acc[j] = fmaf(bonus, vv[j], acc[j]);
      }
#pragma unroll
      for (int off = 1; off < KG; off <<= 1)
#pragma unroll
        for (int j = 0; j < VT; ++j)
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      if (kg == 0) {
        T* dst = y + base + (long)(t0 + s) * tstride + col0 + c0;
#pragma unroll
        for (int j = 0; j < VT; ++j) dst[j] = from_float<T>(acc[j]);
      }
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int j = 0; j < VT; ++j)
          S[i][j] = fmaf(ww[i], S[i][j], kk[i] * vv[j]);
    }
    __syncwarp();  // every lane is done with buf before it is refilled
  }

#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int j = 0; j < VT; ++j)
      s_end[sbase + (long)(kg * KT + i) * N + col0 + c0 + j] = S[i][j];
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_end, int B, int Tn, int H, cudaStream_t stream) {
  const dim3 grid(N / VB, H, B);
  wkv6_kernel<T, N><<<grid, 32, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_end), Tn, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int n, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* y,
                     void* s_end, int B, int Tn, int H, cudaStream_t st) {
  switch (n) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, y, s_end, B, Tn, H, st);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, s_end, B, Tn, H, st);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, s_end, B, Tn, H, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of r, k, v and y: 0 = float32, 1 = bfloat16.  n: head size, 16, 32
// or 64.  r, k, v, y [B, T, H, n] and w [B, T, H, n] fp32, u [H, n] fp32,
// s0 (or null = zeros) and s_end [B, H, n, n] fp32; all contiguous and
// 16-byte aligned.  Returns cudaGetLastError() after the launch (0 = ok).
int wkv6_fwd(int dtype, int n, const void* r, const void* k, const void* v,
             const void* w, const void* u, const void* s0, void* y,
             void* s_end, int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_n<float>(n, r, k, v, w, u, s0, y, s_end, B, T, H, st);
  if (dtype == 1)
    return (int)launch_n<__nv_bfloat16>(n, r, k, v, w, u, s0, y, s_end, B,
                                        T, H, st);
  return (int)cudaErrorInvalidValue;
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
