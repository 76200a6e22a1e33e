// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (the TPU Pallas kernel).  It computes exactly what that kernel's `_kernel`
// computes, for q [B, S, H, d] and k, v [B, T, Hkv, d] in the model layout
// (no transposes and no padding copies: ragged S and T are masked here):
//
//   * query head h reads kv head h / (H / Hkv) (GQA);
//   * kv column `col` is valid for absolute query row `row = i + q_offset`
//     when col < min(T, kv_valid[b]), and col <= row when causal, and
//     row - col < window when a window is set;
//   * masked logits are -1e30 and their p is forced to 0 (not exp'd);
//   * running max m, denominator l and accumulator live in fp32, l is clamped
//     at 1e-30 at the end, so a fully masked row writes 0, not NaN;
//   * QK^T and PV accumulate in fp32; inputs are bf16 or fp32, the output
//     has q's type.
//
// The TPU kernel skips dead kv blocks with pl.when; here that becomes the
// bounds of the kv-tile loop, computed per CTA from the causal, window and
// kv_valid predicates.
//
// Design (first, simple version).  One CTA of 128 threads per
// (query tile, head, batch).  The query tile has BQ = 64 rows, or 4 rows
// when S <= 4 (decode).  K and V tiles of 64 rows are staged in dynamic
// shared memory as fp32 (padded rows, no bank conflicts); scores and the
// online softmax stay in fp32 registers.  TPR = 128 / BQ threads share a
// query row: each holds 64 / TPR score columns and d / TPR output dims, and
// row max / row sum are warp shuffles among them.  P goes through shared
// memory for the PV product.  All products are plain FMAs.  No atomics: the
// result is deterministic.
//
// What bounds it on an H100.
//   * Decode (S = 1, T = cache length) is bound by the bytes of K and V read:
//     B * T * 2 * Hkv * d * 2 bytes.  This design re-reads each kv head once
//     per query head of its group (through L2), uses one of four warps for
//     the single row, and puts B * H CTAs on the card (96 at B=8, H=12,
//     under the 132 SMs).  It does little about the bound.
//   * Prefill (S = T ~ 1k, causal) is bound by tensor-core FLOPs:
//     ~ 4 * S^2 * d * H / 2.  This design does its products as CUDA-core
//     FMAs fed from shared memory, far from the tensor-core rate.
// Next steps, in order: split-KV decode (several CTAs per (b, h) over T,
// then a combine pass) with GQA row packing (the query heads of a group in
// one CTA, so K/V are read once); then a prefill path on wgmma with TMA
// loads into a ring of shared-memory stages (mma.sync first if simpler).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;          // kv rows per tile
constexpr float kNeg = -1e30f;   // masked logit, as in the TPU kernel

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

// Stage `rows` rows of D elements (row r at src + r * stride) into shared
// memory as fp32 with row pitch D + 1.  Rows at or beyond `valid` are zeroed.
// 16-byte vector loads: the wrapper checks alignment.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long stride, int rows,
                                          int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float* d = dst + r * (D + 1) + c;
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = to_float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = 0.f;
    }
  }
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_valid,
                 T* __restrict__ o, int S, int Tk, int H, int Hkv,
                 int q_offset, int causal, int window, float scale) {
  constexpr int TPR = kThreads / BQ;  // threads per query row
  constexpr int NC = kBK / TPR;       // score columns per thread
  constexpr int ND = D / TPR;         // output dims per thread
  constexpr int LD = D + 1;           // padded smem row pitch
  constexpr int LP = kBK + 1;
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row's threads share a warp");
  static_assert(kBK % TPR == 0 && D % TPR == 0, "even split of a row");

  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* Ks = Qs + BQ * LD;    // [kBK][LD]
  float* Vs = Ks + kBK * LD;   // [kBK][LD]
  float* Ps = Vs + kBK * LD;   // [BQ][LP]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, r = tid / TPR, c = tid % TPR;
  const int qrows = min(BQ, S - q0);
  // A warp holds 32 / TPR whole rows; it computes iff its first row exists
  // (so shuffles among row-mates always see the full warp).
  const bool warp_live = (tid / 32) * (32 / TPR) < qrows;

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hkv * D;
  load_tile<T, D>(Qs, q + ((long long)b * S + q0) * q_stride + (long long)h * D,
                  q_stride, BQ, qrows);

  // Columns any row of this CTA may see: the block skipping of the TPU
  // kernel as loop bounds.
  int kv_lim = Tk;
  if (kv_valid != nullptr) kv_lim = min(kv_lim, kv_valid[b]);
  int kv_end = kv_lim;
  if (causal) kv_end = min(kv_end, q0 + qrows - 1 + q_offset + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1);

  const int arow = q0 + r + q_offset;  // absolute position of my row
  float m = kNeg, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;

  for (int t0 = (kv_begin / kBK) * kBK; t0 < kv_end; t0 += kBK) {
    __syncthreads();  // Q staged / previous tile consumed
    const long long off = ((long long)b * Tk + t0) * kv_stride +
                          (long long)hk * D;
    const int trows = min(kBK, Tk - t0);
    load_tile<T, D>(Ks, k + off, kv_stride, kBK, trows);
    load_tile<T, D>(Vs, v + off, kv_stride, kBK, trows);
    __syncthreads();
    if (!warp_live) continue;

    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.f;
    const float* qr = Qs + r * LD;
    for (int kk = 0; kk < D; ++kk) {
      const float qv = qr[kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] += qv * Ks[(j * TPR + c) * LD + kk];
    }

    float tmax = kNeg;
    unsigned live = 0;  // bit j: column j * TPR + c is unmasked
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = t0 + j * TPR + c;
      bool ok = col < kv_lim;
      if (causal) ok = ok && col <= arow;
      if (window > 0) ok = ok && arow - col < window;
      s[j] = ok ? s[j] * scale : kNeg;
      live |= (ok ? 1u : 0u) << j;
      tmax = fmaxf(tmax, s[j]);
    }
#pragma unroll
    for (int w = TPR / 2; w > 0; w /= 2)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, w));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float p = ((live >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += p;
      Ps[r * LP + j * TPR + c] = p;
    }
#pragma unroll
    for (int w = TPR / 2; w > 0; w /= 2)
      psum += __shfl_xor_sync(0xffffffffu, psum, w);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's P is visible to its threads

#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= alpha;
    const float* pr = Ps + r * LP;
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = pr[jj];
      const float* vr = Vs + jj * LD + c;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] += p * vr[i * TPR];
    }
  }

  if (r < qrows) {
    const float lc = fmaxf(l, 1e-30f);
    T* out = o + ((long long)b * S + q0 + r) * q_stride + (long long)h * D;
#pragma unroll
    for (int i = 0; i < ND; ++i) out[i * TPR + c] = from_float<T>(acc[i] / lc);
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_valid, void* o, int B, int S, int Tk, int H,
                   int Hkv, int q_offset, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = ((BQ + 2 * kBK) * (D + 1) + BQ * (kBK + 1)) *
                      sizeof(float);
  auto kern = flash_fwd_kernel<T, D, BQ>;
  // Above 48 KB a kernel must opt in to dynamic shared memory; setting the
  // same value again is harmless.
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_valid, static_cast<T*>(o), S, Tk, H, Hkv,
      q_offset, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const int* kv_valid, void* o, int B, int S, int Tk,
                        int H, int Hkv, int q_offset, int causal, int window,
                        float scale, cudaStream_t stream) {
  if (S <= 4)
    return launch<T, D, 4>(q, k, v, kv_valid, o, B, S, Tk, H, Hkv, q_offset,
                           causal, window, scale, stream);
  return launch<T, D, 64>(q, k, v, kv_valid, o, B, S, Tk, H, Hkv, q_offset,
                          causal, window, scale, stream);
}

template <typename T>
cudaError_t launch_dim(int d, const void* q, const void* k, const void* v,
                       const int* kv_valid, void* o, int B, int S, int Tk,
                       int H, int Hkv, int q_offset, int causal, int window,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_rows<T, 32>(q, k, v, kv_valid, o, B, S, Tk, H, Hkv,
                                q_offset, causal, window, scale, stream);
    case 64:
      return launch_rows<T, 64>(q, k, v, kv_valid, o, B, S, Tk, H, Hkv,
                                q_offset, causal, window, scale, stream);
    case 128:
      return launch_rows<T, 128>(q, k, v, kv_valid, o, B, S, Tk, H, Hkv,
                                 q_offset, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  kv_valid may be null (= T).  window <= 0
// means no window.  Returns cudaGetLastError() after the launch (0 = ok).
int flash_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                        const void* v, const void* kv_valid, void* o, int B,
                        int S, int Tk, int H, int Hkv, int q_offset,
                        int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int* valid = static_cast<const int*>(kv_valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dim<float>(head_dim, q, k, v, valid, o, B, S, Tk, H,
                                  Hkv, q_offset, causal, window, scale, st);
  if (dtype == 1)
    return (int)launch_dim<__nv_bfloat16>(head_dim, q, k, v, valid, o, B, S,
                                          Tk, H, Hkv, q_offset, causal,
                                          window, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
