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
// Two kernels; the wrapper picks one from the dtype and the query length
// (ops.py::kernel_route) and passes its choice here.
//
// "mma": bf16 prefill (S > 4), on the tensor cores (flash_fwd_mma_kernel).
// One CTA of 4 warps per (head, batch, 64-row query tile); each warp owns 16
// query rows (64 rows a CTA rather than 128: at qwen2-1.5b's 1024-token
// prefill that is 192 CTAs on the 132 SMs instead of 96).  Q (ldmatrix'd
// once into A fragments), the scores, the online-softmax state (m, l) and
// the O accumulator stay in registers.  K and V tiles of 64 rows stay bf16
// in shared memory (rows padded by 16 bytes, so the 8 rows an ldmatrix
// reads fall in distinct banks), loaded by cp.async into two stages, so
// the next tile loads while this one is computed.  QK^T and PV are bf16
// mma.sync.m16n8k16 with fp32 accumulation; V's B fragments come from
// ldmatrix.trans.  After the row max, P goes from the score accumulators to
// bf16 A fragments in registers, with no trip through shared memory.  The
// mask predicate runs only on tiles that cross the causal diagonal, the
// window's edge or kv_valid; interior tiles skip it.  The last (heaviest
// causal) query tiles are launched first.  Rows of K and V at or beyond
// min(T, kv_valid[b]) are read as zeros.  Numerics: rounding P to bf16
// before PV is the one departure from the reference, which computes PV in
// fp32; l sums the unrounded p.  exp is taken as ex2.approx (2 ulp) of
// log2(e)-scaled logits.
//
// "fma": fp32 (any S) and decode (S <= 4) in either dtype, on the CUDA
// cores (flash_fwd_kernel; first, simple version).  One CTA of 128 threads
// per (query tile, head, batch).  The query tile has BQ = 64 rows, or 4 rows
// when S <= 4.  K and V tiles of 64 rows are staged in dynamic shared memory
// as fp32 (padded rows, no bank conflicts); scores and the online softmax
// stay in fp32 registers.  TPR = 128 / BQ threads share a query row: each
// holds 64 / TPR score columns and d / TPR output dims, and row max / row
// sum are warp shuffles among them.  P goes through shared memory for the
// PV product.  All products are plain FMAs.  fp32 stays off the tensor
// cores: the port keeps TF32 off.
//
// Neither kernel uses atomics or splits the kv axis: the result is
// deterministic, which paged == contiguous serving relies on.
//
// What bounds it on an H100.
//   * Decode (S = 1, T = cache length) is bound by the bytes of K and V read:
//     B * T * 2 * Hkv * d * 2 bytes.  The fma design re-reads each kv head
//     once per query head of its group (through L2), uses one of four warps
//     for the single row, and puts B * H CTAs on the card (96 at B=8, H=12,
//     under the 132 SMs).  It does little about the bound.
//   * Prefill (S = T ~ 1k, causal) is bound by tensor-core FLOPs:
//     ~ 4 * S^2 * d * H / 2.  The mma route puts them on the tensor cores,
//     but with 4 warps a CTA and one or two CTAs an SM, each warp's chain
//     of mma.sync, softmax and mma.sync is latency-bound: one CTA alone
//     takes as long per kv tile as 132 together (PERF.md section 6).
// Next steps: split-KV decode (several CTAs per (b, h) over T, then a
// deterministic combine pass) with GQA row packing (the query heads of a
// group in one CTA, so K/V are read once); then prefill on wgmma with TMA
// loads into a ring of shared-memory stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  if constexpr (std::is_same<T, float>::value)
    return launch<T, D, 64>(q, k, v, kv_valid, o, B, S, Tk, H, Hkv, q_offset,
                            causal, window, scale, stream);
  return cudaErrorInvalidValue;  // bf16 prefill takes the mma route
}

// ---------------------------------------------------------------- mma route

typedef __nv_bfloat16 bf16;
constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaBQ = 64;        // query rows a CTA: 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b: a 16x16 (row major), b 16x8 (column major), bf16 in, fp32 acc
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the MUFU unit (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and
// t = lane % 4, a lane holds accumulator rows g and g + 8, columns 2t and
// 2t + 1 of each 8-column n-tile; A rows g / g + 8, columns 2t, 2t + 1 and
// 2t + 8, 2t + 9; B columns g, rows 2t, 2t + 1 and 2t + 8, 2t + 9.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ kv_valid, bf16* __restrict__ o,
                     int S, int Tk, int H, int Hkv, int q_offset, int causal,
                     int window, float scale_log2) {
  constexpr int LD = D + 8;        // padded smem row pitch, in elements
  constexpr int CH = D / 8;        // 16-byte chunks a row
  constexpr int KT = D / 16;       // k-steps of QK^T
  constexpr int NT = kBK / 8;      // score n-tiles
  constexpr int DT = D / 8;        // output n-tiles
  static_assert(D % 16 == 0 && kBK % 16 == 0, "mma tiles");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + kMmaBQ * LD;                   // [2][kBK][LD]
  bf16* Vs = Ks + 2 * kBK * LD;                  // [2][kBK][LD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMmaBQ;  // last tiles first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int qrows = min(kMmaBQ, S - q0);
  const bool live = warp * 16 < qrows;  // warp-uniform
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hkv * D;

  // the kv tiles any row of this CTA may see (the TPU kernel's block skip)
  int kv_lim = Tk;
  if (kv_valid != nullptr) kv_lim = min(kv_lim, kv_valid[b]);
  int kv_end = kv_lim;
  if (causal) kv_end = min(kv_end, q0 + qrows + q_offset);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1);
  const int t_first = kv_begin / kBK * kBK;
  const int ntiles = kv_end > t_first ? (kv_end - t_first + kBK - 1) / kBK
                                      : 0;

  const bf16* qg = q + ((long long)b * S + q0) * q_stride + (long long)h * D;
  for (int i = tid; i < kMmaBQ * CH; i += kMmaThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < qrows;
    cp_async16(Qs + r * LD + c, ok ? qg + r * q_stride + c : qg, ok);
  }
  cp_async_commit();

  const long long kv_base = (long long)b * Tk * kv_stride + (long long)hk * D;
  auto load_kv = [&](int stage, int t0) {
    const bf16* kg = k + kv_base + (long long)t0 * kv_stride;
    const bf16* vg = v + kv_base + (long long)t0 * kv_stride;
    bf16* kd = Ks + stage * kBK * LD;
    bf16* vd = Vs + stage * kBK * LD;
    for (int i = tid; i < kBK * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = t0 + r < kv_lim;
      const long long off = ok ? r * kv_stride + c : 0;
      cp_async16(kd + r * LD + c, kg + off, ok);
      cp_async16(vd + r * LD + c, vg + off, ok);
    }
  };
  if (ntiles > 0) load_kv(0, t_first);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  unsigned qa[KT][4];
  if (live) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      ldmatrix_x4(qa[kk], Qs + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8)
                                   * LD + kk * 16 + (lane / 16) * 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const int row0 = q0 + warp * 16 + g + q_offset;  // absolute positions
  const int row1 = row0 + 8;

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    const int t0 = t_first + it * kBK;
    if (it + 1 < ntiles) load_kv(stage ^ 1, t0 + kBK);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    if (live) {
      const bf16* kt = Ks + stage * kBK * LD;
      const bf16* vt = Vs + stage * kBK * LD;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned kb[4];
          ldmatrix_x4(kb, kt + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD
                              + kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
        }
      }

      // the predicate only where a tile crosses the diagonal, the window's
      // edge or kv_lim (CTA-uniform)
      const bool edge =
          t0 + kBK > kv_lim ||
          (causal && t0 + kBK - 1 > q0 + q_offset) ||
          (window > 0 && q0 + q_offset + kMmaBQ - 1 - t0 >= window);
      unsigned dead = 0;  // bit 4 j + e: s[j][e] is masked
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int col = t0 + j * 8 + 2 * tq + (e & 1);
            const int row = e < 2 ? row0 : row1;
            bool ok = col < kv_lim;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && row - col < window;
            if (!ok) {
              x = kNeg;
              dead |= 1u << (4 * j + e);
            }
          }
          s[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {  // the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ((dead >> (4 * j + e)) & 1u)
                              ? 0.f
                              : fast_exp2(s[j][e] - (e < 2 ? mn0 : mn1));
          s[j][e] = p;
          if (e < 2) ps0 += p;
          else ps1 += p;
        }
      }
      l0 = l0 * alpha0 + ps0;  // this lane's columns; joined at the end
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= alpha0;
        acc[j][1] *= alpha0;
        acc[j][2] *= alpha1;
        acc[j][3] *= alpha1;
      }

      // O += P V: P's accumulators become A fragments in registers
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        unsigned pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, vt + (kk * 16 + (lane % 8)
                                      + ((lane / 8) % 2) * 8) * LD
                                    + dp * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }
  cp_async_wait<0>();

  if (!live) return;
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g;
  bf16* o0 = o + ((long long)b * S + r0) * q_stride + (long long)h * D
             + 2 * tq;
  bf16* o1 = o0 + 8 * q_stride;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + j * 8) =
          __floats2bfloat162_rn(acc[j][0] / lc0, acc[j][1] / lc0);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + j * 8) =
          __floats2bfloat162_rn(acc[j][2] / lc1, acc[j][3] / lc1);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* kv_valid, void* o, int B, int S, int Tk,
                       int H, int Hkv, int q_offset, int causal, int window,
                       float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kMmaBQ + 4 * kBK) * (D + 8) * sizeof(bf16);
  auto kern = flash_fwd_mma_kernel<D>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid(H, B, (S + kMmaBQ - 1) / kMmaBQ);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv_valid, static_cast<bf16*>(o), S, Tk, H,
      Hkv, q_offset, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int d, int route, const void* q, const void* k,
                       const void* v, const int* kv_valid, void* o, int B,
                       int S, int Tk, int H, int Hkv, int q_offset,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
#define FLASH_ARGS q, k, v, kv_valid, o, B, S, Tk, H, Hkv, q_offset, causal, \
                   window, scale, stream
  if (route == 1) {  // mma: bf16 only
    if (!std::is_same<T, bf16>::value) return cudaErrorInvalidValue;
    switch (d) {
      case 32: return launch_mma<32>(FLASH_ARGS);
      case 64: return launch_mma<64>(FLASH_ARGS);
      case 128: return launch_mma<128>(FLASH_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != 0) return cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_rows<T, 32>(FLASH_ARGS);
    case 64: return launch_rows<T, 64>(FLASH_ARGS);
    case 128: return launch_rows<T, 128>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = fma (CUDA cores: fp32, and
// bf16 with S <= 4), 1 = mma (tensor cores, bf16).  kv_valid may be null
// (= T).  window <= 0 means no window.  Returns cudaGetLastError() after
// the launch (0 = ok).
int flash_attention_fwd(int dtype, int head_dim, int route, const void* q,
                        const void* k, const void* v, const void* kv_valid,
                        void* o, int B, int S, int Tk, int H, int Hkv,
                        int q_offset, int causal, int window, float scale,
                        void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int* valid = static_cast<const int*>(kv_valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dim<float>(head_dim, route, q, k, v, valid, o, B, S,
                                  Tk, H, Hkv, q_offset, causal, window, scale,
                                  st);
  if (dtype == 1)
    return (int)launch_dim<bf16>(head_dim, route, q, k, v, valid, o, B, S,
                                 Tk, H, Hkv, q_offset, causal, window, scale,
                                 st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
