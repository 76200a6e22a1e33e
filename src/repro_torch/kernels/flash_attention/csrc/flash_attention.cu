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
// Three routes; the wrapper picks one from the dtype and the query length
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
// "split": decode (S <= 4) in either dtype.  Split-KV with GQA packing:
// a grid of (split, kv head, batch) CTAs.  A CTA takes every query head of
// its kv head (up to 32 / S of them; more heads take more CTAs) and all S
// rows, so each K/V tile crosses HBM once for the whole group, and walks one
// chunk of the kv axis.  The chunks come from ops.py::decode_plan, a pure
// function of (B, Hkv, T): about two CTAs an SM, never read from kv_valid
// (on the device).  A chunk that starts at or beyond kv_valid[b], or wholly
// outside the window, is an empty partial: the CTA writes (m, l) = (-1e30,
// 0) and exits.  K/V tiles of 64 rows stay in their storage type in shared
// memory, through a cp.async ring of three stages.  bf16
// (flash_split_mma_kernel): the g * S rows padded to one or two m16 tiles,
// QK^T and PV on mma.sync as in the mma route; warp w owns columns
// [16 w, 16 w + 16) of every tile with its own online softmax, and the four
// warps' states merge in warp order at the end.  fp32
// (flash_split_fma_kernel): CUDA-core FMAs, a thread a score column and a
// warp a row's softmax.  Each CTA writes its unnormalised accumulator and
// (m, l) to fp32 scratch; a combine pass (flash_combine_kernel) merges the
// splits of a row in split order, skips empty ones (so no exp(-inf + inf))
// and divides by max(L, 1e-30): a row no split saw writes 0.  With a single
// split the split kernel writes the output itself.
//
// "fma": fp32 prefill (S > 4) on the CUDA cores (flash_fwd_kernel; first,
// simple version).  One CTA of 128 threads per (64-row query tile, head,
// batch).  K and V tiles of 64 rows are staged in dynamic shared memory as
// fp32 (padded rows, no bank conflicts); scores and the online softmax stay
// in fp32 registers.  Two threads share a query row: each holds 32 score
// columns and d / 2 output dims, and row max / row sum are warp shuffles.
// P goes through shared memory for the PV product.  All products are plain
// FMAs.  fp32 stays off the tensor cores: the port keeps TF32 off.
//
// No route uses atomics, and a split's order is fixed: the same call gives
// the same bits, and a row's result depends only on its inputs, T and the
// plan, which paged == contiguous serving relies on.
//
// What bounds it on an H100.
//   * Decode (S = 1, T = cache length) is bound by the bytes of K and V
//     read: B * T * 2 * Hkv * d * 2 bytes (for the columns kv_valid keeps).
//     The split route reads them once a kv head and puts 256 CTAs on the
//     card at qwen2-1.5b's and Mixtral-8x22B's decode; its two passes take
//     ~3-5x that bound (PERF.md section 6).
//   * Prefill (S = T ~ 1k, causal) is bound by tensor-core FLOPs:
//     ~ 4 * S^2 * d * H / 2.  The mma route puts them on the tensor cores,
//     but with 4 warps a CTA and one or two CTAs an SM, each warp's chain
//     of mma.sync, softmax and mma.sync is latency-bound: one CTA alone
//     takes as long per kv tile as 132 together (PERF.md section 6).
// Next steps: prefill on wgmma with TMA loads into a ring of shared-memory
// stages (a warpgroup's asynchronous products let one tile's softmax run
// under the next tile's QK^T); fp32 prefill with register-tiled FMAs; the
// combine folded into the split pass (the last CTA of a row behind a
// counter) to save the second pass's latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kFmaBQ = 64;       // query rows a CTA of the fma route
constexpr int kBK = 64;          // kv rows per tile
constexpr float kNeg = -1e30f;   // masked logit, as in the TPU kernel

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage `rows` rows of D floats (row r at src + r * stride) into shared
// memory with row pitch D + 1.  Rows at or beyond `valid` are zeroed.
// 16-byte vector loads: the wrapper checks alignment.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          long long stride, int rows,
                                          int valid) {
  constexpr int kVec = 4;
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float* d = dst + r * (D + 1) + c;
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = e[j];
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int* __restrict__ kv_valid, float* __restrict__ o,
                 int S, int Tk, int H, int Hkv, int q_offset, int causal,
                 int window, float scale) {
  constexpr int BQ = kFmaBQ;
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
  load_tile<D>(Qs, q + ((long long)b * S + q0) * q_stride + (long long)h * D,
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
    load_tile<D>(Ks, k + off, kv_stride, kBK, trows);
    load_tile<D>(Vs, v + off, kv_stride, kBK, trows);
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
    float* out = o + ((long long)b * S + q0 + r) * q_stride + (long long)h * D;
#pragma unroll
    for (int i = 0; i < ND; ++i) out[i * TPR + c] = acc[i] / lc;
  }
}

// fp32 prefill (S > 4): 64-row query tiles
template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const int* kv_valid, void* o, int B, int S, int Tk,
                       int H, int Hkv, int q_offset, int causal, int window,
                       float scale, cudaStream_t stream) {
  constexpr int BQ = kFmaBQ;
  if (S <= 4) return cudaErrorInvalidValue;  // decode takes the split route
  const size_t smem = ((BQ + 2 * kBK) * (D + 1) + BQ * (kBK + 1)) *
                      sizeof(float);
  auto kern = flash_fwd_kernel<D>;
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
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_valid, static_cast<float*>(o), S, Tk,
      H, Hkv, q_offset, causal, window, scale);
  return cudaGetLastError();
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

// -------------------------------------------------------------- split route
//
// Decode (S <= 4): grid (split, kv head x head chunk, batch).  One CTA takes
// the query heads of one kv head (up to kSplitRows / S of them) and all S
// query rows: row r of the CTA is head h0 + r / S, query row r % S.  It walks
// kv columns [split * chunk, (split + 1) * chunk) in tiles of kBK, staged in
// their storage type by a cp.async ring of kStages.  It writes its
// unnormalised accumulator and (m, l) for each row to fp32 scratch, or, when
// there is a single split, the normalised output itself.

constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kSplitRows = 32;      // g * S rows a CTA, at most
constexpr int kStages = 3;          // cp.async ring depth

// The kv columns [lo, hi) any row of this CTA may see inside its chunk.
struct ChunkRange {
  int lo, hi, lim;  // lim = min(T, kv_valid[b]), the per-column limit
};

__device__ __forceinline__ ChunkRange chunk_range(const int* kv_valid, int b,
                                                  int Tk, int S, int chunk,
                                                  int q_offset, int causal,
                                                  int window) {
  ChunkRange c;
  c.lim = Tk;
  if (kv_valid != nullptr) c.lim = min(c.lim, kv_valid[b]);
  const int c0 = blockIdx.x * chunk;
  c.hi = min(c0 + chunk, c.lim);
  if (causal) c.hi = min(c.hi, q_offset + S);
  c.lo = c0;
  if (window > 0) c.lo = max(c.lo, q_offset - window + 1);
  return c;
}

__device__ __forceinline__ bool col_visible(int col, int arow, int lim,
                                            int causal, int window) {
  bool ok = col < lim;
  if (causal) ok = ok && col <= arow;
  if (window > 0) ok = ok && arow - col < window;
  return ok;
}

// Where row r's result goes: its partial (split s of n) or, with one split,
// the output.  Partials: acc [n][B*S*H][D], then (m, l) [n][B*S*H][2].
template <typename T, int D>
__device__ __forceinline__ void store_row(T* o, float* part, long long row,
                                          long long rows, int dd, float acc,
                                          float m, float l) {
  if (gridDim.x == 1) {
    o[row * D + dd] = from_float<T>(acc / fmaxf(l, 1e-30f));
    return;
  }
  const long long slot = (long long)blockIdx.x * rows + row;
  part[slot * D + dd] = acc;
  if (dd == 0) {
    float* ml = part + (long long)gridDim.x * rows * D + slot * 2;
    ml[0] = m;
    ml[1] = l;
  }
}

// Stage kBK rows of K and V (kv columns t0 ...) into a ring stage with row
// pitch LD; rows at or beyond `hi` are zero-filled (nothing read).
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, const T* kg,
                                         const T* vg, long long kv_stride,
                                         int t0, int hi) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int CH = D / kVec;
  for (int i = threadIdx.x; i < kBK * CH; i += kSplitThreads) {
    const int r = i / CH, c = (i % CH) * kVec;
    const bool ok = t0 + r < hi;
    const long long off = ok ? (long long)(t0 + r) * kv_stride + c : 0;
    cp_async16(ks + r * LD + c, kg + off, ok);
    cp_async16(vs + r * LD + c, vg + off, ok);
  }
}

// bf16: QK^T and PV on mma.sync.m16n8k16 (fp32 accumulation), the CTA's
// rows padded to MT m-tiles of 16.  Warp w owns columns [16 w, 16 w + 16)
// of every kv tile with its own online softmax; the four warps' states are
// merged in a fixed order at the end.
template <int D, int MT>
__global__ void __launch_bounds__(kSplitThreads, 2)
flash_split_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const int* __restrict__ kv_valid, bf16* __restrict__ o,
                       float* __restrict__ part, int B, int S, int Tk, int H,
                       int Hkv, int gh, int q_offset, int causal, int window,
                       int chunk, float scale_log2) {
  constexpr int LD = D + 8;  // padded smem row pitch, in elements
  constexpr int CH = D / 8;
  constexpr int KT = D / 16;
  constexpr int DT = D / 8;
  constexpr int RP = MT * 16;  // padded rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [RP][LD]
  bf16* Ks = Qs + RP * LD;                       // [kStages][kBK][LD]
  bf16* Vs = Ks + kStages * kBK * LD;            // [kStages][kBK][LD]
  float* wm = reinterpret_cast<float*>(Vs + kStages * kBK * LD);  // [4][RP]
  float* wl = wm + 4 * RP;                                         // [4][RP]
  float* buf = reinterpret_cast<float*>(Ks);  // [4][RP][D], after the loop

  const int g_all = H / Hkv, hc = (g_all + gh - 1) / gh;
  const int hk = blockIdx.y / hc, h0 = hk * g_all + (blockIdx.y % hc) * gh;
  const int nh = min(gh, hk * g_all + g_all - h0);
  const int R = nh * S, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const long long rows_all = (long long)B * S * H;
  const ChunkRange cr = chunk_range(kv_valid, b, Tk, S, chunk, q_offset,
                                    causal, window);
  auto out_row = [&](int r) {  // row of [B, S, H] that CTA row r is
    return ((long long)b * S + r % S) * H + h0 + r / S;
  };
  if (cr.hi <= cr.lo) {  // nothing visible: an empty partial, or zeros
    for (int i = tid; i < R * D; i += kSplitThreads)
      store_row<bf16, D>(o, part, out_row(i / D), rows_all, i % D, 0.f, kNeg,
                         0.f);
    return;
  }
  const int c0 = blockIdx.x * chunk;
  const int t_first = c0 + (cr.lo - c0) / kBK * kBK;
  const int ntiles = (cr.hi - t_first + kBK - 1) / kBK;

  for (int i = tid; i < RP * CH; i += kSplitThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < R;
    const bf16* src = ok ? q + out_row(r) * D + c : q;
    cp_async16(Qs + r * LD + c, src, ok);
  }
  cp_async_commit();
  const long long kv_stride = (long long)Hkv * D;
  const bf16* kg = k + (long long)b * Tk * kv_stride + (long long)hk * D;
  const bf16* vg = v + (long long)b * Tk * kv_stride + (long long)hk * D;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles)
      stage_kv<bf16, D, LD>(Ks + s * kBK * LD, Vs + s * kBK * LD, kg, vg,
                            kv_stride, t_first + s * kBK, cr.hi);
    cp_async_commit();
  }

  float acc[MT][DT][4];
  float m[MT][2], l[MT][2];
  int arow[MT][2];  // absolute query position of each of my rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = kNeg;
      l[mt][hh] = 0.f;
      arow[mt][hh] = q_offset + (mt * 16 + g + 8 * hh) % S;
    }
  }

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` (and Q) have landed
    __syncthreads();               // ... for every thread; stage it-1 is free
    const int nxt = it + kStages - 1;
    if (nxt < ntiles)
      stage_kv<bf16, D, LD>(Ks + (nxt % kStages) * kBK * LD,
                            Vs + (nxt % kStages) * kBK * LD, kg, vg,
                            kv_stride, t_first + nxt * kBK, cr.hi);
    cp_async_commit();
    const int t0 = t_first + it * kBK;
    const bf16* kt = Ks + (it % kStages) * kBK * LD + warp * 16 * LD;
    const bf16* vt = Vs + (it % kStages) * kBK * LD + warp * 16 * LD;

    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] =
                                      s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      unsigned kb[4];
      ldmatrix_x4(kb, kt + ((lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                          ((lane / 8) % 2) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned qa[4];
        ldmatrix_x4(qa, Qs + (mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8) *
                                 LD + kk * 16 + (lane / 16) * 8);
        mma_bf16(s[mt][0], qa, kb[0], kb[1]);
        mma_bf16(s[mt][1], qa, kb[2], kb[3]);
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {kNeg, kNeg};
      unsigned dead = 0;  // bit 4 j + e: s[mt][j][e] is masked
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t0 + warp * 16 + j * 8 + 2 * tq + (e & 1);
          float x = s[mt][j][e] * scale_log2;
          if (!col_visible(col, arow[mt][e / 2], cr.lim, causal, window)) {
            x = kNeg;
            dead |= 1u << (4 * j + e);
          }
          s[mt][j][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int w = 1; w < 4; w <<= 1)
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], w));
        const float mn = fmaxf(m[mt][hh], mx[hh]);
        alpha[hh] = fast_exp2(m[mt][hh] - mn);
        m[mt][hh] = mn;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ((dead >> (4 * j + e)) & 1u)
                              ? 0.f
                              : fast_exp2(s[mt][j][e] - m[mt][e / 2]);
          s[mt][j][e] = p;
          ps[e / 2] += p;
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[mt][hh] = l[mt][hh] * alpha[hh] + ps[hh];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[mt][j][0] *= alpha[0];
        acc[mt][j][1] *= alpha[0];
        acc[mt][j][2] *= alpha[1];
        acc[mt][j][3] *= alpha[1];
      }
      // O += P V over my 16 columns: P's accumulators are the A fragment
      unsigned pa[4];
      pa[0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
      pa[1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
      pa[2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
      pa[3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vt + ((lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[mt][2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[mt][2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the four warps' states, in warp order
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int w = 1; w < 4; w <<= 1)
        l[mt][hh] += __shfl_xor_sync(0xffffffffu, l[mt][hh], w);
      if (tq == 0) {
        wm[warp * RP + mt * 16 + g + 8 * hh] = m[mt][hh];
        wl[warp * RP + mt * 16 + g + 8 * hh] = l[mt][hh];
      }
    }
  __syncthreads();  // every warp is done with the ring; (m, l) published
  auto merged_max = [&](int r) {
    float mm = kNeg;
    for (int w = 0; w < 4; ++w)
      if (wl[w * RP + r] > 0.f) mm = fmaxf(mm, wm[w * RP + r]);
    return mm;
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + g + 8 * hh;
      const float f = l[mt][hh] > 0.f
                          ? fast_exp2(m[mt][hh] - merged_max(r)) : 0.f;
      float* dst = buf + (warp * RP + r) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) =
            make_float2(acc[mt][j][2 * hh] * f, acc[mt][j][2 * hh + 1] * f);
    }
  __syncthreads();
  for (int i = tid; i < R * D; i += kSplitThreads) {
    const int r = i / D, dd = i % D;
    const float mm = merged_max(r);
    float a = 0.f, ll = 0.f;
    for (int w = 0; w < 4; ++w) {
      const float lw = wl[w * RP + r];
      a += buf[(w * RP + r) * D + dd];
      if (lw > 0.f) ll += lw * fast_exp2(wm[w * RP + r] - mm);
    }
    store_row<bf16, D>(o, part, out_row(r), rows_all, dd, a, mm, ll);
  }
}

// fp32 (the tensor cores would need TF32, which stays off): CUDA-core FMAs.
// Per kv tile: thread t scores column t % kBK for rows t / kBK, + 2, ...
// (q broadcast from shared memory, K rows read as 16-byte vectors on an odd
// 16-byte pitch: no bank conflicts); a warp per row runs the online softmax;
// thread t accumulates output dim t % D for rows t / D, + 128 / D, ...
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
flash_split_fma_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ kv_valid,
                       float* __restrict__ o, float* __restrict__ part, int B,
                       int S, int Tk, int H, int Hkv, int gh, int q_offset,
                       int causal, int window, int chunk, float scale_log2) {
  constexpr int kVec = 4;  // floats a 16-byte vector
  constexpr int LD = D + kVec;  // an odd number of 16-byte vectors a row
  constexpr int LP = kBK + 1;
  constexpr int RQ = kSplitRows / (kSplitThreads / kBK);  // score rows
  constexpr int RO = kSplitRows / (kSplitThreads / D);    // output rows
  static_assert((LD / kVec) % 2 == 1, "odd pitch");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [kStages][kBK][LD]
  float* Vs = Ks + kStages * kBK * LD;                  // [kStages][kBK][LD]
  float* Qs = Vs + kStages * kBK * LD;              // [32][D]
  float* Ps = Qs + kSplitRows * D;                  // [32][LP]
  float* Ms = Ps + kSplitRows * LP;                 // m, l, alpha: [3][32]

  const int g_all = H / Hkv, hc = (g_all + gh - 1) / gh;
  const int hk = blockIdx.y / hc, h0 = hk * g_all + (blockIdx.y % hc) * gh;
  const int nh = min(gh, hk * g_all + g_all - h0);
  const int R = nh * S, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long rows_all = (long long)B * S * H;
  const ChunkRange cr = chunk_range(kv_valid, b, Tk, S, chunk, q_offset,
                                    causal, window);
  auto out_row = [&](int r) {
    return ((long long)b * S + r % S) * H + h0 + r / S;
  };
  if (cr.hi <= cr.lo) {
    for (int i = tid; i < R * D; i += kSplitThreads)
      store_row<float, D>(o, part, out_row(i / D), rows_all, i % D, 0.f, kNeg,
                      0.f);
    return;
  }
  const int c0 = blockIdx.x * chunk;
  const int t_first = c0 + (cr.lo - c0) / kBK * kBK;
  const int ntiles = (cr.hi - t_first + kBK - 1) / kBK;
  const long long kv_stride = (long long)Hkv * D;
  const float* kg = k + (long long)b * Tk * kv_stride + (long long)hk * D;
  const float* vg = v + (long long)b * Tk * kv_stride + (long long)hk * D;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles)
      stage_kv<float, D, LD>(Ks + s * kBK * LD, Vs + s * kBK * LD, kg, vg,
                         kv_stride, t_first + s * kBK, cr.hi);
    cp_async_commit();
  }
  for (int i = tid; i < kSplitRows * D; i += kSplitThreads) {
    const int r = i / D;
    Qs[i] = r < R ? q[out_row(r) * D + i % D] : 0.f;
  }
  if (tid < kSplitRows) {
    Ms[tid] = kNeg;
    Ms[kSplitRows + tid] = 0.f;
  }

  const int sc = tid % kBK, sr = tid / kBK;  // score column, first row
  const int od = tid % D, orow = tid / D;    // output dim, first row
  constexpr int RS = kSplitThreads / kBK, RSO = kSplitThreads / D;
  float acc[RO];
#pragma unroll
  for (int j = 0; j < RO; ++j) acc[j] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < ntiles)
      stage_kv<float, D, LD>(Ks + (nxt % kStages) * kBK * LD,
                         Vs + (nxt % kStages) * kBK * LD, kg, vg, kv_stride,
                         t_first + nxt * kBK, cr.hi);
    cp_async_commit();
    const int t0 = t_first + it * kBK;
    const float* kt = Ks + (it % kStages) * kBK * LD;
    const float* vt = Vs + (it % kStages) * kBK * LD;

    float s[RQ];
#pragma unroll
    for (int j = 0; j < RQ; ++j) s[j] = 0.f;
    for (int c = 0; c < D; c += kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kt + sc * LD + c);
      const float* kf = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        if (sr + RS * j < R) {
          const float* qr = Qs + (sr + RS * j) * D + c;
#pragma unroll
          for (int e = 0; e < kVec; ++e) s[j] += qr[e] * kf[e];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RQ; ++j)
      if (sr + RS * j < R) Ps[(sr + RS * j) * LP + sc] = s[j] * scale_log2;
    __syncthreads();

    for (int r = warp; r < R; r += kSplitThreads / 32) {
      const int arow = q_offset + r % S;
      float x[2];
      bool ok[2];
      float mx = kNeg;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        ok[e] = col_visible(t0 + c, arow, cr.lim, causal, window);
        x[e] = ok[e] ? Ps[r * LP + c] : kNeg;
        mx = fmaxf(mx, x[e]);
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = Ms[r], mn = fmaxf(m_old, mx);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ok[e] ? exp2f(x[e] - mn) : 0.f;
        Ps[r * LP + lane + 32 * e] = p;
        psum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, w);
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_old - mn);
        Ms[r] = mn;
        Ms[kSplitRows + r] = Ms[kSplitRows + r] * alpha + psum;
        Ms[2 * kSplitRows + r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int r = orow + RSO * j;
      if (r < R) {
        float a = acc[j] * Ms[2 * kSplitRows + r];
        const float* pr = Ps + r * LP;
        for (int c = 0; c < kBK; ++c) a += pr[c] * vt[c * LD + od];
        acc[j] = a;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RO; ++j) {
    const int r = orow + RSO * j;
    if (r < R)
      store_row<float, D>(o, part, out_row(r), rows_all, od, acc[j], Ms[r],
                      Ms[kSplitRows + r]);
  }
}

// Merge the splits of each row in split order: M = the largest m of the
// splits that saw a column (l > 0), L = sum l 2^(m - M), acc likewise; the
// output is acc / max(L, 1e-30), 0 where every split was empty.  One CTA of
// D threads a row of [B, S, H]: thread dd reads its dim of every split, the
// loads independent of one another; (m, l) of the splits go through shared
// memory.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                     int rows, int n_split) {
  // (m, l) of every split, then wts[s] = l > 0 ? 2^(m - M) : 0, then L
  extern __shared__ float sh[];
  float* wts = sh + 2 * n_split;
  const long long row = blockIdx.x;
  const int dd = threadIdx.x;
  const float* ml = part + (long long)n_split * rows * D;
  for (int i = dd; i < 2 * n_split; i += D)
    sh[i] = ml[((long long)(i / 2) * rows + row) * 2 + i % 2];
  __syncthreads();
  if (dd == 0) {
    float mm = kNeg, ll = 0.f;
    for (int s = 0; s < n_split; ++s)
      if (sh[2 * s + 1] > 0.f) mm = fmaxf(mm, sh[2 * s]);
    for (int s = 0; s < n_split; ++s) {
      const float f = sh[2 * s + 1] > 0.f ? exp2f(sh[2 * s] - mm) : 0.f;
      wts[s] = f;
      ll += sh[2 * s + 1] * f;
    }
    wts[n_split] = ll;
  }
  __syncthreads();
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float f = wts[s];
    if (f > 0.f) acc += part[((long long)s * rows + row) * D + dd] * f;
  }
  o[row * D + dd] = from_float<T>(acc / fmaxf(wts[n_split], 1e-30f));
}

// Above 48 KB a kernel must opt in to dynamic shared memory: once for
// each instantiation (SMEM is fixed by its template arguments).
template <typename Kern>
cudaError_t opt_in_smem(Kern kern, size_t smem, bool& done) {
  if (done || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = e == cudaSuccess;
  return e;
}

struct SplitArgs {
  const void *q, *k, *v;
  const int* kv_valid;
  void* o;
  float* part;
  int B, S, Tk, H, Hkv, gh, q_offset, causal, window, chunk;
  float scale_log2;
};

template <int D, int MT>
cudaError_t launch_split_mma(const SplitArgs& a, dim3 grid,
                             cudaStream_t stream) {
  static_assert(4 * MT * 16 * D * sizeof(float) <=
                    2 * kStages * kBK * (D + 8) * sizeof(bf16),
                "the merge buffer fits in the ring");
  const size_t smem =
      (size_t)(MT * 16 + 2 * kStages * kBK) * (D + 8) * sizeof(bf16) +
      2 * 4 * MT * 16 * sizeof(float);
  auto kern = flash_split_mma_kernel<D, MT>;
  static bool opted_in = false;
  const cudaError_t e = opt_in_smem(kern, smem, opted_in);
  if (e != cudaSuccess) return e;
  kern<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.kv_valid, static_cast<bf16*>(a.o),
      a.part, a.B, a.S, a.Tk, a.H, a.Hkv, a.gh, a.q_offset, a.causal,
      a.window, a.chunk, a.scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_split_fma(const SplitArgs& a, dim3 grid,
                             cudaStream_t stream) {
  constexpr int LD = D + 4;
  const size_t smem = (size_t)(2 * kStages * kBK * LD + kSplitRows * D +
                               kSplitRows * (kBK + 1) + 3 * kSplitRows) *
                      sizeof(float);
  auto kern = flash_split_fma_kernel<D>;
  static bool opted_in = false;
  const cudaError_t e = opt_in_smem(kern, smem, opted_in);
  if (e != cudaSuccess) return e;
  kern<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.kv_valid, static_cast<float*>(a.o),
      a.part,
      a.B, a.S, a.Tk, a.H, a.Hkv, a.gh, a.q_offset, a.causal, a.window,
      a.chunk, a.scale_log2);
  return cudaGetLastError();
}

// Decode: the split kernel (tensor cores for bf16, CUDA cores for fp32),
// then, when there is more than one split, the combine pass.
template <typename T, int D>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* kv_valid, void* o, void* scratch, int B,
                         int S, int Tk, int H, int Hkv, int q_offset,
                         int causal, int window, int n_split, int chunk,
                         float scale, cudaStream_t stream) {
  if (S > 4 || n_split < 1 || chunk <= 0 || chunk % kBK != 0 ||
      (long long)n_split * chunk < Tk ||
      (long long)(n_split - 1) * chunk >= Tk ||
      (n_split > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  const int g = H / Hkv;
  const int gh = min(g, kSplitRows / S);  // query heads a CTA
  const int hc = (g + gh - 1) / gh;       // CTAs a kv head
  const dim3 grid(n_split, Hkv * hc, B);
  const SplitArgs a{q, k, v, kv_valid, o, static_cast<float*>(scratch), B,
                    S, Tk, H, Hkv, gh, q_offset, causal, window, chunk,
                    scale * kLog2e};
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value)
    err = gh * S <= 16 ? launch_split_mma<D, 1>(a, grid, stream)
                       : launch_split_mma<D, 2>(a, grid, stream);
  else
    err = launch_split_fma<D>(a, grid, stream);
  if (err != cudaSuccess || n_split == 1) return err;
  const int rows = B * S * H;
  flash_combine_kernel<T, D><<<rows, D, (3 * n_split + 1) * sizeof(float),
                               stream>>>(a.part, static_cast<T*>(o), rows,
                                         n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int d, int route, const void* q, const void* k,
                       const void* v, const int* kv_valid, void* o,
                       void* scratch, int B, int S, int Tk, int H, int Hkv,
                       int q_offset, int causal, int window, int n_split,
                       int chunk, float scale, cudaStream_t stream) {
#define FLASH_ARGS q, k, v, kv_valid, o, B, S, Tk, H, Hkv, q_offset, causal, \
                   window, scale, stream
#define SPLIT_ARGS q, k, v, kv_valid, o, scratch, B, S, Tk, H, Hkv, q_offset, \
                   causal, window, n_split, chunk, scale, stream
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  switch (route) {
    case 0:  // fma: fp32 prefill
      if (kBf16) return cudaErrorInvalidValue;
      switch (d) {
        case 32: return launch_fma<32>(FLASH_ARGS);
        case 64: return launch_fma<64>(FLASH_ARGS);
        case 128: return launch_fma<128>(FLASH_ARGS);
        default: return cudaErrorInvalidValue;
      }
    case 1:  // mma: bf16 prefill
      if (!kBf16) return cudaErrorInvalidValue;
      switch (d) {
        case 32: return launch_mma<32>(FLASH_ARGS);
        case 64: return launch_mma<64>(FLASH_ARGS);
        case 128: return launch_mma<128>(FLASH_ARGS);
        default: return cudaErrorInvalidValue;
      }
    case 2:  // split: decode, either dtype
      switch (d) {
        case 32: return launch_split<T, 32>(SPLIT_ARGS);
        case 64: return launch_split<T, 64>(SPLIT_ARGS);
        case 128: return launch_split<T, 128>(SPLIT_ARGS);
        default: return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
#undef SPLIT_ARGS
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = fma (CUDA cores, fp32
// prefill), 1 = mma (tensor cores, bf16 prefill), 2 = split (decode, S <= 4,
// either dtype).  kv_valid may be null (= T).  window <= 0 means no window.
// split only: the kv axis is cut into n_split chunks of `chunk` columns (a
// multiple of 64; ops.py::decode_plan), and scratch holds n_split * B * S *
// H * (head_dim + 2) floats (may be null when n_split is 1).  Returns
// cudaGetLastError() after the launches (0 = ok).
int flash_attention_fwd(int dtype, int head_dim, int route, const void* q,
                        const void* k, const void* v, const void* kv_valid,
                        void* o, void* scratch, int B, int S, int Tk, int H,
                        int Hkv, int q_offset, int causal, int window,
                        int n_split, int chunk, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int* valid = static_cast<const int*>(kv_valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dim<float>(head_dim, route, q, k, v, valid, o, scratch,
                                  B, S, Tk, H, Hkv, q_offset, causal, window,
                                  n_split, chunk, scale, st);
  if (dtype == 1)
    return (int)launch_dim<bf16>(head_dim, route, q, k, v, valid, o, scratch,
                                 B, S, Tk, H, Hkv, q_offset, causal, window,
                                 n_split, chunk, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
