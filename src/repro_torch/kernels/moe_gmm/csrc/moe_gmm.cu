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
// bf16: the tensor cores (gmm_mma_kernel).  Each CTA computes a BM x BN
// output tile of one expert (in phase (a) BN columns of the gate and of the
// up product, so the SwiGLU stays in the epilogue) with bf16
// mma.sync.m16n8k16 and fp32 accumulators in registers.  A [BM, BK] and
// weight [BK, BN] tiles go through a ring of cp.async stages in shared
// memory (rows padded by 16 bytes: the 8 rows an ldmatrix reads fall in
// distinct banks), so the next tiles' bytes are in flight while this one is
// multiplied; A fragments come from ldmatrix, the row-major weights' B
// fragments from ldmatrix.trans.  Tiles:
//
//   * decode, C <= 16: one m16 row tile covers the slab, so each expert's
//     weights cross HBM once a step; 128 columns and 4 warps a CTA, a ring
//     of 4 stages of BK = 32 (1024 CTAs in phase (a), 384 in (b));
//   * prefill: 128 rows x 64 columns of gate and of up (phase (a)) or 128
//     columns (phase (b)), 4 warps of 64 x 32 / 64 x 64 (few ldmatrix bytes
//     a product), a ring of 3 stages of BK = 64.  A warp whose 64 rows all
//     lie at or beyond the load skips the products, so a tile's padding
//     costs at most 63 rows of them.
//
// The grid is (row tile, column tile, expert), row tiles fastest: the CTAs
// that share a weight tile run together, and the second reads it from L2.
// Ragged C, D and F edges are masked here, with no padding: D and F need
// only be multiples of 8, and the k edge inside a k-step is zero-filled.
//
// fp32 (gmm_fma_kernel; fp32 stays off the tensor cores while TF32 is off):
// the same two phases on CUDA-core FMAs, SGEMM-style.  A and the weights
// stream through a cp.async ring (16-byte copies as they lie in memory,
// edges and dead rows zero-filled); each thread keeps a register tile of
// TM rows x TN columns (phase (a): of gate and of up, side by side) and
// reads A as float4 along k and the weights as float4 along n, so each
// shared word feeds 4-16 FMAs.  ops.py::gmm_plan picks a tile a phase from
// the shapes alone:
//   * decode (C <= 8): one 8-row tile, 16 k-groups of a CTA splitting
//     each 64-deep k-step and added in group order, a 4-stage ring (96 KB
//     of weights in flight a CTA);
//   * prefill: 128 rows x 128 columns of gate and of up (8 x 8 of each a
//     thread) or 256 of down (8 x 16), one k-group, 3 stages of 32; an
//     expert's last row tile with at most 32 live rows takes a sliver
//     path (32 rows, a thread 4 x 4 or 4 x 8) in the same k order;
//   * narrow (where prefill's grid gives under two CTAs an SM): 32 rows,
//     16 / 32 columns, 16 k-groups of a k-step of 64.
//
// Both keep each row's k-sum in one fixed order, whatever the row's place in
// the slab or the loads, with no atomics: the result is deterministic,
// which paged == contiguous serving relies on.
//
// What bounds it on an H100.
//   * Decode (B = 8 tokens, top-2 of 8 experts) reads every loaded expert's
//     weights, 3 * D * F * 2 bytes each in bf16 (4.83 GB for 8
//     Mixtral-8x22B experts): ~1.44 ms at 3.35 TB/s, twice that in fp32.
//     The decode tiles keep three stages of every CTA's weight tiles in
//     flight; fp32 runs at 1.1-1.2x its byte bound (PERF.md section 6).
//   * Prefill (a few hundred kept rows an expert) is bound by the same
//     bytes (~1.46 ms) and by 6 * rows * D * F FLOPs (1.25 ms at C = 1024
//     on 989 TFLOP/s in bf16; 10.8 ms at Jamba's C = 1024 on 67 TFLOP/s in
//     fp32); mma.sync runs well under that peak.  The fp32 prefill tile
//     (one CTA of 8 warps an SM at 255 registers) reaches ~42 % of 67
//     TFLOP/s on Jamba's routing: an expert's last, partly filled row tile
//     streams a whole weight tile for a few rows (PERF.md section 6).
// Next steps: wgmma with TMA loads and a producer warp for the bf16 prefill
// tile; fp32 row tiles that follow each expert's load (its remainder
// folded into the weight stream of the tile before it); the dispatch
// gather fused into the A loads (rows indexed by slot_src).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------- bf16: the tensor cores

typedef __nv_bfloat16 bf16;

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

// A CTA tile of BM rows x BN columns (of each weight matrix), k-steps of
// BK, a ring of STAGES; warps of WM x WN.  Rows padded by 16 bytes in
// shared memory, so the 8 rows an ldmatrix reads fall in distinct banks.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = (BM / WM) * WARPS_N * 32;  // threads
  static constexpr int MT = WM / 16, NTL = WN / 8;     // a warp's mma tiles
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole ldmatrix tiles");
  template <bool GLU>
  static constexpr size_t smem() {
    return (size_t)STAGES * (BM * LDA + (GLU ? 2 : 1) * BK * LDB) *
           sizeof(bf16);
  }
};
// decode (C <= 16): one m16 row tile covers the slab; 4 warps of 32 columns
using DecodeMma = MmaTile<16, 128, 32, 16, 32, 4>;
// prefill: 128-row tiles, 4 warps of 64 rows; phase (a) 64 columns of gate
// and of up
using PrefillGluMma = MmaTile<128, 64, 64, 64, 32, 3>;
using PrefillMma = MmaTile<128, 128, 64, 64, 64, 3>;

// One phase over every expert, bf16 operands and fp32 accumulators:
// out[e] = epilogue(a[e] @ b0[e], a[e] @ b1[e]), a [E, C, K], b0/b1
// [E, K, N], out [E, C, N].  Grid (row tile, column tile, expert): the row
// tiles that share a weight tile are neighbours in launch order, so the
// second reads it from L2.
template <class Tl, bool GLU>
__global__ void __launch_bounds__(Tl::NT)
gmm_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b0,
               const bf16* __restrict__ b1, const int* __restrict__ load,
               bf16* __restrict__ out, int C, int K, int N) {
  constexpr int BM = Tl::BM, BN = Tl::BN, BK = Tl::BK, NT = Tl::NT;
  constexpr int LDA = Tl::LDA, LDB = Tl::LDB, STAGES = Tl::STAGES;
  constexpr int MT = Tl::MT, NTL = Tl::NTL, NB = GLU ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BM][LDA]
  bf16* Bs = As + STAGES * BM * LDA;             // [STAGES][NB][BK][LDB]

  const int e = blockIdx.z, n0 = blockIdx.y * BN, m0 = blockIdx.x * BM;
  const int rows = load == nullptr ? C : min(load[e], C);
  const int live = min(BM, rows - m0);  // live rows of this tile (may be <= 0)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* o = out + ((long long)e * C + m0) * N + n0;

  if (live <= 0) {  // an empty row tile: no weight is read
    if (!GLU) {
      for (int i = tid; i < BM * BN / 8; i += NT) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        if (m0 + r < C && n0 + c < N)
          *reinterpret_cast<uint4*>(o + (long long)r * N + c) =
              make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  const bf16* ag = a + ((long long)e * C + m0) * K;
  const bf16* bg0 = b0 + (long long)e * K * N + n0;
  const bf16* bg1 = GLU ? b1 + (long long)e * K * N + n0 : bg0;
  const int ktiles = (K + BK - 1) / BK;
  // K, N and C edges are zero-filled: K and N are multiples of 8, so a
  // 16-byte vector is all in or all out
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * BM * LDA;
    for (int i = tid; i < BM * BK / 8; i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = r < live && k0 + c < K;
      cp_async16(as + r * LDA + c, ok ? ag + (long long)r * K + k0 + c : ag,
                 ok);
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      bf16* bs = Bs + (stage * NB + q) * BK * LDB;
      const bf16* bg = q == 0 ? bg0 : bg1;
      for (int i = tid; i < BK * BN / 8; i += NT) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(bs + r * LDB + c,
                   ok ? bg + (long long)(k0 + r) * N + c : bg, ok);
      }
    }
  };

  float acc[NB][MT][NTL][4];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
        acc[q][i][j][0] = acc[q][i][j][1] = acc[q][i][j][2] =
            acc[q][i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  const int wm0 = (warp / Tl::WARPS_N) * Tl::WM;
  const int wn0 = (warp % Tl::WARPS_N) * Tl::WN;
  // a warp whose rows all lie at or beyond the load skips the products
  const bool busy = wm0 < live;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for all; stage kt - 1 is free again
    if (kt + STAGES - 1 < ktiles)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * BM * LDA;
    const bf16* bs = Bs + (kt % STAGES) * NB * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK / 16 && busy; ++kk) {
      unsigned af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], as + (wm0 + i * 16 + (lane % 8) +
                                 ((lane / 8) % 2) * 8) * LDA +
                               kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int np = 0; np < NTL / 2; ++np) {
          unsigned bf[4];
          ldmatrix_x4_trans(bf, bs + q * BK * LDB +
                                    (kk * 16 + (lane % 8) +
                                     ((lane / 8) % 2) * 8) * LDB +
                                    wn0 + np * 16 + (lane / 16) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[q][i][2 * np], af[i], bf[0], bf[1]);
            mma_bf16(acc[q][i][2 * np + 1], af[i], bf[2], bf[3]);
          }
        }
    }
  }
  cp_async_wait<0>();

  // epilogue: a lane holds rows g and g + 8, columns 2t and 2t + 1 of each
  // 8-column tile
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm0 + i * 16 + g + 8 * hh;
      if (m0 + r >= C) continue;
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const int c = wn0 + j * 8 + 2 * tq;
        if (n0 + c >= N) continue;
        __nv_bfloat162* dst =
            reinterpret_cast<__nv_bfloat162*>(o + (long long)r * N + c);
        if (r >= live) {
          if (!GLU) *dst = __floats2bfloat162_rn(0.f, 0.f);
        } else if (GLU) {
          float hv[2];
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const float gv = acc[0][i][j][2 * hh + t];
            hv[t] = gv / (1.f + expf(-gv)) * acc[NB - 1][i][j][2 * hh + t];
          }
          *dst = __floats2bfloat162_rn(hv[0], hv[1]);
        } else {
          *dst = __floats2bfloat162_rn(acc[0][i][j][2 * hh],
                                       acc[0][i][j][2 * hh + 1]);
        }
      }
    }
}

template <class Tl, bool GLU>
cudaError_t launch_mma_phase(const void* a, const void* b0, const void* b1,
                             const int* load, void* out, int E, int C, int K,
                             int N, cudaStream_t stream) {
  constexpr size_t smem = Tl::template smem<GLU>();
  auto kern = gmm_mma_kernel<Tl, GLU>;
  static bool opted_in = false;  // above 48 KB: opt in, once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((C + Tl::BM - 1) / Tl::BM, (N + Tl::BN - 1) / Tl::BN, E);
  kern<<<grid, Tl::NT, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b0),
      static_cast<const bf16*>(b1), load, static_cast<bf16*>(out), C, K, N);
  return cudaGetLastError();
}

template <class GluTile, class DownTile>
cudaError_t launch_mma(const void* x, const void* wg, const void* wu,
                       const void* wd, const int* load, void* h, void* y,
                       int E, int C, int D, int F, cudaStream_t stream) {
  const cudaError_t err = launch_mma_phase<GluTile, true>(
      x, wg, wu, load, h, E, C, D, F, stream);
  if (err != cudaSuccess) return err;
  return launch_mma_phase<DownTile, false>(h, wd, nullptr, load, y, E, C, F,
                                           D, stream);
}

// ------------------------------------------------- fp32: the CUDA cores

// An fp32 tile of one phase: BM rows x BN columns of its output (phase
// (a): BN columns of h, so BN of the gate product and BN of the up
// product), k-steps of BK through a cp.async ring of STAGES.  A thread
// holds TM rows x TN columns (x 2 in phase (a)) of fp32 accumulators; the
// CTA's 256 threads form KS groups, group g taking k [g KG, g KG + KG) of
// every k-step, their sums added in group order at the end.  A row's k
// order is fixed by KS and BK alone.
template <int BM_, int BN_, int TM_, int TN_, int KS_, int BK_, int STAGES_,
          int MINB_, bool GLU_>
struct FmaTile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, KS = KS_;
  static constexpr int BK = BK_, STAGES = STAGES_, MINB = MINB_;
  static constexpr bool GLU = GLU_;
  static constexpr int NB = GLU ? 2 : 1;   // weight matrices (gate, up)
  static constexpr int RG = BM / TM;       // thread rows
  static constexpr int CG = BN / TN;       // thread columns
  static constexpr int NT = RG * CG * KS;  // threads
  static constexpr int KG = BK / KS;       // k of a step a group takes
  static constexpr int NC = TN / 4;        // a thread's float4 columns
  static constexpr int LDA = BK + 4;       // row pitches, floats: float4
  static constexpr int LDB = BN + 4;       // aligned, and the k rows two
                                           // groups read in distinct banks
  static constexpr int LDR = NB * BN + 4;  // the groups' sums, a row
  static constexpr size_t kRing =
      (size_t)STAGES * (BM * LDA + NB * BK * LDB) * sizeof(float);
  static constexpr size_t kRed =
      KS > 1 ? (size_t)KS * BM * LDR * sizeof(float) : 0;
  static constexpr size_t smem = kRing > kRed ? kRing : kRed;
  static_assert(NT == 256, "256 threads a CTA");
  static_assert(BM % TM == 0 && BN % TN == 0 && TN % 4 == 0, "whole tiles");
  static_assert(BK % KS == 0 && KG % 4 == 0, "whole float4 k a group");
  static_assert(smem <= 232448, "fits the 227 KB of an H100 CTA");
};

// The three tiles, codes 0-2 (ops.py::FP32_TILES mirrors them; gmm_plan
// picks one a phase from the shapes), for phase (a) (gate and up) and
// phase (b) (down):
//   0 decode (C <= 8): one 8-row tile covers the slab, so each expert's
//     weights cross HBM once; 16 k-groups, a 4-stage ring of BK = 64
//     (3 stages, 96 KB of weights, in flight);
//   1 narrow (where prefill's grid leaves the card short of CTAs): 32
//     rows, 16 / 32 columns, 16 k-groups;
//   2 prefill: 128 rows, 128 / 256 columns (8 x 8 of gate and of up, or
//     8 x 16, a thread), one k-group, 3 stages of 32.  A row tile with at
//     most 32 live rows (an expert's last, partly filled) takes the
//     sliver path instead: the same columns over 32 rows, a thread 4 rows
//     of half as many columns, so its few rows cost a quarter of a
//     thread's work, in the same k order.
using DecodeGlu = FmaTile<8, 64, 8, 4, 16, 64, 4, 1, true>;
using DecodeDown = FmaTile<8, 128, 8, 8, 16, 64, 4, 1, false>;
using NarrowGlu = FmaTile<32, 16, 8, 4, 16, 64, 3, 2, true>;
using NarrowDown = FmaTile<32, 32, 8, 8, 16, 64, 3, 2, false>;
using PrefillGlu = FmaTile<128, 128, 8, 8, 1, 32, 3, 1, true>;
using PrefillDown = FmaTile<128, 256, 8, 16, 1, 32, 3, 1, false>;
using SliverGlu = FmaTile<32, 128, 4, 4, 1, 32, 3, 1, true>;
using SliverDown = FmaTile<32, 256, 4, 8, 1, 32, 3, 1, false>;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// One tile of one phase: rows [m0, m0 + BM) x columns [n0, n0 + BN) of
// out[e] = epilogue(a[e] @ b0[e], a[e] @ b1[e]), rows [m0, m0 + live) live,
// with a [E, C, K], b0/b1 [E, K, N], out [E, C, N], all row-major.  GLU:
// phase (a), out = silu(a b0) * (a b1).  Otherwise phase (b), out = a b0
// (b1 unused), and rows at or beyond the expert's load are written as
// zeros.  A and the weights go through the ring as they lie in memory
// (16-byte cp.async, k edge, column edge and dead rows zero-filled); a
// thread reads its TM rows of A as float4 along k and its weight columns as
// float4 along n, so each shared word feeds TN or 2 TN (A) and TM
// (weights) FMAs.
template <class Tl>
__device__ __forceinline__ void gmm_fma_tile(
    const float* __restrict__ a, const float* __restrict__ b0,
    const float* __restrict__ b1, float* __restrict__ out, int C, int K,
    int N, int e, int m0, int n0, int live) {
  constexpr int BM = Tl::BM, BN = Tl::BN, TM = Tl::TM, TN = Tl::TN;
  constexpr int KS = Tl::KS, BK = Tl::BK, STAGES = Tl::STAGES, NT = Tl::NT;
  constexpr int NB = Tl::NB, CG = Tl::CG, KG = Tl::KG, NC = Tl::NC;
  constexpr int LDA = Tl::LDA, LDB = Tl::LDB, LDR = Tl::LDR;
  constexpr bool GLU = Tl::GLU;
  extern __shared__ __align__(16) float fsm[];
  float* As = fsm;                         // [STAGES][BM][LDA]
  float* Bs = As + STAGES * BM * LDA;      // [STAGES][NB][BK][LDB]

  const int tid = threadIdx.x;
  float* o = out + ((long long)e * C + m0) * N + n0;

  // thread (row group ty, k group kg, column group tx), tx fastest
  const int tx = tid % CG, kg = (tid / CG) % KS, ty = tid / (CG * KS);
  const float* ag = a + ((long long)e * C + m0) * K;
  const float* bg0 = b0 + (long long)e * K * N + n0;
  const float* bg1 = GLU ? b1 + (long long)e * K * N + n0 : bg0;
  const int ktiles = (K + BK - 1) / BK;
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    float* as = As + stage * BM * LDA;
    for (int i = tid; i < BM * BK / 4; i += NT) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool ok = r < live && k0 + c < K;
      cp_async16(as + r * LDA + c, ok ? ag + (long long)r * K + k0 + c : ag,
                 ok);
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      float* bs = Bs + (stage * NB + q) * BK * LDB;
      const float* bg = q == 0 ? bg0 : bg1;
      for (int i = tid; i < BK * BN / 4; i += NT) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(bs + r * LDB + c,
                   ok ? bg + (long long)(k0 + r) * N + c : bg, ok);
      }
    }
  };

  float acc[NB][TM][TN];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[q][i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  // a thread whose rows all lie at or beyond the load skips the products
  const bool busy = ty * TM < live;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for all; stage kt - 1 is free again
    if (kt + STAGES - 1 < ktiles)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    if (!busy) continue;
    const float* as = As + (kt % STAGES) * BM * LDA + ty * TM * LDA + kg * KG;
    const float* bs = Bs + (kt % STAGES) * NB * BK * LDB + kg * KG * LDB +
                      tx * 4;
#pragma unroll
    for (int kk = 0; kk < KG; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + i * LDA + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 bv[NB][NC];
#pragma unroll
        for (int q = 0; q < NB; ++q)
#pragma unroll
          for (int j = 0; j < NC; ++j)
            bv[q][j] = *reinterpret_cast<const float4*>(
                bs + q * BK * LDB + (kk + u) * LDB + j * (BN / NC));
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = u == 0 ? av[i].x : u == 1 ? av[i].y
                        : u == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int q = 0; q < NB; ++q)
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              acc[q][i][4 * j] += x * bv[q][j].x;
              acc[q][i][4 * j + 1] += x * bv[q][j].y;
              acc[q][i][4 * j + 2] += x * bv[q][j].z;
              acc[q][i][4 * j + 3] += x * bv[q][j].w;
            }
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (KS == 1) {
    // epilogue from the registers: rows ty + RG i, float4 columns
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
      if (m0 + r >= C) continue;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = j * (BN / NC) + tx * 4;
        if (n0 + c >= N) continue;
        float* dst = o + (long long)r * N + c;
        if (r >= live) {
          if (!GLU)
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if (GLU) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              silu_mul(acc[0][i][4 * j], acc[NB - 1][i][4 * j]),
              silu_mul(acc[0][i][4 * j + 1], acc[NB - 1][i][4 * j + 1]),
              silu_mul(acc[0][i][4 * j + 2], acc[NB - 1][i][4 * j + 2]),
              silu_mul(acc[0][i][4 * j + 3], acc[NB - 1][i][4 * j + 3]));
        } else {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[0][i][4 * j], acc[0][i][4 * j + 1],
                          acc[0][i][4 * j + 2], acc[0][i][4 * j + 3]);
        }
      }
    }
  } else {
    // the groups' sums through shared memory (over the drained ring),
    // added in group order: red[kg][row][q * BN + column]
    __syncthreads();
    float* red = fsm;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          *reinterpret_cast<float4*>(
              red + (kg * BM + ty * TM + i) * LDR + q * BN + j * (BN / NC) +
              tx * 4) =
              make_float4(acc[q][i][4 * j], acc[q][i][4 * j + 1],
                          acc[q][i][4 * j + 2], acc[q][i][4 * j + 3]);
    __syncthreads();
    for (int idx = tid; idx < BM * BN / 4; idx += NT) {
      const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      if (m0 + r >= C || n0 + c >= N) continue;
      float* dst = o + (long long)r * N + c;
      if (r >= live) {
        if (!GLU)
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      float4 sum[NB];
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        sum[q] = *reinterpret_cast<const float4*>(red + r * LDR + q * BN + c);
        for (int g = 1; g < KS; ++g) {
          const float4 p = *reinterpret_cast<const float4*>(
              red + (g * BM + r) * LDR + q * BN + c);
          sum[q].x += p.x;
          sum[q].y += p.y;
          sum[q].z += p.z;
          sum[q].w += p.w;
        }
      }
      if (GLU)
        *reinterpret_cast<float4*>(dst) = make_float4(
            silu_mul(sum[0].x, sum[NB - 1].x),
            silu_mul(sum[0].y, sum[NB - 1].y),
            silu_mul(sum[0].z, sum[NB - 1].z),
            silu_mul(sum[0].w, sum[NB - 1].w));
      else
        *reinterpret_cast<float4*>(dst) = sum[0];
    }
  }
}

// Rows [r0, r1) x BN columns of a tile at (m0, n0) written as zeros (rows
// beyond C and columns beyond N left alone).
template <int BN, int NT>
__device__ __forceinline__ void zero_rows(float* o, int r0, int r1, int m0,
                                          int n0, int C, int N) {
  for (int i = threadIdx.x; i < (r1 - r0) * BN / 4; i += NT) {
    const int r = r0 + i / (BN / 4), c = (i % (BN / 4)) * 4;
    if (m0 + r < C && n0 + c < N)
      *reinterpret_cast<float4*>(o + (long long)r * N + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One phase over every expert: grid (row tile, column tile, expert) of
// tile Tl, row tiles fastest (the CTAs that share a weight tile run
// together, and the second reads it from L2).  A row tile wholly at or
// beyond the expert's load reads no weight (phase (b) writes it as zeros);
// one with at most Sl::BM live rows runs on the sliver tile Sl.
template <class Tl, class Sl>
__global__ void __launch_bounds__(Tl::NT, Tl::MINB)
gmm_fma_kernel(const float* __restrict__ a, const float* __restrict__ b0,
               const float* __restrict__ b1, const int* __restrict__ load,
               float* __restrict__ out, int C, int K, int N) {
  static_assert(Sl::BN == Tl::BN && Sl::GLU == Tl::GLU && Sl::NT == Tl::NT &&
                    Sl::BM <= Tl::BM && Sl::KS == Tl::KS && Sl::BK == Tl::BK,
                "a sliver tile covers the same columns in the same k order");
  const int e = blockIdx.z, m0 = blockIdx.x * Tl::BM;
  const int n0 = blockIdx.y * Tl::BN;
  const int rows = load == nullptr ? C : min(load[e], C);
  const int live = min(Tl::BM, rows - m0);  // live rows (may be <= 0)
  float* o = out + ((long long)e * C + m0) * N + n0;
  if (live <= 0) {
    if (!Tl::GLU) zero_rows<Tl::BN, Tl::NT>(o, 0, Tl::BM, m0, n0, C, N);
    return;
  }
  if constexpr (Sl::BM < Tl::BM) {
    if (live <= Sl::BM) {
      gmm_fma_tile<Sl>(a, b0, b1, out, C, K, N, e, m0, n0, live);
      if (!Tl::GLU) zero_rows<Tl::BN, Tl::NT>(o, Sl::BM, Tl::BM, m0, n0, C, N);
      return;
    }
  }
  gmm_fma_tile<Tl>(a, b0, b1, out, C, K, N, e, m0, n0, live);
}

template <class Tl, class Sl = Tl>
cudaError_t launch_fma_phase(const void* a, const void* b0, const void* b1,
                             const int* load, void* out, int E, int C, int K,
                             int N, cudaStream_t stream) {
  constexpr size_t smem = Tl::smem > Sl::smem ? Tl::smem : Sl::smem;
  auto kern = gmm_fma_kernel<Tl, Sl>;
  static bool opted_in = false;  // above 48 KB: opt in, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((C + Tl::BM - 1) / Tl::BM, (N + Tl::BN - 1) / Tl::BN, E);
  kern<<<grid, Tl::NT, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b0),
      static_cast<const float*>(b1), load, static_cast<float*>(out), C, K, N);
  return cudaGetLastError();
}

// fp32: phase (a) on tile `glu`, phase (b) on tile `down` (codes 0-2)
cudaError_t launch_fp32(const void* x, const void* wg, const void* wu,
                        const void* wd, const int* load, void* h, void* y,
                        int E, int C, int D, int F, int glu, int down,
                        cudaStream_t stream) {
  if (glu < 0 || glu > 2 || down < 0 || down > 2)
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (glu) {
    case 0: err = launch_fma_phase<DecodeGlu>(x, wg, wu, load, h, E, C, D, F,
                                              stream); break;
    case 1: err = launch_fma_phase<NarrowGlu>(x, wg, wu, load, h, E, C, D, F,
                                              stream); break;
    default: err = launch_fma_phase<PrefillGlu, SliverGlu>(
        x, wg, wu, load, h, E, C, D, F, stream);
  }
  if (err != cudaSuccess) return err;
  switch (down) {
    case 0: return launch_fma_phase<DecodeDown>(h, wd, nullptr, load, y, E, C,
                                                F, D, stream);
    case 1: return launch_fma_phase<NarrowDown>(h, wd, nullptr, load, y, E, C,
                                                F, D, stream);
    default: return launch_fma_phase<PrefillDown, SliverDown>(
        h, wd, nullptr, load, y, E, C, F, D, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x [E, C, D], w_gate/w_up [E, D, F],
// w_down [E, F, D], scratch h [E, C, F], output y [E, C, D], all contiguous
// and 16-byte aligned, D and F multiples of 16 bytes' worth of elements
// (8 in bf16, 4 in fp32).
// load: [E] int32 on the device, or null (= every row is live).
// fp32 only: the tiles of phase (a) and phase (b), codes 0-2 of the fp32
// tiles (ops.py::gmm_plan); bf16 picks its own and ignores them.
// Returns cudaGetLastError() after the launches (0 = ok).
int grouped_swiglu_fwd(int dtype, const void* x, const void* w_gate,
                       const void* w_up, const void* w_down, const void* load,
                       void* h, void* y, int E, int C, int D, int F,
                       int tile_glu, int tile_down, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const int* ld = static_cast<const int*>(load);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fp32(x, w_gate, w_up, w_down, ld, h, y, E, C, D, F,
                            tile_glu, tile_down, st);
  if (dtype == 1) {
    if (C <= DecodeMma::BM)
      return (int)launch_mma<DecodeMma, DecodeMma>(x, w_gate, w_up, w_down,
                                                   ld, h, y, E, C, D, F, st);
    return (int)launch_mma<PrefillGluMma, PrefillMma>(
        x, w_gate, w_up, w_down, ld, h, y, E, C, D, F, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* grouped_swiglu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
