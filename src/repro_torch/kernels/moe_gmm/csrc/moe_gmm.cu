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
// fp32 (gmm_kernel; first, simple version; fp32 stays off the tensor cores
// while TF32 is off): the same two phases on CUDA-core FMAs, BM x BN tiles
// staged in shared memory as fp32, a TM x TN micro-tile a thread; decode
// (C <= 8) BM = 8, else BM = BN = 64.
//
// Both keep each row's k-sum in one fixed order, whatever the row's place in
// the slab or the other experts' loads, with no atomics: the result is
// deterministic, which paged == contiguous serving relies on.
//
// What bounds it on an H100.
//   * Decode (B = 8 tokens, top-2 of 8 experts) reads every loaded expert's
//     weights, 3 * D * F * 2 bytes each (4.83 GB for 8 Mixtral-8x22B
//     experts): ~1.44 ms at 3.35 TB/s.  The decode tile keeps three
//     stages of every CTA's weight tiles in flight.
//   * Prefill (a few hundred kept rows an expert) is bound by the same
//     bytes (~1.46 ms) and by 6 * rows * D * F FLOPs (1.25 ms at C = 1024
//     on 989 TFLOP/s); mma.sync runs well under that peak (PERF.md
//     section 6).
// Next steps: wgmma with TMA loads and a producer warp for the prefill tile;
// the dispatch gather fused into the A loads (rows indexed by slot_src).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------- fp32: the CUDA cores

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
// pitch `ld` floats) into shared memory with row pitch LDS.
// Elements at row >= row_lim or column >= col_lim are zero.  col_lim, ld and
// the tile origin are multiples of the 16-byte vector, so a vector is all in
// or all out.
template <int ROWS, int COLS, int LDS, int NT>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      long long ld, int row_lim,
                                      int col_lim) {
  constexpr int kVec = 4;  // floats a 16-byte vector
  constexpr int kVecPerRow = COLS / kVec;
  static_assert(COLS % kVec == 0, "tile width is whole vectors");
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += NT) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float* d = dst + r * LDS + c;
    if (r < row_lim && c < col_lim) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (long long)r * ld + c);
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = e[j];
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
template <class Tl, bool GLU>
__global__ void __launch_bounds__(Tl::NT)
gmm_kernel(const float* __restrict__ a, const float* __restrict__ b0,
           const float* __restrict__ b1, const int* __restrict__ load,
           float* __restrict__ out, int C, int K, int N) {
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
  float* o = out + ((long long)e * C + m0) * N + n0;

  if (live <= 0) {  // an empty row tile: no weight is read
    if (!GLU) {
      for (int i = tid; i < BM * BN; i += NT) {
        const int r = i / BN, c = i % BN;
        if (m0 + r < C && n0 + c < N)
          o[(long long)r * N + c] = 0.f;
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
    stage<BM, BK, LDA, NT>(As, a + a_off + k0, K, live, kl);
    stage<BK, BN, BN, NT>(Bs[0], b0 + b_off + (long long)k0 * N, N, kl,
                             N - n0);
    if (GLU)
      stage<BK, BN, BN, NT>(Bs[NB - 1], b1 + b_off + (long long)k0 * N, N,
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
      float* dst = o + (long long)r * N + c;
      if (r >= live) {
        if (!GLU) *dst = 0.f;  // phase (a) leaves it unread
      } else if (GLU) {
        const float g = acc[0][i][j];
        *dst = g / (1.f + expf(-g)) * acc[NB - 1][i][j];
      } else {
        *dst = acc[0][i][j];
      }
    }
  }
}

template <class Tl, bool GLU>
cudaError_t launch_phase(const void* a, const void* b0, const void* b1,
                         const int* load, void* out, int E, int C, int K,
                         int N, cudaStream_t stream) {
  const dim3 grid((N + Tl::BN - 1) / Tl::BN, (C + Tl::BM - 1) / Tl::BM, E);
  gmm_kernel<Tl, GLU><<<grid, Tl::NT, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b0),
      static_cast<const float*>(b1), load, static_cast<float*>(out), C, K,
      N);
  return cudaGetLastError();
}

template <class Tl>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const int* load, void* h, void* y, int E,
                   int C, int D, int F, cudaStream_t stream) {
  const cudaError_t err =
      launch_phase<Tl, true>(x, wg, wu, load, h, E, C, D, F, stream);
  if (err != cudaSuccess) return err;
  return launch_phase<Tl, false>(h, wd, nullptr, load, y, E, C, F, D,
                                    stream);
}

// fp32: the CUDA-core kernel
cudaError_t launch_fp32(const void* x, const void* wg, const void* wu,
                        const void* wd, const int* load, void* h, void* y,
                        int E, int C, int D, int F, cudaStream_t stream) {
  if (C <= DecodeTile::BM)
    return launch<DecodeTile>(x, wg, wu, wd, load, h, y, E, C, D, F,
                              stream);
  return launch<PrefillTile>(x, wg, wu, wd, load, h, y, E, C, D, F, stream);
}

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x [E, C, D], w_gate/w_up [E, D, F],
// w_down [E, F, D], scratch h [E, C, F], output y [E, C, D], all contiguous
// and 16-byte aligned, D and F multiples of 16 bytes' worth of elements
// (8 in bf16, 4 in fp32).
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
    return (int)launch_fp32(x, w_gate, w_up, w_down, ld, h, y, E, C, D, F,
                            st);
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
