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
// r, k, v, y: [B, T, H, N] in bf16 or fp32 (y in r's type); w: [B, T, H, N]
// fp32 decay in (0, 1]; u: [H, N] fp32; s0, s_end: [B, H, N, N] fp32.  N is
// 16, 32 or 64.  Everything is computed in fp32.
//
// What bounds it on an H100.  The bytes are r, k, v, y once each and w in
// fp32 (12 B an element in bf16: 32.8 MB at B = 1, T = 1024, H = 40,
// N = 64, 9.8 us at 3.35 TB/s); the recurrence's 5 N^2 + 5 N fp32
// operations a step and head (0.85 GFLOP there) take 12.7 us on the CUDA
// cores at 67 TFLOP/s.  Walking the T steps in order pays each step's
// latency T times and never reaches the tensor cores; the chunked form
// below puts the N^2 work on them and leaves T / 64 dependent steps.
//
// The chunked form.  Each (b, h) sequence is cut into chunks of C = 64
// steps (the last one zero-padded: r = k = v = 0 add nothing), each chunk
// into sub-blocks of SB = 16.  With lam = max(log w, -30) and L the sum of
// lam from the chunk's start (L_(i-1) before step i):
//
//   y_i   = (r_i e^{L_(i-1)}) S_in + sum_(j<i) A[i,j] v_j + (r_i u k_i) v_i
//   A[i,j] = sum_n r_i[n] k_j[n] e^{L_(i-1)[n] - L_j[n]}
//   S_out = e^{L_last} S_in + sum_j (k_j e^{L_last - L_j}) v_j^T
//
// Numerics.  The floor of -30 nats on lam changes a step's decay by at most
// e^-30 (~1e-13) of the state it multiplies, and keeps log w finite where
// fp32 w underflows to 0 (w = exp(-exp(x)), x > ~4.6).  Every exponent is a
// sum of lam over the steps between two points, so it is <= 0 and every
// factor <= 1: nothing overflows and no inf - inf occurs.  None is taken as
// a difference of two long cumulative sums (which would cancel): with E
// (the sum within the sub-block before a step), Q (after a step) and G (a
// sub-block's total), all in log2 units, the factors are e^E, e^Q and per
// channel e^{G_(J+1) + .. + G_(I-1)}, e^{G_0 + .. + G_(I-1)} and
// e^{G_(I+1) + .. + G_last}, multiplied together.  The off-diagonal 16 x 16
// blocks of A factor through the step before the row block's start:
// A[I, J] = (r_I e^{E_I} e^{G_(J+1) + .. + G_(I-1)}) (k_J e^{Q_J})^T.  The
// diagonal blocks are fp32 FMAs an element, their factor e^{L_(i-1) - L_j}
// the product of the decays between j and i (a product needs no floor).
// The four products (those off-diagonal blocks, A V, (r e^L) S_in and the
// increment (k e^{L_last - L})^T V) run on mma.sync m16n8k8 TF32 with fp32
// accumulation, each fp32 operand split into a high and a low TF32 part:
// three products where both operands are fp32 (3xTF32), two where one is
// bf16 (exact in TF32).  ref.wkv6_chunked_plain is the same algorithm in
// plain PyTorch, for the CPU tests.
//
// Design.  One CTA of 8 warps for each (b, h, chunk): 640 CTAs at B = 1,
// T = 1024, H = 40, two on an SM (102 KiB of shared memory each in bf16
// at N = 64, 90 KiB in fp32).
//  1. Everything that does not need S_in.  The chunk's r, k, v and w in
//     shared memory in one round trip (cp.async; bf16 inputs stay as
//     loaded).  A's diagonal blocks: warps 2 I and 2 I + 1 the block of
//     sub-block I, a lane two rows and pairs of channels, joined by
//     shuffles.  A thread a (sub-block, channel): lam (log2f), E, Q, G, and
//     r e^E, k e^Q in fp32.  The six off-diagonal blocks, a warp each, while
//     the last two warps form the per-channel factors.  A V (a warp the rows
//     of a sub-block, half the columns) and the increment (a warp four
//     16 x 8 tiles of the state) stay in registers.
//  2. The state crosses chunks in order, thread by thread.  Each thread
//     owns the 16 elements of the state where its increment's accumulators
//     lie, the same in every chunk.  It polls its predecessor's thread's
//     words of S_in (s0, fetched at the start, or 0 for the first chunk),
//     forms S_out = e^{L_last} S_in + increment and writes it (to s_end for
//     the last chunk, else to one of two state buffers of its head, which
//     its successor reads).  A word carries its value and its writer's tag
//     (chunk + 1) in 64 bits: no flag, fence or barrier on the chain, whose
//     step between chunks is an L2 round trip and an FMA.  The buffers are
//     zeroed by the caller, so no stale word carries a live tag.  CTAs take
//     their chunk index from a device counter, chunk-major, so a CTA only
//     ever waits on one that took its index earlier and is running: no
//     deadlock.
//  3. It adds (r e^L) S_in to the A V accumulators and writes y.
// Each chunk takes S_in from its immediate predecessor, and every output is
// one fixed sequence of operations (no atomics on data, no look-back over
// aggregates): the result is the same bits on every call.  A sequence of
// one chunk needs no counter or state buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int C = 64;            // steps a chunk
constexpr int SB = 16;           // steps a sub-block
constexpr int NSB = C / SB;      // sub-blocks a chunk
constexpr int NW = 2 * NSB;      // warps: two a sub-block
constexpr int THREADS = 32 * NW;
// lam's floor of -30 nats, in log2 units
constexpr float LOG2_FLOOR = -30.0f * 1.4426950408889634f;

// 2^x for x <= 0 (ex2.approx: 2 ulp; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory; zeros where !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x = hi + lo to fp32 accuracy.  hi is x rounded to TF32 (to nearest, ties
// away from zero, as cvt.rna.tf32 rounds a finite value: add half a TF32
// ulp, clear the 13 low bits); lo = x - hi is exact, and the tensor core
// reads only its top 19 bits, so it stands within 2^-21 of x's magnitude.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16 x 8 A fragment (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4)), split into high and low TF32 parts.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// acc[t] += A B_t and cor[t] += the low-part terms, to fp32 accuracy
// together, for TN 8 x 8 B fragments (b[t][0] at (t4, g), b[t][1] at
// (t4 + 4, g)) given as TF32 high and low parts.  Two accumulators keep
// the dependent MMAs on each short; the products are grouped by term so
// that the TN tiles' MMAs issue back to back.  B_EXACT: B is bf16, exact
// in TF32, so its low part is 0 and two terms remain.
template <bool B_EXACT, int TN>
__device__ __forceinline__ void mma3(float (*acc)[4], float (*cor)[4],
                                     const FragA& a, const uint32_t (*hi)[2],
                                     const uint32_t (*lo)[2]) {
#pragma unroll
  for (int t = 0; t < TN; ++t) mma_tf32(cor[t], a.lo, hi[t][0], hi[t][1]);
  if (!B_EXACT)
#pragma unroll
    for (int t = 0; t < TN; ++t) mma_tf32(cor[t], a.hi, lo[t][0], lo[t][1]);
#pragma unroll
  for (int t = 0; t < TN; ++t) mma_tf32(acc[t], a.hi, hi[t][0], hi[t][1]);
}

// A state word crossing chunks: the fp32 value in the low half, the tag of
// the chunk that wrote it (its index + 1) in the high half.  Words are
// written and read with relaxed gpu-scope (strong) accesses, each 64-bit
// word single-copy atomic, so a reader that sees the tag sees the value;
// weak loads could return a stale copy of a line, tag and all, from an
// earlier call on the same memory.  Two neighbouring words travel as one
// 16-byte access, and a thread issues all its accesses back to back before
// it checks a tag.
__device__ __forceinline__ unsigned long long ld_tagged(
    const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(word) : "l"(p) : "memory");
  return word;
}
__device__ __forceinline__ ulonglong2 ld_tagged2(
    const unsigned long long* p) {
  ulonglong2 x;
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(x.x), "=l"(x.y) : "l"(p) : "memory");
  return x;
}
__device__ __forceinline__ void st_tagged2(unsigned long long* p, float a,
                                           float b, unsigned tag) {
  const unsigned long long hi = static_cast<unsigned long long>(tag) << 32;
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};\n" ::"l"(p),
               "l"(hi | __float_as_uint(a)), "l"(hi | __float_as_uint(b))
               : "memory");
}

// Shared memory, in floats.  Row strides are padded so that a warp's reads
// fall in distinct banks: N + 4 floats for arrays read as [row][k] A
// operands, N + 8 for [k][col] B operands and for w, N + 16 bf16 for the
// staged inputs (the diagonal blocks read 16 channels of 4 rows at once).
// fp32 inputs land in R, K and V; bf16 inputs stay as loaded in STAGE
// ([3][C][N + 16] bf16: r, k, v).
template <typename T, int N>
struct Smem {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int LD = N + 4, LDB = N + 8, LDA = C + 4, LDS = N + 16;
  static constexpr int R = 0;                  // (r, then) r e^E
  static constexpr int K = R + C * LD;         // (k, then) k e^Q
  static constexpr int W = K + C * LD;         // w
  static constexpr int A = W + C * LDB;
  static constexpr int V = A + C * LDA;        // v (fp32) or STAGE (bf16)
  static constexpr int STAGE = V;
  static constexpr int G = V + (BF16 ? 3 * C * LDS / 2 : C * LDB);
  static constexpr int EB = G + NSB * N;       // e^{G_0 + .. + G_(I-1)}
  static constexpr int EA = EB + NSB * N;      // e^{G_(I+1) + .. + G_last}
  static constexpr int D = EA + NSB * N;       // e^{L_last} [N]
  static constexpr int FLOATS = D + N;
  // S_in split into TF32 parts, once w, A and v are dead
  static constexpr int SHI = W, SLO = W + N * LDB;
  static_assert(SLO + N * LDB <= G, "S_in must fit before G");
};

// an input element (a = 0, 1, 2: r, k, v) as loaded, as fp32
template <typename T, int N>
__device__ __forceinline__ float in_at(const float* smem, int a, int row,
                                       int col) {
  using SM = Smem<T, N>;
  if (SM::BF16) {
    const unsigned short x = reinterpret_cast<const unsigned short*>(
        smem + SM::STAGE)[(a * C + row) * SM::LDS + col];
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  return a == 2 ? smem[SM::V + row * SM::LDB + col]
                : smem[a * C * SM::LD + row * SM::LD + col];
}

// two neighbouring input elements (col even) as fp32
template <typename T, int N>
__device__ __forceinline__ float2 in2_at(const float* smem, int a, int row,
                                         int col) {
  using SM = Smem<T, N>;
  if (SM::BF16) {
    const uint32_t x = reinterpret_cast<const uint32_t*>(
        smem + SM::STAGE)[((a * C + row) * SM::LDS + col) / 2];
    return make_float2(__uint_as_float(x << 16),
                       __uint_as_float(x & 0xffff0000u));
  }
  return *reinterpret_cast<const float2*>(
      smem + (a == 2 ? SM::V + row * SM::LDB : a * C * SM::LD + row * SM::LD)
      + col);
}

// 1b. A's diagonal block of sub-block `blk`, in fp32 FMAs.  Lane (p, q)
// of a group of QN takes local rows p and 15 - p (the 15 entries below the
// diagonal between them, and the two bonus terms r u k) over the channel
// pairs n = 2 QN nn + 2 q, + 1; the QN lanes are joined by shuffles.  The
// factor e^{L_(i-1) - L_j} is the product of the decays between j and i,
// walked from j = i - 1 down (a product needs no floor: w = 0 gives the
// factor's true value, 0).
template <typename T, int N, int QN>
__device__ __forceinline__ void wkv6_diag(float* smem, const float* uh,
                                          int blk, int p, int q) {
  using SM = Smem<T, N>;
  constexpr int LDB = SM::LDB, LDA = SM::LDA;
  const float* sW = smem + SM::W;
  float* sA = smem + SM::A;
  const int blk0 = blk * SB;
  const int ra = blk0 + p, rb = blk0 + SB - 1 - p;
  float acc[SB - 1], bon_a = 0.f, bon_b = 0.f;
#pragma unroll
  for (int m = 0; m < SB - 1; ++m) acc[m] = 0.f;
#pragma unroll 2
  for (int nn = 0; nn < N / (2 * QN); ++nn) {
    const int n = 2 * QN * nn + 2 * q;
    const float2 r_a = in2_at<T, N>(smem, 0, ra, n);
    const float2 r_b = in2_at<T, N>(smem, 0, rb, n);
    const float2 un = __ldg(reinterpret_cast<const float2*>(uh + n));
    const float2 k_a = in2_at<T, N>(smem, 1, ra, n);
    const float2 k_b = in2_at<T, N>(smem, 1, rb, n);
    bon_a = fmaf(r_a.x * un.x, k_a.x, fmaf(r_a.y * un.y, k_a.y, bon_a));
    bon_b = fmaf(r_b.x * un.x, k_b.x, fmaf(r_b.y * un.y, k_b.y, bon_b));
    float f0 = 1.f, f1 = 1.f;
#pragma unroll
    for (int m = 0; m < SB - 1; ++m) {
      const bool in_a = m < p;
      if (m == p) f0 = f1 = 1.f;
      const int j = blk0 + (in_a ? p - 1 - m : SB - 2 - m);
      const float2 kj = in2_at<T, N>(smem, 1, j, n);
      const float2 wj = *reinterpret_cast<const float2*>(sW + j * LDB + n);
      acc[m] = fmaf(in_a ? r_a.x : r_b.x, kj.x * f0, acc[m]);
      acc[m] = fmaf(in_a ? r_a.y : r_b.y, kj.y * f1, acc[m]);
      f0 *= wj.x;
      f1 *= wj.y;
    }
  }
#pragma unroll
  for (int off = 1; off < QN; off <<= 1) {
#pragma unroll
    for (int m = 0; m < SB - 1; ++m)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
    bon_a += __shfl_xor_sync(0xffffffffu, bon_a, off);
    bon_b += __shfl_xor_sync(0xffffffffu, bon_b, off);
  }
  if (q == 0) {
#pragma unroll
    for (int m = 0; m < SB - 1; ++m) {
      if (m < p)
        sA[ra * LDA + blk0 + p - 1 - m] = acc[m];
      else
        sA[rb * LDA + blk0 + SB - 2 - m] = acc[m];
    }
    sA[ra * LDA + blk0 + p] = bon_a;
    sA[rb * LDA + blk0 + SB - 1 - p] = bon_b;
    // above the diagonal: row a from p + 1, row b from 16 - p
    for (int j = p + 1; j < SB; ++j) sA[ra * LDA + blk0 + j] = 0.f;
    for (int j = SB - p; j < SB; ++j) sA[rb * LDA + blk0 + j] = 0.f;
  }
}

// 1c. for (sub-block, channel) item p, in one thread: lam = max(log2 w,
// floor) (0 past the end), E (the sum within the sub-block before a step),
// Q (after it) and G (the total); r e^E and k e^Q into R and K
template <typename T, int N>
__device__ __forceinline__ void wkv6_scan(float* smem, int p, int steps) {
  using SM = Smem<T, N>;
  constexpr int LD = SM::LD, LDB = SM::LDB;
  const float* sW = smem + SM::W;
  float* sR = smem + SM::R;
  float* sK = smem + SM::K;
  const int blk = p / N, n = p % N, row0 = blk * SB;
  float lam[SB];
#pragma unroll
  for (int s = 0; s < SB; ++s)
    lam[s] = row0 + s < steps
                 ? fmaxf(log2f(sW[(row0 + s) * LDB + n]), LOG2_FLOOR)
                 : 0.f;
  float e = 0.f;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    sR[(row0 + s) * LD + n] = in_at<T, N>(smem, 0, row0 + s, n) * exp2_neg(e);
    e += lam[s];
  }
  smem[SM::G + blk * N + n] = e;
  float qs = 0.f;
#pragma unroll
  for (int s = SB - 1; s >= 0; --s) {
    sK[(row0 + s) * LD + n] = in_at<T, N>(smem, 1, row0 + s, n) * exp2_neg(qs);
    qs += lam[s];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2)
    wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, T* __restrict__ y,
                      float* __restrict__ s_end,
                      unsigned long long* __restrict__ chain, int Tn, int H,
                      int BH, int nchunks) {
  using SM = Smem<T, N>;
  constexpr int LD = SM::LD, LDB = SM::LDB, LDA = SM::LDA;
  constexpr int NT = N / 8;                   // 8-wide tiles across N
  constexpr bool BF16 = SM::BF16;             // bf16 v is exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* sR = smem + SM::R;
  float* sK = smem + SM::K;
  float* sW = smem + SM::W;
  float* sA = smem + SM::A;
  float* sG = smem + SM::G;
  float* sEB = smem + SM::EB;
  float* sEA = smem + SM::EA;
  float* sD = smem + SM::D;
  uint32_t* sShi = reinterpret_cast<uint32_t*>(smem + SM::SHI);
  uint32_t* sSlo = reinterpret_cast<uint32_t*>(smem + SM::SLO);
  __shared__ int s_ticket;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wblk = warp >> 1, whalf = warp & 1;   // a sub-block, a half

  // chunk-major tickets: chunk c of every head before chunk c + 1 of any
  int ticket = blockIdx.x;
  if (nchunks > 1) {
    if (tid == 0)
      s_ticket = atomicAdd(reinterpret_cast<int*>(chain + 2 * BH * N * N), 1);
    __syncthreads();
    ticket = s_ticket;
  }
  const int chunk = ticket / BH, bh = ticket % BH;
  const int b = bh / H, h = bh % H;
  const int t0 = chunk * C;
  const int steps = min(C, Tn - t0);
  const long tstride = (long)H * N;
  const long base = ((long)b * Tn + t0) * tstride + (long)h * N;
  const long nn2 = (long)N * N;

  // the state tiles this thread carries: 16 x 8 tiles of the increment,
  // TPW a warp, all in one row block
  constexpr int TILES = N * N / 128;
  constexpr int TPW = TILES >= NW ? TILES / NW : 1;
  const int tile0 = warp * TPW;
  const bool has_tiles = tile0 < TILES;
  const int rb = tile0 / NT, ct0 = tile0 % NT;
  // the first chunk's S_in (s0) is fetched now, under the work below
  float2 s_first[TPW][2];
  if (chunk == 0 && s0 && has_tiles)
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        s_first[tt][half] = __ldg(reinterpret_cast<const float2*>(
            s0 + bh * nn2 + (rb * 16 + g + 8 * half) * N + (ct0 + tt) * 8 +
            2 * t4));

  // 1a. the chunk in shared memory in one round trip (cp.async; rows past
  // the end zero-filled)
  {
    constexpr int VE = 16 / sizeof(T);        // elements a 16-byte piece
    constexpr int VPR = N / VE;
    for (int idx = tid; idx < 3 * C * VPR; idx += THREADS) {
      const int a = idx / (C * VPR), row = idx / VPR % C;
      const int c0 = idx % VPR * VE;
      const bool ok = row < steps;
      const T* src = (a == 0 ? r : a == 1 ? k : v) + base +
                     (ok ? row : 0) * tstride + c0;
      void* dst;
      if (BF16)
        dst = reinterpret_cast<T*>(smem + SM::STAGE) + (a * C + row) * SM::LDS
              + c0;
      else
        dst = smem + (a == 2 ? SM::V + row * LDB : a * C * LD + row * LD) + c0;
      cp_async16(dst, src, ok);
    }
    for (int idx = tid; idx < C * N / 4; idx += THREADS) {
      const int row = idx / (N / 4), c0 = idx % (N / 4) * 4;
      const bool ok = row < steps;
      cp_async16(sW + row * LDB + c0, w + base + (ok ? row : 0) * tstride + c0,
                 ok);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // 1b. A's diagonal blocks (wkv6_diag: warps 2 I and 2 I + 1 the block of
  // sub-block I), then 1c. the sums and scalings of each (sub-block,
  // channel) (wkv6_scan).  fp32 r, k are scaled in place by the scans; bf16
  // ones stay as loaded, so a warp goes on while the others finish their
  // diagonal block.
  wkv6_diag<T, N, 8>(smem, u + (long)h * N, wblk, whalf * 4 + (lane >> 3),
                     lane & 7);
  if (!BF16) __syncthreads();
  for (int p = tid; p < NSB * N; p += THREADS) wkv6_scan<T, N>(smem, p, steps);
  __syncthreads();

  // 1d. A's off-diagonal blocks (I, J), J < I, on the tensor cores, warp w
  // the w-th pair: (r_I e^{E_I} e^{G_(J+1) + .. + G_(I-1)}) (k_J e^{Q_J})^T
  // over the N channels, every factor <= 1.  Meanwhile the last warps form
  // the per-channel factors e^{G_0 + .. + G_(I-1)}, e^{G_(I+1) + .. +
  // G_last} and the chunk's decay e^{L_last}.
  constexpr int PAIRS = NSB * (NSB - 1) / 2;
  if (warp < PAIRS) {
    int bi = 1;
    while (bi * (bi + 1) / 2 <= warp) ++bi;
    const int bj = warp - bi * (bi - 1) / 2;
    float acc[2][4] = {}, cor[2][4] = {};
    const int i0 = bi * SB + g, i1 = i0 + 8;
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
      const int n0 = kk * 8 + t4, n1 = n0 + 4;
      // G_(J+1) + .. + G_(I-1): at most two sub-blocks lie between
      float mid0 = 0.f, mid1 = 0.f;
#pragma unroll
      for (int m = 1; m < NSB - 1; ++m)
        if (bj + m < bi) {
          mid0 += sG[(bj + m) * N + n0];
          mid1 += sG[(bj + m) * N + n1];
        }
      const float f0 = exp2_neg(mid0), f1 = exp2_neg(mid1);
      const FragA a(sR[i0 * LD + n0] * f0, sR[i1 * LD + n0] * f0,
                    sR[i0 * LD + n1] * f1, sR[i1 * LD + n1] * f1);
      uint32_t hi[2][2], lo[2][2];
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int j = bj * SB + jt * 8 + g;
        split(sK[j * LD + n0], hi[jt][0], lo[jt][0]);
        split(sK[j * LD + n1], hi[jt][1], lo[jt][1]);
      }
      mma3<false, 2>(acc, cor, a, hi, lo);
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      const int col = bj * SB + jt * 8 + 2 * t4;
      store2(sA + i0 * LDA + col, acc[jt][0] + cor[jt][0],
             acc[jt][1] + cor[jt][1]);
      store2(sA + i1 * LDA + col, acc[jt][2] + cor[jt][2],
             acc[jt][3] + cor[jt][3]);
    }
  } else {
    for (int n = tid - 32 * PAIRS; n < N; n += 32 * (NW - PAIRS)) {
      float before = 0.f, after = 0.f;
#pragma unroll
      for (int m = 0; m < NSB; ++m) {
        sEB[m * N + n] = exp2_neg(before);
        before += sG[m * N + n];
        sEA[(NSB - 1 - m) * N + n] = exp2_neg(after);
        after += sG[(NSB - 1 - m) * N + n];
      }
      sD[n] = exp2_neg(before);
    }
  }
  __syncthreads();

  // v's B fragment at (row j, column c) as TF32 parts
  auto v_frag = [&](int j, int c, uint32_t& hi, uint32_t& lo) {
    if (BF16)
      hi = __float_as_uint(in_at<T, N>(smem, 2, j, c));
    else
      split(smem[SM::V + j * LDB + c], hi, lo);
  };

  // 1e. y = A V: warp w the rows of sub-block w / 2, half w % 2 of the
  // columns (A is zero above the diagonal blocks, so the sum stops there)
  constexpr int YT = NT / 2;                  // 8-wide column tiles a warp
  const int i0 = wblk * SB + g, ct_y = whalf * YT;
  float yacc[YT][4] = {}, ycor[YT][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < 2 * (wblk + 1); ++kk) {
    const int j0 = kk * 8 + t4;
    const FragA a(sA[i0 * LDA + j0], sA[(i0 + 8) * LDA + j0],
                  sA[i0 * LDA + j0 + 4], sA[(i0 + 8) * LDA + j0 + 4]);
    uint32_t hi[YT][2], lo[YT][2];
#pragma unroll
    for (int nt = 0; nt < YT; ++nt) {
      v_frag(j0, (ct_y + nt) * 8 + g, hi[nt][0], lo[nt][0]);
      v_frag(j0 + 4, (ct_y + nt) * 8 + g, hi[nt][1], lo[nt][1]);
    }
    mma3<BF16, YT>(yacc, ycor, a, hi, lo);
  }

  // 1f. the increment (k e^{L_last - L})^T V = (k e^Q e^{G_(J+1) + ..})^T V
  float inc[TPW][4] = {}, icor[TPW][4] = {};
  if (has_tiles) {
    const int n0 = rb * 16 + g;
#pragma unroll
    for (int kk = 0; kk < C / 8; ++kk) {
      const int j0 = kk * 8 + t4, blk = kk / 2;
      const float ea0 = sEA[blk * N + n0], ea1 = sEA[blk * N + n0 + 8];
      const FragA a(sK[j0 * LD + n0] * ea0, sK[j0 * LD + n0 + 8] * ea1,
                    sK[(j0 + 4) * LD + n0] * ea0,
                    sK[(j0 + 4) * LD + n0 + 8] * ea1);
      uint32_t hi[TPW][2], lo[TPW][2];
#pragma unroll
      for (int tt = 0; tt < TPW; ++tt) {
        v_frag(j0, (ct0 + tt) * 8 + g, hi[tt][0], lo[tt][0]);
        v_frag(j0 + 4, (ct0 + tt) * 8 + g, hi[tt][1], lo[tt][1]);
      }
      mma3<BF16, TPW>(inc, icor, a, hi, lo);
    }
  }

  // 2. the chain: S_in from the predecessor, S_out = e^{L_last} S_in +
  // increment to the successor, each thread for its 16 elements of the
  // state (those of its increment tiles) on its own: it polls the tagged
  // words its predecessor's thread wrote and passes its S_out words on at
  // once.  The barrier retires w, A and v before S_in's TF32 parts
  // overwrite them.
  __syncthreads();
  const bool has_state = chunk > 0 || s0;
  const bool last = chunk == nchunks - 1;
  if (has_tiles) {
    float2 sin[TPW][2];
    if (chunk > 0) {
      // the predecessor's tag is (chunk - 1) + 1: one lane a warp polls one
      // word (the predecessor's warp writes its lanes' words together),
      // then every lane takes its sixteen, again until each carries it
      const unsigned long long* src =
          chain + ((long)bh * 2 + ((chunk - 1) & 1)) * nn2;
      if (lane == 0)
        while ((ld_tagged(src + (rb * 16) * N + ct0 * 8) >> 32)
               != (unsigned)chunk) {
        }
      __syncwarp();
      for (;;) {
        ulonglong2 x[TPW][2];
#pragma unroll
        for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            x[tt][half] = ld_tagged2(src + (rb * 16 + g + 8 * half) * N +
                                     (ct0 + tt) * 8 + 2 * t4);
        bool ready = true;
#pragma unroll
        for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            ready &= (x[tt][half].x >> 32) == (unsigned)chunk &&
                     (x[tt][half].y >> 32) == (unsigned)chunk;
            sin[tt][half] = make_float2(__uint_as_float((unsigned)x[tt][half].x),
                                        __uint_as_float((unsigned)x[tt][half].y));
          }
        if (ready) break;
      }
    } else {
#pragma unroll
      for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          sin[tt][half] = s0 ? s_first[tt][half] : make_float2(0.f, 0.f);
    }
    float2 out[TPW][2];
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float d = sD[rb * 16 + g + 8 * half];
        out[tt][half] = make_float2(
            fmaf(d, sin[tt][half].x, inc[tt][2 * half] + icor[tt][2 * half]),
            fmaf(d, sin[tt][half].y,
                 inc[tt][2 * half + 1] + icor[tt][2 * half + 1]));
      }
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long e = (rb * 16 + g + 8 * half) * N + (ct0 + tt) * 8 + 2 * t4;
        if (last)
          *reinterpret_cast<float2*>(s_end + bh * nn2 + e) = out[tt][half];
        else
          st_tagged2(chain + ((long)bh * 2 + (chunk & 1)) * nn2 + e,
                     out[tt][half].x, out[tt][half].y, chunk + 1);
      }
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = (rb * 16 + g + 8 * half) * LDB + (ct0 + tt) * 8 + 2 * t4;
        uint32_t h0, l0, h1, l1;
        split(sin[tt][half].x, h0, l0);
        split(sin[tt][half].y, h1, l1);
        *reinterpret_cast<uint2*>(sShi + e) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(sSlo + e) = make_uint2(l0, l1);
      }
  }
  __syncthreads();

  // 3. y += (r e^E e^{G_0 + .. + G_(I-1)}) S_in, then y out
  if (has_state) {
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
      const int n0 = kk * 8 + t4;
      const float eb0 = sEB[wblk * N + n0], eb1 = sEB[wblk * N + n0 + 4];
      const FragA a(sR[i0 * LD + n0] * eb0, sR[(i0 + 8) * LD + n0] * eb0,
                    sR[i0 * LD + n0 + 4] * eb1,
                    sR[(i0 + 8) * LD + n0 + 4] * eb1);
      uint32_t hi[YT][2], lo[YT][2];
#pragma unroll
      for (int nt = 0; nt < YT; ++nt) {
        const int c = (ct_y + nt) * 8 + g;
        hi[nt][0] = sShi[n0 * LDB + c];
        hi[nt][1] = sShi[(n0 + 4) * LDB + c];
        lo[nt][0] = sSlo[n0 * LDB + c];
        lo[nt][1] = sSlo[(n0 + 4) * LDB + c];
      }
      mma3<false, YT>(yacc, ycor, a, hi, lo);
    }
  }
#pragma unroll
  for (int nt = 0; nt < YT; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + 8 * half;
      if (i < steps)
        store2(y + base + i * tstride + (ct_y + nt) * 8 + 2 * t4,
               yacc[nt][2 * half] + ycor[nt][2 * half],
               yacc[nt][2 * half + 1] + ycor[nt][2 * half + 1]);
    }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_end, void* chain, int B, int Tn, int H,
                   cudaStream_t stream) {
  const int nchunks = (Tn + C - 1) / C;
  const long ctas = (long)B * H * nchunks;
  if (ctas > INT_MAX || (nchunks > 1 && !chain))
    return cudaErrorInvalidValue;
  const size_t bytes = Smem<T, N>::FLOATS * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunk_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  wkv6_chunk_kernel<T, N><<<(unsigned)ctas, THREADS, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_end),
      static_cast<unsigned long long*>(chain), Tn, H, B * H, nchunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int n, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* y,
                     void* s_end, void* chain, int B, int Tn, int H,
                     cudaStream_t st) {
  switch (n) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, y, s_end, chain, B, Tn, H,
                           st);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, s_end, chain, B, Tn, H,
                           st);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, s_end, chain, B, Tn, H,
                           st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of r, k, v and y: 0 = float32, 1 = bfloat16.  n: head size, 16, 32
// or 64.  r, k, v, y [B, T, H, n] and w [B, T, H, n] fp32, u [H, n] fp32,
// s0 (or null = zeros) and s_end [B, H, n, n] fp32; all contiguous and
// 16-byte aligned.  When T > 64: chain, 2 B H n n + 1 64-bit words set to
// 0 (two tagged states a head, then the chunk counter).  Returns
// cudaGetLastError() after the launch (0 = ok).
int wkv6_fwd(int dtype, int n, const void* r, const void* k, const void* v,
             const void* w, const void* u, const void* s0, void* y,
             void* s_end, void* chain, int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (long)B * H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_n<float>(n, r, k, v, w, u, s0, y, s_end, chain, B, T,
                                H, st);
  if (dtype == 1)
    return (int)launch_n<__nv_bfloat16>(n, r, k, v, w, u, s0, y, s_end,
                                        chain, B, T, H, st);
  return (int)cudaErrorInvalidValue;
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
