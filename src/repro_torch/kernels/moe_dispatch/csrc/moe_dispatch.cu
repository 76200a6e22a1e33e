// MoE route, dispatch, gather and combine for NVIDIA Hopper (sm_90a), plain
// C interface.
//
// Replaces no TPU kernel: the JAX package leaves these steps of
// src/repro/models/moe.py::moe_fwd to XLA, which fuses them.  In eager
// PyTorch the same steps (core/device/moe_balance.py: route_topk,
// priority_dispatch, gather_expert_inputs, combine_expert_outputs, and the
// aux loss's sums) are ~134 calls a MoE layer, ~110 of them kernels of a
// few microseconds each, so the host issuing them paced the decode.  Here
// they are at most five launches a layer call, each computing what the
// plain functions compute:
//
//   route    (moe_route_kernel, one warp a token): softmax over E, a stable
//            top-k (ties to the lower expert), the top-k renormalised
//            (Mixtral's rule) or kept as the softmax gave them (Jamba's;
//            a flag uniform over the launch), and the (k+1)-th choice that
//            restealing offers.  The softmax is
//            laid out as PyTorch's warp softmax lays it out (expert
//            e = i * 32 + lane, each lane's partial sum in i order, then an
//            xor butterfly), so that it gives its bits.
//   rank     (moe_rank_kernel, one CTA an expert, once or twice): the CTA
//            collects the assignments routed to its expert in index order
//            (a ballot and a warp scan a chunk), ranks them by (priority
//            descending, index ascending), which is the stable lexsort of
//            _dispatch_once, and writes the plan: slot_src's row, load,
//            kept, expert, gate, each assignment's slot.  With restealing
//            a second launch ranks the second pass (kept assignments at
//            +inf, dropped ones at their next choice); where capacity >= T
//            the first pass keeps everything (a token's choices are
//            distinct experts), so the second pass only orders each
//            expert's assignments by index, and one launch does that.
//   gather   (moe_gather_kernel, one CTA a slot row): the [E, C, D] buffer
//            from slot_src, zeros in empty slots; its last CTA adds the
//            per-expert partial sums into dropped_mass and the aux loss.
//   combine  (moe_combine_kernel, one CTA a token and 16-byte column
//            stripe): y[slot] * gate over the token's kept slots in
//            ascending slot order, added from +0 one choice at a time with
//            __fmul_rn / __fadd_rn (no contraction into an FMA), cast once.
//
// Every sum is taken in a fixed order (no float atomics): two calls give the
// same bits.
//
// What bounds it on an H100.  Route, rank and the finalising sums touch
// kilobytes and are bound by latency: a few microseconds each.  Ranking is
// O(n^2 / threads) in an expert's n assignments (n <= T; 512 at Mixtral's
// chunk, ~21 at Kimi's 8192 assignments over 384 experts).  Gather and
// combine move bytes: E * C * D elements written and the kept rows read,
// and T * k * D read with T * D written (Mixtral decode: 0.4 and 0.8 MB,
// ~0.1 and ~0.3 us at 3.35 TB/s, so latency again; a 512-token chunk at
// dropless capacity writes 50 MB of buffer, ~15 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRouteWarps = 8;      // tokens a route CTA
constexpr int kRankThreads = 512;
constexpr int kGatherThreads = 256;
constexpr int kCombineThreads = 128;
constexpr int kMaxK = 16;

// ------------------------------------------------------------------ route

// Lane `lane` holds experts e = i * 32 + lane, i < V (V * 32 >= E).
template <int V>
__global__ void __launch_bounds__(kRouteWarps * 32)
    moe_route_kernel(const float* __restrict__ logits, float* __restrict__ probs,
                     int* __restrict__ expert, float* __restrict__ gate,
                     int* __restrict__ alt_e, float* __restrict__ alt_p, int T,
                     int E, int k, int renorm) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kRouteWarps + (threadIdx.x >> 5);
  if (t >= T) return;                        // a whole warp leaves together
  const float* row = logits + (long long)t * E;
  float p[V];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = i * 32 + lane;
    p[i] = e < E ? row[e] : -INFINITY;
    mx = mx > p[i] ? mx : p[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float b = __shfl_xor_sync(kFull, mx, o);
    mx = mx > b ? mx : b;
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    p[i] = expf(p[i] - mx);                  // exp(-inf) = 0 past E
    sum += p[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  float* prow = probs + (long long)t * E;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = i * 32 + lane;
    p[i] = p[i] / sum;
    if (e < E) prow[e] = p[i];
    else p[i] = -1.f;                        // below every probability
  }
  // k + 1 rounds of a warp argmax: (value desc, expert asc), the order of a
  // stable descending sort; a chosen expert is marked -1
  float g[kMaxK];
  const int rounds = alt_e != nullptr ? k + 1 : k;
  float gsum = 0.f;
  for (int r = 0; r < rounds; ++r) {
    float bv = -2.f;
    int be = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (p[i] > bv) { bv = p[i]; be = i * 32 + lane; }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oe = __shfl_xor_sync(kFull, be, o);
      if (ov > bv || (ov == bv && oe < be)) { bv = ov; be = oe; }
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i * 32 + lane == be) p[i] = -1.f;
    if (r < k) {
      g[r] = bv;
      gsum += bv;
      if (lane == 0) expert[(long long)t * k + r] = be;
    } else if (lane == 0) {
      // no (k+1)-th choice when k == E: the plain argmax of an all -inf
      // row, expert 0 at -inf
      const bool none = bv < 0.f;
      alt_e[t] = none ? 0 : be;
      alt_p[t] = none ? -INFINITY : bv;
    }
  }
  if (lane == 0) {
    if (renorm) {
      // the plain path: gate / clamp(gate.sum(-1), min=1e-9), summed in
      // order
      const float s = fmaxf(gsum, 1e-9f);
      for (int r = 0; r < k; ++r) gate[(long long)t * k + r] = g[r] / s;
    } else {
      for (int r = 0; r < k; ++r) gate[(long long)t * k + r] = g[r];
    }
  }
}

// ------------------------------------------------------------------- rank

// What one rank launch reads and writes.  mode: 0 ranks by the policy's
// priority (the first pass), 1 ranks the resteal pass (kept assignments at
// +inf, dropped ones at their next choice), 2 orders by index alone (the
// resteal pass after a first pass that kept everything).
struct RankArgs {
  const int* expert;          // [A] routed expert
  const float* gate;          // [A] routed gate
  const float* probs;         // [T, E]: column sums for the aux loss, or null
  const int* alt_e;           // [T] next choice (mode 1)
  const float* alt_p;         // [T]
  const uint8_t* keep1;       // [A] the first pass's keep (mode 1)
  uint8_t* keep_first;        // [A] out: keep, where a second pass follows
  uint8_t* kept;              // [A] out (final pass), and the rest below
  int* expert_out;            // [A]
  float* gate_out;            // [A]
  int* slot;                  // [A] e * C + rank, or -1
  int* slot_src;              // [E, C]
  int* load;                  // [E]
  float* drop_part;           // [E] dropped gate mass by expert
  float* colsum;              // [E] sum over tokens of probs (or null)
  float* list_keys;           // [E, cap] global list, or null: shared
  int* list_idx;              // [E, cap]
  int T, k, E, C, cap, mode, arrival;
};

// Block sum in a fixed order: a warp butterfly, then warp 0 over the warps.
template <int THREADS>
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                           // red free from an earlier use
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;                                  // valid in thread 0
}

__global__ void __launch_bounds__(kRankThreads)
    moe_rank_kernel(RankArgs a) {
  extern __shared__ float smem_list[];
  __shared__ int warp_n[kRankThreads / 32];
  __shared__ float red[kRankThreads / 32];
  const int e = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int A = a.T * a.k;
  float* keys = a.list_keys ? a.list_keys + (long long)e * a.cap : smem_list;
  int* idx = a.list_keys ? a.list_idx + (long long)e * a.cap
                         : reinterpret_cast<int*>(smem_list + a.cap);

  // collect this expert's assignments in index order
  int n = 0;
  for (int base = 0; base < A; base += kRankThreads) {
    const int i = base + tid;
    bool mine = false;
    float key = 0.f;
    if (i < A) {
      int ei = a.expert[i];
      if (a.mode == 1) {
        const bool k1 = a.keep1[i] != 0;
        const int t = i / a.k;
        if (!k1) ei = a.alt_e[t];
        key = k1 ? INFINITY : (a.arrival ? -(float)i : a.alt_p[t]);
      } else if (a.mode == 0) {
        key = a.arrival ? -(float)i : a.gate[i];
      }
      mine = ei == e;
    }
    const unsigned ballot = __ballot_sync(kFull, mine);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int off = n, total = 0;
#pragma unroll
    for (int w = 0; w < kRankThreads / 32; ++w) {
      const int c = warp_n[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (mine) {
      const int pos = off + __popc(ballot & ((1u << lane) - 1u));
      if (pos < a.cap) { keys[pos] = key; idx[pos] = i; }
    }
    n += total;
    __syncthreads();                         // warp_n is written again
  }
  n = min(n, a.cap);    // never cut: cap bounds the list
  const bool final_pass = a.keep_first == nullptr;
  // the order is the index order where every key ties or follows it
  const bool by_index = a.mode == 2 || (a.mode == 0 && a.arrival);
  float dropped = 0.f;
  for (int i = tid; i < n; i += kRankThreads) {
    int r = i;
    if (!by_index) {
      const float ki = keys[i];
      r = 0;
      for (int j = 0; j < n; ++j) {
        const float kj = keys[j];
        r += (kj > ki) || (kj == ki && j < i);
      }
    }
    const int ai = idx[i];
    const bool keep = r < a.C;
    if (!final_pass) {
      a.keep_first[ai] = keep;
      continue;
    }
    const float g1 = a.gate[ai];
    // restolen (mode 1, dropped by the first pass, kept now): the next
    // choice's probability; never renormalised, as in the plain path
    const float g = (a.mode == 1 && !a.keep1[ai]) ? a.alt_p[ai / a.k] : g1;
    a.kept[ai] = keep;
    a.expert_out[ai] = keep ? e : a.expert[ai];
    a.gate_out[ai] = keep ? g : 0.f;
    a.slot[ai] = keep ? e * a.C + r : -1;
    if (keep) a.slot_src[(long long)e * a.C + r] = ai;
    else dropped += g1;
  }
  if (final_pass) {
    const int ld = min(n, a.C);
    for (int c = ld + tid; c < a.C; c += kRankThreads)
      a.slot_src[(long long)e * a.C + c] = -1;
    const float d = block_sum<kRankThreads>(dropped, red);
    if (tid == 0) {
      a.load[e] = ld;
      a.drop_part[e] = d;
    }
  }
  if (a.colsum != nullptr) {
    float s = 0.f;
    for (int t = tid; t < a.T; t += kRankThreads)
      s += a.probs[(long long)t * a.E + e];
    s = block_sum<kRankThreads>(s, red);
    if (tid == 0) a.colsum[e] = s;
  }
}

// ----------------------------------------------------------------- gather

// dropped_mass = sum of drop_part; aux = E * sum_e (colsum_e / T)
// * (load_e / max(sum load, 1)), each in expert order by a fixed tree.
__device__ void finalize(const float* drop_part, const float* colsum,
                         const int* load, float* dropped_mass, float* aux,
                         int E, int T) {
  __shared__ float red[kGatherThreads / 32];
  __shared__ int total_s;
  float ls = 0.f;
  for (int e = threadIdx.x; e < E; e += kGatherThreads) ls += (float)load[e];
  // loads are integers far below 2^24: every order gives the same sum
  ls = block_sum<kGatherThreads>(ls, red);
  if (threadIdx.x == 0) total_s = (int)ls;
  __syncthreads();
  const float denom = (float)max(total_s, 1);
  const float inv_t = 1.f / (float)T;
  float d = 0.f, x = 0.f;
  for (int e = threadIdx.x; e < E; e += kGatherThreads) {
    d += drop_part[e];
    x += (colsum[e] * inv_t) * ((float)load[e] / denom);
  }
  d = block_sum<kGatherThreads>(d, red);
  x = block_sum<kGatherThreads>(x, red);
  if (threadIdx.x == 0) {
    *dropped_mass = d;
    *aux = (float)E * x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
    moe_gather_kernel(const T* __restrict__ x, const int* __restrict__ slot_src,
                      T* __restrict__ buf, long long rows, int D, int k,
                      const float* drop_part, const float* colsum,
                      const int* load, float* dropped_mass, float* aux, int E,
                      int ntok) {
  const long long row = blockIdx.x;
  if (row == rows) {
    finalize(drop_part, colsum, load, dropped_mass, aux, E, ntok);
    return;
  }
  const int vecs = D * (int)sizeof(T) / 16;
  uint4* out = reinterpret_cast<uint4*>(buf + row * D);
  const int src = slot_src[row];
  if (src < 0) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int v = threadIdx.x; v < vecs; v += kGatherThreads) out[v] = z;
  } else {
    const uint4* in =
        reinterpret_cast<const uint4*>(x + (long long)(src / k) * D);
    for (int v = threadIdx.x; v < vecs; v += kGatherThreads) out[v] = in[v];
  }
}

// ---------------------------------------------------------------- combine

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) f[q] = __bfloat162float(h[q]);
}
__device__ __forceinline__ uint4 pack(const float (&f)[4], float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], bf16) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = __float2bfloat16_rn(f[q]);
  return u;
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ slot,
                       const float* __restrict__ gate, T* __restrict__ out,
                       int D, int k) {
  constexpr int N = 16 / sizeof(T);
  const long long t = blockIdx.x;
  const int v = blockIdx.y * kCombineThreads + threadIdx.x;
  if (v * N >= D) return;
  // the token's kept slots, ascending (insertion sort of at most k)
  int s[kMaxK];
  float w[kMaxK];
  int n = 0;
  for (int j = 0; j < k; ++j) {
    const int sj = slot[t * k + j];
    if (sj < 0) continue;
    const float wj = gate[t * k + j];
    int p = n++;
    while (p > 0 && s[p - 1] > sj) {
      s[p] = s[p - 1];
      w[p] = w[p - 1];
      --p;
    }
    s[p] = sj;
    w[p] = wj;
  }
  float acc[N];
#pragma unroll
  for (int q = 0; q < N; ++q) acc[q] = 0.f;
  for (int j = 0; j < n; ++j) {
    const uint4 raw =
        reinterpret_cast<const uint4*>(y + (long long)s[j] * D)[v];
    float f[N];
    unpack(raw, f);
#pragma unroll
    for (int q = 0; q < N; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(f[q], w[j]));
  }
  reinterpret_cast<uint4*>(out + t * D)[v] = pack(acc, T());
}

// --------------------------------------------------------------- launches

template <int V>
cudaError_t launch_route(const float* logits, float* probs, int* expert,
                         float* gate, int* alt_e, float* alt_p, int T, int E,
                         int k, int renorm, cudaStream_t st) {
  const int grid = (T + kRouteWarps - 1) / kRouteWarps;
  moe_route_kernel<V><<<grid, kRouteWarps * 32, 0, st>>>(
      logits, probs, expert, gate, alt_e, alt_p, T, E, k, renorm);
  return cudaGetLastError();
}

cudaError_t launch_rank(RankArgs a, cudaStream_t st) {
  size_t smem = 0;
  if (a.list_keys == nullptr) {
    smem = (size_t)a.cap * (sizeof(float) + sizeof(int));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          moe_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
    }
  }
  moe_rank_kernel<<<a.E, kRankThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gather(const void* x, const int* slot_src, void* buf,
                          int E, int C, int D, int k, const float* drop_part,
                          const float* colsum, const int* load,
                          float* dropped_mass, float* aux, int ntok,
                          cudaStream_t st) {
  const long long rows = (long long)E * C;
  moe_gather_kernel<T><<<(unsigned)(rows + 1), kGatherThreads, 0, st>>>(
      static_cast<const T*>(x), slot_src, static_cast<T*>(buf), rows, D, k,
      drop_part, colsum, load, dropped_mass, aux, E, ntok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(const void* y, const int* slot, const float* gate,
                           void* out, int T_, int D, int k, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const int vecs = D / N;
  const dim3 grid(T_, (vecs + kCombineThreads - 1) / kCombineThreads);
  moe_combine_kernel<T><<<grid, kCombineThreads, 0, st>>>(
      static_cast<const T*>(y), slot, gate, static_cast<T*>(out), D, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logits [T, E] fp32 -> probs [T, E] fp32, expert [T, k] int32, gate
// [T, k] fp32 (renormalised over the k where renorm is non-zero, else the
// probabilities themselves), and, when alt_e is not null, the (k+1)-th
// choice alt_e [T] int32 and its probability alt_p [T].  E <= 1024,
// 1 <= k <= min(E, 16).  Returns cudaGetLastError() (0 = ok).
int moe_route_fwd(const void* logits, void* probs, void* expert, void* gate,
                  void* alt_e, void* alt_p, int T, int E, int k, int renorm,
                  void* stream) {
  if (T <= 0 || E <= 0 || E > 1024 || k <= 0 || k > kMaxK || k > E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(logits);
  float* p = static_cast<float*>(probs);
  int* ex = static_cast<int*>(expert);
  float* g = static_cast<float*>(gate);
  int* ae = static_cast<int*>(alt_e);
  float* ap = static_cast<float*>(alt_p);
  const int v = (E + 31) / 32;
  if (v <= 1) return (int)launch_route<1>(l, p, ex, g, ae, ap, T, E, k,
                                           renorm, st);
  if (v <= 2) return (int)launch_route<2>(l, p, ex, g, ae, ap, T, E, k,
                                           renorm, st);
  if (v <= 4) return (int)launch_route<4>(l, p, ex, g, ae, ap, T, E, k,
                                           renorm, st);
  if (v <= 8) return (int)launch_route<8>(l, p, ex, g, ae, ap, T, E, k,
                                           renorm, st);
  if (v <= 12) return (int)launch_route<12>(l, p, ex, g, ae, ap, T, E, k,
                                            renorm, st);
  if (v <= 16) return (int)launch_route<16>(l, p, ex, g, ae, ap, T, E, k,
                                            renorm, st);
  return (int)launch_route<32>(l, p, ex, g, ae, ap, T, E, k, renorm, st);
}

// The plan, the expert buffer and the stats of T tokens x k choices over E
// experts of capacity C, from moe_route_fwd's outputs (alt_e, alt_p: only
// with resteal).  dtype: 0 = float32, 1 = bfloat16 (x [T, D] and buf
// [E, C, D], contiguous, 16-byte aligned, D a multiple of 16 bytes' worth).
// Outputs: kept [A] uint8, expert_out [A] int32, gate_out [A] fp32, slot
// [A] int32, slot_src [E, C] int32, load [E] int32, stats [2E + 2] fp32
// (drop_part [E], colsum [E], dropped_mass, aux).  keep_scratch: [A] uint8
// when resteal and C < T, else null.  list_scratch: null (lists in shared
// memory, cap * 8 bytes a CTA) or [2 * E * cap] 4-byte words; cap bounds
// an expert's list: T, or T * k where a resteal pass follows a first pass
// that may drop (ops.py::rank_list).  arrival: 1 = policy "arrival", 0 =
// "priority".  Returns cudaGetLastError() after the launches (0 = ok).
int moe_dispatch_fwd(int dtype, const void* x, const void* expert,
                     const void* gate, const void* probs, const void* alt_e,
                     const void* alt_p, void* keep_scratch, void* kept,
                     void* expert_out, void* gate_out, void* slot,
                     void* slot_src, void* load, void* stats,
                     void* list_scratch, void* buf, int T, int k, int E,
                     int C, int D, int cap, int arrival, int resteal,
                     void* stream) {
  if (T <= 0 || k <= 0 || E <= 0 || C <= 0 || D <= 0 || cap <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* st_f = static_cast<float*>(stats);
  RankArgs a{};
  a.expert = static_cast<const int*>(expert);
  a.gate = static_cast<const float*>(gate);
  a.probs = static_cast<const float*>(probs);
  a.alt_e = static_cast<const int*>(alt_e);
  a.alt_p = static_cast<const float*>(alt_p);
  a.kept = static_cast<uint8_t*>(kept);
  a.expert_out = static_cast<int*>(expert_out);
  a.gate_out = static_cast<float*>(gate_out);
  a.slot = static_cast<int*>(slot);
  a.slot_src = static_cast<int*>(slot_src);
  a.load = static_cast<int*>(load);
  a.drop_part = st_f;
  a.colsum = st_f + E;
  if (list_scratch != nullptr) {
    a.list_keys = static_cast<float*>(list_scratch);
    a.list_idx = static_cast<int*>(list_scratch) + (long long)E * cap;
  }
  a.T = T;
  a.k = k;
  a.E = E;
  a.C = C;
  a.cap = cap;
  a.arrival = arrival;
  cudaError_t err;
  if (!resteal) {
    a.mode = 0;
    err = launch_rank(a, st);
  } else if (C >= T) {
    a.mode = 2;
    err = launch_rank(a, st);
  } else {
    if (keep_scratch == nullptr || alt_e == nullptr || alt_p == nullptr)
      return (int)cudaErrorInvalidValue;
    RankArgs first = a;
    first.mode = 0;
    first.keep_first = static_cast<uint8_t*>(keep_scratch);
    err = launch_rank(first, st);
    if (err != cudaSuccess) return (int)err;
    a.mode = 1;
    a.keep1 = static_cast<const uint8_t*>(keep_scratch);
    a.colsum = nullptr;                      // taken by the first pass
    err = launch_rank(a, st);
  }
  if (err != cudaSuccess) return (int)err;
  const int* ld = static_cast<const int*>(load);
  if (dtype == 0)
    return (int)launch_gather<float>(x, a.slot_src, buf, E, C, D, k, st_f,
                                     st_f + E, ld, st_f + 2 * E,
                                     st_f + 2 * E + 1, T, st);
  if (dtype == 1)
    return (int)launch_gather<bf16>(x, a.slot_src, buf, E, C, D, k, st_f,
                                    st_f + E, ld, st_f + 2 * E,
                                    st_f + 2 * E + 1, T, st);
  return (int)cudaErrorInvalidValue;
}

// y [E, C, D] (dtype as above) -> out [T, D]: sum over each token's kept
// choices, in ascending slot order, of y[slot] * gate.  slot, gate: [T, k]
// from moe_dispatch_fwd.
int moe_combine_fwd(int dtype, const void* y, const void* slot,
                    const void* gate, void* out, int T, int D, int k,
                    void* stream) {
  if (T <= 0 || D <= 0 || k <= 0 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(slot);
  const float* g = static_cast<const float*>(gate);
  if (dtype == 0) return (int)launch_combine<float>(y, s, g, out, T, D, k, st);
  if (dtype == 1) return (int)launch_combine<bf16>(y, s, g, out, T, D, k, st);
  return (int)cudaErrorInvalidValue;
}

const char* moe_dispatch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
