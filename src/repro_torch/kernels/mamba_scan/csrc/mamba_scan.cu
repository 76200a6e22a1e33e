// The Mamba (S6) mixer's conv and selective scan for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package runs src/repro/models/ssm.py's
// mixer (mamba_fwd, mamba_decode) as XLA ops, which fuses them.  In eager
// PyTorch the same chain between in_proj and out_proj was ~53 calls a
// decode layer and ~126 a 512-token chunk layer (ref.py keeps it), each a
// kernel of a few microseconds, so the host issuing them paced the
// hybrid's steps, and the chunked scan wrote fp32 [T, d_inner, d_state]
// tensors (268 MB a 512-token layer at Jamba's widths) several times.
// Here the chain is two launches around the two projections that stay
// GEMMs (x_proj, and dt_proj after the Δ norm):
//
//   conv  (mamba_conv_kernel, a thread a channel and 32 steps): the
//         depthwise causal conv over [conv_state, x] with its window in
//         registers, summed in fp32, plus the bias, rounded to the model
//         dtype, SiLU, rounded again (where the plain path hands a tensor
//         on); the CTAs of the first steps also write the next conv state,
//         the last d_conv - 1 rows of [conv_state, x].
//   scan  (mamba_scan_kernel, a CTA 128 threads: a channel's d_state
//         states over d_state / 4 threads, 4 each; a CTA a batch row and
//         128 / (d_state / 4) channels): per tile of 32 steps it stages in
//         shared memory softplus(Δ), Δ x, x and silu(z) (rounded to the
//         model dtype) of its channels, and B and C of each step (32
//         numbers shared by every channel) through the inner RMSNorms
//         where the layer has them (a flag uniform over the launch:
//         b_norm != null), rounded to the model dtype where
//         models/layers.py::rms_norm rounds; then walks the steps with h in
//         registers: decay = exp(Δ A), A = -exp(a_log), h = decay h + Δ x
//         B, y = C·h (the state lanes summed with shuffles) + D x, rounded,
//         times the gate, rounded.  h0 is read once and h_end written
//         once; nothing [T, d_inner, d_state]-sized touches device memory.
//         Decode (T = 1, B rows) and a prefill chunk (B = 1, T steps) take
//         the same kernel.
//
// Δ, the decays and h are fp32 throughout; exp is expf (not __expf), so
// the kernels differ from the plain path by fp32 rounding (an FMA here,
// another summation order there) and, in bf16, by the conv's sum, which
// the plain prefill rounds to bf16 after every product and add.
//
// What bounds it on an H100.  A 512-token chunk of Jamba (d_inner 8192,
// d_state 16) moves ~33 MB (x, Δ, z in and y out, bf16): ~10 us at
// 3.35 TB/s; its 67 M decays are an exp each, ~18 us on the SFUs, so the
// scan is bound by its exps at ~20 us.  A decode step at B = 32 reads and
// writes h, 2 x 16.8 MB: ~10 us.  At B = 1 the scan has 256 CTAs of 128
// threads (~8 warps an SM), and each warp walks the steps in order, so
// latency, not bandwidth, is what the chunk kernel fights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kConvThreads = 128;
constexpr int kConvSteps = 32;      // time steps a conv CTA
constexpr int kScanThreads = 128;
constexpr int kStates = 4;          // states a scan thread
constexpr int kScanSteps = 32;      // time steps staged at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the model dtype and widened again: where the plain path
// hands a tensor of that dtype on
template <typename E>
__device__ __forceinline__ float rounded(float v) {
  return to_f(from_f<E>(v));
}

// PyTorch's CUDA SiLU and softplus (beta 1, threshold 20), in fp32
__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}
__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

// ------------------------------------------------------------------- conv

// x: rows r = b * T + t, x_row elements apart, channels contiguous;
// state [B, DC-1, D]; w [DC, D]; bias [D] -> xc [B, T, D], state_out
// [B, DC-1, D].  Grid (ceil(D / 128), B * tiles), tiles of kConvSteps.
template <typename E, int DC>
__global__ void __launch_bounds__(kConvThreads)
    mamba_conv_kernel(const E* __restrict__ x, long long x_row,
                      const E* __restrict__ state, const E* __restrict__ w,
                      const E* __restrict__ bias, E* __restrict__ xc,
                      E* __restrict__ state_out, int T, int D, int tiles) {
  const int d = blockIdx.x * kConvThreads + threadIdx.x;
  if (d >= D) return;
  const int b = blockIdx.y / tiles;
  const int t0 = (blockIdx.y % tiles) * kConvSteps;
  const int t1 = min(t0 + kConvSteps, T);
  const E* xb = x + (long long)b * T * x_row + d;
  const E* sb = state + (long long)b * (DC - 1) * D + d;
  // [state, x] at position p (p < DC-1 in the state): x step p - (DC-1)
  auto padded = [&](int t) -> float {
    return t >= 0 ? to_f(xb[(long long)t * x_row])
                  : to_f(sb[(long long)(t + DC - 1) * D]);
  };
  float wv[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) wv[i] = to_f(w[(long long)i * D + d]);
  const float bv = to_f(bias[d]);
  // win[i] holds step t - (DC-1) + i while step t is computed
  float win[DC];
#pragma unroll
  for (int i = 0; i < DC - 1; ++i) win[i] = padded(t0 - (DC - 1) + i);
  E* out = xc + ((long long)b * T) * D + d;
  for (int t = t0; t < t1; ++t) {
    win[DC - 1] = to_f(xb[(long long)t * x_row]);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < DC; ++i) acc = fmaf(win[i], wv[i], acc);
    out[(long long)t * D] = from_f<E>(silu(rounded<E>(acc + bv)));
#pragma unroll
    for (int i = 0; i < DC - 1; ++i) win[i] = win[i + 1];
  }
  if (t0 == 0) {
    // the next state: the last DC-1 rows of [state, x]
    E* so = state_out + (long long)b * (DC - 1) * D + d;
#pragma unroll
    for (int j = 0; j < DC - 1; ++j)
      so[(long long)j * D] = from_f<E>(padded(T - (DC - 1) + j));
  }
}

// ------------------------------------------------------------------- scan

// xc [B, T, D] contiguous; dt, z: rows r = b * T + t, dt_row / z_row
// apart; bc: rows bc_row apart, B in columns [0, DS), C in [DS, 2 DS);
// a_log [D, DS], d_skip [D] and h0 [B, D, DS] fp32; b_norm, c_norm [DS] or
// both null -> y [B, T, D], h_end [B, D, DS].  Grid (ceil(D / kChannels),
// B).
template <typename E, int DS>
__global__ void __launch_bounds__(kScanThreads)
    mamba_scan_kernel(const E* __restrict__ xc, const E* __restrict__ dt,
                      long long dt_row, const E* __restrict__ bc,
                      long long bc_row, const E* __restrict__ z,
                      long long z_row, const float* __restrict__ a_log,
                      const float* __restrict__ d_skip,
                      const float* __restrict__ h0,
                      const E* __restrict__ b_norm,
                      const E* __restrict__ c_norm, float eps,
                      E* __restrict__ y, float* __restrict__ h_end, int T,
                      int D) {
  constexpr int kLanes = DS / kStates;              // threads a channel
  constexpr int kChannels = kScanThreads / kLanes;  // channels a CTA
  static_assert(DS % kStates == 0 && 32 % kLanes == 0, "d_state");
  __shared__ float s_dt[kScanSteps][kChannels];     // softplus(Δ)
  __shared__ float s_dtx[kScanSteps][kChannels];    // Δ x
  __shared__ float s_xy[kScanSteps][kChannels];     // x, then y
  __shared__ float s_gate[kScanSteps][kChannels];   // silu(z), rounded
  __shared__ float s_b[kScanSteps][DS];
  __shared__ float s_c[kScanSteps][DS];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int c = tid / kLanes;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const bool live = d < D;
  const long long row0 = (long long)blockIdx.y * T;

  float a[kStates], h[kStates];
  const long long hd = ((long long)blockIdx.y * D + d) * DS + lane * kStates;
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    a[s] = live ? -expf(a_log[(long long)d * DS + lane * kStates + s]) : 0.f;
    h[s] = live ? h0[hd + s] : 0.0f;
  }
  const float dskip = live ? d_skip[d] : 0.0f;

  for (int t0 = 0; t0 < T; t0 += kScanSteps) {
    const int n = min(kScanSteps, T - t0);
    for (int i = tid; i < n * kChannels; i += kScanThreads) {
      const int tt = i / kChannels, cc = i % kChannels, dd = d0 + cc;
      float sp = 0.0f, xv = 0.0f, g = 0.0f;
      if (dd < D) {
        const long long r = row0 + t0 + tt;
        xv = to_f(xc[r * D + dd]);
        sp = softplus(to_f(dt[r * dt_row + dd]));
        g = rounded<E>(silu(to_f(z[r * z_row + dd])));
      }
      s_dt[tt][cc] = sp;
      s_dtx[tt][cc] = sp * xv;
      s_xy[tt][cc] = xv;
      s_gate[tt][cc] = g;
    }
    for (int i = tid; i < 2 * n; i += kScanThreads) {
      const int tt = i >> 1, part = i & 1;
      const E* src = bc + (row0 + t0 + tt) * bc_row + part * DS;
      float* dst = part ? s_c[tt] : s_b[tt];
      float v[DS];
      float ss = 0.0f;
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        v[k] = to_f(src[k]);
        ss = fmaf(v[k], v[k], ss);
      }
      if (b_norm == nullptr) {
#pragma unroll
        for (int k = 0; k < DS; ++k) dst[k] = v[k];
      } else {
        // rms_norm: (x * rsqrt(mean(x^2) + eps)) in the model dtype, times
        // the scale in the model dtype
        const E* scale = part ? c_norm : b_norm;
        const float r = rsqrtf(ss / DS + eps);
#pragma unroll
        for (int k = 0; k < DS; ++k)
          dst[k] = rounded<E>(rounded<E>(v[k] * r) * to_f(scale[k]));
      }
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float sp = s_dt[tt][c], dx = s_dtx[tt][c];
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kStates; ++s) {
        const int k = lane * kStates + s;
        h[s] = fmaf(expf(sp * a[s]), h[s], dx * s_b[tt][k]);
        acc = fmaf(h[s], s_c[tt][k], acc);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFull, acc, o);
      if (lane == 0) {
        const float yv = rounded<E>(fmaf(s_xy[tt][c], dskip, acc));
        s_xy[tt][c] = rounded<E>(yv * s_gate[tt][c]);
      }
    }
    __syncthreads();
    for (int i = tid; i < n * kChannels; i += kScanThreads) {
      const int tt = i / kChannels, cc = i % kChannels, dd = d0 + cc;
      if (dd < D) y[(row0 + t0 + tt) * D + dd] = from_f<E>(s_xy[tt][cc]);
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kStates; ++s) h_end[hd + s] = h[s];
  }
}

template <typename E, int DC>
cudaError_t launch_conv(const void* x, long long x_row, const void* state,
                        const void* w, const void* bias, void* xc,
                        void* state_out, int B, int T, int D,
                        cudaStream_t stream) {
  const int tiles = (T + kConvSteps - 1) / kConvSteps;
  dim3 grid((D + kConvThreads - 1) / kConvThreads, B * tiles);
  mamba_conv_kernel<E, DC><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const E*>(x), x_row, static_cast<const E*>(state),
      static_cast<const E*>(w), static_cast<const E*>(bias),
      static_cast<E*>(xc), static_cast<E*>(state_out), T, D, tiles);
  return cudaGetLastError();
}

template <typename E>
cudaError_t conv_by_width(int d_conv, const void* x, long long x_row,
                          const void* state, const void* w, const void* bias,
                          void* xc, void* state_out, int B, int T, int D,
                          cudaStream_t stream) {
  switch (d_conv) {
    case 1:
      return launch_conv<E, 1>(x, x_row, state, w, bias, xc, state_out, B,
                               T, D, stream);
    case 2:
      return launch_conv<E, 2>(x, x_row, state, w, bias, xc, state_out, B,
                               T, D, stream);
    case 3:
      return launch_conv<E, 3>(x, x_row, state, w, bias, xc, state_out, B,
                               T, D, stream);
    case 4:
      return launch_conv<E, 4>(x, x_row, state, w, bias, xc, state_out, B,
                               T, D, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename E, int DS>
cudaError_t launch_scan(const void* xc, const void* dt, long long dt_row,
                        const void* bc, long long bc_row, const void* z,
                        long long z_row, const void* a_log,
                        const void* d_skip, const void* h0,
                        const void* b_norm, const void* c_norm, float eps,
                        void* y, void* h_end, int B, int T, int D,
                        cudaStream_t stream) {
  constexpr int kChannels = kScanThreads / (DS / kStates);
  dim3 grid((D + kChannels - 1) / kChannels, B);
  mamba_scan_kernel<E, DS><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const E*>(xc), static_cast<const E*>(dt), dt_row,
      static_cast<const E*>(bc), bc_row, static_cast<const E*>(z), z_row,
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<const E*>(b_norm),
      static_cast<const E*>(c_norm), eps, static_cast<E*>(y),
      static_cast<float*>(h_end), T, D);
  return cudaGetLastError();
}

template <typename E>
cudaError_t scan_by_state(int d_state, const void* xc, const void* dt,
                          long long dt_row, const void* bc, long long bc_row,
                          const void* z, long long z_row, const void* a_log,
                          const void* d_skip, const void* h0,
                          const void* b_norm, const void* c_norm, float eps,
                          void* y, void* h_end, int B, int T, int D,
                          cudaStream_t stream) {
  switch (d_state) {
    case 8:
      return launch_scan<E, 8>(xc, dt, dt_row, bc, bc_row, z, z_row, a_log,
                               d_skip, h0, b_norm, c_norm, eps, y, h_end, B,
                               T, D, stream);
    case 16:
      return launch_scan<E, 16>(xc, dt, dt_row, bc, bc_row, z, z_row, a_log,
                                d_skip, h0, b_norm, c_norm, eps, y, h_end, B,
                                T, D, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16.  x: B * T rows of D channels, x_row elements
// apart (in_proj's first half, read in place); state [B, d_conv-1, D];
// w [d_conv, D]; bias [D] -> xc [B, T, D], state_out [B, d_conv-1, D];
// 1 <= d_conv <= 4.  Returns a cudaError_t (0: launched).
int mamba_conv_fwd(int dtype, const void* x, long x_row, const void* state,
                   const void* w, const void* bias, void* xc,
                   void* state_out, int batch, int steps, int channels,
                   int d_conv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return conv_by_width<bf16>(d_conv, x, x_row, state, w, bias, xc,
                               state_out, batch, steps, channels, s);
  return conv_by_width<float>(d_conv, x, x_row, state, w, bias, xc,
                              state_out, batch, steps, channels, s);
}

// dtype 0: fp32, 1: bf16.  xc [B, T, D] contiguous; dt, z: B * T rows,
// dt_row / z_row elements apart; bc: B * T rows bc_row apart (x_proj's B
// and C columns, read in place); a_log [D, d_state], d_skip [D], h0
// [B, D, d_state] fp32; b_norm, c_norm [d_state] (the model dtype) or
// both null; eps the norms' -> y [B, T, D], h_end [B, D, d_state] fp32;
// d_state 8 or 16.  Returns a cudaError_t (0: launched).
int mamba_scan_fwd(int dtype, const void* xc, const void* dt, long dt_row,
                   const void* bc, long bc_row, const void* z, long z_row,
                   const void* a_log, const void* d_skip, const void* h0,
                   const void* b_norm, const void* c_norm, float eps,
                   void* y, void* h_end, int batch, int steps, int channels,
                   int d_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return scan_by_state<bf16>(d_state, xc, dt, dt_row, bc, bc_row, z,
                               z_row, a_log, d_skip, h0, b_norm, c_norm, eps,
                               y, h_end, batch, steps, channels, s);
  return scan_by_state<float>(d_state, xc, dt, dt_row, bc, bc_row, z, z_row,
                              a_log, d_skip, h0, b_norm, c_norm, eps, y,
                              h_end, batch, steps, channels, s);
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
