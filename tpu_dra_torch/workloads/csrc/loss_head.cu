// The LM loss head's cross-entropy over bf16 logits, for Hopper (sm_90a):
// per row of logits x [N, V] and its target t, the forward writes
// lse = log(sum_v exp(x_v)) and nll = lse - x_t in fp32, and the backward
// writes dlogits = dnll * (exp(x - lse) - [v = t]) in bf16.
//
// Replaces no TPU kernel. The reference (tpu_dra/workloads/model.py:
// token_nll) computes this loss in XLA, which fuses the logsumexp and the
// gather into the logits' consumers. The port's plain form casts the bf16
// logits to fp32 and runs logsumexp and gather in PyTorch: twelve passes
// over [N, V] (84 bytes an element across forward and backward), every
// one bytes-bound.
//
// What bounds them on the H100: bytes. The forward reads each bf16 logit
// once (2 B an element), the backward reads it again and writes its bf16
// gradient once (4 B an element); the targets, lse, nll and dnll add
// 16 B a row each way. At 3.35 TB/s that is 0.160 / 0.320 ms at N 8184,
// V 32768, 0.320 / 0.641 ms at N 16383, V 32768 and 0.601 / 1.202 ms at
// N 49146, V 20480. The exponential costs one MUFU op an element, well
// under the SFU's rate at those byte rates.
//
// What the design does about it:
// 1. loss_lse_nll: one CTA of 256 threads per row, 16-byte loads (8
//    logits), kUnroll loads of a thread issued before any is used, so a
//    resident SM (8 CTAs) keeps 128 KB of loads in flight. Each thread
//    keeps a running max and a sum of exponentials rescaled to it, in
//    fp32 registers, over its share of the row; the threads' pairs are
//    merged by warp shuffles, then across the 8 warps in shared memory.
//    Exponentials are exp2f((x - max) * log2 e), the difference taken
//    first so that the error stays relative to it. One thread writes lse
//    = max + log(sum) and nll = lse - x_t (NaN where t lies outside [0,
//    V)).
// 2. loss_dlogits: the same grid and loads; each logit's gradient is
//    taken in fp32 as dnll * (exp(x - lse) - [v = t]) and rounded once to
//    bf16, eight to a 16-byte store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace loss {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;       // bf16 logits per 16-byte load
constexpr int kUnroll = 4;    // 16-byte loads in flight per thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr uint32_t kNegInfPair = 0xff80ff80u;   // two bf16 -inf

// The two bf16 halves of a word as floats (exact: a bf16 is the top half
// of its fp32).
__device__ __forceinline__ float lo_of(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_of(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void unpack(const uint4& v, float (&x)[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = lo_of(w[j]);
    x[2 * j + 1] = hi_of(w[j]);
  }
}

// (m, s) and (m2, s2), each a max and a sum of exp(x - max), merged.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float top = fmaxf(m, m2);
  if (top == -INFINITY) return;          // both empty so far
  s = s * exp2f((m - top) * kLog2e) + s2 * exp2f((m2 - top) * kLog2e);
  m = top;
}

__global__ void __launch_bounds__(kThreads)
lse_nll_kernel(const __nv_bfloat16* __restrict__ logits,
               const int64_t* __restrict__ targets, float* __restrict__ lse,
               float* __restrict__ nll, int vocab) {
  const int row = blockIdx.x;
  const __nv_bfloat16* x_row = logits + static_cast<size_t>(row) * vocab;
  const uint4* src = reinterpret_cast<const uint4*>(x_row);
  const int n_vec = vocab / kVec;
  float m = -INFINITY, s = 0.f;
  for (int base = threadIdx.x; base < n_vec; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < n_vec ? __ldcs(src + i)
                       : make_uint4(kNegInfPair, kNegInfPair, kNegInfPair,
                                    kNegInfPair);
    }
    float top = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[kVec];
      unpack(v[u], x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) top = fmaxf(top, x[j]);
    }
    if (top == -INFINITY) continue;      // nothing but -inf so far
    s *= exp2f((m - top) * kLog2e);
    m = top;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[kVec];
      unpack(v[u], x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) s += exp2f((x[j] - m) * kLog2e);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float warp_m[kWarps], warp_s[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_m[warp] = m;
    warp_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) merge(m, s, warp_m[w], warp_s[w]);
  const float row_lse = m + log2f(s) * kLn2;
  const int64_t t = targets[row];
  const float x_t = (t >= 0 && t < vocab) ? __bfloat162float(x_row[t]) : NAN;
  lse[row] = row_lse;
  nll[row] = row_lse - x_t;
}

__global__ void __launch_bounds__(kThreads)
dlogits_kernel(const __nv_bfloat16* __restrict__ logits,
               const int64_t* __restrict__ targets,
               const float* __restrict__ lse, const float* __restrict__ dnll,
               __nv_bfloat16* __restrict__ dlogits, int vocab) {
  const int row = blockIdx.x;
  const size_t offset = static_cast<size_t>(row) * vocab;
  const uint4* src = reinterpret_cast<const uint4*>(logits + offset);
  uint4* dst = reinterpret_cast<uint4*>(dlogits + offset);
  const int n_vec = vocab / kVec;
  const float row_lse = lse[row], g = dnll[row];
  const int64_t t = targets[row];
  for (int base = threadIdx.x; base < n_vec; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < n_vec) v[u] = __ldcs(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i >= n_vec) break;
      float x[kVec];
      unpack(v[u], x);
      const int64_t at = t - static_cast<int64_t>(i) * kVec;  // t's slot
      uint32_t out[4];
#pragma unroll
      for (int j = 0; j < kVec; j += 2) {
        float d[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p = exp2f((x[j + h] - row_lse) * kLog2e);
          d[h] = g * (at == j + h ? p - 1.f : p);
        }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(d[0], d[1]);
        out[j / 2] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      __stcs(dst + i, make_uint4(out[0], out[1], out[2], out[3]));
    }
  }
}

}  // namespace loss

// logits [n_rows, vocab] bf16 (rows contiguous, 16-byte aligned, vocab a
// multiple of 8), targets [n_rows] int64; writes lse and nll [n_rows] fp32.
extern "C" int loss_lse_nll(const void* logits, const void* targets, void* lse,
                            void* nll, int n_rows, int vocab, void* stream) {
  if (n_rows == 0) return 0;
  if (vocab <= 0 || vocab % loss::kVec)
    return static_cast<int>(cudaErrorInvalidValue);
  loss::lse_nll_kernel<<<n_rows, loss::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const int64_t*>(targets), static_cast<float*>(lse),
      static_cast<float*>(nll), vocab);
  return static_cast<int>(cudaGetLastError());
}

// logits and targets as loss_lse_nll takes them, lse and dnll [n_rows]
// fp32; writes dlogits [n_rows, vocab] bf16.
extern "C" int loss_dlogits(const void* logits, const void* targets,
                            const void* lse, const void* dnll, void* dlogits,
                            int n_rows, int vocab, void* stream) {
  if (n_rows == 0) return 0;
  if (vocab <= 0 || vocab % loss::kVec)
    return static_cast<int>(cudaErrorInvalidValue);
  loss::dlogits_kernel<<<n_rows, loss::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const int64_t*>(targets), static_cast<const float*>(lse),
      static_cast<const float*>(dnll),
      static_cast<__nv_bfloat16*>(dlogits), vocab);
  return static_cast<int>(cudaGetLastError());
}
