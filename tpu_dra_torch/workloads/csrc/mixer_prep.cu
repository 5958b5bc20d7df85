// The KDA layer's elementwise prologue and epilogue for Hopper (sm_90a),
// each fused into one pass forward and one backward:
//
// - short_conv: per channel c of a [B, T, C] bf16 projection x, the causal
//   depthwise conv y_t = sum_j w[j][c] x_{t - 3 + j} (4 taps, fp32 weights,
//   no bias), a = SiLU(y), and where `norm` is set the L2 norm over each
//   128-channel head, out = scale * a / sqrt(sum a^2 + eps); bf16 out.
// - gated_norm: per 128-channel head of o [B, T, H * 128] bf16, out =
//   o / sqrt(mean(o^2) + eps) * scale[c] * sigmoid(gate + bias) (gate bf16
//   [B, T, H * 128], bias fp32 [H * 128], scale fp32 [128]); bf16 out.
//
// The backward of each recomputes its forward from the saved bf16 inputs
// (nothing fp32 is kept between the passes) and writes dx / do and dgate
// in bf16; the weights' gradients (the conv's taps, the norm's scale, the
// gate's bias) are summed over a CTA's tokens in shared memory and added
// into fp32 buffers the wrapper zeroes.
//
// Replaces no TPU kernel: the JAX package has no linear attention. What
// bounds them on the H100: bytes. At the Kimi Linear cell's shape (T 32767,
// C 4096) one tensor is 268 MB in bf16; the conv reads x once and writes
// out once (0.16 ms at 3.35 TB/s), its backward reads x and dout and
// writes dx (0.24 ms); the norm reads o and gate and writes out (0.24 ms),
// its backward reads o, gate and dout and writes do and dgate (0.40 ms).
// In PyTorch the same took cuDNN's depthwise conv (an unaligned implicit
// GEMM) and some thirty fp32 passes a layer, each kept for autograd.
//
// What the design does about it: a warp owns one head (128 channels, 4 a
// lane, 8-byte loads) over a run of L tokens, walking them in order (the
// conv's last 3 rows kept in registers, so every x row is read once) or in
// reverse for the backward (3 rows of dy beyond the run recomputed, so no
// CTA waits for another); the head's sums are warp shuffles. A CTA is 4
// warps on 4 consecutive runs of one head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;     // channels of a head
constexpr int TAPS = 4;     // the conv's taps
constexpr int RUN = 64;     // tokens a warp walks
constexpr int WARPS = 4;    // warps (runs) of a CTA
constexpr int NT = 32 * WARPS;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + __expf(-x)); }

// The CTA's per-channel sums of `part` ([WARPS] warps x NT/WARPS... one
// value a thread) added into dst[c0 + e] for the lane's 4 channels.
__device__ __forceinline__ void add_over_warps(float* smem, const float (&part)[4],
                                               float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) smem[warp * HD + lane * 4 + e] = part[e];
  __syncthreads();
  if (threadIdx.x < HD) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += smem[w * HD + threadIdx.x];
    atomicAdd(dst + threadIdx.x, s);
  }
  __syncthreads();
}

}  // namespace

// ---------------------------------------------------------------------------
// The short conv, SiLU and the head's L2 norm.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) short_conv_fwd_kernel(
    const bf16* __restrict__ x, const float* __restrict__ w,
    bf16* __restrict__ out, int T, int C, int norm, float scale, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, c0 = blockIdx.y * HD + lane * 4;
  const int t0 = (blockIdx.x * WARPS + warp) * RUN;
  if (t0 >= T) return;
  const int t1 = min(t0 + RUN, T);
  const size_t row0 = static_cast<size_t>(b) * T;
  float wt[TAPS][4], hist[TAPS - 1][4];
#pragma unroll
  for (int j = 0; j < TAPS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) wt[j][e] = w[j * C + c0 + e];
#pragma unroll
  for (int j = 0; j < TAPS - 1; ++j) {
    const int t = t0 - (TAPS - 1) + j;
    if (t >= 0) load4(x + (row0 + t) * C + c0, hist[j]);
    else
#pragma unroll
      for (int e = 0; e < 4; ++e) hist[j][e] = 0.f;
  }
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    float xv[4], a[4];
    load4(x + (row0 + t) * C + c0, xv);
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = wt[0][e] * hist[0][e] + wt[1][e] * hist[1][e] +
                      wt[2][e] * hist[2][e] + wt[3][e] * xv[e];
      a[e] = y * sigmoid(y);
      ss += a[e] * a[e];
      hist[0][e] = hist[1][e];
      hist[1][e] = hist[2][e];
      hist[2][e] = xv[e];
    }
    if (norm) {
      const float r = scale * rsqrtf(warp_sum(ss) + eps);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] *= r;
    }
    store4(out + (row0 + t) * C + c0, a);
  }
}

__global__ void __launch_bounds__(NT) short_conv_bwd_kernel(
    const bf16* __restrict__ x, const float* __restrict__ w,
    const bf16* __restrict__ dout, bf16* __restrict__ dx,
    float* __restrict__ dw, int T, int C, int norm, float scale, float eps) {
  __shared__ float red[WARPS * HD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, c0 = blockIdx.y * HD + lane * 4;
  const int t0 = (blockIdx.x * WARPS + warp) * RUN;
  const int t1 = min(t0 + RUN, T);
  const size_t row0 = static_cast<size_t>(b) * T;
  float wt[TAPS][4], dwp[TAPS][4];
#pragma unroll
  for (int j = 0; j < TAPS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wt[j][e] = w[j * C + c0 + e];
      dwp[j][e] = 0.f;
    }
  if (t0 < T) {
    // Tokens from the run's last + 3 (dy beyond the run, for dx) down to
    // t0; xw holds x[t-3 .. t], dyn dy[t+1 .. t+3].
    const int top = min(t1 + TAPS - 1, T) - 1;
    float xw[TAPS][4], dyn[TAPS - 1][4];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const int t = top - (TAPS - 1) + j;
      if (t >= 0) load4(x + (row0 + t) * C + c0, xw[j]);
      else
#pragma unroll
        for (int e = 0; e < 4; ++e) xw[j][e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < TAPS - 1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dyn[j][e] = 0.f;
    for (int t = top; t >= t0; --t) {
      float y[4], s[4], a[4], go[4], dy[4];
      load4(dout + (row0 + t) * C + c0, go);
      float ss = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = wt[0][e] * xw[0][e] + wt[1][e] * xw[1][e] + wt[2][e] * xw[2][e] +
               wt[3][e] * xw[3][e];
        s[e] = sigmoid(y[e]);
        a[e] = y[e] * s[e];
        ss += a[e] * a[e];
      }
      if (norm) {
        // out = scale a / n: da = (scale / n) (dout - u (u . dout)), u = a / n.
        const float rn = rsqrtf(warp_sum(ss) + eps);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) dot += a[e] * rn * go[e];
        dot = warp_sum(dot);
#pragma unroll
        for (int e = 0; e < 4; ++e) go[e] = scale * rn * (go[e] - a[e] * rn * dot);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dy[e] = go[e] * s[e] * (1.f + y[e] * (1.f - s[e]));
      if (t < t1) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[e] = wt[3][e] * dy[e] + wt[2][e] * dyn[0][e] + wt[1][e] * dyn[1][e] +
                 wt[0][e] * dyn[2][e];
#pragma unroll
          for (int j = 0; j < TAPS; ++j) dwp[j][e] += dy[e] * xw[j][e];
        }
        store4(dx + (row0 + t) * C + c0, d);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dyn[2][e] = dyn[1][e];
        dyn[1][e] = dyn[0][e];
        dyn[0][e] = dy[e];
        xw[3][e] = xw[2][e];
        xw[2][e] = xw[1][e];
        xw[1][e] = xw[0][e];
      }
      const int tn = t - TAPS;
      if (tn >= 0) load4(x + (row0 + tn) * C + c0, xw[0]);
      else
#pragma unroll
        for (int e = 0; e < 4; ++e) xw[0][e] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < TAPS; ++j)
    add_over_warps(red, dwp[j], dw + j * C + blockIdx.y * HD);
}

// ---------------------------------------------------------------------------
// The gated RMSNorm.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) gated_norm_fwd_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ gate,
    const float* __restrict__ bias, const float* __restrict__ scale,
    bf16* __restrict__ out, int T, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, c0 = blockIdx.y * HD + lane * 4;
  const int t0 = (blockIdx.x * WARPS + warp) * RUN;
  if (t0 >= T) return;
  const int t1 = min(t0 + RUN, T);
  const size_t row0 = static_cast<size_t>(b) * T;
  float sc[4], bi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sc[e] = scale[lane * 4 + e];
    bi[e] = bias[c0 + e];
  }
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    float ov[4], gv[4], y[4];
    load4(o + (row0 + t) * C + c0, ov);
    load4(gate + (row0 + t) * C + c0, gv);
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) ss += ov[e] * ov[e];
    const float r = rsqrtf(warp_sum(ss) * (1.f / HD) + eps);
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = ov[e] * r * sc[e] * sigmoid(gv[e] + bi[e]);
    store4(out + (row0 + t) * C + c0, y);
  }
}

__global__ void __launch_bounds__(NT) gated_norm_bwd_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ gate,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const bf16* __restrict__ dout, bf16* __restrict__ dox,
    bf16* __restrict__ dgate, float* __restrict__ dbias,
    float* __restrict__ dscale, int T, int C, float eps) {
  __shared__ float red[WARPS * HD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, c0 = blockIdx.y * HD + lane * 4;
  const int t0 = (blockIdx.x * WARPS + warp) * RUN;
  const int t1 = min(t0 + RUN, T);
  const size_t row0 = static_cast<size_t>(b) * T;
  float sc[4], bi[4], dbp[4], dsp[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sc[e] = scale[lane * 4 + e];
    bi[e] = bias[c0 + e];
    dbp[e] = dsp[e] = 0.f;
  }
#pragma unroll 2
  for (int t = t0; t < t1; ++t) {
    float ov[4], gv[4], go[4], dn[4], dz[4];
    load4(o + (row0 + t) * C + c0, ov);
    load4(gate + (row0 + t) * C + c0, gv);
    load4(dout + (row0 + t) * C + c0, go);
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) ss += ov[e] * ov[e];
    const float r = rsqrtf(warp_sum(ss) * (1.f / HD) + eps);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float n = ov[e] * r, sg = sigmoid(gv[e] + bi[e]);
      dn[e] = go[e] * sc[e] * sg;
      dot += dn[e] * n;
      dsp[e] += go[e] * n * sg;
      dz[e] = go[e] * n * sc[e] * sg * (1.f - sg);
      dbp[e] += dz[e];
    }
    dot = warp_sum(dot) * (1.f / HD);
#pragma unroll
    for (int e = 0; e < 4; ++e) dn[e] = r * (dn[e] - ov[e] * r * dot);
    store4(dox + (row0 + t) * C + c0, dn);
    store4(dgate + (row0 + t) * C + c0, dz);
  }
  add_over_warps(red, dbp, dbias + blockIdx.y * HD);
  add_over_warps(red, dsp, dscale);
}

// ---------------------------------------------------------------------------
// C entry points: pointers, then B, T, C (a multiple of 128), then the
// float arguments, then the stream. Each returns its launch's CUDA error.
// ---------------------------------------------------------------------------

namespace {

dim3 grid_of(int B, int T, int C) {
  return dim3((T + RUN * WARPS - 1) / (RUN * WARPS), C / HD, B);
}

}  // namespace

extern "C" int short_conv_fwd(const void* x, const void* w, void* out, int B,
                              int T, int C, int norm, float scale, float eps,
                              void* stream) {
  if (B * T == 0) return 0;
  if (C % HD) return static_cast<int>(cudaErrorInvalidValue);
  short_conv_fwd_kernel<<<grid_of(B, T, C), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w),
      static_cast<bf16*>(out), T, C, norm, scale, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int short_conv_bwd(const void* x, const void* w, const void* dout,
                              void* dx, void* dw, int B, int T, int C, int norm,
                              float scale, float eps, void* stream) {
  if (B * T == 0) return 0;
  if (C % HD) return static_cast<int>(cudaErrorInvalidValue);
  short_conv_bwd_kernel<<<grid_of(B, T, C), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx),
      static_cast<float*>(dw), T, C, norm, scale, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gated_norm_fwd(const void* o, const void* gate, const void* bias,
                              const void* scale, void* out, int B, int T, int C,
                              float eps, void* stream) {
  if (B * T == 0) return 0;
  if (C % HD) return static_cast<int>(cudaErrorInvalidValue);
  gated_norm_fwd_kernel<<<grid_of(B, T, C), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(gate),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<bf16*>(out), T, C, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gated_norm_bwd(const void* o, const void* gate, const void* bias,
                              const void* scale, const void* dout, void* dox,
                              void* dgate, void* dbias, void* dscale, int B,
                              int T, int C, float eps, void* stream) {
  if (B * T == 0) return 0;
  if (C % HD) return static_cast<int>(cudaErrorInvalidValue);
  gated_norm_bwd_kernel<<<grid_of(B, T, C), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(gate),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dox),
      static_cast<bf16*>(dgate), static_cast<float*>(dbias),
      static_cast<float*>(dscale), T, C, eps);
  return static_cast<int>(cudaGetLastError());
}
