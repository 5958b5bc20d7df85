// Kimi Delta Attention's chunk kernels for Hopper (sm_90a): the gated
// delta rule with a per-channel decay, S_t = (I - b_t k_t k_t^T)
// Diag(exp g_t) S_{t-1} + b_t k_t v_t^T, o_t = S_t^T q_t, from S_0 = 0, per
// (batch, head), in chunks of C = 64 tokens (workloads/_kda_kernels.py
// says the chunk form; its plain versions follow these kernels stage by
// stage). q, k, v, o and dO are bf16 [B, T, H, 128]; g fp32 [B, T, H, 128]
// (log-decays, <= 0), beta fp32 [B, T, H]; the chunk buffers are fp32
// [B, H, N, ...], N = ceil(T / 64), rows past T zero.
//
// Replaces no TPU kernel: the JAX package has no linear attention.
//
// What bounds them on the H100: at the cell's shape (B1, T 32767, H 32,
// dk = dv = 128) the compulsory bytes of a call are ~1.6 GB forward and
// ~3.0 GB backward (0.5 and 0.9 ms at 3.35 TB/s), and the chunk form's
// products ~146 GFLOP forward (0.15 ms of bf16 tensor-core peak). These
// first kernels do all arithmetic in fp32 on the CUDA cores, and the
// state pass runs sequentially over 512 chunks with B x H x 4 = 128
// CTAs: the FMA and exponential issue rate and the state pass's serial
// depth bound them, not bytes.
//
// What the design does about it:
// 1. kda_intra_kernel, one CTA per (chunk, head, batch): the cumulative
//    log-decay G of the chunk's rows in log2 units in shared memory; each
//    pair i <= r of rows takes its decay channel by channel as
//    exp2(G_r - G_i), never positive, so nothing overflows whatever the
//    decays; A~ (i < r) and P (i <= r) share those exponentials. The
//    unit lower triangular solve M W = Diag(beta) (k exp G), M U~ =
//    Diag(beta) v runs one column per thread (128 of W, 128 of U~) by
//    forward substitution in registers, fully unrolled. It also writes
//    q exp G, Kh = k exp(G_last - G) and exp G_last, so the state passes
//    take no exponential.
// 2. kda_state_fwd_kernel, one CTA per (32 columns of dv, head, batch),
//    the chunks in order: the state's [128 x 32] block in shared memory;
//    per chunk U = U~ - W S, o = (q exp G) S + P U, S <- Diag(exp G_last)
//    S + Kh^T U. For the backward it writes each chunk's starting state
//    and U instead of o.
// 3. kda_state_bwd_kernel, the same grid, the chunks in reverse: dU = Kh
//    dS + P^T dO, dS <- Diag(exp G_last) dS + (q exp G)^T dO - W^T dU;
//    writes each chunk's dS (of its end state) and dU.
// 4. kda_dstate_kernel, one CTA per (chunk, head, batch, product): the
//    chunk's full-width products over dv, dQg = dO S^T, dW = -dU S^T,
//    dKh = U dS^T, dP = tril(dO U^T) and d(exp G_last) = rowsum(dS * S).
// 5. kda_intra_bwd_kernel, one CTA per chunk: back substitution with M^T
//    (one column per thread), dA = -(dX W^T + dY U~^T) streamed over
//    32-column slabs, then each (row, channel) takes its terms from the
//    pairs twice, as row and as column, with the exponentials recomputed,
//    and the decays' gradient is summed back over the rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // rows of a chunk
constexpr int D = 128;         // dk = dv
constexpr int NT = 256;        // threads of every CTA
constexpr int DVB = 32;        // dv columns of a state-pass CTA
constexpr int AP = C + 1;      // padded row of a [C][C] tile
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(const bf16 x) { return __bfloat162float(x); }

// Row t of head h of a [B, T, H, D] tensor.
__device__ __forceinline__ size_t tok(int b, int t, int h, int T, int H) {
  return ((static_cast<size_t>(b) * T + t) * H + h) * D;
}

// The chunk's C rows of a [B, T, H, D] bf16 tensor into shared memory,
// rows past T zero; 16-byte loads.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b,
                                          int n, int h, int T, int H) {
  for (int idx = threadIdx.x; idx < C * D / 8; idx += NT) {
    const int r = idx / (D / 8), c8 = idx % (D / 8);
    const int t = n * C + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < T) v = *reinterpret_cast<const uint4*>(src + tok(b, t, h, T, H) + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * D + c8 * 8) = v;
  }
}

// The chunk's g rows into G, then per channel the inclusive cumulative
// sum over the rows, in log2 units; beta into bs. Ends synchronized.
__device__ __forceinline__ void load_decay(float* G, float* bs, const float* g,
                                           const float* beta, int b, int n,
                                           int h, int T, int H) {
  for (int idx = threadIdx.x; idx < C * D / 4; idx += NT) {
    const int r = idx / (D / 4), c4 = idx % (D / 4);
    const int t = n * C + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) v = *reinterpret_cast<const float4*>(g + tok(b, t, h, T, H) + c4 * 4);
    *reinterpret_cast<float4*>(G + r * D + c4 * 4) = v;
  }
  if (threadIdx.x < C) {
    const int t = n * C + threadIdx.x;
    bs[threadIdx.x] = t < T ? beta[(static_cast<size_t>(b) * T + t) * H + h] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < D) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) {
      s += G[r * D + threadIdx.x];
      G[r * D + threadIdx.x] = s * kLog2e;
    }
  }
  __syncthreads();
}

// A [rows x cols] fp32 tile of a chunk buffer (row stride D) into shared
// memory (row stride D), by 16-byte vectors.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int rows) {
  for (int idx = threadIdx.x; idx < rows * D / 4; idx += NT)
    reinterpret_cast<float4*>(dst)[idx] = reinterpret_cast<const float4*>(src)[idx];
}

// Pair p of the rows i <= r of a chunk, in (r, i) order.
__device__ __forceinline__ void pair_of(int p, int& r, int& i) {
  r = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= p) ++r;
  while (r * (r + 1) / 2 > p) --r;
  i = p - r * (r + 1) / 2;
}

}  // namespace

// ---------------------------------------------------------------------------
// 1. The chunk-local quantities.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 2) kda_intra_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, float* __restrict__ Wo,
    float* __restrict__ Uto, float* __restrict__ Qgo, float* __restrict__ Kho,
    float* __restrict__ Po, float* __restrict__ glo, float* __restrict__ Ato,
    int T, int H) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z, N = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t chunk = (static_cast<size_t>(b) * H + h) * N + n;
  extern __shared__ float4 smem4[];
  float* G = reinterpret_cast<float*>(smem4);   // [C][D], log2 units
  bf16* ks = reinterpret_cast<bf16*>(G + C * D);  // [C][D]
  bf16* qs = ks + C * D;
  bf16* vs = qs + C * D;
  float* A = reinterpret_cast<float*>(vs + C * D);  // [C][AP], A~
  float* bs = A + C * AP;                           // [C]

  load_rows(ks, k, b, n, h, T, H);
  load_rows(qs, q, b, n, h, T, H);
  load_rows(vs, v, b, n, h, T, H);
  load_decay(G, bs, g, beta, b, n, h, T, H);

  // Pairs i <= r: A~[r][i] (i < r) and P[r][i]; each lane starts its
  // channel loop at its own offset, so the warp's rows fall in distinct
  // banks.
  float* P = Po + chunk * C * C;
  for (int p = tid; p < C * (C + 1) / 2; p += NT) {
    int r, i;
    pair_of(p, r, i);
    float a0 = 0.f, a1 = 0.f, p0 = 0.f, p1 = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < D; cc += 2) {
      const int c0 = (cc + lane) & (D - 1), c1 = (cc + 1 + lane) & (D - 1);
      const float e0 = exp2f(G[r * D + c0] - G[i * D + c0]) * bf(ks[i * D + c0]);
      const float e1 = exp2f(G[r * D + c1] - G[i * D + c1]) * bf(ks[i * D + c1]);
      a0 += bf(ks[r * D + c0]) * e0;
      a1 += bf(ks[r * D + c1]) * e1;
      p0 += bf(qs[r * D + c0]) * e0;
      p1 += bf(qs[r * D + c1]) * e1;
    }
    P[r * C + i] = p0 + p1;
    const float a = i < r ? a0 + a1 : 0.f;
    A[r * AP + i] = a;
    if (Ato) Ato[chunk * C * C + r * C + i] = a;
  }
  for (int idx = tid; idx < C * C; idx += NT) {
    const int r = idx / C, i = idx % C;
    if (i > r) {
      P[idx] = 0.f;
      if (Ato) Ato[chunk * C * C + idx] = 0.f;
    }
  }
  __syncthreads();

  // Forward substitution, one column per thread: threads [0, 128) solve
  // M W = Diag(beta) (k exp G), threads [128, 256) M U~ = Diag(beta) v.
  {
    const bool isw = tid < D;
    const int c = tid & (D - 1);
    float w[C];
#pragma unroll
    for (int r = 0; r < C; ++r)
      w[r] = isw ? bs[r] * bf(ks[r * D + c]) * exp2f(G[r * D + c])
                 : bs[r] * bf(vs[r * D + c]);
#pragma unroll
    for (int r = 1; r < C; ++r) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i + 1 < r; i += 2) {
        s0 += A[r * AP + i] * w[i];
        s1 += A[r * AP + i + 1] * w[i + 1];
      }
      if (r & 1) s0 += A[r * AP + r - 1] * w[r - 1];
      w[r] -= bs[r] * (s0 + s1);
    }
    float* out = (isw ? Wo : Uto) + chunk * C * D;
#pragma unroll
    for (int r = 0; r < C; ++r) out[r * D + c] = w[r];
  }

  // q exp G, Kh = k exp(G_last - G), exp G_last.
  for (int idx = tid; idx < C * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const float gr = G[r * D + c];
    Qgo[chunk * C * D + idx] = bf(qs[idx]) * exp2f(gr);
    Kho[chunk * C * D + idx] = bf(ks[idx]) * exp2f(G[(C - 1) * D + c] - gr);
  }
  if (tid < D) glo[chunk * D + tid] = exp2f(G[(C - 1) * D + tid]);
}

// ---------------------------------------------------------------------------
// 2. The state pass, chunks in order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1) kda_state_fwd_kernel(
    const float* __restrict__ W, const float* __restrict__ Ut,
    const float* __restrict__ Qg, const float* __restrict__ Kh,
    const float* __restrict__ P, const float* __restrict__ gl,
    bf16* __restrict__ o, float* __restrict__ S0s, float* __restrict__ Uo,
    int T, int H, int N) {
  const int j0 = blockIdx.x * DVB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, j = tid & 31, grp = tid >> 5;
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // [D][DVB]
  float* Ws = S + D * DVB;                      // [C][D]
  float* Qs = Ws + C * D;
  float* Ks = Qs + C * D;
  float* Ps = Ks + C * D;                       // [C][C]
  float* Us = Ps + C * C;                       // [C][DVB]
  float* gs = Us + C * DVB;                     // [D]

  for (int idx = tid; idx < D * DVB; idx += NT) S[idx] = 0.f;
  __syncthreads();
  for (int n = 0; n < N; ++n) {
    const size_t chunk = (static_cast<size_t>(b) * H + h) * N + n;
    load_tile(Ws, W + chunk * C * D, C);
    load_tile(Qs, Qg + chunk * C * D, C);
    load_tile(Ks, Kh + chunk * C * D, C);
    for (int idx = tid; idx < C * C / 4; idx += NT)
      reinterpret_cast<float4*>(Ps)[idx] =
          reinterpret_cast<const float4*>(P + chunk * C * C)[idx];
    for (int idx = tid; idx < C * DVB / 4; idx += NT) {
      const int r = idx / (DVB / 4), c4 = idx % (DVB / 4);
      reinterpret_cast<float4*>(Us)[idx] =
          *reinterpret_cast<const float4*>(Ut + chunk * C * D + r * D + j0 + c4 * 4);
    }
    if (tid < D) gs[tid] = gl[chunk * D + tid];
    if (S0s) {
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int a = grp * 16 + m;
        S0s[chunk * D * D + a * D + j0 + j] = S[a * DVB + j];
      }
    }
    __syncthreads();

    // U = U~ - W S, rows grp * 8 + m.
    {
      float u[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) u[m] = Us[(grp * 8 + m) * DVB + j];
      for (int a = 0; a < D; a += 4) {
        const float s0 = S[a * DVB + j], s1 = S[(a + 1) * DVB + j],
                    s2 = S[(a + 2) * DVB + j], s3 = S[(a + 3) * DVB + j];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float4 w4 = *reinterpret_cast<const float4*>(Ws + (grp * 8 + m) * D + a);
          u[m] -= w4.x * s0 + w4.y * s1 + w4.z * s2 + w4.w * s3;
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int r = grp * 8 + m;
        Us[r * DVB + j] = u[m];
        if (Uo) Uo[(static_cast<size_t>(b) * H + h) * N * C * D +
                   static_cast<size_t>(n) * C * D + r * D + j0 + j] = u[m];
      }
    }
    __syncthreads();

    // o = (q exp G) S + P U.
    if (o) {
      float acc[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[m] = 0.f;
      for (int a = 0; a < D; a += 4) {
        const float s0 = S[a * DVB + j], s1 = S[(a + 1) * DVB + j],
                    s2 = S[(a + 2) * DVB + j], s3 = S[(a + 3) * DVB + j];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float4 q4 = *reinterpret_cast<const float4*>(Qs + (grp * 8 + m) * D + a);
          acc[m] += q4.x * s0 + q4.y * s1 + q4.z * s2 + q4.w * s3;
        }
      }
      const int top = grp * 8 + 8;   // P is zero above the diagonal
      for (int i = 0; i < top; ++i) {
        const float ui = Us[i * DVB + j];
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[m] += Ps[(grp * 8 + m) * C + i] * ui;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int t = n * C + grp * 8 + m;
        if (t < T) o[tok(b, t, h, T, H) + j0 + j] = __float2bfloat16(acc[m]);
      }
    }
    __syncthreads();

    // S <- Diag(exp G_last) S + Kh^T U, rows grp * 16 + m.
    {
      float s[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int a = grp * 16 + m;
        s[m] = gs[a] * S[a * DVB + j];
      }
      for (int r = 0; r < C; ++r) {
        const float ur = Us[r * DVB + j];
#pragma unroll
        for (int m4 = 0; m4 < 4; ++m4) {
          const float4 k4 = *reinterpret_cast<const float4*>(Ks + r * D + grp * 16 + m4 * 4);
          s[m4 * 4] += k4.x * ur;
          s[m4 * 4 + 1] += k4.y * ur;
          s[m4 * 4 + 2] += k4.z * ur;
          s[m4 * 4 + 3] += k4.w * ur;
        }
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) S[(grp * 16 + m) * DVB + j] = s[m];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 3. The state's gradient, chunks in reverse.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1) kda_state_bwd_kernel(
    const float* __restrict__ Qg, const float* __restrict__ W,
    const float* __restrict__ Kh, const float* __restrict__ P,
    const float* __restrict__ gl, const bf16* __restrict__ dO,
    float* __restrict__ dSs, float* __restrict__ dUo, int T, int H, int N) {
  const int j0 = blockIdx.x * DVB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, j = tid & 31, grp = tid >> 5;
  extern __shared__ float4 smem4[];
  float* dS = reinterpret_cast<float*>(smem4);  // [D][DVB]
  float* Ks = dS + D * DVB;                      // [C][D]
  float* Qs = Ks + C * D;
  float* Ws = Qs + C * D;
  float* Ps = Ws + C * D;                        // [C][C]
  float* dOs = Ps + C * C;                       // [C][DVB]
  float* dUs = dOs + C * DVB;                    // [C][DVB]
  float* gs = dUs + C * DVB;                     // [D]

  for (int idx = tid; idx < D * DVB; idx += NT) dS[idx] = 0.f;
  __syncthreads();
  for (int n = N - 1; n >= 0; --n) {
    const size_t chunk = (static_cast<size_t>(b) * H + h) * N + n;
    load_tile(Ks, Kh + chunk * C * D, C);
    load_tile(Qs, Qg + chunk * C * D, C);
    load_tile(Ws, W + chunk * C * D, C);
    for (int idx = tid; idx < C * C / 4; idx += NT)
      reinterpret_cast<float4*>(Ps)[idx] =
          reinterpret_cast<const float4*>(P + chunk * C * C)[idx];
    {
      const int r = tid / 4, c8 = tid % 4, t = n * C + r;   // C x 32 bf16
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (t < T) raw = *reinterpret_cast<const uint4*>(dO + tok(b, t, h, T, H) + j0 + c8 * 8);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int x = 0; x < 8; ++x) dOs[r * DVB + c8 * 8 + x] = bf(e[x]);
    }
    if (tid < D) gs[tid] = gl[chunk * D + tid];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int a = grp * 16 + m;
      dSs[chunk * D * D + a * D + j0 + j] = dS[a * DVB + j];
    }
    __syncthreads();

    // dU = Kh dS + P^T dO, rows grp * 8 + m.
    {
      float du[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) du[m] = 0.f;
      for (int a = 0; a < D; a += 4) {
        const float s0 = dS[a * DVB + j], s1 = dS[(a + 1) * DVB + j],
                    s2 = dS[(a + 2) * DVB + j], s3 = dS[(a + 3) * DVB + j];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float4 k4 = *reinterpret_cast<const float4*>(Ks + (grp * 8 + m) * D + a);
          du[m] += k4.x * s0 + k4.y * s1 + k4.z * s2 + k4.w * s3;
        }
      }
      for (int i = grp * 8; i < C; ++i) {   // P[i][r] is zero for i < r
        const float di = dOs[i * DVB + j];
#pragma unroll
        for (int m = 0; m < 8; ++m) du[m] += Ps[i * C + grp * 8 + m] * di;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int r = grp * 8 + m;
        dUs[r * DVB + j] = du[m];
        dUo[chunk * C * D + r * D + j0 + j] = du[m];
      }
    }
    __syncthreads();

    // dS <- Diag(exp G_last) dS + (q exp G)^T dO - W^T dU.
    {
      float s[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int a = grp * 16 + m;
        s[m] = gs[a] * dS[a * DVB + j];
      }
      for (int r = 0; r < C; ++r) {
        const float dor = dOs[r * DVB + j], dur = dUs[r * DVB + j];
#pragma unroll
        for (int m4 = 0; m4 < 4; ++m4) {
          const float4 q4 = *reinterpret_cast<const float4*>(Qs + r * D + grp * 16 + m4 * 4);
          const float4 w4 = *reinterpret_cast<const float4*>(Ws + r * D + grp * 16 + m4 * 4);
          s[m4 * 4] += q4.x * dor - w4.x * dur;
          s[m4 * 4 + 1] += q4.y * dor - w4.y * dur;
          s[m4 * 4 + 2] += q4.z * dor - w4.z * dur;
          s[m4 * 4 + 3] += q4.w * dor - w4.w * dur;
        }
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) dS[(grp * 16 + m) * DVB + j] = s[m];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 4. Each chunk's products over the full dv.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 2) kda_dstate_kernel(
    const bf16* __restrict__ dO, const float* __restrict__ U,
    const float* __restrict__ dU, const float* __restrict__ S0s,
    const float* __restrict__ dSs, float* __restrict__ dQg,
    float* __restrict__ dW, float* __restrict__ dKh, float* __restrict__ dP,
    float* __restrict__ dgl, int T, int H) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z >> 2,
            part = blockIdx.z & 3, N = gridDim.x;
  const int tid = threadIdx.x;
  const size_t chunk = (static_cast<size_t>(b) * H + h) * N + n;
  extern __shared__ float4 smem4[];
  float* L = reinterpret_cast<float*>(smem4);   // [C][D]
  float* R = L + C * D;                          // [D][D + 1]
  constexpr int RP = D + 1;

  // L: dO (parts 0 and 3), dU (1) or U (2).
  if (part == 0 || part == 3) {
    for (int idx = tid; idx < C * D / 8; idx += NT) {
      const int r = idx / (D / 8), c8 = idx % (D / 8), t = n * C + r;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (t < T) raw = *reinterpret_cast<const uint4*>(dO + tok(b, t, h, T, H) + c8 * 8);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int x = 0; x < 8; ++x) L[r * D + c8 * 8 + x] = bf(e[x]);
    }
  } else {
    load_tile(L, (part == 1 ? dU : U) + chunk * C * D, C);
  }
  // R: S (parts 0, 1), dS (2) or U (3), rows padded.
  const float* rsrc = part == 2 ? dSs + chunk * D * D
                    : part == 3 ? U + chunk * C * D : S0s + chunk * D * D;
  const int rrows = part == 3 ? C : D;
  for (int idx = tid; idx < rrows * D / 4; idx += NT) {
    const int r = idx / (D / 4), c4 = idx % (D / 4);
    const float4 v = reinterpret_cast<const float4*>(rsrc)[idx];
    R[r * RP + c4 * 4] = v.x;
    R[r * RP + c4 * 4 + 1] = v.y;
    R[r * RP + c4 * 4 + 2] = v.z;
    R[r * RP + c4 * 4 + 3] = v.w;
  }
  __syncthreads();

  if (part < 3) {
    // out[r][a] = sign * sum_j L[r][j] R[a][j], rows half * 32 + m.
    const int a = tid & (D - 1), half = tid >> 7;
    float acc[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) acc[m] = 0.f;
    for (int jj = 0; jj < D; jj += 4) {
      const float r0 = R[a * RP + jj], r1 = R[a * RP + jj + 1],
                  r2 = R[a * RP + jj + 2], r3 = R[a * RP + jj + 3];
#pragma unroll
      for (int m = 0; m < 32; ++m) {
        const float4 l4 = *reinterpret_cast<const float4*>(L + (half * 32 + m) * D + jj);
        acc[m] += l4.x * r0 + l4.y * r1 + l4.z * r2 + l4.w * r3;
      }
    }
    float* out = (part == 0 ? dQg : part == 1 ? dW : dKh) + chunk * C * D;
    const float sign = part == 1 ? -1.f : 1.f;
#pragma unroll
    for (int m = 0; m < 32; ++m) out[(half * 32 + m) * D + a] = sign * acc[m];
    return;
  }

  // dP[r][i] = sum_j dO[r][j] U[i][j] for i <= r, rows rg * 16 + m.
  {
    const int i = tid & (C - 1), rg = tid >> 6;
    float acc[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) acc[m] = 0.f;
    for (int jj = 0; jj < D; jj += 4) {
      const float r0 = R[i * RP + jj], r1 = R[i * RP + jj + 1],
                  r2 = R[i * RP + jj + 2], r3 = R[i * RP + jj + 3];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const float4 l4 = *reinterpret_cast<const float4*>(L + (rg * 16 + m) * D + jj);
        acc[m] += l4.x * r0 + l4.y * r1 + l4.z * r2 + l4.w * r3;
      }
    }
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int r = rg * 16 + m;
      dP[chunk * C * C + r * C + i] = i <= r ? acc[m] : 0.f;
    }
  }
  // d(exp G_last)[a] = sum_j dS[a][j] S[a][j]: a warp per 16 rows.
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int a = warp * 16; a < warp * 16 + 16; ++a) {
      const float* s = S0s + chunk * D * D + a * D;
      const float* ds = dSs + chunk * D * D + a * D;
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) x += s[lane + 32 * e] * ds[lane + 32 * e];
#pragma unroll
      for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) dgl[chunk * D + a] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// 5. Back through the chunk: dq, dk, dv, dg, dbeta.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1) kda_intra_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, const float* __restrict__ At,
    const float* __restrict__ W, const float* __restrict__ Ut,
    const float* __restrict__ dQg, const float* __restrict__ dW,
    const float* __restrict__ dU, const float* __restrict__ dKh,
    const float* __restrict__ dP, const float* __restrict__ dgl,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dg, float* __restrict__ dbeta, int T, int H) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z, N = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t chunk = (static_cast<size_t>(b) * H + h) * N + n;
  constexpr int SP = 33;   // padded row of a [C][32] slab
  extern __shared__ float4 smem4[];
  float* G = reinterpret_cast<float*>(smem4);     // [C][D], log2 units
  bf16* ks = reinterpret_cast<bf16*>(G + C * D);  // [C][D]
  bf16* qs = ks + C * D;
  bf16* vs = qs + C * D;
  float* As = reinterpret_cast<float*>(vs + C * D);  // [C][AP], A~
  float* dAs = As + C * AP;                          // [C][AP], beta_r dA
  float* dPs = dAs + C * AP;                         // [C][AP]
  float* bs = dPs + C * AP;                          // [C]
  float* dbs = bs + C;                               // [C]
  float* gsum = dbs + C;                             // [2][D]
  float* XY = gsum + 2 * D;                          // [C][2 D]: dX | dY
  float* slab = XY + C * 2 * D;                      // [C][SP]
  float* dGs = XY;                                   // [C][D], after XY

  load_rows(ks, k, b, n, h, T, H);
  load_rows(qs, q, b, n, h, T, H);
  load_rows(vs, v, b, n, h, T, H);
  for (int idx = tid; idx < C * C; idx += NT) {
    const int r = idx / C, i = idx % C;
    As[r * AP + i] = At[chunk * C * C + idx];
    dPs[r * AP + i] = dP[chunk * C * C + idx];
    dAs[r * AP + i] = 0.f;
  }
  if (tid < C) dbs[tid] = 0.f;
  load_decay(G, bs, g, beta, b, n, h, T, H);

  // dX = M^-T dW, dY = M^-T dU by back substitution, one column per
  // thread: M^T[r][i] = beta_i A~[i][r] for i > r.
  {
    const int c = tid & (D - 1);
    const float* src = (tid < D ? dW : dU) + chunk * C * D;
    float x[C];
#pragma unroll
    for (int r = 0; r < C; ++r) x[r] = src[r * D + c];
#pragma unroll
    for (int r = C - 2; r >= 0; --r) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = r + 1; i < C; i += 2) {
        s0 += bs[i] * As[i * AP + r] * x[i];
        if (i + 1 < C) s1 += bs[i + 1] * As[(i + 1) * AP + r] * x[i + 1];
      }
      x[r] -= s0 + s1;
    }
#pragma unroll
    for (int r = 0; r < C; ++r) XY[r * 2 * D + tid] = x[r];
  }
  __syncthreads();

  // dA[r][i] = -(dX_r . W_i + dY_r . U~_i), i < r, over eight slabs of 32
  // of the 256 columns; each lane starts at its own column.
  {
    constexpr int PAIRS = C * (C - 1) / 2;
    constexpr int PER = (PAIRS + NT - 1) / NT;
    float acc[PER];
    int pr[PER], pi[PER];
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      acc[s] = 0.f;
      const int p = tid + s * NT;
      int r, i;
      pair_of(p < PAIRS ? p : 0, r, i);   // i <= r-1 pairs as (r - 1, i)
      pr[s] = p < PAIRS ? r + 1 : -1;
      pi[s] = i;
    }
    for (int sl = 0; sl < 2 * D / 32; ++sl) {
      const float* src = (sl < D / 32 ? W : Ut) + chunk * C * D + (sl % (D / 32)) * 32;
      for (int idx = tid; idx < C * 32; idx += NT) {
        const int r = idx / 32, cc = idx % 32;
        slab[r * SP + cc] = src[r * D + cc];
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        if (pr[s] < 0) continue;
        const float* xr = XY + pr[s] * 2 * D + sl * 32;
        const float* wi = slab + pi[s] * SP;
        float a = 0.f;
#pragma unroll 8
        for (int cc = 0; cc < 32; ++cc) {
          const int c = (cc + lane) & 31;
          a += xr[c] * wi[c];
        }
        acc[s] += a;
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      if (pr[s] < 0) continue;
      const int r = pr[s], i = pi[s];
      const float da = -acc[s];
      dAs[r * AP + i] = bs[r] * da;
      atomicAdd(&dbs[r], da * As[r * AP + i]);
    }
  }

  // Each thread's (row, channel)s: c = tid % 128, rows (tid / 128) + 2 m.
  const int c = tid & (D - 1), r0 = tid >> 7;
  const float gL = G[(C - 1) * D + c];
  float dkr[C / 2], dqr[C / 2], dGr[C / 2];
  float gpart = 0.f;
#pragma unroll
  for (int m = 0; m < C / 2; ++m) {
    const int r = r0 + 2 * m;
    const float gr = G[r * D + c], eg = exp2f(gr), eh = exp2f(gL - gr);
    const float kf = bf(ks[r * D + c]), qf = bf(qs[r * D + c]), vf = bf(vs[r * D + c]);
    const float dx = XY[r * 2 * D + c], dy = XY[r * 2 * D + D + c];
    const float dkg = bs[r] * dx, kg = kf * eg;
    const int t = n * C + r;
    if (t < T) dv[tok(b, t, h, T, H) + c] = __float2bfloat16(bs[r] * dy);
    float part = dx * kg + dy * vf;
#pragma unroll
    for (int off = 16; off; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) atomicAdd(&dbs[r], part);
    const float dqg = dQg[chunk * C * D + r * D + c];
    const float dkh = dKh[chunk * C * D + r * D + c];
    dkr[m] = dkg * eg + dkh * eh;
    dqr[m] = dqg * eg;
    dGr[m] = dkg * kg + dqg * qf * eg - dkh * kf * eh;
    gpart += dkh * kf * eh;
  }
  gsum[r0 * D + c] = gpart;
  __syncthreads();

  // The pairs' terms: as row r (i <= r) and as column i = r (rows r' >= r).
#pragma unroll 1
  for (int m = 0; m < C / 2; ++m) {
    const int r = r0 + 2 * m;
    const float gr = G[r * D + c], kr = bf(ks[r * D + c]), qr = bf(qs[r * D + c]);
    // Two rows a step into two sums each, unrolled: the loads and
    // exponentials of several steps in flight, not one chain.
    float tk0 = 0.f, tk1 = 0.f, tq0 = 0.f, tq1 = 0.f, col0 = 0.f, col1 = 0.f;
    int i = 0;
#pragma unroll 2
    for (; i < r; i += 2) {      // i, i + 1 <= r; dAs[r][r] is zero
      const float e0 = exp2f(gr - G[i * D + c]) * bf(ks[i * D + c]);
      const float e1 = exp2f(gr - G[(i + 1) * D + c]) * bf(ks[(i + 1) * D + c]);
      tk0 += dAs[r * AP + i] * e0;
      tq0 += dPs[r * AP + i] * e0;
      tk1 += dAs[r * AP + i + 1] * e1;
      tq1 += dPs[r * AP + i + 1] * e1;
    }
    if (i == r) tq0 += dPs[r * AP + r] * bf(ks[r * D + c]);
    int rr = r;
#pragma unroll 2
    for (; rr + 1 < C; rr += 2) {
      const float e0 = exp2f(G[rr * D + c] - gr);
      const float e1 = exp2f(G[(rr + 1) * D + c] - gr);
      col0 += (dAs[rr * AP + r] * bf(ks[rr * D + c]) +
               dPs[rr * AP + r] * bf(qs[rr * D + c])) * e0;
      col1 += (dAs[(rr + 1) * AP + r] * bf(ks[(rr + 1) * D + c]) +
               dPs[(rr + 1) * AP + r] * bf(qs[(rr + 1) * D + c])) * e1;
    }
    if (rr < C)
      col0 += (dAs[rr * AP + r] * bf(ks[rr * D + c]) +
               dPs[rr * AP + r] * bf(qs[rr * D + c])) * exp2f(G[rr * D + c] - gr);
    const float tk = tk0 + tk1, tq = tq0 + tq1, col = col0 + col1;
    dkr[m] += tk + col;
    dqr[m] += tq;
    dGr[m] += kr * tk + qr * tq - kr * col;
  }
  if (r0 == 1)   // row C - 1 is m = C / 2 - 1 of the odd rows
    dGr[C / 2 - 1] += gsum[c] + gsum[D + c] + dgl[chunk * D + c] * exp2f(gL);

  // dq, dk out; dg = the reverse cumulative sum of dG over the rows.
#pragma unroll
  for (int m = 0; m < C / 2; ++m) {
    const int r = r0 + 2 * m, t = n * C + r;
    if (t < T) {
      dq[tok(b, t, h, T, H) + c] = __float2bfloat16(dqr[m]);
      dk[tok(b, t, h, T, H) + c] = __float2bfloat16(dkr[m]);
    }
    dGs[r * D + c] = dGr[m];
  }
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int r = C - 1; r >= 0; --r) {
      s += dGs[r * D + tid];
      const int t = n * C + r;
      if (t < T) dg[tok(b, t, h, T, H) + tid] = s;
    }
  }
  if (tid < C && n * C + tid < T)
    dbeta[(static_cast<size_t>(b) * T + n * C + tid) * H + h] = dbs[tid];
}

// ---------------------------------------------------------------------------
// C entry points: pointers, then B, T, H, then the stream. Each returns
// the CUDA error of its launch.
// ---------------------------------------------------------------------------

namespace {

constexpr size_t kIntraSmem = (C * D) * 4 + 3 * (C * D) * 2 + (C * AP + C) * 4;
constexpr size_t kStateFwdSmem = (D * DVB + 3 * C * D + C * C + C * DVB + D) * 4;
constexpr size_t kStateBwdSmem = (D * DVB + 3 * C * D + C * C + 2 * C * DVB + D) * 4;
constexpr size_t kDstateSmem = (C * D + D * (D + 1)) * 4;
constexpr size_t kIntraBwdSmem = (C * D) * 4 + 3 * (C * D) * 2 +
                                 (3 * C * AP + 2 * C + 2 * D + C * 2 * D + C * 33) * 4;

template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

int chunks(int T) { return (T + C - 1) / C; }

}  // namespace

extern "C" int kda_intra(const void* q, const void* k, const void* v,
                         const void* g, const void* beta, void* W, void* Ut,
                         void* Qg, void* Kh, void* P, void* glast, void* At,
                         int B, int T, int H, void* stream) {
  if (B * T * H == 0) return 0;
  if (int err = prepare(kda_intra_kernel, kIntraSmem)) return err;
  kda_intra_kernel<<<dim3(chunks(T), H, B), NT, kIntraSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<float*>(W),
      static_cast<float*>(Ut), static_cast<float*>(Qg), static_cast<float*>(Kh),
      static_cast<float*>(P), static_cast<float*>(glast), static_cast<float*>(At),
      T, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kda_state_fwd(const void* W, const void* Ut, const void* Qg,
                             const void* Kh, const void* P, const void* glast,
                             void* o, void* S0s, void* U, int B, int T, int H,
                             void* stream) {
  if (B * T * H == 0) return 0;
  if (int err = prepare(kda_state_fwd_kernel, kStateFwdSmem)) return err;
  kda_state_fwd_kernel<<<dim3(D / DVB, H, B), NT, kStateFwdSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(Ut),
      static_cast<const float*>(Qg), static_cast<const float*>(Kh),
      static_cast<const float*>(P), static_cast<const float*>(glast),
      static_cast<bf16*>(o), static_cast<float*>(S0s), static_cast<float*>(U),
      T, H, chunks(T));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kda_state_bwd(const void* Qg, const void* W, const void* Kh,
                             const void* P, const void* glast, const void* dO,
                             void* dSs, void* dU, int B, int T, int H,
                             void* stream) {
  if (B * T * H == 0) return 0;
  if (int err = prepare(kda_state_bwd_kernel, kStateBwdSmem)) return err;
  kda_state_bwd_kernel<<<dim3(D / DVB, H, B), NT, kStateBwdSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Qg), static_cast<const float*>(W),
      static_cast<const float*>(Kh), static_cast<const float*>(P),
      static_cast<const float*>(glast), static_cast<const bf16*>(dO),
      static_cast<float*>(dSs), static_cast<float*>(dU), T, H, chunks(T));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kda_dstate(const void* dO, const void* U, const void* dU,
                          const void* S0s, const void* dSs, void* dQg, void* dW,
                          void* dKh, void* dP, void* dglast, int B, int T, int H,
                          void* stream) {
  if (B * T * H == 0) return 0;
  if (int err = prepare(kda_dstate_kernel, kDstateSmem)) return err;
  kda_dstate_kernel<<<dim3(chunks(T), H, B * 4), NT, kDstateSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dO), static_cast<const float*>(U),
      static_cast<const float*>(dU), static_cast<const float*>(S0s),
      static_cast<const float*>(dSs), static_cast<float*>(dQg),
      static_cast<float*>(dW), static_cast<float*>(dKh), static_cast<float*>(dP),
      static_cast<float*>(dglast), T, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kda_intra_bwd(const void* q, const void* k, const void* v,
                             const void* g, const void* beta, const void* At,
                             const void* W, const void* Ut, const void* dQg,
                             const void* dW, const void* dU, const void* dKh,
                             const void* dP, const void* dglast, void* dq,
                             void* dk, void* dv, void* dg, void* dbeta, int B,
                             int T, int H, void* stream) {
  if (B * T * H == 0) return 0;
  if (int err = prepare(kda_intra_bwd_kernel, kIntraBwdSmem)) return err;
  kda_intra_bwd_kernel<<<dim3(chunks(T), H, B), NT, kIntraBwdSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<const float*>(At),
      static_cast<const float*>(W), static_cast<const float*>(Ut),
      static_cast<const float*>(dQg), static_cast<const float*>(dW),
      static_cast<const float*>(dU), static_cast<const float*>(dKh),
      static_cast<const float*>(dP), static_cast<const float*>(dglast),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dg), static_cast<float*>(dbeta), T, H);
  return static_cast<int>(cudaGetLastError());
}
