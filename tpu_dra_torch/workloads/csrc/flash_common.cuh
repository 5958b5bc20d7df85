// Shared pieces of the hand-written Hopper flash-attention kernels
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Tile geometry: one CTA of 4 warps owns a 64-row stationary tile (Q rows
// for fwd/dq, K/V rows for dkv); each warp owns 16 of those rows and runs
// the bf16 tensor-core product mma.sync.m16n8k16 with fp32 accumulation.
// The streamed side (K/V, or Q/dO) passes through shared memory in 64-row
// tiles. Fragment layouts are the PTX ISA's for m16n8k16 (g = lane / 4,
// t = lane % 4):
//   A (16x16, row-major): a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                         a2 = (g, 2t+8..)     a3 = (g+8, 2t+8..)
//   B (16x8, "col"):      b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8.., n g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1)   c2,c3 = (g+8, 2t..2t+1)
// A C fragment pair over 16 columns is exactly an A fragment over a
// 16-deep k chunk, so P (or dS) goes from the score accumulators into the
// next product without touching shared memory.
//
// Numerics follow the TPU kernels (tpu_dra/workloads/flashattention.py):
// roped q/k are rounded to bf16 before the dot, p and ds are rounded to
// bf16 before their products, scores are scaled after the dot, and masked
// scores take the finite value -1e30.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kBlock = 64;          // rows per tile, stationary and streamed
constexpr int kWarps = 4;           // 16 rows of the stationary tile each
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;             // bf16 per smem row: conflict-free loads

// Element strides of a [B, S, H, D] view whose D stride is 1.
struct Layout {
  long long b, s, h;
};

// Everything the three kernels read and write. Inputs q, k, v share the
// `in` layout (the model passes views of one fused qkv projection);
// dout/o/dq/dk/dv are [B, S, H, D] contiguous (`out`); lse, delta and
// dlse are [B, H, S] fp32. cos_t/sinm_t are the [S, D] rope tables
// (bf16, as the TPU kernels store them for bf16 inputs).
struct Params {
  const bf16 *q, *k, *v, *dout, *cos_t, *sinm_t;
  const float *lse_in, *delta, *dlse;
  bf16 *o, *dq, *dk, *dv;
  float *lse_out;
  int B, S, H;
  Layout in, out;
  int causal, rope;
  float sm_scale;
};

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b on the tensor cores (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major smem tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile,
                                       int r0, int k0, int lane) {
  const bf16* p = tile + (r0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * LD);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * LD + 8);
}

// B fragment with B[k][n] = Y[n0 + n][k0 + k]: Y holds one row per n (the
// K tile in Q.K^T, the V tile in dO.V^T), so k pairs are contiguous.
template <int LD>
__device__ __forceinline__ void load_b_rows_n(uint32_t b[2], const bf16* tile,
                                              int n0, int k0, int lane) {
  const bf16* p = tile + (n0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// B fragments of two adjacent n-tiles with B[k][n] = Z[k0 + k][n0 + n]: Z
// holds one row per k (V in P.V, K in dS.K, dO in P^T.dO, Q in dS^T.Q), so
// k pairs are strided; ldmatrix.trans gathers them. Lane l addresses row
// l % 8 of 8x8 matrix l / 8: matrices 0/1 are k rows 0-7/8-15 of n-tile
// n0, matrices 2/3 the same of n-tile n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_rows_k_x2(uint32_t b0[2], uint32_t b1[2],
                                                 const bf16* tile, int k0,
                                                 int n0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  const bf16* p = tile + (k0 + (m & 1) * 8 + r) * LD + n0 + (m >> 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// x * c + y * s in fp32 without contraction into an FMA, the rounding of
// the TPU kernels' `xf * cos + rolled * sinm`.
__device__ __forceinline__ float rot(float x, float c, float y, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
}

// Eight bf16 lanes of x * cos + partner * sinm, rounded to bf16.
__device__ __forceinline__ uint4 rope8(uint4 x, uint4 partner, uint4 c,
                                       uint4 s) {
  uint4 out;
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&partner);
  const __nv_bfloat162* cp = reinterpret_cast<const __nv_bfloat162*>(&c);
  const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(&s);
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(xp[i]);
    const float2 yf = __bfloat1622float2(yp[i]);
    const float2 cf = __bfloat1622float2(cp[i]);
    const float2 sf = __bfloat1622float2(sp[i]);
    op[i] = __floats2bfloat162_rn(rot(xf.x, cf.x, yf.x, sf.x),
                                  rot(xf.y, cf.y, yf.y, sf.y));
  }
  return out;
}

__device__ __forceinline__ uint4 ld_u128(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Copy rows [row0, row0 + kBlock) of one (b, h) slice (row stride
// `stride` elements) into a smem tile of pitch D + kPad, zero-filling rows
// at or past S: the ragged causal edge is masked here and by the score
// masks, so the wrapper never pads. With `rope`, the rows are rotated on
// the way in (position = row index): x * cos + roll(x, D/2) * sinm, the
// TPU kernels' _rope_apply, so roped q/k exist only in shared memory.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* src,
                                           long long stride, int row0, int S,
                                           const bf16* cos_t,
                                           const bf16* sinm_t, bool rope) {
  constexpr int LD = D + kPad;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (!rope) {
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int row = row0 + r;
      const uint4 x = row < S ? ld_u128(src + row * stride + c) : zero;
      *reinterpret_cast<uint4*>(tile + r * LD + c) = x;
    }
    return;
  }
  constexpr int kHalf = D / 2;
  constexpr int kChunks = kHalf / 8;  // each thread rotates a (c, c+D/2) pair
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = row0 + r;
    uint4 lo = zero, hi = zero;
    if (row < S) {
      const bf16* x = src + row * stride;
      const bf16* ct = cos_t + (long long)row * D;
      const bf16* st = sinm_t + (long long)row * D;
      const uint4 xl = ld_u128(x + c), xh = ld_u128(x + c + kHalf);
      lo = rope8(xl, xh, ld_u128(ct + c), ld_u128(st + c));
      hi = rope8(xh, xl, ld_u128(ct + c + kHalf), ld_u128(st + c + kHalf));
    }
    *reinterpret_cast<uint4*>(tile + r * LD + c) = lo;
    *reinterpret_cast<uint4*>(tile + r * LD + c + kHalf) = hi;
  }
}

// The inverse rotation (the VJP of the forward one) applied in registers
// to a warp's fp32 accumulator over 16 rows x D: column j's partner j+D/2
// sits in n-tile (jt + D/16) of the same thread, so the roll needs no
// data exchange. rows: the global positions of fragment rows g and g+8.
template <int D>
__device__ __forceinline__ void rope_inverse(float acc[D / 8][4],
                                             const bf16* cos_t,
                                             const bf16* sinm_t, int row_g,
                                             int row_g8, int S, int lane) {
  constexpr int kHalfTiles = D / 16;
  const int t = lane & 3;
#pragma unroll
  for (int jt = 0; jt < kHalfTiles; ++jt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_g8 : row_g;
      if (row >= S) continue;
      const int col = jt * 8 + 2 * t;
      const float2 c_lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(cos_t + (long long)row * D + col));
      const float2 c_hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          cos_t + (long long)row * D + col + D / 2));
      const float2 s_lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          sinm_t + (long long)row * D + col));
      const float2 s_hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          sinm_t + (long long)row * D + col + D / 2));
      float* lo = &acc[jt][2 * half];
      float* hi = &acc[jt + kHalfTiles][2 * half];
      const float l0 = lo[0], l1 = lo[1], h0 = hi[0], h1 = hi[1];
      lo[0] = rot(l0, c_lo.x, h0, -s_lo.x);
      lo[1] = rot(l1, c_lo.y, h1, -s_lo.y);
      hi[0] = rot(h0, c_hi.x, l0, -s_hi.x);
      hi[1] = rot(h1, c_hi.y, l1, -s_hi.y);
    }
  }
}

// Store a warp's fp32 accumulator (16 rows x D) as bf16 rows of a
// [B, S, H, D] contiguous output; rows at or past S are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           const float acc[D / 8][4],
                                           int row_g, int row_g8, int S,
                                           int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int jt = 0; jt < D / 8; ++jt) {
    const int col = jt * 8 + 2 * t;
    if (row_g < S)
      *reinterpret_cast<uint32_t*>(dst + row_g * stride + col) =
          pack_bf16(acc[jt][0], acc[jt][1]);
    if (row_g8 < S)
      *reinterpret_cast<uint32_t*>(dst + row_g8 * stride + col) =
          pack_bf16(acc[jt][2], acc[jt][3]);
  }
}

// Instantiate `launch<D>` for every head dim the kernels take: a multiple
// of 16 (the mma depth, and D/2 a whole number of 8-column n-tiles) up to
// 128 (the register budget of the fp32 accumulators).
template <template <int> class Launch>
cudaError_t dispatch_head_dim(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return Launch<16>::run(p, stream);
    case 32: return Launch<32>::run(p, stream);
    case 48: return Launch<48>::run(p, stream);
    case 64: return Launch<64>::run(p, stream);
    case 80: return Launch<80>::run(p, stream);
    case 96: return Launch<96>::run(p, stream);
    case 112: return Launch<112>::run(p, stream);
    case 128: return Launch<128>::run(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline Params make_params(int B, int S, int H, int D, long long in_b,
                          long long in_s, long long in_h, int causal,
                          int rope) {
  Params p = {};
  p.B = B;
  p.S = S;
  p.H = H;
  p.in = Layout{in_b, in_s, in_h};
  p.out = Layout{(long long)S * H * D, (long long)H * D, (long long)D};
  p.causal = causal;
  p.rope = rope;
  // 1/sqrt(D) rounded once from double, as the TPU kernels' Python float.
  p.sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return p;
}

}  // namespace flash
