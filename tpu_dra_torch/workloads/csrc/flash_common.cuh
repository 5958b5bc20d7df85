// Shared pieces of the hand-written mma.sync flash-attention kernels
// (flash_fwd.cu, flash_bwd_mma.cu), for bf16 and fp32 inputs (the element
// type T is a template parameter throughout); the wgmma kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu) take its scalar helpers (bf16
// packing, rot, ld_pair).
//
// Tile geometry: a CTA of eight warps owns a 64-row stationary tile (Q
// rows for fwd, K/V rows for bwd) and runs warp-level tensor-core
// products (mma.sync) with fp32 accumulation. The streamed side (K/V, or
// Q/dO) passes through shared memory in 64-row tiles, in a two-stage
// cp.async ring. Shared memory holds a few tiles whatever S is, and every
// global offset is 64-bit, so one kernel serves every sequence length.
//
// bf16 products: mma.sync.m16n8k16. Fragment layouts are the PTX ISA's
// (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                         a2 = (g, 2t+8..)     a3 = (g+8, 2t+8..)
//   B (16x8, "col"):      b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8.., n g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1)   c2,c3 = (g+8, 2t..2t+1)
// A C fragment pair over 16 columns is exactly an A fragment over a
// 16-deep k chunk, so P (or dS) goes from the score accumulators into the
// next product without touching shared memory.
//
// fp32 products: three TF32 tensor-core products per fp32 product
// (mma.sync.m16n8k8 .tf32), x = hi + lo with hi = x & 0xffffe000 (x
// truncated to TF32: one integer op) and lo = x - hi (exact in fp32; the
// tensor cores read its top 10 mantissa bits), a.b = a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi; the dropped a_lo.b_lo term and lo's own
// truncation cost at most ~3 * 2^-20 of a product
// (tests/test_torch_bwd_mma.py and test_torch_fwd_mma.py emulate it).
// Each operand is split once where it is loaded, and a score-shaped
// accumulator (P, dS) once per tile. Why not one TF32 pass: it keeps ~3
// decimal digits, a different function from the reference's fp32 dot.
// Why not FFMA on the CUDA cores: the split keeps the bf16 path's warp
// tiling and runs at 495/3 = 165 TFLOP/s of tensor-core peak, against 67
// TFLOP/s of fp32 FFMA. m16n8k8's layouts:
//   A (16x8):  a0 = (g, t)  a1 = (g+8, t)  a2 = (g, t+4)  a3 = (g+8, t+4)
//   B (8x8):   b0 = (k t, n g)  b1 = (k t+4, n g)
//   C:         as above
// The C layout does not match A's, so where P (or dS) feeds the next
// product the k slots are permuted instead of shuffling data: slot t
// holds column 2t and slot t+4 column 2t+1 of the 8-wide C tile, and the
// B fragment of that product reads rows 2t and 2t+1 to match (a sum over
// k does not care in which slot each k sits). The same rows also make
// those B loads bank-conflict-free at a row pitch of D + 4 floats. The
// tensor cores round each fp32 accumulation toward zero, so the long sums
// over streamed tiles are summed per tile in fresh registers and added up
// in IEEE fp32, once per tile.
//
// Numerics follow the TPU kernels (tpu_dra/workloads/flashattention.py):
// roped q/k are rounded to the input type before the dot, p and ds are
// rounded to the input type before their products (nothing rounds for
// fp32), scores are scaled after the dot, and masked scores take the
// finite value -1e30.
#pragma once

#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kBlock = 64;          // rows per tile, stationary and streamed
constexpr int kThreads = 128;       // stage_tile's threads, by default

// Per element type: the depth of one mma and the smem row padding that
// keeps fragment loads bank-conflict-free (16 bytes either way, so rows
// stay 16-byte aligned).
template <typename T> struct Elem;
template <> struct Elem<bf16> {
  static constexpr int kDepth = 16;
  static constexpr int kPad = 8;
};
template <> struct Elem<float> {
  static constexpr int kDepth = 8;
  static constexpr int kPad = 4;
};

// Element strides of a [B, S, H, D] view whose D stride is 1.
struct Layout {
  long long b, s, h;
};

// Everything the kernels read and write. Inputs q, k, v share the `in`
// layout (the model passes views of one fused qkv projection);
// dout/o/dq/dk/dv are [B, S, H, D] contiguous (`out`), as are the
// backward's fp32 dQ accumulator dq_acc and the forward's roped-k
// scratch kr; lse, delta and dlse are [B, H, S] fp32. cos_t/sinm_t are
// the [S, D] rope tables, in the input type, as the TPU kernels store
// them.
template <typename T>
struct Params {
  const T *q, *k, *v, *dout, *cos_t, *sinm_t;
  const float *lse_in, *delta, *dlse;
  T *o, *dq, *dk, *dv, *kr;
  float *lse_out, *dq_acc;
  int B, S, H;
  Layout in, out;
  int causal, rope;
  float sm_scale;
};

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent elements as fp32, and their store from fp32.
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void st_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------------------
// Fragments and products. The kernels are written once against these
// overloads; FragA<T>/FragB<T> are the A and B operands of one mma step
// of depth Elem<T>::kDepth.
// ---------------------------------------------------------------------------

template <typename T> struct FragA;
template <typename T> struct FragB;
template <> struct FragA<bf16> { uint32_t x[4]; };
template <> struct FragB<bf16> { uint32_t x[2]; };
template <> struct FragA<float> { uint32_t hi[4], lo[4]; };
template <> struct FragB<float> { uint32_t hi[2], lo[2]; };

// c += a * b on the tensor cores (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma(float c[4], const FragA<bf16>& a,
                                    const FragB<bf16>& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
        "r"(b.x[1]));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b to fp32 accuracy: the small cross terms first, then the
// large one.
__device__ __forceinline__ void mma(float c[4], const FragA<float>& a,
                                    const FragB<float>& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// x = hi + lo: hi = x truncated to TF32, lo = x - hi (exact in fp32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A fragment of rows r0..r0+15, columns k0..k0+depth-1 of a row-major
// smem tile.
template <int LD>
__device__ __forceinline__ void load_a(FragA<bf16>& a, const bf16* tile,
                                       int r0, int k0, int lane) {
  const bf16* p = tile + (r0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  a.x[0] = ld_u32(p);
  a.x[1] = ld_u32(p + 8 * LD);
  a.x[2] = ld_u32(p + 8);
  a.x[3] = ld_u32(p + 8 * LD + 8);
}

template <int LD>
__device__ __forceinline__ void load_a(FragA<float>& a, const float* tile,
                                       int r0, int k0, int lane) {
  const float* p = tile + (r0 + (lane >> 2)) * LD + k0 + (lane & 3);
  split(p[0], a.hi[0], a.lo[0]);
  split(p[8 * LD], a.hi[1], a.lo[1]);
  split(p[4], a.hi[2], a.lo[2]);
  split(p[8 * LD + 4], a.hi[3], a.lo[3]);
}

// B fragment with B[k][n] = Y[n0 + n][k0 + k]: Y holds one row per n (the
// K tile in Q.K^T, the V tile in dO.V^T), so k runs along a row.
template <int LD>
__device__ __forceinline__ void load_b_rows_n(FragB<bf16>& b, const bf16* tile,
                                              int n0, int k0, int lane) {
  const bf16* p = tile + (n0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  b.x[0] = ld_u32(p);
  b.x[1] = ld_u32(p + 8);
}

template <int LD>
__device__ __forceinline__ void load_b_rows_n(FragB<float>& b,
                                              const float* tile, int n0,
                                              int k0, int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * LD + k0 + (lane & 3);
  split(p[0], b.hi[0], b.lo[0]);
  split(p[4], b.hi[1], b.lo[1]);
}

// B fragments of two adjacent n-tiles with B[k][n] = Z[k0 + k][n0 + n]: Z
// holds one row per k (V in P.V, K in dS.K, dO in P^T.dO, Q in dS^T.Q).
// bf16: k pairs are strided, so ldmatrix.trans gathers them. Lane l
// addresses row l % 8 of 8x8 matrix l / 8: matrices 0/1 are k rows 0-7/
// 8-15 of n-tile n0, matrices 2/3 the same of n-tile n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_rows_k_x2(FragB<bf16>& b0,
                                                 FragB<bf16>& b1,
                                                 const bf16* tile, int k0,
                                                 int n0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  const bf16* p = tile + (k0 + (m & 1) * 8 + r) * LD + n0 + (m >> 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b0.x[0]), "=r"(b0.x[1]), "=r"(b1.x[0]), "=r"(b1.x[1])
      : "r"(addr)
      : "memory");
}

// fp32: the permuted k slots of the header (slot t = row k0 + 2t, slot
// t + 4 = row k0 + 2t + 1), matching a_from_c.
template <int LD>
__device__ __forceinline__ void load_b_rows_k_x2(FragB<float>& b0,
                                                 FragB<float>& b1,
                                                 const float* tile, int k0,
                                                 int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  split(p[0], b0.hi[0], b0.lo[0]);
  split(p[LD], b0.hi[1], b0.lo[1]);
  split(p[8], b1.hi[0], b1.lo[0]);
  split(p[LD + 8], b1.hi[1], b1.lo[1]);
}

// One n-tile of the same B: fp32 in the permuted k slots; bf16 by
// ldmatrix.trans of k rows k0..k0+7 and k0+8..k0+15 at column n0 (lanes
// 0-7 and 8-15 address them; the other lanes repeat them).
template <int LD>
__device__ __forceinline__ void load_b_rows_k(FragB<float>& b,
                                              const float* tile, int k0,
                                              int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  split(p[0], b.hi[0], b.lo[0]);
  split(p[LD], b.hi[1], b.lo[1]);
}

template <int LD>
__device__ __forceinline__ void load_b_rows_k(FragB<bf16>& b,
                                              const bf16* tile, int k0,
                                              int n0, int lane) {
  const bf16* p = tile + (k0 + (lane & 15)) * LD + n0;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b.x[0]), "=r"(b.x[1])
      : "r"(addr)
      : "memory");
}

// The A fragment of k-step kk of a product whose A is a warp's fp32
// score-shaped accumulator c[n-tile][4] (P or dS, 16 rows x 8 per
// n-tile), rounded to the input type. bf16: n-tiles 2kk and 2kk+1 pack
// into one 16-deep fragment. fp32: n-tile kk, in the permuted k slots.
__device__ __forceinline__ void a_from_c(FragA<bf16>& a, const float (*c)[4],
                                         int kk) {
  a.x[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a.x[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a.x[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a.x[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

__device__ __forceinline__ void a_from_c(FragA<float>& a, const float (*c)[4],
                                         int kk) {
  split(c[kk][0], a.hi[0], a.lo[0]);  // (g, slot t) = column 2t
  split(c[kk][2], a.hi[1], a.lo[1]);  // (g + 8, slot t)
  split(c[kk][1], a.hi[2], a.lo[2]);  // (g, slot t + 4) = column 2t+1
  split(c[kk][3], a.hi[3], a.lo[3]);  // (g + 8, slot t + 4)
}

// acc[j] += bf16(C) . Z[z0 .. z0 + KSTEPS * 16) for every 8-column n-tile
// j of D: C is a warp's score-shaped fp32 accumulator (P, 16 rows,
// c[n-tile][4]) and Z a bf16 smem tile with one row per k (V in P.V).
// bf16 products are exact in fp32 and round once into acc.
template <int D, int LD, int KSTEPS>
__device__ __forceinline__ void mma_c_rows(float acc[D / 8][4],
                                           const float (*c)[4], const bf16* z,
                                           int z0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    FragA<bf16> a;
    a_from_c(a, c, kk);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      FragB<bf16> b0, b1;
      load_b_rows_k_x2<LD>(b0, b1, z, z0 + kk * Elem<bf16>::kDepth, j * 8,
                           lane);
      mma(acc[j], a, b0);
      mma(acc[j + 1], a, b1);
    }
  }
}

// cp.async of 16 or 4 bytes into shared memory, zero-filled where `real`
// is false (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool real) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(real ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool real) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(real ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// One 16-byte chunk (8 bf16 or 4 fp32) of x * cos + partner * sinm,
// computed in fp32 and rounded to T.
template <typename T>
__device__ __forceinline__ uint4 rope16(uint4 x, uint4 partner, uint4 c,
                                        uint4 s) {
  constexpr int N = 16 / sizeof(T);
  uint4 out;
  const T* xp = reinterpret_cast<const T*>(&x);
  const T* yp = reinterpret_cast<const T*>(&partner);
  const T* cp = reinterpret_cast<const T*>(&c);
  const T* sp = reinterpret_cast<const T*>(&s);
  T* op = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int i = 0; i < N; ++i)
    op[i] = from_f32<T>(rot(to_f32(xp[i]), to_f32(cp[i]), to_f32(yp[i]),
                            to_f32(sp[i])));
  return out;
}

template <typename T>
__device__ __forceinline__ uint4 ld_u128(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Copy rows [row0, row0 + kBlock) of one (b, h) slice (row stride
// `stride` elements) into a smem tile of pitch LD, zero-filling rows at or
// past S: the ragged causal edge is masked here and by the score masks,
// so the wrapper never pads. With `rope`, the rows are rotated on the way
// in (position = row index): x * cos + roll(x, D/2) * sinm, the TPU
// kernels' _rope_apply, so roped q/k exist only in shared memory. Threads
// 0 .. NT-1 share the work.
template <typename T, int D, int LD = D + Elem<T>::kPad, int NT = kThreads>
__device__ __forceinline__ void stage_tile(T* tile, const T* src,
                                           long long stride, int row0, int S,
                                           const T* cos_t, const T* sinm_t,
                                           bool rope) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte chunk
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (!rope) {
    constexpr int kChunks = D / kVec;
    for (int i = threadIdx.x; i < kBlock * kChunks; i += NT) {
      const int r = i / kChunks, c = (i % kChunks) * kVec;
      const int row = row0 + r;
      const uint4 x = row < S ? ld_u128(src + row * stride + c) : zero;
      *reinterpret_cast<uint4*>(tile + r * LD + c) = x;
    }
    return;
  }
  constexpr int kHalf = D / 2;
  constexpr int kChunks = kHalf / kVec;  // a thread rotates a (c, c+D/2) pair
  for (int i = threadIdx.x; i < kBlock * kChunks; i += NT) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const int row = row0 + r;
    uint4 lo = zero, hi = zero;
    if (row < S) {
      const T* x = src + row * stride;
      const T* ct = cos_t + (long long)row * D;
      const T* st = sinm_t + (long long)row * D;
      const uint4 xl = ld_u128(x + c), xh = ld_u128(x + c + kHalf);
      lo = rope16<T>(xl, xh, ld_u128(ct + c), ld_u128(st + c));
      hi = rope16<T>(xh, xl, ld_u128(ct + c + kHalf), ld_u128(st + c + kHalf));
    }
    *reinterpret_cast<uint4*>(tile + r * LD + c) = lo;
    *reinterpret_cast<uint4*>(tile + r * LD + c + kHalf) = hi;
  }
}

// The inverse rotation (the VJP of the forward one) applied in registers
// to a warp's fp32 accumulator over 16 rows x D: column j's partner j+D/2
// sits in n-tile (jt + D/16) of the same thread, so the roll needs no
// data exchange. rows: the global positions of fragment rows g and g+8.
template <typename T, int D>
__device__ __forceinline__ void rope_inverse(float acc[D / 8][4],
                                             const T* cos_t, const T* sinm_t,
                                             int row_g, int row_g8, int S,
                                             int lane) {
  constexpr int kHalfTiles = D / 16;
  const int t = lane & 3;
#pragma unroll
  for (int jt = 0; jt < kHalfTiles; ++jt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_g8 : row_g;
      if (row >= S) continue;
      const long long at = (long long)row * D + jt * 8 + 2 * t;
      const float2 c_lo = ld_pair(cos_t + at);
      const float2 c_hi = ld_pair(cos_t + at + D / 2);
      const float2 s_lo = ld_pair(sinm_t + at);
      const float2 s_hi = ld_pair(sinm_t + at + D / 2);
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

// Store a warp's fp32 accumulator (16 rows x D) as rows of T in a
// [B, S, H, D] contiguous output; rows at or past S are dropped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, long long stride,
                                           const float acc[D / 8][4],
                                           int row_g, int row_g8, int S,
                                           int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int jt = 0; jt < D / 8; ++jt) {
    const int col = jt * 8 + 2 * t;
    if (row_g < S) st_pair(dst + row_g * stride + col, acc[jt][0], acc[jt][1]);
    if (row_g8 < S)
      st_pair(dst + row_g8 * stride + col, acc[jt][2], acc[jt][3]);
  }
}

// xr = rope(x) as stage_tile rotates it (rounded to T), [B, S, H, D]
// contiguous, from x in the `in` layout: the one rotation of the streamed
// operand (q in the backward, k in the forward), so that its tiles need
// none. One thread per 16-byte chunk of a row's first half and its
// partner D/2 away.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    rope_rows_kernel(const T* x, Layout in, const T* cos_t, const T* sinm_t,
                     T* xr, long long rows, int S, int H) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / 2 / kVec;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= rows * kChunks) return;
  const long long r = i / kChunks;   // [B, S, H] row
  const int c = static_cast<int>(i % kChunks) * kVec;
  const int h = static_cast<int>(r % H);
  const int s = static_cast<int>((r / H) % S);
  const long long b = r / ((long long)H * S);
  const T* src = x + b * in.b + s * in.s + h * in.h;
  const T* ct = cos_t + (long long)s * D;
  const T* st = sinm_t + (long long)s * D;
  const uint4 xl = ld_u128(src + c), xh = ld_u128(src + c + D / 2);
  *reinterpret_cast<uint4*>(xr + r * D + c) =
      rope16<T>(xl, xh, ld_u128(ct + c), ld_u128(st + c));
  *reinterpret_cast<uint4*>(xr + r * D + c + D / 2) =
      rope16<T>(xh, xl, ld_u128(ct + c + D / 2), ld_u128(st + c + D / 2));
}

template <typename T, int D>
cudaError_t rope_rows(const Params<T>& p, const T* x, T* xr,
                      cudaStream_t stream) {
  const long long rows = (long long)p.B * p.S * p.H;
  const long long threads = rows * (D / 2 / (16 / sizeof(T)));
  rope_rows_kernel<T, D><<<(unsigned)((threads + 255) / 256), 256, 0,
                           stream>>>(x, p.in, p.cos_t, p.sinm_t, xr, rows,
                                     p.S, p.H);
  return cudaGetLastError();
}

// The C entry points' operands, untyped until the element type is known.
struct Operands {
  const void *q, *k, *v, *dout, *cos_t, *sinm_t;
  const float *lse_in, *delta, *dlse;
  void *o, *dq, *dk, *dv, *kr;
  float *lse_out, *dq_acc;
};

struct Shape {
  int B, S, H, D;
  long long in_b, in_s, in_h;
  int causal, rope;
};

template <typename T>
Params<T> make_params(const Operands& x, const Shape& sh) {
  Params<T> p = {};
  p.q = static_cast<const T*>(x.q);
  p.k = static_cast<const T*>(x.k);
  p.v = static_cast<const T*>(x.v);
  p.dout = static_cast<const T*>(x.dout);
  p.cos_t = static_cast<const T*>(x.cos_t);
  p.sinm_t = static_cast<const T*>(x.sinm_t);
  p.lse_in = x.lse_in;
  p.delta = x.delta;
  p.dlse = x.dlse;
  p.o = static_cast<T*>(x.o);
  p.dq = static_cast<T*>(x.dq);
  p.dk = static_cast<T*>(x.dk);
  p.dv = static_cast<T*>(x.dv);
  p.kr = static_cast<T*>(x.kr);
  p.lse_out = x.lse_out;
  p.dq_acc = x.dq_acc;
  p.B = sh.B;
  p.S = sh.S;
  p.H = sh.H;
  p.in = Layout{sh.in_b, sh.in_s, sh.in_h};
  p.out = Layout{(long long)sh.S * sh.H * sh.D, (long long)sh.H * sh.D,
                 (long long)sh.D};
  p.causal = sh.causal;
  p.rope = sh.rope;
  // 1/sqrt(D) rounded once from double, as the TPU kernels' Python float.
  p.sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(sh.D)));
  return p;
}

// Instantiate `Launch<T, D>` for every head dim the kernels take. bf16: a
// multiple of 16 (the bf16 mma depth, and D/2 a whole number of 8-column
// n-tiles) up to 128 (the register budget of the fp32 accumulators).
// fp32: only 16 (the reference's streaming-tier test shape) and 128 (the
// flagship's head dim), the ones a caller uses; each fp32 instance costs
// several seconds of nvcc time (_flash_kernels.FP32_HEAD_DIMS).
template <typename T, template <typename, int> class Launch>
cudaError_t dispatch_head_dim(int D, const Params<T>& p, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {
    switch (D) {
      case 16: return Launch<T, 16>::run(p, stream);
      case 128: return Launch<T, 128>::run(p, stream);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 16: return Launch<T, 16>::run(p, stream);
      case 32: return Launch<T, 32>::run(p, stream);
      case 48: return Launch<T, 48>::run(p, stream);
      case 64: return Launch<T, 64>::run(p, stream);
      case 80: return Launch<T, 80>::run(p, stream);
      case 96: return Launch<T, 96>::run(p, stream);
      case 112: return Launch<T, 112>::run(p, stream);
      case 128: return Launch<T, 128>::run(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

// Dispatch on (element type, D): elem_bytes 2 is bf16, 4 is fp32.
template <template <typename, int> class Launch>
int dispatch(int elem_bytes, const Operands& x, const Shape& sh,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: return static_cast<int>(
        dispatch_head_dim<bf16, Launch>(sh.D, make_params<bf16>(x, sh), s));
    case 4: return static_cast<int>(
        dispatch_head_dim<float, Launch>(sh.D, make_params<float>(x, sh), s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
