// Flash-attention backward for Hopper (sm_90a) on mma.sync, bf16 or fp32
// inputs, as one fused pass: each CTA keeps one 64-key K/V tile
// stationary and streams the 64-row Q/dO tiles that attend to it,
// computing dK and dV in registers and adding its dQ partials into an
// fp32 accumulator; a last launch in the same C entry turns the
// accumulator into dq.
//
// Replaces tpu_dra/workloads/flashattention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (reached through _flash_bwd_rule) and
// _bwd_dq_stream_kernel and _bwd_dkv_stream_kernel (_bwd_calls_stream):
// it streams Q/dO through shared memory at every S, so it is the
// counterpart of both tiers. It serves fp32 inputs (D 16 and 128) and
// bf16 at the head dims other than 64 and 128; bf16 at D 64 and 128,
// every model path, runs flash_bwd_sm90.cu (_flash_kernels.bwd_route).
//
// What bounds it on the H100: five products per (query, key) pair, 10 * D
// FLOPs. fp32 runs each product as three TF32 products (flash_common.cuh),
// so its bound is those FLOPs over 495/3 TFLOP/s: at B1 S8192 H2 D128,
// causal, 85.9 GFLOP in 0.52 ms. The tensor cores, not the 42 MB of
// operands, bound it.
//
// What the design does about it:
// 1. One pass. Per K tile and Q tile, S^T = K.Q^T and dP^T = V.dO^T are
//    computed once (the dq/dkv split computed them in both kernels, 14 * D
//    FLOPs per pair against 10). Eight warps: warp w owns keys
//    16 (w % 4) .. +15 and queries 32 (w / 4) .. +31 of each Q tile, so
//    P^T and dS^T come out of its accumulators in A-fragment layout for
//    dV += P^T.dO and dK += dS^T.Q, and the two warps of one key group
//    hold partial dK, dV over disjoint queries, added in a fixed order at
//    the end. dS^T goes through shared memory for dQ = dS.K, which the
//    eight warps share by 16 query rows x D/2 columns.
// 2. dQ reduction. Every CTA adds its [64 x D] dQ partial of each Q tile
//    into the [B, S, H, D] fp32 accumulator with vector atomics
//    (red.global.add.v2.f32); the epilogue scales, inverse-rotates and
//    rounds it once. dQ's sums run in an order that changes from run to
//    run; dK and dV are summed by one CTA in a fixed order and are
//    reproducible bit for bit.
// 3. Asynchronous staging. Q/dO tiles and their lse, dlse and delta rows
//    arrive by cp.async in a ring of two stages: tile i + 1 lands while
//    tile i's products run. With RoPE, a first launch writes the roped q
//    once into the dq buffer (free until the epilogue), so the streamed
//    tiles need no rotation; K is rotated once per CTA as it is staged.
// 4. Split once, at full rate. fp32 operands split as hi = x & 0xffffe000
//    (a truncation to TF32: one integer op) and lo = x - hi (exact); the
//    tensor cores read lo's top 10 mantissa bits. P^T and dS^T are split
//    once per tile in registers, not once per use. The 3-term product then
//    drops at most ~3 * 2^-20 of each product (tests/test_torch_bwd_mma.py
//    emulates it against float64).
// 5. Resources. 64-key tiles and 256 threads: the fp32 dK and dV
//    accumulators take 128 registers a thread at D=128, the CTA 217 KB of
//    shared memory (K, V, two stages of Q and dO, dS^T), one CTA and eight
//    warps per SM. The grid's y axis is the K tile, so the causal CTAs with
//    the most Q tiles launch first and the light ones fill in behind them.
//
// Rounding points are bwd_dq_plain's and bwd_dkv_plain's: roped q/k
// rounded to the input type before the dots, scores scaled after them,
// masked scores -1e30 (on the diagonal and ragged tiles; queries and keys
// >= S are masked in every mode), P and dS rounded to the input type
// before their products, dK and dQ scaled, inverse-rotated in fp32 and
// rounded once, dV rounded once. The sums run in another order than the
// plain versions' (tile by tile; dQ over K tiles in no fixed order).
#include "flash_common.cuh"

namespace bwd_mma {

using flash::bf16;
using flash::Elem;
using flash::FragA;
using flash::FragB;
using flash::kNegInf;
using flash::Layout;

constexpr int kKeys = 64;      // keys per CTA (stationary K/V tile)
constexpr int kQ = 64;         // queries per streamed tile
constexpr int kSub = 32;       // queries of a tile per warp
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;

// The A fragment of dS (query m x key k) at keys k0.., queries m0.., read
// from dS^T stored [key][query]. fp32 in the permuted k slots (matching
// load_b_rows_k); bf16 by ldmatrix.trans: matrices 0-3 are (keys k0..7,
// queries m0..7), (k0..7, m0+8..15), (k0+8..15, m0..7), (k0+8..15,
// m0+8..15).
template <int LD>
__device__ __forceinline__ void ld_a_t(FragA<float>& a, const float* ds_t,
                                       int k0, int m0, int lane) {
  const float* p = ds_t + (k0 + 2 * (lane & 3)) * LD + m0 + (lane >> 2);
  flash::split(p[0], a.hi[0], a.lo[0]);       // (g, slot t)
  flash::split(p[8], a.hi[1], a.lo[1]);       // (g + 8, slot t)
  flash::split(p[LD], a.hi[2], a.lo[2]);      // (g, slot t + 4)
  flash::split(p[LD + 8], a.hi[3], a.lo[3]);  // (g + 8, slot t + 4)
}

template <int LD>
__device__ __forceinline__ void ld_a_t(FragA<bf16>& a, const bf16* ds_t,
                                       int k0, int m0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  const bf16* p = ds_t + (k0 + (m >> 1) * 8 + r) * LD + m0 + (m & 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a.x[0]), "=r"(a.x[1]), "=r"(a.x[2]), "=r"(a.x[3])
      : "r"(addr)
      : "memory");
}

// The A fragments of a warp's 16 x 32 score-shaped accumulator c (P^T or
// dS^T), rounded to the input type, for all k steps at once: fp32 splits
// each value once (flash::a_from_c's permuted slots), bf16 packs.
template <typename T> struct ScoreA {
  static constexpr int kSteps = kSub / Elem<T>::kDepth;
  FragA<T> a[kSteps];
};

template <typename T>
__device__ __forceinline__ void to_a(ScoreA<T>& s, const float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < ScoreA<T>::kSteps; ++kk)
    flash::a_from_c(s.a[kk], c, kk);
}

// acc[j] += T(C) . Z[z0 .. z0 + 32) for every n-tile j of D, Z a tile with
// one row per k (dO in P^T.dO, Q in dS^T.Q). The tensor cores round each
// fp32 accumulation toward zero, so each tile's products are summed in
// fresh registers and added to acc in IEEE fp32 (flash_common.cuh).
template <typename T, int D, int LD>
__device__ __forceinline__ void add_c_rows(float (*acc)[4], const ScoreA<T>& s,
                                           const T* z, int z0, int lane) {
#pragma unroll
  for (int j = 0; j < D / 8; j += 2) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < ScoreA<T>::kSteps; ++kk) {
      FragB<T> b0, b1;
      flash::load_b_rows_k_x2<LD>(b0, b1, z, z0 + kk * Elem<T>::kDepth,
                                  j * 8, lane);
      flash::mma(t0, s.a[kk], b0);
      flash::mma(t1, s.a[kk], b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] += t0[e];
      acc[j + 1][e] += t1[e];
    }
  }
}

// Shared memory, in elements of T unless named: K, V, kStages x (Q, dO),
// dS^T [key][query], then fp32 kStages x (lse, dlse, delta) rows. At
// D=128 fp32: 216.5 KB.
template <typename T, int D>
struct Smem {
  static constexpr int kLd = D + Elem<T>::kPad;
  static constexpr int kTile = kKeys * kLd;
  // dS^T pitch: fp32 68 keeps ld_a_t's and the C-fragment stores'
  // banks apart in the permuted slots, bf16 72 ldmatrix's rows.
  static constexpr int kLdDs = kQ + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int kK = 0, kV = kTile, kStage0 = 2 * kTile;
  static constexpr int kDs = kStage0 + kStages * 2 * kTile;
  static constexpr int kEnd = kDs + kKeys * kLdDs;
  static constexpr int kRowsBytes = kStages * 3 * kQ * 4;
  static constexpr int kBytes = kEnd * (int)sizeof(T) + kRowsBytes;
  // The dK and dV partials of warps 4-7, fp32 [key][D + 4], reuse the
  // stage area after the loop.
  static constexpr int kRedLd = D + 4;
  static_assert(2 * kKeys * kRedLd * 4 <= kStages * 2 * kTile * (int)sizeof(T),
                "dK/dV partials do not fit the stage area");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_mma_kernel(const flash::Params<T> p, const T* q_src,
                         Layout q_l) {
  using L = Smem<T, D>;
  constexpr int LD = L::kLd;
  constexpr int kDepth = Elem<T>::kDepth;
  constexpr int NT = D / 8;
  constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte chunk
  constexpr int kChunks = D / kVec;       // chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* base = reinterpret_cast<T*>(smem);
  T* Ks = base + L::kK;
  T* Vs = base + L::kV;
  T* ds_t = base + L::kDs;
  float* rows_s = reinterpret_cast<float*>(base + L::kEnd);

  const int n_tiles = (p.S + kQ - 1) / kQ;
  const int kt = blockIdx.y;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = kt * kKeys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, g = lane >> 2;
  const int kg = warp & 3;            // key group: keys 16 kg .. +15
  const int c0 = (warp >> 2) * kSub;  // this warp's queries in a tile
  const int key_g = k0 + kg * 16 + g, key_g8 = key_g + 8;
  const T* qs = q_src + b * q_l.b + h * q_l.h;
  const T* dout = p.dout + b * p.out.b + h * p.out.h;
  const float* lse_row = p.lse_in + (long long)bh * p.S;
  const float* delta_row = p.delta + (long long)bh * p.S;
  const float* dlse_row = p.dlse + (long long)bh * p.S;

  // Start tile qt's Q, dO and rows loading into stage s (one commit group).
  auto load_stage = [&](int s, int qt) {
    T* q_t = base + L::kStage0 + s * 2 * L::kTile;
    T* do_t = q_t + L::kTile;
    const int q0 = qt * kQ;
    for (int i = tid; i < kQ * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kVec;
      const int row = q0 + r;
      const bool real = row < p.S;
      const long long at = real ? row : 0;
      flash::cp_async16(q_t + r * LD + c, qs + at * q_l.s + c, real);
      flash::cp_async16(do_t + r * LD + c, dout + at * p.out.s + c, real);
    }
    if (tid < kQ) {
      const int row = q0 + tid;
      const bool real = row < p.S;
      const int at = real ? row : 0;
      float* rs = rows_s + s * 3 * kQ;
      flash::cp_async4(rs + tid, lse_row + at, real);
      flash::cp_async4(rs + kQ + tid, dlse_row + at, real);
      flash::cp_async4(rs + 2 * kQ + tid, delta_row + at, real);
    }
  };

  const int first = p.causal ? kt : 0;
  load_stage(0, first);
  flash::cp_async_commit();
  if (first + 1 < n_tiles) load_stage(1, first + 1);
  flash::cp_async_commit();
  // K (rotated) and V, once, while the first tiles land.
  if (tid < flash::kThreads) {
    const long long in_off = b * p.in.b + h * p.in.h;
    flash::stage_tile<T, D>(Ks, p.k + in_off, p.in.s, k0, p.S, p.cos_t,
                            p.sinm_t, p.rope);
    flash::stage_tile<T, D>(Vs, p.v + in_off, p.in.s, k0, p.S, nullptr,
                            nullptr, false);
  }

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int qt = first, it = 0; qt < n_tiles; ++qt, ++it) {
    const int s = it & 1;
    const T* Qs = base + L::kStage0 + s * 2 * L::kTile;
    const T* dOs = Qs + L::kTile;
    const float* lse_s = rows_s + s * 3 * kQ;
    const float* dlse_s = lse_s + kQ;
    const float* delta_s = dlse_s + kQ;
    const int q0 = qt * kQ;
    flash::cp_async_wait<1>();  // tile qt's group landed (qt + 1's may not)
    __syncthreads();            // ... for every thread; dS^T of qt - 1 is read

    // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x 32 queries per warp.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / kDepth; ++kk) {
      FragA<T> ka, va;
      flash::load_a<LD>(ka, Ks, kg * 16, kk * kDepth, lane);
      flash::load_a<LD>(va, Vs, kg * 16, kk * kDepth, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB<T> bq, bd;
        flash::load_b_rows_n<LD>(bq, Qs, c0 + j * 8, kk * kDepth, lane);
        flash::load_b_rows_n<LD>(bd, dOs, c0 + j * 8, kk * kDepth, lane);
        flash::mma(st[j], ka, bq);
        flash::mma(dpt[j], va, bd);
      }
    }

    // P^T and dS^T = P^T * (dP^T + dlse - delta).
    const bool masked = (p.causal && qt == kt) || q0 + kQ > p.S ||
                        k0 + kKeys > p.S;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = c0 + j * 8 + 2 * t + (e & 1);  // tile-relative query
        float sc = st[j][e] * p.sm_scale;
        if (masked) {
          const int query = q0 + qi;
          const int key = e < 2 ? key_g : key_g8;
          if ((p.causal && query < key) || query >= p.S || key >= p.S)
            sc = kNegInf;
        }
        const float pr = expf(sc - lse_s[qi]);
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] + (dlse_s[qi] - delta_s[qi]));
      }
    }

    // dS^T, rounded to T, into shared memory for dQ.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T* d = ds_t + (kg * 16 + g) * L::kLdDs + c0 + j * 8 + 2 * t;
      flash::st_pair(d, dpt[j][0], dpt[j][1]);
      flash::st_pair(d + 8 * L::kLdDs, dpt[j][2], dpt[j][3]);
    }

    // dV += T(P^T) . dO, then dK += T(dS^T) . Q.
    {
      ScoreA<T> pa;
      to_a(pa, st);
      add_c_rows<T, D, LD>(dv, pa, dOs, c0, lane);
    }
    {
      ScoreA<T> da;
      to_a(da, dpt);
      add_c_rows<T, D, LD>(dk, da, Qs, c0, lane);
    }
    __syncthreads();   // dS^T complete; stage s is read
    if (qt + 2 < n_tiles) load_stage(s, qt + 2);
    flash::cp_async_commit();

    // dQ partial = T(dS) . K: warp w takes queries 16 (w % 4) .. +15 and
    // the (w / 4)-th half of D's columns, summed over the 64 keys in fresh
    // registers, then added into the accumulator.
    {
      constexpr int kN = D / 16;   // n-tiles per warp
      const int m0 = (warp & 3) * 16;
      const int n0 = (warp >> 2) * kN;
      float acc[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeys / kDepth; ++kk) {
        FragA<T> a;
        ld_a_t<L::kLdDs>(a, ds_t, kk * kDepth, m0, lane);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          FragB<T> bk;
          flash::load_b_rows_k<LD>(bk, Ks, kk * kDepth, (n0 + j) * 8, lane);
          flash::mma(acc[j], a, bk);
        }
      }
      const int row = q0 + m0 + g;
      float* dst = p.dq_acc + b * p.out.b + h * p.out.h;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int col = (n0 + j) * 8 + 2 * t;
        if (row < p.S)
          atomicAdd(reinterpret_cast<float2*>(dst + row * p.out.s + col),
                    make_float2(acc[j][0], acc[j][1]));
        if (row + 8 < p.S)
          atomicAdd(
              reinterpret_cast<float2*>(dst + (row + 8) * p.out.s + col),
              make_float2(acc[j][2], acc[j][3]));
      }
    }
  }

  // The two warps of a key group hold dK, dV over disjoint queries: warps
  // 4-7 hand theirs over through the stage area, warps 0-3 add them.
  flash::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(base + L::kStage0);
  float* red_k = red + (kg * 16 + g) * L::kRedLd + 2 * t;
  float* red_v = red_k + kKeys * L::kRedLd;
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      flash::st_pair(red_k + j * 8, dk[j][0], dk[j][1]);
      flash::st_pair(red_k + j * 8 + 8 * L::kRedLd, dk[j][2], dk[j][3]);
      flash::st_pair(red_v + j * 8, dv[j][0], dv[j][1]);
      flash::st_pair(red_v + j * 8 + 8 * L::kRedLd, dv[j][2], dv[j][3]);
    }
  }
  __syncthreads();
  if (warp >= 4) return;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 k_g = flash::ld_pair(red_k + j * 8);
    const float2 k_g8 = flash::ld_pair(red_k + j * 8 + 8 * L::kRedLd);
    const float2 v_g = flash::ld_pair(red_v + j * 8);
    const float2 v_g8 = flash::ld_pair(red_v + j * 8 + 8 * L::kRedLd);
    dk[j][0] = (dk[j][0] + k_g.x) * p.sm_scale;
    dk[j][1] = (dk[j][1] + k_g.y) * p.sm_scale;
    dk[j][2] = (dk[j][2] + k_g8.x) * p.sm_scale;
    dk[j][3] = (dk[j][3] + k_g8.y) * p.sm_scale;
    dv[j][0] += v_g.x;
    dv[j][1] += v_g.y;
    dv[j][2] += v_g8.x;
    dv[j][3] += v_g8.y;
  }
  if (p.rope)
    flash::rope_inverse<T, D>(dk, p.cos_t, p.sinm_t, key_g, key_g8, p.S,
                              lane);
  const long long out_off = b * p.out.b + h * p.out.h;
  flash::store_rows<T, D>(p.dk + out_off, p.out.s, dk, key_g, key_g8, p.S,
                          lane);
  flash::store_rows<T, D>(p.dv + out_off, p.out.s, dv, key_g, key_g8, p.S,
                          lane);
}

// dq = inverse_rope(acc * sm_scale) rounded to T once, the rounding of
// bwd_dq_plain. One thread per 4 columns of a row's first half and their
// partners D/2 away; rows are the [B, S, H] positions of acc.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    epilogue_kernel(const float* acc, const T* cos_t, const T* sinm_t, T* dq,
                    long long rows, int S, int H, int rope, float sm_scale) {
  constexpr int kChunks = D / 8;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= rows * kChunks) return;
  const long long r = i / kChunks;
  const int c = static_cast<int>(i % kChunks) * 4;
  const float4 lo4 = *reinterpret_cast<const float4*>(acc + r * D + c);
  const float4 hi4 = *reinterpret_cast<const float4*>(acc + r * D + c + D / 2);
  float lo[4] = {lo4.x * sm_scale, lo4.y * sm_scale, lo4.z * sm_scale,
                 lo4.w * sm_scale};
  float hi[4] = {hi4.x * sm_scale, hi4.y * sm_scale, hi4.z * sm_scale,
                 hi4.w * sm_scale};
  if (rope) {
    const long long at = ((r / H) % S) * D + c;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float2 cl = flash::ld_pair(cos_t + at + e);
      const float2 ch = flash::ld_pair(cos_t + at + D / 2 + e);
      const float2 sl = flash::ld_pair(sinm_t + at + e);
      const float2 sh = flash::ld_pair(sinm_t + at + D / 2 + e);
      const float l0 = lo[e], l1 = lo[e + 1], h0 = hi[e], h1 = hi[e + 1];
      lo[e] = flash::rot(l0, cl.x, h0, -sl.x);
      lo[e + 1] = flash::rot(l1, cl.y, h1, -sl.y);
      hi[e] = flash::rot(h0, ch.x, l0, -sh.x);
      hi[e + 1] = flash::rot(h1, ch.y, l1, -sh.y);
    }
  }
  T* out = dq + r * D + c;
  flash::st_pair(out, lo[0], lo[1]);
  flash::st_pair(out + 2, lo[2], lo[3]);
  flash::st_pair(out + D / 2, hi[0], hi[1]);
  flash::st_pair(out + D / 2 + 2, hi[2], hi[3]);
}

// The C entry's launches for one (T, D): the rotation of q (with rope),
// the fused kernel, the epilogue.
template <typename T, int D>
struct Launch {
  static cudaError_t run(const flash::Params<T>& p, cudaStream_t stream) {
    const long long rows = (long long)p.B * p.S * p.H;
    const T* q_src = p.q;
    Layout q_l = p.in;
    if (p.rope) {
      // The roped q goes into dq, which only the epilogue writes.
      cudaError_t err = flash::rope_rows<T, D>(p, p.q, p.dq, stream);
      if (err != cudaSuccess) return err;
      q_src = p.dq;
      q_l = p.out;
    }
    const int smem = Smem<T, D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_mma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.B * p.H, (p.S + kKeys - 1) / kKeys);
    flash_bwd_mma_kernel<T, D><<<grid, kThreads, smem, stream>>>(p, q_src,
                                                                 q_l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long threads = rows * (D / 8);
    epilogue_kernel<T, D><<<(unsigned)((threads + 255) / 256), 256, 0,
                            stream>>>(p.dq_acc, p.cos_t, p.sinm_t, p.dq, rows,
                                      p.S, p.H, p.rope, p.sm_scale);
    return cudaGetLastError();
  }
};

}  // namespace bwd_mma

// q, k, v [B, S, H, D] sharing strides (in_b, in_s, in_h), D stride 1,
// 16-byte-aligned base and strides; dout [B, S, H, D] contiguous; lse,
// delta, dlse [B, H, S] fp32; cos_t/sinm_t [S, D] (read only when rope);
// dq_acc [B, S, H, D] fp32 scratch, zeroed by the caller; dq, dk, dv
// [B, S, H, D] contiguous out. q, k, v, dout, dq, dk, dv and the tables
// are all bf16 (elem_bytes 2) or all fp32 (elem_bytes 4), at the head
// dims of flash::dispatch_head_dim; anything else returns
// cudaErrorInvalidValue. Returns the first CUDA error of its launches (0
// on success); allocates nothing, never syncs. Hkv, Dv, k's and v's
// strides and the window are flash_bwd_sm90's: here Hkv must be H, Dv D,
// k's and v's strides q's, and the window 0.
extern "C" int flash_bwd_mma(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* dlse,
                             const void* cos_t, const void* sinm_t,
                             void* dq_acc, void* dq, void* dk, void* dv,
                             int B, int S, int H, int Hkv, int D, int Dv,
                             long long in_b, long long in_s, long long in_h,
                             long long k_b, long long k_s, long long k_h,
                             long long v_b, long long v_s, long long v_h,
                             int causal, int window, int rope, int elem_bytes,
                             void* stream) {
  // One K/V head per query head and no window: q, k and v share a layout.
  if (Hkv != H || window != 0 || Dv != D || k_b != in_b || k_s != in_s ||
      k_h != in_h || v_b != in_b || v_s != in_s || v_h != in_h)
    return static_cast<int>(cudaErrorInvalidValue);
  flash::Operands x = {};
  x.q = q;
  x.k = k;
  x.v = v;
  x.dout = dout;
  x.lse_in = static_cast<const float*>(lse);
  x.delta = static_cast<const float*>(delta);
  x.dlse = static_cast<const float*>(dlse);
  x.cos_t = cos_t;
  x.sinm_t = sinm_t;
  x.dq_acc = static_cast<float*>(dq_acc);
  x.dq = dq;
  x.dk = dk;
  x.dv = dv;
  return flash::dispatch<bwd_mma::Launch>(
      elem_bytes, x, flash::Shape{B, S, H, D, in_b, in_s, in_h, causal, rope},
      stream);
}
