// Flash-attention forward for Hopper (sm_90a) on mma.sync, bf16 or fp32
// inputs: causal or full attention of one 64-row Q tile against every K/V
// tile it needs, with RoPE, writing O and the per-row logsumexp. It serves
// fp32 (D 16 and 128), and bf16 at the head dims flash_fwd_sm90.cu is not
// built for (_flash_kernels.fwd_route).
//
// Replaces tpu_dra/workloads/flashattention.py:_fwd_kernel (the Pallas
// kernel reached through _fwd_call) and _fwd_stream_kernel (the same
// function with K/V as a grid axis, reached through _fwd_call_stream):
// this kernel streams K/V through shared memory at every S, so it is the
// counterpart of both tiers.
//
// What bounds it on the H100: two products per (query, key) pair, 4 * D
// FLOPs. fp32 runs each product as three TF32 products (flash_common.cuh),
// so its bound is those FLOPs over 495/3 TFLOP/s: at B1 S8192 H2 D128,
// causal, 34.4 GFLOP in 0.208 ms, against 42 MB of compulsory traffic in
// 0.013 ms. The tensor cores, not memory, bound it.
//
// What the design does about it:
// 1. Split once, at full rate. fp32 operands split as hi = x & 0xffffe000,
//    lo = x - hi (flash::split): Q's fragments once per K tile, K's and
//    V's once per use by each warp, P once per tile in registers. The
//    fragments come from shared memory in 16-byte loads: Q.K^T's k slots
//    are permuted (slots t and t + 4 of a 16-column chunk's first k step
//    are columns 4t and 4t + 1, of its second 4t + 2 and 4t + 3), so one
//    load gives two k steps of a Q or K fragment; P.V's output columns are
//    permuted (n = g of n-tile j in a group of four is column 4g + j of
//    the group's 32), so one load gives four n-tiles of V's fragment. Q
//    and K rows at a pitch of 16 mod 32 floats and V rows at 4 mod 16 keep
//    those loads free of bank conflicts.
// 2. Asynchronous staging. K/V tiles arrive by cp.async in a ring of two
//    stages, in the input type: tile i + 1 lands while tile i's products
//    and softmax run. (Split hi/lo planes of two fp32 stages would take
//    ~270 KB at D=128, past the 227 KB a block may have.)
// 3. Eight warps per 64-row Q tile: warp w owns rows 16 (w % 4) .. +15 and
//    keys 32 (w / 4) .. +31 of each 64-key tile, with its own row max, row
//    sum and accumulator. The two partials of a row group meet once, at
//    the end, through shared memory, in a fixed order, so O and lse are
//    reproducible bit for bit. One CTA of 256 threads per SM (174 KB of
//    shared memory at fp32 D=128). The grid's y axis is the Q tile,
//    heaviest causal tiles first, the light ones filling in behind.
// 4. RoPE off the loop. A first launch in the same C entry writes the
//    roped k once into a scratch buffer the wrapper allocates, so the
//    streamed K tiles need no rotation; Q is rotated once as it is staged.
//    (Rotating each K tile in place after it landed, with its table rows
//    a tile ahead, cost 14-17% of the forward: PERF.md.)
// 5. Base-2 softmax: on unmasked tiles the exponent is one FMA,
//    exp2(s * scale * log2 e - m * scale * log2 e); diagonal and ragged
//    tiles round the scaled score first, so masked scores stay exact.
//    exp2 is ex2.approx.ftz (the hardware approximation, results below
//    2^-126 flushed to zero): exp2f's handling of subnormal results cost
//    10% of the forward and changed no output bit at B1 S8192 H2 D128
//    (PERF.md).
// 6. IEEE sums. The tensor cores round each fp32 accumulation toward zero,
//    so each tile's P.V products are summed in fresh registers and added
//    to O once per tile, by one fma with the rescale
//    (tests/test_torch_fwd_mma.py shows what skipping that costs).
//
// Rounding points are fwd_plain's (the TPU kernels'): roped q/k rounded to
// the input type before the dot, scores scaled after it (a masked score is
// -1e30 before scaling here: exp gives 0 either way), P rounded to the
// input type before P.V (nothing rounds for fp32), O divided by the row
// sum, then rounded; lse = m * scale + log(l). The sums run in another
// order than fwd_plain's (tile by tile, two key halves).
#include "flash_common.cuh"

namespace fwd {

using flash::bf16;
using flash::Elem;
using flash::FragA;
using flash::FragB;
using flash::kNegInf;

constexpr int kRows = 64;      // Q rows per CTA
constexpr int kKeys = 64;      // keys per streamed K/V tile
constexpr int kHalf = 32;      // keys of a tile per warp
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.44269504088896341f;

// 2^x (ex2.approx.ftz: results below 2^-126 flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory, in elements of T: the Q tile, then two stages of (K
// tile, V tile). After the loop the stage area holds the key-half-1
// warps' partials (fp32, per row group [D/2 + 4][32 lanes]).
template <typename T, int D>
struct Smem {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kLdK = kF32 ? D + (D % 32 ? 32 : 16) : D + 8;
  static constexpr int kLdV = kF32 ? D + 4 : D + 8;
  static constexpr int kStage0 = kRows * kLdK;
  static constexpr int kStage = kKeys * (kLdK + kLdV);
  static constexpr int kBytes = (kStage0 + 2 * kStage) * (int)sizeof(T);
  static constexpr int kRedRow = (D / 2 + 4) * 32;
  static_assert(4 * kRedRow * 4 <= 2 * kStage * (int)sizeof(T),
                "the partials do not fit the stage area");
};

// ---------------------------------------------------------------------------
// fp32 fragments (16-byte loads, permuted slots: see the header)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The A fragments of two k steps from rows g (r) and g + 8 (r8).
__device__ __forceinline__ void split_a2(FragA<float>& a0, FragA<float>& a1,
                                         float4 r, float4 r8) {
  flash::split(r.x, a0.hi[0], a0.lo[0]);
  flash::split(r8.x, a0.hi[1], a0.lo[1]);
  flash::split(r.y, a0.hi[2], a0.lo[2]);
  flash::split(r8.y, a0.hi[3], a0.lo[3]);
  flash::split(r.z, a1.hi[0], a1.lo[0]);
  flash::split(r8.z, a1.hi[1], a1.lo[1]);
  flash::split(r.w, a1.hi[2], a1.lo[2]);
  flash::split(r8.w, a1.hi[3], a1.lo[3]);
}

// The B fragments of the same two k steps from one K row.
__device__ __forceinline__ void split_b2(FragB<float>& b0, FragB<float>& b1,
                                         float4 r) {
  flash::split(r.x, b0.hi[0], b0.lo[0]);
  flash::split(r.y, b0.hi[1], b0.lo[1]);
  flash::split(r.z, b1.hi[0], b1.lo[0]);
  flash::split(r.w, b1.hi[1], b1.lo[1]);
}

// s (16 rows x 32 keys: rows r0.., keys n0.. of the tile) = Q . K^T.
template <int D, int LD>
__device__ __forceinline__ void qk_tile(float (*s)[4], const float* Qs,
                                        const float* Ks, int r0, int n0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* q = Qs + (r0 + g) * LD + 4 * t;
  const float* k = Ks + (n0 + g) * LD + 4 * t;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    FragA<float> a0, a1;
    split_a2(a0, a1, ld4(q + 16 * c), ld4(q + 8 * LD + 16 * c));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB<float> b0, b1;
      split_b2(b0, b1, ld4(k + j * 8 * LD + 16 * c));
      flash::mma(s[j], a0, b0);
      flash::mma(s[j], a1, b1);
    }
  }
}

// bf16: Q's fragments are held in registers across the K loop.
template <int D, int LD>
__device__ __forceinline__ void qk_tile(float (*s)[4], const FragA<bf16>* qa,
                                        const bf16* Ks, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB<bf16> b;
      flash::load_b_rows_n<LD>(b, Ks, n0 + j * 8, kk * 16, lane);
      flash::mma(s[j], qa[kk], b);
    }
  }
}

// n-tiles per group of P.V's permuted output columns: n = g of n-tile j is
// column kGroup * g + j of the group's 8 * kGroup, so lane (g, t) holds
// columns 2 kGroup t .. 2 kGroup t + 2 kGroup - 1 of each group.
template <int D>
constexpr int kGroup = D / 8 < 4 ? D / 8 : 4;

template <int N>
__device__ __forceinline__ void ld_row(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    static_assert(N == 2, "groups of 2 or 4 n-tiles");
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}

// acc = acc * corr + P . V over keys k0 .. k0 + 31 of the tile (corr[0]
// for row g, corr[1] for row g + 8): P (this warp's 16 x 32 scores) split
// once; V's B fragments in the permuted k slots of P's C layout (slot t =
// key 2t, slot t + 4 = key 2t + 1) and the permuted columns above. Each
// group's products are summed in fresh registers and added to the
// rescaled acc in IEEE fp32, by one fma.
template <int D, int LD>
__device__ __forceinline__ void pv_tile(float (*acc)[4], const float* corr,
                                        const float (*p)[4], const float* Vs,
                                        int k0, int lane) {
  constexpr int NG = kGroup<D>;
  const int g = lane >> 2, t = lane & 3;
  FragA<float> pa[kHalf / 8];
#pragma unroll
  for (int kk = 0; kk < kHalf / 8; ++kk) flash::a_from_c(pa[kk], p, kk);
  const float* v = Vs + (k0 + 2 * t) * LD + NG * g;
#pragma unroll
  for (int grp = 0; grp < D / (8 * NG); ++grp) {
    float sum[NG][4] = {};
#pragma unroll
    for (int kk = 0; kk < kHalf / 8; ++kk) {
      float v0[NG], v1[NG];
      ld_row<NG>(v0, v + kk * 8 * LD + grp * 8 * NG);
      ld_row<NG>(v1, v + (kk * 8 + 1) * LD + grp * 8 * NG);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        FragB<float> b;
        flash::split(v0[j], b.hi[0], b.lo[0]);
        flash::split(v1[j], b.hi[1], b.lo[1]);
        flash::mma(sum[j], pa[kk], b);
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      float* a = acc[grp * NG + j];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = fmaf(a[e], corr[e >> 1], sum[j][e]);
    }
  }
}

// Rows g and g + 8 of O from an accumulator in pv_tile's column order;
// rows at or past S are dropped.
template <int D>
__device__ __forceinline__ void store_o(float* dst, long long stride,
                                        const float (*acc)[4], int row_g,
                                        int row_g8, int S, int lane) {
  constexpr int NG = kGroup<D>;
  const int t = lane & 3;
#pragma unroll
  for (int grp = 0; grp < D / (8 * NG); ++grp) {
    const float(*a)[4] = acc + grp * NG;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_g8 : row_g;
      if (row >= S) continue;
      float* d = dst + row * stride + grp * 8 * NG + 2 * NG * t;
#pragma unroll
      for (int j = 0; j < NG; j += 2) {
        flash::st_pair(d + j, a[j][2 * half], a[j + 1][2 * half]);
        flash::st_pair(d + NG + j, a[j][2 * half + 1], a[j + 1][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// k_src: K (roped with RoPE) in layout k_l.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const flash::Params<T> p, const T* k_src,
                     flash::Layout k_l) {
  using L = Smem<T, D>;
  constexpr bool kF32 = L::kF32;
  constexpr int NT = D / 8;
  constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte chunk
  constexpr int kChunks = D / kVec;       // chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* base = reinterpret_cast<T*>(smem);
  T* Qs = base;

  const int n_tiles = (p.S + kKeys - 1) / kKeys;
  const int qt = n_tiles - 1 - blockIdx.y;  // longest causal rows first
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int r0 = (warp & 3) * 16;       // this warp's rows of the Q tile
  const int kh = (warp >> 2) * kHalf;   // this warp's keys of each K tile
  const int row_g = q0 + r0 + (lane >> 2), row_g8 = row_g + 8;
  const long long in_off = b * p.in.b + h * p.in.h;
  const T* ks_src = k_src + b * k_l.b + h * k_l.h;
  const T* v_src = p.v + in_off;
  const int last = p.causal ? qt + 1 : n_tiles;
  const float scale_log2 = p.sm_scale * kLog2e;

  // Start K/V tile kt loading into stage st.
  auto load_kv = [&](int st, int kt) {
    T* ks = base + L::kStage0 + st * L::kStage;
    T* vs = ks + kKeys * L::kLdK;
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kVec;
      const int row = kt * kKeys + r;
      const bool real = row < p.S;
      const long long at = real ? row : 0;
      flash::cp_async16(ks + r * L::kLdK + c, ks_src + at * k_l.s + c, real);
      flash::cp_async16(vs + r * L::kLdV + c, v_src + at * p.in.s + c, real);
    }
  };

  load_kv(0, 0);
  flash::cp_async_commit();
  // Q (rotated), once, while the first tile lands.
  flash::stage_tile<T, D, L::kLdK, kThreads>(Qs, p.q + in_off, p.in.s, q0,
                                             p.S, p.cos_t, p.sinm_t, p.rope);
  __syncthreads();
  FragA<T> qa[kF32 ? 1 : D / 16];
  if constexpr (!kF32) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      flash::load_a<L::kLdK>(qa[kk], Qs, r0, kk * 16, lane);
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // raw (unscaled) row maxima
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int kt = 0; kt < last; ++kt) {
    const int st = kt & 1;
    const T* Ks = base + L::kStage0 + st * L::kStage;
    const T* Vs = Ks + kKeys * L::kLdK;
    flash::cp_async_wait<0>();
    __syncthreads();  // tile kt landed for every thread; tile kt - 1 is read
    if (kt + 1 < last) load_kv(st ^ 1, kt + 1);
    flash::cp_async_commit();

    const int k0 = kt * kKeys;
    float s[4][4];    // 16 rows x 32 keys
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kF32) qk_tile<D, L::kLdK>(s, Qs, Ks, r0, kh, lane);
    else qk_tile<D, L::kLdK>(s, qa, Ks, kh, lane);

    const bool masked = (p.causal && kt == qt) || k0 + kKeys > p.S;
    if (masked) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + kh + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_g : row_g8;
          if ((p.causal && col > row) || col >= p.S) s[j][e] = kNegInf;
        }
      }
    }
    // Online softmax on the accumulators: rows g (e = 0, 1) and g+8 (2, 3).
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    mx[0] = flash::quad_max(mx[0]);
    mx[1] = flash::quad_max(mx[1]);
    const float corr[2] = {ex2((m_run[0] - mx[0]) * scale_log2),
                           ex2((m_run[1] - mx[1]) * scale_log2)};
    const float mc[2] = {__fmul_rn(mx[0], scale_log2),
                         __fmul_rn(mx[1], scale_log2)};
    m_run[0] = mx[0];
    m_run[1] = mx[1];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        s[j][e] = masked ? ex2(__fmul_rn(x, scale_log2) - mc[e >> 1])
                         : ex2(fmaf(x, scale_log2, -mc[e >> 1]));
      }
      rs[0] += s[j][0] + s[j][1];
      rs[1] += s[j][2] + s[j][3];
    }
    l_run[0] = fmaf(l_run[0], corr[0], rs[0]);
    l_run[1] = fmaf(l_run[1], corr[1], rs[1]);
    if constexpr (kF32) {
      pv_tile<D, L::kLdV>(acc, corr, s, Vs, kh, lane);
    } else {   // bf16 products accumulate into acc itself
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      flash::mma_c_rows<D, L::kLdV, kHalf / 16>(acc, s, Vs, kh, lane);
    }
  }

  // The two warps of a row group hold partials over disjoint keys: the
  // key-half-1 warp hands (acc, m, l) over through the stage area, the
  // other merges them, always in this order.
  l_run[0] = flash::quad_sum(l_run[0]);
  l_run[1] = flash::quad_sum(l_run[1]);
  flash::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(base + L::kStage0) +
               (warp & 3) * L::kRedRow + lane;
  if (kh) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(j * 4 + e) * 32] = acc[j][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      red[(NT * 4 + i) * 32] = m_run[i];
      red[(NT * 4 + 2 + i) * 32] = l_run[i];
    }
  }
  __syncthreads();
  if (kh) return;
  float w0[2], w1[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = red[(NT * 4 + i) * 32], l1 = red[(NT * 4 + 2 + i) * 32];
    const float m = fmaxf(m_run[i], m1);
    w0[i] = ex2((m_run[i] - m) * scale_log2);
    w1[i] = ex2((m1 - m) * scale_log2);
    l[i] = fmaf(l1, w1[i], __fmul_rn(l_run[i], w0[i]));
    m_run[i] = m;
  }
  // o = acc / l: divide first, as the TPU kernel does, then round.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      acc[j][e] =
          fmaf(red[(j * 4 + e) * 32], w1[i], __fmul_rn(acc[j][e], w0[i])) /
          l[i];
    }
  }
  const long long out_off = b * p.out.b + h * p.out.h;
  if constexpr (kF32)
    store_o<D>(p.o + out_off, p.out.s, acc, row_g, row_g8, p.S, lane);
  else
    flash::store_rows<T, D>(p.o + out_off, p.out.s, acc, row_g, row_g8, p.S,
                            lane);
  if (t == 0) {
    float* lse = p.lse_out + (long long)bh * p.S;
    if (row_g < p.S) lse[row_g] = __fmul_rn(m_run[0], p.sm_scale) + logf(l[0]);
    if (row_g8 < p.S)
      lse[row_g8] = __fmul_rn(m_run[1], p.sm_scale) + logf(l[1]);
  }
}

// The C entry's launches for one (T, D): the rotation of k into kr (with
// rope), then the kernel.
template <typename T, int D>
struct Launch {
  static cudaError_t run(const flash::Params<T>& p, cudaStream_t stream) {
    const T* k_src = p.k;
    flash::Layout k_l = p.in;
    if (p.rope) {
      cudaError_t err = flash::rope_rows<T, D>(p, p.k, p.kr, stream);
      if (err != cudaSuccess) return err;
      k_src = p.kr;
      k_l = p.out;
    }
    const int smem = Smem<T, D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.B * p.H, (p.S + kRows - 1) / kRows);
    flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p, k_src, k_l);
    return cudaGetLastError();
  }
};

}  // namespace fwd

// q, k, v: [B, S, H, D] sharing strides (in_b, in_s, in_h), D stride 1,
// 16-byte aligned rows. o: [B, S, H, D] contiguous; lse: [B, H, S] fp32.
// cos_t/sinm_t: [S, D] (read only when rope). kr: [B, S, H, D] contiguous
// scratch for the roped k (written and read only when rope). q, k, v, o,
// kr and the tables are all bf16 (elem_bytes 2) or all fp32 (elem_bytes
// 4), at the head dims of flash::dispatch_head_dim; anything else returns
// cudaErrorInvalidValue. Returns the first CUDA error of its launches (0
// on success); allocates nothing, never syncs. Hkv, Dv, k's and v's
// strides and the window are flash_fwd_sm90's: here Hkv must be H, Dv D,
// k's and v's strides q's, and the window 0.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* cos_t, const void* sinm_t, void* o,
                         void* lse, void* kr, int B, int S, int H, int Hkv,
                         int D, int Dv, long long in_b, long long in_s,
                         long long in_h, long long k_b, long long k_s,
                         long long k_h, long long v_b, long long v_s,
                         long long v_h, int causal, int window, int rope,
                         int elem_bytes, void* stream) {
  // One K/V head per query head and no window: q, k and v share a layout.
  if (Hkv != H || window != 0 || Dv != D || k_b != in_b || k_s != in_s ||
      k_h != in_h || v_b != in_b || v_s != in_s || v_h != in_h)
    return static_cast<int>(cudaErrorInvalidValue);
  flash::Operands x = {};
  x.q = q;
  x.k = k;
  x.v = v;
  x.cos_t = cos_t;
  x.sinm_t = sinm_t;
  x.o = o;
  x.lse_out = static_cast<float*>(lse);
  x.kr = kr;
  return flash::dispatch<fwd::Launch>(
      elem_bytes, x, flash::Shape{B, S, H, D, in_b, in_s, in_h, causal, rope},
      stream);
}
