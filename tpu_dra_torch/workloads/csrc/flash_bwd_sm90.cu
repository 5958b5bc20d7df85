// Flash-attention backward for Hopper (sm_90a), bf16 at head dims (q.k,
// v) = (64, 64), (128, 128) and (192, 128), as one fused pass: each CTA keeps one 128-key K/V tile stationary and
// streams the 64-row Q/dO tiles that attend to it, computing dK and dV in
// registers and adding its dQ partials into an fp32 accumulator; a second
// launch in the same C entry turns the accumulator into dq.
//
// Replaces tpu_dra/workloads/flashattention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (reached through _flash_bwd_rule) and
// _bwd_dq_stream_kernel and _bwd_dkv_stream_kernel (_bwd_calls_stream)
// for bf16 at D 64 and 128, which carries every backward of the
// flagship, long_ctx and long_ctx_xl paths. fp32 inputs and the other
// bf16 head dims run flash_bwd_mma.cu (_flash_kernels.bwd_route says
// which).
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): five products
// per (query, key) pair, 10 * D FLOPs, against q, k, v, dO in and dq, dk,
// dv out: at the flagship shape (B8 S1023 H16 D128, causal) 85.8 GFLOP,
// operations bound it at 0.087 ms; at B1 S16384 H16 D128, 2.75 TFLOP,
// 2.78 ms. The dq/dkv split it replaces recomputes Q.K^T and dO.V^T in
// both kernels, 14 * D FLOPs per pair.
//
// Design:
// 1. One pass. Per K/V tile and streamed Q tile: S^T = K.Q^T and
//    dP^T = V.dO^T (wgmma m64n64k16, both operands K-major in shared
//    memory), P^T = 2^(s * scale * log2(e) - lse * log2(e)), dS^T = P^T *
//    (dP^T + dlse - delta), dV += P^T.dO and dK += dS^T.Q (wgmma with P^T
//    and dS^T from registers, re-packed as bf16 A fragments, and dO / Q
//    read MN-major), and dQ = dS.K (wgmma with dS^T read back from shared
//    memory as a transposed A and the stationary K as an MN-major B).
// 2. Warp specialisation. Warpgroup 0 produces: one thread issues TMA
//    loads (128-byte swizzle, zero fill past S) of K and V once and of Q,
//    dO and the Q rows' rope-table halves into a ring of kStages stages;
//    warp 1 stages lse * log2(e) and dlse - delta of the stage's rows.
//    Warpgroups 1 and 2 consume, 64 keys each, holding their dK and dV
//    accumulators in registers (setmaxnreg 24 / 240). Each consumer
//    computes half of dQ's columns (D=128; at D=64 consumer 0 all of
//    them), so both consumers' dS^T halves meet in shared memory (two
//    buffers, one named barrier per tile). The consumers run in step:
//    the products read both operands of S^T, dP^T and dQ from shared
//    memory, whose bandwidth the two consumers share, so letting them
//    drift a tile apart (dQ of tile i deferred into tile i + 1, Q(i + 1)
//    rotated during tile i) measured slower, and spilled (PERF.md).
// 3. dQ reduction. Every CTA adds its [64 x D] dQ partial of each Q tile
//    into the [B, S, H, D] fp32 accumulator: each consumer warp stages its
//    16 rows in swizzled shared memory and issues TMA reduce-adds
//    (cp.reduce.async.bulk.tensor .add.f32, the reduction done in L2, rows
//    past S dropped by the map); the epilogue kernel scales,
//    inverse-rotates and rounds it once. The reductions make dq's sums run
//    in an order that changes from run to run; dk and dv are summed by one
//    CTA in a fixed order and are reproducible bit for bit.
// 4. RoPE. K is rotated once per CTA, in place (tables from L2); each
//    streamed Q tile is rotated in place by both consumers, 32 rows each,
//    from the table halves that arrive with it (the forward's scheme; only
//    the first D/2 columns of each table are read).
// 5. Causal order. K tile 0 sees the most Q tiles: the grid's y axis is
//    the K tile, so the heaviest CTAs of every head launch first; each CTA
//    streams its Q tiles from the diagonal down.
//
// Latent attention (DeepSeek-V3's MLA, (192, 128); no rope, which the
// caller applies to the 64 roped dims): dK holds 96 registers a consumer
// thread where dV holds 64, so P^T is packed to bf16 only after dS^T (one
// fewer 16-register array live while S^T and dP^T both are); dK += dS^T.Q
// is one m64n192 wgmma; dQ's three 64-column boxes go to consumer 0 (boxes
// 0 and 2) and consumer 1 (box 1). Shared memory: K 48 KB + V 32 KB, two
// stages of Q 24 KB + dO 16 KB, and the same dS^T, dQ and row-vector
// buffers: 226 KB. The scale is 1/sqrt(Dqk).
//
// Rounding points are bwd_dq_plain's and bwd_dkv_plain's: roped q/k
// rounded to bf16 before the dots, scores scaled after them, masked scores
// -1e30 (on the diagonal and ragged tiles; queries and keys >= S are
// masked in every mode, since TMA's zero rows would give p = 1), P and dS
// rounded to bf16 before their products, dK and dQ scaled, inverse-
// rotated in fp32 and rounded once, dV rounded once. The exponential runs
// in base 2 (ex2.approx) and the sums run in another order than the plain
// versions' (tile by tile; dQ over K tiles in no fixed order).
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace bwd_sm90 {

using flash::bf16;
using flash::kNegInf;

constexpr int kKeys = 128;          // keys per CTA (stationary K/V tile)
constexpr int kQ = 64;              // queries per streamed tile
constexpr int kStages = 2;          // Q/dO ring depth
constexpr int kThreads = 384;       // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumerWarps = 8;
constexpr int kKvBox = kKeys * 128;  // 128 rows x 64 bf16 columns
constexpr int kQBox = kQ * 128;      // 64 rows x 64 bf16 columns
constexpr int kDsTile = kKeys * 128; // dS^T: 128 keys x 64 queries, bf16
// A consumer warp's dQ rows (16) by 32 fp32 columns, 128-byte swizzled:
// the box of one TMA reduce-add; a consumer stages 4 warps x 2 of them.
constexpr int kDqBox = 16 * 128;
constexpr int kDqTile = 8 * kDqBox;
// 24 x 128 + 240 x 256 = 168 x 384: the registers the block starts with
// under __launch_bounds__(384, 1).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBothConsumers = 3;    // named barrier over warpgroups 1, 2

struct Args {
  const bf16* cos_t;   // [S, D] rope tables, read only when rope
  const bf16* sinm_t;
  const float* lse;    // [B, H, S]
  const float* delta;
  const float* dlse;
  float* dq_acc;       // [B, S, H, D] fp32, zeroed by the caller
  int S, H, n_qt;      // n_qt = ceil(S / 64)
  int causal, rope;
  float scale_log2;    // sm_scale * log2(e)
  float sm_scale;
};

// Shared memory: K and V tiles, kStages x (Q tile, dO tile, the Q rows'
// rope-table halves), two dS^T tiles, the two consumers' dQ staging,
// kStages x (lse * log2(e), dlse - delta of the stage's rows), then the
// barriers. Only an instance whose q.k and v share a head dim ropes
// (kRope). 226 KB at (128, 128) and at (192, 128).
template <int DK, int DV>
struct Smem {
  static constexpr bool kRope = DK == DV;
  static constexpr int kKv = (DK / 64) * kKvBox;    // K tile
  static constexpr int kV = (DV / 64) * kKvBox;     // V tile
  static constexpr int kQt = (DK / 64) * kQBox;     // Q tile
  static constexpr int kDo = (DV / 64) * kQBox;     // dO tile
  // cos_t then sinm_t, the first D/2 columns of 64 rows, unswizzled.
  static constexpr int kTables = kRope ? 2 * kQ * DK : 0;
  static constexpr int kStage = kQt + kDo + kTables;
  static constexpr int kStage0 = kKv + kV;
  static constexpr int kDs = kStage0 + kStages * kStage;
  static constexpr int kDq = kDs + 2 * kDsTile;
  static constexpr int kRowVecs = kDq + 2 * kDqTile;  // 2 x 64 fp32 a stage
  static constexpr int kBarrierOff = kRowVecs + kStages * 2 * kQ * 4;
  static constexpr int kBytes = kBarrierOff + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // base rounded up to 1 KB
  static_assert(kAlloc <= 232448, "227 KB of shared memory per block");
};

// S^T (or dP^T) = A . B^T for one consumer: A its 64 rows of the K (or V)
// tile, B the stage's 64 Q (or dO) rows, both K-major; D/16 k-steps (D
// the operands' head dim: Dqk for S^T, Dv for dP^T).
template <int D>
__device__ __forceinline__ void kq_product(float (&acc)[32], uint64_t a_desc,
                                           uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in_box = (kk % 4) * 32;
    sm90::wgmma_ss_m64n64<0, 0>(
        acc, sm90::desc_add(a_desc, (kk / 4) * kKvBox + in_box),
        sm90::desc_add(b_desc, (kk / 4) * kQBox + in_box), kk > 0);
  }
}

// acc (64 keys x D) += A . B: A the 64 x 64 P^T or dS^T as 4 k-steps of
// bf16 A fragments, B the stage's dO or Q tile read MN-major (LBO: the
// next 64 columns of D).
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2],
                                           const uint32_t (&frag)[16],
                                           uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    const uint64_t d = sm90::desc_add(b_desc, kk * 16 * 128);
    if constexpr (D == 192) sm90::wgmma_rs_m64n192(acc, &frag[4 * kk], d);
    else if constexpr (D == 128) sm90::wgmma_rs_m64n128(acc, &frag[4 * kk], d);
    else sm90::wgmma_rs_m64n64(acc, &frag[4 * kk], d);
  }
}

// dQ (64 queries x 64 columns) = dS . K: dS^T's 128 key rows read as a
// transposed A, K's rows as an MN-major B; 8 k-steps of 16 keys.
__device__ __forceinline__ void dq_product(float (&acc)[32], uint64_t ds_desc,
                                           uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t off = kk * 16 * 128;
    sm90::wgmma_ss_m64n64<1, 1>(acc, sm90::desc_add(ds_desc, off),
                                sm90::desc_add(k_desc, off), kk > 0);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap dk_map,
                          const __grid_constant__ CUtensorMap dv_map,
                          const __grid_constant__ CUtensorMap cos_map,
                          const __grid_constant__ CUtensorMap sinm_map,
                          const __grid_constant__ CUtensorMap dq_map,
                          const Args a) {
  using L = Smem<DK, DV>;
  constexpr int D = DK;             // the rope paths' head dim (DK == DV)
  constexpr int kBoxes = DK / 64;   // of K, Q, dK and dQ
  constexpr int kVBoxes = DV / 64;  // of V, dO and dV
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* k_tile = smem;
  uint8_t* v_tile = smem + L::kKv;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarrierOff);
  uint64_t* kv_full = bars;                // K and V landed
  uint64_t* full = bars + 1;               // Q, dO, tables, lse/corr landed
  uint64_t* q_ready = full + kStages;      // Q rotated by both consumers
  uint64_t* empty = q_ready + kStages;     // both consumers done with it

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kKeys;
  const int qt0 = a.causal ? k0 / kQ : 0;  // the diagonal's Q tile
  const int n_it = a.n_qt - qt0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  auto stage = [&](int it) {
    return smem + L::kStage0 + (it % kStages) * L::kStage;
  };
  // lse * log2(e) of the stage's rows; dlse - delta follows at + kQ.
  auto row_vecs = [&](int it) {
    return reinterpret_cast<float*>(smem + L::kRowVecs) +
           (it % kStages) * 2 * kQ;
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);
      sm90::mbar_init(&q_ready[s], kConsumerWarps);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }

    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warpgroup -------------------------------------------
    sm90::regs_dec<kProducerRegs>();
    const int warp = tid / 32, lane = tid % 32;
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, L::kKv + L::kV);
      for (int c = 0; c < kBoxes; ++c)
        sm90::tma_load_4d(k_tile + c * kKvBox, &k_map, kv_full, c * 64, h, k0,
                          b);
      for (int c = 0; c < kVBoxes; ++c)
        sm90::tma_load_4d(v_tile + c * kKvBox, &v_map, kv_full, c * 64, h, k0,
                          b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages, q0 = (qt0 + it) * kQ;
        uint8_t* st = stage(it);
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s],
                                    L::kQt + L::kDo + (a.rope ? L::kTables : 0));
        for (int c = 0; c < kBoxes; ++c)
          sm90::tma_load_4d(st + c * kQBox, &q_map, &full[s], c * 64, h, q0,
                            b);
        for (int c = 0; c < kVBoxes; ++c)
          sm90::tma_load_4d(st + L::kQt + c * kQBox, &do_map, &full[s],
                            c * 64, h, q0, b);
        if constexpr (L::kRope) if (a.rope) {
          uint8_t* tables = st + L::kQt + L::kDo;
          sm90::tma_load_2d(tables, &cos_map, &full[s], 0, q0);
          sm90::tma_load_2d(tables + kQ * D, &sinm_map, &full[s], 0, q0);
        }
      }
    } else if (warp == 1) {
      // lse in base 2 and dlse - delta of the stage's rows; 0 past S.
      const long long row0 = (long long)bh * a.S;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages, q0 = (qt0 + it) * kQ;
        float* lse2 = row_vecs(it);
        float* corr = lse2 + kQ;
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        for (int r = lane; r < kQ; r += 32) {
          const int q = q0 + r;
          const bool real = q < a.S;
          lse2[r] = real ? a.lse[row0 + q] * kLog2e : 0.f;
          corr[r] = real ? a.dlse[row0 + q] - a.delta[row0 + q] : 0.f;
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: w owns keys [64w, 64w + 64) of the tile -----
  sm90::regs_inc<kConsumerRegs>();
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int key_l = 64 * w + 16 * warp + g;  // tile row of fragment row g
  const int key_g = k0 + key_l, key_g8 = key_g + 8;
  // dQ's columns: box w at D=128; all of them on consumer 0 at D=64;
  // boxes 0 and 2 on consumer 0 and box 1 on consumer 1 at Dqk=192.
  const bool computes_dq = DK >= 128 || w == 0;

  sm90::mbar_wait(kv_full, 0);
  if constexpr (L::kRope) if (a.rope) {
    sm90::rope_rows<D, kKvBox, 64>(
        k_tile, 64 * w, k0, a.S, tid,
        [&](int pos, int, int j, uint4& c, uint4& s) {
          const long long at = (long long)pos * D + j * 8;
          c = __ldg(reinterpret_cast<const uint4*>(a.cos_t + at));
          s = __ldg(reinterpret_cast<const uint4*>(a.sinm_t + at));
        });
    sm90::fence_proxy_async();
  }
  sm90::named_sync(1 + w, 128);  // this consumer's K rows rotated
  const uint64_t kw_desc = sm90::desc_sw128(k_tile + w * 64 * 128, 16, 1024);
  const uint64_t vw_desc = sm90::desc_sw128(v_tile + w * 64 * 128, 16, 1024);
  const uint64_t kdq_desc =
      sm90::desc_sw128(k_tile + (DK >= 128 ? w : 0) * kKvBox, kKvBox, 1024);

  float dk[DK / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages, phase = (it / kStages) & 1;
    // The k-steps' descriptors are computed where they are used, each
    // tile: hoisted out of the loop they would hold 48 registers.
    uint64_t kw = kw_desc, vw = vw_desc, kdq = kdq_desc;
    asm volatile("" : "+l"(kw), "+l"(vw), "+l"(kdq));
    const int q0 = (qt0 + it) * kQ;
    uint8_t* q_s = stage(it);
    uint8_t* do_s = q_s + L::kQt;
    const float* lse2 = row_vecs(it);
    const float* corr = lse2 + kQ;
    uint8_t* ds_s = smem + L::kDs + (it & 1) * kDsTile;

    sm90::mbar_wait(&full[s], phase);
    if constexpr (L::kRope) if (a.rope) {
      // Rows [32w, 32w + 32) of Q, from the table halves of the stage.
      const uint8_t* tables = q_s + 2 * L::kQt;
      sm90::rope_rows<D, kQBox, 32>(
          q_s, 32 * w, q0, a.S, tid,
          [&](int, int r, int j, uint4& c, uint4& sn) {
            const uint8_t* at = tables + r * D + j * 16;
            c = *reinterpret_cast<const uint4*>(at);
            sn = *reinterpret_cast<const uint4*>(at + kQ * D);
          });
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&q_ready[s]);
      sm90::mbar_wait(&q_ready[s], phase);
    }
    // S^T and dP^T: 64 keys x 64 queries each.
    float sc[32], dp[32];
    sm90::wgmma_fence();
    kq_product<DK>(sc, kw, sm90::desc_sw128(q_s, 16, 1024));
    sm90::wgmma_commit();
    kq_product<DV>(dp, vw, sm90::desc_sw128(do_s, 16, 1024));
    sm90::wgmma_commit();
    // P^T while dP^T still runs. Fragment: sc[4j + e] is key row g (e < 2)
    // or g + 8, query q0 + 8j + 2t + (e & 1).
    const bool masked = (a.causal && q0 < k0 + kKeys) || q0 + kQ > a.S ||
                        k0 + kKeys > a.S;
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmaf_rn(sc[4 * j + e], a.scale_log2, -(e & 1 ? l2.y : l2.x));
        if (masked) {
          const int query = q0 + 8 * j + 2 * t + (e & 1);
          const int key = e < 2 ? key_g : key_g8;
          if ((a.causal && query < key) || query >= a.S || key >= a.S)
            x = kNegInf;
        }
        sc[4 * j + e] = sm90::ex2(x);
      }
    }
    uint32_t pa[16], da[16];  // P^T and dS^T as bf16 A fragments
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        pa[i] = flash::pack_bf16(sc[2 * i], sc[2 * i + 1]);
    };
    if constexpr (DK == DV) pack_p();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 cr = *reinterpret_cast<const float2*>(corr + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] + (e & 1 ? cr.y : cr.x));
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) da[i] = flash::pack_bf16(dp[2 * i], dp[2 * i + 1]);
    if constexpr (DK != DV) pack_p();
    // dS^T into shared memory (rows = keys, 64 query columns, swizzled as
    // one 128-row box) for dQ = dS . K; both consumers' halves meet there.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(ds_s + sm90::swz_off(key_l, j, kDsTile) +
                                   4 * t) = da[2 * j];
      *reinterpret_cast<uint32_t*>(ds_s + sm90::swz_off(key_l + 8, j, kDsTile) +
                                   4 * t) = da[2 * j + 1];
    }
    sm90::fence_proxy_async();
    // Both dS^T halves stored (and, on the first tile, both halves of K
    // rotated). The other buffer's readers finished a tile ago.
    sm90::named_sync(kBothConsumers, 256);

    // dV and dK, then dQ: waiting for the first before issuing the second
    // keeps P^T, dS^T and the dQ accumulator out of each other's registers.
    float dq[32];
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
    sm90::wgmma_fence();
    rs_product<DV>(dv, pa, sm90::desc_sw128(do_s, kQBox, 1024));
    rs_product<DK>(dk, da, sm90::desc_sw128(q_s, kQBox, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);  // Q, dO, lse/corr read
    // dQ of 64 columns from box c of K (descriptor kdq_c), added at
    // column c0.
    auto dq_box = [&](uint64_t kdq_c, int c0) {
      sm90::wgmma_fence();
      dq_product(dq, sm90::desc_sw128(ds_s, kDsTile, 1024), kdq_c);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      // This warp's dQ partial, rows q0 + 16 warp + [0, 16) by 64 columns
      // (fragment rows g, g + 8; columns 8j + 2t), staged as two swizzled
      // 16 x 32 fp32 boxes, then added into the accumulator by TMA (rows
      // past S are dropped by the map). Lane 0 first waits until the
      // previous reduce has read the staging.
      uint8_t* dq_s = smem + L::kDq + w * kDqTile + warp * kDqBox;
      if (lane == 0) sm90::bulk_wait_read();
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int chunk = 2 * (j % 4) + t / 2;  // 16-byte chunk in its box
        uint8_t* box = dq_s + (j / 4) * 4 * kDqBox + ((chunk ^ g) << 4) +
                       (t & 1) * 8;
        *reinterpret_cast<float2*>(box + g * 128) =
            make_float2(dq[4 * j], dq[4 * j + 1]);
        *reinterpret_cast<float2*>(box + (g + 8) * 128) =
            make_float2(dq[4 * j + 2], dq[4 * j + 3]);
      }
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        sm90::tma_reduce_add_4d(&dq_map, dq_s, c0, h, q0 + 16 * warp, b);
        sm90::tma_reduce_add_4d(&dq_map, dq_s + 4 * kDqBox, c0 + 32, h,
                                q0 + 16 * warp, b);
        sm90::bulk_commit();
      }
    };
    if (computes_dq) dq_box(kdq, 64 * w);
    if constexpr (kBoxes == 3)
      if (w == 0) dq_box(sm90::desc_add(kdq, 2 * kKvBox), 128);
  }
  if (computes_dq && lane == 0) sm90::bulk_wait_read();

  // Epilogue: dK scaled and inverse-rotated in fp32 (tables at the key
  // positions; column j's partner j + D/2 sits in the same thread), dK and
  // dV rounded once into this consumer's rows of the (now unused) K and V
  // tiles, swizzled as the output maps' 64-row boxes, then stored by TMA
  // (rows past S are not written).
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] *= a.sm_scale;
  if constexpr (L::kRope) if (a.rope) {
#pragma unroll
    for (int jt = 0; jt < D / 16; ++jt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = half ? key_g8 : key_g;
        if (key >= a.S) continue;
        const long long at = (long long)key * D + jt * 8 + 2 * t;
        const float2 c_lo = flash::ld_pair(a.cos_t + at);
        const float2 c_hi = flash::ld_pair(a.cos_t + at + D / 2);
        const float2 s_lo = flash::ld_pair(a.sinm_t + at);
        const float2 s_hi = flash::ld_pair(a.sinm_t + at + D / 2);
        // Indices, not pointers: an address taken would move dk to
        // local memory.
        const int lo = 4 * jt + 2 * half, hi = lo + 4 * (D / 16);
        const float l0 = dk[lo], l1 = dk[lo + 1], h0 = dk[hi], h1 = dk[hi + 1];
        dk[lo] = flash::rot(l0, c_lo.x, h0, -s_lo.x);
        dk[lo + 1] = flash::rot(l1, c_lo.y, h1, -s_lo.y);
        dk[hi] = flash::rot(h0, c_hi.x, l0, -s_hi.x);
        dk[hi + 1] = flash::rot(h1, c_hi.y, l1, -s_hi.y);
      }
    }
  }
  // The other consumer's dS . K products read every row of K.
  sm90::named_sync(kBothConsumers, 256);
  // 64 keys x (columns of 4 j) of `acc`, rounded into `tile`'s rows.
  auto stage_rows = [&](uint8_t* tile, auto& acc, int j) {
    const int lo = sm90::swz_off(key_l, j, kKvBox) + 4 * t;
    const int hi = sm90::swz_off(key_l + 8, j, kKvBox) + 4 * t;
    *reinterpret_cast<uint32_t*>(tile + lo) =
        flash::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + hi) =
        flash::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  };
#pragma unroll
  for (int j = 0; j < DK / 8; ++j) stage_rows(k_tile, dk, j);
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) stage_rows(v_tile, dv, j);
  sm90::fence_proxy_async();
  sm90::named_sync(1 + w, 128);
  if (tid == 0) {
    for (int c = 0; c < kBoxes; ++c)
      sm90::tma_store_4d(&dk_map, k_tile + c * kKvBox + w * 64 * 128, c * 64,
                         h, k0 + 64 * w, b);
    for (int c = 0; c < kVBoxes; ++c)
      sm90::tma_store_4d(&dv_map, v_tile + c * kKvBox + w * 64 * 128, c * 64,
                         h, k0 + 64 * w, b);
    sm90::tma_store_wait();
  }
}

// dq = inverse_rope(acc * sm_scale) rounded to bf16 once, the rounding of
// bwd_dq_plain. One thread per 4 columns of the first half of a row and
// their partners D/2 away; rows are the [B, S, H] positions of acc.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_epilogue(const float* acc, const bf16* cos_t,
                       const bf16* sinm_t, bf16* dq, long long rows, int S,
                       int H, int rope, float sm_scale) {
  constexpr int kChunks = D / 8;  // 4-column chunks in half a row
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
    float cl[4], ch[4], sl[4], sh[4];
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float2 a0 = flash::ld_pair(cos_t + at + e);
      const float2 a1 = flash::ld_pair(cos_t + at + D / 2 + e);
      const float2 b0 = flash::ld_pair(sinm_t + at + e);
      const float2 b1 = flash::ld_pair(sinm_t + at + D / 2 + e);
      cl[e] = a0.x; cl[e + 1] = a0.y; ch[e] = a1.x; ch[e + 1] = a1.y;
      sl[e] = b0.x; sl[e + 1] = b0.y; sh[e] = b1.x; sh[e + 1] = b1.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = lo[e], h = hi[e];
      lo[e] = flash::rot(l, cl[e], h, -sl[e]);
      hi[e] = flash::rot(h, ch[e], l, -sh[e]);
    }
  }
  *reinterpret_cast<uint2*>(dq + r * D + c) =
      make_uint2(flash::pack_bf16(lo[0], lo[1]), flash::pack_bf16(lo[2], lo[3]));
  *reinterpret_cast<uint2*>(dq + r * D + c + D / 2) =
      make_uint2(flash::pack_bf16(hi[0], hi[1]), flash::pack_bf16(hi[2], hi[3]));
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const float* dlse, const void* cos_t, const void* sinm_t,
                   float* dq_acc, void* dq, void* dk, void* dv, int B, int S,
                   int H, long long in_b, long long in_s, long long in_h,
                   long long v_b, long long v_s, long long v_h, int causal,
                   int rope, cudaStream_t stream) {
  if (rope && !Smem<DK, DV>::kRope) return cudaErrorInvalidValue;
  // q (64-row boxes), k (128-row boxes) in the callers' strides, v
  // (128-row boxes) in its own; dout, dv [B, S, H, DV] and dk [B, S, H,
  // DK] contiguous in 64-row boxes.
  const long long k_b = (long long)S * H * DK, k_s = (long long)H * DK;
  const long long o_b = (long long)S * H * DV, o_s = (long long)H * DV;
  CUtensorMap maps[9] = {};
  if (!(sm90::encode_bshd(&maps[0], q, B, S, H, DK, in_b, in_s, in_h, kQ) &&
        sm90::encode_bshd(&maps[1], k, B, S, H, DK, in_b, in_s, in_h, kKeys) &&
        sm90::encode_bshd(&maps[2], v, B, S, H, DV, v_b, v_s, v_h, kKeys) &&
        sm90::encode_bshd(&maps[3], dout, B, S, H, DV, o_b, o_s, DV, kQ) &&
        sm90::encode_bshd(&maps[4], dk, B, S, H, DK, k_b, k_s, DK, 64) &&
        sm90::encode_bshd(&maps[5], dv, B, S, H, DV, o_b, o_s, DV, 64) &&
        sm90::encode_bshd_box(&maps[8], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                              dq_acc, B, S, H, DK, k_b, k_s, DK, 16)))
    return cudaErrorInvalidValue;
  // The tables' first halves (Smem says why), 64 positions per box.
  if (rope && !(sm90::encode_rows(&maps[6], cos_t, S, DK / 2, DK, kQ) &&
                sm90::encode_rows(&maps[7], sinm_t, S, DK / 2, DK, kQ)))
    return cudaErrorInvalidValue;
  Args a;
  a.cos_t = static_cast<const bf16*>(cos_t);
  a.sinm_t = static_cast<const bf16*>(sinm_t);
  a.lse = lse;
  a.delta = delta;
  a.dlse = dlse;
  a.dq_acc = dq_acc;
  a.S = S;
  a.H = H;
  a.n_qt = (S + kQ - 1) / kQ;
  a.causal = causal;
  a.rope = rope;
  // 1/sqrt(Dqk) rounded once from double, as the TPU kernels' Python
  // float.
  a.sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DK)));
  a.scale_log2 = a.sm_scale * kLog2e;
  const int smem = Smem<DK, DV>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kKeys - 1) / kKeys);
  flash_bwd_sm90_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      maps[8], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * S * H;
  const long long threads = rows * (DK / 8);
  flash_bwd_dq_epilogue<DK><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      dq_acc, a.cos_t, a.sinm_t, static_cast<bf16*>(dq), rows, S, H, rope,
      a.sm_scale);
  return cudaGetLastError();
}

}  // namespace bwd_sm90

// q, k [B, S, H, D] sharing strides (in_b, in_s, in_h), v [B, S, H, Dv]
// in strides (v_b, v_s, v_h), D stride 1, 16-byte-aligned bases and
// strides; dout [B, S, H, Dv] contiguous; lse, delta, dlse [B, H, S] fp32;
// cos_t/sinm_t [S, D]; dq_acc [B, S, H, D] fp32 scratch, zeroed by the
// caller; dq, dk [B, S, H, D] and dv [B, S, H, Dv] contiguous bf16 out.
// Takes bf16 (elem_bytes 2) at (D, Dv) = (64, 64), (128, 128) and (192,
// 128) (rope only where D == Dv); anything else returns
// cudaErrorInvalidValue, as does a tensor map the driver refuses. Returns
// the first CUDA error of its two launches (0 on success); allocates
// nothing, never syncs.
extern "C" int flash_bwd_sm90(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* dlse,
                              const void* cos_t, const void* sinm_t,
                              void* dq_acc, void* dq, void* dk, void* dv,
                              int B, int S, int H, int D, int Dv,
                              long long in_b, long long in_s, long long in_h,
                              long long v_b, long long v_s, long long v_h,
                              int causal, int rope, int elem_bytes,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const float* dlse_f = static_cast<const float*>(dlse);
  float* acc = static_cast<float*>(dq_acc);
  if (elem_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64 && Dv == 64)
    return static_cast<int>(bwd_sm90::launch<64, 64>(
        q, k, v, dout, lse_f, delta_f, dlse_f, cos_t, sinm_t, acc, dq, dk, dv,
        B, S, H, in_b, in_s, in_h, v_b, v_s, v_h, causal, rope, st));
  if (D == 128 && Dv == 128)
    return static_cast<int>(bwd_sm90::launch<128, 128>(
        q, k, v, dout, lse_f, delta_f, dlse_f, cos_t, sinm_t, acc, dq, dk, dv,
        B, S, H, in_b, in_s, in_h, v_b, v_s, v_h, causal, rope, st));
  if (D == 192 && Dv == 128)
    return static_cast<int>(bwd_sm90::launch<192, 128>(
        q, k, v, dout, lse_f, delta_f, dlse_f, cos_t, sinm_t, acc, dq, dk, dv,
        B, S, H, in_b, in_s, in_h, v_b, v_s, v_h, causal, rope, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
