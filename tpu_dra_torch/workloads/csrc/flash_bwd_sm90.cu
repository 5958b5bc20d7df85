// Flash-attention backward for Hopper (sm_90a), bf16 at head dims (q.k,
// v) = (64, 64), (128, 128) and (192, 128), as one fused pass: each CTA
// keeps one 128-key K/V tile stationary and streams the 64-row Q/dO tiles
// that attend to it, computing dK and dV in registers and adding its dQ
// partials into an fp32 accumulator; a second launch in the same C entry
// turns the accumulator into dq.
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
//    dP^T = V.dO^T (wgmma, both operands K-major in shared memory), P^T =
//    2^(s * scale * log2(e) - lse * log2(e)), dS^T = P^T * (dP^T + dlse -
//    delta), dV += P^T.dO and dK += dS^T.Q (wgmma with P^T and dS^T from
//    registers, re-packed as bf16 A fragments, and dO / Q read MN-major),
//    and dQ = dS.K (wgmma with dS^T read back from shared memory as a
//    transposed A and the stationary K as an MN-major B).
// 2. Warp specialisation. Warpgroup 0 produces: one thread issues TMA
//    loads (zero fill past S) of K and V once and of Q, dO and the Q
//    rows' rope-table halves into a ring of kStages stages; warp 1 stages
//    lse * log2(e) and dlse - delta of the stage's rows; warp 2 writes dQ
//    (item 4). Warpgroups 1 and 2 consume, 64 keys each, holding their dK
//    and dV accumulators in registers (setmaxnreg 24 / 240); every
//    pointer into shared memory stays a shared one (LDS/STS).
// 3. The consumers' schedule. Within a Q tile each product is issued as
//    soon as its operands exist, so CUDA-core work runs while a product
//    holds the tensor cores: S^T and dP^T together; P^T while dP^T runs
//    (its exponentials pinned before dP^T's wait); dS^T; dV as soon as
//    P^T is packed, running through dS^T's store and the barrier where
//    both consumers' dS^T halves meet; then dQ and dK back to back, one
//    wait for dQ, dQ's staging while dK runs, and dK's wait at the tile's
//    end. The mask's compares run only on the diagonal's and ragged
//    tiles (a branch, not predicated code that would issue on every
//    tile). The consumers stay in step and every product stays within its
//    tile: an earlier design that let them drift a tile apart (dQ of tile
//    i deferred into tile i + 1, Q(i + 1) rotated during tile i), and one
//    that let dK run on through the next tile's Q rotation, each held a
//    second tile's registers, spilled and measured slower (PERF.md). dS^T
//    has two buffers where shared memory allows, so a consumer stores the
//    next tile's while the other may still read this one's; at (192, 128)
//    one, freed by an mbarrier (ds_free) once both have read it.
// 4. dQ reduction, off the consumers. Every CTA adds its [64 x D] dQ
//    partial of each Q tile into the [B, S, H, D] fp32 accumulator: the
//    consumers stage it in swizzled shared memory (64-row by 32-column
//    fp32 boxes) and arrive on an mbarrier; warp 2 of the producer issues
//    one TMA reduce-add per box (cp.reduce.async.bulk.tensor .add.f32,
//    the reduction done in L2, rows past S dropped by the map), waits for
//    their reads and frees the staging. No consumer waits for a reduce.
//    The epilogue kernel scales, inverse-rotates and rounds the
//    accumulator once. The reductions make dq's sums run in an order that
//    changes from run to run; dk and dv are summed by one CTA in a fixed
//    order and are reproducible bit for bit.
// 5. RoPE. K is rotated once per CTA, in place (tables from L2); each
//    streamed Q tile is rotated in place by both consumers, 32 rows each,
//    from the table halves that arrive with it (the forward's scheme; only
//    the first D/2 columns of each table are read).
// 6. Launch order. Every CTA of a head streams that head's Q and dO and
//    adds into its dQ rows, so the grid runs heads in groups (launch says
//    how many: as many as keep their Q, dO and dQ accumulator within half
//    of L2, at least two), each group's K tiles heaviest first (K tile 0
//    sees the most Q tiles when causal) with its heads side by side. With
//    every head's first K tile launched together, as before, at B6 S8191
//    H16 the reduce-adds and the streamed tiles missed L2 and the kernel
//    took twice as long. Each CTA streams its Q tiles from the diagonal
//    down (with grouped K/V heads, each query head's in turn).
//
// Registers per consumer thread (of 240) at (128, 128): dK 64 + dV 64 +
// S^T 32 + dP^T 32 = 192 while S^T and dP^T run, dK 64 + dV 64 + dQ 32 +
// P^T's and dS^T's fragments 32 = 192 while dQ and dK do. dQ's columns
// are split evenly, 64 a consumer (at D=64 consumer 0 computes all 64).
//
// Grouped-query attention and a sliding window (every instance). The CTA
// of a K/V tile of K/V head hk streams the Q tiles of each of its group's
// H / Hkv query heads in turn, one flat loop (head outer, Q tile inner),
// and keeps adding into the same dK and dV registers: dK and dV are
// written once, [B, S, Hkv, D], never as per-query-head partials summed
// afterwards. dQ's reduce-adds go to the streamed head's rows. A window W
// streams only the Q tiles that meet the K tile's band: from the diagonal
// to the one holding query k0 + 127 + W - 1, four 64-row tiles at W =
// 128, where plain causal streams every tile below the diagonal. The
// mask branch takes the band's upper edge too (some query more than W - 1
// past some key), one unsigned compare per score, as the forward.
//
// Latent attention (DeepSeek-V3's MLA, (192, 128); no rope, which the
// caller applies to the 64 roped dims): dK holds 96 registers a consumer
// thread where dV holds 64, so S^T's and dP^T's whole accumulators would
// make 224, and ptxas then serialises every product. So S^T and dP^T run
// in two halves of 32 queries (200 with the first half's P^T fragments,
// which dV reads while the second half is issued). dQ is split evenly,
// 96 columns a consumer (one m64n96 product each): K is loaded in
// 32-column boxes with the 64-byte swizzle, so each half of dQ's columns
// is whole boxes of K. dQ's 48 registers leave no room for dS^T's
// fragments beside dK and dV (96 + 64 + 48 + 32 > 200, the budget after
// addresses), so dK += dS^T.Q reads dS^T from the shared-memory copy
// stored for dQ (one m64n192 product with both operands in shared
// memory), and dV is waited for before dQ and dK issue: 208. Every such
// choice follows from (Dqk, Dv) at compile time (Smem). Shared memory:
// K 48 KB + V 32 KB, two stages of Q 24 KB + dO 16 KB, one dS^T buffer
// of 16 KB, dQ's staging 48 KB and the row vectors: 226 KB. The scale is
// 1/sqrt(Dqk).
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
// dQ's staging: a tile's 64 rows by 32 fp32 columns, 128-byte swizzled:
// the box of one TMA reduce-add.
constexpr int kDqBox = kQ * 128;
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
  int Hkv, q_per_kv;   // K/V heads; query heads per K/V head, H / Hkv
  int n_kt, n_bh;      // K tiles per head, K/V heads (B * Hkv)
  int group;           // K/V heads whose K tiles run side by side (launch)
  int causal, rope;
  int window;          // 0: none; else causal keys (i - window, i]
  unsigned band;       // causal: kept iff (unsigned)(query - key) < band
  float scale_log2;    // sm_scale * log2(e)
  float sm_scale;
};

// Shared memory: K and V tiles, kStages x (Q tile, dO tile, the Q rows'
// rope-table halves), one or two dS^T tiles, dQ's staging, kStages x (lse *
// log2(e), dlse - delta of the stage's rows), then the barriers. Only an
// instance whose q.k and v share a head dim ropes (kRope). 226 KB at
// (128, 128) and at (192, 128).
template <int DK, int DV>
struct Smem {
  static constexpr bool kRope = DK == DV;
  // dQ's columns a consumer computes: half each from D=128, all on
  // consumer 0 at D=64.
  static constexpr int kDqCols = DK >= 128 ? DK / 2 : DK;
  static constexpr int kDqWarps = DK >= 128 ? kConsumerWarps : 4;
  // K's TMA boxes: 64 columns, 128-byte swizzled, or 32 columns with the
  // 64-byte swizzle where a consumer's dQ columns are not whole 64-column
  // boxes (96 at Dqk=192): dQ = dS.K then reads whole boxes of K.
  static constexpr int kKCols = kDqCols % 64 == 0 ? 64 : 32;
  static constexpr int kKBox = kKeys * kKCols * 2;
  // dK += dS^T.Q reads dS^T from shared memory where its A fragments do
  // not fit beside the dK, dV and dQ accumulators and P^T's fragments
  // (the consumer's registers less 40 for addresses and indices).
  static constexpr bool kDkFromSmem =
      DK / 2 + DV / 2 + kDqCols / 2 + 32 > kConsumerRegs - 40;
  // S^T and dP^T run in two halves of 32 queries where their whole
  // accumulators do not fit beside dK's and dV's in the same budget (224
  // registers at (192, 128): ptxas would serialise every product).
  static constexpr bool kHalves = DK / 2 + DV / 2 + 64 > kConsumerRegs - 40;
  static constexpr int kKv = DK * kKeys * 2;        // K tile
  static constexpr int kV = (DV / 64) * kKvBox;     // V tile
  static constexpr int kQt = (DK / 64) * kQBox;     // Q tile
  static constexpr int kDo = (DV / 64) * kQBox;     // dO tile
  // cos_t then sinm_t, the first D/2 columns of 64 rows, unswizzled.
  static constexpr int kTables = kRope ? 2 * kQ * DK : 0;
  static constexpr int kStage = kQt + kDo + kTables;
  static constexpr int kStage0 = kKv + kV;
  static constexpr int kDs = kStage0 + kStages * kStage;
  // Two dS^T buffers where they fit, one at (192, 128): a consumer then
  // stores tile i + 1's once both consumers' products have read tile i's
  // (an mbarrier, ds_free).
  static constexpr int kAfterDs =
      (DK / 32) * kDqBox + kStages * 2 * kQ * 4 + 8 * (4 + 3 * kStages) + 1024;
  static constexpr int kDsBufs = kDs + 2 * kDsTile + kAfterDs <= 232448 ? 2 : 1;
  static constexpr int kDq = kDs + kDsBufs * kDsTile;
  static constexpr int kRowVecs = kDq + (DK / 32) * kDqBox;  // 2 x 64 fp32 a stage
  static constexpr int kBarrierOff = kRowVecs + kStages * 2 * kQ * 4;
  static constexpr int kBytes = kBarrierOff + 8 * (4 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // base rounded up to 1 KB
  static_assert(kAlloc <= 232448, "227 KB of shared memory per block");
};

// A descriptor over a tile of kCols-column boxes (the swizzle of that
// width).
template <int kCols>
__device__ __forceinline__ uint64_t desc_box(const void* p, uint32_t lbo,
                                             uint32_t sbo) {
  if constexpr (kCols == 64) return sm90::desc_sw128(p, lbo, sbo);
  else return sm90::desc_sw64(p, lbo, sbo);
}

// S^T (or dP^T) = A . B^T for one consumer: A its 64 rows of the K (or V)
// tile in kACols-column boxes, B N of the stage's Q (or dO) rows, both
// K-major; D/16 k-steps (D the operands' head dim: Dqk for S^T, Dv for
// dP^T).
template <int D, int kACols, int N = kQ>
__device__ __forceinline__ void kq_product(float (&acc)[N / 2], uint64_t a_desc,
                                           uint64_t b_desc) {
  constexpr int kSteps = kACols / 16;  // k-steps in one box of A
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sm90::desc_add(
        a_desc, (kk / kSteps) * kKeys * kACols * 2 + (kk % kSteps) * 32);
    const uint64_t db =
        sm90::desc_add(b_desc, (kk / 4) * kQBox + (kk % 4) * 32);
    if constexpr (N == 32) sm90::wgmma_ss_m64n32<0, 0>(acc, da, db, kk > 0);
    else sm90::wgmma_ss_m64n64<0, 0>(acc, da, db, kk > 0);
  }
}

// acc (64 keys x D) += A . B: A the 64 x 64 P^T or dS^T as 4 k-steps of
// bf16 A fragments, B the stage's dO or Q tile read MN-major (LBO: the
// next 64 columns of D); k-steps [K0, K1) of them.
template <int D, int K0 = 0, int K1 = kQ / 16>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2],
                                           const uint32_t (&frag)[16],
                                           uint64_t b_desc) {
#pragma unroll
  for (int kk = K0; kk < K1; ++kk) {
    const uint64_t d = sm90::desc_add(b_desc, kk * 16 * 128);
    if constexpr (D == 192) sm90::wgmma_rs_m64n192(acc, &frag[4 * kk], d);
    else if constexpr (D == 128) sm90::wgmma_rs_m64n128(acc, &frag[4 * kk], d);
    else sm90::wgmma_rs_m64n64(acc, &frag[4 * kk], d);
  }
}

// dK (64 keys x 192) += dS^T . Q with dS^T read from shared memory: A
// this consumer's 64 rows of the dS^T tile, K-major; B the stage's Q tile,
// MN-major.
__device__ __forceinline__ void ss_dk_product(float (&acc)[96],
                                              uint64_t a_desc,
                                              uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk)
    sm90::wgmma_ss_m64n192<0, 1>(acc, sm90::desc_add(a_desc, kk * 32),
                                 sm90::desc_add(b_desc, kk * 16 * 128), 1);
}

// dQ (64 queries x N columns) = dS . K: dS^T's 128 key rows read as a
// transposed A, K's rows (kBCols-column boxes) as an MN-major B; 8 k-steps
// of 16 keys.
template <int N, int kBCols>
__device__ __forceinline__ void dq_product(float (&acc)[N / 2],
                                           uint64_t ds_desc,
                                           uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t da = sm90::desc_add(ds_desc, kk * 16 * 128);
    const uint64_t db = sm90::desc_add(k_desc, kk * 16 * kBCols * 2);
    if constexpr (N == 96) sm90::wgmma_ss_m64n96<1, 1>(acc, da, db, kk > 0);
    else sm90::wgmma_ss_m64n64<1, 1>(acc, da, db, kk > 0);
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
  constexpr int kVBoxes = DV / 64;  // of V, dO and dV
  constexpr int kDqCols = L::kDqCols;
  extern __shared__ uint8_t smem_raw[];
  // The base rounded up to 1 KB by an offset from smem_raw, so that every
  // pointer into it stays a shared-memory one (LDS/STS, not generic).
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_tile = smem;
  uint8_t* v_tile = smem + L::kKv;
  uint8_t* dq_stage = smem + L::kDq;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarrierOff);
  uint64_t* kv_full = bars;                // K and V landed
  uint64_t* dq_full = bars + 1;            // the tile's dQ staged
  uint64_t* dq_empty = bars + 2;           // its reduce-adds read it
  uint64_t* ds_free = bars + 3;            // both consumers done with dS^T
  uint64_t* full = bars + 4;               // Q, dO, tables, lse/corr landed
  uint64_t* q_ready = full + kStages;      // Q rotated by both consumers
  uint64_t* empty = q_ready + kStages;     // both consumers done with it

  // The CTA's K/V head and K tile: heads in groups of a.group, each
  // group's K tiles heaviest first (the diagonal's; causal), its heads
  // side by side.
  const int g0 = blockIdx.x / (a.group * a.n_kt) * a.group;
  const int in_group = blockIdx.x - g0 * a.n_kt;
  const int heads = min(a.group, a.n_bh - g0);
  const int bh = g0 + in_group % heads, b = bh / a.Hkv, hk = bh % a.Hkv;
  const int k0 = in_group / heads * kKeys;
  const int qt0 = a.causal ? k0 / kQ : 0;  // the diagonal's Q tile
  // Q tiles [qt0, qt1) of each query head: with a window, up to the one
  // holding the last query that sees key k0 + 127.
  const int qt1 =
      a.window ? min(a.n_qt, (k0 + kKeys + a.window - 2) / kQ + 1) : a.n_qt;
  const int n_it = (qt1 - qt0) * a.q_per_kv;
  // Iteration it streams Q tile qt of query head h: each loop below steps
  // (h, qt) along with it, head outer, tile inner (no division, which
  // the producer's 24 registers would spill). Q tiles from the last down
  // to the diagonal, heads inner and rotated by K tile so that the CTAs
  // in flight share a Q tile in L2, measured slower on an H100 at S 32767
  // (64 query heads over 4: 171.8 ms against 149.1) and spilled the (128,
  // 128) consumer (PERF.md).
  const int h0 = hk * a.q_per_kv;
  auto next = [&](int& h, int& qt) {
    if (++qt == qt1) {
      qt = qt0;
      ++h;
    }
  };
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
    sm90::mbar_init(dq_full, L::kDqWarps);
    sm90::mbar_init(dq_empty, 1);
    sm90::mbar_init(ds_free, kConsumerWarps);
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
      for (int c = 0; c < DK / L::kKCols; ++c)
        sm90::tma_load_4d(k_tile + c * L::kKBox, &k_map, kv_full,
                          c * L::kKCols, hk, k0, b);
      for (int c = 0; c < kVBoxes; ++c)
        sm90::tma_load_4d(v_tile + c * kKvBox, &v_map, kv_full, c * 64, hk,
                          k0, b);
      for (int it = 0, h = h0, qt = qt0; it < n_it; ++it, next(h, qt)) {
        const int s = it % kStages, q0 = qt * kQ;
        uint8_t* st = stage(it);
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s],
                                    L::kQt + L::kDo + (a.rope ? L::kTables : 0));
        for (int c = 0; c < DK / 64; ++c)
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
      for (int it = 0, h = h0, qt = qt0; it < n_it; ++it, next(h, qt)) {
        const int s = it % kStages, q0 = qt * kQ;
        const long long row0 = ((long long)b * a.H + h) * a.S;
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
    } else if (warp == 2 && lane == 0) {
      // The dQ writer: each tile's staged partial added into the
      // accumulator, one reduce-add per 32 columns; the staging is free
      // again once they have read it.
      for (int it = 0, h = h0, qt = qt0; it < n_it; ++it, next(h, qt)) {
        const int q0 = qt * kQ;
        sm90::mbar_wait(dq_full, it & 1);
        for (int c = 0; c < DK / 32; ++c)
          sm90::tma_reduce_add_4d(&dq_map, dq_stage + c * kDqBox, c * 32, h,
                                  q0, b);
        sm90::bulk_commit();
        sm90::bulk_wait_read();
        sm90::mbar_arrive(dq_empty);
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
  // dQ's columns [dq_c0, dq_c0 + kDqCols): half each from D=128; all of
  // them on consumer 0 at D=64.
  const bool computes_dq = DK >= 128 || w == 0;
  const int dq_c0 = DK >= 128 ? w * kDqCols : 0;

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
  constexpr uint32_t kKSbo = 8 * L::kKCols * 2;  // 8 rows of a K box
  const uint64_t kw_desc =
      desc_box<L::kKCols>(k_tile + w * 64 * L::kKCols * 2, 16, kKSbo);
  const uint64_t vw_desc = sm90::desc_sw128(v_tile + w * 64 * 128, 16, 1024);
  const uint64_t kdq_desc = desc_box<L::kKCols>(
      k_tile + (dq_c0 / L::kKCols) * L::kKBox, L::kKBox, kKSbo);

  float dk[DK / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;

  for (int it = 0, qt = qt0; it < n_it;
       ++it, qt = qt + 1 == qt1 ? qt0 : qt + 1) {
    const int s = it % kStages, phase = (it / kStages) & 1;
    // The k-steps' descriptors are computed where they are used, each
    // tile: hoisted out of the loop they would hold 48 registers.
    uint64_t kw = kw_desc, vw = vw_desc, kdq = kdq_desc;
    asm volatile("" : "+l"(kw), "+l"(vw), "+l"(kdq));
    const int q0 = qt * kQ;
    uint8_t* q_s = stage(it);
    uint8_t* do_s = q_s + L::kQt;
    const float* lse2 = row_vecs(it);
    const float* corr = lse2 + kQ;
    uint8_t* ds_s = smem + L::kDs + (it % L::kDsBufs) * kDsTile;

    sm90::mbar_wait(&full[s], phase);
    if constexpr (L::kRope) if (a.rope) {
      // Rows [32w, 32w + 32) of Q, from the table halves of the stage.
      const uint8_t* tables = q_s + L::kQt + L::kDo;
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
    // S^T and dP^T: 64 keys x 64 queries each (two halves of 32 queries
    // where kHalves).
    uint32_t pa[16], da[16];  // P^T and dS^T as bf16 A fragments
    // The diagonal's, the ragged and the window's upper edge tiles (some
    // query W or more past some key).
    const bool masked = (a.causal && q0 < k0 + kKeys) || q0 + kQ > a.S ||
                        k0 + kKeys > a.S ||
                        (a.window && q0 + kQ - 1 - k0 >= a.window);
    // P^T in place of n-tile jl of S^T's accumulator `st` (n-tile jg of the
    // tile: st[4 jl + e] is key row g (e < 2) or g + 8, query q0 + 8 jg +
    // 2t + (e & 1)), masked where `mask`.
    auto p_tile = [&](auto& st, int jl, int jg, bool mask) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * jg + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmaf_rn(st[4 * jl + e], a.scale_log2, -(e & 1 ? l2.y : l2.x));
        if (mask) {
          const int query = q0 + 8 * jg + 2 * t + (e & 1);
          const int key = e < 2 ? key_g : key_g8;
          if ((a.causal && static_cast<unsigned>(query - key) >= a.band) ||
              query >= a.S || key >= a.S)
            x = kNegInf;
        }
        st[4 * jl + e] = sm90::ex2(x);
      }
    };
    // dS^T in place of n-tile jl of dP^T's accumulator `dpt` from P^T's
    // `pt`, then P^T's and dS^T's fragments of the tile's n-tile jg.
    auto ds_tile = [&](auto& pt, auto& dpt, int jl, int jg) {
      const float2 cr = *reinterpret_cast<const float2*>(corr + 8 * jg + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * jl + e] =
            pt[4 * jl + e] * (dpt[4 * jl + e] + (e & 1 ? cr.y : cr.x));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pa[2 * jg + i] = flash::pack_bf16(pt[4 * jl + 2 * i], pt[4 * jl + 2 * i + 1]);
        da[2 * jg + i] = flash::pack_bf16(dpt[4 * jl + 2 * i], dpt[4 * jl + 2 * i + 1]);
      }
    };
    // dS^T's fragments of n-tiles [j0, j1) into shared memory (rows =
    // keys, 64 query columns, swizzled as one 128-row box) for dQ = dS . K;
    // with one buffer, once both consumers' products of the previous tile
    // have read it (with two, the other buffer's readers finished a tile
    // ago).
    auto store_ds = [&](int j0, int j1) {
      if constexpr (L::kDsBufs == 1)
        if (j0 == 0) sm90::mbar_wait(ds_free, (it & 1) ^ 1);
#pragma unroll
      for (int j = j0; j < j1; ++j) {
        *reinterpret_cast<uint32_t*>(ds_s + sm90::swz_off(key_l, j, kDsTile) +
                                     4 * t) = da[2 * j];
        *reinterpret_cast<uint32_t*>(
            ds_s + sm90::swz_off(key_l + 8, j, kDsTile) + 4 * t) = da[2 * j + 1];
      }
    };
    const uint64_t do_mn = sm90::desc_sw128(do_s, kQBox, 1024);
    if constexpr (!L::kHalves) {
      float sc[32], dp[32];
      sm90::wgmma_fence();
      kq_product<DK, L::kKCols>(sc, kw, sm90::desc_sw128(q_s, 16, 1024));
      sm90::wgmma_commit();
      kq_product<DV, 64>(dp, vw, sm90::desc_sw128(do_s, 16, 1024));
      sm90::wgmma_commit();
      // P^T while dP^T runs (pinned before its wait). Two loops, not one
      // with a predicated mask: the mask's compares would issue on every
      // tile, where only the diagonal's and ragged ones need them.
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      if (masked) {
#pragma unroll
        for (int j = 0; j < 8; ++j) p_tile(sc, j, j, true);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) p_tile(sc, j, j, false);
      }
      sm90::fence_regs(sc);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) ds_tile(sc, dp, j, j);
      // dV += P^T . dO as soon as P^T is packed: it runs through dS^T's
      // store and the barrier. (Packed before dS^T, P^T's fragments would
      // sit beside S^T, dP^T, dK and dV, and the consumer spills.)
      sm90::wgmma_fence();
      rs_product<DV>(dv, pa, do_mn);
      sm90::wgmma_commit();
      store_ds(0, 8);
    } else {
      // Per half: S^T and dP^T, P^T and dS^T (one loop, the mask
      // predicated: two would spill), then the half's two k-steps of dV,
      // which run while the next half is issued.
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float sh[16], dh[16];
        // The half's descriptors made here, not hoisted (they would spill).
        uint64_t kwh = kw, vwh = vw,
                 qh = sm90::desc_sw128(q_s + hf * 32 * 128, 16, 1024),
                 doh = sm90::desc_sw128(do_s + hf * 32 * 128, 16, 1024);
        asm volatile("" : "+l"(kwh), "+l"(vwh), "+l"(qh), "+l"(doh));
        sm90::wgmma_fence();
        kq_product<DK, L::kKCols, 32>(sh, kwh, qh);
        sm90::wgmma_commit();
        kq_product<DV, 64, 32>(dh, vwh, doh);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(pa);
        sm90::fence_regs(sh);
        sm90::fence_regs(dh);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p_tile(sh, j, 4 * hf + j, masked);
          ds_tile(sh, dh, j, 4 * hf + j);
        }
        sm90::wgmma_fence();
        if (hf == 0) rs_product<DV, 0, 2>(dv, pa, do_mn);
        else rs_product<DV, 2, 4>(dv, pa, do_mn);
        sm90::wgmma_commit();
        store_ds(4 * hf, 4 * hf + 4);
      }
    }
    sm90::fence_proxy_async();
    // Both consumers' dS^T stored (and, on the first tile, both halves of
    // K rotated).
    sm90::named_sync(kBothConsumers, 256);

    // dQ, then dK, back to back.
    if constexpr (L::kDkFromSmem) {
      sm90::wgmma_wait<0>();  // dV: P^T's fragments free for dQ's sums
      sm90::fence_regs(dv);
      sm90::fence_regs(pa);
    }
    float dq[kDqCols / 2];
    auto issue_dq = [&]() {
      dq_product<kDqCols, L::kKCols>(dq, sm90::desc_sw128(ds_s, kDsTile, 1024),
                                     kdq);
      sm90::wgmma_commit();
    };
    sm90::wgmma_fence();
    if constexpr (DK >= 128) issue_dq();
    if constexpr (L::kDkFromSmem)
      ss_dk_product(dk, sm90::desc_sw128(ds_s + w * 64 * 128, 16, 1024),
                    sm90::desc_sw128(q_s, kQBox, 1024));
    else
      rs_product<DK>(dk, da, sm90::desc_sw128(q_s, kQBox, 1024));
    sm90::wgmma_commit();
    if constexpr (DK >= 128) {
      sm90::wgmma_wait<1>();  // dV and dQ; dK still runs
    } else {
      // Consumer 0 alone computes dQ, in a branch, where a product must
      // find none in flight (ptxas would serialise every product).
      sm90::wgmma_wait<0>();
      if (computes_dq) {
        sm90::wgmma_fence();
        issue_dq();
        sm90::wgmma_wait<0>();
      }
    }
    if constexpr (!L::kDkFromSmem) {
      sm90::fence_regs(dv);
      sm90::fence_regs(pa);
    }
    if (computes_dq) {
      sm90::fence_regs(dq);
      // This warp's dQ partial, rows q0 + 16 warp + [0, 16) by kDqCols
      // columns (fragment rows g, g + 8; columns 8j + 2t), staged into the
      // swizzled 64 x 32 boxes once the writer has read the previous tile's.
      sm90::mbar_wait(dq_empty, (it & 1) ^ 1);
      uint8_t* dq_s = dq_stage + (dq_c0 / 32) * kDqBox + (16 * warp + g) * 128 +
                      (t & 1) * 8;
#pragma unroll
      for (int j = 0; j < kDqCols / 8; ++j) {
        const int chunk = 2 * (j % 4) + t / 2;  // 16-byte chunk in its box
        uint8_t* at = dq_s + (j / 4) * kDqBox + ((chunk ^ g) << 4);
        *reinterpret_cast<float2*>(at) = make_float2(dq[4 * j], dq[4 * j + 1]);
        *reinterpret_cast<float2*>(at + 8 * 128) =
            make_float2(dq[4 * j + 2], dq[4 * j + 3]);
      }
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(dq_full);
    }
    sm90::wgmma_wait<0>();  // dK
    sm90::fence_regs(dk);
    if constexpr (!L::kDkFromSmem) sm90::fence_regs(da);
    __syncwarp();
    if (lane == 0) {
      sm90::mbar_arrive(&empty[s]);  // Q, dO, lse/corr read
      if constexpr (L::kDsBufs == 1) sm90::mbar_arrive(ds_free);
    }
  }

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
    for (int c = 0; c < DK / 64; ++c)
      sm90::tma_store_4d(&dk_map, k_tile + c * kKvBox + w * 64 * 128, c * 64,
                         hk, k0 + 64 * w, b);
    for (int c = 0; c < kVBoxes; ++c)
      sm90::tma_store_4d(&dv_map, v_tile + c * kKvBox + w * 64 * 128, c * 64,
                         hk, k0 + 64 * w, b);
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
                   int H, int Hkv, long long q_b, long long q_s, long long q_h,
                   long long k_b, long long k_s, long long k_h, long long v_b,
                   long long v_s, long long v_h, int causal, int window,
                   int rope, cudaStream_t stream) {
  if (rope && !Smem<DK, DV>::kRope) return cudaErrorInvalidValue;
  if (Hkv < 1 || H % Hkv || window < 0 || (window && !causal))
    return cudaErrorInvalidValue;
  // q (64-row boxes), k (128-row boxes of Smem's kKCols columns) and v
  // (128-row boxes) in the callers' strides; dout [B, S, H, DV], dk [B, S,
  // Hkv, DK] and dv [B, S, Hkv, DV] contiguous in 64-row boxes; dQ's
  // accumulator [B, S, H, DK] in boxes of a tile's 64 rows by 32 columns.
  const long long a_b = (long long)S * H * DK, a_s = (long long)H * DK;
  const long long o_b = (long long)S * H * DV, o_s = (long long)H * DV;
  const long long dk_b = (long long)S * Hkv * DK, dk_s = (long long)Hkv * DK;
  const long long dv_b = (long long)S * Hkv * DV, dv_s = (long long)Hkv * DV;
  CUtensorMap maps[9] = {};
  if (!(sm90::encode_bshd(&maps[0], q, B, S, H, DK, q_b, q_s, q_h, kQ) &&
        sm90::encode_bshd(&maps[1], k, B, S, Hkv, DK, k_b, k_s, k_h, kKeys,
                          Smem<DK, DV>::kKCols * 2) &&
        sm90::encode_bshd(&maps[2], v, B, S, Hkv, DV, v_b, v_s, v_h, kKeys) &&
        sm90::encode_bshd(&maps[3], dout, B, S, H, DV, o_b, o_s, DV, kQ) &&
        sm90::encode_bshd(&maps[4], dk, B, S, Hkv, DK, dk_b, dk_s, DK, 64) &&
        sm90::encode_bshd(&maps[5], dv, B, S, Hkv, DV, dv_b, dv_s, DV, 64) &&
        sm90::encode_bshd_box(&maps[8], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                              dq_acc, B, S, H, DK, a_b, a_s, DK, kQ)))
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
  a.Hkv = Hkv;
  a.q_per_kv = H / Hkv;
  a.n_kt = (S + kKeys - 1) / kKeys;
  a.n_bh = B * Hkv;
  // K/V heads in flight together: every CTA of a K/V head reads its query
  // heads' Q and dO and adds into their dQ rows, so as many as keep those
  // within half of L2 (25 MB) share the card at a time, and the reads and
  // the reduce-adds hit L2; at least two (one head's tail beside the next
  // head's heavy tiles), a power of two.
  const long long head_bytes =
      (long long)S * a.q_per_kv * (DK * 4 + (DK + DV) * 2);
  a.group = 2;
  while (a.group * 2 <= B * Hkv && a.group * 2 * head_bytes <= (25ll << 20))
    a.group *= 2;
  a.causal = causal;
  a.rope = rope;
  a.window = window;
  a.band = window ? static_cast<unsigned>(window) : 0x80000000u;
  // 1/sqrt(Dqk) rounded once from double, as the TPU kernels' Python
  // float.
  a.sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DK)));
  a.scale_log2 = a.sm_scale * kLog2e;
  const int smem = Smem<DK, DV>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_kt * a.n_bh);
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

// q [B, S, H, D] in strides (q_b, q_s, q_h), k [B, S, Hkv, D] in (k_b,
// k_s, k_h), v [B, S, Hkv, Dv] in (v_b, v_s, v_h), D stride 1, 16-byte-
// aligned bases and strides, Hkv dividing H; dout [B, S, H, Dv]
// contiguous; lse, delta, dlse [B, H, S] fp32; cos_t/sinm_t [S, D];
// dq_acc [B, S, H, D] fp32 scratch, zeroed by the caller; dq [B, S, H,
// D], dk [B, S, Hkv, D] and dv [B, S, Hkv, Dv] contiguous bf16 out;
// window 0 (none) or W > 0 with causal. Takes bf16 (elem_bytes 2) at (D,
// Dv) = (64, 64), (128, 128) and (192, 128) (rope only where D == Dv);
// anything else returns cudaErrorInvalidValue, as does a tensor map the
// driver refuses. Returns the first CUDA error of its two launches (0 on
// success); allocates nothing, never syncs.
extern "C" int flash_bwd_sm90(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* dlse,
                              const void* cos_t, const void* sinm_t,
                              void* dq_acc, void* dq, void* dk, void* dv,
                              int B, int S, int H, int Hkv, int D, int Dv,
                              long long q_b, long long q_s, long long q_h,
                              long long k_b, long long k_s, long long k_h,
                              long long v_b, long long v_s, long long v_h,
                              int causal, int window, int rope,
                              int elem_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const float* dlse_f = static_cast<const float*>(dlse);
  float* acc = static_cast<float*>(dq_acc);
  if (elem_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64 && Dv == 64)
    return static_cast<int>(bwd_sm90::launch<64, 64>(
        q, k, v, dout, lse_f, delta_f, dlse_f, cos_t, sinm_t, acc, dq, dk, dv,
        B, S, H, Hkv, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, causal,
        window, rope, st));
  if (D == 128 && Dv == 128)
    return static_cast<int>(bwd_sm90::launch<128, 128>(
        q, k, v, dout, lse_f, delta_f, dlse_f, cos_t, sinm_t, acc, dq, dk, dv,
        B, S, H, Hkv, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, causal,
        window, rope, st));
  if (D == 192 && Dv == 128)
    return static_cast<int>(bwd_sm90::launch<192, 128>(
        q, k, v, dout, lse_f, delta_f, dlse_f, cos_t, sinm_t, acc, dq, dk, dv,
        B, S, H, Hkv, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, causal,
        window, rope, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
