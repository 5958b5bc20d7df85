// Flash-attention forward for Hopper (sm_90a), bf16 at head dims (q.k, v)
// = (64, 64), (128, 128) and (192, 128): causal or full attention of one
// 128-row Q tile against every 128-key K/V tile it needs, with RoPE fused
// where q.k and v share a head dim, writing O and the per-row logsumexp.
// Grouped-query attention (H query heads over Hkv K/V heads, query head h
// reading K/V head h / (H / Hkv)) and a causal sliding window (query i
// sees keys j with i - W < j <= i) at every instance.
// TMA loads into a ring of shared-memory stages, a producer warpgroup and
// two consumer warpgroups running wgmma.
//
// Replaces tpu_dra/workloads/flashattention.py:_fwd_kernel (reached
// through _fwd_call) and _fwd_stream_kernel (_fwd_call_stream) for bf16
// at D 64 and 128, which carries every forward of the flagship,
// long_ctx and long_ctx_xl paths, and carries the latent attention of the
// DeepSeek-V3 family (dsv3_model.py), which the reference does not have.
// fp32 inputs and the other bf16 head dims stay on flash_fwd.cu
// (_flash_kernels.fwd_route says which).
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at the
// flagship shape (B8 S1023 H16 D128, causal) 34 GFLOP against 135 MB of
// compulsory traffic, so bytes bound it at 0.040 ms; at B1 S16384 H16
// D128, 1.1 TFLOP against 0.27 GB, operations at 1.11 ms.
//
// What the design does about what held flash_fwd.cu back:
// 1. Warp-level products. Both products are warpgroup wgmma: S = Q.K^T
//    as m64n128k16 with Q and K K-major in shared memory, O += P.V as
//    m64nDk16 with P from registers (the score accumulator re-packed as
//    A fragments, the mma.sync layout) and V MN-major (transposed B).
// 2. Synchronous staging. One producer thread issues TMA loads (128-byte
//    swizzle, zero fill past S) into a ring of kStages stages with
//    full/empty mbarriers. K and V land and are released apart, and K is
//    loaded a tile ahead of V: its stage frees once Q.K^T has read it, a
//    softmax before V's. Q (32 KB at D=128) + 2 x (K, V and the K rows'
//    rope tables, 96 KB) = 224 KB of shared memory.
// 3. RoPE per K tile per Q tile. The stage's cos/sinm rows arrive with K
//    by TMA; each consumer rotates its 64 rows of K(i + 1) in place (the
//    swizzle keeps column c and c + D/2 in known 16-byte chunks) after
//    tile i's softmax, while P.V(i - 1) runs, then fences them for the
//    async proxy and arrives on the stage's k_ready barrier. Q is rotated
//    once. A 128-row Q tile halves the rotations of each K tile against
//    64-row tiles. It still costs: a rotation adds about as much CUDA-core
//    work per tile as the softmax (PERF.md, the forward with and without
//    rope).
// 4. Small CTAs and slow exponentials. 384 threads own 128 Q rows; the
//    producer gives up registers (setmaxnreg.dec to 40) so each consumer
//    thread may hold S (64), O (64) and P (32) at D=128 (setmaxnreg.inc
//    to 232). The softmax runs in base 2: scores are scaled by
//    sm_scale * log2(e) after the dot (on unmasked tiles inside the
//    exponent's FMA) and p = ex2.approx(s - m); lse is m * ln(2) + log(l).
//    Within a consumer, Q.K^T of tile i and P.V of tile i-1 are issued
//    together and tile i's softmax runs while P.V still occupies the
//    tensor cores; the two consumers share the tensor cores besides. (An
//    explicit ping-pong between them, FA3's named-barrier turns, and a
//    persistent block per SM walking the tiles measured no faster over
//    both paths' shapes; PERF.md.)
//
// Latent attention (DeepSeek-V2/V3's MLA, (192, 128)): q and k carry 128
// "nope" and 64 roped dims, v 128; the caller ropes the 64 dims, so this
// instance takes no tables (rope refused). Q.K^T runs 12 k-steps where the
// (128, 128) instance runs 8; S, O and P hold the same registers (the key
// tile and v's width are the same), and Q (48 KB) + 2 x (K 48 KB, V 32 KB)
// = 208 KB of shared memory. The scale is 1/sqrt(Dqk).
//
// Grouped-query attention costs nothing per tile: the CTA of query head h
// loads K/V head h / (H / Hkv), whose tiles its neighbours in the grid
// (the other query heads of the group) read from L2. A window W visits
// only the key tiles from the one holding key q0 - W + 1 up to the
// diagonal: ceil((W - 1) / 128) + 1 tiles a Q tile, not qt + 1. At W =
// 128 that is two, and a window call is bound by its q, k, v and o bytes,
// where a global call at S = 32768 is bound by operations. The window's compares run
// only on the band's edge tiles (the mask branch, as on the diagonal),
// one unsigned compare per score: kept iff (unsigned)(row - col) < band,
// band = W, or 2^31 for plain causal (row >= col).
//
// Rounding points are the TPU kernels': roped q/k rounded to bf16 before
// the dot, scores scaled after it, masked scores -1e30 (only on the
// diagonal and ragged tiles; keys >= S are masked in every mode),
// unnormalised p rounded to bf16 before P.V while the denominator sums
// fp32 p, O divided by it before rounding.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace flash_sm90 {

using flash::bf16;
using flash::kNegInf;

constexpr int kRows = 128;          // Q rows per CTA, keys per K/V tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kThreads = 384;       // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumerWarps = 8;
constexpr int kBoxBytes = kRows * 128;  // 128 rows x 64 bf16 columns
constexpr int kHalfBoxBytes = 64 * 128; // one consumer's 64 rows of a box
// 40 x 128 + 232 x 256 = 168 x 384: the registers the block starts with
// under __launch_bounds__(384, 1). (24 for the producer spills its loop.)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const bf16* cos_t;   // [S, D] rope tables, read only when rope
  const bf16* sinm_t;
  float* lse;          // [B, H, S]
  int S, H, n_tiles;   // n_tiles = ceil(S / 128), Q and K alike
  int group;           // query heads per K/V head, H / Hkv
  int causal, rope;
  int window;          // 0: none; else causal keys (i - window, i]
  unsigned band;       // causal: kept iff (unsigned)(row - col) < band
  float scale_log2;    // sm_scale * log2(e)
};

// Shared memory: Q tile, then kStages x (K tile, V tile, the stage's rope
// table rows), then barriers. The table rows are the first D/2 columns of
// cos_t then of sinm_t for the stage's 128 positions, unswizzled (D bytes
// a row): the kernel reads only those halves, since cos_t's second half
// repeats its first and sinm_t's is its negation (the port's
// _rope_tables builds them so). Only an instance whose q.k and v share a
// head dim ropes (kRope). 224 KB at (128, 128), 208 KB at (192, 128).
template <int DK, int DV>
struct Smem {
  static constexpr bool kRope = DK == DV;
  static constexpr int kTile = (DK / 64) * kBoxBytes;  // Q or K
  static constexpr int kVTile = (DV / 64) * kBoxBytes;
  static constexpr int kTables = kRope ? kTile : 0;     // both half tables
  static constexpr int kStage = kTile + kVTile + kTables;
  static constexpr int kBarrierOff = kTile + kStages * kStage;
  static constexpr int kBytes = kBarrierOff + 8 * (1 + 5 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // base rounded up to 1 KB
};

// Q rows: the tables from global memory (L2), once per block.
template <int D>
__device__ __forceinline__ void rope_q(uint8_t* q_tile, int r0, int q0, int S,
                                       const bf16* cos_t, const bf16* sinm_t,
                                       int tid) {
  sm90::rope_rows<D, kBoxBytes, 64>(
      q_tile, r0, q0, S, tid, [&](int pos, int, int j, uint4& c, uint4& s) {
        const long long at = (long long)pos * D + j * 8;
        c = __ldg(reinterpret_cast<const uint4*>(cos_t + at));
        s = __ldg(reinterpret_cast<const uint4*>(sinm_t + at));
      });
}

// K rows of one stage: the table rows came with it by TMA (Smem).
template <int D>
__device__ __forceinline__ void rope_k(uint8_t* k_tile, int r0, int k0, int S,
                                       int tid) {
  const uint8_t* tables = k_tile + Smem<D, D>::kTile + Smem<D, D>::kVTile;
  sm90::rope_rows<D, kBoxBytes, 64>(
      k_tile, r0, k0, S, tid, [&](int, int r, int j, uint4& c, uint4& s) {
        const uint8_t* at = tables + r * D + j * 16;
        c = *reinterpret_cast<const uint4*>(at);
        s = *reinterpret_cast<const uint4*>(at + kRows * D);
      });
}

// O += P . V for one 128-key tile: P as 8 k-steps of A fragments.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pa)[32],
                                           uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const uint64_t d = sm90::desc_add(v_desc, kk * 16 * 128);
    if constexpr (D == 128) sm90::wgmma_rs_m64n128(o, &pa[4 * kk], d);
    else sm90::wgmma_rs_m64n64(o, &pa[4 * kk], d);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map,
                          const __grid_constant__ CUtensorMap cos_map,
                          const __grid_constant__ CUtensorMap sinm_map,
                          const Args a) {
  using L = Smem<DK, DV>;
  constexpr int kBoxes = DK / 64;   // of Q and K
  constexpr int kVBoxes = DV / 64;  // of V and O
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_tile = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarrierOff);
  uint64_t* q_full = bars;
  // Per stage: K (with its table rows) and V land, and are released,
  // apart: K is free once Q.K^T has read it, so the next K's load and
  // rotation start a softmax and a P.V earlier than V's.
  uint64_t* full_k = bars + 1;             // K and its table rows landed
  uint64_t* full_v = full_k + kStages;     // V landed
  uint64_t* k_ready = full_v + kStages;    // K rotated by both consumers
  uint64_t* empty_k = k_ready + kStages;   // both consumers done with K
  uint64_t* empty_v = empty_k + kStages;   // ... and with V

  const int qt = a.n_tiles - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int hk = h / a.group;  // the K/V head this query head reads
  const int q0 = qt * kRows;
  // Key tiles [kt0, kt0 + n_kt): from the first (or, with a window, the
  // one holding key q0 - W + 1) up to the diagonal, or all of them.
  const int kt0 = a.window ? max(0, q0 - a.window + 1) / kRows : 0;
  const int n_kt = (a.causal ? qt + 1 : a.n_tiles) - kt0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&k_ready[s], kConsumerWarps);
      sm90::mbar_init(&empty_k[s], kConsumerWarps);
      sm90::mbar_init(&empty_v[s], kConsumerWarps);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warpgroup -------------------------------------------
    sm90::regs_dec<kProducerRegs>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(q_full, L::kTile);
      for (int c = 0; c < kBoxes; ++c)
        sm90::tma_load_4d(q_tile + c * kBoxBytes, &q_map, q_full, c * 64, h,
                          q0, b);
      // K (and its table rows) of tile it, once Q.K^T(it - kStages) has
      // released the stage.
      auto load_k = [&](int it) {
        const int s = it % kStages;
        uint8_t* k_tile = smem + L::kTile + s * L::kStage;
        sm90::mbar_wait(&empty_k[s], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full_k[s],
                                    L::kTile + (a.rope ? L::kTables : 0));
        const int k0 = (kt0 + it) * kRows;
        for (int c = 0; c < kBoxes; ++c)
          sm90::tma_load_4d(k_tile + c * kBoxBytes, &k_map, &full_k[s],
                            c * 64, hk, k0, b);
        if constexpr (L::kRope) {
          if (a.rope) {
            uint8_t* tables = k_tile + L::kTile + L::kVTile;
            sm90::tma_load_2d(tables, &cos_map, &full_k[s], 0, k0);
            sm90::tma_load_2d(tables + L::kTables / 2, &sinm_map, &full_k[s],
                              0, k0);
          }
        }
      };
      // V of tile it, once P.V(it - kStages) has released the stage.
      auto load_v = [&](int it) {
        const int s = it % kStages;
        uint8_t* v_tile = smem + 2 * L::kTile + s * L::kStage;
        sm90::mbar_wait(&empty_v[s], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full_v[s], L::kVTile);
        for (int c = 0; c < kVBoxes; ++c)
          sm90::tma_load_4d(v_tile + c * kBoxBytes, &v_map, &full_v[s],
                            c * 64, hk, (kt0 + it) * kRows, b);
      };
      // K runs a tile ahead of V: its stage frees a softmax earlier, and
      // the consumers rotate it a tile before they multiply by it.
      load_k(0);
      for (int it = 0; it < n_kt; ++it) {
        if (it + 1 < n_kt) load_k(it + 1);
        load_v(it);
      }
    }
    return;
  }

  // ---- consumer warpgroups: w owns Q rows [64w, 64w + 64) --------------
  sm90::regs_inc<kConsumerRegs>();
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row_l = 64 * w + 16 * warp + g;  // tile row of fragment row g
  const int row_g = q0 + row_l, row_g8 = row_g + 8;

  // Rotate this consumer's half of the K tile in stage `s` (tile `it`),
  // make it visible to wgmma and count this warp on k_ready[s].
  auto rotate_k = [&](int it) {
    const int s = it % kStages;
    uint8_t* k_tile = smem + L::kTile + s * L::kStage;
    sm90::mbar_wait(&full_k[s], (it / kStages) & 1);
    if constexpr (L::kRope)
      rope_k<DK>(k_tile, 64 * w, (kt0 + it) * kRows, a.S, tid);
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&k_ready[s]);
  };

  sm90::mbar_wait(q_full, 0);
  if constexpr (L::kRope) {
    if (a.rope) {
      rope_q<DK>(q_tile, 64 * w, q0, a.S, a.cos_t, a.sinm_t, tid);
      sm90::fence_proxy_async();
      sm90::named_sync(1 + w, 128);
      rotate_k(0);
    }
  }
  const uint64_t q_desc = sm90::desc_sw128(q_tile + w * kHalfBoxBytes, 16, 1024);

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // in log2 units (scaled scores)
  float l_run[2] = {0.f, 0.f};          // this thread's share of the sums
  float sc[64];     // S of the current tile, then its p in fp32
  uint32_t pa[32];  // p of the previous tile as bf16 A fragments

  auto stage = [&](int it) { return smem + L::kTile + (it % kStages) * L::kStage; };
  auto release = [&](uint64_t* bars_, int it) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars_[it % kStages]);
  };
  auto wait_k = [&](int it) {
    sm90::mbar_wait(&full_k[it % kStages], (it / kStages) & 1);
    if (a.rope) sm90::mbar_wait(&k_ready[it % kStages], (it / kStages) & 1);
  };
  // S = Q . K^T of tile `it`: 64 rows x 128 keys, DK/16 k-steps (issued).
  auto issue_qk = [&](int it) {
    const uint64_t k_desc = sm90::desc_sw128(stage(it), 16, 1024);
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      sm90::wgmma_ss_m64n128(sc, sm90::desc_add(q_desc, off),
                             sm90::desc_add(k_desc, off), kk > 0);
    }
  };
  // O += P . V of tile `it`, V MN-major (LBO: the next 64 columns of D).
  auto issue_pv = [&](int it) {
    pv_product<DV>(o, pa, sm90::desc_sw128(stage(it) + L::kTile, kBoxBytes,
                                           1024));
  };
  // Scale (base 2), mask and exponentiate tile `it` in sc; corr is the
  // factor the running O and sums take, rs this tile's row sums.
  // Fragment: sc[4j + e] is row g (e < 2) or g + 8, key k0 + 8j + 2t +
  // (e & 1).
  float corr[2], rs[2];
  // Unmasked tiles fold the scale into the exponent's FMA (the max of
  // the raw scores, scaled, is the max of the scaled ones).
  auto softmax = [&](int it) {
    const int k0 = (kt0 + it) * kRows;
    // The diagonal's, the ragged and the window's lower edge tiles (some
    // row's band starts above k0).
    const bool masked = (a.causal && kt0 + it == qt) || k0 + kRows > a.S ||
                        (a.window && k0 < q0 + kRows - a.window);
    float mx[2] = {m_run[0], m_run[1]};
    if (masked) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * a.scale_log2;
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? row_g : row_g8;
          if ((a.causal && static_cast<unsigned>(row - col) >= a.band) ||
              col >= a.S)
            x = kNegInf;
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    } else {
      float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i)
        raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], sc[i]);
      mx[0] = fmaxf(mx[0], raw[0] * a.scale_log2);
      mx[1] = fmaxf(mx[1], raw[1] * a.scale_log2);
    }
    mx[0] = flash::quad_max(mx[0]);
    mx[1] = flash::quad_max(mx[1]);
    corr[0] = sm90::ex2(m_run[0] - mx[0]);
    corr[1] = sm90::ex2(m_run[1] - mx[1]);
    m_run[0] = mx[0];
    m_run[1] = mx[1];
    rs[0] = rs[1] = 0.f;
    if (masked) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = sm90::ex2(sc[i] - mx[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += sc[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = sm90::ex2(__fmaf_rn(sc[i], a.scale_log2, -mx[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += sc[i];
      }
    }
  };
  // Fold tile `it`'s softmax in once the previous P.V has finished:
  // rescale O and the sums, and P to bf16 A fragments (k-step kk =
  // n-tiles 2kk and 2kk + 1).
  auto fold = [&]() {
    l_run[0] = l_run[0] * corr[0] + rs[0];
    l_run[1] = l_run[1] * corr[1] + rs[1];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      pa[i] = flash::pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };

  // Software pipeline within the warpgroup: Q.K^T of tile it and P.V of
  // tile it - 1 are issued together; tile it's softmax, then the
  // rotation of this consumer's half of K(it + 1), run while P.V(it - 1)
  // still occupies the tensor cores.
  wait_k(0);
  sm90::wgmma_fence();
  issue_qk(0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  release(empty_k, 0);
  softmax(0);
  if (a.rope && n_kt > 1) rotate_k(1);
  fold();
  for (int it = 1; it < n_kt; ++it) {
    wait_k(it);
    sm90::mbar_wait(&full_v[(it - 1) % kStages], ((it - 1) / kStages) & 1);
    sm90::fence_regs(o);
    sm90::fence_regs(pa);
    sm90::wgmma_fence();
    issue_qk(it);
    sm90::wgmma_commit();
    issue_pv(it - 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // Q.K^T(it) done, P.V(it - 1) may run on
    sm90::fence_regs(sc);
    release(empty_k, it);
    softmax(it);
    if (a.rope && it + 1 < n_kt) rotate_k(it + 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(pa);
    release(empty_v, it - 1);
    fold();
  }
  sm90::mbar_wait(&full_v[(n_kt - 1) % kStages], ((n_kt - 1) / kStages) & 1);
  sm90::fence_regs(o);
  sm90::fence_regs(pa);
  sm90::wgmma_fence();
  issue_pv(n_kt - 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  sm90::fence_regs(pa);
  release(empty_v, n_kt - 1);

  // Epilogue: O / l rounded to bf16 into this warpgroup's (now unused) Q
  // rows, swizzled as the O map's 64-row box, then one TMA store per box
  // (rows past S are not written). Divide first, then round, as the TPU
  // kernel does.
  const float l0 = flash::quad_sum(l_run[0]), l1 = flash::quad_sum(l_run[1]);
  sm90::named_sync(1 + w, 128);  // every warp's Q.K^T reads are done
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    uint8_t* lo = q_tile + sm90::swz_off(row_l, j, kBoxBytes) + 4 * t;
    uint8_t* hi = q_tile + sm90::swz_off(row_l + 8, j, kBoxBytes) + 4 * t;
    *reinterpret_cast<uint32_t*>(lo) =
        flash::pack_bf16(o[4 * j] / l0, o[4 * j + 1] / l0);
    *reinterpret_cast<uint32_t*>(hi) =
        flash::pack_bf16(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
  sm90::fence_proxy_async();
  sm90::named_sync(1 + w, 128);
  if (tid == 0) {
    for (int c = 0; c < kVBoxes; ++c)
      sm90::tma_store_4d(&o_map, q_tile + c * kBoxBytes + w * kHalfBoxBytes,
                         c * 64, h, q0 + 64 * w, b);
    sm90::tma_store_wait();
  }
  if (t == 0) {
    float* lse = a.lse + (long long)bh * a.S;
    if (row_g < a.S) lse[row_g] = m_run[0] * kLn2 + logf(l0);
    if (row_g8 < a.S) lse[row_g8] = m_run[1] * kLn2 + logf(l1);
  }
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* cos_t, const void* sinm_t, void* o, float* lse,
                   int B, int S, int H, int Hkv, long long q_b, long long q_s,
                   long long q_h, long long k_b, long long k_s, long long k_h,
                   long long v_b, long long v_s, long long v_h, int causal,
                   int window, int rope, cudaStream_t stream) {
  if (rope && !Smem<DK, DV>::kRope) return cudaErrorInvalidValue;
  if (Hkv < 1 || H % Hkv || window < 0 || (window && !causal))
    return cudaErrorInvalidValue;
  CUtensorMap maps[6] = {};
  if (!(sm90::encode_bshd(&maps[0], q, B, S, H, DK, q_b, q_s, q_h, kRows) &&
        sm90::encode_bshd(&maps[1], k, B, S, Hkv, DK, k_b, k_s, k_h, kRows) &&
        sm90::encode_bshd(&maps[2], v, B, S, Hkv, DV, v_b, v_s, v_h, kRows)))
    return cudaErrorInvalidValue;
  // o: [B, S, H, DV] contiguous, stored 64 rows (one consumer) per box.
  if (!sm90::encode_bshd(&maps[3], o, B, S, H, DV, (long long)S * H * DV,
                         (long long)H * DV, DV, 64))
    return cudaErrorInvalidValue;
  // The tables' first halves (Smem says why), 128 positions per box.
  if (rope && !(sm90::encode_rows(&maps[4], cos_t, S, DK / 2, DK, kRows) &&
                sm90::encode_rows(&maps[5], sinm_t, S, DK / 2, DK, kRows)))
    return cudaErrorInvalidValue;
  Args a;
  a.cos_t = static_cast<const bf16*>(cos_t);
  a.sinm_t = static_cast<const bf16*>(sinm_t);
  a.lse = lse;
  a.S = S;
  a.H = H;
  a.n_tiles = (S + kRows - 1) / kRows;
  a.group = H / Hkv;
  a.causal = causal;
  a.rope = rope;
  a.window = window;
  a.band = window ? static_cast<unsigned>(window) : 0x80000000u;
  // 1/sqrt(Dqk) rounded once from double, as the TPU kernels' Python
  // float, then carried into base 2.
  a.scale_log2 = static_cast<float>(1.0 / sqrt(static_cast<double>(DK))) *
                 1.4426950408889634f;
  const int smem = Smem<DK, DV>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_tiles, B * H);
  flash_fwd_sm90_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a);
  return cudaGetLastError();
}

}  // namespace flash_sm90

// The same C interface as flash_fwd (flash_fwd.cu): q [B, S, H, D] in
// strides (q_b, q_s, q_h), k [B, S, Hkv, D] in (k_b, k_s, k_h), v [B, S,
// Hkv, Dv] in (v_b, v_s, v_h), D stride 1, 16-byte-aligned bases and
// strides, Hkv dividing H; o [B, S, H, Dv] contiguous; lse [B, H, S]
// fp32; cos_t/sinm_t [S, D]; window 0 (none) or W > 0 with causal. Takes
// bf16 (elem_bytes 2) at (D, Dv) = (64, 64), (128, 128) and (192, 128)
// (rope only where D == Dv); anything else returns cudaErrorInvalidValue,
// as does a tensor map the driver refuses. Returns the CUDA error of the
// launch (0 on success); allocates nothing, never syncs.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              const void* cos_t, const void* sinm_t, void* o,
                              void* lse, int B, int S, int H, int Hkv, int D,
                              int Dv, long long q_b, long long q_s,
                              long long q_h, long long k_b, long long k_s,
                              long long k_h, long long v_b, long long v_s,
                              long long v_h, int causal, int window, int rope,
                              int elem_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (elem_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64 && Dv == 64)
    return static_cast<int>(flash_sm90::launch<64, 64>(
        q, k, v, cos_t, sinm_t, o, lse_f, B, S, H, Hkv, q_b, q_s, q_h, k_b,
        k_s, k_h, v_b, v_s, v_h, causal, window, rope, st));
  if (D == 128 && Dv == 128)
    return static_cast<int>(flash_sm90::launch<128, 128>(
        q, k, v, cos_t, sinm_t, o, lse_f, B, S, H, Hkv, q_b, q_s, q_h, k_b,
        k_s, k_h, v_b, v_s, v_h, causal, window, rope, st));
  if (D == 192 && Dv == 128)
    return static_cast<int>(flash_sm90::launch<192, 128>(
        q, k, v, cos_t, sinm_t, o, lse_f, B, S, H, Hkv, q_b, q_s, q_h, k_b,
        k_s, k_h, v_b, v_s, v_h, causal, window, rope, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
