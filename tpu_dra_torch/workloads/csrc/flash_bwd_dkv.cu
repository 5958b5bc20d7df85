// Flash-attention backward, dK and dV, for Hopper (sm_90a): one 64-row
// K/V tile streams the Q/dO tiles that attend to it (from the diagonal
// down when causal), recomputes P^T = exp(s^T - lse) and accumulates
// dV = sum_i P_i^T . dO_i and dK = scale * sum_i dS_i^T . Q_i with
// dS = P * (dO . V^T - delta + dlse), then applies the inverse RoPE to dK.
//
// Replaces tpu_dra/workloads/flashattention.py:_bwd_dkv_kernel (the Pallas
// kernel reached through _flash_bwd_rule).
//
// What bounds it on the H100: at the flagship shape (B8 S1023 H16 D128,
// causal) four products make 69 GFLOP against 203 MB, so the roofline is
// the tensor cores' (~69 us). This first version runs far from it:
// mma.sync runs well below wgmma's rate, two fp32 16xD accumulators per
// warp leave room for few CTAs per SM, and each Q/dO tile is staged
// synchronously.
//
// What the design does about it: each warp computes the transposed scores
// S^T = K.Q^T for its 16 keys, so P^T and dS^T come out of the mma
// accumulators already in A-fragment layout for P^T.dO and dS^T.Q; a
// 64-row Q tile is consumed in two 32-row halves, which keeps the live
// score registers at 32 next to the 128 of the accumulators; lse and the
// dlse - delta term are staged once per Q tile in shared memory.
#include "flash_common.cuh"

namespace flash {

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + kPad;
  constexpr int NT = D / 8;
  constexpr int KT = D / 16;
  constexpr int kSub = 32;  // queries per half of a Q tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBlock * LD;
  bf16* Qs = Vs + kBlock * LD;
  bf16* dOs = Qs + kBlock * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kBlock * LD);
  float* corr_s = lse_s + kBlock;

  const int n_tiles = (p.S + kBlock - 1) / kBlock;
  const int kt = blockIdx.x;  // causal: tile 0 sees the most Q tiles
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = kt * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int key_g = k0 + warp * 16 + (lane >> 2), key_g8 = key_g + 8;
  const long long in_off = b * p.in.b + h * p.in.h;
  const long long out_off = b * p.out.b + h * p.out.h;
  const float* lse_row = p.lse_in + (long long)bh * p.S;
  const float* delta_row = p.delta + (long long)bh * p.S;
  const float* dlse_row = p.dlse + (long long)bh * p.S;

  stage_tile<D>(Ks, p.k + in_off, p.in.s, k0, p.S, p.cos_t, p.sinm_t, p.rope);
  stage_tile<D>(Vs, p.v + in_off, p.in.s, k0, p.S, nullptr, nullptr, false);

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  const int first = p.causal ? kt : 0;
  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    stage_tile<D>(Qs, p.q + in_off, p.in.s, q0, p.S, p.cos_t, p.sinm_t, p.rope);
    stage_tile<D>(dOs, p.dout + out_off, p.out.s, q0, p.S, nullptr, nullptr, false);
    if (threadIdx.x < kBlock) {
      const int row = q0 + threadIdx.x;
      const bool real = row < p.S;
      lse_s[threadIdx.x] = real ? lse_row[row] : 0.f;
      corr_s[threadIdx.x] = real ? dlse_row[row] - delta_row[row] : 0.f;
    }
    __syncthreads();
    const bool masked = (p.causal && qt == kt) || q0 + kBlock > p.S;

#pragma unroll
    for (int sub = 0; sub < kBlock / kSub; ++sub) {
      const int c0 = sub * kSub;  // first query of this half, tile-relative
      float st[4][4], dpt[4][4];  // 16 keys x 32 queries
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Ks, warp * 16, kk * 16, lane);
        load_a<LD>(va, Vs, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bq[2], bd[2];
          load_b_rows_n<LD>(bq, Qs, c0 + j * 8, kk * 16, lane);
          load_b_rows_n<LD>(bd, dOs, c0 + j * 8, kk * 16, lane);
          mma(st[j], ka, bq);    // S^T = K . Q^T
          mma(dpt[j], va, bd);   // dP^T = V . dO^T
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c0 + j * 8 + 2 * t + (e & 1);  // tile-relative query
          float sc = st[j][e] * p.sm_scale;
          if (masked) {
            const int query = q0 + qi;
            const int key = e < 2 ? key_g : key_g8;
            if ((p.causal && query < key) || query >= p.S) sc = kNegInf;
          }
          const float pr = expf(sc - lse_s[qi]);
          st[j][e] = pr;                              // P^T
          dpt[j][e] = pr * (dpt[j][e] + corr_s[qi]);  // dS^T
        }
      }
      // dV += bf16(P^T) . dO and dK += bf16(dS^T) . Q over 16 queries a step.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(st[2 * kk][0], st[2 * kk][1]),
            pack_bf16(st[2 * kk][2], st[2 * kk][3]),
            pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
            pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b0[2], b1[2];
          load_b_rows_k_x2<LD>(b0, b1, dOs, c0 + kk * 16, j * 8, lane);
          mma(dv[j], pa, b0);
          mma(dv[j + 1], pa, b1);
          load_b_rows_k_x2<LD>(b0, b1, Qs, c0 + kk * 16, j * 8, lane);
          mma(dk[j], da, b0);
          mma(dk[j + 1], da, b1);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    dk[j][0] *= p.sm_scale;
    dk[j][1] *= p.sm_scale;
    dk[j][2] *= p.sm_scale;
    dk[j][3] *= p.sm_scale;
  }
  if (p.rope) rope_inverse<D>(dk, p.cos_t, p.sinm_t, key_g, key_g8, p.S, lane);
  store_rows<D>(p.dk + out_off, p.out.s, dk, key_g, key_g8, p.S, lane);
  store_rows<D>(p.dv + out_off, p.out.s, dv, key_g, key_g8, p.S, lane);
}

template <int D>
struct LaunchDkv {
  static cudaError_t run(const Params& p, cudaStream_t stream) {
    const int smem = 4 * kBlock * (D + kPad) * (int)sizeof(bf16) +
                     2 * kBlock * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.S + kBlock - 1) / kBlock, p.B * p.H);
    flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace flash

// Same operands as flash_bwd_dq; writes dk and dv ([B, S, H, D] contiguous
// bf16). Returns the CUDA error of the launch (0 on success); allocates
// nothing, never syncs.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* dlse,
                             const void* cos_t, const void* sinm_t, void* dk,
                             void* dv, int B, int S, int H, int D,
                             long long in_b, long long in_s, long long in_h,
                             int causal, int rope, void* stream) {
  using namespace flash;
  Params p = make_params(B, S, H, D, in_b, in_s, in_h, causal, rope);
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dlse = static_cast<const float*>(dlse);
  p.cos_t = static_cast<const bf16*>(cos_t);
  p.sinm_t = static_cast<const bf16*>(sinm_t);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  return static_cast<int>(dispatch_head_dim<LaunchDkv>(
      D, p, static_cast<cudaStream_t>(stream)));
}
