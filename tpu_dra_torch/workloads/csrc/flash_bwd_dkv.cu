// Flash-attention backward, dK and dV, for Hopper (sm_90a): one 64-row
// K/V tile streams the Q/dO tiles that attend to it (from the diagonal
// down when causal), recomputes P^T = exp(s^T - lse) and accumulates
// dV = sum_i P_i^T . dO_i and dK = scale * sum_i dS_i^T . Q_i with
// dS = P * (dO . V^T - delta + dlse), then applies the inverse RoPE to dK.
// bf16 or fp32 inputs.
//
// Replaces tpu_dra/workloads/flashattention.py:_bwd_dkv_kernel (the Pallas
// kernel reached through _flash_bwd_rule) and _bwd_dkv_stream_kernel (the
// same function with Q/dO as a grid axis, reached through
// _bwd_calls_stream): this kernel streams Q/dO through shared memory at
// every S, so it is the counterpart of both tiers.
//
// What bounds it on the H100: at the flagship shape (B8 S1023 H16 D128,
// causal) four products make 69 GFLOP against 203 MB, so the roofline is
// the tensor cores' (~69 us); at B1 S16384 H16 D128, 2.2 TFLOP (~2.2 ms).
// fp32 inputs run three TF32 products per product (flash_common.cuh), so
// their bound is the FLOPs over 495/3 TFLOP/s; their four 64 x (128 + 4)
// fp32 tiles take 135 KB of shared memory at D=128, one CTA per SM. This
// first version runs far from the bound: mma.sync runs well below wgmma's
// rate, two fp32 16xD accumulators per warp leave room for few CTAs per
// SM, and each Q/dO tile is staged synchronously.
//
// What the design does about it: each warp computes the transposed scores
// S^T = K.Q^T for its 16 keys, so P^T and dS^T come out of the mma
// accumulators already in A-fragment layout for P^T.dO and dS^T.Q; a
// 64-row Q tile is consumed in two 32-row halves, which keeps the live
// score registers at 32 next to the 128 of the accumulators; lse and the
// dlse - delta term are staged once per Q tile in shared memory.
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params<T> p) {
  constexpr int LD = D + Elem<T>::kPad;
  constexpr int kDepth = Elem<T>::kDepth;
  constexpr int NT = D / 8;
  constexpr int KT = D / kDepth;
  constexpr int kSub = 32;  // queries per half of a Q tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBlock * LD;
  T* Qs = Vs + kBlock * LD;
  T* dOs = Qs + kBlock * LD;
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

  stage_tile<T, D>(Ks, p.k + in_off, p.in.s, k0, p.S, p.cos_t, p.sinm_t,
                   p.rope);
  stage_tile<T, D>(Vs, p.v + in_off, p.in.s, k0, p.S, nullptr, nullptr,
                   false);

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
    stage_tile<T, D>(Qs, p.q + in_off, p.in.s, q0, p.S, p.cos_t, p.sinm_t,
                     p.rope);
    stage_tile<T, D>(dOs, p.dout + out_off, p.out.s, q0, p.S, nullptr,
                     nullptr, false);
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
        FragA<T> ka, va;
        load_a<LD>(ka, Ks, warp * 16, kk * kDepth, lane);
        load_a<LD>(va, Vs, warp * 16, kk * kDepth, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB<T> bq, bd;
          load_b_rows_n<LD>(bq, Qs, c0 + j * 8, kk * kDepth, lane);
          load_b_rows_n<LD>(bd, dOs, c0 + j * 8, kk * kDepth, lane);
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
      // dV += T(P^T) . dO and dK += T(dS^T) . Q.
      mma_c_rows2<D, LD, kSub / kDepth>(dv, st, dOs, dk, dpt, Qs, c0, lane);
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    dk[j][0] *= p.sm_scale;
    dk[j][1] *= p.sm_scale;
    dk[j][2] *= p.sm_scale;
    dk[j][3] *= p.sm_scale;
  }
  if (p.rope)
    rope_inverse<T, D>(dk, p.cos_t, p.sinm_t, key_g, key_g8, p.S, lane);
  store_rows<T, D>(p.dk + out_off, p.out.s, dk, key_g, key_g8, p.S, lane);
  store_rows<T, D>(p.dv + out_off, p.out.s, dv, key_g, key_g8, p.S, lane);
}

template <typename T, int D>
struct LaunchDkv {
  static cudaError_t run(const Params<T>& p, cudaStream_t stream) {
    const int smem = 4 * kBlock * (D + Elem<T>::kPad) * (int)sizeof(T) +
                     2 * kBlock * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.S + kBlock - 1) / kBlock, p.B * p.H);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace flash

// Same operands as flash_bwd_dq; writes dk and dv ([B, S, H, D]
// contiguous, of the input type). Returns the CUDA error of the launch
// (0 on success); allocates nothing, never syncs.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* dlse,
                             const void* cos_t, const void* sinm_t, void* dk,
                             void* dv, int B, int S, int H, int D,
                             long long in_b, long long in_s, long long in_h,
                             int causal, int rope, int elem_bytes,
                             void* stream) {
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
  x.dk = dk;
  x.dv = dv;
  return flash::dispatch<flash::LaunchDkv>(
      elem_bytes, x, flash::Shape{B, S, H, D, in_b, in_s, in_h, causal, rope},
      stream);
}
