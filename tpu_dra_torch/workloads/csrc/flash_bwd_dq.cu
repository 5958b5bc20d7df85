// Flash-attention backward, dQ, for Hopper (sm_90a): one 64-row Q tile
// streams the K/V tiles it attends to, recomputes P = exp(s - lse) and
// accumulates dQ = scale * sum_j dS_j . K_j with
// dS = P * (dO . V^T - delta + dlse), then applies the inverse RoPE.
// bf16 or fp32 inputs.
//
// Replaces tpu_dra/workloads/flashattention.py:_bwd_dq_kernel (the Pallas
// kernel reached through _flash_bwd_rule) and _bwd_dq_stream_kernel (the
// same function with K/V as a grid axis, reached through
// _bwd_calls_stream): this kernel streams K/V through shared memory at
// every S, so it is the counterpart of both tiers. It serves fp32 inputs
// and bf16 at head dims other than 64 and 128, with flash_bwd_dkv.cu; bf16
// at D 64 and 128, every model path, runs the fused flash_bwd_sm90.cu
// (_flash_kernels.bwd_route).
//
// What bounds it on the H100: at the flagship shape (B8 S1023 H16 D128,
// causal) three products make 51 GFLOP against 169 MB, so the roofline is
// the tensor cores' (~52 us); at B1 S16384 H16 D128, 1.65 TFLOP (~1.7 ms).
// fp32 inputs run three TF32 products per product (flash_common.cuh), so
// their bound is the FLOPs over 495/3 TFLOP/s. This first version runs
// far from it: mma.sync runs well below wgmma's rate and each K/V tile is
// staged synchronously.
//
// What the design does about it: P and dS stay in registers and feed
// dS.K as A fragments; the dlse - delta row term is folded once per row
// outside the K loop; the inverse rotation runs on the fp32 accumulators
// in registers (column j's partner j + D/2 is in the same thread); causal
// tiles above the diagonal are skipped and only the diagonal tile masked.
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params<T> p) {
  constexpr int LD = D + Elem<T>::kPad;
  constexpr int kDepth = Elem<T>::kDepth;
  constexpr int NT = D / 8;
  constexpr int KT = D / kDepth;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBlock * LD;
  T* Ks = dOs + kBlock * LD;
  T* Vs = Ks + kBlock * LD;

  const int n_tiles = (p.S + kBlock - 1) / kBlock;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row_g = q0 + warp * 16 + (lane >> 2), row_g8 = row_g + 8;
  const long long in_off = b * p.in.b + h * p.in.h;
  const long long out_off = b * p.out.b + h * p.out.h;

  stage_tile<T, D>(Qs, p.q + in_off, p.in.s, q0, p.S, p.cos_t, p.sinm_t,
                   p.rope);
  stage_tile<T, D>(dOs, p.dout + out_off, p.out.s, q0, p.S, nullptr, nullptr,
                   false);
  const float* lse_row = p.lse_in + (long long)bh * p.S;
  const float* delta_row = p.delta + (long long)bh * p.S;
  const float* dlse_row = p.dlse + (long long)bh * p.S;
  float lse[2] = {0.f, 0.f}, corr[2] = {0.f, 0.f};
  if (row_g < p.S) {
    lse[0] = lse_row[row_g];
    corr[0] = dlse_row[row_g] - delta_row[row_g];
  }
  if (row_g8 < p.S) {
    lse[1] = lse_row[row_g8];
    corr[1] = dlse_row[row_g8] - delta_row[row_g8];
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int last = p.causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();
    stage_tile<T, D>(Ks, p.k + in_off, p.in.s, k0, p.S, p.cos_t, p.sinm_t,
                     p.rope);
    stage_tile<T, D>(Vs, p.v + in_off, p.in.s, k0, p.S, nullptr, nullptr,
                     false);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      FragA<T> qa, da;
      load_a<LD>(qa, Qs, warp * 16, kk * kDepth, lane);
      load_a<LD>(da, dOs, warp * 16, kk * kDepth, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragB<T> bk, bv;
        load_b_rows_n<LD>(bk, Ks, j * 8, kk * kDepth, lane);
        load_b_rows_n<LD>(bv, Vs, j * 8, kk * kDepth, lane);
        mma(s[j], qa, bk);
        mma(dp[j], da, bv);
      }
    }
    const bool masked = (p.causal && kt == qt) || k0 + kBlock > p.S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sc = s[j][e] * p.sm_scale;
        if (masked) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_g : row_g8;
          if ((p.causal && col > row) || col >= p.S) sc = kNegInf;
        }
        const float pr = expf(sc - lse[e >> 1]);
        s[j][e] = pr * (dp[j][e] + corr[e >> 1]);  // dS
      }
    }
    // acc += T(dS) . K
    mma_c_rows<D, LD, kBlock / kDepth>(acc, s, Ks, 0, lane);
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] *= p.sm_scale;
    acc[j][1] *= p.sm_scale;
    acc[j][2] *= p.sm_scale;
    acc[j][3] *= p.sm_scale;
  }
  if (p.rope)
    rope_inverse<T, D>(acc, p.cos_t, p.sinm_t, row_g, row_g8, p.S, lane);
  store_rows<T, D>(p.dq + out_off, p.out.s, acc, row_g, row_g8, p.S, lane);
}

template <typename T, int D>
struct LaunchDq {
  static cudaError_t run(const Params<T>& p, cudaStream_t stream) {
    const int smem = 4 * kBlock * (D + Elem<T>::kPad) * (int)sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.S + kBlock - 1) / kBlock, p.B * p.H);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace flash

// q, k, v: [B, S, H, D] sharing strides (in_b, in_s, in_h); dout and
// dq: [B, S, H, D] contiguous; lse, delta, dlse: [B, H, S] fp32;
// cos_t/sinm_t: [S, D] (read only when rope). q, k, v, dout, dq and the
// tables are all bf16 (elem_bytes 2) or all fp32 (elem_bytes 4). Returns
// the CUDA error of the launch (0 on success); allocates nothing, never
// syncs.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* dlse,
                            const void* cos_t, const void* sinm_t, void* dq,
                            int B, int S, int H, int D, long long in_b,
                            long long in_s, long long in_h, int causal,
                            int rope, int elem_bytes, void* stream) {
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
  x.dq = dq;
  return flash::dispatch<flash::LaunchDq>(
      elem_bytes, x, flash::Shape{B, S, H, D, in_b, in_s, in_h, causal, rope},
      stream);
}
