// Flash-attention forward for Hopper (sm_90a): causal or full attention of
// one 64-row Q tile against every K/V tile it needs, with RoPE rotated
// in-tile, writing O and the per-row logsumexp. bf16 or fp32 inputs. It
// serves fp32, and bf16 at the head dims flash_fwd_sm90.cu is not built
// for (_flash_kernels.fwd_route).
//
// Replaces tpu_dra/workloads/flashattention.py:_fwd_kernel (the Pallas
// kernel reached through _fwd_call) and _fwd_stream_kernel (the same
// function with K/V as a grid axis, reached through _fwd_call_stream):
// this kernel streams K/V through shared memory at every S, so it is the
// counterpart of both tiers.
//
// What bounds it on the H100: at the flagship shape (B8 S1023 H16 D128,
// causal) it does 34 GFLOP against 135 MB of compulsory traffic, so the
// roofline puts it on the memory side (~40 us against ~35 us of bf16
// tensor-core time); at B1 S16384 H16 D128 it does 1.1 TFLOP against
// 0.27 GB, on the tensor cores' side (~1.1 ms). fp32 inputs run three TF32
// products per product (flash_common.cuh), so their bound is the FLOPs
// over 495/3 TFLOP/s. This first version runs far from those bounds:
// mma.sync runs well below wgmma's rate, and the tiles are staged through
// registers without cp.async/TMA overlap.
//
// What the design does about it: scores never leave registers (the online
// softmax runs on the mma accumulators and P feeds the P.V product as an
// A fragment directly); bf16 Q fragments stay in registers across the K
// loop; causal tiles above the diagonal are skipped and only the diagonal
// (and ragged last) tile is masked; the heaviest causal tiles are
// scheduled first. bf16 at D 64 and 128, every forward of the model
// paths, runs flash_fwd_sm90.cu instead: TMA staging, a producer
// warpgroup and wgmma consumers.
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params<T> p) {
  constexpr int LD = D + Elem<T>::kPad;
  constexpr int kDepth = Elem<T>::kDepth;
  constexpr int NT = D / 8;       // n-tiles of the output across D
  constexpr int KT = D / kDepth;  // k-steps of Q.K^T across D
  // bf16 Q fragments stay in registers across the K loop (32 registers
  // at D=128); fp32's split fragments would take 128, so they are
  // reloaded from the staged Q tile for every K tile.
  constexpr bool kHoldQ = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBlock * LD;
  T* Vs = Ks + kBlock * LD;

  const int n_tiles = (p.S + kBlock - 1) / kBlock;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row_g = q0 + warp * 16 + (lane >> 2), row_g8 = row_g + 8;
  const long long in_off = b * p.in.b + h * p.in.h;

  stage_tile<T, D>(Qs, p.q + in_off, p.in.s, q0, p.S, p.cos_t, p.sinm_t,
                   p.rope);
  __syncthreads();
  FragA<T> qa[kHoldQ ? KT : 1];
  if constexpr (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      load_a<LD>(qa[kk], Qs, warp * 16, kk * kDepth, lane);
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int last = p.causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_tile<T, D>(Ks, p.k + in_off, p.in.s, k0, p.S, p.cos_t, p.sinm_t,
                     p.rope);
    stage_tile<T, D>(Vs, p.v + in_off, p.in.s, k0, p.S, nullptr, nullptr,
                     false);
    __syncthreads();

    float s[8][4];  // 16 rows x 64 keys
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      FragA<T> a;
      if constexpr (kHoldQ) a = qa[kk];
      else load_a<LD>(a, Qs, warp * 16, kk * kDepth, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragB<T> bk;
        load_b_rows_n<LD>(bk, Ks, j * 8, kk * kDepth, lane);
        mma(s[j], a, bk);
      }
    }
    const bool masked = (p.causal && kt == qt) || k0 + kBlock > p.S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= p.sm_scale;
        if (masked) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_g : row_g8;
          if ((p.causal && col > row) || col >= p.S) s[j][e] = kNegInf;
        }
      }
    }
    // Online softmax on the accumulators: rows g (e = 0, 1) and g+8 (2, 3).
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const float corr[2] = {expf(m_run[0] - mx[0]), expf(m_run[1] - mx[1])};
    m_run[0] = mx[0];
    m_run[1] = mx[1];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mx[0]);
      s[j][1] = expf(s[j][1] - mx[0]);
      s[j][2] = expf(s[j][2] - mx[1]);
      s[j][3] = expf(s[j][3] - mx[1]);
      rs[0] += s[j][0] + s[j][1];
      rs[1] += s[j][2] + s[j][3];
    }
    l_run[0] = l_run[0] * corr[0] + rs[0];
    l_run[1] = l_run[1] * corr[1] + rs[1];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // acc += T(P) . V
    mma_c_rows<D, LD, kBlock / kDepth>(acc, s, Vs, 0, lane);
  }

  const float l_g = quad_sum(l_run[0]), l_g8 = quad_sum(l_run[1]);
  const long long out_off = b * p.out.b + h * p.out.h;
  // o = acc / denom: divide first, as the TPU kernel does, then round.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] = acc[j][0] / l_g;
    acc[j][1] = acc[j][1] / l_g;
    acc[j][2] = acc[j][2] / l_g8;
    acc[j][3] = acc[j][3] / l_g8;
  }
  store_rows<T, D>(p.o + out_off, p.out.s, acc, row_g, row_g8, p.S, lane);
  if (t == 0) {
    float* lse = p.lse_out + (long long)bh * p.S;
    if (row_g < p.S) lse[row_g] = m_run[0] + logf(l_g);
    if (row_g8 < p.S) lse[row_g8] = m_run[1] + logf(l_g8);
  }
}

template <typename T, int D>
struct LaunchFwd {
  static cudaError_t run(const Params<T>& p, cudaStream_t stream) {
    const int smem = 3 * kBlock * (D + Elem<T>::kPad) * (int)sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.S + kBlock - 1) / kBlock, p.B * p.H);
    flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace flash

// q, k, v: [B, S, H, D] sharing strides (in_b, in_s, in_h), D stride 1,
// 16-byte aligned rows. o: [B, S, H, D] contiguous; lse: [B, H, S] fp32.
// cos_t/sinm_t: [S, D] (read only when rope). q, k, v, o and the tables
// are all bf16 (elem_bytes 2) or all fp32 (elem_bytes 4). Returns the
// CUDA error of the launch (0 on success); allocates nothing, never syncs.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* cos_t, const void* sinm_t, void* o,
                         void* lse, int B, int S, int H, int D, long long in_b,
                         long long in_s, long long in_h, int causal, int rope,
                         int elem_bytes, void* stream) {
  flash::Operands x = {};
  x.q = q;
  x.k = k;
  x.v = v;
  x.cos_t = cos_t;
  x.sinm_t = sinm_t;
  x.o = o;
  x.lse_out = static_cast<float*>(lse);
  return flash::dispatch<flash::LaunchFwd>(
      elem_bytes, x, flash::Shape{B, S, H, D, in_b, in_s, in_h, causal, rope},
      stream);
}
