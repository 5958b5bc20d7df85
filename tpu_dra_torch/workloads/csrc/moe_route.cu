// Top-1 MoE routing by slot index, and the row copies that move tokens into
// and out of the experts' buffers, for Hopper (sm_90a): bf16 or fp32 rows.
//
// Replaces no TPU kernel. The reference (tpu_dra/workloads/moe.py:
// route_top1, _experts) builds dense one-hot [B,S,E,C] dispatch and combine
// tensors and contracts them with the tokens in two einsums, so that every
// shape is static under jit; XLA, not a Pallas kernel, runs them. Top-1
// routing gives each token one expert and at most one slot, and each slot
// at most one token, so the same function is a gather by index into an
// [E*C, D] buffer, whose shape is static as well. These kernels are that
// gather (moe.py, _moe_kernels.py).
//
// What bounds them on the H100: bytes. The dense form multiplies by 0 or by
// the gate: at B8 S1024 D2048 E8 C1280 each einsum is [8192 x 2048] against
// [8192 x 10240], 344 GFLOP, and the masks are [B,S,E,C] tensors of 84M
// elements. A gather moves each kept row once: 34 MB of tokens and 42 MB of
// slots in bf16, ~23 us at 3.35 TB/s. The route reads 32 KB of expert ids.
//
// What the design does about it:
// 1. moe_route: one CTA of 1024 threads. Each thread holds 8 consecutive
//    tokens' experts, so thread order is (b, s) order; per expert one
//    block-wide exclusive scan of the threads' counts (warp shuffles, then
//    the 32 warp totals) gives each token its position within its expert,
//    continued from the lower data ranks' counts (`offset`). Tiles of 8192
//    tokens carry each expert's running count in shared memory, so any T
//    takes one launch. It writes the position of every token, the slot
//    (e - e_lo) * C + c of every token kept by one of this rank's experts
//    [e_lo, e_hi) (else -1), the token of every slot (-1 where empty), the
//    tokens routed to each expert and the tokens kept by any expert. No
//    atomics: the result is the same on every run.
// 2. moe_gather_rows: dst[i] = scale * src[idx[i]], or zeros where
//    idx[i] < 0; scale is scale[i], or scale[idx[i]] with scale_by_src, or
//    1 (a plain copy, bit for bit) without scale. One warp per row, 16-byte
//    loads and stores (D a multiple of 8), every load of a lane issued
//    before its stores. The product is taken in fp32 and rounded once,
//    which is what a one-hot GEMM with fp32 accumulation gives: one term
//    that is not zero.
// 3. moe_row_dot: out[t] = sum_d a[t, d] * b[idx[t], d] in fp32, or 0 where
//    idx[t] < 0 (the gate's gradient). One warp per row, a fixed order of
//    partial sums and shuffles, so the result is reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe {

constexpr int kScanThreads = 1024;
constexpr int kPerThread = 8;
constexpr int kTile = kScanThreads * kPerThread;
constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kUnroll = 4;        // 16-byte loads in flight per lane

// Exclusive prefix sum of v over the block, in thread order; *total gets
// the block's sum. Every thread calls it; warp_sums holds 33 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += n;
    }
    warp_sums[lane] = wi - w;
    if (lane == 31) warp_sums[32] = wi;
  }
  __syncthreads();
  const int out = warp_sums[warp] + incl - v;
  *total = warp_sums[32];
  __syncthreads();  // warp_sums is reused by the next scan
  return out;
}

__global__ void __launch_bounds__(kScanThreads)
    route_kernel(const int* __restrict__ expert, const int* __restrict__ offset,
                 int* __restrict__ pos, int* __restrict__ slot,
                 int* __restrict__ token_of_slot, int* __restrict__ counts,
                 int* __restrict__ kept_total, int T, int E, int C, int e_lo,
                 int e_hi) {
  extern __shared__ int smem[];  // carry[E], then the scan's 33 ints
  int* carry = smem;
  int* warp_sums = smem + E;
  const int n_slots = (e_hi - e_lo) * C;
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) token_of_slot[i] = -1;
  for (int e = threadIdx.x; e < E; e += blockDim.x) carry[e] = offset[e];
  __syncthreads();
  int n_kept = 0;  // this thread's tokens within capacity, any expert
  for (int base = 0; base < T; base += kTile) {
    const int first = base + threadIdx.x * kPerThread;
    int mine[kPerThread];
    int at[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      mine[j] = first + j < T ? expert[first + j] : -1;
      at[j] = 0;
    }
    for (int e = 0; e < E; ++e) {
      int n = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) n += mine[j] == e;
      // Read before the scan's barriers; thread 0 writes it after them.
      const int c0 = carry[e];
      int total;
      int p = c0 + block_exclusive_scan(n, warp_sums, &total);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (mine[j] == e) at[j] = p++;
      if (threadIdx.x == 0) carry[e] = c0 + total;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int t = first + j;
      if (t >= T) continue;
      const int e = mine[j];
      pos[t] = at[j];
      n_kept += at[j] < C;
      const bool kept = e >= e_lo && e < e_hi && at[j] < C;
      const int s = kept ? (e - e_lo) * C + at[j] : -1;
      slot[t] = s;
      if (kept) token_of_slot[s] = t;
    }
    __syncthreads();  // carry's updates before the next tile's reads
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    counts[e] = carry[e] - offset[e];
  int total;
  block_exclusive_scan(n_kept, warp_sums, &total);
  if (threadIdx.x == 0) *kept_total = total;
}

// 16 bytes of T as floats, and back with round-to-nearest-even.
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void to_float(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 from_float(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void to_float(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 from_float(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    gather_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                       const float* __restrict__ scale, int scale_by_src,
                       T* __restrict__ dst, int n_rows, int d) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= n_rows) return;
  const int lane = threadIdx.x;
  const int nv = d / Pack<T>::N;
  const int from = idx[row];
  uint4* out = reinterpret_cast<uint4*>(dst + static_cast<int64_t>(row) * d);
  if (from < 0) {
    for (int v = lane; v < nv; v += 32) out[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* in =
      reinterpret_cast<const uint4*>(src + static_cast<int64_t>(from) * d);
  const bool scaled = scale != nullptr;
  const float s = scaled ? scale[scale_by_src ? from : row] : 1.0f;
  for (int v0 = lane; v0 < nv; v0 += 32 * kUnroll) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = v0 + 32 * k;
      if (v < nv) u[k] = __ldg(in + v);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = v0 + 32 * k;
      if (v >= nv) continue;
      if (scaled) {
        float f[Pack<T>::N];
        Pack<T>::to_float(u[k], f);
#pragma unroll
        for (int i = 0; i < Pack<T>::N; ++i) f[i] *= s;
        out[v] = Pack<T>::from_float(f);
      } else {
        out[v] = u[k];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    row_dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int* __restrict__ idx, float* __restrict__ out,
                   int n_rows, int d) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= n_rows) return;
  const int lane = threadIdx.x;
  const int from = idx[row];
  float acc = 0.0f;
  if (from >= 0) {
    const int nv = d / Pack<T>::N;
    const uint4* pa =
        reinterpret_cast<const uint4*>(a + static_cast<int64_t>(row) * d);
    const uint4* pb =
        reinterpret_cast<const uint4*>(b + static_cast<int64_t>(from) * d);
    for (int v = lane; v < nv; v += 32) {
      float fa[Pack<T>::N], fb[Pack<T>::N];
      Pack<T>::to_float(__ldg(pa + v), fa);
      Pack<T>::to_float(__ldg(pb + v), fb);
#pragma unroll
      for (int i = 0; i < Pack<T>::N; ++i) acc = fmaf(fa[i], fb[i], acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[row] = acc;
}

inline dim3 row_grid(int n_rows) {
  return dim3((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace moe

extern "C" int moe_route(const void* expert, const void* offset, void* pos,
                         void* slot, void* token_of_slot, void* counts,
                         void* kept, int T, int E, int C, int e_lo, int e_hi,
                         void* stream) {
  const size_t smem = (E + 33) * sizeof(int);
  moe::route_kernel<<<1, moe::kScanThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(expert), static_cast<const int*>(offset),
      static_cast<int*>(pos), static_cast<int*>(slot),
      static_cast<int*>(token_of_slot), static_cast<int*>(counts),
      static_cast<int*>(kept), T, E, C, e_lo, e_hi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_gather_rows(const void* src, const void* idx,
                               const void* scale, void* dst, int n_rows, int d,
                               int scale_by_src, int elem_bytes, void* stream) {
  if (n_rows == 0) return 0;
  const dim3 block(32, moe::kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* sc = static_cast<const float*>(scale);
  if (elem_bytes == 2) {
    moe::gather_rows_kernel<__nv_bfloat16><<<moe::row_grid(n_rows), block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src), i, sc, scale_by_src,
        static_cast<__nv_bfloat16*>(dst), n_rows, d);
  } else if (elem_bytes == 4) {
    moe::gather_rows_kernel<float><<<moe::row_grid(n_rows), block, 0, s>>>(
        static_cast<const float*>(src), i, sc, scale_by_src,
        static_cast<float*>(dst), n_rows, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_row_dot(const void* a, const void* b, const void* idx,
                           void* out, int n_rows, int d, int elem_bytes,
                           void* stream) {
  if (n_rows == 0) return 0;
  const dim3 block(32, moe::kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  if (elem_bytes == 2) {
    moe::row_dot_kernel<__nv_bfloat16><<<moe::row_grid(n_rows), block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), i, o, n_rows, d);
  } else if (elem_bytes == 4) {
    moe::row_dot_kernel<float><<<moe::row_grid(n_rows), block, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), i, o,
        n_rows, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
