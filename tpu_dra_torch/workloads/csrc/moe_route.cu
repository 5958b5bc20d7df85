// MoE routing, top-1 by slot index and top-k dropless, and the row copies
// that move tokens into and out of the experts' buffers, for Hopper (sm_90a):
// bf16 or fp32 rows.
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
//
// Top-k dropless routing over the experts a rank holds (the DeepSeek-V3
// family's MoE, moe.py:route_topk), where every (token, k) pair whose
// expert is held is computed and none is dropped:
// 2. moe_route_topk: one CTA of 1024 threads over the (token, k) pairs in
//    (b, s, k) order, 8 consecutive pairs a thread. A first pass counts
//    each held expert's pairs; their exclusive prefix is where each
//    expert's rows start in the [N, D] buffer (N the held pairs, the
//    grouped GEMM's row count). A second pass gives each pair its row:
//    the counts of up to 16 held experts ride as 16-bit fields in eight
//    words, so one block-wide scan of the eight words per tile of 8192
//    pairs gives every pair its position within its expert (the running
//    counts carried across tiles), where the top-1 route runs one scan
//    per expert. It writes each pair's row (or -1 where its expert is not
//    held), the pair and the token of each row, the experts' row offsets
//    and the held pairs and the largest expert's count. No atomics.
//
// The row copies of both routings' dispatch and combine (moe.py:_Dispatch,
// _Combine; the top-1 route's at k = 1, its slots as rows):
// 3. moe_gather_rows: dst[i] = scale[i] * src[idx[i]], or zeros where
//    idx[i] < 0; without scale a plain copy, bit for bit (the dispatch,
//    and the combine's backward). One warp per row, 16-byte loads and
//    stores (D a multiple of 8), every load of a lane issued before its
//    stores. The product is taken in fp32 and rounded once, which is what
//    a one-hot GEMM with fp32 accumulation gives: one term that is not
//    zero.
// 4. moe_combine_rows: out[t] = sum_k gate[t, k] * src[idx[t, k]] over the
//    pairs with idx >= 0 (or their plain sum without gates; zeros where
//    none is held), in fp32 and rounded once: the combine and the
//    dispatch's backward. One warp per token, 16-byte loads.
// 5. moe_pair_dot: out[p] = sum_d a[p / k, d] * b[idx[p], d] in fp32, or 0
//    where idx[p] < 0 (the gates' gradient): row_dot_kernel, the rows of
//    `a` shared by k pairs. One warp per pair, a fixed order of partial
//    sums and shuffles, so the result is reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe {

constexpr int kScanThreads = 1024;
constexpr int kPerThread = 8;
constexpr int kTile = kScanThreads * kPerThread;
constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kUnroll = 4;        // 16-byte loads in flight per lane
constexpr int kMaxHeld = 16;      // held experts of the top-k route
constexpr int kWords = kMaxHeld / 2;  // two 16-bit counts a word

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

// block_exclusive_scan over eight words of packed 16-bit counts at once
// (no field's sum over a tile passes 8192, so no field carries into the
// next); *total gets the block's sums. sums holds 33 * kWords words.
__device__ __forceinline__ void packed_exclusive_scan(uint32_t (&v)[kWords],
                                                      uint32_t* sums,
                                                      uint32_t (&total)[kWords]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t incl[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) incl[w] = v[w];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t n = __shfl_up_sync(0xffffffffu, incl[w], o);
      if (lane >= o) incl[w] += n;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) sums[warp * kWords + w] = incl[w];
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t x[kWords], xi[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      x[w] = lane < (blockDim.x >> 5) ? sums[lane * kWords + w] : 0u;
      xi[w] = x[w];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const uint32_t n = __shfl_up_sync(0xffffffffu, xi[w], o);
        if (lane >= o) xi[w] += n;
      }
    }
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      sums[lane * kWords + w] = xi[w] - x[w];
      if (lane == 31) sums[32 * kWords + w] = xi[w];
    }
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    v[w] = sums[warp * kWords + w] + incl[w] - v[w];
    total[w] = sums[32 * kWords + w];
  }
  __syncthreads();  // sums is reused by the next scan
}

// Field `e` (a held expert's index) of packed counts, without indexing
// the register array by a runtime value.
__device__ __forceinline__ uint32_t field(const uint32_t (&v)[kWords], int e) {
  uint32_t word = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    if (w == (e >> 1)) word = v[w];
  return (word >> (16 * (e & 1))) & 0xffffu;
}

__device__ __forceinline__ void bump(uint32_t (&v)[kWords], int e) {
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    if (w == (e >> 1)) v[w] += 1u << (16 * (e & 1));
}

__global__ void __launch_bounds__(kScanThreads)
    route_topk_kernel(const int* __restrict__ expert, int n_pairs, int k,
                      int e_lo, int e_hi, int* __restrict__ slot,
                      int* __restrict__ pair_of_row,
                      int* __restrict__ token_of_row,
                      int* __restrict__ offsets, int* __restrict__ stats) {
  __shared__ uint32_t sums[33 * kWords];
  __shared__ int start[kMaxHeld];
  __shared__ int carry[kMaxHeld];
  const int held = e_hi - e_lo;
  if (threadIdx.x < kMaxHeld) carry[threadIdx.x] = 0;
  __syncthreads();
  // The held experts' pairs: thread 0 adds each tile's sums.
  for (int base = 0; base < n_pairs; base += kTile) {
    const int first = base + threadIdx.x * kPerThread;
    uint32_t v[kWords] = {};
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = first + j < n_pairs ? expert[first + j] - e_lo : -1;
      if (e >= 0 && e < held) bump(v, e);
    }
    uint32_t total[kWords];
    packed_exclusive_scan(v, sums, total);
    if (threadIdx.x == 0)
      for (int e = 0; e < held; ++e) carry[e] += field(total, e);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int rows = 0, most = 0;
    for (int e = 0; e < held; ++e) {
      start[e] = offsets[e] = rows;
      rows += carry[e];
      most = max(most, carry[e]);
      carry[e] = 0;
    }
    offsets[held] = rows;
    stats[0] = rows;
    stats[1] = most;
  }
  __syncthreads();
  // Each pair's row: its expert's start, then its position there.
  for (int base = 0; base < n_pairs; base += kTile) {
    const int first = base + threadIdx.x * kPerThread;
    int mine[kPerThread];
    uint32_t v[kWords] = {};
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      int e = first + j < n_pairs ? expert[first + j] - e_lo : -1;
      if (e >= held) e = -1;
      mine[j] = e;
      if (e >= 0) bump(v, e);
    }
    uint32_t total[kWords];
    packed_exclusive_scan(v, sums, total);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int p = first + j;
      if (p >= n_pairs) continue;
      const int e = mine[j];
      if (e < 0) {
        slot[p] = -1;
        continue;
      }
      const int row = start[e] + carry[e] + static_cast<int>(field(v, e));
      bump(v, e);
      slot[p] = row;
      pair_of_row[row] = p;
      token_of_row[row] = p / k;
    }
    __syncthreads();  // every read of carry before thread 0 moves it
    if (threadIdx.x == 0)
      for (int e = 0; e < held; ++e) carry[e] += field(total, e);
    __syncthreads();
  }
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
                       const float* __restrict__ scale, T* __restrict__ dst,
                       int n_rows, int d) {
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
  const float s = scaled ? scale[row] : 1.0f;
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

template <typename T, bool kShared>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    row_dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int* __restrict__ idx, float* __restrict__ out,
                   int n_rows, int d, int k) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= n_rows) return;
  const int lane = threadIdx.x;
  const int from = idx[row];
  float acc = 0.0f;
  if (from >= 0) {
    const int nv = d / Pack<T>::N;
    // Row `row` of a, or with kShared the row its k pairs share
    // (moe_pair_dot, the one entry, launches kShared = true).
    const int a_row = kShared ? row / k : row;
    const uint4* pa =
        reinterpret_cast<const uint4*>(a + static_cast<int64_t>(a_row) * d);
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

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    combine_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                        const float* __restrict__ gate, T* __restrict__ dst,
                        int n_rows, int k, int d) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= n_rows) return;
  const int lane = threadIdx.x;
  const int nv = d / Pack<T>::N;
  uint4* out = reinterpret_cast<uint4*>(dst + static_cast<int64_t>(row) * d);
  for (int v0 = lane; v0 < nv; v0 += 32 * kUnroll) {
    float acc[kUnroll][Pack<T>::N] = {};
    for (int j = 0; j < k; ++j) {
      const int from = idx[static_cast<int64_t>(row) * k + j];
      if (from < 0) continue;
      const float g = gate != nullptr ? gate[static_cast<int64_t>(row) * k + j]
                                      : 1.0f;
      const uint4* in =
          reinterpret_cast<const uint4*>(src + static_cast<int64_t>(from) * d);
      uint4 u[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int v = v0 + 32 * q;
        if (v < nv) u[q] = __ldg(in + v);
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (v0 + 32 * q >= nv) continue;
        float f[Pack<T>::N];
        Pack<T>::to_float(u[q], f);
#pragma unroll
        for (int i = 0; i < Pack<T>::N; ++i) acc[q][i] = fmaf(g, f[i], acc[q][i]);
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int v = v0 + 32 * q;
      if (v < nv) out[v] = Pack<T>::from_float(acc[q]);
    }
  }
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
                               int elem_bytes, void* stream) {
  if (n_rows == 0) return 0;
  const dim3 block(32, moe::kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* sc = static_cast<const float*>(scale);
  if (elem_bytes == 2) {
    moe::gather_rows_kernel<__nv_bfloat16><<<moe::row_grid(n_rows), block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src), i, sc,
        static_cast<__nv_bfloat16*>(dst), n_rows, d);
  } else if (elem_bytes == 4) {
    moe::gather_rows_kernel<float><<<moe::row_grid(n_rows), block, 0, s>>>(
        static_cast<const float*>(src), i, sc, static_cast<float*>(dst),
        n_rows, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// expert [n_pairs] int32: each (token, k) pair's expert, in (b, s, k)
// order, k pairs a token. slot [n_pairs]: the pair's row in the held
// experts' buffer, or -1 where its expert is outside [e_lo, e_hi);
// pair_of_row, token_of_row [n_pairs]: rows [0, N) get their pair and its
// token (the rest is not written); offsets [e_hi - e_lo + 1]: each held
// expert's first row, then N; stats [2]: N and the largest held expert's
// count. At most kMaxHeld held experts and 2^31 pairs.
extern "C" int moe_route_topk(const void* expert, void* slot,
                              void* pair_of_row, void* token_of_row,
                              void* offsets, void* stats, int n_pairs, int k,
                              int e_lo, int e_hi, void* stream) {
  if (e_hi - e_lo < 1 || e_hi - e_lo > moe::kMaxHeld || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  moe::route_topk_kernel<<<1, moe::kScanThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(expert), n_pairs, k, e_lo, e_hi,
      static_cast<int*>(slot), static_cast<int*>(pair_of_row),
      static_cast<int*>(token_of_row), static_cast<int*>(offsets),
      static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// out [n_rows, d] of src [N, d]: row t is sum_j gate[t * k + j] * src[idx[t
// * k + j]] over the j with idx >= 0 (gate null: the plain sum), in fp32
// and rounded once; zeros where no idx is.
extern "C" int moe_combine_rows(const void* src, const void* idx,
                                const void* gate, void* dst, int n_rows,
                                int k, int d, int elem_bytes, void* stream) {
  if (n_rows == 0) return 0;
  const dim3 block(32, moe::kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* g = static_cast<const float*>(gate);
  if (elem_bytes == 2) {
    moe::combine_rows_kernel<__nv_bfloat16><<<moe::row_grid(n_rows), block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src), i, g,
        static_cast<__nv_bfloat16*>(dst), n_rows, k, d);
  } else if (elem_bytes == 4) {
    moe::combine_rows_kernel<float><<<moe::row_grid(n_rows), block, 0, s>>>(
        static_cast<const float*>(src), i, g, static_cast<float*>(dst),
        n_rows, k, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [n_pairs] fp32: sum_d a[p / k, d] * b[idx[p], d], or 0 where idx[p]
// < 0.
extern "C" int moe_pair_dot(const void* a, const void* b, const void* idx,
                            void* out, int n_pairs, int k, int d,
                            int elem_bytes, void* stream) {
  if (n_pairs == 0) return 0;
  const dim3 block(32, moe::kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  if (elem_bytes == 2) {
    moe::row_dot_kernel<__nv_bfloat16, true><<<moe::row_grid(n_pairs), block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), i, o, n_pairs, d, k);
  } else if (elem_bytes == 4) {
    moe::row_dot_kernel<float, true><<<moe::row_grid(n_pairs), block, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), i, o,
        n_pairs, d, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
