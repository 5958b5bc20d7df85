// Hopper (sm_90a) machinery for the hand-written kernels, in raw PTX (no
// CUTLASS/CuTe, so a source that includes it builds in seconds):
//
// - TMA: 4-D tensor maps over a [B, S, H, D] bf16 or fp32 view and 2-D
//   maps over the leading columns of a row-major matrix (host side,
//   encode_bshd_box, encode_rows), bulk tensor loads that complete on an
//   mbarrier, bulk tensor stores and fp32 reduce-adds;
// - mbarriers: init, arrive, arrive with an expected byte count, and a
//   wait on a phase parity;
// - warpgroup matrix products (wgmma.mma_async) with both operands in
//   shared memory, or A in registers, and their shared-memory matrix
//   descriptors for 128-byte-swizzled tiles;
// - register reallocation between warpgroups (setmaxnreg), named
//   barriers and the proxy fence between thread stores and async reads;
// - base-2 exponentials and the in-place RoPE rotation of swizzled bf16
//   tiles (rope_rows) that the Hopper kernels share.
//
// Shared-memory tiles: TMA writes a box of 64 bf16 columns (128 bytes) by
// R rows with the 128-byte swizzle: 16-byte chunk c of row r lands at
// r * 128 + ((c ^ (r % 8)) * 16) from a 1024-byte-aligned base (swz_off).
// A D-wide tile is D / 64 such boxes one after another. A wgmma
// descriptor over such a tile:
//   K-major (rows = M or N, 64 k per box; Q and K in Q.K^T):
//     SBO = 1024 (8 rows of 128 bytes), LBO unused (16); the k-step of 16
//     elements moves the start by 32 bytes inside a box, and the next box
//     by the box size;
//   MN-major (rows = k, 64 n per box; V in P.V, transposed):
//     SBO = 1024 (8 k-rows), LBO = the box size (the next 64 n); the
//     k-step of 16 rows moves the start by 16 * 128 bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"  // pack_bf16

namespace sm90 {

// Byte offset of 16-byte chunk `chunk` (0..D/8-1) of row `row` in a tile
// of 128-byte-swizzled boxes of `box_bytes` each.
__host__ __device__ __forceinline__ int swz_off(int row, int chunk,
                                                int box_bytes) {
  return (chunk >> 3) * box_bytes + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once (a ring's
// "empty" barriers start out released that way).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 4-D map at coordinates (c0, c1, c2, c3) (innermost first)
// into shared memory; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D map at coordinates (c0, c1) into shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One box from shared memory to the map's tensor; elements outside the
// tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One fp32 box from shared memory added element by element into the
// map's tensor (the reduction runs in L2); elements outside the tensor
// are not written.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Close this thread's group of bulk stores and reductions.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's committed bulk operations have read their
// shared-memory sources (the source may then be rewritten or the block
// exit).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Commit this thread's bulk stores and wait until their shared-memory
// reads are done (the source may then be reused or the block exit).
__device__ __forceinline__ void tma_store_wait() {
  bulk_commit();
  bulk_wait_read();
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Warpgroups
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `n` threads.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at `p` (1024-byte-aligned
// box, so the base-offset field stays 0); lbo/sbo in bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A descriptor moved by `bytes` (a multiple of 16) in shared memory.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma writes (accumulators) or reads
// (A fragments) to this point of the program: the compiler neither reads
// the former early nor reuses the latter before wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d = A . B^T (scale_d 0) or d += A . B^T (scale_d 1), m64n128k16, A and B
// K-major in shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d = A . B (scale_d 0) or d += A . B (scale_d 1), m64n64k16, both
// operands in shared memory. TransA / TransB 0 reads the operand K-major
// (A = rows of M, B = rows of N, k along a row: Q and K in K.Q^T), 1
// MN-major (k along the rows: dS^T read as dS, K read as B in dS.K).
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// d += A . B, m64n128k16: A (64 x 16) from registers in the mma.sync
// A-fragment layout (a[4] per thread), B MN-major in shared memory
// (descriptor db, transposed: imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n192k16: A (64 x 16) from registers in the mma.sync
// A-fragment layout (a[4] per thread), B MN-major in shared memory
// (descriptor db, transposed: imm-trans-b 1; three 64-column boxes LBO
// apart). d's registers follow m64n128's pattern over 24 n-tiles.
__device__ __forceinline__ void wgmma_rs_m64n192(float (&d)[96], const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n64k16: A (64 x 16) from registers in the mma.sync
// A-fragment layout (a[4] per thread), B MN-major in shared memory
// (descriptor db, transposed: imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// Exponentials and RoPE on swizzled bf16 tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// x * c + y * s rounded as flash::rot rounds it (two products, their
// sum): a product of two bf16 values is exact in fp32, so the fused form
// rounds the same sum once, as the unfused one does.
__device__ __forceinline__ float rot_exact(float x, float c, float y, float s) {
  return __fmaf_rn(x, c, __fmul_rn(y, s));
}

// One 32-bit word (two columns) of the rotation x * cos + roll(x, D/2) *
// sinm, as flash::rope16 computes it: lo = x * c + y * s and hi = y * c +
// x * (-s) in fp32, each rounded to bf16, where x holds columns c0, c0+1
// < D/2, y their partners c0 + D/2, c0 + D/2 + 1, and c, s the tables'
// columns c0, c0+1 (their second halves are c and -s). In a swizzled
// tile, 16-byte chunk j and its partner j + D/16 sit at offsets known
// from the row alone.
__device__ __forceinline__ void rope_word(uint32_t& x, uint32_t& y,
                                          uint32_t c, uint32_t s) {
  const float x0 = bf16_lo(x), x1 = bf16_hi(x), y0 = bf16_lo(y),
              y1 = bf16_hi(y), c0 = bf16_lo(c), c1 = bf16_hi(c),
              s0 = bf16_lo(s), s1 = bf16_hi(s);
  x = flash::pack_bf16(rot_exact(x0, c0, y0, s0), rot_exact(x1, c1, y1, s1));
  y = flash::pack_bf16(rot_exact(y0, c0, x0, -s0),
                       rot_exact(y1, c1, x1, -s1));
}

// Rows [r0, r0 + kRows) of a tile of D/64 swizzled boxes of kBox bytes
// each, whose row 0 sits at position pos0, rotated in place by the 128
// threads of one warpgroup (tid 0..127). `table(pos, row, j, c, s)`
// fetches chunk j of the row's cos_t/sinm_t first halves. A thread takes
// its items two at a time, every load of a pair before either rotation,
// so the pair costs one trip to memory (four at once would spill). Rows
// at or past S hold TMA's zeros and are left alone.
template <int D, int kBox, int kRows, typename Table>
__device__ __forceinline__ void rope_rows(uint8_t* tile, int r0, int pos0,
                                          int S, int tid, Table table) {
  constexpr int kHalf = D / 16;              // chunks in half a row
  constexpr int kItems = kRows * kHalf / 128;
  constexpr int kPair = kItems < 2 ? kItems : 2;
  static_assert(kItems >= 1 && kItems % kPair == 0, "rows x D per warpgroup");
#pragma unroll
  for (int n0 = 0; n0 < kItems; n0 += kPair) {
    uint4 c[kPair], s[kPair], lo[kPair], hi[kPair];
#pragma unroll
    for (int u = 0; u < kPair; ++u) {
      const int i = tid + 128 * (n0 + u), r = r0 + i / kHalf, j = i % kHalf;
      if (pos0 + r < S) {
        table(pos0 + r, r, j, c[u], s[u]);
        lo[u] = *reinterpret_cast<const uint4*>(tile + swz_off(r, j, kBox));
        hi[u] = *reinterpret_cast<const uint4*>(tile +
                                                swz_off(r, j + kHalf, kBox));
      }
    }
#pragma unroll
    for (int u = 0; u < kPair; ++u) {
      const int i = tid + 128 * (n0 + u), r = r0 + i / kHalf, j = i % kHalf;
      if (pos0 + r < S) {
        rope_word(lo[u].x, hi[u].x, c[u].x, s[u].x);
        rope_word(lo[u].y, hi[u].y, c[u].y, s[u].y);
        rope_word(lo[u].z, hi[u].z, c[u].z, s[u].z);
        rope_word(lo[u].w, hi[u].w, c[u].w, s[u].w);
        *reinterpret_cast<uint4*>(tile + swz_off(r, j, kBox)) = lo[u];
        *reinterpret_cast<uint4*>(tile + swz_off(r, j + kHalf, kBox)) = hi[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no -lcuda; null if the driver does not offer it.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A map over the [B, S, H, D] view at `base` with element strides (sb,
// ss, sh) and D stride 1, as dims (D, H, S, B), whose box is 128 bytes
// of columns (64 bf16 or 32 fp32) by `rows` rows of one (b, h), 128-byte
// swizzled. Rows past S load as zeros and are not stored. Strides must
// be multiples of 16 bytes. Returns false if the driver refuses it.
inline bool encode_bshd_box(CUtensorMap* map, CUtensorMapDataType type,
                            int elem_bytes, const void* base, int B, int S,
                            int H, int D, long long sb, long long ss,
                            long long sh, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * elem_bytes),
                                 (cuuint64_t)(ss * elem_bytes),
                                 (cuuint64_t)(sb * elem_bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem_bytes), 1,
                             (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 [B, S, H, D]: boxes of 64 columns by `rows` rows.
inline bool encode_bshd(CUtensorMap* map, const void* base, int B, int S,
                        int H, int D, long long sb, long long ss, long long sh,
                        int rows) {
  return encode_bshd_box(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, B, S,
                         H, D, sb, ss, sh, rows);
}

// A bf16 map over the first `cols` columns of a row-major [rows, pitch]
// matrix at `base` (pitch in elements), boxes of `cols` x `box_rows`,
// unswizzled: a box lands as box_rows rows of cols * 2 bytes. Rows past
// `rows` load as zeros. Returns false if the driver refuses it.
inline bool encode_rows(CUtensorMap* map, const void* base, int rows,
                        int cols, int pitch, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
