// Hopper (sm_90a) building blocks of the port's wgmma kernels
// (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu, flash_bwd_sm90.cu,
// int8mm_sm90.cu, and the wgmma bodies of int8mm_gemv_sm90.cu and
// decode_mlp_sm90.cu): cp.async copies into the 128-byte-swizzled tiles
// that wgmma descriptors read, the descriptors, and the wgmma products
// with their fences. The mma.sync kernels (the decode body in
// decode_attention.cuh, the int8 GEMV in int8mm_gemv_sm90.cu and the
// decode MLP in decode_mlp_sm90.cu at 1 and 2 planes) share the
// cp.async copies, the ring's mbarriers, ldmatrix and the m16n8k16
// product below.
//
// The tile layout: a tile of ROWS rows x HD bf16 columns is HD/64 column
// blocks of ROWS rows x 128 bytes, each 128-byte-swizzled (16-byte chunk
// c of row r at chunk c ^ (r % 8)). Its base is 1024-byte aligned, so
// every 8-row group is one swizzle atom. The same tile serves both
// operand majors:
//   - K-major (rows are M or N, the contraction runs along the row):
//     stride byte offset 1024 (one 8-row group), a 16-column k-step 32
//     bytes on inside a column block, the next 64 columns one block on;
//   - MN-major (rows are the contraction, columns are N; transpose-B):
//     leading byte offset one column block (ROWS x 128 bytes), stride
//     byte offset 1024, a 16-row k-step 2048 bytes on.
//
// The accumulator fragment of a 64 x N wgmma product: thread t of the
// warpgroup (warp w = t / 32, lane l) holds, for each 8-column chunk j,
// elements 4j..4j+3 at rows 16w + l/4 (e = 0, 1) and 16w + l/4 + 8
// (e = 2, 3), columns 8j + 2 (l % 4) + (e % 2). Packed to bf16x2 in
// order, the fragment of columns 16kk..16kk+15 (elements 8kk..8kk+7) is
// the register-A fragment of k-step kk of a product that contracts over
// those columns.
#pragma once

#include "common.cuh"

namespace tpu_dra {

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 8 bytes (L1-cached: the int8 GEMV's x fragments); src-size 0 writes
// zeros.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
// One float; src-size 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the
// async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of a row-major matrix whose row r starts at
// src + r * stride (HD bf16 each) into the swizzled tile at dst, copied
// by THREADS threads; rows at or past `rows` are zero.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                size_t stride, int row0,
                                                int rows) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  static_assert(ROWS * kChunks % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / THREADS; ++n) {
    const int c = threadIdx.x + n * THREADS;
    const int r = c / kChunks;
    const int cc = c % kChunks;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* g =
        ok ? src + static_cast<size_t>(row0 + r) * stride + cc * 8 : src;
    cp_async16(dst + (cc / 8) * (ROWS * 128) + r * 128 +
                   (((cc % 8) ^ (r % 8)) << 4),
               g, ok);
  }
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each >> 4.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are
// pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of wgmma operands
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// mbarrier helpers: a ring slot's "full" barrier completes once every
// thread's copies into it have landed (cp.async.mbarrier.arrive), its
// "empty" barrier once every thread has read it.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Four 8 x 8 b16 matrices: lanes 8i .. 8i + 7 give the 16-byte rows of
// matrix i. Plain, lane l gets row l / 4, elements 2 (l % 4) and +1 of
// each; transposed (.trans), elements 2 (l % 4) and +1 of column l / 4,
// i.e. two consecutive rows of one column.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr,
                                            uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, fp32) += A (16 x 16 bf16, row-major) . B (16 x 8 bf16,
// column-major). For lane (g = lane / 4, t = lane % 4): a0 = A[g][2t,
// 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8,
// 2t+9]; b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]; d0, d1 = D[g][2t,
// 2t+1], d2, d3 = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[0:64] (+)= A . B over 16 of K: A is 64 rows x 16 of a K-major
// shared tile (descriptor a); B is 16 (k) x 128 (n), by default K-major
// (128 rows of n, descriptor b: d = A . B^T of that tile), with
// TRANS_B = 1 MN-major (16 rows of k x 128 columns, transpose-B set).
// scale_d = 0 overwrites d.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t a,
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// d[0:32] (+)= A . B^T over 16 of K: A is 64 rows x 16 of a K-major
// shared tile (descriptor a), B is 64 rows (n) x 16 of a K-major tile
// (descriptor b). scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:64] += A . B over 16 of K: A is this thread's four packed bf16x2
// registers of a 64 x 16 tile, B is 16 (k) x 128 (n) of a shared tile,
// by default MN-major (descriptor b, transpose-B set), with TRANS_B = 0
// K-major (128 rows of n x 16 k).
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

// d[0:32] += A . B over 16 of K: A is this thread's four packed bf16x2
// registers of a 64 x 16 tile, B is 16 (k) x 64 (n) of a shared tile,
// by default MN-major (descriptor b, transpose-B set), with TRANS_B = 0
// K-major (64 rows of n x 16 k).
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

// d[0:16] += A . B over 16 of K: A is this thread's four packed bf16x2
// registers of a 64 x 16 tile, B is 16 (k) x 32 (n) of a shared tile,
// by default MN-major, with TRANS_B = 0 K-major (32 rows of n x 16 k).
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

// d += A . B for one 16-row k-step with A in registers and B MN-major,
// N = the head dim (the accumulator's size: 64 floats at 128, 32 at 64).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_m64n128k16(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_m64n64k16(d, a, b);
}

}  // namespace tpu_dra
