// Weight-only int8 matmul for Hopper (sm_90a), the tensor-core tile for
// large M:
//   out[m, n] = bf16((sum_k f32(x[m, k]) * f32(w_q[k, n])) * scale[n])
// for bf16 x [M, K], int8 w_q [K, N] row-major and a per-column f32
// scale [N]; the wrapper sends it bf16 with M > 16, K % 8 == 0,
// N % 16 == 0 and x, w_q 16-byte aligned (ops/int8mm.py `_int8mm_route`,
// "sm90"). int8mm.cu keeps the decode GEMV (M <= 16), fp32 and the
// shapes this kernel does not take.
//
// Replaces: tpu_dra/workloads/ops/int8mm.py `_kernel` (:47, wrapper
// `_pallas_int8_matmul` :68, pallas_call :76) at prefill shapes.
// Numerics are the Pallas body's: the int8 weights convert exactly to
// bf16 (every int8 value is a bf16), the products accumulate in fp32,
// the scale multiplies the finished fp32 sum once, one rounding.
//
// What bounds it on an H100: 2 M K N operations against K N + 2 M K +
// 2 M N bytes. At Llama-3-8B widths it is operations bound from M ~ 170
// on; at the engine's prefill bucket (M = 1024, K = 4096, N = 14336) it
// does 120 GFLOP against 88 MB, 0.122 ms of bf16 tensor work against
// 0.026 ms of memory. So the tensor cores must be kept busy, and the
// int8 -> bf16 conversion that wgmma needs (it takes no mixed types)
// must neither sit between the products nor cost more than they do.
// The design:
//   - a CTA of ROWS / 64 consumer warpgroups (ROWS = 128 or 256, the
//     wrapper's choice by grid size) owns a ROWS x 128 output tile, 64
//     rows and 64 fp32 accumulators a thread per warpgroup, and walks K
//     in steps of 64 with 4 wgmma m64n128k16 a step: A is the x tile,
//     K-major, B the W tile in bf16, MN-major (transpose-B), both in the
//     128-byte-swizzled layout of sm90.cuh. Every warpgroup shares the
//     one converted W tile, so at 256 rows a weight is converted once
//     for every 256 rows of x;
//   - x tiles come by 16-byte cp.async into a ring of four stages, two
//     steps ahead; the raw int8 W tiles (8 KB) into a ring of three,
//     three steps ahead, so the W bytes from HBM have two steps to land.
//     Rows past M, columns past K and N are zero-filled by cp.async's
//     source size;
//   - the conversion overlaps the products: after issuing step t's
//     wgmmas, each thread converts step t+1's W chunks that it copied
//     itself (so its own cp.async wait orders the reads) into one of
//     three bf16 W buffers. A warpgroup keeps step t's products in
//     flight across the step's one barrier and waits only for step
//     t-1's, so the tensor cores always have the next step queued;
//   - M tiles run fastest in the grid, so the CTAs in flight together
//     share a W slab and read it from HBM once while x stays in L2;
//   - the epilogue scales the fp32 accumulators and writes bf16x2 pairs
//     straight from the fragment. One CTA owns each output tile and K
//     runs in a fixed order (no split-K, no atomics): reruns give
//     identical bits.

#include "sm90.cuh"

namespace tpu_dra {
namespace {

constexpr int kTileN = 128;  // output columns a CTA
constexpr int kTileK = 64;   // contraction a step: a 128-byte bf16 row
constexpr int kXAhead = 2;   // step t loads x t+2 ...
constexpr int kWAhead = 3;   // ... and W t+3
constexpr int kXStages = kXAhead + 2;  // x t+2 reuses step t-2's stage
constexpr int kRawStages = kWAhead;    // W t+3 reuses step t's raw stage
constexpr int kWBufs = 3;  // bf16 W tiles: steps t-1 (in flight), t, t+1
constexpr uint32_t kRawBytes = kTileK * kTileN;  // 64 k-rows x 128 bytes
constexpr uint32_t kWBlock = kTileK * 128;  // 64 k-rows x 64 bf16 columns
constexpr uint32_t kWBytes = 2 * kWBlock;

// A CTA's ROWS x 128 output tile. Shared memory from a 1024-byte-aligned
// base: the x ring (ROWS rows x 128 bytes a stage, one swizzled column
// block), the raw int8 W ring, then the bf16 W tiles, each 64 k-rows x
// 128 columns as two swizzled 64-column blocks of 64 rows x 128 bytes
// (the MN-major B operand).
template <int ROWS>
struct Tile {
  static constexpr int kThreads = 2 * ROWS;  // 128 a warpgroup
  static constexpr int kWChunks = kRawBytes / 16 / kThreads;  // a thread
  static constexpr uint32_t kXBytes = ROWS * 128;
  static constexpr uint32_t kRaw0 = kXStages * kXBytes;
  static constexpr uint32_t kW0 = kRaw0 + kRawStages * kRawBytes;
  static constexpr uint32_t kBytes = kW0 + kWBufs * kWBytes;
  static __device__ __forceinline__ uint32_t x(uint32_t base, int s) {
    return base + s * kXBytes;
  }
  static __device__ __forceinline__ uint32_t raw(uint32_t base, int s) {
    return base + kRaw0 + s * kRawBytes;
  }
  static __device__ __forceinline__ uint32_t w(uint32_t base, int b) {
    return base + kW0 + b * kWBytes;
  }
};

// The raw W tile is 512 16-byte chunks (16 int8 columns of one k-row);
// thread t copies and converts chunks t + j * threads. Chunk i holds
// k-row 2 (i / 16) + (i / 4) % 2 and columns 16 c16 .. 16 c16 + 15 with
// c16 = 4 ((i / 8) % 2) + i % 4: a quarter-warp (8 chunks) takes two
// adjacent rows of one 64-column block, so its 16-byte stores of
// converted bf16 land on 8 distinct swizzled positions (no bank
// conflict), and a warp reads four whole 128-byte rows of W.
struct WChunk {
  int k, c16;
};
__device__ __forceinline__ WChunk w_chunk(int i) {
  return {2 * (i / 16) + (i / 4) % 2, 4 * ((i / 8) % 2) + i % 4};
}
// Chunk c16 of raw row k sits at c16 ^ (4 (k % 2)), so the
// quarter-warp's reads of its own chunks are conflict-free too.
__device__ __forceinline__ uint32_t raw_offset(WChunk c) {
  return c.k * 128 + ((c.c16 ^ ((c.k & 1) << 2)) << 4);
}

// x rows [m0, m0 + ROWS) x columns [k0, k0 + 64) into x stage s. K % 8
// == 0 puts every 16-byte chunk wholly inside or wholly past K; the
// chunks past M or K are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_x(uint32_t base, int s,
                                       const __nv_bfloat16* x, int M, int K,
                                       int m0, int k0) {
  using T = Tile<ROWS>;
  const uint32_t xs = T::x(base, s);
#pragma unroll
  for (int j = 0; j < ROWS * 8 / T::kThreads; ++j) {
    const int c = threadIdx.x + j * T::kThreads;
    const int r = c / 8;
    const int cc = c % 8;
    const bool ok = m0 + r < M && k0 + cc * 8 < K;
    const __nv_bfloat16* g =
        ok ? x + static_cast<size_t>(m0 + r) * K + k0 + cc * 8 : x;
    cp_async16(xs + r * 128 + ((cc ^ (r % 8)) << 4), g, ok);
  }
}

// This thread's chunks of W rows [k0, k0 + 64) x columns [n0, n0 + 128)
// into raw stage s (N % 16 == 0: a chunk is wholly inside or past N).
template <int ROWS>
__device__ __forceinline__ void load_w(uint32_t base, int s, const int8_t* w,
                                       int K, int N, int n0, int k0) {
  using T = Tile<ROWS>;
  const uint32_t raw = T::raw(base, s);
#pragma unroll
  for (int j = 0; j < T::kWChunks; ++j) {
    const WChunk c = w_chunk(threadIdx.x + j * T::kThreads);
    const bool ok = k0 + c.k < K && n0 + 16 * c.c16 < N;
    const int8_t* g =
        ok ? w + static_cast<size_t>(k0 + c.k) * N + n0 + 16 * c.c16 : w;
    cp_async16(raw + raw_offset(c), g, ok);
  }
}

// This thread's chunks of raw stage s -> bf16 W tile b (bf16 column n
// of row k is 16-byte chunk (n % 64) / 8 of row k in block n / 64,
// swizzled).
template <int ROWS>
__device__ __forceinline__ void convert_w(uint32_t base, int s, int b) {
  using T = Tile<ROWS>;
  const uint32_t raw = T::raw(base, s);
  const uint32_t wt = T::w(base, b);
#pragma unroll
  for (int j = 0; j < T::kWChunks; ++j) {
    const WChunk c = w_chunk(threadIdx.x + j * T::kThreads);
    uint32_t v[4], o[8];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(raw + raw_offset(c))
                 : "memory");
#pragma unroll
    for (int q = 0; q < 4; ++q) i8x4_to_bf16x4(v[q], o[2 * q], o[2 * q + 1]);
    const uint32_t row = wt + (c.c16 / 4) * kWBlock + c.k * 128;
    const int chunk = 2 * (c.c16 % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile(
          "st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
              row + (((chunk + h) ^ (c.k % 8)) << 4)),
          "r"(o[4 * h]), "r"(o[4 * h + 1]), "r"(o[4 * h + 2]),
          "r"(o[4 * h + 3])
          : "memory");
  }
}

template <int ROWS>
__global__ void __launch_bounds__(2 * ROWS, 1)
int8_matmul_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        __nv_bfloat16* __restrict__ out, int M, int K,
                        int N) {
  using T = Tile<ROWS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const int m0 = blockIdx.x * ROWS;
  const int n0 = blockIdx.y * kTileN;
  const int n_steps = (K + kTileK - 1) / kTileK;

  // Group g (g = -kWAhead .. -1 before the loop, then the step) holds
  // x g + kXAhead and W g + kWAhead where they exist, so at step t W t+1
  // is kWAhead - 1 groups back and x t+1 kXAhead - 1.
  auto issue = [&](int g) {
    const int tx = g + kXAhead;
    const int tw = g + kWAhead;
    if (tx >= 0 && tx < n_steps)
      load_x<ROWS>(base, tx % kXStages, x, M, K, m0, tx * kTileK);
    if (tw >= 0 && tw < n_steps)
      load_w<ROWS>(base, tw % kRawStages, w, K, N, n0, tw * kTileK);
    cp_async_commit();
  };
  // Step t+1's W into bf16 buffer (t+1) % 3 once its bytes have landed,
  // then x t+1, then the barrier that publishes both.
  auto next = [&](int t) {
    if (t + 1 < n_steps) {
      cp_async_wait<kWAhead - 1>();
      convert_w<ROWS>(base, (t + 1) % kRawStages, (t + 1) % kWBufs);
      cp_async_wait<kXAhead - 1>();
    }
    fence_proxy_async();
    __syncthreads();
  };
  for (int g = -kWAhead; g < 0; ++g) issue(g);
  next(-1);

  const int wg = threadIdx.x / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  pin(acc);

  for (int t = 0; t < n_steps; ++t) {
    issue(t);
    const uint32_t xa = T::x(base, t % kXStages) + wg * 64 * 128;
    const uint32_t wb = T::w(base, t % kWBufs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      wgmma_ss_m64n128k16<1>(acc, smem_desc(xa + kk * 32, 16, 1024),
                             smem_desc(wb + kk * 2048, kWBlock, 1024), 1);
    wgmma_commit();
    // Step t-1's products are done: its x stage and bf16 buffer are
    // free once every warpgroup passes the barrier of next(t).
    wgmma_wait<1>();
    next(t);
  }
  wgmma_wait_all();
  pin(acc);

  // acc x scale rounded once to bf16, bf16x2 pairs straight from the
  // fragment; N % 16 == 0, so a pair is wholly inside or past N.
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row = m0 + wg * 64 + 16 * warp + lane / 4;  // and row + 8
  const int col = n0 + 2 * (lane % 4);                   // + 8 j
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int n = col + 8 * j;
    if (n >= N) continue;
    const float s0 = scale[n];
    const float s1 = scale[n + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = row + 8 * r;
      if (m < M)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * N +
                                           n) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * s0,
                                  acc[4 * j + 2 * r + 1] * s1);
    }
  }
}

// Dynamic shared memory of a CTA: the tiles and 1 KB of slack for the
// 1024-byte alignment of their base.
template <int ROWS>
constexpr size_t smem_bytes() {
  return Tile<ROWS>::kBytes + 1024;
}

template <int ROWS>
cudaError_t launch(const void* x, const void* w_q, const void* scale,
                   void* out, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((M + ROWS - 1) / ROWS, (N + kTileN - 1) / kTileN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<ROWS>();
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_sm90_kernel<ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int8_matmul_sm90_kernel<ROWS><<<grid, 2 * ROWS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M,
      K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_dra

// x [M, K] bf16, w_q [K, N] int8, scale [N] f32, out [M, N] bf16, all
// contiguous; K % 8 == 0, N % 16 == 0, x and w_q 16-byte aligned;
// rows the CTA tile's, 128 or 256. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a shape, alignment or tile it does
// not take).
extern "C" int tpu_int8_matmul_sm90(const void* x, const void* w_q,
                                    const void* scale, void* out, int M,
                                    int K, int N, int rows, void* stream) {
  using namespace tpu_dra;
  if (M == 0 || N == 0) return cudaSuccess;
  const bool ok = M > 0 && K > 0 && K % 8 == 0 && N > 0 && N % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w_q) % 16 == 0;
  if (!ok) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 128:
      return launch<128>(x, w_q, scale, out, M, K, N, s);
    case 256:
      return launch<256>(x, w_q, scale, out, M, K, N, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a CTA of the rows tile asks for, in bytes
// (0 for a tile it does not take).
extern "C" int tpu_int8_matmul_sm90_smem(int rows) {
  using namespace tpu_dra;
  switch (rows) {
    case 128: return static_cast<int>(smem_bytes<128>());
    case 256: return static_cast<int>(smem_bytes<256>());
    default: return 0;
  }
}
