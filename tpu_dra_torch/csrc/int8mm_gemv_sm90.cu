// Weight-only int8 matmul for Hopper (sm_90a), the decode GEMV:
//   out[m, n] = bf16((sum_k f32(x[m, k]) * f32(w_q[k, n])) * scale[n])
// for bf16 x [M, K] with M <= 16 (M = the decode step's slot count),
// int8 w_q [K, N] row-major and a per-column f32 scale [N]. The wrapper
// (ops/int8mm.py `_int8mm_route`, "gemv_sm90") sends it bf16 with
// M <= 16, K % 4 == 0, N % 16 == 0, x 8-byte and w_q 16-byte aligned:
// every decode projection and lm_head at Llama-3-8B widths. int8mm.cu's
// gemv_kernel keeps fp32 and the shapes this kernel does not take.
//
// Replaces: tpu_dra/workloads/ops/int8mm.py `_kernel` (:47, wrapper
// `_pallas_int8_matmul` :68, pallas_call :76) at decode shapes. Numerics
// are the Pallas body's: the int8 weights convert exactly to bf16, the
// products are exact in fp32 and sum in fp32, the scale multiplies the
// finished sum once, one rounding.
//
// What bounds it on an H100: bytes. Every weight byte feeds 2 M flops,
// so at M = 8 the K N int8 bytes take 0.0176 ms at gate/up (4096 x
// 14336) against ~1 us of tensor work. The design:
//   - the products run on the tensor cores, mma.sync m16n8k16 bf16 with
//     fp32 accumulators. The int8 weights are converted to bf16 in
//     registers (common.cuh: a byte permute and an add a byte, a permute
//     packs two), about 3 instructions a weight byte where CUDA-core
//     FMAs took about 10. W^T is the A operand (16 columns x 16 k) and
//     x^T the B operand (16 k x 8 rows of x), so at M <= 8 no half of the
//     tile idles: one mma a 256-byte piece of W (two, one a plane of 8
//     rows, for 9 <= M <= 16). wgmma would need W as a 64-row register A
//     operand and its fences; for a product bound by bytes it buys
//     nothing;
//   - the contraction order is free, so x and W take the same
//     permutation of k: for lane (g = lane / 4, t = lane % 4), fragment
//     k 2t, 2t+1, 2t+8, 2t+9 of a k16 step are the physical rows
//     4t .. 4t+3. The lane reads 16 bytes of each of those rows, columns
//     16 g .. 16 g + 15 of its warp's 128-column slab; byte j and byte
//     8 + j give rows g and g + 8 of the A fragment of tile j (j < 8),
//     and the B fragment of x row g is the 8 bytes x[g][4t .. 4t+3];
//   - the CTA's 8 warps copy each stage of W together (16-byte cp.async
//     chunks, consecutive threads on consecutive chunks of a row) and
//     every warp reads its fragments from shared memory; a ring of 4
//     stages, each slot with a "full" mbarrier (every thread's copies
//     landed: cp.async.mbarrier.arrive) and an "empty" one (every thread
//     has read it), keeps 3 stages (48 KB) in flight a CTA with no
//     CTA-wide barrier in the loop. The x pieces of a stage ride in the
//     same slot. (Warps that each copied and read back only their own
//     16-byte pieces, with no barrier at all, streamed W markedly slower
//     on the H100 in exploratory builds);
//   - one launch, the K split reduced on chip: a CTA's 8 warps cover
//     warps_n slabs x 8 / warps_n k16 steps of each stage, and a
//     thread-block cluster of up to 8 CTAs (the launch's cluster
//     attribute, since the plan picks its size per shape) splits K
//     further. The warps of a slab meet in shared memory and the CTAs of
//     a cluster through distributed shared memory, each sum in a fixed
//     order (warps, then ranks, ascending); every rank finishes its
//     share of the columns, scales, rounds and writes. No fp32 partials
//     in device memory, no second kernel, no atomics: reruns give
//     identical bits.
// The plan (warps_n, cluster, K ranges) comes from ops/int8mm.py
// `gemv_sm90_plan`, from (M, K, N, SM count) alone.

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace tpu_dra {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;                  // ring depth
constexpr int kCols = 128;                  // a warp's slab: 8 lanes x 16 bytes
constexpr int kWBytes = kWarps * 16 * kCols;  // a stage's W: 16 KB
constexpr int kPlaneBytes = 32 * 8;  // x pieces of 8 rows for one k16 step
constexpr int kMaxCluster = 8;
// The most dynamic shared memory a CTA asks for: 227 KB less 1 KB for
// its static barriers.
constexpr int kMaxSmem = 232448 - 1024;

// A stage: W's 16 rows x 128 columns for each warp, then the x pieces
// of its warps_k k16 steps.
__host__ __device__ constexpr int stage_bytes(int planes, int warps_k) {
  return kWBytes + warps_k * planes * kPlaneBytes;
}

// Grid (cluster, column CTAs): blockIdx.x is the CTA's rank in its
// cluster, which takes k16 steps [rank * cta_steps, + cta_steps). The
// CTA owns warps_n slabs (a block of 128 warps_n columns) and walks its
// steps in stages of warps_k = 8 / warps_n steps: warp w takes slab
// w / warps_k and step w % warps_k of every stage.
template <int PLANES>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemv_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out, int M, int K, int N,
                      int warps_n, int cta_steps) {
  constexpr int kRows = 8 * PLANES;  // the partial sums' rows
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full, then empty
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  const uint32_t empty0 = full0 + 8 * kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int warps_k = kWarps / warps_n;
  const int sn = warp / warps_k;
  const int wk = warp % warps_k;
  const int rank = blockIdx.x;
  const int cluster = gridDim.x;
  const int cta_begin = rank * cta_steps;
  const int cta_end = min((K + 15) / 16, cta_begin + cta_steps);
  const int k_end = min(K, 16 * cta_end);  // rows past it read as zeros
  const int n_stages = max(0, (cta_end - cta_begin + warps_k - 1) / warps_k);
  const int width = warps_n * kCols;  // the CTA's block, bytes a row
  const int cta_col0 = blockIdx.y * width;
  const int sbytes = stage_bytes(PLANES, warps_k);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, kThreads);
      mbar_init(empty0 + 8 * i, kThreads);
    }
  }
  __syncthreads();  // the barriers are initialized

  // Stage s covers k16 steps cta_begin + warps_k s + [0, warps_k): W
  // rows [16 (cta_begin + warps_k s), + 16 warps_k) of the CTA's block,
  // row r at slot + r width, then x piece (j, p, l) at slot + kWBytes +
  // 8 ((j PLANES + p) 32 + l): x[8 p + l / 4][16 (step j) + 4 (l % 4)
  // .. + 3]. Chunk c of row r sits at c ^ 2 ((r / 4) % 4) within its
  // 128 bytes, so the 8 lanes of a quarter-warp read 8 distinct bank
  // groups. Thread tid copies the 16-byte W chunks tid + 256 j of the
  // stage in row order: the same column chunk tid % chunks (chunks
  // divides 256) of rows r0 + j (256 / chunks), so its offsets are fixed
  // and its source pointer walks down W a stage at a time.
  const int chunks = width / 16;  // a row's
  constexpr int kChunks = kWBytes / 16 / kThreads;  // a thread's, a stage
  const int ch = threadIdx.x % chunks;
  const int r0 = threadIdx.x / chunks;
  const int r_step = kThreads / chunks;
  const bool col_ok = cta_col0 + 16 * ch < N;
  uint32_t w_dst[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int r = r0 + j * r_step;
    w_dst[j] = r * width + ((ch ^ (2 * ((r / 4) % 4))) << 4);
  }
  const int8_t* src = w + static_cast<size_t>(16 * cta_begin + r0) * N +
                      cta_col0 + 16 * ch;
  const size_t r_stride = static_cast<size_t>(r_step) * N;
  const size_t stage_stride = static_cast<size_t>(16 * warps_k) * N;
  int row = 16 * cta_begin + r0;  // of chunk 0, this stage
  // This thread's x pieces i = tid + 256 h (h < PLANES): (step
  // i / (32 PLANES), plane (i / 32) % PLANES, lane i % 32) of a stage.
  int x_k[PLANES];
  const __nv_bfloat16* x_src[PLANES];
  bool x_ok[PLANES];
#pragma unroll
  for (int h = 0; h < PLANES; ++h) {
    const int i = threadIdx.x + h * kThreads;
    const int m = 8 * ((i / 32) % PLANES) + (i % 32) / 4;
    x_k[h] = 16 * (cta_begin + i / (32 * PLANES)) + 4 * (i % 4);
    x_ok[h] = i < warps_k * PLANES * 32 && m < M;
    x_src[h] = x + static_cast<size_t>(m) * K + x_k[h];
  }
  auto issue = [&](int s) {
    if (s >= n_stages) return;
    const int slot = s % kStages;
    if (s >= kStages) mbar_wait(empty0 + 8 * slot, (s / kStages - 1) & 1);
    const uint32_t stage = base + slot * sbytes;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const bool ok = col_ok && row + j * r_step < k_end;
      cp_async16(stage + w_dst[j], ok ? src + j * r_stride : w, ok);
    }
    src += stage_stride;
    row += 16 * warps_k;
#pragma unroll
    for (int h = 0; h < PLANES; ++h) {
      if (threadIdx.x + h * kThreads >= warps_k * PLANES * 32) break;
      const bool ok = x_ok[h] && x_k[h] < k_end;  // K % 4 == 0: whole
      cp_async8(stage + kWBytes + (threadIdx.x + h * kThreads) * 8,
                ok ? x_src[h] : x, ok);
      x_src[h] += 16 * warps_k;
      x_k[h] += 16 * warps_k;
    }
    mbar_arrive_on_copies(full0 + 8 * slot);
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // acc[p][j]: tile j's 16 columns x rows 8 p .. 8 p + 7.
  float acc[PLANES][8][4];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][j][c] = 0.0f;

  // Lane (g, t) reads rows 16 wk + 4 t + r (r = 0..3) of each stage,
  // chunk 8 sn + g (columns 128 sn + 16 g .. + 15 of the block), and
  // the x pieces of step wk.
  const uint32_t my_w =
      (16 * wk + 4 * t) * width + (((8 * sn + g) ^ (2 * t)) << 4);
  const uint32_t my_x = kWBytes + (wk * PLANES * 32 + lane) * 8;
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % kStages;
    mbar_wait(full0 + 8 * slot, (s / kStages) & 1);
    const uint32_t st = base + slot * sbytes;
    uint32_t u[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(u[r][0]), "=r"(u[r][1]), "=r"(u[r][2]),
                     "=r"(u[r][3])
                   : "r"(st + my_w + r * width)
                   : "memory");
    uint32_t b[PLANES][2];
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
      asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(b[p][0]), "=r"(b[p][1])
                   : "r"(st + my_x + p * kPlaneBytes)
                   : "memory");
    mbar_arrive(empty0 + 8 * slot);  // this thread is done with stage s
    issue(s + kStages - 1);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) u[r][q] ^= 0x80808080u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = j / 4;
      const int i = j % 4;
      // Rows 4t, 4t+1 (a0, a1) and 4t+2, 4t+3 (a2, a3) of columns
      // 16 g + j (a0, a2) and 16 g + 8 + j (a1, a3).
      uint32_t a[4];
      a[0] = pack_upper_halves(i8_f32_bits(u[0][q], i),
                               i8_f32_bits(u[1][q], i));
      a[1] = pack_upper_halves(i8_f32_bits(u[0][q + 2], i),
                               i8_f32_bits(u[1][q + 2], i));
      a[2] = pack_upper_halves(i8_f32_bits(u[2][q], i),
                               i8_f32_bits(u[3][q], i));
      a[3] = pack_upper_halves(i8_f32_bits(u[2][q + 2], i),
                               i8_f32_bits(u[3][q + 2], i));
#pragma unroll
      for (int p = 0; p < PLANES; ++p)
        mma_16816(acc[p][j], a, b[p][0], b[p][1]);
    }
  }
  __syncthreads();  // every warp is done with the ring: it holds the sums

  // Warp w's sums at red[w][row][column of its slab]: lane (g, t) holds
  // rows 8 p + 2 t (c0, c2) and 8 p + 2 t + 1 (c1, c3), columns 16 g + j
  // (c0, c1) and 16 g + 8 + j (c2, c3) of tile j.
  float* red = reinterpret_cast<float*>(smem);
  float* mine = red + warp * kRows * kCols;
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = mine + (8 * p + 2 * t + h) * kCols + 16 * g;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(row + 4 * c) = make_float4(
            acc[p][4 * (c % 2)][2 * (c / 2) + h],
            acc[p][4 * (c % 2) + 1][2 * (c / 2) + h],
            acc[p][4 * (c % 2) + 2][2 * (c / 2) + h],
            acc[p][4 * (c % 2) + 3][2 * (c / 2) + h]);
    }
  __syncthreads();

  // The CTA's sum of each slab, warps in order, into its first warp's
  // slot; float4 group e is row (e / 32) % kRows, columns 4 (e % 32) of
  // slab e / (32 kRows). Rows past M are skipped here and below.
  const int groups = warps_n * kRows * 32;
  for (int e = threadIdx.x; e < groups; e += kThreads) {
    if ((e / 32) % kRows >= M) continue;
    float4* p0 = reinterpret_cast<float4*>(red) +
                 (e / (kRows * 32)) * warps_k * kRows * 32 + e % (kRows * 32);
    float4 v = *p0;
    for (int i = 1; i < warps_k; ++i) {
      const float4 o = p0[i * kRows * 32];
      v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
    }
    *p0 = v;
  }
  cg::cluster_group cl = cg::this_cluster();
  if (cluster > 1)
    cl.sync();  // every rank's sums are visible across the cluster
  else
    __syncthreads();

  // Rank r finishes groups [r * per, (r + 1) * per): the ranks' sums in
  // rank order, times the scale, rounded once.
  const int per = (groups + cluster - 1) / cluster;
  const int e_end = min(groups, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < e_end; e += kThreads) {
    const int m = (e / 32) % kRows;
    const int n = cta_col0 + (e / (kRows * 32)) * kCols + 4 * (e % 32);
    if (m >= M || n >= N) continue;
    const int off =
        (e / (kRows * 32)) * warps_k * kRows * 32 + e % (kRows * 32);
    float4 v = reinterpret_cast<float4*>(cl.map_shared_rank(red, 0))[off];
    for (int r = 1; r < cluster; ++r) {
      const float4 o =
          reinterpret_cast<float4*>(cl.map_shared_rank(red, r))[off];
      v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
    }
    uint2 packed;
    packed.x = pack_bf16(v.x * scale[n], v.y * scale[n + 1]);
    packed.y = pack_bf16(v.z * scale[n + 2], v.w * scale[n + 3]);
    *reinterpret_cast<uint2*>(out + static_cast<size_t>(m) * N + n) = packed;
  }
  if (cluster > 1) cl.sync();  // no rank leaves while its sums are read
}

// Dynamic shared memory of a CTA: the ring, which holds the warps' sums
// after the loop.
size_t smem_bytes(int planes, int warps_n) {
  const size_t ring =
      static_cast<size_t>(kStages) * stage_bytes(planes, kWarps / warps_n);
  const size_t red = static_cast<size_t>(kWarps) * 8 * planes * kCols * 4;
  return ring > red ? ring : red;
}

// The launch configuration of a plan, less the stream.
template <int PLANES>
cudaLaunchConfig_t config(int N, int warps_n, int cluster,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int slabs = (N + kCols - 1) / kCols;
  cfg.gridDim = dim3(cluster, (slabs + warps_n - 1) / warps_n, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(PLANES, warps_n);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int PLANES>
cudaError_t launch(const void* x, const void* w_q, const void* scale,
                   void* out, int M, int K, int N, int warps_n, int cluster,
                   int cta_steps, cudaStream_t stream) {
  if ((N + kCols - 1) / kCols > 65535 * warps_n) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemv_sm90_kernel<PLANES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<PLANES>(N, warps_n, cluster, attr);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(
      &cfg, int8_gemv_sm90_kernel<PLANES>,
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M,
      K, N, warps_n, cta_steps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_dra

// x [M, K] bf16, w_q [K, N] int8, scale [N] f32, out [M, N] bf16, all
// contiguous; 1 <= M <= 16, K % 4 == 0, N % 16 == 0, x 8-byte and w_q
// 16-byte aligned. The plan: warps_n (1, 2, 4 or 8) slabs a CTA, a
// cluster of `cluster` (1..8) CTAs along K and cta_steps k16 steps a
// CTA, covering ceil(K / 16) steps. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a shape, alignment or plan it does
// not take).
extern "C" int tpu_int8_gemv_sm90(const void* x, const void* w_q,
                                  const void* scale, void* out, int M, int K,
                                  int N, int warps_n, int cluster,
                                  int cta_steps, void* stream) {
  using namespace tpu_dra;
  if (M == 0 || N == 0) return cudaSuccess;
  const int steps = (K + 15) / 16;
  const int planes = M <= 8 ? 1 : 2;
  const bool ok =
      M > 0 && M <= 16 && K > 0 && K % 4 == 0 && N > 0 && N % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(w_q) % 16 == 0 &&
      (warps_n == 1 || warps_n == 2 || warps_n == 4 || warps_n == 8) &&
      cluster >= 1 && cluster <= kMaxCluster && cta_steps >= 1 &&
      static_cast<long long>(cluster) * cta_steps >= steps &&
      smem_bytes(planes, warps_n) <= static_cast<size_t>(kMaxSmem);
  if (!ok) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes == 1)
    return launch<1>(x, w_q, scale, out, M, K, N, warps_n, cluster,
                     cta_steps, s);
  return launch<2>(x, w_q, scale, out, M, K, N, warps_n, cluster, cta_steps,
                   s);
}

// How many clusters of `cluster` CTAs of the plan (planes, warps_n) the
// device holds at once (cudaOccupancyMaxActiveClusters), or -1 when the
// query fails: what the plan's cap on clustered grids stands for.
extern "C" int tpu_int8_gemv_sm90_max_clusters(int planes, int warps_n,
                                               int cluster) {
  using namespace tpu_dra;
  cudaLaunchAttribute attr[1];
  int n = -1;
  cudaError_t err;
  if (planes == 1) {
    cudaFuncSetAttribute(int8_gemv_sm90_kernel<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    const cudaLaunchConfig_t cfg = config<1>(1 << 20, warps_n, cluster, attr);
    err = cudaOccupancyMaxActiveClusters(&n, int8_gemv_sm90_kernel<1>, &cfg);
  } else {
    cudaFuncSetAttribute(int8_gemv_sm90_kernel<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    const cudaLaunchConfig_t cfg = config<2>(1 << 20, warps_n, cluster, attr);
    err = cudaOccupancyMaxActiveClusters(&n, int8_gemv_sm90_kernel<2>, &cfg);
  }
  return err == cudaSuccess ? n : -1;
}
