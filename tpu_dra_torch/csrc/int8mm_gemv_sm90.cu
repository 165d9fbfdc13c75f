// Weight-only int8 matmul for Hopper (sm_90a), the decode GEMV:
//   out[m, n] = bf16((sum_k f32(x[m, k]) * f32(w_q[k, n])) * scale[n])
// for bf16 x [M, K] with M <= 128 (M = the decode step's slot count),
// int8 w_q [K, N] row-major and a per-column f32 scale [N]. The wrapper
// (ops/int8mm.py `_int8mm_route`, "gemv_sm90") sends it bf16 with
// M <= 128, K % 4 == 0, N % 16 == 0, x 8-byte and w_q 16-byte aligned:
// every decode projection and lm_head at Llama-3-8B widths of an engine
// of up to 128 slots (and the spec verify pass's 40 rows). int8mm.cu's
// gemv_kernel keeps fp32 and the M <= 16 shapes this kernel does not
// take; int8mm_sm90.cu's tile, which served 17 <= M <= 128 before the
// wgmma body below, keeps M > 128.
//
// Replaces: tpu_dra/workloads/ops/int8mm.py `_kernel` (:47, wrapper
// `_pallas_int8_matmul` :68, pallas_call :76) at decode shapes. Numerics
// are the Pallas body's: the int8 weights convert exactly to bf16, the
// products are exact in fp32 and sum in fp32, the scale multiplies the
// finished sum once, one rounding.
//
// What bounds it on an H100: bytes. Every weight byte feeds 2 M flops,
// at most 256 at M = 128, where 295 (989 TFLOP/s over 3.35 TB/s) would
// make it compute-bound: at M = 8 the K N int8 bytes take 0.0176 ms at
// gate/up (4096 x 14336) against ~1 us of tensor work, at M = 64 about
// 0.018 against 7.6 us, at M = 128 0.0189 against 15.2 us (near the
// ridge: the products must overlap the copies). The design:
//   - the products run on the tensor cores with fp32 accumulators. The
//     int8 weights are converted to bf16 in registers (common.cuh: a
//     byte permute and an add a byte, a permute packs two), about 3
//     instructions a weight byte where CUDA-core FMAs took about 10; no
//     converted W touches shared memory. W^T is the A operand and x^T
//     the B operand, so the slot count is the product's small side:
//       - 1 and 2 planes of 8 rows (M <= 16): mma.sync m16n8k16, A = 16
//         columns x 16 k, B = 16 k x 8 rows of x; one mma a 256-byte
//         piece of W (two, one a plane, for 9 <= M <= 16);
//       - 4, 8 and 16 planes (17 <= M <= 128): wgmma m64nNk16, N = 32,
//         64 or 128 rows of x, A from registers (the .rs form: a warp's
//         fragment is an m16n8k16 A fragment, warp w of the warpgroup
//         rows 16 w .. 16 w + 15), B = x^T through a shared-memory
//         descriptor. mma.sync cannot go there: its accumulators would
//         take 128 or 256 registers a thread and the warps' sums 256 KB;
//         a wgmma's take N / 2 a 64-column block, and a warp carries
//         TILES = max(2, slabs a CTA) 16-column tiles a k16 step (its
//         warpgroup's blocks), at most 4 at 8 planes (128 registers) and
//         2 at 16 (128 registers: a CTA of 1 or 2 slabs). At 16 planes
//         the conversion is done once a W byte (W is the register
//         operand, so a row split between the warpgroups, as the bf16
//         decode MLP has, would convert each byte twice), one register
//         set of A fragments (a second set, as at 4 and 8 planes, fits
//         beside the 128 accumulators only at the 255-register limit
//         and was slower: int8mm_ablation.py wide128) and a ring of 4
//         stages (a stage's x piece is 32 KB at one slab);
//   - at 1 and 2 planes the contraction order is free, so x and W take
//     the same permutation of k: for lane (g = lane / 4, t = lane % 4),
//     fragment k 2t, 2t+1, 2t+8, 2t+9 of a k16 step are the physical
//     rows 4t .. 4t+3. The lane reads 16 bytes of each of those rows,
//     columns 16 g .. 16 g + 15 of its warp's 128-column slab; byte j
//     and byte 8 + j give rows g and g + 8 of the A fragment of tile j
//     (j < 8), and the B fragment of x row g is the 8 bytes
//     x[g][4t .. 4t+3]. At 4, 8 and 16 planes x's k order is the
//     descriptor's (K-major, 128-byte-swizzled blocks of 64 k), so W
//     keeps it: the lane reads 2 TILES bytes of rows 2t, 2t+1, 2t+8 and
//     2t+9, bytes b and TILES + b giving rows g and g + 8 of tile b; W
//     chunk c of row r sits at c ^ 2 ((r / 2) % 4), so a wavefront of
//     those reads (4, 8 or 16 bytes a lane) hits every bank once;
//   - the CTA's 8 warps copy each stage of W together (16-byte cp.async
//     chunks, consecutive threads on consecutive chunks of a row) and
//     every warp reads its fragments from shared memory; a ring of 4
//     stages, each slot with a "full" mbarrier (every thread's copies
//     landed: cp.async.mbarrier.arrive) and an "empty" one (every thread
//     has read it; at wgmma, once its warpgroup's products of the slot
//     have retired), keeps 3 stages (48 KB of W) in flight a CTA with no
//     CTA-wide barrier in the loop. The x pieces of a stage ride in the
//     same slot; the wgmma body's ring (5 stages, 4 at 16 planes) issues
//     its next stage while a stage's products run. (Warps that each
//     copied and read back only their own 16-byte pieces, with no
//     barrier at all, streamed W markedly slower on the H100 in
//     exploratory builds);
//   - one launch, the K split reduced on chip: a CTA's warps cover its
//     block's columns and each stage's k16 steps (at 1 and 2 planes
//     warps_n slabs x 8 / warps_n steps; at 4-16 each warp 16 TILES
//     columns, the two warpgroups splitting the columns or, at one
//     slab, the steps), and a thread-block cluster of up to 8 CTAs (the
//     launch's cluster attribute, since the plan picks its size per
//     shape) splits K further. The warps of a column meet in shared
//     memory and the CTAs of a cluster through distributed shared
//     memory, each sum in a fixed order (warps, then ranks, ascending);
//     every rank finishes its share of the columns, scales, rounds and
//     writes. No fp32 partials in device memory, no second kernel, no
//     atomics: reruns give identical bits.
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

// ---------------------------------------------------------------------
// 4, 8 and 16 planes (17 <= M <= 128): the wgmma body.

// 16-column tiles a warp carries a k16 step at 4-16 planes (its
// warpgroup's 64-column blocks): as many as the CTA's slabs, at least 2.
// A warp then covers 16 TILES columns, 2 TILES bytes of each W row a
// lane, and a warpgroup 64 TILES: at 2 slabs or more the two
// warpgroups split the columns, at 1 slab they split each stage's k16
// steps.
__host__ __device__ constexpr int wg_tiles(int warps_n) {
  return warps_n < 2 ? 2 : warps_n;
}
// The x piece of a stage at 4, 8 and 16 planes: the wgmma B operand, 8
// PLANES rows of the stage's k, K-major in 128-byte-swizzled blocks of
// 64 k (row m's 128 bytes at m * 128, 16-byte chunk c at c ^ (m % 8)),
// one block a 4 k16 steps (a stage of fewer steps fills part of one).
__host__ __device__ constexpr int wg_x_bytes(int planes, int warps_k) {
  return 8 * planes * 128 * ((warps_k + 3) / 4);
}
__host__ __device__ constexpr int wg_stage_bytes(int planes, int warps_k) {
  return kWBytes + wg_x_bytes(planes, warps_k);
}
// The wgmma body's ring depth. Stage s + ring - 1 is issued while stage
// s's products run, into the slot stage s - 1 freed, so ring - 1 stages
// are in flight behind the one being read.
constexpr int kWgStages = 5;
// At 16 planes a one-slab stage is 48 KB (16 KB of W, 32 KB of x): 4
// stages (192 KB) fit a CTA's shared memory, 5 do not.
__host__ __device__ constexpr int wg_ring(int planes) {
  return planes == 16 ? 4 : kWgStages;
}

// 4 N bytes of shared memory at addr into words v (N = 1, 2 or 4).
template <int N>
__device__ __forceinline__ void lds_words(uint32_t addr, uint32_t (&v)[N]) {
  if constexpr (N == 1) {
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v[0]) : "r"(addr)
                 : "memory");
  } else if constexpr (N == 2) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(v[0]), "=r"(v[1]) : "r"(addr) : "memory");
  } else {
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(addr) : "memory");
  }
}

// d (+)= A . B over one k16 step, m64nNk16 with N = 8 PLANES rows of x:
// A = 64 columns of W^T from registers, B = x^T through its K-major
// descriptor.
template <int PLANES>
__device__ __forceinline__ void wgmma_w_x(float (&d)[4 * PLANES],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  if constexpr (PLANES == 4)
    wgmma_rs_m64n32k16<0>(d, a, b);
  else if constexpr (PLANES == 8)
    wgmma_rs_m64n64k16<0>(d, a, b);
  else
    wgmma_rs_m64n128k16<0>(d, a, b);
}

// The same grid and plan as int8_gemv_sm90_kernel. Warp w covers the
// 16 TILES columns u = w % units of the CTA's block (units = width /
// (16 TILES): 4 or 8) in share w / units of each stage's k16 steps
// (shares = 8 / units: the warpgroups split the steps at 4 units); its
// warpgroup issues one wgmma a tile and k16 step, its 4 warps' tile b
// the block's 64 A rows.
template <int PLANES, int TILES>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemv_sm90_kernel_wgmma(const __nv_bfloat16* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const float* __restrict__ scale,
                            __nv_bfloat16* __restrict__ out, int M, int K,
                            int N, int warps_n, int cta_steps) {
  constexpr int kN = 8 * PLANES;      // x's rows, padded: the wgmma's N
  constexpr int kCw = 16 * TILES;     // a warp's columns
  constexpr int kWords = TILES / 2;   // a lane's words of a W row
  constexpr int kSteps = 8 / TILES;   // k16 steps a warp takes a stage
  constexpr int kPieces = kN / 8;     // a thread's x pieces, at most
  // A fragments' register sets: at 2 tiles a warp (32 registers a set)
  // the next stage's are built while a stage's products run, but for
  // 16 planes (128 accumulators).
  constexpr int kBufs = TILES == 2 && PLANES < 16 ? 2 : 1;
  constexpr int kRing = wg_ring(PLANES);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kRing];  // full, empty
  // The swizzled B operand wants a 1024-byte-aligned base.
  const uint32_t raw_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  const uint32_t full0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  const uint32_t empty0 = full0 + 8 * kRing;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int warps_k = kWarps / warps_n;
  const int width = warps_n * kCols;  // the CTA's block, bytes a row
  const int units = width / kCw;
  const int shares = kWarps / units;
  const int u = warp % units;
  const int wk = warp / units;
  const int rank = blockIdx.x;
  const int cluster = gridDim.x;
  const int cta_begin = rank * cta_steps;
  const int cta_end = min((K + 15) / 16, cta_begin + cta_steps);
  const int k_end = min(K, 16 * cta_end);  // rows past it read as zeros
  const int n_stages = max(0, (cta_end - cta_begin + warps_k - 1) / warps_k);
  const int cta_col0 = blockIdx.y * width;
  const int sbytes = wg_stage_bytes(PLANES, warps_k);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full0 + 8 * i, kThreads);
      mbar_init(empty0 + 8 * i, kThreads);
    }
  }
  __syncthreads();  // the barriers are initialized

  // W's rows of a stage as at 1 and 2 planes, but chunk c of row r at
  // c ^ 2 ((r / 2) % 4): the lanes of a k16 step read rows 2t, 2t + 1,
  // 2t + 8 and 2t + 9 (the fragment's own k order, which x keeps in
  // its descriptor's layout), and (r / 2) % 4 = t for all four.
  const int chunks = width / 16;
  constexpr int kCopies = kWBytes / 16 / kThreads;  // a thread's, a stage
  const int ch = threadIdx.x % chunks;
  const int r0 = threadIdx.x / chunks;
  const int r_step = kThreads / chunks;
  const bool col_ok = cta_col0 + 16 * ch < N;
  uint32_t w_off[kCopies];
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    const int r = r0 + j * r_step;
    w_off[j] = r * width + ((ch ^ (2 * ((r / 2) % 4))) << 4);
  }
  const int8_t* w_src = w + static_cast<size_t>(16 * cta_begin + r0) * N +
                        cta_col0 + 16 * ch;
  const size_t w_rows = static_cast<size_t>(r_step) * N;
  const size_t w_stage = static_cast<size_t>(16 * warps_k) * N;
  int w_row = 16 * cta_begin + r0;  // of chunk 0, this stage
  // x piece i = tid + 256 h of a stage (4 k of one row; 4 warps_k a
  // row): row i / (4 warps_k), piece p = i % (4 warps_k), in block
  // p / 16 at chunk (p % 16) / 2 of its row, half p % 2. 256 is a
  // multiple of 4 warps_k, so a thread's pieces share p (and k) and
  // step rows by x_rstep = 64 / warps_k, a multiple of 8 (the same
  // swizzle).
  const int pieces = kN * 4 * warps_k;
  const int x_rstep = 64 / warps_k;
  const int x_m0 = threadIdx.x / (4 * warps_k);
  const int x_p = threadIdx.x % (4 * warps_k);
  const uint32_t x_off0 = kWBytes + (x_p / 16) * (kN * 128) + x_m0 * 128 +
                          ((((x_p % 16) / 2) ^ (x_m0 % 8)) << 4) +
                          8 * (x_p % 2);
  int x_k = 16 * cta_begin + 4 * x_p;
  const __nv_bfloat16* x_src = x + static_cast<size_t>(x_m0) * K + x_k;
  auto issue = [&](int s) {
    if (s >= n_stages) return;
    const int slot = s % kRing;
    if (s >= kRing) mbar_wait(empty0 + 8 * slot, (s / kRing - 1) & 1);
    const uint32_t stage = base + slot * sbytes;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const bool valid = col_ok && w_row + j * r_step < k_end;
      cp_async16(stage + w_off[j], valid ? w_src + j * w_rows : w, valid);
    }
    w_src += w_stage;
    w_row += 16 * warps_k;
#pragma unroll
    for (int h = 0; h < kPieces; ++h) {
      if (threadIdx.x + h * kThreads >= pieces) break;
      const int m = x_m0 + h * x_rstep;
      const bool valid = m < M && x_k < k_end;  // whole: K % 4 == 0
      cp_async8(stage + x_off0 + h * x_rstep * 128,
                valid ? x_src + static_cast<size_t>(h * x_rstep) * K : x,
                valid);
    }
    x_src += 16 * warps_k;
    x_k += 16 * warps_k;
    mbar_arrive_on_copies(full0 + 8 * slot);
  };
  for (int s = 0; s < kRing - 1; ++s) issue(s);

  // acc[b]: the m64nN accumulator of tile b. Lane (g, t) of warp w4 in
  // its warpgroup holds rows 16 w4 + g (elements 4p, 4p + 1) and
  // 16 w4 + g + 8 (4p + 2, 4p + 3) of the product: W columns
  // 2 TILES g + b and 2 TILES g + TILES + b of the warp's, at x rows
  // 8p + 2t and 8p + 2t + 1.
  float acc[TILES][4 * PLANES];
#pragma unroll
  for (int b = 0; b < TILES; ++b)
#pragma unroll
    for (int e = 0; e < 4 * PLANES; ++e) acc[b][e] = 0.0f;

  // Lane (g, t) reads kWords words at byte 2 TILES g of the warp's
  // columns in rows 2t, 2t + 1, 2t + 8 and 2t + 9 of each of its k16
  // steps j = wk + shares i of a stage.
  const int colb = u * kCw + 2 * TILES * g;
  const uint32_t my_w = 2 * t * width + (((colb / 16) ^ (2 * t)) << 4) +
                        colb % 16;
  // Wait for stage s, read this lane's words of it and build the A
  // fragments of its steps: tile b's a0 = rows 2t, 2t+1 (k) of column
  // byte b, a1 the same of byte TILES + b (A row g + 8), a2 and a3 those
  // of rows 2t + 8, 2t + 9.
  auto load = [&](int s, uint32_t (&a)[kSteps][TILES][4]) {
    const int slot = s % kRing;
    mbar_wait(full0 + 8 * slot, (s / kRing) & 1);
    fence_proxy_async();  // the stage's cp.async bytes, read by wgmma
    const uint32_t st = base + slot * sbytes;
    uint32_t v[kSteps][4][kWords];
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        lds_words(st + my_w + (16 * (wk + shares * i) + (r % 2) +
                               8 * (r / 2)) * width,
                  v[i][r]);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kWords; ++q) v[i][r][q] ^= 0x80808080u;
#pragma unroll
      for (int b = 0; b < TILES; ++b) {
        constexpr int kHi = TILES;
        a[i][b][0] = pack_upper_halves(i8_f32_bits(v[i][0][b / 4], b % 4),
                                       i8_f32_bits(v[i][1][b / 4], b % 4));
        a[i][b][1] = pack_upper_halves(
            i8_f32_bits(v[i][0][(kHi + b) / 4], (kHi + b) % 4),
            i8_f32_bits(v[i][1][(kHi + b) / 4], (kHi + b) % 4));
        a[i][b][2] = pack_upper_halves(i8_f32_bits(v[i][2][b / 4], b % 4),
                                       i8_f32_bits(v[i][3][b / 4], b % 4));
        a[i][b][3] = pack_upper_halves(
            i8_f32_bits(v[i][2][(kHi + b) / 4], (kHi + b) % 4),
            i8_f32_bits(v[i][3][(kHi + b) / 4], (kHi + b) % 4));
      }
    }
  };
  // Stage s's products, one wgmma a step and tile, one commit group.
  auto products = [&](int s, const uint32_t (&a)[kSteps][TILES][4]) {
    const uint32_t st = base + (s % kRing) * sbytes;
    __syncwarp();  // wgmma wants the warp converged
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int j = wk + shares * i;  // the stage's k16 step
      const uint64_t bd = smem_desc(
          st + kWBytes + (j / 4) * (kN * 128) + (j % 4) * 32, 16, 1024);
#pragma unroll
      for (int b = 0; b < TILES; ++b) wgmma_w_x<PLANES>(acc[b], a[i][b], bd);
    }
    wgmma_commit();
  };
  // Stage s + kRing - 1 takes the slot that stage s - 1 freed and is
  // issued while stage s's products run: at 16 planes the products take
  // about the copies' time, and copies issued once they retired left
  // the tensor cores idle (int8mm_ablation.py wide128); at 4 and 8
  // planes the order is neutral. Every thread frees stage s once its
  // warpgroup's products of it have retired (they read its x).
  auto issue_next = [&](int s) { issue(s + kRing - 1); };
  auto release = [&](int s) { mbar_arrive(empty0 + 8 * (s % kRing)); };
  uint32_t a[kBufs][kSteps][TILES][4];
  if constexpr (kBufs == 1) {
    for (int s = 0; s < n_stages; ++s) {
      load(s, a[0]);
      products(s, a[0]);
      issue_next(s);
      wgmma_wait<0>();
      release(s);
    }
  } else {
    // Stage s + 1's words are read and converted into the other
    // register set while stage s's products run.
    if (n_stages > 0) load(0, a[0]);
    for (int s = 0; s < n_stages; s += 2) {
      products(s, a[0]);
      issue_next(s);
      if (s + 1 < n_stages) load(s + 1, a[1]);
      wgmma_wait<0>();
      release(s);
      if (s + 1 < n_stages) {
        products(s + 1, a[1]);
        issue_next(s + 1);
        if (s + 2 < n_stages) load(s + 2, a[0]);
        wgmma_wait<0>();
        release(s + 1);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < TILES; ++b) pin(acc[b]);
  __syncthreads();  // every warp is done with the ring: it holds the sums

  // Warp w's sums at red[w][row][column of its kCw]: lane (g, t) holds
  // rows 8p + 2t + h, columns 2 TILES g + y (y < 2 TILES), y < TILES
  // in element 4p + h of tile y and the rest in element 4p + 2 + h of
  // tile y - TILES; float4 c of a row is columns 4c .. 4c + 3.
  float* red = reinterpret_cast<float*>(smem + (base - raw_base));
  float* mine = red + warp * kN * kCw;
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = mine + (8 * p + 2 * t + h) * kCw + 2 * TILES * g;
#pragma unroll
      for (int c = 0; c < TILES / 2; ++c) {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = 4 * c + e;
          f[e] = acc[y % TILES][4 * p + 2 * (y / TILES) + h];
        }
        *reinterpret_cast<float4*>(row + 4 * c) =
            make_float4(f[0], f[1], f[2], f[3]);
      }
    }
  __syncthreads();

  // The shares of each unit, in order, into share 0's slot (warps
  // 0 .. units - 1, one after the other): float4 group e is unit
  // e / (kN kCw / 4), row (e / (kCw / 4)) % kN, columns 4 (e % (kCw / 4)).
  const int groups = units * kN * kCw / 4;
  if (shares > 1) {
    for (int e = threadIdx.x; e < groups; e += kThreads) {
      if ((e / (kCw / 4)) % kN >= M) continue;
      float4* p0 = reinterpret_cast<float4*>(red) + e;
      float4 v = *p0;
      for (int i = 1; i < shares; ++i) {
        const float4 o = p0[i * groups];
        v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
      }
      *p0 = v;
    }
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
    const int m = (e / (kCw / 4)) % kN;
    const int n = cta_col0 + (e / (kN * kCw / 4)) * kCw + 4 * (e % (kCw / 4));
    if (m >= M || n >= N) continue;
    float4 v = reinterpret_cast<float4*>(cl.map_shared_rank(red, 0))[e];
    for (int r = 1; r < cluster; ++r) {
      const float4 o =
          reinterpret_cast<float4*>(cl.map_shared_rank(red, r))[e];
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
// after the loop (at 4, 8 and 16 planes with 1 KB to align its base).
size_t smem_bytes(int planes, int warps_n) {
  const int warps_k = kWarps / warps_n;
  if (planes >= 4) {
    const size_t ring =
        static_cast<size_t>(wg_ring(planes)) *
        wg_stage_bytes(planes, warps_k);
    const size_t red =
        static_cast<size_t>(kWarps) * 8 * planes * 16 * wg_tiles(warps_n) * 4;
    return 1024 + (ring > red ? ring : red);
  }
  const size_t ring =
      static_cast<size_t>(kStages) * stage_bytes(planes, warps_k);
  const size_t red = static_cast<size_t>(kWarps) * 8 * planes * kCols * 4;
  return ring > red ? ring : red;
}

// The launch configuration of a plan, less the stream.
cudaLaunchConfig_t config(int planes, int N, int warps_n, int cluster,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int slabs = (N + kCols - 1) / kCols;
  cfg.gridDim = dim3(cluster, (slabs + warps_n - 1) / warps_n, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(planes, warps_n);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

using Kernel = void (*)(const __nv_bfloat16*, const int8_t*, const float*,
                        __nv_bfloat16*, int, int, int, int, int);

// The kernel of (planes, warps_n): the mma.sync body at 1 and 2 planes,
// the wgmma body at 4 (any slabs), 8 (at most 4 slabs) and 16 (at most
// 2); null for anything else.
Kernel kernel_of(int planes, int warps_n) {
  const int tiles = wg_tiles(warps_n);
  switch (planes) {
    case 1: return int8_gemv_sm90_kernel<1>;
    case 2: return int8_gemv_sm90_kernel<2>;
    case 4:
      return tiles == 2 ? int8_gemv_sm90_kernel_wgmma<4, 2>
             : tiles == 4 ? int8_gemv_sm90_kernel_wgmma<4, 4>
                          : int8_gemv_sm90_kernel_wgmma<4, 8>;
    case 8:
      return tiles == 2 ? int8_gemv_sm90_kernel_wgmma<8, 2>
             : tiles == 4 ? int8_gemv_sm90_kernel_wgmma<8, 4>
                          : nullptr;
    case 16:
      return tiles == 2 ? int8_gemv_sm90_kernel_wgmma<16, 2> : nullptr;
    default: return nullptr;
  }
}

cudaError_t launch(Kernel kernel, int planes, const void* x, const void* w_q,
                   const void* scale, void* out, int M, int K, int N,
                   int warps_n, int cluster, int cta_steps,
                   cudaStream_t stream) {
  if ((N + kCols - 1) / kCols > 65535 * warps_n) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(planes, N, warps_n, cluster, attr);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(w_q), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, K, N, warps_n, cta_steps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_dra

// x [M, K] bf16, w_q [K, N] int8, scale [N] f32, out [M, N] bf16, all
// contiguous; 1 <= M <= 128, K % 4 == 0, N % 16 == 0, x 8-byte and w_q
// 16-byte aligned. The plan: warps_n (1, 2, 4 or 8; at most 4 for
// 33 <= M <= 64, at most 2 for 65 <= M <= 128) slabs a CTA, a cluster
// of `cluster` (1..8) CTAs along K and cta_steps k16 steps a CTA,
// covering ceil(K / 16) steps. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape, alignment or plan it does not
// take).
extern "C" int tpu_int8_gemv_sm90(const void* x, const void* w_q,
                                  const void* scale, void* out, int M, int K,
                                  int N, int warps_n, int cluster,
                                  int cta_steps, void* stream) {
  using namespace tpu_dra;
  if (M == 0 || N == 0) return cudaSuccess;
  const int steps = (K + 15) / 16;
  const int planes =
      M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : M <= 64 ? 8 : 16;
  const bool ok =
      M > 0 && M <= 128 && K > 0 && K % 4 == 0 && N > 0 && N % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(w_q) % 16 == 0 &&
      (warps_n == 1 || warps_n == 2 || warps_n == 4 || warps_n == 8) &&
      cluster >= 1 && cluster <= kMaxCluster && cta_steps >= 1 &&
      static_cast<long long>(cluster) * cta_steps >= steps &&
      kernel_of(planes, warps_n) != nullptr &&
      smem_bytes(planes, warps_n) <= static_cast<size_t>(kMaxSmem);
  if (!ok) return cudaErrorInvalidValue;
  return launch(kernel_of(planes, warps_n), planes, x, w_q, scale, out, M, K,
                N, warps_n, cluster, cta_steps,
                static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` CTAs of the plan (planes, warps_n) the
// device holds at once (cudaOccupancyMaxActiveClusters), or -1 when the
// query fails or the plan is not one the kernel takes: what the plan's
// cap on clustered grids stands for.
extern "C" int tpu_int8_gemv_sm90_max_clusters(int planes, int warps_n,
                                               int cluster) {
  using namespace tpu_dra;
  const Kernel kernel = kernel_of(planes, warps_n);
  if (kernel == nullptr) return -1;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kMaxSmem);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(planes, 1 << 20, warps_n, cluster,
                                        attr);
  int n = -1;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -1;
}
