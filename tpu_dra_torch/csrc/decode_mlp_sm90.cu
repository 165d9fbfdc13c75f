// Fused decode MLP block for Hopper (sm_90a), bf16 on the tensor cores:
//   out = x + down(silu(gate(rms(x))) * up(rms(x)))   for x [B, d], B <= 128.
//
// Replaces: tpu_dra/workloads/ops/decode_mlp.py `_decode_mlp_kernel`
// (:102, wrapper `_pallas_decode_mlp` :155, pallas_call :176) on the
// route ops/decode_mlp.py `_decode_mlp_route` calls "sm90": bf16,
// d and ffn multiples of 8, x and the weights contiguous and 16-byte
// aligned (every bf16 decode step at Llama-3-8B widths). A launch takes
// 1 <= B <= 128 rows, as the Pallas body holds the whole batch in one
// block; the wrapper runs larger batches as consecutive blocks of 128
// rows, each a full pass over the weights.
// decode_mlp.cu keeps fp32 and the other shapes.
// Numerics are the Pallas body's: xn = bf16(x32 * rsqrt(mean(x32^2) +
// eps) * scale32); gate and up summed in fp32; act = bf16(silu(g) * u)
// with silu in fp32; out = bf16(x32 + act . w_down), summed in fp32.
//
// What bounds it on an H100: bytes. Every weight byte feeds 2 B flops,
// so even at B = 128 the 3 d ffn bf16 weights (352 MB at d = 4096,
// ffn = 14336) take 0.105 ms at 3.35 TB/s against 0.046 ms of tensor
// work at the bf16 peak. The design reads every weight byte from device
// memory once for any B <= 128: rows are never tiled over CTAs, every
// CTA's products cover all the rows of its columns.
//   - two launches of one body, gate/up (w_gate and w_up side by side,
//     K = d, N = ffn) and down (w_down, K = ffn, N = d); the down
//     launch is a programmatic dependent of gate/up: the gate/up CTAs
//     let it launch once their last stage is issued, and its CTAs fill
//     their first ring stages of w_down (which gate/up does not write)
//     before `griddepcontrol.wait`, only then copying act;
//   - the weights stream through a ring of 16 KB stages: a stage is
//     `rows` k rows of the CTA's `width` (64 or 128) columns (of both
//     matrices at gate/up), stored as 64-column blocks of rows x 128
//     bytes with 16-byte chunk c of row r at c ^ (r % 8). The CTA's 8
//     warps copy each stage together (16-byte cp.async, each thread 4
//     chunks at offsets fixed for the whole walk); each slot has a
//     "full" mbarrier (every thread's copies landed:
//     cp.async.mbarrier.arrive) and an "empty" one (every thread has
//     read it), and `slots - 1` stages stay in flight with no CTA-wide
//     barrier in the loop;
//   - the products by the rows' 8-row planes, PLANES = 1, 2, 4, 8 or 16
//     for B <= 8, 16, 32, 64, 128, on the tensor cores with fp32
//     accumulators.
//     W^T is the A operand and xn^T (act^T at down) the B operand:
//       - 1 and 2 planes: mma.sync m16n8k16, W's A fragment (16 columns
//         x 16 k) straight from the stage by ldmatrix.x4.trans (the 8 x
//         8 blocks (k 0-7, 8-15) x (columns 0-7, 8-15) of a k16 step
//         are a0 .. a3), B (16 k x 8 rows a plane) by ldmatrix.x4 over
//         two planes (.x2 at one). Gate/up copies x's rows and the scale
//         over its K range as one cp.async group ahead of its first ring
//         stages, normalizes them in shared memory (the ranks of a
//         cluster add their sums of x^2 through distributed shared
//         memory) and keeps bf16 xn resident, rows padded by 16 bytes;
//         down streams act's piece of each stage (its k of every row) in
//         the slot beside w_down's rows;
//       - 4, 8 and 16 planes: wgmma m64nNk16 (N = 32 or 64 rows), each
//         warpgroup one 64-column block of W, read in place through a
//         descriptor (the MN-major stage block, transpose-A), against
//         the B operand's piece of the stage in K-major 128-byte-swizzled
//         rows. At 16 planes the CTA is one 64-column block and its two
//         warpgroups split the rows, 64 each (an m64n128 accumulator of
//         gate and up would be 128 floats a thread): each keeps the
//         8-plane accumulator, takes every k16 step of the stage, and the
//         stage's W, copied from device memory once, is read twice from
//         shared memory. Both passes stream that piece: rms_kernel writes xn
//         [B, d] first (the gate/up launch a programmatic dependent of
//         it, filling its W stages meanwhile), since xn of 17-64 rows
//         resident over a K range would force a K split over clusters,
//         two to four waves of CTAs and a reduction through distributed
//         shared memory at every CTA's end (decode_mlp_ablation.py,
//         phase wide, on an H100 80GB HBM3 at 700 W: at B = 64 those
//         cost 0.185 ms against 0.139; ldmatrix and mma.sync at 8
//         planes took 0.214 ms, bound by the per-stage fragment loads
//         and not by the bytes);
//   - the K reduction stays on chip: warp w takes the 16-column tile
//     w / warps_k (warps_n = width / 16 tiles) and every warps_k-th k16
//     step of each stage (at wgmma its warpgroup's block and share of
//     the steps; at 16 planes tile w % 4 of its warpgroup's rows, every
//     step); a thread-block cluster of up to 8 CTAs (the launch's
//     cluster attribute, picked per pass by the plan) splits K further.
//     The warps of a tile meet in shared memory (over the ring, which
//     at 8 planes of gate/up needs 64 KB for them) and the CTAs of a
//     cluster through distributed shared memory, each sum in a fixed
//     order (warps, then ranks, ascending), 4 columns a thread; every
//     rank finishes its share of the outputs: silu(g) * u at gate/up
//     (g and u of a (column, row) sit in the same registers of the same
//     thread), x + the sum at down. No fp32 partials in device memory,
//     no atomics: reruns give identical bits.
// ptxas (chip_smoke.py, phase build, prints each instantiation's
// registers, shared memory and spills): 90-97 registers at 1 and 2
// planes, 90 and 96 at 4 (down, gate/up), 112 and 144 at 8, no spill.
// The plans (width, cluster, K ranges, ring depth) come from
// ops/decode_mlp.py `mlp_sm90_plan`, from (B, d, ffn, SM count) alone.
// On a decode mesh's model shard the passes are entry points of their
// own, on either side of the gather of act: tpu_decode_mlp_sm90_gate_up
// over the shard's columns with the whole ffn's gate/up plan (so its act
// columns are the fused kernel's bit for bit), and
// tpu_decode_mlp_sm90_down with no programmatic dependence.

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace tpu_dra {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWBytes = 16384;  // a stage's weights, both matrices
constexpr int kMaxSlots = 8;
constexpr int kMaxCluster = 8;
// The most dynamic shared memory a CTA asks for: 227 KB less 1 KB for
// its static barriers and row statistics.
constexpr int kMaxSmem = 232448 - 1024;

// One pass: out [M, N] from W [K, N] (and W1 at gate/up) and the B
// operand's rows (x, normalized, at gate/up; act [M, K] at down).
struct Pass {
  const __nv_bfloat16* x;      // [M, d]: gate/up's input, down's residual
  const __nv_bfloat16* scale;  // [d], gate/up
  const __nv_bfloat16* w0;     // w_gate or w_down, [K, N]
  const __nv_bfloat16* w1;     // w_up, gate/up
  const __nv_bfloat16* b_in;   // act [M, K], down
  __nv_bfloat16* out;          // act [M, N] at gate/up, out [M, N] at down
  int M, K, N;
  int width;      // columns a CTA: 64 or 128
  int cta_steps;  // k16 steps a rank of the cluster
  int slots;      // ring depth
  float eps;
};

// k rows of a stage: 16 KB over a row of the CTA's columns (of both
// matrices at gate/up): 32 or 64 at gate/up, 64 or 128 at down.
__host__ __device__ constexpr int stage_rows(bool gate_up, int width) {
  return kWBytes / ((gate_up ? 2 : 1) * width * 2);
}
// The B operand's layout: at 1 and 2 planes (mma.sync) rows of k padded
// by 16 bytes; at 4 and 8 (wgmma) K-major 128-byte-swizzled blocks of
// 64 k, every row's 128 bytes of a block one after the other (16-byte
// chunk c of row r at c ^ (r % 8)), each block 1024-byte aligned.
__host__ __device__ constexpr bool wgmma_planes(int planes) {
  return planes >= 4;
}
// At 16 planes the two warpgroups split the rows (64 each) of one
// 64-column block instead of splitting its columns or its k16 steps.
__host__ __device__ constexpr bool row_split(int planes) {
  return planes == 16;
}
// Down streams act's piece of each stage into the stage's slot; gate/up
// keeps xn resident over its K range at mma.sync and, at wgmma, streams
// xn's piece of each stage too (xn written by rms_kernel).
__host__ __device__ constexpr bool streams_b(bool gate_up, int planes) {
  return !gate_up || wgmma_planes(planes);
}
// Bytes of a row of the B operand's piece of a stage (the stage's k
// rows): padded by 16 at mma.sync; at wgmma 128 a block of 64 k (a
// gate/up stage's 32 k fill half of one).
__host__ __device__ constexpr int piece_row_bytes(bool gate_up, int width,
                                                  bool wg) {
  return wg ? (stage_rows(gate_up, width) + 63) / 64 * 128
            : 2 * stage_rows(gate_up, width) + 16;
}
__host__ __device__ constexpr int stage_bytes(bool gate_up, int rows_pad,
                                              int width) {
  return streams_b(gate_up, rows_pad / 8)
             ? kWBytes + rows_pad * piece_row_bytes(
                                        gate_up, width,
                                        wgmma_planes(rows_pad / 8))
             : kWBytes;
}
// Stages a rank of cta_steps k16 steps walks.
__host__ __device__ constexpr int stages_of(bool gate_up, int width,
                                            int cta_steps) {
  return (cta_steps + stage_rows(gate_up, width) / 16 - 1) /
         (stage_rows(gate_up, width) / 16);
}
// Where 16-byte chunk c (8 k) of row r of a B operand of rows_pad rows
// sits, from its base: rows of row_bytes at mma.sync, swizzled K-major
// blocks at wgmma.
__host__ __device__ constexpr uint32_t b_chunk(bool wg, int rows_pad,
                                               int row_bytes, int r, int c) {
  return wg ? (c / 8) * (rows_pad * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4)
            : r * row_bytes + 16 * c;
}

// Two bf16 in a word (the first in the low half) -> two floats, exactly.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xFFFF0000u));
}

// d (+)= A . B over 16 of K on the tensor cores, m64nNk16, N = 32 or 64:
// A is 64 columns of W (its MN-major stage block, transpose-A), B the
// operand's N rows (K-major, swizzled). d holds N / 2 floats a thread,
// the sm90.cuh accumulator fragment with M the columns and N the rows.
__device__ __forceinline__ void wgmma_w_x(float (&d)[16], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_w_x(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b));
}

__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Grid (cluster, column CTAs): blockIdx.x is the CTA's rank in its
// cluster, which takes k16 steps [rank * cta_steps, + cta_steps);
// blockIdx.y the CTA's block of `width` columns.
template <int PLANES, bool GATE_UP>
__global__ void __launch_bounds__(kThreads, 1)
mlp_sm90_kernel(const Pass a) {
  constexpr int kRows = 8 * PLANES;  // x's rows, padded
  constexpr int kMats = GATE_UP ? 2 : 1;
  constexpr int kChunks = kWBytes / 16 / kThreads;  // a thread's, a stage
  constexpr int kRed = kMats * kRows * 16;  // a warp's sums
  constexpr bool kWg = wgmma_planes(PLANES);
  constexpr bool kStream = streams_b(GATE_UP, PLANES);  // else xn resident
  constexpr bool kRowSplit = row_split(PLANES);  // width 64 then
  // Planes of a warpgroup's rows, and the k16 steps a warp takes a stage
  // (a stage's rows / 16 over the warps of a tile that split K).
  constexpr int kWgPlanes = kRowSplit ? PLANES / 2 : PLANES;
  constexpr int kWarpSteps = (kRowSplit ? 8 : 4) / kMats;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxSlots];  // full, empty
  __shared__ float ssq[kStream ? 1 : kRows];  // gate/up: the rank's x^2 sums
  __shared__ float rstd[kStream ? 1 : kRows];
  // wgmma's swizzled operands want a 1024-byte-aligned base.
  const uint32_t raw_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t base = kWg ? (raw_base + 1023u) & ~1023u : raw_base;
  const uint32_t full0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  const uint32_t empty0 = full0 + 8 * kMaxSlots;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int width = a.width;
  const int warps_n = width / 16;
  const int warps_k = kWarps / warps_n;
  // The warp's 16-column tile sn and its share wk of the k16 steps. At
  // wgmma a warpgroup takes one 64-column block (width / 64 of them) and
  // every (2 / blocks)-th step; its warp w the block's tile w. At 16
  // planes wk is the warpgroup's half of the rows, and the warps of a
  // tile's sums (red_k) are one: each holds the whole K of its rows.
  const int sn = kWg ? 4 * ((warp / 4) % (width / 64)) + warp % 4
                     : warp / warps_k;
  const int wk = kWg ? (warp / 4) / (width / 64) : warp % warps_k;
  const int red_k = kRowSplit ? 1 : warps_k;
  const int rank = blockIdx.x;
  const int cluster = gridDim.x;
  const int rows = stage_rows(GATE_UP, width);
  const int cta_begin = rank * a.cta_steps;
  const int cta_end = min((a.K + 15) / 16, cta_begin + a.cta_steps);
  const int k_begin = 16 * cta_begin;
  const int k_end = min(a.K, 16 * cta_end);  // rows past it read as 0
  const int n_stages =
      cta_end > cta_begin ? stages_of(GATE_UP, width, cta_end - cta_begin)
                          : 0;
  const int col0 = blockIdx.y * width;
  const int slots = a.slots;
  const int sbytes = stage_bytes(GATE_UP, kRows, width);
  const int p_row = piece_row_bytes(GATE_UP, width, kWg);
  // Gate/up: xn's rows of the rank's stages after the ring, then the
  // scale over the same columns; kc 16-byte chunks a row.
  const int kc = n_stages * rows / 8;
  const int xs_row = 16 * kc + 16;
  const uint32_t xs = base + slots * sbytes;
  const uint32_t sc = xs + kRows * xs_row;

  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      mbar_init(full0 + 8 * i, kThreads);
      mbar_init(empty0 + 8 * i, kThreads);
    }
  }
  __syncthreads();  // the barriers are initialized

  // Thread tid copies the W chunks tid + 256 j of a stage: matrix
  // j / (kChunks / kMats), row r0 + (j % (kChunks / kMats)) r_step,
  // column chunk ch; offsets fixed, source pointers walking down W a
  // stage at a time.
  const int cpr = width / 8;  // 16-byte chunks a row of one matrix
  const int ch = threadIdx.x % cpr;
  const int r0 = threadIdx.x / cpr;
  const int r_step = kThreads / cpr;
  const bool col_ok = col0 + 8 * ch < a.N;
  const size_t w_step = static_cast<size_t>(rows) * a.N;
  uint32_t w_dst[kChunks];
  const __nv_bfloat16* w_src[kChunks];
  int w_row[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int m = j / (kChunks / kMats);
    const int r = r0 + (j % (kChunks / kMats)) * r_step;
    w_dst[j] = m * (rows * width * 2) + (ch / 8) * (rows * 128) + r * 128 +
               (((ch % 8) ^ (r % 8)) << 4);
    w_row[j] = k_begin + r;
    w_src[j] = (m ? a.w1 : a.w0) + static_cast<size_t>(k_begin + r) * a.N +
               col0 + 8 * ch;
  }
  // The B operand's piece of a stage (act at down, xn at wgmma gate/up)
  // is kRows rows of p_cpr 16-byte chunks (4, 8 or 16); thread tid
  // copies chunk tid % p_cpr of rows tid / p_cpr + j * p_r_step,
  // j < kPieces.
  constexpr int kPieces = (kRows * 16 + kThreads - 1) / kThreads;
  const int p_cpr = rows / 8;
  const int p_r_step = kThreads / p_cpr;
  const int p_r0 = threadIdx.x / p_cpr;
  const int p_c = threadIdx.x % p_cpr;
  int p_k = k_begin + 8 * p_c;
  const __nv_bfloat16* p_src = a.b_in + p_k;  // row 0

  auto issue_w = [&](uint32_t stage) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const bool ok = col_ok && w_row[j] < k_end;
      cp_async16(stage + w_dst[j], ok ? w_src[j] : a.w0, ok);
      w_src[j] += w_step;
      w_row[j] += rows;
    }
  };
  auto issue_piece = [&](uint32_t stage) {
    if (kStream) {
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int r = p_r0 + j * p_r_step;
        if (r < kRows) {
          const bool ok = r < a.M && p_k < k_end;  // K % 8 == 0: whole
          cp_async16(stage + kWBytes + b_chunk(kWg, kRows, p_row, r, p_c),
                     ok ? p_src + static_cast<size_t>(r) * a.K : a.b_in, ok);
        }
      }
    }
    p_src += rows;
    p_k += rows;
  };
  // The next stage to issue goes to slot i_slot in round i_round.
  int i_slot = 0, i_round = 0;
  auto issue = [&](int s) {
    if (s >= n_stages) return;
    if (i_round > 0) mbar_wait(empty0 + 8 * i_slot, (i_round - 1) & 1);
    const uint32_t stage = base + i_slot * sbytes;
    issue_w(stage);
    issue_piece(stage);
    mbar_arrive_on_copies(full0 + 8 * i_slot);
    if (++i_slot == slots) {
      i_slot = 0;
      ++i_round;
    }
  };
  const int ahead = min(slots - 1, n_stages);
  if constexpr (!kStream) {
    // x's rows and the scale over the rank's columns (zero past k_end
    // and past M) as one cp.async group ahead of the ring: its wait
    // covers them alone (the ring's copies are never committed).
    for (int i = threadIdx.x; i < (kRows + 1) * kc; i += kThreads) {
      const int r = i / kc;  // row kRows: the scale
      const int c = i % kc;
      const int k = k_begin + 8 * c;
      const bool ok = k < k_end && (r == kRows || r < a.M);
      const __nv_bfloat16* src =
          r == kRows ? a.scale + k : a.x + static_cast<size_t>(r) * a.K + k;
      cp_async16(r == kRows ? sc + 16 * c
                            : xs + r * xs_row + 16 * c,
                 ok ? src : a.x, ok);
    }
    cp_async_commit();
    for (int s = 0; s < ahead; ++s) issue(s);
    if (n_stages < slots) grid_dependents_launch();
  } else {
    // The first W stages do not depend on the launch before (rms_kernel
    // for gate/up, gate/up for down); the B operand does.
    for (int s = 0; s < ahead; ++s) issue_w(base + s * sbytes);
    if (GATE_UP && n_stages < slots) grid_dependents_launch();
    grid_dependency_wait();
    for (int s = 0; s < ahead; ++s) {
      issue_piece(base + s * sbytes);
      mbar_arrive_on_copies(full0 + 8 * s);
    }
    i_slot = ahead;
  }

  if constexpr (!kStream) {
    // Each row's sum of x^2 over the rank's columns (warp w: rows w,
    // w + 8, ...), the ranks' sums in rank order, rstd; then xn =
    // bf16(x32 * rstd * scale32) in place, 8 columns a thread at a time.
    cp_async_wait<0>();
    __syncthreads();  // x and the scale have landed
    for (int r = warp; r < kRows; r += kWarps) {
      float ss = 0.0f;
      for (int c = lane; c < kc; c += 32) {
        uint32_t v[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "r"(xs + r * xs_row + 16 * c)
                     : "memory");
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 f = bf16x2_to_float2(v[h]);
          ss += f.x * f.x + f.y * f.y;
        }
      }
      ss = warp_sum(ss);
      if (lane == 0) ssq[r] = ss;
    }
    cg::cluster_group cl = cg::this_cluster();
    if (cluster > 1)
      cl.sync();  // every rank's sums are visible across the cluster
    else
      __syncthreads();
    if (threadIdx.x < kRows) {
      float ss = 0.0f;
      for (int r = 0; r < cluster; ++r)
        ss += cl.map_shared_rank(ssq, r)[threadIdx.x];
      rstd[threadIdx.x] = rsqrtf(ss / a.K + a.eps);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kc; c += kThreads) {
      uint32_t sv[4];
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(sv[0]), "=r"(sv[1]), "=r"(sv[2]), "=r"(sv[3])
                   : "r"(sc + 16 * c)
                   : "memory");
      float2 sf[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) sf[h] = bf16x2_to_float2(sv[h]);
      for (int r = 0; r < a.M; ++r) {  // rows past M are zeros
        const uint32_t addr = xs + r * xs_row + 16 * c;
        uint32_t v[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "r"(addr)
                     : "memory");
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 f = bf16x2_to_float2(v[h]);
          v[h] = pack_bf16(f.x * rstd[r] * sf[h].x, f.y * rstd[r] * sf[h].y);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                     "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                     : "memory");
      }
    }
    __syncthreads();  // xn is in place
  }

  float acc[kMats][kWgPlanes][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int p = 0; p < kWgPlanes; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][p][c] = 0.0f;

  if constexpr (kWg) {
    // A warpgroup's products of a stage: for each of its k16 steps j and
    // each matrix one m64nNk16 over its 64-column block (descriptor: the
    // block's k rows x 128 bytes, 1024 bytes an 8-row group, 2048 a
    // step) against the piece's rows at the step (1024 bytes an 8-row
    // group, 32 bytes a step inside a 64-k block; at 16 planes from its
    // half's first row, 64 x 128 bytes on for the second); then every
    // thread waits for them and frees the slot.
    const uint32_t a_block = (sn / 4) * (rows * 128);
    const uint32_t b_half = kRowSplit ? wk * (64 * 128) : 0;
    int slot = 0, phase = 0;
    for (int s = 0; s < n_stages; ++s) {
      mbar_wait(full0 + 8 * slot, phase);
      __syncwarp();  // wgmma wants the warp converged
      fence_proxy_async();  // the ring's cp.async bytes, read by wgmma
      const uint32_t st = base + slot * sbytes;
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kWarpSteps; ++i) {
        const int j = kRowSplit ? i : wk + warps_k * i;  // the k16 step
        const uint64_t bd = smem_desc(
            st + kWBytes + (j / 4) * (kRows * 128) + b_half + (j % 4) * 32,
            16, 1024);
#pragma unroll
        for (int m = 0; m < kMats; ++m)
          wgmma_w_x(reinterpret_cast<float(&)[4 * kWgPlanes]>(acc[m]),
                    smem_desc(st + m * (rows * width * 2) + a_block +
                                  j * 2048,
                              rows * 128, 1024),
                    bd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(empty0 + 8 * slot);  // this thread is done with stage s
      issue(s + slots - 1);
      if (GATE_UP && s == n_stages - slots) grid_dependents_launch();
      if (++slot == slots) {
        slot = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int m = 0; m < kMats; ++m)
      pin(reinterpret_cast<float(&)[4 * kWgPlanes]>(acc[m]));
  } else {
    // ldmatrix: lane l addresses row 8 (q / 2) + l % 8 of a k16 step,
    // 16-byte chunk 2 (sn % 4) + q % 2 of 64-column block sn / 4 (q =
    // l / 8: matrix q is a_q). B (the operand's rows, k contiguous):
    // ldmatrix.x4 without transpose gives lane (g, t) b0 (k 2t, 2t + 1)
    // and b1 (k 2t + 8, 2t + 9) of row 8 p + g for planes p and p + 1:
    // lane l addresses row 8 (p + q / 2) + l % 8 at k 8 (q % 2) of a
    // step (.x2 at one plane: lanes 0-15). A row's stride is an odd
    // number of 16-byte chunks, so a phase's 8 rows hit 8 bank groups.
    const int q = lane / 8;
    const int rr = lane % 8;
    const uint32_t a_lane = (sn / 4) * (rows * 128) +
                            (rr + 8 * (q / 2)) * 128 +
                            (((2 * (sn % 4) + q % 2) ^ rr) << 4);
    const int b_row = GATE_UP ? xs_row : p_row;
    const uint32_t b_lane = (GATE_UP ? xs : kWBytes) +
                            (rr + 8 * (PLANES > 1 ? q / 2 : 0)) * b_row +
                            16 * (q % 2);
    const int b_plane = 8 * b_row;
    // The B fragments of planes p and p + 1 at a k16 step's address.
    auto load_b = [&](uint32_t addr, uint32_t (&b)[PLANES][2]) {
      if constexpr (PLANES == 1) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
            : "=r"(b[0][0]), "=r"(b[0][1])
            : "r"(addr));
      } else {
  #pragma unroll
        for (int p = 0; p < PLANES; p += 2) {
          uint32_t r[4];
          ldmatrix_x4(addr + p * b_plane, r);
          b[p][0] = r[0];
          b[p][1] = r[1];
          b[p + 1][0] = r[2];
          b[p + 1][1] = r[3];
        }
      }
    };
    int slot = 0, phase = 0;
    for (int s = 0; s < n_stages; ++s) {
      mbar_wait(full0 + 8 * slot, phase);
      const uint32_t st = base + slot * sbytes;
      uint32_t af[kMats][kWarpSteps][4];
      uint32_t bf[kWarpSteps][PLANES][2];
  #pragma unroll
      for (int i = 0; i < kWarpSteps; ++i) {
        const int j = wk + warps_k * i;  // the stage's k16 step
  #pragma unroll
        for (int m = 0; m < kMats; ++m)
          ldmatrix_x4_trans(st + m * (rows * width * 2) + j * 2048 + a_lane,
                            af[m][i]);
        if (!GATE_UP) load_b(st + b_lane + 32 * j, bf[i]);
      }
      mbar_arrive(empty0 + 8 * slot);  // this thread is done with stage s
      issue(s + slots - 1);
      if (GATE_UP && s == n_stages - slots) grid_dependents_launch();
  #pragma unroll
      for (int i = 0; i < kWarpSteps; ++i) {
        if (GATE_UP)
          load_b(b_lane + 2 * (s * rows + 16 * (wk + warps_k * i)), bf[i]);
  #pragma unroll
        for (int m = 0; m < kMats; ++m)
  #pragma unroll
          for (int p = 0; p < PLANES; ++p)
            mma_16816(acc[m][p], af[m][i], bf[i][p][0], bf[i][p][1]);
      }
      if (++slot == slots) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
  __syncthreads();  // every warp is done with the ring: it holds the sums

  // Warp w's sums at red[w][m][row][column of its tile]: lane (g, t)
  // holds columns g (c0, c1) and g + 8 (c2, c3), rows 8 p + 2 t (c0, c2)
  // and 8 p + 2 t + 1 (c1, c3) (at 16 planes of its warpgroup's half,
  // both halves of a tile in one slot).
  float* red = reinterpret_cast<float*>(smem + (base - raw_base));
  float* mine = red + (sn * red_k + (kRowSplit ? 0 : wk)) * kRed;
  const int row0 = kRowSplit ? 64 * wk : 0;
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int p = 0; p < kWgPlanes; ++p) {
      float* r = mine + (m * kRows + row0 + 8 * p + 2 * t) * 16 + g;
      r[0] = acc[m][p][0];
      r[16] = acc[m][p][1];
      r[8] = acc[m][p][2];
      r[24] = acc[m][p][3];
    }
  __syncthreads();
  // The CTA's sum of each tile, warps in order, into its first warp's
  // slot.
  if (red_k > 1) {
    for (int e = threadIdx.x; e < warps_n * kRed / 4; e += kThreads) {
      float4* p0 = reinterpret_cast<float4*>(red) +
                   (e / (kRed / 4)) * red_k * (kRed / 4) + e % (kRed / 4);
      float4 v = p0[0];
      for (int i = 1; i < red_k; ++i) {
        const float4 w = p0[i * (kRed / 4)];
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      p0[0] = v;
    }
  }
  cg::cluster_group cl = cg::this_cluster();
  if (cluster > 1)
    cl.sync();  // every rank's sums are visible across the cluster
  else
    __syncthreads();

  // Rank r finishes outputs [r * per, (r + 1) * per) of (tile, row < M,
  // 4 consecutive columns): the ranks' sums in rank order, then
  // silu(g) * u (gate/up) or x + the sum (down), rounded once. N % 8 ==
  // 0, so 4 columns are wholly inside or past N.
  const int outs = warps_n * a.M * 4;
  const int per = (outs + cluster - 1) / cluster;
  const int e_end = min(outs, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < e_end; e += kThreads) {
    const int tile = e / (a.M * 4);
    const int row = (e / 4) % a.M;
    const int c4 = 4 * (e % 4);
    const int n = col0 + 16 * tile + c4;
    if (n >= a.N) continue;
    const int off = tile * red_k * kRed + row * 16 + c4;
    float4 v[kMats];
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      v[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int r = 0; r < cluster; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(
            cl.map_shared_rank(red, r) + off + m * kRows * 16);
        v[m].x += w.x;
        v[m].y += w.y;
        v[m].z += w.z;
        v[m].w += w.w;
      }
    }
    const size_t o = static_cast<size_t>(row) * a.N + n;
    uint2 out;
    if (GATE_UP) {
      const float4 g4 = v[0], u4 = v[kMats - 1];
      out.x = pack_bf16(g4.x / (1.0f + expf(-g4.x)) * u4.x,
                        g4.y / (1.0f + expf(-g4.y)) * u4.y);
      out.y = pack_bf16(g4.z / (1.0f + expf(-g4.z)) * u4.z,
                        g4.w / (1.0f + expf(-g4.w)) * u4.w);
    } else {
      const uint2 xv = *reinterpret_cast<const uint2*>(a.x + o);
      const float2 x01 = bf16x2_to_float2(xv.x);
      const float2 x23 = bf16x2_to_float2(xv.y);
      out.x = pack_bf16(x01.x + v[0].x, x01.y + v[0].y);
      out.y = pack_bf16(x23.x + v[0].z, x23.y + v[0].w);
    }
    *reinterpret_cast<uint2*>(a.out + o) = out;
  }
  if (cluster > 1) cl.sync();  // no rank leaves while its sums are read
}

// xn [M, d] = bf16(x32 * rsqrt(mean(x32^2) + eps) * scale32), one CTA
// a row, for the wgmma gate/up pass (4, 8 and 16 planes), which streams
// it.
// The sum of x^2 in a fixed order: each thread's 8-column chunks in
// order, then the warps' butterfly, then the warps in order. Lets the
// gate/up launch start at once, so its W stages stream while xn is
// written.
__global__ void __launch_bounds__(kThreads)
rms_kernel(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ scale,
           __nv_bfloat16* __restrict__ xn, int d, float eps) {
  __shared__ float part[kWarps];
  grid_dependents_launch();
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  float ss = 0.0f;
  for (int c = threadIdx.x; c < d / 8; c += kThreads) {
    const uint4 v = xr[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = bf16x2_to_float2(w[h]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[w];
  const float rstd = rsqrtf(total / d + eps);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4* out = reinterpret_cast<uint4*>(xn + row * d);
  for (int c = threadIdx.x; c < d / 8; c += kThreads) {
    const uint4 v = xr[c];
    const uint4 sv = sr[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
    uint32_t o[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = bf16x2_to_float2(w[h]);
      const float2 sf = bf16x2_to_float2(sw[h]);
      o[h] = pack_bf16(f.x * rstd * sf.x, f.y * rstd * sf.y);
    }
    out[c] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Dynamic shared memory of a pass's CTA: the ring and, at gate/up, xn's
// rows; at least the warps' sums, which overlay them after the loop (at
// 16 planes a tile's two warps share one slot).
size_t smem_bytes(int planes, bool gate_up, int width, int cta_steps,
                  int slots) {
  const int rows_pad = 8 * planes;
  const bool wg = wgmma_planes(planes);
  size_t bytes =
      static_cast<size_t>(slots) * stage_bytes(gate_up, rows_pad, width);
  if (!streams_b(gate_up, planes)) {
    const int cols =
        stages_of(true, width, cta_steps) * stage_rows(true, width);
    bytes += static_cast<size_t>(rows_pad) * (2 * cols + 16) + 2 * cols;
  }
  const size_t sums = static_cast<size_t>(row_split(planes) ? kWarps / 2
                                                            : kWarps) *
                      (gate_up ? 2 : 1) * rows_pad * 16 * 4;
  return (bytes > sums ? bytes : sums) + (wg ? 1024 : 0);
}

// The launch configuration of a pass, less the stream: the cluster
// attribute, and with `pdl` the programmatic dependence on the launch
// before (down on gate/up in the fused block; a wgmma gate/up on
// rms_kernel; a down half launched on its own after the gather of act
// takes none).
cudaLaunchConfig_t config(const Pass& p, int planes, bool gate_up,
                          int cluster, bool pdl, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (p.N + p.width - 1) / p.width, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes =
      smem_bytes(planes, gate_up, p.width, p.cta_steps, p.slots);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  return cfg;
}

template <int PLANES, bool GATE_UP>
cudaError_t launch_pass(const Pass& p, int cluster, bool pdl,
                        cudaStream_t stream) {
  const auto kernel = mlp_sm90_kernel<PLANES, GATE_UP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(p, PLANES, GATE_UP, cluster, pdl, attr);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// 8-row planes of B rows: 1, 2, 4, 8 or 16 (B <= 128).
int planes_of(int batch) {
  return batch <= 8    ? 1
         : batch <= 16 ? 2
         : batch <= 32 ? 4
         : batch <= 64 ? 8
                       : 16;
}

// One pass at p.M's planes; `pdl` as config.
template <bool GATE_UP>
cudaError_t launch_planes(const Pass& p, int cluster, bool pdl,
                          cudaStream_t stream) {
  switch (planes_of(p.M)) {
    case 1:
      return launch_pass<1, GATE_UP>(p, cluster, pdl, stream);
    case 2:
      return launch_pass<2, GATE_UP>(p, cluster, pdl, stream);
    case 4:
      return launch_pass<4, GATE_UP>(p, cluster, pdl, stream);
    case 8:
      return launch_pass<8, GATE_UP>(p, cluster, pdl, stream);
    default:
      return launch_pass<16, GATE_UP>(p, cluster, pdl, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The gate/up pass; at 4, 8 and 16 planes first rms_kernel writing xn
// (p.b_in), and the pass a programmatic dependent of it.
cudaError_t launch_gate_up(const Pass& p, __nv_bfloat16* xn, int cluster,
                           cudaStream_t stream) {
  if (!streams_b(true, planes_of(p.M)))
    return launch_planes<true>(p, cluster, false, stream);
  rms_kernel<<<p.M, kThreads, 0, stream>>>(p.x, p.scale, xn, p.K, p.eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_planes<true>(p, cluster, true, stream);
}

// A pass's plan is one this kernel takes (at 16 planes 64 columns).
bool plan_ok(int planes, bool gate_up, int K, int N, int width,
             int cluster, int cta_steps, int slots) {
  const int steps = (K + 15) / 16;
  return (width == 64 || (width == 128 && !row_split(planes))) &&
         cluster >= 1 &&
         cluster <= kMaxCluster && cta_steps >= 1 &&
         static_cast<long long>(cluster) * cta_steps >= steps &&
         slots >= 2 && slots <= kMaxSlots &&
         (N + width - 1) / width <= 65535 &&
         smem_bytes(planes, gate_up, width, cta_steps, slots) <=
             static_cast<size_t>(kMaxSmem);
}

}  // namespace
}  // namespace tpu_dra

// x [batch, d], scale [d], w_gate / w_up [d, ffn], w_down [ffn, d], all
// bf16 and contiguous; scratch act [batch, ffn] and, at 17 <= batch
// (4, 8 and 16 planes), xn [batch, d] (rms_kernel writes it, gate/up
// streams it; null below); out [batch, d]. 1 <= batch <= 128, d % 8 ==
// 0, ffn % 8 == 0, x, scale, the weights, act, xn and out 16-byte
// aligned. The plan of each pass (gate/up: K = d, N = ffn;
// down: K = ffn, N = d): width (64 or 128 columns a CTA; 64 at 16
// planes), a cluster of
// `cluster` (1..8) CTAs along K, cta_steps k16 steps a CTA covering
// ceil(K / 16), and a ring of `slots` (2..8) stages. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a shape,
// alignment or plan it does not take).
extern "C" int tpu_decode_mlp_sm90(
    const void* x, const void* scale, const void* w_gate, const void* w_up,
    const void* w_down, void* act, void* xn, void* out, int batch, int d,
    int ffn,
    int gu_width, int gu_cluster, int gu_cta_steps, int gu_slots,
    int dn_width, int dn_cluster, int dn_cta_steps, int dn_slots, float eps,
    void* stream) {
  using namespace tpu_dra;
  if (batch == 0) return cudaSuccess;
  const int planes = planes_of(batch);
  const bool ok =
      batch > 0 && batch <= 128 && d > 0 && d % 8 == 0 && ffn > 0 &&
      ffn % 8 == 0 && aligned16(x) && aligned16(scale) && aligned16(w_gate) &&
      aligned16(w_up) && aligned16(w_down) && aligned16(act) &&
      aligned16(out) && (!streams_b(true, planes) || aligned16(xn)) &&
      plan_ok(planes, true, d, ffn, gu_width, gu_cluster, gu_cta_steps,
              gu_slots) &&
      plan_ok(planes, false, ffn, d, dn_width, dn_cluster, dn_cta_steps,
              dn_slots);
  if (!ok) return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  const T* xb = static_cast<const T*>(x);
  T* actb = static_cast<T*>(act);
  T* xnb = static_cast<T*>(xn);
  const Pass gu = {xb, static_cast<const T*>(scale),
                   static_cast<const T*>(w_gate), static_cast<const T*>(w_up),
                   xnb, actb, batch, d, ffn, gu_width, gu_cta_steps,
                   gu_slots, eps};
  const Pass dn = {xb, nullptr, static_cast<const T*>(w_down), nullptr, actb,
                   static_cast<T*>(out), batch, ffn, d, dn_width,
                   dn_cta_steps, dn_slots, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_gate_up(gu, xnb, gu_cluster, s);
  if (err != cudaSuccess) return err;
  return launch_planes<false>(dn, dn_cluster, true, s);
}

// The gate/up half on a decode mesh's model shard: act [batch, cols] =
// silu(xn . w_gate) * (xn . w_up) for the shard's columns, w_gate / w_up
// [d, cols] contiguous, scratch xn [batch, d] as tpu_decode_mlp_sm90's. The plan is gate/up's (width, cluster,
// cta_steps, slots); planned as the unsharded ffn's (the caller passes
// mlp_sm90_plan(batch, d, ffn) with ffn the whole width), every act
// element is the fused kernel's bit for bit: a column's sum depends on
// the K split and the width alone, not on how many columns there are.
// Same conditions as tpu_decode_mlp_sm90 with cols for ffn.
extern "C" int tpu_decode_mlp_sm90_gate_up(
    const void* x, const void* scale, const void* w_gate, const void* w_up,
    void* act, void* xn, int batch, int d, int cols, int width, int cluster,
    int cta_steps, int slots, float eps, void* stream) {
  using namespace tpu_dra;
  if (batch == 0) return cudaSuccess;
  const int planes = planes_of(batch);
  const bool ok =
      batch > 0 && batch <= 128 && d > 0 && d % 8 == 0 && cols > 0 &&
      cols % 8 == 0 && aligned16(x) && aligned16(scale) &&
      aligned16(w_gate) && aligned16(w_up) && aligned16(act) &&
      (!streams_b(true, planes) || aligned16(xn)) &&
      plan_ok(planes, true, d, cols, width, cluster, cta_steps, slots);
  if (!ok) return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  const Pass gu = {static_cast<const T*>(x), static_cast<const T*>(scale),
                   static_cast<const T*>(w_gate), static_cast<const T*>(w_up),
                   static_cast<T*>(xn), static_cast<T*>(act), batch, d, cols,
                   width, cta_steps, slots, eps};
  return launch_gate_up(gu, static_cast<T*>(xn), cluster,
                        static_cast<cudaStream_t>(stream));
}

// The down half: out [batch, d] = x + act . w_down over the act
// gathered from every shard, act [batch, ffn], w_down [ffn, d]. With the
// fused kernel's down plan it is that kernel's down launch, so its out
// bit for bit; it waits on the stream's earlier work as any launch does.
extern "C" int tpu_decode_mlp_sm90_down(
    const void* x, const void* act, const void* w_down, void* out,
    int batch, int d, int ffn, int width, int cluster, int cta_steps,
    int slots, void* stream) {
  using namespace tpu_dra;
  if (batch == 0) return cudaSuccess;
  const int planes = planes_of(batch);
  const bool ok =
      batch > 0 && batch <= 128 && d > 0 && d % 8 == 0 && ffn > 0 &&
      ffn % 8 == 0 && aligned16(x) && aligned16(act) && aligned16(w_down) &&
      aligned16(out) &&
      plan_ok(planes, false, ffn, d, width, cluster, cta_steps, slots);
  if (!ok) return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  const Pass dn = {static_cast<const T*>(x), nullptr,
                   static_cast<const T*>(w_down), nullptr,
                   static_cast<const T*>(act), static_cast<T*>(out), batch,
                   ffn, d, width, cta_steps, slots, 0.0f};
  return launch_planes<false>(dn, cluster, false,
                              static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` CTAs of a pass's plan the device holds
// at once (cudaOccupancyMaxActiveClusters), or -1 when the query fails
// or the plan is not one the kernel takes: what the plan's cap on
// clustered grids stands for.
extern "C" int tpu_decode_mlp_sm90_max_clusters(int planes, int gate_up,
                                                int width, int cluster,
                                                int cta_steps, int slots) {
  using namespace tpu_dra;
  if (!(planes == 1 || planes == 2 || planes == 4 || planes == 8 ||
        planes == 16) ||
      !plan_ok(planes, gate_up != 0, 16 * cta_steps * cluster, 1 << 20,
               width, cluster, cta_steps, slots))
    return -1;
  Pass p = {};
  p.N = 1 << 20;
  p.width = width;
  p.cta_steps = cta_steps;
  p.slots = slots;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      config(p, planes, gate_up != 0, cluster, true, attr);
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  const void* kernels[5][2] = {
      {reinterpret_cast<const void*>(mlp_sm90_kernel<1, false>),
       reinterpret_cast<const void*>(mlp_sm90_kernel<1, true>)},
      {reinterpret_cast<const void*>(mlp_sm90_kernel<2, false>),
       reinterpret_cast<const void*>(mlp_sm90_kernel<2, true>)},
      {reinterpret_cast<const void*>(mlp_sm90_kernel<4, false>),
       reinterpret_cast<const void*>(mlp_sm90_kernel<4, true>)},
      {reinterpret_cast<const void*>(mlp_sm90_kernel<8, false>),
       reinterpret_cast<const void*>(mlp_sm90_kernel<8, true>)},
      {reinterpret_cast<const void*>(mlp_sm90_kernel<16, false>),
       reinterpret_cast<const void*>(mlp_sm90_kernel<16, true>)}};
  const void* k = kernels[planes == 16  ? 4
                          : planes == 8 ? 3
                                        : planes / 2][gate_up != 0];
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kMaxSmem);
  err = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  return err == cudaSuccess ? n : -1;
}
