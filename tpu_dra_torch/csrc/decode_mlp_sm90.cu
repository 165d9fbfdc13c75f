// Fused decode MLP block for Hopper (sm_90a), bf16 on the tensor cores:
//   out = x + down(silu(gate(rms(x))) * up(rms(x)))   for x [B, d], B <= 16.
//
// Replaces: tpu_dra/workloads/ops/decode_mlp.py `_decode_mlp_kernel`
// (:102, wrapper `_pallas_decode_mlp` :155, pallas_call :176) on the
// route ops/decode_mlp.py `_decode_mlp_route` calls "sm90": bf16,
// 1 <= B <= 16, d and ffn multiples of 8, x and the weights contiguous
// and 16-byte aligned (every decode step at Llama-3-8B widths).
// decode_mlp.cu keeps fp32, 17 <= B <= 64 and the other shapes.
// Numerics are the Pallas body's: xn = bf16(x32 * rsqrt(mean(x32^2) +
// eps) * scale32); gate and up summed in fp32; act = bf16(silu(g) * u)
// with silu in fp32; out = bf16(x32 + act . w_down), summed in fp32.
//
// What bounds it on an H100: bytes. Every weight byte feeds 2 B flops,
// so at B = 8 the 3 d ffn bf16 weights (352 MB at d = 4096, ffn = 14336)
// take 0.105 ms at 3.35 TB/s against ~0.2 us of tensor work. The design:
//   - two launches of one body, gate/up (w_gate and w_up side by side,
//     K = d, N = ffn) and down (w_down, K = ffn, N = d); the down
//     launch is a programmatic dependent of gate/up: the gate/up CTAs
//     let it launch once their last stage is issued, and its CTAs fill
//     their first ring stages of w_down (which gate/up does not write)
//     before `griddepcontrol.wait`, only then copying act;
//   - the products run on the tensor cores, mma.sync m16n8k16 bf16 with
//     fp32 accumulators. W^T is the A operand (16 columns x 16 k) and
//     xn^T (or act^T) the B operand (16 k x 8 rows), so at B <= 8 no
//     half of the tile idles; 9 <= B <= 16 runs two products a tile,
//     one a plane of 8 rows. W's A fragment comes straight from the
//     stage by ldmatrix.x4.trans: the 8 x 8 blocks (k 0-7, 8-15) x
//     (columns 0-7, 8-15) of a k16 step are a0 .. a3, k pairs 2t, 2t+1
//     of column g, with no conversion and no shuffle;
//   - the weights stream through a ring of 16 KB stages: a stage is
//     `rows` k rows of the CTA's `width` (64 or 128) columns (of both
//     matrices at gate/up), stored as 64-column blocks of rows x 128
//     bytes with 16-byte chunk c of row r at c ^ (r % 8), so the 8 rows
//     an ldmatrix phase reads sit in 8 bank groups. The CTA's 8 warps
//     copy each stage together (16-byte cp.async, each thread 4 chunks
//     at offsets fixed for the whole walk); each slot has a "full"
//     mbarrier (every thread's copies landed: cp.async.mbarrier.arrive)
//     and an "empty" one (every thread has read it), and `slots - 1`
//     stages stay in flight with no CTA-wide barrier in the loop;
//   - the B operand: gate/up copies x's rows and the scale over its K
//     range as one cp.async group ahead of its first ring stages, then
//     normalizes in shared memory (the ranks of a cluster add their
//     sums of x^2 through distributed shared memory), bf16-rounded xn
//     resident for the whole walk; down streams act's piece of each
//     stage in the same slot as w_down's rows. Rows of both are padded
//     by 16 bytes, so a warp's B-fragment loads hit 32 distinct banks;
//   - the K reduction stays on chip: warp w takes the 16-column tile
//     w / warps_k (warps_n = width / 16 tiles) and every warps_k-th k16
//     step of each stage; a thread-block cluster of up to 8 CTAs (the
//     launch's cluster attribute, picked per pass by the plan) splits K
//     further. The warps of a tile meet in shared memory and the CTAs
//     of a cluster through distributed shared memory, each sum in a
//     fixed order (warps, then ranks, ascending); every rank finishes
//     its share of the outputs: silu(g) * u at gate/up (g and u of a
//     (column, row) sit in the same registers of the same thread), x +
//     the sum at down. No fp32 partials in device memory, no atomics:
//     reruns give identical bits.
// The plans (width, cluster, K ranges, ring depth) come from
// ops/decode_mlp.py `mlp_sm90_plan`, from (B, d, ffn, SM count) alone.

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
// Bytes of a row of act's piece of a stage (down), padded by 16.
__host__ __device__ constexpr int piece_row_bytes(int width) {
  return 2 * stage_rows(false, width) + 16;
}
__host__ __device__ constexpr int stage_bytes(bool gate_up, int rows_pad,
                                              int width) {
  return gate_up ? kWBytes : kWBytes + rows_pad * piece_row_bytes(width);
}
// Stages a rank of cta_steps k16 steps walks.
__host__ __device__ constexpr int stages_of(bool gate_up, int width,
                                            int cta_steps) {
  return (cta_steps + stage_rows(gate_up, width) / 16 - 1) /
         (stage_rows(gate_up, width) / 16);
}

// Two bf16 in a word (the first in the low half) -> two floats, exactly.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xFFFF0000u));
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
  constexpr int kWarpSteps = 4 / kMats;  // k16 steps a warp takes a stage
  constexpr int kRed = kMats * kRows * 16;  // a warp's sums
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxSlots];  // full, empty
  __shared__ float ssq[kRows];   // gate/up: the rank's sums of x^2
  __shared__ float rstd[kRows];
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
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
  const int sn = warp / warps_k;
  const int wk = warp % warps_k;
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
  const int p_row = piece_row_bytes(width);
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
  // Down: thread tid < kRows rows / 8 copies chunk tid % (rows / 8) of
  // row tid / (rows / 8) of act's piece.
  const int p_cpr = rows / 8;
  const int p_r = threadIdx.x / p_cpr;
  const bool p_mine = !GATE_UP && p_r < kRows;
  const bool p_row_ok = p_r < a.M;
  const uint32_t p_dst = kWBytes + p_r * p_row + (threadIdx.x % p_cpr) * 16;
  int p_k = k_begin + 8 * (threadIdx.x % p_cpr);
  const __nv_bfloat16* p_src =
      a.b_in + static_cast<size_t>(p_row_ok ? p_r : 0) * a.K + p_k;

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
    if (p_mine) {
      const bool ok = p_row_ok && p_k < k_end;  // K % 8 == 0: whole
      cp_async16(stage + p_dst, ok ? p_src : a.b_in, ok);
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
    if (!GATE_UP) issue_piece(stage);
    mbar_arrive_on_copies(full0 + 8 * i_slot);
    if (++i_slot == slots) {
      i_slot = 0;
      ++i_round;
    }
  };
  const int ahead = min(slots - 1, n_stages);
  if (GATE_UP) {
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
      cp_async16(r == kRows ? sc + 16 * c : xs + r * xs_row + 16 * c,
                 ok ? src : a.x, ok);
    }
    cp_async_commit();
    for (int s = 0; s < ahead; ++s) issue(s);
    if (n_stages < slots) grid_dependents_launch();
  } else {
    // w_down's first stages do not depend on the gate/up launch; act
    // does.
    for (int s = 0; s < ahead; ++s) issue_w(base + s * sbytes);
    grid_dependency_wait();
    for (int s = 0; s < ahead; ++s) {
      issue_piece(base + s * sbytes);
      mbar_arrive_on_copies(full0 + 8 * s);
    }
    i_slot = ahead;
  }

  if (GATE_UP) {
    // Each row's sum of x^2 over the rank's columns (warp w: rows w,
    // w + 8), the ranks' sums in rank order, rstd; then xn = bf16(x32 *
    // rstd * scale32) in place, 8 columns a thread at a time.
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

  float acc[kMats][PLANES][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][p][c] = 0.0f;

  // ldmatrix: lane l addresses row 8 (q / 2) + l % 8 of a k16 step,
  // 16-byte chunk 2 (sn % 4) + q % 2 of 64-column block sn / 4 (q =
  // l / 8: matrix q is a_q). B: lane (g, t) reads row 8 p + g of the
  // operand at k 2t (b0) and 2t + 8 (b1) of a step.
  const int q = lane / 8;
  const int rr = lane % 8;
  const uint32_t a_lane = (sn / 4) * (rows * 128) +
                          (rr + 8 * (q / 2)) * 128 +
                          (((2 * (sn % 4) + q % 2) ^ rr) << 4);
  const uint32_t b_lane =
      GATE_UP ? xs + g * xs_row + 4 * t : kWBytes + g * p_row + 4 * t;
  const int b_plane = 8 * (GATE_UP ? xs_row : p_row);
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
      if (!GATE_UP) {
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
          asm volatile(
              "ld.shared.u32 %0, [%2];\nld.shared.u32 %1, [%2+16];\n"
              : "=r"(bf[i][p][0]), "=r"(bf[i][p][1])
              : "r"(st + b_lane + p * b_plane + 32 * j)
              : "memory");
      }
    }
    mbar_arrive(empty0 + 8 * slot);  // this thread is done with stage s
    issue(s + slots - 1);
    if (GATE_UP && s == n_stages - slots) grid_dependents_launch();
#pragma unroll
    for (int i = 0; i < kWarpSteps; ++i) {
      if (GATE_UP) {
        const int j = wk + warps_k * i;
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
          asm volatile(
              "ld.shared.u32 %0, [%2];\nld.shared.u32 %1, [%2+16];\n"
              : "=r"(bf[i][p][0]), "=r"(bf[i][p][1])
              : "r"(b_lane + p * b_plane + 2 * (s * rows + 16 * j))
              : "memory");
      }
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
  __syncthreads();  // every warp is done with the ring: it holds the sums

  // Warp w's sums at red[w][m][row][column of its tile]: lane (g, t)
  // holds columns g (c0, c1) and g + 8 (c2, c3), rows 8 p + 2 t (c0, c2)
  // and 8 p + 2 t + 1 (c1, c3).
  float* red = reinterpret_cast<float*>(smem);
  float* mine = red + warp * kRed;
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      float* r = mine + (m * kRows + 8 * p + 2 * t) * 16 + g;
      r[0] = acc[m][p][0];
      r[16] = acc[m][p][1];
      r[8] = acc[m][p][2];
      r[24] = acc[m][p][3];
    }
  __syncthreads();
  // The CTA's sum of each tile, warps in order, into its first warp's
  // slot.
  if (warps_k > 1) {
    for (int e = threadIdx.x; e < warps_n * kRed; e += kThreads) {
      float* p0 = red + (e / kRed) * warps_k * kRed + e % kRed;
      float v = p0[0];
      for (int i = 1; i < warps_k; ++i) v += p0[i * kRed];
      p0[0] = v;
    }
  }
  cg::cluster_group cl = cg::this_cluster();
  if (cluster > 1)
    cl.sync();  // every rank's sums are visible across the cluster
  else
    __syncthreads();

  // Rank r finishes outputs [r * per, (r + 1) * per) of (tile, row < M,
  // column): the ranks' sums in rank order, then silu(g) * u (gate/up)
  // or x + the sum (down), rounded once.
  const int outs = warps_n * a.M * 16;
  const int per = (outs + cluster - 1) / cluster;
  const int e_end = min(outs, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < e_end; e += kThreads) {
    const int tile = e / (a.M * 16);
    const int row = (e / 16) % a.M;
    const int n = col0 + 16 * tile + e % 16;
    if (n >= a.N) continue;
    const int off = tile * warps_k * kRed + row * 16 + e % 16;
    float v[kMats];
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      v[m] = 0.0f;
      for (int r = 0; r < cluster; ++r)
        v[m] += cl.map_shared_rank(red, r)[off + m * kRows * 16];
    }
    const size_t o = static_cast<size_t>(row) * a.N + n;
    if (GATE_UP) {
      a.out[o] = __float2bfloat16_rn(v[0] / (1.0f + expf(-v[0])) * v[1]);
    } else {
      a.out[o] = __float2bfloat16_rn(__bfloat162float(a.x[o]) + v[0]);
    }
  }
  if (cluster > 1) cl.sync();  // no rank leaves while its sums are read
}

// Dynamic shared memory of a pass's CTA: the ring (which holds the
// warps' sums after the loop) and, at gate/up, xn's rows.
size_t smem_bytes(int planes, bool gate_up, int width, int cta_steps,
                  int slots) {
  const int rows_pad = 8 * planes;
  const size_t ring =
      static_cast<size_t>(slots) * stage_bytes(gate_up, rows_pad, width);
  if (!gate_up) return ring;
  const int cols = stages_of(true, width, cta_steps) * stage_rows(true, width);
  return ring + static_cast<size_t>(rows_pad) * (2 * cols + 16) + 2 * cols;
}

// The launch configuration of a pass, less the stream: the cluster
// attribute, and at down the programmatic dependence on gate/up.
cudaLaunchConfig_t config(const Pass& p, int planes, bool gate_up,
                          int cluster, cudaLaunchAttribute* attr) {
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
  cfg.numAttrs = gate_up ? 1 : 2;
  return cfg;
}

template <int PLANES, bool GATE_UP>
cudaError_t launch_pass(const Pass& p, int cluster, cudaStream_t stream) {
  const auto kernel = mlp_sm90_kernel<PLANES, GATE_UP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(p, PLANES, GATE_UP, cluster, attr);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int PLANES>
cudaError_t launch(const Pass& gu, int gu_cluster, const Pass& dn,
                   int dn_cluster, cudaStream_t stream) {
  cudaError_t err = launch_pass<PLANES, true>(gu, gu_cluster, stream);
  if (err != cudaSuccess) return err;
  return launch_pass<PLANES, false>(dn, dn_cluster, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A pass's plan is one this kernel takes.
bool plan_ok(int planes, bool gate_up, int K, int N, int width,
             int cluster, int cta_steps, int slots) {
  const int steps = (K + 15) / 16;
  return (width == 64 || width == 128) && cluster >= 1 &&
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
// bf16 and contiguous; scratch act [batch, ffn]; out [batch, d].
// 1 <= batch <= 16, d % 8 == 0, ffn % 8 == 0, x, scale, the weights,
// act and out 16-byte aligned. The plan of each pass (gate/up: K = d, N = ffn;
// down: K = ffn, N = d): width (64 or 128 columns a CTA), a cluster of
// `cluster` (1..8) CTAs along K, cta_steps k16 steps a CTA covering
// ceil(K / 16), and a ring of `slots` (2..8) stages. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a shape,
// alignment or plan it does not take).
extern "C" int tpu_decode_mlp_sm90(
    const void* x, const void* scale, const void* w_gate, const void* w_up,
    const void* w_down, void* act, void* out, int batch, int d, int ffn,
    int gu_width, int gu_cluster, int gu_cta_steps, int gu_slots,
    int dn_width, int dn_cluster, int dn_cta_steps, int dn_slots, float eps,
    void* stream) {
  using namespace tpu_dra;
  if (batch == 0) return cudaSuccess;
  const int planes = batch <= 8 ? 1 : 2;
  const bool ok =
      batch > 0 && batch <= 16 && d > 0 && d % 8 == 0 && ffn > 0 &&
      ffn % 8 == 0 && aligned16(x) && aligned16(scale) && aligned16(w_gate) &&
      aligned16(w_up) && aligned16(w_down) && aligned16(act) &&
      aligned16(out) &&
      plan_ok(planes, true, d, ffn, gu_width, gu_cluster, gu_cta_steps,
              gu_slots) &&
      plan_ok(planes, false, ffn, d, dn_width, dn_cluster, dn_cta_steps,
              dn_slots);
  if (!ok) return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  const T* xb = static_cast<const T*>(x);
  T* actb = static_cast<T*>(act);
  const Pass gu = {xb, static_cast<const T*>(scale),
                   static_cast<const T*>(w_gate), static_cast<const T*>(w_up),
                   nullptr, actb, batch, d, ffn, gu_width, gu_cta_steps,
                   gu_slots, eps};
  const Pass dn = {xb, nullptr, static_cast<const T*>(w_down), nullptr, actb,
                   static_cast<T*>(out), batch, ffn, d, dn_width,
                   dn_cta_steps, dn_slots, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes == 1) return launch<1>(gu, gu_cluster, dn, dn_cluster, s);
  return launch<2>(gu, gu_cluster, dn, dn_cluster, s);
}

// How many clusters of `cluster` CTAs of a pass's plan the device holds
// at once (cudaOccupancyMaxActiveClusters), or -1 when the query fails
// or the plan is not one the kernel takes: what the plan's cap on
// clustered grids stands for.
extern "C" int tpu_decode_mlp_sm90_max_clusters(int planes, int gate_up,
                                                int width, int cluster,
                                                int cta_steps, int slots) {
  using namespace tpu_dra;
  if (!(planes == 1 || planes == 2) ||
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
      config(p, planes, gate_up != 0, cluster, attr);
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  const void* kernels[2][2] = {
      {reinterpret_cast<const void*>(mlp_sm90_kernel<1, false>),
       reinterpret_cast<const void*>(mlp_sm90_kernel<1, true>)},
      {reinterpret_cast<const void*>(mlp_sm90_kernel<2, false>),
       reinterpret_cast<const void*>(mlp_sm90_kernel<2, true>)}};
  const void* k = kernels[planes - 1][gate_up != 0];
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kMaxSmem);
  err = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  return err == cudaSuccess ? n : -1;
}
