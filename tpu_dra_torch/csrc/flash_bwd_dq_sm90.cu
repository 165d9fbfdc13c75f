// Flash-attention dQ backward for Hopper (sm_90a), bf16 at hd 64 and
// 128: q and dout [b, sq, h, hd], k/v [b, skv, kvh, hd] in their public
// layouts, lse (natural-log, the forward's) and delta [b, h, sq] f32, dq
// like q; GQA with h % kvh == 0, any sq <= skv (the query rows are the
// last sq positions: row i sees key j when j <= i + skv - sq under
// causal).
//
// Replaces tpu_dra/workloads/ops/attention.py `_flash_bwd_dq_kernel`
// (:178, pallas_call :430) on the bf16 hd 64/128 route; fp32 and the
// other head dims keep flash_bwd_dq_kernel in flash_attention.cu. Its
// rounding points are that file's: s is the fp32 dot times qk_scale
// (scale * log2 e, computed once on the host); p = exp2(s - lse log2 e);
// dS = p (dP - delta) stays fp32 until it is rounded to bf16 as the
// input of the dQ product; scale multiplies dQ once, at the end.
//
// What bounds it on an H100: at the training shape (b=2, s=2048, h=32,
// kvh=8, hd=128, causal) it does 103.1 GFLOP against 118 MB of inputs
// and outputs, so it is operations bound (0.104 ms at 989 TFLOP/s). The
// design is the forward's (flash_fwd_sm90.cu) with one more product and
// no online softmax, queries as the wgmma M dimension, so that dS comes
// out of its products in the register layout that dQ += dS.K takes as
// its A operand and nothing between the products goes through shared
// memory:
//   - a CTA of two warpgroups owns a 128-row query tile of one (head,
//     batch), 64 rows each; Q and dO are loaded once, and each thread
//     keeps its two rows' lse log2 e and delta in registers. K and V
//     tiles of 64 keys stream through a ring of three stages (160 KB in
//     all at hd 128), loaded with 16-byte cp.async into the
//     128-byte-swizzled layout of sm90.cuh. Tile t+2's copies are issued
//     before tile t's products, so one barrier a tile both publishes
//     tile t and frees tile t-1's stage. Rows past sq and keys past skv
//     are zero-filled by cp.async's source size; causal tiles past the
//     CTA's frontier are never loaded;
//   - S = Q.K^T and dP = dO.V^T are hd/16 wgmma m64n64k16 each, both
//     operands K-major in shared memory;
//   - p and dS are computed on the fp32 accumulator fragments (a thread
//     holds two rows x 16 keys); the mask is evaluated only on tiles
//     that cross the causal diagonal or a ragged edge, and a warpgroup
//     skips the products of a tile none of its rows sees (it still takes
//     part in the barrier);
//   - dQ += dS.K is 4 wgmma m64n{hd}k16 with dS packed to bf16 in
//     registers as the A operand (the accumulator fragment of S is the A
//     fragment, no shuffle) and K MN-major from the same tile that S
//     read K-major (transpose-B); dQ stays in fp32 registers and is
//     stored once, times scale, straight from the fragment;
//   - the grid is (h, b, query tiles) with the heaviest causal tiles
//     launched first and the heads of one kv group adjacent, so their
//     K/V reads hit in L2; one CTA writes each dQ row and there are no
//     atomics, so reruns give identical bits.

#include "sm90.cuh"

namespace tpu_dra {
namespace {

constexpr int kRows = 128;  // query rows per CTA, 64 per warpgroup
constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kStages = 3;  // K/V ring depth
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX module: finite
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1024-byte-aligned base: Q and dO (128 rows
// each), then the ring's stages of K and V (64 rows each), all in the
// layout of sm90.cuh (hd/64 column blocks of rows x 128 bytes).
template <int HD>
struct Layout {
  static constexpr uint32_t kQBlock = kRows * 128;  // a 64-column block
  static constexpr uint32_t kKBlock = kKeys * 128;
  static constexpr uint32_t kQTile = (HD / 64) * kQBlock;
  static constexpr uint32_t kKTile = (HD / 64) * kKBlock;
  static constexpr uint32_t kBytes = 2 * kQTile + 2 * kStages * kKTile;
  static __device__ __forceinline__ uint32_t q(uint32_t base) { return base; }
  static __device__ __forceinline__ uint32_t dout(uint32_t base) {
    return base + kQTile;
  }
  static __device__ __forceinline__ uint32_t k(uint32_t base, int s) {
    return base + 2 * kQTile + 2 * s * kKTile;
  }
  static __device__ __forceinline__ uint32_t v(uint32_t base, int s) {
    return k(base, s) + kKTile;
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int sq, int skv,
                         int h, int kvh, int causal, float qk_scale,
                         float scale) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;

  const int i0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // heaviest first
  const int head = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = head / (h / kvh);
  const int off = skv - sq;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const size_t q_base = static_cast<size_t>(bi) * sq * q_stride + head * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  const int last_row = min(i0 + kRows, sq) - 1;
  int n_tiles = (skv + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (last_row + off) / kKeys + 1);

  auto load_kv = [&](int t, int s) {
    load_tile_async<HD, kKeys, kThreads>(L::k(base, s), kb, kv_stride,
                                         t * kKeys, skv);
    load_tile_async<HD, kKeys, kThreads>(L::v(base, s), vb, kv_stride,
                                         t * kKeys, skv);
  };
  // Groups: {Q, dO, tile 0}, {tile 1}, then one a tile (empty past the
  // last), so that at tile t at most one group, tile t+1's, is pending.
  load_tile_async<HD, kRows, kThreads>(L::q(base), q + q_base, q_stride, i0,
                                       sq);
  load_tile_async<HD, kRows, kThreads>(L::dout(base), dout + q_base, q_stride,
                                       i0, sq);
  load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wg_row0 = i0 + 64 * wg;
  const int row = wg_row0 + 16 * warp + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);                  // within each 8 columns
  // This warpgroup's 64 rows of Q and dO, k-step 0.
  const uint32_t q_wg = L::q(base) + wg * 64 * 128;
  const uint32_t do_wg = L::dout(base) + wg * 64 * 128;

  // Each of this thread's rows: lse in log2 units and delta (0 past sq,
  // where Q and dO are zero and nothing is written).
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    const size_t at = (static_cast<size_t>(bi) * h + head) * sq + i;
    lse2[r] = i < sq ? lse[at] * kLog2e : 0.0f;
    dlt[r] = i < sq ? delta[at] : 0.0f;
  }

  float dq_acc[HD / 2];
#pragma unroll
  for (int c = 0; c < HD / 2; ++c) dq_acc[c] = 0.0f;

  int stage = 0;  // t % kStages
  for (int t = 0; t < n_tiles; ++t) {
    // Tile t has landed (only tile t+1's group may be pending) and every
    // warpgroup is done with tile t-1, whose stage the next copies fill.
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (t + 2 < n_tiles) {
      const int s2 = stage == 0 ? kStages - 1 : stage - 1;  // (t+2) % 3
      load_kv(t + 2, s2);
    }
    cp_async_commit();
    const uint32_t ks = L::k(base, stage);
    const uint32_t vs = L::v(base, stage);
    stage = stage + 1 == kStages ? 0 : stage + 1;
    const int j0 = t * kKeys;
    // No row of this warpgroup sees a key of the tile.
    if (wg_row0 >= sq || (causal && j0 > wg_row0 + 63 + off)) continue;

    // S = Q.K^T and dP = dO.V^T: 64 rows x 64 keys, fp32.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t qstep = (kk / 4) * L::kQBlock + (kk % 4) * 32;
      const uint32_t kstep = (kk / 4) * L::kKBlock + (kk % 4) * 32;
      wgmma_ss_m64n64k16(s, smem_desc(q_wg + qstep, 16, 1024),
                         smem_desc(ks + kstep, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t qstep = (kk / 4) * L::kQBlock + (kk % 4) * 32;
      const uint32_t kstep = (kk / 4) * L::kKBlock + (kk % 4) * 32;
      wgmma_ss_m64n64k16(dp, smem_desc(do_wg + qstep, 16, 1024),
                         smem_desc(vs + kstep, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    // p and dS on the fragments, dS packed to bf16 in order: the
    // register-A fragment of the dQ product. A tile needs the mask when
    // it reaches past skv or past the diagonal of this warpgroup's first
    // row.
    const bool masked =
        j0 + kKeys > skv || (causal && j0 + kKeys - 1 > wg_row0 + off);
    uint32_t ds[16];
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const int r = (c / 2) % 2;
      float x0 = s[c] * qk_scale;
      float x1 = s[c + 1] * qk_scale;
      if (masked) {
        const int j = j0 + 8 * (c / 4) + col;  // s[c]'s key; s[c + 1]'s j + 1
        const int i = row + 8 * r;
        if (j >= skv || (causal && j > i + off)) x0 = kNegInf;
        if (j + 1 >= skv || (causal && j + 1 > i + off)) x1 = kNegInf;
      }
      const float p0 = exp2f(x0 - lse2[r]);
      const float p1 = exp2f(x1 - lse2[r]);
      ds[c / 2] = pack_bf16(p0 * (dp[c] - dlt[r]), p1 * (dp[c + 1] - dlt[r]));
    }

    // dQ += dS.K: K's [keys, hd] tile is MN-major here; a 16-key step is
    // 2048 bytes on, the next 64 columns one 64-row block on.
    pin(dq_acc);
    pin(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2],
                             ds[4 * kk + 3]};
      wgmma_rs(dq_acc, a, smem_desc(ks + kk * 2048, L::kKBlock, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dq_acc);
  }

  // dQ x scale rounded to bf16 straight from the fragment; rows past sq
  // are not written.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= sq) continue;
    __nv_bfloat16* out = dq + q_base + static_cast<size_t>(i) * q_stride + col;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) = __floats2bfloat162_rn(
          dq_acc[4 * c + 2 * r] * scale, dq_acc[4 * c + 2 * r + 1] * scale);
  }
}

// Dynamic shared memory of a CTA: the tiles and 1 KB of slack for the
// 1024-byte alignment of their base.
template <int HD>
constexpr size_t smem_bytes() {
  return Layout<HD>::kBytes + 1024;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int b, int sq, int skv, int h, int kvh,
                   int causal, float qk_scale, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_sm90_kernel<HD>
      <<<dim3(h, b, (sq + kRows - 1) / kRows), kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<__nv_bfloat16*>(dq), sq, skv, h, kvh, causal, qk_scale,
          scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_dra

// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// type or shape it does not take). The arguments are tpu_flash_bwd_dq's
// (flash_attention.cu): tensors contiguous and 16-byte aligned in the
// layouts of the header, dtype the storage code of common.cuh (bf16
// only here), qk_scale hd^-0.5 * log2(e) and scale hd^-0.5, each rounded
// once to float.
extern "C" int tpu_flash_bwd_dq_sm90(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int dtype, int b, int sq,
                                     int skv, int h, int kvh, int hd,
                                     int causal, float qk_scale, float scale,
                                     void* stream) {
  using namespace tpu_dra;
  const bool ok = dtype == kBFloat16 && b >= 1 && b <= 65535 && sq >= 1 &&
                  sq <= skv && kvh >= 1 && h >= kvh && h % kvh == 0 &&
                  (sq + kRows - 1) / kRows <= 65535;
  if (!ok) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq, b, sq, skv, h, kvh,
                        causal, qk_scale, scale, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dq, b, sq, skv, h, kvh,
                         causal, qk_scale, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a CTA of the hd instantiation asks for, in
// bytes (0 for a head dim it does not take).
extern "C" int tpu_flash_bwd_dq_sm90_smem(int hd) {
  using namespace tpu_dra;
  switch (hd) {
    case 64: return static_cast<int>(smem_bytes<64>());
    case 128: return static_cast<int>(smem_bytes<128>());
    default: return 0;
  }
}
