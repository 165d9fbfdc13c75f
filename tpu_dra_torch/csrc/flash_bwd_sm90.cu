// Flash-attention dK/dV backward for Hopper (sm_90a), bf16 at hd 64 and
// 128: q and dout [b, sq, h, hd], k/v [b, skv, kvh, hd] in their public
// layouts, lse (natural-log, the forward's) and delta [b, h, sq] f32,
// dk/dv like k/v; GQA with h % kvh == 0, any sq <= skv (the query rows
// are the last sq positions: row i sees key j when j <= i + skv - sq
// under causal).
//
// Replaces tpu_dra/workloads/ops/attention.py `_flash_bwd_dkv_kernel`
// (:239, pallas_call :457) on the bf16 hd 64/128 route; fp32 and the
// other head dims keep flash_bwd_dkv_kernel in flash_attention.cu. Its
// rounding points are that file's: s is the fp32 dot times qk_scale
// (scale * log2 e, computed once on the host); p = exp2(s - lse log2 e)
// is rounded to bf16 only as the input of the dV product; dS = p (dP -
// delta) stays fp32 until it is rounded to bf16 as the input of the dK
// product; scale multiplies dK once, at the end.
//
// What bounds it on an H100: at the training shape (b=2, s=2048, h=32,
// kvh=8, hd=128, causal) it does 137.5 GFLOP against 102 MB of inputs
// and outputs, so it is operations bound (0.139 ms at 989 TFLOP/s). The
// design is the forward's (flash_fwd_sm90.cu) turned on its side, keys
// as the wgmma M dimension, so that P^T and dS^T come out of their
// products in the register layout the next product takes as its A
// operand and nothing between the products goes through shared memory:
//   - a CTA of two warpgroups owns a 128-key tile of one (kv head,
//     batch), 64 keys each; K and V are loaded once. 64-row Q and dO
//     tiles with their 64 lse and delta floats stream through a ring of
//     two stages, loaded with cp.async into the 128-byte-swizzled layout
//     of sm90.cuh. The ring runs over the flattened sequence of (query
//     head rep, query tile), so the next head's first tile loads while
//     this head's last tile computes; causal tiles before the CTA's
//     first visible row are never loaded. Tile t+1's copies are issued
//     before tile t's products, so one barrier a tile both publishes
//     tile t and frees tile t-1's stage. Rows past sq (with their lse and
//     delta) and keys past skv are zero-filled by cp.async's source size;
//   - S^T = K.Q^T and dP^T = V.dO^T are hd/16 wgmma m64n64k16 each, both
//     operands K-major in shared memory;
//   - p^T and dS^T are computed on the fp32 accumulator fragments (a
//     thread holds two keys x 16 query columns; each column's lse and
//     delta come from the staged floats); the mask is evaluated only on
//     tiles that cross the causal diagonal or a ragged edge, and a
//     warpgroup skips a tile none of whose rows sees its keys;
//   - dV += P^T.dO and dK += dS^T.Q are 4 wgmma m64n{hd}k16 each, with
//     P^T and dS^T packed to bf16 in registers as the A operand and dO
//     and Q MN-major from the same tiles the first two products read
//     K-major (transpose-B); dK and dV stay in fp32 registers;
//   - the grid is (kv heads, batch, key tiles) with key tile 0, which
//     sees the most query rows under causal, in the first wave; no
//     atomics, so reruns give identical bits.

#include "sm90.cuh"

namespace tpu_dra {
namespace {

constexpr int kKeys = 128;  // keys per CTA, 64 per warpgroup
constexpr int kRows = 64;   // query rows per Q/dO tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX module: finite
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1024-byte-aligned base: K, V (128 rows each),
// then the ring's stages of Q and dO (64 rows each), all in the layout
// of sm90.cuh; then each stage's 64 lse and 64 delta floats.
template <int HD>
struct Layout {
  static constexpr uint32_t kKBlock = kKeys * 128;  // a 64-column block
  static constexpr uint32_t kQBlock = kRows * 128;
  static constexpr uint32_t kKTile = (HD / 64) * kKBlock;
  static constexpr uint32_t kQTile = (HD / 64) * kQBlock;
  static constexpr uint32_t kStages = 2;
  static constexpr uint32_t kStats = 2 * kKTile + 2 * kStages * kQTile;
  static constexpr uint32_t kStatBytes = 2 * kRows * 4;  // lse, delta
  static constexpr uint32_t kBytes = kStats + kStages * kStatBytes;
  static __device__ __forceinline__ uint32_t k(uint32_t base) { return base; }
  static __device__ __forceinline__ uint32_t v(uint32_t base) {
    return base + kKTile;
  }
  static __device__ __forceinline__ uint32_t q(uint32_t base, int s) {
    return base + 2 * kKTile + 2 * s * kQTile;
  }
  static __device__ __forceinline__ uint32_t dout(uint32_t base, int s) {
    return q(base, s) + kQTile;
  }
  // lse at +0, delta at +kRows floats.
  static __device__ __forceinline__ uint32_t stats(uint32_t base, int s) {
    return base + kStats + s * kStatBytes;
  }
};

// Query tile i0 of one head into stage s: Q and dO rows, then lse and
// delta (threads 0..63 and 64..127, one float each). Rows at or past sq
// are zero.
template <int HD>
__device__ __forceinline__ void load_query_tile(
    uint32_t base, int s, const __nv_bfloat16* qb, const __nv_bfloat16* dob,
    const float* lse_row, const float* delta_row, size_t q_stride, int i0,
    int sq) {
  using L = Layout<HD>;
  load_tile_async<HD, kRows, kThreads>(L::q(base, s), qb, q_stride, i0, sq);
  load_tile_async<HD, kRows, kThreads>(L::dout(base, s), dob, q_stride, i0,
                                       sq);
  const int t = threadIdx.x;
  if (t < 2 * kRows) {
    const int r = t % kRows;
    const float* src = t < kRows ? lse_row : delta_row;
    const bool ok = i0 + r < sq;
    cp_async4(L::stats(base, s) + 4 * t, ok ? src + i0 + r : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int sq, int skv,
                          int h, int kvh, int causal, float qk_scale,
                          float scale) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* stats = reinterpret_cast<const float*>(
      smem_raw + (base - raw) + L::kStats);

  const int g = blockIdx.x;
  const int bi = blockIdx.y;
  const int j0 = blockIdx.z * kKeys;
  const int n_rep = h / kvh;
  const int off = skv - sq;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const size_t kv_base = static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  load_tile_async<HD, kKeys, kThreads>(L::k(base), k + kv_base, kv_stride, j0,
                                       skv);
  load_tile_async<HD, kKeys, kThreads>(L::v(base), v + kv_base, kv_stride, j0,
                                       skv);

  // The ring's sequence: tile t is query tile first + t % per_rep of
  // head rep t / per_rep. Rows before first * kRows see no key of this
  // CTA (causal: rows i >= j0 - off do).
  const int n_qt = (sq + kRows - 1) / kRows;
  const int first = causal ? max(0, j0 - off) / kRows : 0;
  const int per_rep = n_qt - first;
  const int n_tiles = n_rep * per_rep;
  auto load = [&](int t, int s) {
    const int head = g * n_rep + t / per_rep;
    const size_t q_base = static_cast<size_t>(bi) * sq * q_stride + head * HD;
    const size_t row = (static_cast<size_t>(bi) * h + head) * sq;
    load_query_tile<HD>(base, s, q + q_base, dout + q_base, lse + row,
                        delta + row, q_stride, (first + t % per_rep) * kRows,
                        sq);
  };
  load(0, 0);
  cp_async_commit();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wg_key0 = j0 + 64 * wg;
  const int key = wg_key0 + 16 * warp + lane / 4;  // and key + 8
  const int col = 2 * (lane % 4);                  // within each 8 columns
  // This warpgroup's 64 rows of K and V, k-step 0.
  const uint32_t k_wg = L::k(base) + wg * 64 * 128;
  const uint32_t v_wg = L::v(base) + wg * 64 * 128;

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int c = 0; c < HD / 2; ++c) dk_acc[c] = dv_acc[c] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t has landed (it is the only group in flight) and every
    // warpgroup is done with tile t-1, whose stage the next copies fill.
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) {
      load(t + 1, (t + 1) & 1);
      cp_async_commit();
    }
    const int i0 = (first + t % per_rep) * kRows;
    // No row of the tile sees a key of this warpgroup.
    if (wg_key0 >= skv || (causal && wg_key0 > i0 + kRows - 1 + off))
      continue;
    const uint32_t qs = L::q(base, t & 1);
    const uint32_t dos = L::dout(base, t & 1);

    // S^T = K.Q^T and dP^T = V.dO^T: 64 keys x 64 rows, fp32.
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t kstep = (kk / 4) * L::kKBlock + (kk % 4) * 32;
      const uint32_t qstep = (kk / 4) * L::kQBlock + (kk % 4) * 32;
      wgmma_ss_m64n64k16(st, smem_desc(k_wg + kstep, 16, 1024),
                         smem_desc(qs + qstep, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t kstep = (kk / 4) * L::kKBlock + (kk % 4) * 32;
      const uint32_t qstep = (kk / 4) * L::kQBlock + (kk % 4) * 32;
      wgmma_ss_m64n64k16(dpt, smem_desc(v_wg + kstep, 16, 1024),
                         smem_desc(dos + qstep, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(st);
    pin(dpt);

    // p^T and dS^T on the fragments, packed to bf16 in order: the
    // register-A fragments of the dV and dK products. A tile needs the
    // mask when it reaches past sq or skv or past the diagonal of its
    // first row.
    const float* lse_s = stats + (t & 1) * 2 * kRows;
    const float* delta_s = lse_s + kRows;
    const bool masked = i0 + kRows > sq || wg_key0 + 64 > skv ||
                        (causal && wg_key0 + 63 > i0 + off);
    uint32_t pt[16], dst[16];
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const int cc = 8 * (c / 4) + col;  // st[c]'s row; st[c + 1]'s is cc + 1
      const int j = key + 8 * ((c / 2) % 2);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + cc);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + cc);
      float x0 = st[c] * qk_scale;
      float x1 = st[c + 1] * qk_scale;
      if (masked) {
        const int i = i0 + cc;
        if (j >= skv || i >= sq || (causal && j > i + off)) x0 = kNegInf;
        if (j >= skv || i + 1 >= sq || (causal && j > i + 1 + off))
          x1 = kNegInf;
      }
      const float p0 = exp2f(x0 - l2.x * kLog2e);
      const float p1 = exp2f(x1 - l2.y * kLog2e);
      pt[c / 2] = pack_bf16(p0, p1);
      dst[c / 2] = pack_bf16(p0 * (dpt[c] - d2.x), p1 * (dpt[c + 1] - d2.y));
    }

    // dV += P^T.dO and dK += dS^T.Q: dO's and Q's [rows, hd] tiles are
    // MN-major here; a 16-row step is 2048 bytes on, the next 64
    // columns one 64-row block on.
    pin(dv_acc);
    pin(dk_acc);
    pin(pt);
    pin(dst);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint32_t a[4] = {pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2],
                             pt[4 * kk + 3]};
      wgmma_rs(dv_acc, a, smem_desc(dos + kk * 2048, L::kQBlock, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint32_t a[4] = {dst[4 * kk], dst[4 * kk + 1], dst[4 * kk + 2],
                             dst[4 * kk + 3]};
      wgmma_rs(dk_acc, a, smem_desc(qs + kk * 2048, L::kQBlock, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dv_acc);
    pin(dk_acc);
  }

  // dK x scale and dV rounded to bf16 straight from the fragments;
  // keys past skv are not written.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key + 8 * r;
    if (j >= skv) continue;
    const size_t at = kv_base + static_cast<size_t>(j) * kv_stride + col;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * c) =
          __floats2bfloat162_rn(dk_acc[4 * c + 2 * r] * scale,
                                dk_acc[4 * c + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * c) =
          __floats2bfloat162_rn(dv_acc[4 * c + 2 * r],
                                dv_acc[4 * c + 2 * r + 1]);
    }
  }
}

// Dynamic shared memory of a CTA: the tiles and statistics, and 1 KB of
// slack for the 1024-byte alignment of their base.
template <int HD>
constexpr size_t smem_bytes() {
  return Layout<HD>::kBytes + 1024;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int sq, int skv, int h, int kvh,
                   int causal, float qk_scale, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_sm90_kernel<HD>
      <<<dim3(kvh, b, (skv + kKeys - 1) / kKeys), kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          sq, skv, h, kvh, causal, qk_scale, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_dra

// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// type or shape it does not take). The arguments are tpu_flash_bwd_dkv's
// (flash_attention.cu): tensors contiguous and 16-byte aligned in the
// layouts of the header, dtype the storage code of common.cuh (bf16
// only here), qk_scale hd^-0.5 * log2(e) and scale hd^-0.5, each rounded
// once to float.
extern "C" int tpu_flash_bwd_dkv_sm90(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int dtype, int b,
                                      int sq, int skv, int h, int kvh, int hd,
                                      int causal, float qk_scale, float scale,
                                      void* stream) {
  using namespace tpu_dra;
  const bool ok = dtype == kBFloat16 && b >= 1 && b <= 65535 && sq >= 1 &&
                  sq <= skv && kvh >= 1 && h >= kvh && h % kvh == 0 &&
                  (skv + kKeys - 1) / kKeys <= 65535;
  if (!ok) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, h, kvh,
                        causal, qk_scale, scale, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, h,
                         kvh, causal, qk_scale, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a CTA of the hd instantiation asks for, in
// bytes (0 for a head dim it does not take).
extern "C" int tpu_flash_bwd_dkv_sm90_smem(int hd) {
  using namespace tpu_dra;
  switch (hd) {
    case 64: return static_cast<int>(smem_bytes<64>());
    case 128: return static_cast<int>(smem_bytes<128>());
    default: return 0;
  }
}
