// Flash-attention forward for Hopper (sm_90a), bf16 at hd 64 and 128:
// q [b, sq, h, hd], k/v [b, skv, kvh, hd] in their public layouts, out
// like q and lse [b, h, sq] f32; GQA with h % kvh == 0, any sq <= skv
// (the query rows are the last sq positions: row i sees key j when
// j <= i + skv - sq under causal).
//
// Replaces tpu_dra/workloads/ops/attention.py `_flash_kernel` (:92,
// pallas_call :378) on the bf16 hd 64/128 route; fp32 and the other
// head dims keep flash_fwd_kernel in flash_attention.cu. Its rounding
// points are that file's: s is the fp32 dot times qk_scale (scale *
// log2 e, computed once on the host); exp2 softmax with fp32 m and l;
// p rounded to bf16 only as the input of P.V; lse = (m + log2 max(l,
// 1e-30)) ln 2.
//
// What bounds it on an H100: at the training shape (b=2, s=2048, h=32,
// kvh=8, hd=128, causal) it does 68.8 GFLOP against 84 MB of inputs and
// outputs, ~800 flops a byte, so it is operations bound (0.0695 ms at
// 989 TFLOP/s against 0.025 ms at 3.35 TB/s). The design keeps the
// tensor cores fed and everything between the two products out of
// shared memory:
//   - a CTA of two warpgroups owns a 128-row query tile (64 rows each);
//     Q is loaded once, K and V tiles of 128 keys stream through a ring
//     of two stages (160 KB at hd 128), loaded with 16-byte cp.async
//     into the 128-byte-swizzled layout that wgmma descriptors read.
//     Tile t+1's copies are issued before tile t's products, so one
//     barrier a tile both publishes tile t and frees tile t-1's stage.
//     Rows past skv (and query rows past sq) are zero-filled by
//     cp.async's source size, so a ragged edge never feeds stale bits
//     into a product;
//   - S = Q.K^T is hd/16 wgmma m64n128k16 with both operands K-major in
//     shared memory; the online softmax runs on the fp32 accumulator
//     fragment in registers (a thread holds two rows; the row max takes
//     two quad shuffles, the row sum is reduced once at the end); the
//     mask is evaluated only on tiles that reach past skv or the causal
//     diagonal;
//   - O += P.V is 8 wgmma m64n{hd}k16 with P packed to bf16 in
//     registers as the A operand (the accumulator fragment of S is the
//     A fragment, no shuffle) and V MN-major from shared memory
//     (transpose-B); O stays in fp32 registers, rescaled by each row's
//     alpha between products;
//   - the grid is (h, b, query tiles) with the heaviest causal tiles
//     launched first; no atomics, so reruns give identical bits.

#include "sm90.cuh"

namespace tpu_dra {
namespace {

constexpr int kRows = 128;  // query rows per CTA, 64 per warpgroup
constexpr int kKeys = 128;  // keys per K/V tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX module: finite
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory: Q, then the ring's stages (K, V), each a 128-row tile
// in the swizzled layout of sm90.cuh (hd/64 column blocks of 128 rows x
// 128 bytes) from a 1024-byte-aligned base.
template <int HD>
struct Layout {
  static constexpr uint32_t kBlock = kRows * 128;  // one 64-column block
  static constexpr uint32_t kTile = (HD / 64) * kBlock;
  static constexpr uint32_t kStages = 2;
  static constexpr uint32_t kBytes = kTile * (1 + 2 * kStages);
  static __device__ __forceinline__ uint32_t k(uint32_t base, int s) {
    return base + kTile * (1 + 2 * s);
  }
  static __device__ __forceinline__ uint32_t v(uint32_t base, int s) {
    return base + kTile * (2 + 2 * s);
  }
};
static_assert(kRows == kKeys, "Q, K and V tiles share one layout");

// One 128-row tile (Q, K or V) into the swizzled layout.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int row0, int rows) {
  load_tile_async<HD, kRows, kThreads>(dst, src, stride, row0, rows);
}

// The accumulator fragment of the products: sm90.cuh.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int sq, int skv, int h,
                      int kvh, int causal, float qk_scale) {
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
  const __nv_bfloat16* qb = q + static_cast<size_t>(bi) * sq * q_stride + head * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  const int last_row = min(i0 + kRows, sq) - 1;
  int n_tiles = (skv + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (last_row + off) / kKeys + 1);

  load_tile<HD>(base, qb, q_stride, i0, sq);
  load_tile<HD>(L::k(base, 0), kb, kv_stride, 0, skv);
  load_tile<HD>(L::v(base, 0), vb, kv_stride, 0, skv);
  cp_async_commit();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wg_row0 = i0 + 64 * wg;
  const int row = wg_row0 + 16 * warp + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);                  // within each 8 columns
  // This warpgroup's 64 rows of Q, k-step 0.
  const uint32_t q_wg = base + wg * 64 * 128;

  float o[HD / 2];
#pragma unroll
  for (int c = 0; c < HD / 2; ++c) o[c] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's part of each row's sum

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t has landed (it is the only group in flight) and every
    // warpgroup is done with tile t-1, whose stage the next copies fill.
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int s = (t + 1) & 1;
      load_tile<HD>(L::k(base, s), kb, kv_stride, (t + 1) * kKeys, skv);
      load_tile<HD>(L::v(base, s), vb, kv_stride, (t + 1) * kKeys, skv);
      cp_async_commit();
    }
    const uint32_t ks = L::k(base, t & 1);
    const uint32_t vs = L::v(base, t & 1);

    // S = Q.K^T: 64 rows x 128 keys, fp32.
    float s[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t step = (kk / 4) * L::kBlock + (kk % 4) * 32;
      wgmma_ss_m64n128k16(s, smem_desc(q_wg + step, 16, 1024),
                          smem_desc(ks + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // Online softmax on the fragment. A tile needs the mask when it
    // reaches past skv or past the diagonal of this warpgroup's first
    // row.
    const int j0 = t * kKeys;
    const bool masked =
        j0 + kKeys > skv || (causal && j0 + kKeys - 1 > wg_row0 + off);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < 64; ++c) {
      float x = s[c] * qk_scale;
      if (masked) {
        const int j = j0 + 8 * (c / 4) + col + (c % 2);
        const int i = row + 8 * ((c / 2) % 2);
        if (j >= skv || (causal && j > i + off)) x = kNegInf;
      }
      s[c] = x;
      mx[(c / 2) % 2] = fmaxf(mx[(c / 2) % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    uint32_t p[32];  // bf16x2: P's A fragment, k-step kk in p[4kk..4kk+3]
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 64; c += 2) {
      const int r = (c / 2) % 2;
      const float p0 = exp2f(s[c] - m[r]);
      const float p1 = exp2f(s[c + 1] - m[r]);
      sum[r] += p0;
      sum[r] += p1;
      p[c / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) o[c] *= alpha[(c / 2) % 2];

    // O += P.V: V's [keys, hd] tile is MN-major for this product; a
    // 16-key step is 2048 bytes on, the next 64 columns one block on.
    pin(o);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      wgmma_rs(o, a, smem_desc(vs + kk * 2048, L::kBlock, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = row + 8 * r;
    if (i >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* ob =
        out + (static_cast<size_t>(bi) * sq + i) * q_stride + head * HD + col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    if (lane % 4 == 0)
      lse[(static_cast<size_t>(bi) * h + head) * sq + i] =
          (m[r] + log2f(denom)) * kLn2;
  }
}

// Dynamic shared memory of a CTA: the tiles and 1 KB of slack for the
// 1024-byte alignment of their base.
template <int HD>
constexpr size_t smem_bytes() {
  return Layout<HD>::kBytes + 1024;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int b, int sq, int skv, int h, int kvh,
                   int causal, float qk_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_sm90_kernel<HD>
      <<<dim3(h, b, (sq + kRows - 1) / kRows), kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), sq, skv,
          h, kvh, causal, qk_scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_dra

// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// type or shape it does not take). The arguments are tpu_flash_fwd's
// (flash_attention.cu): q, k, v and out contiguous and 16-byte aligned
// in the layouts of the header, dtype the storage code of common.cuh
// (bf16 only here), lse f32 [b, h, sq], qk_scale hd^-0.5 * log2(e)
// rounded once to float.
extern "C" int tpu_flash_fwd_sm90(const void* q, const void* k,
                                  const void* v, void* out, void* lse,
                                  int dtype, int b, int sq, int skv, int h,
                                  int kvh, int hd, int causal, float qk_scale,
                                  void* stream) {
  using namespace tpu_dra;
  const bool ok = dtype == kBFloat16 && b >= 1 && b <= 65535 && sq >= 1 &&
                  sq <= skv && kvh >= 1 && h >= kvh && h % kvh == 0 &&
                  (sq + kRows - 1) / kRows <= 65535;
  if (!ok) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, out, lse, b, sq, skv, h, kvh, causal,
                        qk_scale, s);
    case 128:
      return launch<128>(q, k, v, out, lse, b, sq, skv, h, kvh, causal,
                         qk_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a CTA of the hd instantiation asks for, in
// bytes (0 for a head dim it does not take).
extern "C" int tpu_flash_fwd_sm90_smem(int hd) {
  using namespace tpu_dra;
  switch (hd) {
    case 64: return static_cast<int>(smem_bytes<64>());
    case 128: return static_cast<int>(smem_bytes<128>());
    default: return 0;
  }
}
