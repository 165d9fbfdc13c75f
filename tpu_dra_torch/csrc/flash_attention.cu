// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels
// of the training path, for q [b, sq, h, hd] and k/v [b, skv, kvh, hd]
// in their public layouts (no grouped or repeated copies), lse and
// delta [b, h, sq] f32, GQA with h % kvh == 0, any sq <= skv (the query
// rows are the last sq positions: row i sees key j when j <= i + skv - sq
// under causal), hd a multiple of 16 up to 128.
//
// Replaces tpu_dra/workloads/ops/attention.py:
//   flash_fwd_kernel     <- `_flash_kernel`         (:92,  pallas_call :378)
//   flash_bwd_dq_kernel  <- `_flash_bwd_dq_kernel`  (:178, pallas_call :430)
//   flash_bwd_dkv_kernel <- `_flash_bwd_dkv_kernel` (:239, pallas_call :457)
// Their rounding points are the Pallas bodies': s is the fp32 sum of the
// products times (scale * log2 e), one float the host computes in double;
// softmax runs in the exp2 domain with fp32 statistics; p is rounded to
// T only as the input of P.V (forward) and P^T.dO (dV); dS = p (dP - delta)
// stays fp32 until it is rounded to T as the input of dS.K and dS^T.Q;
// scale multiplies dQ and dK once, at the end; the forward's lse is
// natural-log, (m + log2 max(l, 1e-30)) ln 2.
//
// What bounds them on an H100: at the training shapes (b=2, s=2048,
// h=32, kvh=8, hd=128) each is operations bound: the forward does
// 4 b h s^2 hd / 2 flops (causal) against ~84 MB of inputs and outputs,
// dQ 6 and dK/dV 8 of those units, all at several hundred flops a byte.
// So every product runs on the tensor cores (bf16 in, fp32 sums); fp32
// inputs take a CUDA-core FMA path instead, so that fp32 keeps its bits
// (TF32 would not).
//
// The forward, dQ and dK/dV for bf16 at hd 64 and 128 (the training
// shapes) live in flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu and
// flash_bwd_sm90.cu (wgmma products, a cp.async ring, the elementwise
// passes in registers); the three kernels here serve fp32 and the other
// head dims.
//
// Design. The Pallas kernels pin one KV head's whole K/V plane in VMEM
// and walk it in blocks. Here a CTA of 4 warps owns one 64-row tile:
//   - forward and dQ: one (query tile, head, batch). K/V stream through
//     shared memory 64 keys at a time (16 KB a tile at hd 128 bf16);
//     causal tiles past the frontier are never loaded, and the mask is
//     evaluated on the diagonal and ragged tiles only.
//   - dK/dV: one (key tile, kv head, batch). It keeps its K/V tile in
//     shared memory and walks all n_rep query heads' tiles from the
//     causal frontier, dK and dV in fp32 registers, written once. No
//     atomics, so a rerun gives identical bits.
// Each product is one warp-level pass over the CTA's tile (WMMA
// 16x16x16 bf16, fp32 accumulators; warp w owns rows 16w..16w+15) with
// the result in shared memory, where the elementwise softmax pass reads
// it: thread t owns half a row (row t/2, 32 columns), so the row max
// and sum take one shuffle. Large query-tile indices (the heaviest
// causal tiles) launch first. No cp.async/TMA pipeline and no wgmma yet:
// loads and products alternate, which is the first thing to change.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace tpu_dra {
namespace {

constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX module: finite
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row stride, in elements, of a staged tile of T with `cols` columns:
// 16 bytes of padding stagger the banks and keep every 16-row block
// 32-byte aligned, as WMMA's loads and stores need.
template <typename T>
constexpr int ld_of(int cols) {
  return cols + 16 / static_cast<int>(sizeof(T));
}
constexpr int ld_f32(int cols) { return cols + 4; }

// A warp's share of a 64 x N fp32 product held across calls: rows
// 16w..16w+15. mma() adds A[rows, 0:K] . B[0:K, 0:N] with A(m, k) at
// a[m * lda + k] (A_ROW) or a[k * lda + m], and B(k, n) at b[k * ldb + n]
// (B_ROW) or b[n * ldb + k]; store() writes the rows to fp32 shared
// memory. Callers synchronise around it.
template <typename T, int N>
struct Acc;

template <int N>
struct Acc<__nv_bfloat16, N> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      f[N / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < N / 16; ++j) nvcuda::wmma::fill_fragment(f[j], 0.0f);
  }

  template <bool A_ROW, bool B_ROW, int K>
  __device__ __forceinline__ void mma(const __nv_bfloat16* a, int lda,
                                      const __nv_bfloat16* b, int ldb) {
    namespace wmma = nvcuda::wmma;
    using ALayout =
        typename std::conditional<A_ROW, wmma::row_major, wmma::col_major>::type;
    using BLayout =
        typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
    const int m0 = 16 * (threadIdx.x / 32);
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa;
      wmma::load_matrix_sync(fa, A_ROW ? a + m0 * lda + k : a + k * lda + m0,
                             lda);
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb;
        wmma::load_matrix_sync(
            fb, B_ROW ? b + k * ldb + 16 * j : b + (16 * j) * ldb + k, ldb);
        wmma::mma_sync(f[j], fa, fb, f[j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* c, int ldc) {
    const int m0 = 16 * (threadIdx.x / 32);
#pragma unroll
    for (int j = 0; j < N / 16; ++j)
      nvcuda::wmma::store_matrix_sync(c + m0 * ldc + 16 * j, f[j], ldc,
                                      nvcuda::wmma::mem_row_major);
  }
};

// fp32: the same contract on CUDA cores. Lane l of warp w owns row
// 16w + l/2 and the half (l % 2) of its N columns.
template <int N>
struct Acc<float, N> {
  float v[N / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < N / 2; ++c) v[c] = 0.0f;
  }

  template <bool A_ROW, bool B_ROW, int K>
  __device__ __forceinline__ void mma(const float* a, int lda, const float* b,
                                      int ldb) {
    const int lane = threadIdx.x % 32;
    const int r = 16 * (threadIdx.x / 32) + lane / 2;
    const int c0 = (lane % 2) * (N / 2);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x = A_ROW ? a[r * lda + k] : a[k * lda + r];
#pragma unroll
      for (int c = 0; c < N / 2; ++c)
        v[c] += x * (B_ROW ? b[k * ldb + c0 + c] : b[(c0 + c) * ldb + k]);
    }
  }

  __device__ __forceinline__ void store(float* c, int ldc) {
    const int lane = threadIdx.x % 32;
    const int r = 16 * (threadIdx.x / 32) + lane / 2;
    const int c0 = (lane % 2) * (N / 2);
#pragma unroll
    for (int cc = 0; cc < N / 2; ++cc) c[r * ldc + c0 + cc] = v[cc];
  }
};

// Rows [row0, row0 + 64) of a row-major matrix whose row r starts at
// src + r * stride (HD elements of T each) into dst (row stride ld),
// as 16-byte words; rows at or past `rows` are zero, so a ragged edge
// never feeds stale bits (0 * NaN) into a product.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, int ld,
                                          const T* __restrict__ src,
                                          size_t stride, int row0, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      word = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = word;
  }
}

// 64 x HD fp32 rows staged in shared memory (row stride ld) -> T rows of
// a [rows, stride] output, times `mul`, skipping rows at or past `rows`.
template <typename T, int HD>
__device__ __forceinline__ void write_tile(T* __restrict__ dst, size_t stride,
                                           const float* src, int ld, int row0,
                                           int rows, float mul) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i % HD;
    if (row0 + r < rows)
      dst[static_cast<size_t>(row0 + r) * stride + c] =
          from_f32<T>(src[r * ld + c] * mul);
  }
}

// Shared memory of each kernel, in bytes. The fp32 staging region holds
// two 64 x 64 score tiles (S and dP) or one 64 x HD output tile.
template <typename T, int HD>
struct Smem {
  static constexpr int kLd = ld_of<T>(HD);     // Q, K, V, dO tiles
  static constexpr int kLdP = ld_of<T>(kTile);  // P / dS tiles of T
  static constexpr int kLdS = ld_f32(kTile);    // S, dP (fp32)
  static constexpr int kLdO = ld_f32(HD);       // PV, dQ, dK, dV (fp32)
  static constexpr size_t kTileBytes = size_t(kTile) * kLd * sizeof(T);
  static constexpr size_t kPBytes = size_t(kTile) * kLdP * sizeof(T);
  static constexpr size_t kSBytes = size_t(kTile) * kLdS * 4;
  static constexpr size_t kOBytes = size_t(kTile) * kLdO * 4;
  static constexpr size_t kStage =
      2 * kSBytes > kOBytes ? 2 * kSBytes : kOBytes;
  // forward: Q, K, V, P, then S and PV in one region
  static constexpr size_t kFwd =
      3 * kTileBytes + kPBytes + (kSBytes > kOBytes ? kSBytes : kOBytes);
  // dQ and dK/dV: four tiles, then S | dP (dS and P^T written over them)
  static constexpr size_t kBwd = 4 * kTileBytes + kStage;
  static_assert(kPBytes <= kSBytes, "a T tile of P must fit over S");
};

// --- forward -----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int skv, int h, int kvh,
                 int causal, float qk_scale) {
  using S = Smem<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + S::kTileBytes);
  T* vs = reinterpret_cast<T*>(smem + 2 * S::kTileBytes);
  T* ps = reinterpret_cast<T*>(smem + 3 * S::kTileBytes);
  float* ss = reinterpret_cast<float*>(smem + 3 * S::kTileBytes + S::kPBytes);
  float* pv = ss;  // S is dead once P is written

  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heaviest first
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = head / (h / kvh);
  const int off = skv - sq;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const T* qb = q + static_cast<size_t>(bi) * sq * q_stride + head * HD;
  const T* kb = k + static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  const T* vb = v + static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  load_tile<T, HD>(qs, S::kLd, qb, q_stride, i0, sq);

  const int r = threadIdx.x / 2;  // the row this thread's softmax owns
  const int half = threadIdx.x % 2;
  const int i = i0 + r;
  const int last_row = min(i0 + kTile, sq) - 1;
  int n_tiles = (skv + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (last_row + off) / kTile + 1);

  float m = kNegInf, l = 0.0f;
  float o[HD / 2];
#pragma unroll
  for (int c = 0; c < HD / 2; ++c) o[c] = 0.0f;
  Acc<T, kTile> s_acc;
  Acc<T, HD> pv_acc;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    load_tile<T, HD>(ks, S::kLd, kb, kv_stride, j0, skv);
    load_tile<T, HD>(vs, S::kLd, vb, kv_stride, j0, skv);
    __syncthreads();
    s_acc.zero();
    s_acc.template mma<true, false, HD>(qs, S::kLd, ks, S::kLd);
    s_acc.store(ss, S::kLdS);
    __syncthreads();

    // A tile needs the mask when it reaches past skv or past the
    // diagonal of its first row.
    const bool masked =
        j0 + kTile > skv || (causal && j0 + kTile - 1 > i0 + off);
    float sv[kTile / 2];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kTile / 2; ++c) {
      const int col = half * (kTile / 2) + c;
      const int j = j0 + col;
      float s = ss[r * S::kLdS + col] * qk_scale;
      if (masked && (j >= skv || (causal && j > i + off))) s = kNegInf;
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kTile / 2; ++c) {
      const float p = exp2f(sv[c] - m_new);
      sum += p;
      ps[r * S::kLdP + half * (kTile / 2) + c] = from_f32<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = exp2f(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    __syncthreads();

    pv_acc.zero();
    pv_acc.template mma<true, true, kTile>(ps, S::kLdP, vs, S::kLd);
    pv_acc.store(pv, S::kLdO);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < HD / 2; ++c)
      o[c] = o[c] * alpha + pv[r * S::kLdO + half * (HD / 2) + c];
    __syncthreads();
  }

  if (i < sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = out + (static_cast<size_t>(bi) * sq + i) * q_stride + head * HD +
            half * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) ob[c] = from_f32<T>(o[c] / denom);
    if (half == 0)
      lse[(static_cast<size_t>(bi) * h + head) * sq + i] =
          (m + log2f(denom)) * kLn2;
  }
}

// --- backward: the dS tile of one (query tile, key tile) pair ----------------

// From S = Q.K^T and dP = dO.V^T in fp32 shared memory, this thread's
// half row of p = exp2(s * qk_scale - lse2) and dS = p (dP - delta).
// Masked entries (past skv, past the causal diagonal, query rows past
// sq) get p = 0.
template <typename T, int HD>
__device__ __forceinline__ void p_and_ds(const float* ss, const float* dps,
                                         int r, int half, int i, int j0,
                                         int sq, int skv, int off, int causal,
                                         float qk_scale, float lse2,
                                         float dlt, float* p, float* ds) {
  using S = Smem<T, HD>;
#pragma unroll
  for (int c = 0; c < kTile / 2; ++c) {
    const int col = half * (kTile / 2) + c;
    const int j = j0 + col;
    float s = ss[r * S::kLdS + col] * qk_scale;
    if (i >= sq || j >= skv || (causal && j > i + off)) s = kNegInf;
    p[c] = exp2f(s - lse2);
    ds[c] = p[c] * (dps[r * S::kLdS + col] - dlt);
  }
}

// --- dQ --------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int skv, int h, int kvh, int causal,
                    float qk_scale, float scale) {
  using S = Smem<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + S::kTileBytes);
  T* ks = reinterpret_cast<T*>(smem + 2 * S::kTileBytes);
  T* vs = reinterpret_cast<T*>(smem + 3 * S::kTileBytes);
  float* ss = reinterpret_cast<float*>(smem + 4 * S::kTileBytes);
  float* dps = ss + kTile * S::kLdS;
  T* dss = reinterpret_cast<T*>(ss);  // dS written over S
  float* stage = ss;                  // dQ, after the loop

  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = head / (h / kvh);
  const int off = skv - sq;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const size_t q_base = static_cast<size_t>(bi) * sq * q_stride + head * HD;
  const T* kb = k + static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  const T* vb = v + static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  load_tile<T, HD>(qs, S::kLd, q + q_base, q_stride, i0, sq);
  load_tile<T, HD>(dos, S::kLd, dout + q_base, q_stride, i0, sq);

  const int r = threadIdx.x / 2;
  const int half = threadIdx.x % 2;
  const int i = i0 + r;
  const size_t row = (static_cast<size_t>(bi) * h + head) * sq + i;
  const float lse2 = i < sq ? lse[row] * kLog2e : 0.0f;
  const float dlt = i < sq ? delta[row] : 0.0f;
  const int last_row = min(i0 + kTile, sq) - 1;
  int n_tiles = (skv + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (last_row + off) / kTile + 1);

  Acc<T, HD> dq_acc;
  dq_acc.zero();
  Acc<T, kTile> s_acc;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    load_tile<T, HD>(ks, S::kLd, kb, kv_stride, j0, skv);
    load_tile<T, HD>(vs, S::kLd, vb, kv_stride, j0, skv);
    __syncthreads();
    s_acc.zero();
    s_acc.template mma<true, false, HD>(qs, S::kLd, ks, S::kLd);
    s_acc.store(ss, S::kLdS);
    s_acc.zero();
    s_acc.template mma<true, false, HD>(dos, S::kLd, vs, S::kLd);
    s_acc.store(dps, S::kLdS);
    __syncthreads();
    float p[kTile / 2], ds[kTile / 2];
    p_and_ds<T, HD>(ss, dps, r, half, i, j0, sq, skv, off, causal, qk_scale,
                    lse2, dlt, p, ds);
    __syncthreads();  // every read of S is done before dS overwrites it
#pragma unroll
    for (int c = 0; c < kTile / 2; ++c)
      dss[r * S::kLdP + half * (kTile / 2) + c] = from_f32<T>(ds[c]);
    __syncthreads();
    dq_acc.template mma<true, true, kTile>(dss, S::kLdP, ks, S::kLd);
    __syncthreads();
  }
  dq_acc.store(stage, S::kLdO);
  __syncthreads();
  write_tile<T, HD>(dq + q_base, q_stride, stage, S::kLdO, i0, sq, scale);
}

// --- dK / dV -------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int skv, int h, int kvh,
                     int causal, float qk_scale, float scale) {
  using S = Smem<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + S::kTileBytes);
  T* qs = reinterpret_cast<T*>(smem + 2 * S::kTileBytes);
  T* dos = reinterpret_cast<T*>(smem + 3 * S::kTileBytes);
  float* ss = reinterpret_cast<float*>(smem + 4 * S::kTileBytes);
  float* dps = ss + kTile * S::kLdS;
  T* pts = reinterpret_cast<T*>(ss);   // P written over S
  T* dss = reinterpret_cast<T*>(dps);  // dS written over dP
  float* stage = ss;                   // dK, then dV, after the loop

  const int j0 = blockIdx.x * kTile;
  const int g = blockIdx.y;
  const int bi = blockIdx.z;
  const int n_rep = h / kvh;
  const int off = skv - sq;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const size_t kv_base = static_cast<size_t>(bi) * skv * kv_stride + g * HD;
  load_tile<T, HD>(ks, S::kLd, k + kv_base, kv_stride, j0, skv);
  load_tile<T, HD>(vs, S::kLd, v + kv_base, kv_stride, j0, skv);

  const int r = threadIdx.x / 2;
  const int half = threadIdx.x % 2;
  const int n_qt = (sq + kTile - 1) / kTile;
  // First query tile with a row that sees key j0: rows i >= j0 - off.
  const int first = causal ? max(0, j0 - off) / kTile : 0;

  Acc<T, HD> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  Acc<T, kTile> s_acc;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int head = g * n_rep + rep;
    const size_t q_base = static_cast<size_t>(bi) * sq * q_stride + head * HD;
    for (int qt = first; qt < n_qt; ++qt) {
      const int i0 = qt * kTile;
      load_tile<T, HD>(qs, S::kLd, q + q_base, q_stride, i0, sq);
      load_tile<T, HD>(dos, S::kLd, dout + q_base, q_stride, i0, sq);
      __syncthreads();
      s_acc.zero();
      s_acc.template mma<true, false, HD>(qs, S::kLd, ks, S::kLd);
      s_acc.store(ss, S::kLdS);
      s_acc.zero();
      s_acc.template mma<true, false, HD>(dos, S::kLd, vs, S::kLd);
      s_acc.store(dps, S::kLdS);
      __syncthreads();
      const int i = i0 + r;
      const size_t row = (static_cast<size_t>(bi) * h + head) * sq + i;
      const float lse2 = i < sq ? lse[row] * kLog2e : 0.0f;
      const float dlt = i < sq ? delta[row] : 0.0f;
      float p[kTile / 2], ds[kTile / 2];
      p_and_ds<T, HD>(ss, dps, r, half, i, j0, sq, skv, off, causal, qk_scale,
                      lse2, dlt, p, ds);
      __syncthreads();  // S and dP are read before P and dS overwrite them
#pragma unroll
      for (int c = 0; c < kTile / 2; ++c) {
        const int col = half * (kTile / 2) + c;
        pts[r * S::kLdP + col] = from_f32<T>(p[c]);
        dss[r * S::kLdP + col] = from_f32<T>(ds[c]);
      }
      __syncthreads();
      // Rows of dK/dV are keys: A(key, row) = P[row][key], column major.
      dv_acc.template mma<false, true, kTile>(pts, S::kLdP, dos, S::kLd);
      dk_acc.template mma<false, true, kTile>(dss, S::kLdP, qs, S::kLd);
      __syncthreads();
    }
  }
  dk_acc.store(stage, S::kLdO);
  __syncthreads();
  write_tile<T, HD>(dk + kv_base, kv_stride, stage, S::kLdO, j0, skv, scale);
  __syncthreads();
  dv_acc.store(stage, S::kLdO);
  __syncthreads();
  write_tile<T, HD>(dv + kv_base, kv_stride, stage, S::kLdO, j0, skv, 1.0f);
}

// --- launches ------------------------------------------------------------------

struct Shape {
  int b, sq, skv, h, kvh, causal;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, const Shape& s, float qk_scale,
                cudaStream_t stream) {
  const size_t smem = Smem<T, HD>::kFwd;
  cudaError_t err = prepare(flash_fwd_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, HD>
      <<<dim3((s.sq + kTile - 1) / kTile, s.h, s.b), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<float*>(lse), s.sq, s.skv, s.h, s.kvh, s.causal,
          qk_scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Shape& s, float qk_scale, float scale,
                   cudaStream_t stream) {
  const size_t smem = Smem<T, HD>::kBwd;
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD>
      <<<dim3((s.sq + kTile - 1) / kTile, s.h, s.b), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), s.sq, s.skv, s.h, s.kvh, s.causal, qk_scale,
          scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Shape& s, float qk_scale,
                    float scale, cudaStream_t stream) {
  const size_t smem = Smem<T, HD>::kBwd;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, HD>
      <<<dim3((s.skv + kTile - 1) / kTile, s.kvh, s.b), kThreads, smem,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(dout),
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta), static_cast<T*>(dk),
                   static_cast<T*>(dv), s.sq, s.skv, s.h, s.kvh, s.causal,
                   qk_scale, scale);
  return cudaGetLastError();
}

bool valid(const Shape& s, int hd) {
  return s.b >= 1 && s.b <= 65535 && s.sq >= 1 && s.sq <= s.skv &&
         s.kvh >= 1 && s.h >= s.kvh && s.h % s.kvh == 0 && s.h <= 65535 &&
         hd >= 16 && hd <= 128 && hd % 16 == 0;
}

// The three launches as functors: dispatch() instantiates run<T, HD>()
// for the storage type code and head dim.
struct FwdLaunch {
  const void *q, *k, *v;
  void *out, *lse;
  Shape s;
  float qk_scale;
  cudaStream_t stream;
  template <typename T, int HD>
  cudaError_t run() const {
    return fwd<T, HD>(q, k, v, out, lse, s, qk_scale, stream);
  }
};

struct DqLaunch {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* dq;
  Shape s;
  float qk_scale, scale;
  cudaStream_t stream;
  template <typename T, int HD>
  cudaError_t run() const {
    return bwd_dq<T, HD>(q, k, v, dout, lse, delta, dq, s, qk_scale, scale,
                         stream);
  }
};

struct DkvLaunch {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dk, *dv;
  Shape s;
  float qk_scale, scale;
  cudaStream_t stream;
  template <typename T, int HD>
  cudaError_t run() const {
    return bwd_dkv<T, HD>(q, k, v, dout, lse, delta, dk, dv, s, qk_scale,
                          scale, stream);
  }
};

template <typename T, typename Fn>
cudaError_t by_head_dim(int hd, const Fn& fn) {
  switch (hd) {
    case 16: return fn.template run<T, 16>();
    case 32: return fn.template run<T, 32>();
    case 48: return fn.template run<T, 48>();
    case 64: return fn.template run<T, 64>();
    case 80: return fn.template run<T, 80>();
    case 96: return fn.template run<T, 96>();
    case 112: return fn.template run<T, 112>();
    case 128: return fn.template run<T, 128>();
    default: return cudaErrorInvalidValue;
  }
}

template <typename Fn>
cudaError_t dispatch(int dtype, int hd, const Fn& fn) {
  switch (dtype) {
    case kFloat32: return by_head_dim<float>(hd, fn);
    case kBFloat16: return by_head_dim<__nv_bfloat16>(hd, fn);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpu_dra

// Each entry returns the cudaError_t of its launch (cudaErrorInvalidValue
// for a shape or type it does not take). Tensors are contiguous in the
// layouts of the header, 16-byte aligned; dtype is the storage code of
// common.cuh (q, k, v, dout and the outputs share it); qk_scale is
// hd^-0.5 * log2(e) and scale hd^-0.5, each rounded once to float.

extern "C" int tpu_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int dtype, int b, int sq,
                             int skv, int h, int kvh, int hd, int causal,
                             float qk_scale, void* stream) {
  using namespace tpu_dra;
  const Shape s{b, sq, skv, h, kvh, causal};
  if (!valid(s, hd)) return cudaErrorInvalidValue;
  const FwdLaunch fn{q, k, v, out, lse, s, qk_scale,
                     static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, hd, fn);
}

extern "C" int tpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int dtype, int b,
                                int sq, int skv, int h, int kvh, int hd,
                                int causal, float qk_scale, float scale,
                                void* stream) {
  using namespace tpu_dra;
  const Shape s{b, sq, skv, h, kvh, causal};
  if (!valid(s, hd)) return cudaErrorInvalidValue;
  const DqLaunch fn{q,  k, v,        dout,  lse,
                    delta, dq, s, qk_scale, scale,
                    static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, hd, fn);
}

extern "C" int tpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int dtype, int b, int sq, int skv, int h,
                                 int kvh, int hd, int causal, float qk_scale,
                                 float scale, void* stream) {
  using namespace tpu_dra;
  const Shape s{b, sq, skv, h, kvh, causal};
  if (!valid(s, hd)) return cudaErrorInvalidValue;
  const DkvLaunch fn{q,  k,  v, dout,     lse,   delta,
                     dk, dv, s, qk_scale, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, hd, fn);
}
