// Weight-only int8 matmul for Hopper (sm_90a):
//   out[m, n] = T((sum_k f32(x[m, k]) * f32(w_q[k, n])) * scale[n])
// for x [M, K] of type T (fp32 or bf16), w_q [K, N] int8 row-major and
// a per-column f32 scale [N]; any M, K, N.
//
// Replaces: tpu_dra/workloads/ops/int8mm.py `_kernel` (wrapper
// `_pallas_int8_matmul`, pallas_call at :76). Numerics follow the
// Pallas body: the int8 weights convert exactly to the activation type,
// products accumulate in fp32, and the scale multiplies the finished
// fp32 sum once before the single rounding to T.
//
// What bounds it on an H100 depends on M. At decode shapes (M = slot
// count, <= 16) every weight byte feeds 2*M flops: bytes bound, the
// whole cost is streaming K*N int8 bytes once. At prefill shapes (M up
// to rows x chunk, ~1024) a [1024, 4096] x [4096, 14336] product is
// 120 GFLOP against 59 MB: operations bound, so it needs tensor cores.
//
// Design. The Pallas kernel tiles (M/128, N/1024, K/1024) and carries an
// fp32 accumulator in VMEM along K; it runs only on shapes that tile.
// The wrapper (ops/int8mm.py `_int8mm_route`) sends bf16 with M > 16,
// K % 8 == 0, N % 16 == 0 and 16-byte aligned x and w_q to the wgmma
// tile of int8mm_sm90.cu (every prefill projection and the generate
// lm_head), and bf16 with M <= 16, K % 4 == 0, N % 16 == 0, x 8-byte
// and w_q 16-byte aligned to the tensor-core GEMV of
// int8mm_gemv_sm90.cu (every decode projection); this file's three
// kernels cover every other shape, chosen by the entry point:
//   1. gemv (M <= 16: fp32, and bf16 shapes int8mm_gemv_sm90.cu does
//      not take): weight streaming. One CTA per (slab of 32*VEC
//      columns, split of K, tile of RT rows). A lane loads VEC adjacent
//      int8 columns of one weight row as one aligned word (16 bytes when
//      N and the pointer allow), so a warp reads 32*VEC contiguous
//      bytes; the CTA's rows of x sit in shared memory a chunk of K at a
//      time, transposed so a lane reads its RT values of one k as
//      16-byte words; 8 warps split the chunk's rows and their sums meet
//      in a fixed-order tree through shared memory. With one K split the
//      CTA writes T(sum * scale) itself; with several it writes fp32
//      partials [splits, M, N] and a finish pass sums them in order.
//      At M = 8 the loop issues 8 FMAs per weight byte, so the int8 ->
//      f32 conversion takes a byte permute and one add (i8x4_to_f32)
//      instead of the quarter-rate integer-to-float instruction.
//      This is the recipe of decode_mlp.cu, which reads bf16 weights.
//   2. mma (M > 16, bf16, the shapes int8mm_sm90.cu does not take):
//      tensor cores through WMMA bf16 m16n16k16 with fp32 accumulators.
//      A CTA computes a 64 x 128 output tile in 8 warps (32 x 32
//      each); per 32-deep step it stages x as bf16 and
//      W converted int8 -> bf16 (exact for |w| <= 127) in shared memory.
//      The accumulators go through shared memory for the scale and the
//      cast.
//   3. sgemm (M > 16, fp32): the same tiling on CUDA cores (64 x 64
//      tile, 4 x 4 outputs per thread), because fp32 activations would
//      lose bits in TF32 tensor cores.
// No float atomics: every reduction runs in a fixed order, so reruns
// give identical bits.

#include <mma.h>

#include "common.cuh"

namespace tpu_dra {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// --- 1. gemv: M <= 16 -----------------------------------------------------

constexpr int kChunk = 256;  // contraction rows of x staged per round
constexpr int kRowsPerWarp = kChunk / kWarps;

// VEC adjacent int8 weights at p (VEC-byte aligned) -> f32.
template <int VEC>
__device__ __forceinline__ void load_i8_f32(const int8_t* __restrict__ p,
                                            float* f) {
  if constexpr (VEC % 4 == 0) {
    const Pack<uint32_t, VEC / 4> words =
        load_pack<uint32_t, VEC / 4>(reinterpret_cast<const uint32_t*>(p));
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) i8x4_to_f32(words.v[j], f + 4 * j);
  } else {
    const Pack<int8_t, VEC> wp = load_pack<int8_t, VEC>(p);
#pragma unroll
    for (int v = 0; v < VEC; ++v) f[v] = to_f32(wp.v[v]);
  }
}

template <typename T, int RT, int VEC>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, T* __restrict__ out,
            float* __restrict__ partial, int M, int K, int N,
            int split_rows) {
  constexpr int kCols = 32 * VEC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * RT;
  const int rows = min(RT, M - row0);
  const int col = blockIdx.x * kCols + lane * VEC;
  const int k_begin = split * split_rows;
  const int k_end = min(K, k_begin + split_rows);

  __shared__ __align__(16) float xs[kChunk][RT];  // transposed
  __shared__ float red[kWarps / 2][RT][kCols];

  float acc[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    for (int i = threadIdx.x; i < RT * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int k = k0 + i % kChunk;
      xs[i % kChunk][r] =
          (r < rows && k < k_end)
              ? to_f32(x[static_cast<size_t>(row0 + r) * K + k])
              : 0.0f;
    }
    __syncthreads();
    const int kk0 = warp * kRowsPerWarp;
    const int kk1 = min(kk0 + kRowsPerWarp, k_end - k0);
    // N % VEC == 0 (the wrapper picks VEC so), so a pack never crosses N.
    if (col < N) {
#pragma unroll 8
      for (int kk = kk0; kk < kk1; ++kk) {
        float wf[VEC];
        load_i8_f32<VEC>(w + static_cast<size_t>(k0 + kk) * N + col, wf);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float xv = xs[kk][r];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] += xv * wf[v];
        }
      }
    }
    __syncthreads();
  }

  // Fixed-order tree over the warps: 4+4, 2+2, 1+1; warp 0 ends with
  // the CTA's sums for its columns.
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          red[warp - half][r][lane * VEC + v] = acc[r][v];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] += red[warp][r][lane * VEC + v];
    }
    __syncthreads();
  }
  if (warp != 0 || col >= N) return;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r >= rows) break;
    const size_t o = static_cast<size_t>(row0 + r) * N + col;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if (gridDim.y == 1) {
        out[o + v] = from_f32<T>(acc[r][v] * scale[col + v]);
      } else {
        partial[static_cast<size_t>(split) * M * N + o + v] = acc[r][v];
      }
    }
  }
}

template <typename T>
__global__ void finish_kernel(const float* __restrict__ partial,
                              const float* __restrict__ scale,
                              T* __restrict__ out, int M, int N, int splits) {
  const size_t n_out = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[s * n_out + i];
  out[i] = from_f32<T>(acc * scale[i % N]);
}

template <typename T, int RT, int VEC>
cudaError_t launch_gemv(const void* x, const void* w, const float* scale,
                        void* out, float* partial, int M, int K, int N,
                        int splits, cudaStream_t stream) {
  constexpr int kCols = 32 * VEC;
  const int split_rows = (K + splits - 1) / splits;
  gemv_kernel<T, RT, VEC>
      <<<dim3((N + kCols - 1) / kCols, splits, (M + RT - 1) / RT), kThreads,
         0, stream>>>(static_cast<const T*>(x),
                      static_cast<const int8_t*>(w), scale,
                      static_cast<T*>(out), partial, M, K, N, split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n_out = static_cast<size_t>(M) * N;
  finish_kernel<T><<<static_cast<unsigned>((n_out + 255) / 256), 256, 0,
                     stream>>>(partial, scale, static_cast<T*>(out), M, N,
                               splits);
  return cudaGetLastError();
}

// VEC int8 columns per lane; RT * VEC <= 64 keeps the accumulators in
// registers (the wrapper caps VEC by the row tile).
template <typename T, int RT>
cudaError_t gemv_by_vec(int vec, const void* x, const void* w,
                        const float* scale, void* out, float* partial, int M,
                        int K, int N, int splits, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch_gemv<T, RT, 1>(x, w, scale, out, partial, M, K, N, splits,
                                   stream);
    case 4:
      return launch_gemv<T, RT, 4>(x, w, scale, out, partial, M, K, N, splits,
                                   stream);
    case 8:
      return launch_gemv<T, RT, 8>(x, w, scale, out, partial, M, K, N, splits,
                                   stream);
    case 16:
      if constexpr (RT * 16 <= 64)
        return launch_gemv<T, RT, 16>(x, w, scale, out, partial, M, K, N,
                                      splits, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t gemv(int rows_tile, int vec, const void* x, const void* w,
                 const float* scale, void* out, float* partial, int M, int K,
                 int N, int splits, cudaStream_t stream) {
  switch (rows_tile) {
    case 1:
      return gemv_by_vec<T, 1>(vec, x, w, scale, out, partial, M, K, N,
                               splits, stream);
    case 2:
      return gemv_by_vec<T, 2>(vec, x, w, scale, out, partial, M, K, N,
                               splits, stream);
    case 4:
      return gemv_by_vec<T, 4>(vec, x, w, scale, out, partial, M, K, N,
                               splits, stream);
    case 8:
      return gemv_by_vec<T, 8>(vec, x, w, scale, out, partial, M, K, N,
                               splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// --- 2. mma: M > 16, bf16, tensor cores -----------------------------------

constexpr int kTileM = 64;
constexpr int kTileN = 128;
constexpr int kTileK = 32;
constexpr int kLdA = kTileK + 8;  // bf16 elements; +8 staggers the banks
constexpr int kLdB = kTileN + 8;
constexpr int kLdC = kTileN + 4;  // floats
constexpr int kBytesA = kTileM * kLdA * 2;
constexpr int kBytesB = kTileK * kLdB * 2;
constexpr int kBytesC = kTileM * kLdC * 4;
constexpr int kMmaSmem =
    kBytesA + kBytesB > kBytesC ? kBytesA + kBytesB : kBytesC;

__global__ void __launch_bounds__(kThreads)
mma_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ w, const float* __restrict__ scale,
                __nv_bfloat16* __restrict__ out, int M, int K, int N,
                bool x_vec, bool w_vec) {
  namespace wmma = nvcuda::wmma;
  // The staging tiles and the output tile share one buffer: the output
  // goes in only after the last staging round has been read.
  __shared__ __align__(128) unsigned char smem[kMmaSmem];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + kBytesA);
  float* cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 32;  // the warp's 32 x 32 piece of the tile
  const int wn = (warp % 4) * 32;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    // x tile [64, 32]: 8 bf16 (16 bytes) per thread.
    for (int i = threadIdx.x; i < kTileM * kTileK / 8; i += kThreads) {
      const int r = i / (kTileK / 8);
      const int c8 = (i % (kTileK / 8)) * 8;
      const int gm = m0 + r;
      const int gk = k0 + c8;
      __nv_bfloat16* dst = as + r * kLdA + c8;
      if (x_vec && gm < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(gm) * K + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < K)
                       ? x[static_cast<size_t>(gm) * K + gk + e]
                       : zero;
      }
    }
    // W tile [32, 128]: 16 int8 (16 bytes) per thread, converted.
    for (int i = threadIdx.x; i < kTileK * kTileN / 16; i += kThreads) {
      const int r = i / (kTileN / 16);
      const int c16 = (i % (kTileN / 16)) * 16;
      const int gk = k0 + r;
      const int gn = n0 + c16;
      Pack<int8_t, 16> wp;
      if (w_vec && gk < K && gn + 16 <= N) {
        wp = load_pack<int8_t, 16>(w + static_cast<size_t>(gk) * N + gn);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          wp.v[e] = (gk < K && gn + e < N)
                        ? w[static_cast<size_t>(gk) * N + gn + e]
                        : static_cast<int8_t>(0);
      }
      __nv_bfloat16* dst = bs + r * kLdB + c16;
#pragma unroll
      for (int e = 0; e < 16; ++e) dst[e] = __float2bfloat16_rn(to_f32(wp.v[e]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * kLdB + wn + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + i * 16) * kLdC + wn + j * 16,
                              c[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kTileM * kTileN; i += kThreads) {
    const int r = i / kTileN;
    const int cc = i % kTileN;
    const int gm = m0 + r;
    const int gn = n0 + cc;
    if (gm < M && gn < N)
      out[static_cast<size_t>(gm) * N + gn] =
          __float2bfloat16_rn(cs[r * kLdC + cc] * scale[gn]);
  }
}

// --- 3. sgemm: M > 16, fp32, CUDA cores ------------------------------------

constexpr int kSgTile = 64;
constexpr int kSgK = 16;

__global__ void __launch_bounds__(kThreads)
sgemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ out, int M,
             int K, int N) {
  __shared__ float xs[kSgK][kSgTile + 1];  // transposed: xs[k][m]
  __shared__ float ws[kSgK][kSgTile];
  const int m0 = blockIdx.y * kSgTile;
  const int n0 = blockIdx.x * kSgTile;
  const int tx = threadIdx.x % 16;  // output columns tx + 16 j
  const int ty = threadIdx.x / 16;  // output rows ty + 16 i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kSgK) {
    for (int i = threadIdx.x; i < kSgTile * kSgK; i += kThreads) {
      const int r = i / kSgK;
      const int k = i % kSgK;
      xs[k][r] = (m0 + r < M && k0 + k < K)
                     ? x[static_cast<size_t>(m0 + r) * K + k0 + k]
                     : 0.0f;
    }
    for (int i = threadIdx.x; i < kSgK * kSgTile; i += kThreads) {
      const int k = i / kSgTile;
      const int c = i % kSgTile;
      ws[k][c] = (k0 + k < K && n0 + c < N)
                     ? to_f32(w[static_cast<size_t>(k0 + k) * N + n0 + c])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSgK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N)
        out[static_cast<size_t>(m) * N + n] = acc[i][j] * scale[n];
    }
  }
}

}  // namespace
}  // namespace tpu_dra

// x [M, K] (dtype code of common.cuh); w_q [K, N] int8; scale [N] f32;
// out [M, N] of x's type. M <= 16 takes the gemv kernel with a tile of
// rows_tile rows (1, 2, 4 or 8), vec int8 columns per lane (1, 4, 8 or
// 16, dividing N and the alignment of w_q, rows_tile * vec <= 64) and
// `splits` K splits; splits > 1 needs partial [splits, M, N] f32.
// M > 16 takes the mma (bf16) or sgemm (fp32) kernel; x_vec says x rows
// may be read 16 bytes at a time (K % 8 == 0, x 16-byte aligned).
// Returns the cudaError_t of the launches.
extern "C" int tpu_int8_matmul(const void* x, const void* w_q,
                               const void* scale, void* out, void* partial,
                               int dtype, int M, int K, int N, int rows_tile,
                               int vec, int splits, int x_vec, void* stream) {
  using namespace tpu_dra;
  if (M == 0 || N == 0) return cudaSuccess;
  if (M < 0 || K < 1 || N < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (M <= 16) {
    if (splits < 1 || splits > 65535 || (splits > 1 && partial == nullptr))
      return cudaErrorInvalidValue;
    float* part = static_cast<float*>(partial);
    switch (dtype) {
      case kFloat32:
        return gemv<float>(rows_tile, vec, x, w_q, sc, out, part, M, K, N,
                           splits, s);
      case kBFloat16:
        return gemv<__nv_bfloat16>(rows_tile, vec, x, w_q, sc, out, part, M,
                                   K, N, splits, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (M > 65535 * kTileM) return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      sgemm_kernel<<<dim3((N + kSgTile - 1) / kSgTile,
                          (M + kSgTile - 1) / kSgTile),
                     kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const int8_t*>(w_q), sc,
          static_cast<float*>(out), M, K, N);
      return cudaGetLastError();
    case kBFloat16:
      mma_bf16_kernel<<<dim3((N + kTileN - 1) / kTileN,
                             (M + kTileM - 1) / kTileM),
                        kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const int8_t*>(w_q), sc,
          static_cast<__nv_bfloat16*>(out), M, K, N, x_vec != 0, vec == 16);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}
