// Fused decode MLP block for Hopper (sm_90a), on CUDA cores:
//   out = x + down(silu(gate(rms(x))) * up(rms(x)))   for x [B, d], B <= 64.
//
// The route ops/decode_mlp.py `_decode_mlp_route` calls "simt": fp32,
// 17 <= B <= 64, and the bf16 shapes decode_mlp_sm90.cu (the tensor-core
// kernel, which serves bf16 decode at B <= 16) does not take.
//
// Replaces: tpu_dra/workloads/ops/decode_mlp.py `_decode_mlp_kernel`
// (wrapper `_pallas_decode_mlp`, pallas_call at :176). Numerics follow
// the Pallas kernel: xn = T(x32 * rsqrt(mean(x32^2) + eps) * scale32);
// gate and up accumulated in fp32; act = T(silu(g) * u) with silu in
// fp32; down accumulated in fp32; out = T(x32 + acc).
//
// What bounds it on an H100: bytes. At decode batch sizes every weight
// byte feeds 2*B flops (B <= 64), far below the ~295 flops per byte at
// which bf16 tensor cores become the limit; the three weight matrices
// (3*d*ffn elements, 352 MB at Llama-3-8B widths) are the whole cost.
//
// Design. On the TPU the ffn blocks run in order into one VMEM
// accumulator. On Hopper the ffn columns are spread over the SMs in
// three launches on one stream:
//   1. gate_up: one CTA per slab of 32*VEC ffn columns (and per tile of
//      RT rows). It computes the rms statistics of its rows, stages the
//      normalized activations in shared memory a chunk of d at a time,
//      and accumulates gate and up for its columns in fp32; 8 warps
//      split d and reduce through shared memory in a fixed order. It
//      writes act [B, ffn] in T.
//   2. down: one CTA per (slab of 32*VEC output columns, split of ffn),
//      same structure over w_down, writing fp32 partials [splits, B, d].
//   3. residual: out = T(x + sum over splits of the partials).
// With the [in, out] weight layout adjacent threads read adjacent
// columns of one weight row, so every warp load is coalesced, and each
// weight byte is read once. No float atomics anywhere: all reductions
// run in a fixed order, so reruns give identical bits.

#include "common.cuh"

namespace tpu_dra {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;  // rows of the contraction staged per round
constexpr int kRowsPerWarp = kChunk / kWarps;

// gate/up for rows [row0, row0 + RT) and columns
// [blockIdx.x * 32 * VEC, +32 * VEC) of w_gate/w_up [d, ffn].
template <typename T, int RT, int VEC>
__global__ void __launch_bounds__(kThreads)
gate_up_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               const T* __restrict__ w_gate, const T* __restrict__ w_up,
               T* __restrict__ act, int batch, int d, int ffn, float eps) {
  constexpr int kCols = 32 * VEC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * RT;
  const int rows = min(RT, batch - row0);
  const int col = blockIdx.x * kCols + lane * VEC;

  __shared__ float rstd[RT];
  __shared__ float xs[RT][kChunk];
  __shared__ float red_g[kWarps][RT][kCols];
  __shared__ float red_u[kWarps][RT][kCols];

  for (int r = warp; r < rows; r += kWarps) {
    const T* xr = x + static_cast<size_t>(row0 + r) * d;
    float ss = 0.0f;
    for (int k = lane; k < d; k += 32) {
      const float v = to_f32(xr[k]);
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) rstd[r] = rsqrtf(ss / d + eps);
  }
  __syncthreads();

  float ag[RT][VEC], au[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) ag[r][v] = au[r][v] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int i = threadIdx.x; i < RT * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int k = k0 + i % kChunk;
      float v = 0.0f;
      if (r < rows && k < d) {
        v = round_to<T>(to_f32(x[static_cast<size_t>(row0 + r) * d + k]) *
                        rstd[r] * to_f32(scale[k]));
      }
      xs[r][i % kChunk] = v;
    }
    __syncthreads();
    const int kk0 = warp * kRowsPerWarp;
    const int kk1 = min(kk0 + kRowsPerWarp, d - k0);
    if (col < ffn) {
#pragma unroll 8
      for (int kk = kk0; kk < kk1; ++kk) {
        const size_t off = static_cast<size_t>(k0 + kk) * ffn + col;
        const Pack<T, VEC> g = load_pack<T, VEC>(w_gate + off);
        const Pack<T, VEC> u = load_pack<T, VEC>(w_up + off);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float xv = xs[r][kk];
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            ag[r][v] += xv * to_f32(g.v[v]);
            au[r][v] += xv * to_f32(u.v[v]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      red_g[warp][r][lane * VEC + v] = ag[r][v];
      red_u[warp][r][lane * VEC + v] = au[r][v];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < RT * kCols; i += kThreads) {
    const int r = i / kCols;
    const int c = blockIdx.x * kCols + i % kCols;
    if (r >= rows || c >= ffn) continue;
    float g = 0.0f, u = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      g += red_g[w][r][i % kCols];
      u += red_u[w][r][i % kCols];
    }
    const float silu = g / (1.0f + expf(-g));
    act[static_cast<size_t>(row0 + r) * ffn + c] = from_f32<T>(silu * u);
  }
}

// fp32 partials of act @ w_down over ffn rows [split * split_rows, ...)
// for output columns [blockIdx.x * 32 * VEC, +32 * VEC).
template <typename T, int RT, int VEC>
__global__ void __launch_bounds__(kThreads)
down_kernel(const T* __restrict__ act, const T* __restrict__ w_down,
            float* __restrict__ partial, int batch, int d, int ffn,
            int split_rows) {
  constexpr int kCols = 32 * VEC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * RT;
  const int rows = min(RT, batch - row0);
  const int col = blockIdx.x * kCols + lane * VEC;
  const int f_begin = split * split_rows;
  const int f_end = min(ffn, f_begin + split_rows);

  __shared__ float as[RT][kChunk];
  __shared__ float red[kWarps][RT][kCols];

  float acc[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.0f;

  for (int f0 = f_begin; f0 < f_end; f0 += kChunk) {
    for (int i = threadIdx.x; i < RT * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int f = f0 + i % kChunk;
      as[r][i % kChunk] =
          (r < rows && f < f_end)
              ? to_f32(act[static_cast<size_t>(row0 + r) * ffn + f])
              : 0.0f;
    }
    __syncthreads();
    const int ff0 = warp * kRowsPerWarp;
    const int ff1 = min(ff0 + kRowsPerWarp, f_end - f0);
    if (col < d) {
#pragma unroll 8
      for (int ff = ff0; ff < ff1; ++ff) {
        const Pack<T, VEC> w = load_pack<T, VEC>(
            w_down + static_cast<size_t>(f0 + ff) * d + col);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float av = as[r][ff];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] += av * to_f32(w.v[v]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[warp][r][lane * VEC + v] = acc[r][v];
  __syncthreads();
  for (int i = threadIdx.x; i < RT * kCols; i += kThreads) {
    const int r = i / kCols;
    const int c = blockIdx.x * kCols + i % kCols;
    if (r >= rows || c >= d) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][r][i % kCols];
    partial[(static_cast<size_t>(split) * batch + row0 + r) * d + c] = s;
  }
}

template <typename T>
__global__ void residual_kernel(const T* __restrict__ x,
                                const float* __restrict__ partial,
                                T* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[static_cast<size_t>(s) * n + i];
  out[i] = from_f32<T>(to_f32(x[i]) + acc);
}

template <typename T, int RT, int VEC>
cudaError_t launch(const void* x, const void* scale, const void* w_gate,
                   const void* w_up, const void* w_down, void* act,
                   void* partial, void* out, int batch, int d, int ffn,
                   int splits, float eps, cudaStream_t stream) {
  constexpr int kCols = 32 * VEC;
  const int row_tiles = (batch + RT - 1) / RT;
  gate_up_kernel<T, RT, VEC>
      <<<dim3((ffn + kCols - 1) / kCols, row_tiles), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(scale),
          static_cast<const T*>(w_gate), static_cast<const T*>(w_up),
          static_cast<T*>(act), batch, d, ffn, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int split_rows = (ffn + splits - 1) / splits;
  down_kernel<T, RT, VEC><<<dim3((d + kCols - 1) / kCols, splits, row_tiles),
                            kThreads, 0, stream>>>(
      static_cast<const T*>(act), static_cast<const T*>(w_down),
      static_cast<float*>(partial), batch, d, ffn, split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = batch * d;
  residual_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(partial),
      static_cast<T*>(out), n, splits);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t by_rows(const void* x, const void* scale, const void* w_gate,
                    const void* w_up, const void* w_down, void* act,
                    void* partial, void* out, int batch, int d, int ffn,
                    int splits, float eps, cudaStream_t stream) {
  // Smallest row tile that covers the batch (8 rows a tile above 8).
  if (batch <= 1)
    return launch<T, 1, VEC>(x, scale, w_gate, w_up, w_down, act, partial,
                             out, batch, d, ffn, splits, eps, stream);
  if (batch <= 2)
    return launch<T, 2, VEC>(x, scale, w_gate, w_up, w_down, act, partial,
                             out, batch, d, ffn, splits, eps, stream);
  if (batch <= 4)
    return launch<T, 4, VEC>(x, scale, w_gate, w_up, w_down, act, partial,
                             out, batch, d, ffn, splits, eps, stream);
  return launch<T, 8, VEC>(x, scale, w_gate, w_up, w_down, act, partial, out,
                           batch, d, ffn, splits, eps, stream);
}

template <typename T>
cudaError_t by_vec(int vec, const void* x, const void* scale,
                   const void* w_gate, const void* w_up, const void* w_down,
                   void* act, void* partial, void* out, int batch, int d,
                   int ffn, int splits, float eps, cudaStream_t stream) {
  if (vec == 2)
    return by_rows<T, 2>(x, scale, w_gate, w_up, w_down, act, partial, out,
                         batch, d, ffn, splits, eps, stream);
  if (vec == 1)
    return by_rows<T, 1>(x, scale, w_gate, w_up, w_down, act, partial, out,
                         batch, d, ffn, splits, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tpu_dra

// x [batch, d]; scale [d]; w_gate/w_up [d, ffn]; w_down [ffn, d];
// scratch act [batch, ffn] (dtype) and partial [splits, batch, d] fp32;
// out [batch, d]. vec = 2 needs even d and ffn and 2-element-aligned
// weight pointers. Returns the cudaError_t of the launches.
extern "C" int tpu_decode_mlp(const void* x, const void* scale,
                              const void* w_gate, const void* w_up,
                              const void* w_down, void* act, void* partial,
                              void* out, int dtype, int batch, int d, int ffn,
                              int splits, int vec, float eps, void* stream) {
  using namespace tpu_dra;
  if (batch == 0) return cudaSuccess;
  if (batch < 0 || batch > 64 || d < 1 || ffn < 1 || splits < 1 ||
      splits > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return by_vec<float>(vec, x, scale, w_gate, w_up, w_down, act, partial,
                           out, batch, d, ffn, splits, eps, s);
    case kBFloat16:
      return by_vec<__nv_bfloat16>(vec, x, scale, w_gate, w_up, w_down, act,
                                   partial, out, batch, d, ffn, splits, eps,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}
