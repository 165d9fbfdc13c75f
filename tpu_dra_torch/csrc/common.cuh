// Helpers shared by the port's Hopper kernels: element conversion,
// packed vector loads and warp reductions. Every kernel computes in
// fp32 and rounds to the storage type with round-to-nearest-even, the
// rounding that `astype` uses on the JAX side.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpu_dra {

// Storage types a kernel is instantiated for; the Python wrappers pass
// the matching code.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// fp32 value rounded through T and back: what `x.astype(T)` feeds the
// next product on the JAX side.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// N consecutive elements of T moved as one aligned load.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const T* __restrict__ p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> zero_pack() {
  Pack<T, N> p;
#pragma unroll
  for (int i = 0; i < N; ++i) p.v[i] = from_f32<T>(0.0f);
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace tpu_dra
