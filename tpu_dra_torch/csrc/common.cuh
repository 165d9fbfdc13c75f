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
// int8 storage (weights, KV): exact in fp32, and in bf16 for |v| <= 127.
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
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

// All bits zero: 0 in every storage type (fp32, bf16, int8).
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> zero_pack() {
  Pack<T, N> p;
  unsigned char* bytes = reinterpret_cast<unsigned char*>(&p);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(p)); ++i) bytes[i] = 0;
  return p;
}

// int8 -> fp32 and bf16, exactly, without the quarter-rate integer
// conversion. Flipping the sign bits (u = w ^ 0x80808080) maps each
// int8 v to the byte v + 128 in [0, 255]; a byte permute puts it under
// the exponent of 2^23, giving the float 2^23 + v + 128, and
// subtracting 2^23 + 128 leaves v. Byte I of u -> the bits of f32(v):
__device__ __forceinline__ uint32_t i8_f32_bits(uint32_t u, int i) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
      8388736.0f);
}
// v has at most 8 significant bits, so the upper half of f32(v) is v in
// bf16: two such floats -> one bf16x2 word (lo in the low half).
__device__ __forceinline__ uint32_t pack_upper_halves(uint32_t lo,
                                                      uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}
// Four int8 in a word -> four f32.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(i8_f32_bits(u, i));
}
// Four int8 in a word -> four bf16 in two words (bytes 0, 1 in lo).
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  lo = pack_upper_halves(i8_f32_bits(u, 0), i8_f32_bits(u, 1));
  hi = pack_upper_halves(i8_f32_bits(u, 2), i8_f32_bits(u, 3));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace tpu_dra
