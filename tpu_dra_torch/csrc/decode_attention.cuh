// Single-query GQA decode attention, shared by paged_decode.cu (keys
// through a block table) and decode.cu (keys in a contiguous cache).
// The two differ only in where key p of batch row b lives, which the
// `Keys` policy answers; the online softmax below is common to both.
//
// Numerics follow the Pallas block update (tpu_dra/workloads/ops/
// attention.py `_paged_decode_kernel` and `_decode_kernel`), in fp32:
//   s = (q . T(k)) * hd^-0.5            [* k_scale[key] for int8 K]
//   m_new = max(m, s); p = exp(s - m_new); l = l * alpha + sum(p)
//   p' = T(p)                           [T(p * v_scale[key]) for int8 V]
//   acc = acc * alpha + p' . T(v);      out = T(acc / max(l, 1e-30))
// where T is the activation type (fp32 or bf16) and T(int8) is exact.
// `l` sums p before v_scale, as the Pallas kernel does.
//
// Design. One CTA owns one (batch row, kv head) pair and all n_rep
// query rows of that group; each of its 8 warps walks its own tokens
// (kUnroll of them per round, K and V rows loaded before any is used)
// and keeps its own (m, l, acc) in registers; a lane holds hd/32
// columns and a token's score is a warp reduction. The warps' partial
// states merge once at the end through shared memory with the usual
// max-rescale. A K or V row of one kv head is contiguous (hd elements:
// 256 bytes in bf16, 128 in int8), so every warp load is one coalesced
// line: in int8 a lane loads its 4 columns (hd=128) as one 4-byte word.
// Wider per-lane loads (16 bytes, 8 lanes a row) would need 16 columns
// of q and acc per lane and query row: 256 registers at n_rep = 8.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tpu_dra {
namespace attention {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kUnroll = 8;

// Keys through a block table: key p of row b is at position p % page
// of page tables[b, p / page] of the pool [P, page, kvh, hd].
struct PagedKeys {
  const int* __restrict__ tables;
  const int* __restrict__ lengths;
  int page;
  int max_pages;
  __device__ int length(int b) const { return lengths[b]; }
  __device__ int capacity() const { return max_pages * page; }
  __device__ size_t row(int b, int p) const {
    const size_t pid = static_cast<size_t>(
        tables[static_cast<size_t>(b) * max_pages + p / page]);
    return pid * page + p % page;
  }
};

// Keys in a contiguous cache [b, max_seq, kvh, hd], one live length for
// every row (checked against max_seq on the host).
struct ContiguousKeys {
  int len;
  int max_seq;
  __device__ int length(int) const { return len; }
  __device__ int capacity() const { return max_seq; }
  __device__ size_t row(int b, int p) const {
    return static_cast<size_t>(b) * max_seq + p;
  }
};

// T: activation type (q, out); KV: cache storage (T, or int8_t with f32
// scales [rows, kvh]). One CTA per SM is enough (the 8B decode shape
// launches 64 CTAs on 132 SMs), so the bounds let ptxas use up to 255
// registers a thread rather than spill the n_rep x hd/32 accumulators.
template <typename T, typename KV, int HD, int REP, typename Keys>
__global__ void __launch_bounds__(kWarps * 32, 1)
decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_cache,
              const KV* __restrict__ v_cache,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, Keys keys,
              T* __restrict__ out, int kvh, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int EPL = HD / 32;  // columns per lane
  const int b = blockIdx.x;
  const int g = blockIdx.y;  // kv head
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = kvh * REP;

  int length = keys.length(b);
  // Past the table the walk would read rows the slot does not own; a
  // violation poisons the row's output with NaN instead of reading out
  // of bounds (the contiguous wrapper checks its length on the host).
  const bool overflow = length > keys.capacity();
  if (overflow) length = keys.capacity();

  float qf[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    Pack<T, EPL> pk = load_pack<T, EPL>(
        q + (static_cast<size_t>(b) * h + g * REP + r) * HD + lane * EPL);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[r][e] = to_f32(pk.v[e]);
  }

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.0f;
  }

  for (int base = warp * kUnroll; base < length; base += kWarps * kUnroll) {
    Pack<KV, EPL> kr[kUnroll], vr[kUnroll];
    float ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u;
      ks[u] = vs[u] = 0.0f;
      if (p < length) {
        const size_t row = keys.row(b, p);
        const size_t off =
            (row * kvh + g) * HD + static_cast<size_t>(lane) * EPL;
        kr[u] = load_pack<KV, EPL>(k_cache + off);
        vr[u] = load_pack<KV, EPL>(v_cache + off);
        if constexpr (kQuant) {
          ks[u] = k_scale[row * kvh + g];
          vs[u] = v_scale[row * kvh + g];
        }
      } else {
        // Dead columns must contribute 0 * v, never 0 * garbage.
        kr[u] = zero_pack<KV, EPL>();
        vr[u] = zero_pack<KV, EPL>();
      }
    }
    float s[REP][kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qf[r][e] * to_f32(kr[u].v[e]);
        dot = warp_sum(dot) * scale;
        if constexpr (kQuant) dot *= ks[u];
        s[r][u] = (base + u < length) ? dot : kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, s[r][u]);
      const float alpha = expf(m[r] - m_new);
      float p_sum = 0.0f;
      float p_t[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(s[r][u] - m_new);
        p_sum += p;
        p_t[u] = round_to<T>(kQuant ? p * vs[u] : p);
      }
      l[r] = l[r] * alpha + p_sum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a += p_t[u] * to_f32(vr[u].v[e]);
        acc[r][e] = a;
      }
      m[r] = m_new;
    }
  }

  // Merge the warps' partial softmax states. A warp that saw no token
  // keeps m = -1e30 and weighs exp(-1e30 - M) = 0; a row of length 0
  // has M = -1e30 everywhere, l = 0 and acc = 0, so out = 0 / 1e-30 = 0.
  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_acc[kWarps][REP][HD];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][r][lane * EPL + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < REP * HD; i += kWarps * 32) {
    const int r = i / HD;
    const int d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float l_tot = 0.0f, a_tot = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][r] - mx);
      l_tot += sm_l[w][r] * f;
      a_tot += sm_acc[w][r][d] * f;
    }
    float o = a_tot / fmaxf(l_tot, 1e-30f);
    if (overflow) o = __int_as_float(0x7fc00000);  // NaN
    out[(static_cast<size_t>(b) * h + g * REP + r) * HD + d] = from_f32<T>(o);
  }
}

// Arguments every instantiation takes; the dispatch below picks the
// template from the runtime codes.
template <typename Keys>
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  Keys keys;
  void* out;
  int batch;
  int kvh;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int HD, int REP, typename Keys>
cudaError_t launch(const Args<Keys>& a) {
  decode_kernel<T, KV, HD, REP, Keys>
      <<<dim3(a.batch, a.kvh), kWarps * 32, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
          static_cast<const KV*>(a.v), a.k_scale, a.v_scale, a.keys,
          static_cast<T*>(a.out), a.kvh, a.scale);
  return cudaGetLastError();
}

template <typename T, typename KV, int HD, typename Keys>
cudaError_t by_rep(int n_rep, const Args<Keys>& a) {
  switch (n_rep) {
    case 1: return launch<T, KV, HD, 1>(a);
    case 2: return launch<T, KV, HD, 2>(a);
    case 4: return launch<T, KV, HD, 4>(a);
    case 8: return launch<T, KV, HD, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV, typename Keys>
cudaError_t by_hd(int head_dim, int n_rep, const Args<Keys>& a) {
  switch (head_dim) {
    case 64: return by_rep<T, KV, 64>(n_rep, a);
    case 128: return by_rep<T, KV, 128>(n_rep, a);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: the activation code of common.cuh; kv_int8: 0 for a cache of
// the activation type, 1 for int8 with f32 scales.
template <typename Keys>
cudaError_t dispatch(int dtype, int kv_int8, int head_dim, int n_rep,
                     const Args<Keys>& a) {
  if (a.batch == 0) return cudaSuccess;
  if (a.batch < 0 || a.kvh < 1 || a.kvh > 65535) return cudaErrorInvalidValue;
  if (kv_int8 && (a.k_scale == nullptr || a.v_scale == nullptr))
    return cudaErrorInvalidValue;
  switch (dtype * 2 + (kv_int8 ? 1 : 0)) {
    case kFloat32 * 2:
      return by_hd<float, float>(head_dim, n_rep, a);
    case kFloat32 * 2 + 1:
      return by_hd<float, int8_t>(head_dim, n_rep, a);
    case kBFloat16 * 2:
      return by_hd<__nv_bfloat16, __nv_bfloat16>(head_dim, n_rep, a);
    case kBFloat16 * 2 + 1:
      return by_hd<__nv_bfloat16, int8_t>(head_dim, n_rep, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace attention
}  // namespace tpu_dra
