// Paged-decode attention for Hopper (sm_90a).
//
// Replaces: tpu_dra/workloads/ops/attention.py `_paged_decode_kernel`
// (wrapper `_pallas_paged_decode_attention`, pallas_call at :1245).
// One query per slot; GQA over a shared page pool
// k/v [num_pages, page, kvh, hd] through each slot's block table
// tables [B, max_pages]; keys at positions >= lengths[b] are dead.
// Numerics follow the Pallas block update: s = (q.k in fp32) * hd^-0.5,
// fp32 online softmax (m, l, acc) with exp, p rounded to the model type
// before the PV product, out = acc / max(l, 1e-30); a slot of length 0
// gives exact zeros.
//
// What bounds it on an H100: bytes. Each live token costs one K row and
// one V row per kv head (4 KB per token per layer at Llama-3-8B widths)
// and about 4*n_rep*hd flops against them: ~1 flop per byte, far below
// the ~295 flops per byte where bf16 tensor cores become the limit.
//
// Design. On the TPU the grid walks table entries in order and carries
// (m, l, acc) in VMEM from step to step; on the GPU blocks run in no
// order and nothing carries between them. So one CTA owns one
// (slot, kv head) pair and all n_rep query rows of that group, and the
// page walk is a loop inside it. Each of its 8 warps walks its own
// tokens (kUnroll of them per round, K and V rows loaded before any is
// used, so 16 row loads are in flight per warp), reading the page id
// from the table in global memory and keeping its own (m, l, acc) in
// registers; a lane holds hd/32 columns, and a token's score is a warp
// reduction. The 8 partial states merge once at the end through shared
// memory with the usual max-rescale. A row of hd bf16 values is 128 or
// 256 contiguous bytes, so every warp load is coalesced.
//
// Known limit: B * kvh CTAs (64 at the 8B decode shape) leave half of
// the 132 SMs idle; splitting the pages of one slot over several CTAs
// with a combine pass (flash-decoding) is the first perf step.

#include "common.cuh"

namespace tpu_dra {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kUnroll = 8;

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int kvh, int page, int max_pages, float scale) {
  constexpr int EPL = HD / 32;  // columns per lane
  const int b = blockIdx.x;
  const int g = blockIdx.y;  // kv head
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = kvh * REP;

  int length = lengths[b];
  // Past the table the walk would read pages the slot does not own;
  // the wrapper's contract is length <= max_pages * page. A violation
  // poisons the slot's output with NaN instead of reading out of bounds.
  const bool overflow = length > max_pages * page;
  if (overflow) length = max_pages * page;
  const int* table = tables + static_cast<size_t>(b) * max_pages;

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

  const size_t token_stride = static_cast<size_t>(kvh) * HD;
  for (int base = warp * kUnroll; base < length; base += kWarps * kUnroll) {
    Pack<T, EPL> kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u;
      if (p < length) {
        const size_t pid = static_cast<size_t>(table[p / page]);
        const size_t off = (pid * page + p % page) * token_stride +
                           static_cast<size_t>(g) * HD + lane * EPL;
        kr[u] = load_pack<T, EPL>(k_pages + off);
        vr[u] = load_pack<T, EPL>(v_pages + off);
      } else {
        // Dead columns must contribute 0 * v, never 0 * garbage.
        kr[u] = zero_pack<T, EPL>();
        vr[u] = zero_pack<T, EPL>();
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
        dot = warp_sum(dot);
        s[r][u] = (base + u < length) ? dot * scale : kNegInf;
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
        p_t[u] = round_to<T>(p);
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
  // keeps m = -1e30 and weighs exp(-1e30 - M) = 0; a slot of length 0
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

template <typename T, int HD, int REP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* lengths, void* out,
                   int batch, int kvh, int page, int max_pages, float scale,
                   cudaStream_t stream) {
  paged_decode_kernel<T, HD, REP><<<dim3(batch, kvh), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), kvh, page,
      max_pages, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t by_rep(int n_rep, const void* q, const void* k, const void* v,
                   const void* tables, const void* lengths, void* out,
                   int batch, int kvh, int page, int max_pages, float scale,
                   cudaStream_t stream) {
  switch (n_rep) {
    case 1:
      return launch<T, HD, 1>(q, k, v, tables, lengths, out, batch, kvh, page,
                              max_pages, scale, stream);
    case 2:
      return launch<T, HD, 2>(q, k, v, tables, lengths, out, batch, kvh, page,
                              max_pages, scale, stream);
    case 4:
      return launch<T, HD, 4>(q, k, v, tables, lengths, out, batch, kvh, page,
                              max_pages, scale, stream);
    case 8:
      return launch<T, HD, 8>(q, k, v, tables, lengths, out, batch, kvh, page,
                              max_pages, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_hd(int head_dim, int n_rep, const void* q, const void* k,
                  const void* v, const void* tables, const void* lengths,
                  void* out, int batch, int kvh, int page, int max_pages,
                  float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return by_rep<T, 64>(n_rep, q, k, v, tables, lengths, out, batch, kvh,
                           page, max_pages, scale, stream);
    case 128:
      return by_rep<T, 128>(n_rep, q, k, v, tables, lengths, out, batch, kvh,
                            page, max_pages, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpu_dra

// q [batch, kvh*n_rep, head_dim]; k/v pools [P, page, kvh, head_dim];
// tables [batch, max_pages] int32; lengths [batch] int32;
// out [batch, kvh*n_rep, head_dim]. Returns the cudaError_t of the launch.
extern "C" int tpu_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int dtype, int batch,
    int kvh, int n_rep, int head_dim, int page, int max_pages, float scale,
    void* stream) {
  using namespace tpu_dra;
  if (batch == 0) return cudaSuccess;
  if (batch < 0 || kvh < 1 || kvh > 65535 || page < 1 || max_pages < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return by_hd<float>(head_dim, n_rep, q, k_pages, v_pages, tables,
                          lengths, out, batch, kvh, page, max_pages, scale, s);
    case kBFloat16:
      return by_hd<__nv_bfloat16>(head_dim, n_rep, q, k_pages, v_pages,
                                  tables, lengths, out, batch, kvh, page,
                                  max_pages, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
