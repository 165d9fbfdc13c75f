// The fused temperature / top-k pick for Hopper (sm_90a): for each row of
// fp32 logits, scale by 1/temperature, keep the top_k candidates (or the
// whole row when top_k == 0), draw jax.random's Gumbel noise for them
// with Threefry-2x32, and write the id of the argmax of noise + score.
//
// Replaces: no Pallas kernel. On the JAX side the sampler
// (tpu_dra/workloads/generate.py `sample_token` :559 under
// `jax.random.categorical`, called per slot by engine.py `_pick_tokens`
// :1788 and `_pick_tokens_batched` :1989) is one XLA fusion inside the
// jitted step. Written in plain torch it is ~170 launches per Threefry
// and three Threefry calls a step (two fold_ins, the bits) plus a sort;
// here it is one launch, and no value comes back to the host.
//
// Bits. Each row's key is either
//   rows:  fold_in(fold_in(PRNGKey(seed), serials[r / rows_per_serial]),
//                  positions[r]), and candidate j draws counter j;
//   block: fold_in(key, fold) (or key itself), one key for all rows, and
//          candidate j of row r draws counter r * n_cand + j
// where n_cand is top_k, or n for the whole row. A counter c draws
// y0 ^ y1 of Threefry-2x32(key, hi(c), lo(c)); 23 of its bits make
// u = max(tiny, (1.f..2.f mantissa - 1) * 1 + tiny) and the noise is
// -logf(-logf(u)), as jax.random.uniform and gumbel ("low" mode).
// Every float operation is written with its rounding (__fmul_rn,
// __fadd_rn, __fmaf_rn), so nvcc contracts nothing on its own: a top-k
// draw adds the noise to the rounded score, a whole-row draw fuses
// noise + logit * inv into one FMA, as jitted XLA does on each path
// (ops/sample.py). logf is the precise one (no fast-math in NVCC_FLAGS).
//
// Top-k. Candidates are ordered as lax.top_k orders them (value
// descending, ties to the lower index); the noise index is the rank.
// One CTA a row works on the scores' order-preserving 32-bit keys
// (-0.0 counts as +0.0, as the stable sort compares). For k <= 512 a
// filter comes first: each thread's maximum over its strided elements,
// and T0, the k-th largest of those maxima, a lower bound of the k-th
// largest key; the elements >= T0 (a few times k on real logits) go to
// shared memory. If they do not fit (kCap; an all-equal row), or for
// k > 512, a radix select (four 8-bit passes, shared-memory histograms
// with match_any-aggregated atomics) finds the k-th largest key T and
// how many of the elements equal to T to take, and one more pass
// gathers those above T and, by a block-wide scan in index order, the
// lowest-indexed ones equal to T. A rank count over the kept
// candidates puts the k best in order.
//
// What bounds it: bytes. The row is read once from device memory (the
// second pass hits L2), 513 KB at Llama-3's 128256 vocab; the filter
// is two passes of one SM over it (the radix select five). A simple
// kernel that is right: one CTA per row leaves most of the card idle
// at 8 rows (PERF.md).

#include <math.h>

#include "common.cuh"

namespace tpu_dra {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
// Candidates the filter of a top-k draw may keep in shared memory.
constexpr int kCap = 2048;
constexpr uint32_t kKeyParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, jax's gumbel minval

enum Mode : int { kRows = 0, kBlock = 1 };

struct Params {
  const float* logits;
  long long row_stride;
  int n;
  int top_k;
  float inv_temp;
  int mode;
  const int* seed;
  const int* serials;
  int rows_per_serial;
  const int* positions;
  const long long* key;
  uint32_t fold;
  int has_fold;
  int* out;
  float* cand_vals;
  int* cand_idx;
};

struct Words {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: jax's threefry2x32_p.
__device__ __forceinline__ Words threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kKeyParity;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  TF_EVEN
  x0 += k1;
  x1 += k2 + 1u;
  TF_ODD
  x0 += k2;
  x1 += k0 + 2u;
  TF_EVEN
  x0 += k0;
  x1 += k1 + 3u;
  TF_ODD
  x0 += k1;
  x1 += k2 + 4u;
  TF_EVEN
  x0 += k2;
  x1 += k0 + 5u;
#undef TF_EVEN
#undef TF_ODD
#undef TF_ROUND
  return {x0, x1};
}

__device__ __forceinline__ Words fold_in(Words key, uint32_t data) {
  return threefry(key.a, key.b, 0u, data);
}

// jax.random.gumbel (mode "low") of the bits of counter c.
__device__ __forceinline__ float gumbel(Words key, unsigned long long c) {
  const Words y = threefry(key.a, key.b, static_cast<uint32_t>(c >> 32),
                           static_cast<uint32_t>(c));
  const uint32_t bits = y.a ^ y.b;
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float span = __fsub_rn(1.0f, kTiny);
  const float u = fmaxf(kTiny, __fadd_rn(__fmul_rn(f, span), kTiny));
  return -logf(-logf(u));
}

// Larger float, larger key; -0.0 and +0.0 share a key.
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t b = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

struct Best {
  float v;
  int i;
};

// argmax with ties to the lower index (jnp.argmax); a NaN never wins.
__device__ __forceinline__ bool better(float v, int i, const Best& b) {
  return v > b.v || (v == b.v && i < b.i);
}

__device__ __forceinline__ Best block_argmax(Best b, Best* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, b.v, off);
    const int i = __shfl_xor_sync(0xffffffffu, b.i, off);
    if (better(v, i, b)) b = {v, i};
  }
  if (lane == 0) red[warp] = b;
  __syncthreads();
  if (warp == 0) {
    b = lane < kWarps ? red[lane] : Best{-INFINITY, 0x7fffffff};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, b.v, off);
      const int i = __shfl_xor_sync(0xffffffffu, b.i, off);
      if (better(v, i, b)) b = {v, i};
    }
    if (lane == 0) red[0] = b;
  }
  __syncthreads();
  return red[0];
}

__global__ void __launch_bounds__(kThreads) sample_pick_kernel(Params p) {
  __shared__ uint32_t hist[256];
  __shared__ uint32_t t_max[kThreads];
  __shared__ uint32_t c_key[kCap];
  __shared__ int c_idx[kCap];
  __shared__ float s_val[kMaxK];
  __shared__ int s_idx[kMaxK];
  __shared__ Best red[kWarps];
  __shared__ int warp_eq[kWarps];
  __shared__ uint32_t sh_prefix, sh_mask, sh_thresh;
  __shared__ int sh_kk, sh_gt, sh_eq_run, sh_count;

  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = p.logits + static_cast<long long>(r) * p.row_stride;
  const int n = p.n, top_k = p.top_k;
  const float inv = p.inv_temp;

  Words key;
  if (p.mode == kRows) {
    const Words base{0u, static_cast<uint32_t>(*p.seed)};
    key = fold_in(
        fold_in(base, static_cast<uint32_t>(p.serials[r / p.rows_per_serial])),
        static_cast<uint32_t>(p.positions[r]));
  } else {
    key = {static_cast<uint32_t>(p.key[0]), static_cast<uint32_t>(p.key[1])};
    if (p.has_fold) key = fold_in(key, p.fold);
  }
  const int n_cand = top_k > 0 ? top_k : n;
  const unsigned long long c0 =
      p.mode == kBlock ? static_cast<unsigned long long>(r) * n_cand : 0ull;

  if (top_k == 0) {
    Best b{-INFINITY, 0x7fffffff};
    for (int j = tid; j < n; j += kThreads) {
      const float v = __fmaf_rn(row[j], inv, gumbel(key, c0 + j));
      if (better(v, j, b)) b = {v, j};
    }
    b = block_argmax(b, red);
    if (tid == 0) p.out[r] = b.i;
    return;
  }

  // c_key / c_idx receive n_kept candidates that include the top k.
  int n_kept = -1;
  if (top_k <= kThreads) {
    // Filter: T0, the k-th largest of the threads' maxima, is at most
    // the k-th largest key (k distinct elements reach it), so every
    // element of the top k has a key >= T0. Rows whose keys >= T0 do
    // not fit kCap (an all-equal row) take the radix select below.
    uint32_t local = 0u;
    for (int j = tid; j < n; j += kThreads)
      local = max(local, order_key(__fmul_rn(row[j], inv)));
    t_max[tid] = local;
    if (tid == 0) {
      sh_thresh = 0xffffffffu;
      sh_count = 0;
    }
    __syncthreads();
    int greater = 0;
    for (int m = 0; m < kThreads; ++m) greater += t_max[m] > local ? 1 : 0;
    if (greater < top_k) atomicMin(&sh_thresh, local);
    __syncthreads();
    const uint32_t t0 = sh_thresh;
    for (int j = tid; j < n; j += kThreads) {
      const uint32_t u = order_key(__fmul_rn(row[j], inv));
      if (u >= t0) {
        const int pos = atomicAdd(&sh_count, 1);
        if (pos < kCap) {
          c_key[pos] = u;
          c_idx[pos] = j;
        }
      }
    }
    __syncthreads();
    if (sh_count <= kCap) n_kept = sh_count;
  }
  if (n_kept < 0) {
    // Radix select of the top_k-th largest key, 8 bits a pass.
    uint32_t prefix = 0u, mask = 0u;
    int kk = top_k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kThreads) hist[i] = 0u;
      __syncthreads();
      for (int base = 0; base < n; base += kThreads) {
        const int j = base + tid;
        int bin = -1;
        if (j < n) {
          const uint32_t u = order_key(__fmul_rn(row[j], inv));
          if ((u & mask) == prefix)
            bin = static_cast<int>((u >> shift) & 255u);
        }
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));
      }
      __syncthreads();
      if (tid == 0) {
        int above = 0, b = 255;
        for (; b > 0; --b) {
          if (above + static_cast<int>(hist[b]) >= kk) break;
          above += static_cast<int>(hist[b]);
        }
        sh_kk = kk - above;
        sh_prefix = prefix | (static_cast<uint32_t>(b) << shift);
        sh_mask = mask | (255u << shift);
      }
      __syncthreads();
      prefix = sh_prefix;
      mask = sh_mask;
      kk = sh_kk;
    }

    // Gather: every key above T (top_k - kk of them, in any order), then
    // the kk lowest-indexed keys equal to T after them.
    const uint32_t T = prefix;
    const int n_gt = top_k - kk;
    if (tid == 0) {
      sh_gt = 0;
      sh_eq_run = 0;
    }
    __syncthreads();
    for (int base = 0; base < n; base += kThreads) {
      const int j = base + tid;
      uint32_t u = 0u;
      if (j < n) u = order_key(__fmul_rn(row[j], inv));
      const bool eq = j < n && u == T;
      if (j < n && u > T) {
        const int pos = atomicAdd(&sh_gt, 1);
        c_key[pos] = u;
        c_idx[pos] = j;
      }
      const unsigned ball = __ballot_sync(0xffffffffu, eq);
      if (lane == 0) warp_eq[warp] = __popc(ball);
      __syncthreads();
      int rank = sh_eq_run + __popc(ball & ((1u << lane) - 1u));
      int total = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) rank += warp_eq[w];
        total += warp_eq[w];
      }
      if (eq && rank < kk) {
        c_key[n_gt + rank] = u;
        c_idx[n_gt + rank] = j;
      }
      __syncthreads();
      if (tid == 0) sh_eq_run += total;
    }
    __syncthreads();
    n_kept = top_k;
  }

  // Rank sort: value descending, ties to the lower index; the top_k
  // best of the kept candidates land in order.
  for (int t = tid; t < n_kept; t += kThreads) {
    const uint32_t kt = c_key[t];
    const int it = c_idx[t];
    int rank = 0;
    for (int m = 0; m < n_kept; ++m) {
      const uint32_t km = c_key[m];
      rank += (km > kt || (km == kt && c_idx[m] < it)) ? 1 : 0;
    }
    if (rank < top_k) {
      s_val[rank] = __fmul_rn(row[it], inv);
      s_idx[rank] = it;
    }
  }
  __syncthreads();

  Best b{-INFINITY, 0x7fffffff};
  for (int q = tid; q < top_k; q += kThreads) {
    const float v = __fadd_rn(gumbel(key, c0 + q), s_val[q]);
    if (better(v, q, b)) b = {v, q};
    if (p.cand_vals != nullptr) {
      p.cand_vals[static_cast<long long>(r) * top_k + q] = s_val[q];
      p.cand_idx[static_cast<long long>(r) * top_k + q] = s_idx[q];
    }
  }
  b = block_argmax(b, red);
  if (tid == 0) p.out[r] = s_idx[b.i];
}

}  // namespace
}  // namespace tpu_dra

// out[rows] int32 token ids. mode 0 (rows): seed, serials and positions
// are device int32 (seed a scalar); mode 1 (block): key is a device
// int64 [2], folded with `fold` when has_fold. cand_vals / cand_idx
// ([rows, top_k], optional, both or neither) receive the sorted
// candidates.
extern "C" int tpu_sample_pick(const void* logits, long long row_stride,
                               int rows, int n, int top_k, float inv_temp,
                               int mode, const void* seed, const void* serials,
                               int rows_per_serial, const void* positions,
                               const void* key, unsigned int fold,
                               int has_fold, void* out, void* cand_vals,
                               void* cand_idx, void* stream) {
  using namespace tpu_dra;
  if (rows == 0) return cudaSuccess;
  if (rows < 0 || n < 1 || top_k < 0 || top_k > n || top_k > kMaxK ||
      row_stride < n || (cand_vals == nullptr) != (cand_idx == nullptr))
    return cudaErrorInvalidValue;
  if (mode == kRows) {
    if (seed == nullptr || serials == nullptr || positions == nullptr ||
        rows_per_serial < 1)
      return cudaErrorInvalidValue;
  } else if (mode != kBlock || key == nullptr) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.logits = static_cast<const float*>(logits);
  p.row_stride = row_stride;
  p.n = n;
  p.top_k = top_k;
  p.inv_temp = inv_temp;
  p.mode = mode;
  p.seed = static_cast<const int*>(seed);
  p.serials = static_cast<const int*>(serials);
  p.rows_per_serial = rows_per_serial;
  p.positions = static_cast<const int*>(positions);
  p.key = static_cast<const long long*>(key);
  p.fold = fold;
  p.has_fold = has_fold;
  p.out = static_cast<int*>(out);
  p.cand_vals = static_cast<float*>(cand_vals);
  p.cand_idx = static_cast<int*>(cand_idx);
  sample_pick_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
