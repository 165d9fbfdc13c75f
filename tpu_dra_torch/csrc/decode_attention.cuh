// Single-query GQA decode attention, shared by paged_decode.cu (keys
// through a block table) and decode.cu (keys in a contiguous cache).
// The two differ only in where key p of batch row b lives, which the
// `Keys` policy answers; everything below is common to both.
//
// Numerics follow the Pallas block update (tpu_dra/workloads/ops/
// attention.py `_paged_decode_kernel` and `_decode_kernel`), in fp32:
//   s = (q . T(k)) * hd^-0.5            [* k_scale[key] for int8 K]
//   m_new = max(m, s); p = exp(s - m_new); l = l * alpha + sum(p)
//   p' = T(p)                           [T(p * v_scale[key]) for int8 V]
//   acc = acc * alpha + p' . T(v);      out = T(acc / max(l, 1e-30))
// where T is the activation type (fp32 or bf16) and T(int8) is exact.
// `l` sums p before v_scale, as the Pallas kernel does. Scores are kept
// in log2 units (the scale folds in log2 e) and exponentiated with
// exp2, the same softmax up to fp32 rounding.
//
// Design (flash-decoding). What bounds the op is bytes: every live key
// costs one K and one V row per kv head and ~1 flop per byte. Reading
// them at the memory rate needs most SMs busy and many bytes in flight,
// which one CTA per (batch row, kv head) cannot give: at the 8B decode
// shape that is 64 CTAs on 132 SMs, 8 with one long sequence. So:
//
//  - decode_split_kernel: the grid is (split, kv head x row group,
//    batch row). A CTA owns `chunk` consecutive key positions of one
//    (row, kv head) and one group of at most ROWS (2, 4 or 8) of
//    that kv head's n_rep query rows. It streams its keys in
//    tiles of kTile K and V rows (and their int8 scales) through a
//    kStages-deep cp.async ring in shared memory, 16-byte copies whose
//    source address comes from Keys::row (the paged gather is the copy
//    itself); rows past the length are zero-filled through the source
//    size and masked. While a tile lands the warps compute on the one
//    before, with one of two bodies: bf16 caches (the serving paths) on
//    the tensor cores (MmaBody: mma.sync over ldmatrix'd K and V, the
//    query rows padded to 16; at HD 256 two warps share each key group,
//    each summing half the columns), fp32 activations and int8 caches
//    on the CUDA cores (CoreBody: a lane owns 8 columns of one key, a
//    score is a shuffle reduction over the key's lanes). Each warp (or
//    warp pair) keeps its own (m, l, acc); they merge once at the end
//    with the usual max-rescale. A CTA whose range starts at or past its row's length
//    exits at once.
//  - with more than one split the CTA writes its partial (m, l, acc) in
//    fp32 to a workspace [batch, h, splits, hd + 2] (acc, then m in
//    log2 units, then l), and decode_combine_kernel merges each (row,
//    query head)'s live splits in split order:
//      M = max m_i;
//      out = sum acc_i 2^(m_i - M) / max(sum l_i 2^(m_i - M), 1e-30)
//    No atomics, so reruns are bit-identical. The combine is launched as
//    a programmatic dependent of the split kernel, so its launch overlaps
//    the split kernel's tail. With one split the CTA writes `out` itself
//    and the combine is not launched.
//
// Registers decide how many CTAs share an SM (min_blocks): three or
// four, so that the ~4 live CTAs an SM of the 8B decode shapes run in
// about one wave.
//
// Shapes. Any head dim hd that is a multiple of 16 from 16 to 256 runs in
// the instantiation of its bucket HD (64, 128 or 256; hd <= HD): the ring
// keeps rows of HD columns, the copies past hd are zero-filled through
// cp.async's source size and read nothing, q's columns past hd are zeros,
// and no column past hd is stored, so the padding costs shared memory and
// arithmetic but no device-memory bytes. hd 64, 128 and 256 are their own
// buckets; with bf16 q each has a build whose hd is known at compile time
// (kExact). The scale is the caller's (hd^-0.5 of the real head dim). Any
// n_rep runs in groups of ROWS query rows, ROWS the next power of two
// from 2 up to 8 (n_rep 1 in a group of 2, one row masked): ceil(n_rep /
// ROWS) CTAs a (split, kv head), each reading the kv head's keys (the
// groups of one kv head run side by side, so the repeats come mostly from
// L2), the rows of the last group past n_rep masked (no load of q, no
// store). A row's arithmetic does not depend on its group, so grouping
// changes no bit of any row.
//
// The split plan (splits, chunk) comes from the host (ops/attention.py
// `split_plan`), from host-known values only: for the paged kernel its
// key range is the table's capacity, and the lengths stay on the
// device, where the combine reads them to find the live splits.
//
// Contracts: a row of length 0 gives exact zeros; a paged length past
// the table's capacity gives a NaN row and no read out of bounds (the
// contiguous wrapper refuses a length past max_seq on the host).
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace tpu_dra {
namespace attention {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;        // keys a ring stage holds
constexpr int kStages = 3;       // two tiles in flight while one computes
constexpr int kCols = 8;         // columns of a key a lane owns
constexpr int kMaxSplits = 32;   // splits a plan may have (the combine
                                 // holds one split's values a register)
constexpr int kMaxHeadDim = 256;  // the largest head-dim bucket

// Keys through a block table: key p of row b is at position p % page
// of page tables[b, p / page] of the pool [P, page, kvh, hd]. `shift` is
// log2(page) for a power-of-two page (the engine's 16), else -1 and the
// lookup divides.
struct PagedKeys {
  const int* __restrict__ tables;
  const int* __restrict__ lengths;
  int page;
  int max_pages;
  int shift;
  __device__ int length(int b) const { return lengths[b]; }
  __device__ int capacity() const { return max_pages * page; }
  __device__ size_t row(int b, int p) const {
    const int idx = shift >= 0 ? p >> shift : p / page;
    const size_t pid = static_cast<size_t>(
        tables[static_cast<size_t>(b) * max_pages + idx]);
    return pid * page + (p - idx * page);
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

// Sizes that follow from the cache type and head-dim bucket.
template <typename KV, int HD>
struct Layout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  // bf16 caches run the tensor-core body, whose ldmatrix reads want the
  // ring's rows swizzled: 16-byte chunk c of row r at c ^ (r % 8).
  static constexpr bool kMma = std::is_same<KV, __nv_bfloat16>::value;
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(KV));
  static constexpr int kCopies = kRowBytes / 16;  // 16-byte copies a row
  static constexpr int kTileBytes = kTile * kRowBytes;
  // K tile, V tile, then (int8) the K and V scales of the tile's keys.
  static constexpr int kStageBytes =
      2 * kTileBytes + (kQuant ? 2 * kTile * 4 : 0);
  static constexpr int kLanesPerKey = HD / kCols;
  static constexpr int kKeysPerStep = 32 / kLanesPerKey;  // a warp step
  static constexpr int kSteps = kTile / (kWarps * kKeysPerStep);
  static_assert(kTile * kCopies % kThreads == 0, "whole copies per thread");
  static_assert(kSteps >= 1, "a warp covers its keys in whole steps");
};

// Dynamic shared memory of one CTA: the ring, reused at the end for the
// warps' partial states (m, l per warp and query row, then acc). The
// largest, the fp32 ring at HD 256, is 192 KB.
template <typename KV, int HD, int ROWS>
constexpr int smem_bytes() {
  constexpr int ring = kStages * Layout<KV, HD>::kStageBytes;
  constexpr int merge = kWarps * ROWS * (HD + 2) * 4;
  return ring > merge ? ring : merge;
}

// CTAs an SM should hold, which caps the registers a thread: the
// tensor-core body (bf16 caches) needs ~160 at HD 128, so three, and
// two at HD 256 (twice the fragments); the CUDA-core body fits 128 with
// an int8 cache at ROWS <= 4, so four; two otherwise (an fp32 ring
// takes 96 KB at HD 128, and its instantiations spill under four); at
// HD 256 two with an int8 cache and one with fp32 (its 192 KB ring
// leaves room for no second CTA).
template <typename KV, int HD, int ROWS>
constexpr int min_blocks() {
  if (std::is_same<KV, __nv_bfloat16>::value) return HD <= 128 ? 3 : 2;
  if (HD > 128) return sizeof(KV) == 1 ? 2 : 1;
  return ROWS <= 4 && sizeof(KV) == 1 ? 4 : 2;
}

// kCols consecutive elements as fp32, in loads of at most 16 bytes.
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&f)[kCols]) {
  constexpr int kVec =
      16 / static_cast<int>(sizeof(T)) < kCols ? 16 / sizeof(T) : kCols;
#pragma unroll
  for (int i = 0; i < kCols; i += kVec) {
    const Pack<T, kVec> pk = load_pack<T, kVec>(p + i);
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[i + e] = to_f32(pk.v[e]);
  }
}

// The cache rows of one tile that this thread copies: one per 16-byte
// copy of K (and the same row of V), and with int8 the row of the scale
// this thread copies; -1 past `end`. Looked up a tile ahead, so that
// the block-table reads of the paged kernel are in flight while the
// warps compute.
template <typename KV, int HD>
struct TileRows {
  static constexpr int kN = kTile * Layout<KV, HD>::kCopies / kThreads;
  int row[kN];
  int scale_row;
};

template <typename KV, int HD, typename Keys>
__device__ __forceinline__ TileRows<KV, HD> tile_rows(const Keys& keys, int b,
                                                     int p0, int end) {
  using L = Layout<KV, HD>;
  TileRows<KV, HD> t;
#pragma unroll
  for (int n = 0; n < TileRows<KV, HD>::kN; ++n) {
    const int r = (threadIdx.x + n * kThreads) / L::kCopies;
    t.row[n] = p0 + r < end ? static_cast<int>(keys.row(b, p0 + r)) : -1;
  }
  t.scale_row = -1;
  if (L::kQuant && threadIdx.x < kTile && p0 + threadIdx.x < end)
    t.scale_row = static_cast<int>(keys.row(b, p0 + threadIdx.x));
  return t;
}

// Issue the copies of one tile of (kv head g) into the ring stage at
// shared address `stage`; rows of -1, and the copies of a row past its
// `hd` columns (`copies` live ones), are zero-filled and read nothing.
template <typename KV, int HD>
__device__ __forceinline__ void load_tile(
    uint32_t stage, const TileRows<KV, HD>& t,
    const KV* __restrict__ k_cache, const KV* __restrict__ v_cache,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int g, int kvh, int hd, int copies) {
  using L = Layout<KV, HD>;
  constexpr int kPerCopy = 16 / static_cast<int>(sizeof(KV));
#pragma unroll
  for (int n = 0; n < TileRows<KV, HD>::kN; ++n) {
    const int c = threadIdx.x + n * kThreads;
    const int r = c / L::kCopies;
    const int cc = c % L::kCopies;
    const bool ok = t.row[n] >= 0 && cc < copies;
    const size_t off =
        ok ? (static_cast<size_t>(t.row[n]) * kvh + g) * hd + cc * kPerCopy
           : 0;
    const uint32_t dst =
        stage + r * L::kRowBytes + ((L::kMma ? cc ^ (r & 7) : cc) << 4);
    cp_async16(dst, k_cache + off, ok);
    cp_async16(dst + L::kTileBytes, v_cache + off, ok);
  }
  if constexpr (L::kQuant) {
    if (threadIdx.x < kTile) {
      const bool ok = t.scale_row >= 0;
      const size_t off = ok ? static_cast<size_t>(t.scale_row) * kvh + g : 0;
      const uint32_t dst = stage + 2 * L::kTileBytes + threadIdx.x * 4;
      cp_async4(dst, k_scale + off, ok);
      cp_async4(dst + kTile * 4, v_scale + off, ok);
    }
  }
}

// The CUDA-core body (fp32 activations, int8 caches): a lane owns kCols
// columns of one key (32 lanes a key at HD 256, 16 at HD 128, 8 at HD
// 64) and those columns of the ROWS query rows; a score is a reduction
// over the key's lanes. Each lane keeps its own (m, l, acc) over its
// keys. A tile's kSteps steps of keys take one online update each kU
// steps: all of them at HD <= 128; at HD 256 (a lane a key's 32nd, 8
// steps a tile) at most 16 scores a lane per update, so that the
// scores of ROWS rows stay in registers.
template <typename T, typename KV, int HD, int ROWS>
struct CoreBody {
  using L = Layout<KV, HD>;
  static constexpr int LPK = L::kLanesPerKey;
  static constexpr int kU =
      HD <= 128 || ROWS * L::kSteps <= 16 ? L::kSteps : 16 / ROWS;
  static_assert(L::kSteps % kU == 0, "whole updates a tile");
  static constexpr int kSlots = kWarps;  // partial states: one a warp
  int warp, lane, col0;
  float qf[ROWS][kCols];
  float m[ROWS], l[ROWS], acc[ROWS][kCols];

  // q_rows: the first query row of this CTA's group; `rows` of them
  // are live, each `hd` columns long.
  __device__ __forceinline__ void init(const T* q_rows, int hd, int rows) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    col0 = (lane % LPK) * kCols;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < rows && col0 < hd) {
        load_cols(q_rows + r * hd + col0, qf[r]);
      } else {
#pragma unroll
        for (int e = 0; e < kCols; ++e) qf[r][e] = 0.0f;
      }
      m[r] = kNegInf;
      l[r] = 0.0f;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[r][e] = 0.0f;
    }
  }

  // One tile of keys [p0, p0 + kTile) from the ring stage at `st`; keys
  // at or past `end` are dead.
  __device__ __forceinline__ void tile(const unsigned char* st, uint32_t,
                                       int p0, int end, float scale2) {
#pragma unroll
    for (int u0 = 0; u0 < L::kSteps; u0 += kU) steps(st, u0, p0, end, scale2);
  }

  // Steps [u0, u0 + kU) of a tile: one online update.
  __device__ __forceinline__ void steps(const unsigned char* st, int u0,
                                        int p0, int end, float scale2) {
    const KV* kt = reinterpret_cast<const KV*>(st);
    const KV* vt = reinterpret_cast<const KV*>(st + L::kTileBytes);
    const float* sc = reinterpret_cast<const float*>(st + 2 * L::kTileBytes);
    float s[ROWS][kU];
    float vs[kU];
    bool live[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = warp * (kTile / kWarps) + (u0 + u) * L::kKeysPerStep +
                    lane / LPK;
      live[u] = p0 + j < end;
      float kf[kCols];
      load_cols(kt + j * HD + col0, kf);
      float ks = 1.0f;
      vs[u] = 1.0f;
      if constexpr (L::kQuant) {
        ks = sc[j];
        vs[u] = sc[kTile + j];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < kCols; ++e) dot += qf[r][e] * kf[e];
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        dot *= scale2;
        if constexpr (L::kQuant) dot *= ks;
        s[r][u] = live[u] ? dot : kNegInf;
      }
    }
    float pt[ROWS][kU];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kU; ++u) m_new = fmaxf(m_new, s[r][u]);
      const float alpha = exp2f(m[r] - m_new);
      float p_sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        // Dead keys weigh 0 even while this lane has seen no live key.
        const float p = live[u] ? exp2f(s[r][u] - m_new) : 0.0f;
        p_sum += p;
        pt[r][u] = round_to<T>(L::kQuant ? p * vs[u] : p);
      }
      l[r] = l[r] * alpha + p_sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = warp * (kTile / kWarps) + (u0 + u) * L::kKeysPerStep +
                    lane / LPK;
      float vf[kCols];
      load_cols(vt + j * HD + col0, vf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[r][e] += pt[r][u] * vf[e];
    }
  }

  // Merge the lanes that own the same columns (their keys differ) and
  // write the warp's state. A lane that saw no key keeps m = -1e30 and
  // weighs 2^(-1e30 - M) = 0; if no lane did, M = -1e30, l = 0, acc = 0.
  __device__ __forceinline__ void store(float* sm_m, float* sm_l,
                                        float* sm_acc) {
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float mx = fmaxf(m[r], m_o);
        const float f = exp2f(m[r] - mx);
        const float f_o = exp2f(m_o - mx);
        l[r] = l[r] * f + l_o * f_o;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const float a_o = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
          acc[r][e] = acc[r][e] * f + a_o * f_o;
        }
        m[r] = mx;
      }
    }
    if (lane < LPK) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (lane == 0) {
          sm_m[warp * ROWS + r] = m[r];
          sm_l[warp * ROWS + r] = l[r];
        }
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          sm_acc[(warp * ROWS + r) * HD + col0 + e] = acc[r][e];
      }
    }
  }
};

// d += A . B over 16 of K for rows 0-7 of the m16 tile: A's rows 8-15
// are zero (a1 = a3 = 0) and their outputs are dropped, so they take no
// accumulator registers.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[2], uint32_t a0,
                                             uint32_t a2, uint32_t b0,
                                             uint32_t b1) {
  float z2, z3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %11};\n"
      : "+f"(d[0]), "+f"(d[1]), "=f"(z2), "=f"(z3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.0f),
        "f"(0.0f));
}
// The same over 8 of K.
__device__ __forceinline__ void mma_m16n8k8(float (&d)[2], uint32_t a0,
                                            uint32_t b0) {
  float z2, z3;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %7, %8};\n"
      : "+f"(d[0]), "+f"(d[1]), "=f"(z2), "=f"(z3)
      : "r"(a0), "r"(0u), "r"(b0), "f"(0.0f), "f"(0.0f));
}

// The tensor-core body (bf16 activations and cache): the tile's keys
// come in four groups of 8, and a warp takes each kSlots-th group. S =
// Q.K^T is an m16n8 product over HD (the ROWS query rows padded to 16
// with zeros, q's columns past hd zeros); its fragment gives thread
// (g = lane / 4, t = lane % 4) the scores of query row g at keys 2t and
// 2t + 1; p packed to bf16x2 in place is the A fragment of the m16n8k8
// products O += P.V, one for each 8 columns. K is read with ldmatrix and
// V with ldmatrix.trans from the ring's swizzled rows. A thread keeps
// (m, l, acc) of its row g: m shared by the quad, l over its own keys.
// At HD <= 128 warp w takes group w and every column. At HD 256 the
// fragments of all columns would not fit 255 registers, so the warps
// pair up (kCG = 2 column groups): warps 2s and 2s + 1 take groups s and
// s + 2, both compute the same scores (the same products, so the same
// m and l bit for bit), and each accumulates P.V into its half of the
// columns.
template <int HD, int ROWS>
struct MmaBody {
  using L = Layout<__nv_bfloat16, HD>;
  static constexpr int kCG = HD > 128 ? 2 : 1;     // column groups
  static constexpr int kSlots = kWarps / kCG;      // partial states
  static constexpr int kWarpCols = HD / kCG;       // columns a warp sums
  static_assert(kTile == 8 * kWarps, "four groups of 8 keys a tile");
  static_assert(ROWS <= 8, "query rows fit the m16 tile's first 8 rows");
  int warp, lane, slot, c0;
  uint32_t qa[HD / 16][2];  // A fragments: row g, columns 2t.. and 2t+8..
  float m, l;
  float acc[kWarpCols / 8][2];  // row g, columns c0 + 8n + 2t and + 1

  // As CoreBody::init: `rows` live rows of `hd` columns from q_rows.
  __device__ __forceinline__ void init(const __nv_bfloat16* q_rows, int hd,
                                       int rows) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    slot = warp / kCG;
    c0 = (warp % kCG) * kWarpCols;
    const int r = lane / 4;
    const bool live = r < rows;
    const __nv_bfloat16* qr = q_rows + (live ? r * hd : 0) + (lane % 4) * 2;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const bool in = live && 16 * ks < hd;  // hd is whole 16s
      qa[ks][0] = in ? *reinterpret_cast<const uint32_t*>(qr + 16 * ks) : 0u;
      qa[ks][1] =
          in ? *reinterpret_cast<const uint32_t*>(qr + 16 * ks + 8) : 0u;
    }
    m = kNegInf;
    l = 0.0f;
#pragma unroll
    for (int n = 0; n < kWarpCols / 8; ++n) acc[n][0] = acc[n][1] = 0.0f;
  }

  __device__ __forceinline__ void tile(const unsigned char*, uint32_t st,
                                       int p0, int end, float scale2) {
#pragma unroll
    for (int kg = 0; kg < kTile / 8; kg += kSlots)
      group(st, kg + slot, p0, end, scale2);
  }

  // Keys [8 kg, 8 kg + 8) of the tile: one online update.
  __device__ __forceinline__ void group(uint32_t st, int kg, int p0, int end,
                                        float scale2) {
    // The row this lane addresses for ldmatrix, and its swizzle.
    const int key = kg * 8 + (lane & 7);
    const uint32_t k_row = st + key * L::kRowBytes;
    const uint32_t v_row = k_row + L::kTileBytes;
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int kp = 0; kp < HD / 32; ++kp) {
      uint32_t bk[4];
      const int chunk = kp * 4 + (lane >> 3);
      ldmatrix_x4(k_row + ((chunk ^ (key & 7)) << 4), bk);
      mma_m16n8k16(s, qa[2 * kp][0], qa[2 * kp][1], bk[0], bk[1]);
      mma_m16n8k16(s, qa[2 * kp + 1][0], qa[2 * kp + 1][1], bk[2], bk[3]);
    }
    const int j = p0 + kg * 8 + (lane % 4) * 2;
    const bool live0 = j < end;
    const bool live1 = j + 1 < end;
    const float s0 = live0 ? s[0] * scale2 : kNegInf;
    const float s1 = live1 ? s[1] * scale2 : kNegInf;
    float mx = fmaxf(s0, s1);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    // Dead keys weigh 0 even while this row has seen no live key.
    const float e0 = live0 ? exp2f(s0 - m_new) : 0.0f;
    const float e1 = live1 ? exp2f(s1 - m_new) : 0.0f;
    l = l * alpha + (e0 + e1);
    m = m_new;
    const uint32_t pa = pack_bf16(e0, e1);  // T(p), the P.V input
#pragma unroll
    for (int np = 0; np < kWarpCols / 32; ++np) {
      uint32_t bv[4];
      const int chunk = c0 / 8 + np * 4 + (lane >> 3);
      ldmatrix_x4_trans(v_row + ((chunk ^ (key & 7)) << 4), bv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* a = acc[np * 4 + i];
        a[0] *= alpha;
        a[1] *= alpha;
        mma_m16n8k8(acc[np * 4 + i], pa, bv[i]);
      }
    }
  }

  // Write the slot's state: m and l from the pair's first warp (the
  // second holds the same), acc from each warp for its columns.
  __device__ __forceinline__ void store(float* sm_m, float* sm_l,
                                        float* sm_acc) {
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = lane / 4;
    if (r < ROWS) {
      if (lane % 4 == 0 && c0 == 0) {
        sm_m[slot * ROWS + r] = m;
        sm_l[slot * ROWS + r] = l;
      }
#pragma unroll
      for (int n = 0; n < kWarpCols / 8; ++n) {
        float* dst = sm_acc + (slot * ROWS + r) * HD + c0 + n * 8 +
                     (lane % 4) * 2;
        dst[0] = acc[n][0];
        dst[1] = acc[n][1];
      }
    }
  }
};

// T: activation type (q, out); KV: cache storage (T, or int8_t with f32
// scales [rows, kvh]). `partial` is the workspace when gridDim.x (the
// split count) is above 1, else unused: the CTA writes `out`. blockIdx.y
// is kv head g's row group: query heads g * n_rep + grp * ROWS + r.
// kExact: hd == HD, known at compile time. With bf16 activations (the
// serving dtype) every bucket has both builds: with hd at run time the
// strides, the copy predicates and the output loop cost 5-16 % at
// Llama-3-8B's shapes (hd 128) with a bf16 cache and 4-7 % with an int8
// one, where the exact build matches the kernel that took only hd 64 and
// 128 (decode_attention_ablation.py). fp32 activations, which only the
// tests and the reference paths run, take the run-time build alone.
template <typename T, typename KV, int HD, int ROWS, bool kExact,
          typename Keys>
__global__ void __launch_bounds__(kThreads, min_blocks<KV, HD, ROWS>())
decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k_cache,
                    const KV* __restrict__ v_cache,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, Keys keys,
                    T* __restrict__ out, float* __restrict__ partial,
                    int kvh, int hd_arg, int n_rep, int groups, int chunk,
                    float scale) {
  const int hd = kExact ? HD : hd_arg;
  using L = Layout<KV, HD>;
  using Body = typename std::conditional<L::kMma, MmaBody<HD, ROWS>,
                                         CoreBody<T, KV, HD, ROWS>>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int g = blockIdx.y / groups;  // kv head
  const int head0 = g * n_rep + (blockIdx.y % groups) * ROWS;
  const int rows = min(ROWS, (g + 1) * n_rep - head0);  // live rows
  const int b = blockIdx.z;
  const int h = kvh * n_rep;
  const int copies = hd * static_cast<int>(sizeof(KV)) / 16;

  // Let the combine's CTAs launch as this grid's CTAs retire; they wait
  // for the whole grid before they read the workspace.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  int length = keys.length(b);
  // Past the table the walk would read rows the slot does not own; a
  // violation poisons the row's output with NaN instead of reading out
  // of bounds.
  const bool overflow = length > keys.capacity();
  if (overflow) length = keys.capacity();
  const int start = split * chunk;
  // No live key in this split: the combine skips it. A lone split still
  // runs, to write its row (zeros for a length of 0).
  if (splits > 1 && start >= length) return;
  const int end = min(start + chunk, length);
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;
  const uint32_t ring =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // Scores in log2 units: exp2 of them is the softmax's exp.
  const float scale2 = scale * kLog2e;

  // Tile i's rows are looked up one issue ahead of its copies.
  TileRows<KV, HD> tr = tile_rows<KV, HD>(keys, b, start, end);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_tile<KV, HD>(ring + s * L::kStageBytes, tr, k_cache, v_cache,
                        k_scale, v_scale, g, kvh, hd, copies);
      if (s + 1 < n_tiles)
        tr = tile_rows<KV, HD>(keys, b, start + (s + 1) * kTile, end);
    }
    cp_async_commit();
  }

  Body body;
  body.init(q + (static_cast<size_t>(b) * h + head0) * hd, hd, rows);

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t has landed for every thread; every thread is past tile
    // t - 1, whose stage the next copies overwrite.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < n_tiles) {
      load_tile<KV, HD>(ring + (next % kStages) * L::kStageBytes, tr,
                        k_cache, v_cache, k_scale, v_scale, g, kvh, hd,
                        copies);
      if (next + 1 < n_tiles)
        tr = tile_rows<KV, HD>(keys, b, start + (next + 1) * kTile, end);
    }
    cp_async_commit();
    const int stage = (t % kStages) * L::kStageBytes;
    body.tile(smem + stage, ring + stage, start + t * kTile, end, scale2);
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' states
  constexpr int kSlots = Body::kSlots;
  float* sm_m = reinterpret_cast<float*>(smem);  // [kSlots][ROWS]
  float* sm_l = sm_m + kSlots * ROWS;             // [kSlots][ROWS]
  float* sm_acc = sm_l + kSlots * ROWS;           // [kSlots][ROWS][HD]
  body.store(sm_m, sm_l, sm_acc);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    if (r >= rows || d >= hd) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kSlots; ++w) mx = fmaxf(mx, sm_m[w * ROWS + r]);
    float l_tot = 0.0f, a_tot = 0.0f;
#pragma unroll
    for (int w = 0; w < kSlots; ++w) {
      const float f = exp2f(sm_m[w * ROWS + r] - mx);
      l_tot += sm_l[w * ROWS + r] * f;
      a_tot += sm_acc[(w * ROWS + r) * HD + d] * f;
    }
    const size_t row = static_cast<size_t>(b) * h + head0 + r;
    if (splits == 1) {
      float o = a_tot / fmaxf(l_tot, 1e-30f);
      if (overflow) o = __int_as_float(0x7fc00000);  // NaN
      out[row * hd + d] = from_f32<T>(o);
    } else {
      float* dst = partial + (row * splits + split) * (hd + 2);
      dst[d] = a_tot;
      if (d == 0) {
        dst[hd] = mx;
        dst[hd + 1] = l_tot;
      }
    }
  }
}

// One CTA per (query head, batch row), a thread per column of the hd =
// blockDim.x (HDX when it is not 0, the split kernel's exact build):
// merges the row's live splits (those that start below its length) in
// split order. Launched as a programmatic dependent of the split
// kernel: it reads the length, then waits for that grid, then loads
// every live split's (m, l, acc[d]) at once (one round trip to L2)
// before it merges.
template <typename T, int HDX, typename Keys>
__global__ void __launch_bounds__(kMaxHeadDim)
decode_combine_kernel(const float* __restrict__ partial, Keys keys,
                      T* __restrict__ out, int splits, int chunk) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int hd = HDX ? HDX : blockDim.x;
  int length = keys.length(b);
  const bool overflow = length > keys.capacity();
  if (overflow) length = keys.capacity();
  const int live = min((length + chunk - 1) / chunk, splits);
  const size_t row = static_cast<size_t>(b) * gridDim.x + head;
  const float* src = partial + row * splits * (hd + 2);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float m[kMaxSplits], l[kMaxSplits], a[kMaxSplits];
#pragma unroll
  for (int i = 0; i < kMaxSplits; ++i) {
    m[i] = kNegInf;
    l[i] = a[i] = 0.0f;
    if (i < live) {
      m[i] = src[i * (hd + 2) + hd];
      l[i] = src[i * (hd + 2) + hd + 1];
      a[i] = src[i * (hd + 2) + d];
    }
  }
  float mx = kNegInf;
#pragma unroll
  for (int i = 0; i < kMaxSplits; ++i) mx = fmaxf(mx, m[i]);
  float l_tot = 0.0f, a_tot = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxSplits; ++i) {
    if (i < live) {
      const float f = exp2f(m[i] - mx);
      l_tot += l[i] * f;
      a_tot += a[i] * f;
    }
  }
  float o = a_tot / fmaxf(l_tot, 1e-30f);
  if (overflow) o = __int_as_float(0x7fc00000);  // NaN
  out[row * hd + d] = from_f32<T>(o);
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
  float* partial;  // [batch, h, splits, hd + 2] fp32 when splits > 1
  int batch;
  int kvh;
  int hd;
  int n_rep;
  int groups;  // row groups a kv head: ceil(n_rep / ROWS)
  int splits;
  int chunk;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int HD, int ROWS, typename Keys>
cudaError_t launch(const Args<Keys>& a) {
  constexpr int smem = smem_bytes<KV, HD, ROWS>();
  constexpr bool kHasExact = std::is_same<T, __nv_bfloat16>::value;
  const bool exact = kHasExact && a.hd == HD;
  const auto split_kernel =
      exact ? decode_split_kernel<T, KV, HD, ROWS, kHasExact, Keys>
            : decode_split_kernel<T, KV, HD, ROWS, false, Keys>;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  split_kernel<<<dim3(a.splits, a.kvh * a.groups, a.batch), kThreads, smem,
                 a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scale, a.v_scale, a.keys,
      static_cast<T*>(a.out), a.partial, a.kvh, a.hd, a.n_rep, a.groups,
      a.chunk, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.kvh * a.n_rep, a.batch);
  cfg.blockDim = dim3(a.hd);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg,
                            exact ? decode_combine_kernel<T, kHasExact ? HD
                                                                   : 0, Keys>
                                  : decode_combine_kernel<T, 0, Keys>,
                            static_cast<const float*>(a.partial), a.keys,
                            static_cast<T*>(a.out), a.splits, a.chunk);
}

template <typename T, typename KV, int HD, typename Keys>
cudaError_t by_rows(int rows, const Args<Keys>& a) {
  switch (rows) {
    case 2: return launch<T, KV, HD, 2>(a);
    case 4: return launch<T, KV, HD, 4>(a);
    case 8: return launch<T, KV, HD, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The head-dim bucket: the smallest of 64, 128 and 256 that holds hd.
template <typename T, typename KV, typename Keys>
cudaError_t by_hd(int rows, const Args<Keys>& a) {
  if (a.hd <= 64) return by_rows<T, KV, 64>(rows, a);
  if (a.hd <= 128) return by_rows<T, KV, 128>(rows, a);
  return by_rows<T, KV, 256>(rows, a);
}

// dtype: the activation code of common.cuh; kv_int8: 0 for a cache of
// the activation type, 1 for int8 with f32 scales; head_dim a multiple
// of 16 from 16 to 256; rows: the query rows a CTA holds (2, 4 or 8),
// any n_rep >= 1 running in ceil(n_rep / rows) groups. `key_range`:
// the positions the plan must cover (the table's capacity, or the
// length).
template <typename Keys>
cudaError_t dispatch(int dtype, int kv_int8, int head_dim, int n_rep,
                     int rows, long long key_range, Args<Keys> a) {
  if (a.batch == 0) return cudaSuccess;
  if (head_dim < 16 || head_dim > kMaxHeadDim || head_dim % 16 ||
      n_rep < 1 || !(rows == 2 || rows == 4 || rows == 8))
    return cudaErrorInvalidValue;
  a.hd = head_dim;
  a.n_rep = n_rep;
  a.groups = (n_rep + rows - 1) / rows;
  if (a.batch < 0 || a.batch > 65535 || a.kvh < 1 ||
      static_cast<long long>(a.kvh) * a.groups > 65535 ||
      static_cast<long long>(a.kvh) * n_rep > 65535)
    return cudaErrorInvalidValue;
  if (a.splits < 1 || a.splits > kMaxSplits || a.chunk < 1 ||
      static_cast<long long>(a.splits) * a.chunk < key_range ||
      (a.splits > 1 && a.partial == nullptr))
    return cudaErrorInvalidValue;
  if (kv_int8 && (a.k_scale == nullptr || a.v_scale == nullptr))
    return cudaErrorInvalidValue;
  switch (dtype * 2 + (kv_int8 ? 1 : 0)) {
    case kFloat32 * 2:
      return by_hd<float, float>(rows, a);
    case kFloat32 * 2 + 1:
      return by_hd<float, int8_t>(rows, a);
    case kBFloat16 * 2:
      return by_hd<__nv_bfloat16, __nv_bfloat16>(rows, a);
    case kBFloat16 * 2 + 1:
      return by_hd<__nv_bfloat16, int8_t>(rows, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace attention
}  // namespace tpu_dra
