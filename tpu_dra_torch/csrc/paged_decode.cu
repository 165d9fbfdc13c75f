// Paged-decode attention for Hopper (sm_90a).
//
// Replaces: tpu_dra/workloads/ops/attention.py `_paged_decode_kernel`
// (wrapper `_pallas_paged_decode_attention`, pallas_call at :1245), both
// of its branches: pools of the activation type, and int8 pools with f32
// per-(token, kv head) scale pools [num_pages, page, kvh].
// One query per slot; GQA over a shared page pool
// k/v [num_pages, page, kvh, hd] through each slot's block table
// tables [B, max_pages]; keys at positions >= lengths[b] are dead.
// The kernel body and its numerics are in decode_attention.cuh; a slot
// of length 0 gives exact zeros.
//
// What bounds it on an H100: bytes. Each live token costs one K row and
// one V row per kv head (4 KB per token per layer at Llama-3-8B widths
// in bf16, 2 KB plus 16 bytes of scales in int8) and about 4*n_rep*hd
// flops against them: ~1 flop per byte in bf16 and ~2 in int8, far
// below the ~295 flops per byte where bf16 tensor cores become the
// limit. Reading at the memory rate takes most of the 132 SMs and many
// bytes in flight on each.
//
// Design. On the TPU the grid walks table entries in order and carries
// (m, l, acc) in VMEM from step to step; on the GPU blocks run in no
// order and nothing carries between them. One CTA per (slot, kv head)
// gave 64 CTAs at the 8B decode shape, half the card. So the keys of a
// slot are split over CTAs (flash-decoding, decode_attention.cuh):
// each CTA streams a chunk of the slot's pages through a cp.async ring,
// the copies gathering rows through the block table, and writes a
// partial softmax state that a combine kernel merges in a fixed order.
// The split plan covers the table's capacity (max_pages * page), a
// host-known value, so the wrapper never reads the lengths: CTAs past a
// slot's length exit at once, and the combine reads the length on the
// device to merge only the live splits.

#include "decode_attention.cuh"

// q [batch, kvh*n_rep, head_dim]; k/v pools [P, page, kvh, head_dim] of
// q's type (kv_int8 = 0) or int8 (kv_int8 = 1, with k_scale/v_scale
// pools [P, page, kvh] f32); tables [batch, max_pages] int32; lengths
// [batch] int32; out [batch, kvh*n_rep, head_dim]; partial: fp32
// workspace [batch, kvh*n_rep, splits, head_dim + 2] when splits > 1
// (splits * chunk must cover max_pages * page). Returns the
// cudaError_t of the launches.
extern "C" int tpu_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* partial, int dtype, int kv_int8,
    int batch, int kvh, int n_rep, int head_dim, int page, int max_pages,
    int splits, int chunk, float scale, void* stream) {
  using namespace tpu_dra::attention;
  if (page < 1 || max_pages < 1) return cudaErrorInvalidValue;
  int shift = -1;
  if ((page & (page - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < page) ++shift;
  }
  const PagedKeys keys{static_cast<const int*>(tables),
                       static_cast<const int*>(lengths), page, max_pages,
                       shift};
  const Args<PagedKeys> a{q, k_pages, v_pages,
                          static_cast<const float*>(k_scale),
                          static_cast<const float*>(v_scale), keys, out,
                          static_cast<float*>(partial), batch, kvh, splits,
                          chunk, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kv_int8, head_dim, n_rep,
                  static_cast<long long>(max_pages) * page, a);
}
