// Contiguous-cache decode attention for Hopper (sm_90a).
//
// Replaces: tpu_dra/workloads/ops/attention.py `_decode_kernel`
// (wrapper `_pallas_decode_attention`, pallas_call at :889): the s=1
// step of the fixed-batch greedy_generate path. One query per batch
// row; GQA over that row's cache k/v [b, max_seq, kvh, hd] of the
// activation type, or int8 with f32 per-(token, kv head) scales
// [b, max_seq, kvh]; keys [0, length) are live, one length for every
// row, as the Pallas kernel's scalar-prefetched length. A length of 0
// gives exact zeros; a length past max_seq is refused by the wrapper,
// which holds the length on the host.
//
// What bounds it on an H100: bytes, as for the paged kernel (one K and
// one V row per live token and kv head, ~1 flop per byte in bf16).
//
// Design: the Pallas grid is (b * kvh,), one program per (batch row,
// kv head) with its n_rep query rows and a loop over key blocks up to
// the length. One CTA per pair leaves half the H100 idle at b=8 and all
// but 8 SMs with one row, so here the keys [0, length) are split over
// CTAs and merged by a combine kernel in a fixed order (flash-decoding;
// the body is shared with paged_decode.cu in decode_attention.cuh and
// differs only in how key p is addressed: row b * max_seq + p instead
// of a block-table lookup). The split plan covers the host length.

#include "decode_attention.cuh"

// q [batch, kvh*n_rep, head_dim]; k/v [batch, max_seq, kvh, head_dim] of
// q's type (kv_int8 = 0) or int8 (kv_int8 = 1, with k_scale/v_scale
// [batch, max_seq, kvh] f32); head_dim a multiple of 16 from 16 to 256;
// any n_rep, `rows` (2, 4 or 8: ops/attention.py `decode_groups`) query
// rows a CTA; 0 <= length <= max_seq; out like q; partial: fp32 workspace
// [batch, kvh*n_rep, splits, head_dim + 2] when splits > 1 (splits *
// chunk must cover length). Returns the cudaError_t of the launches.
extern "C" int tpu_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, void* partial, int dtype, int kv_int8,
    int batch, int kvh, int n_rep, int rows, int head_dim, int max_seq,
    int length, int splits, int chunk, float scale, void* stream) {
  using namespace tpu_dra::attention;
  if (max_seq < 1 || length < 0 || length > max_seq)
    return cudaErrorInvalidValue;
  const ContiguousKeys keys{length, max_seq};
  const Args<ContiguousKeys> a{q, k, v,
                               static_cast<const float*>(k_scale),
                               static_cast<const float*>(v_scale), keys, out,
                               static_cast<float*>(partial), batch, kvh,
                               0, 0, 0, splits, chunk, scale,
                               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kv_int8, head_dim, n_rep, rows, length, a);
}
