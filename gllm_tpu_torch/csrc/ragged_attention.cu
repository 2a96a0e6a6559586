// Ragged paged attention for Hopper (sm_90a): K1 and K1u.
//
// Replaces gllm_tpu/ops/pallas/ragged_attention.py::ragged_paged_attention
// in its GQA modes, unified=False (K1) and unified=True (K1u), with a
// full-precision cache, an int8 cache with per-page, per-kv-head float32
// scales (`k_scale`/`v_scale` there) or an fp8 cache (the runner's
// float8_e4m3fn). ONE call serves every paged step (decode, mixed and
// prefill batches).
//
// As in the TPU kernel's unified mode, blocks are specialised per row
// class, found on the device from cu_q_lens alone (decode_prefix_len, the
// counterpart of _decode_prefix_len), so the wrapper makes no host sync:
// - the batch's decode prefix (the longest run of one-token sequences at
//   its head, where token s is sequence s) runs the split-KV decode blocks
//   of decode_attention.cuh: one block per (sequence, kv head, split), the
//   G query heads of a kv head are the rows of its tensor-core products
//   and share every K/V row, small batches still fill the SMs, and the
//   last split of a row merges the row's splits;
// - every other sequence (prefill chunks, one-token rows after the first
//   chunk, padding) runs the ragged blocks of ragged_wgmma.cuh (wgmma,
//   bf16 / fp16) or ragged_attention.cuh (float32).
// K1 and K1u run the same code on the card; only their plain versions
// differ. The TPU kernel rescales its unified online softmax AMLA's way
// (_online_update, _rescale_add): the running max is rounded up to an
// integer in the log2 domain, so each rescale is an integer add on the
// exponent field instead of a multiply. On the card a multiply costs no
// more, and the rounded-up max costs accuracy: the tensor-core blocks
// round the probabilities to bf16 / fp16, and under the classic running
// max each row's largest probability is exactly 1, which rounds exactly,
// where AMLA's lies in (0.5, 1] and does not. So both classes rescale the
// classic way, with exp2f; K1u is held to the plain version, which keeps
// AMLA's math. Rows in any order give the right result; only the speed
// depends on the decode prefix.

#include "ragged_wgmma.cuh"

// q [T, Hq, D], k/v cache [P, page, Hkv, D] of cache code `cache`: q's
// dtype, int8 with k_scale/v_scale [P, Hkv] float32, or fp8 (e4m3; the
// scales are null but for int8),
// cu_q_lens [S+1] i32, kv_lens [S] i32, page_table [S, max_pages] i32,
// out [T, Hq, D]; all contiguous on one device. Head dims 32, 64, 128, and
// 256 over a full-precision or an fp8 cache. The decode blocks cover
// `chunk` keys each (a multiple of 32, spanning at most 255 pages),
// num_splits * chunk >= max_pages * page, and `part` is the decode blocks'
// scratch as gllm_decode_attention takes it (may be null when num_splits
// == 1). Returns cudaGetLastError() after the launches.
extern "C" int gllm_ragged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* cu_q_lens,
    const void* kv_lens, const void* page_table, void* out, void* part,
    int num_tokens, int S, int max_pages, int num_q_heads, int num_kv_heads,
    int head_dim, int page_size, int page_offset, int chunk, int num_splits,
    float scale, int dtype, int cache, int decode_only, void* stream) {
  using namespace gllm;
  if (!ragged_args_ok(num_tokens, S, num_q_heads, num_kv_heads) ||
      !decode_args_ok(S, num_q_heads, num_kv_heads, max_pages, page_size,
                      chunk, num_splits, part) ||
      !scales_ok(cache, k_scale, v_scale))
    return (int)cudaErrorInvalidValue;
  const int rc = dispatch_types<true>(
      dtype, cache, head_dim, [&](auto t, auto tc, auto d) {
        using T = decltype(t);
        using TC = decltype(tc);
        return launch_paged_step<T, TC, decltype(d)::value>(
            q, k_cache, v_cache, static_cast<const float*>(k_scale),
            static_cast<const float*>(v_scale),
            static_cast<const int*>(cu_q_lens),
            static_cast<const int*>(kv_lens),
            static_cast<const int*>(page_table), out,
            static_cast<float*>(part), num_tokens, S, max_pages,
            num_q_heads, num_kv_heads, page_size, page_offset, chunk,
            num_splits, scale, decode_only != 0,
            static_cast<cudaStream_t>(stream));
      });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
