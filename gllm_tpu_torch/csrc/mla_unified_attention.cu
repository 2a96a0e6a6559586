// Unified-step MLA paged attention for Hopper (sm_90a).
//
// Replaces gllm_tpu/ops/pallas/ragged_attention.py::ragged_paged_attention
// with unified=True and v_cache=None (K1um): ONE call serves every step of
// the unified engine (decode, mixed and prefill batches) of an MLA model,
// over the latent cache [P, page, 1, DL] whose values are each row's
// leading DV lanes, in q's dtype or in fp8. It is to the MLA kernels (K1m,
// K2m) what ragged_attention.cu is to K1 / K1u and K2. Bound on the card: bytes
// for the decode rows, operations for the prefill chunks (see
// mla_attention.cuh).
//
// As in ragged_attention.cu, the batch's decode prefix is found on the
// device from cu_q_lens (decode_prefix_len, paged_kv.cuh) and the wrapper
// makes no host sync:
// - the decode prefix runs K2m's split-KV decode blocks (one 16-head token
//   per block and split of its keys; the last split of a token merges its
//   splits);
// - every other sequence (prefill chunks, one-token rows after the first
//   chunk, padding) runs K1m's ragged blocks.
// The two classes write disjoint output rows and read disjoint sequences.
// Both rescale the online softmax the classic way, not AMLA's (see
// ragged_attention.cu for why); they are held to the plain version, which
// keeps AMLA's math.

#include "mla_attention.cuh"

// q [T, 16, latent_dim], latent cache [P, page, 1, latent_dim] in q's dtype
// or fp8 (cache code `cache`), cu_q_lens [S+1] i32, kv_lens [S] i32,
// page_table [S, max_pages] i32, out [T, 16, v_dim]; all contiguous on one
// device. (latent_dim, v_dim) is (576, 512) or (96, 64). The decode blocks
// cover `chunk` keys each (a multiple of 32, spanning at most 255 pages),
// num_splits * chunk >= max_pages * page, and `part` is the decode blocks'
// scratch as gllm_mla_decode_attention takes it (may be null when
// num_splits == 1). `decode_only`: every sequence has one token (a
// pure-decode step, T == S), so the decode blocks take every row, those of
// padding sequences included, and the ragged blocks, which would find no
// work, are not launched. Returns cudaGetLastError() after the launches.
extern "C" int gllm_mla_unified_attention(
    const void* q, const void* latent, const void* cu_q_lens,
    const void* kv_lens, const void* page_table, void* out, void* part,
    int num_tokens, int S, int max_pages, int latent_dim, int v_dim,
    int page_size, int page_offset, int chunk, int num_splits, float scale,
    int dtype, int cache, int decode_only, void* stream) {
  using namespace gllm;
  if (num_tokens <= 0 ||
      !decode_args_ok(S, kMlaHeads, 1, max_pages, page_size, chunk,
                      num_splits, part))
    return (int)cudaErrorInvalidValue;
  const int* cu = static_cast<const int*>(cu_q_lens);
  const int* kl = static_cast<const int*>(kv_lens);
  const int* pt = static_cast<const int*>(page_table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = dispatch_mla(
      dtype, cache, latent_dim, v_dim,
      [&](auto t, auto tc, auto dl, auto dv) {
        using T = decltype(t);
        using TC = decltype(tc);
        constexpr int DL = decltype(dl)::value;
        constexpr int DV = decltype(dv)::value;
        const int r = launch_mla<T, TC, DL, DV, true, true>(
            q, latent, decode_only ? nullptr : cu, kl, pt, out,
            static_cast<float*>(part),
            num_tokens, S, max_pages, page_size, page_offset, chunk,
            num_splits, scale, st);
        if (r != 0 || decode_only) return r;
        return launch_mla<T, TC, DL, DV, false, true>(
            q, latent, cu, kl, pt, out, nullptr, num_tokens, S, max_pages,
            page_size, page_offset, 0, 1, scale, st);
      });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
