// MLA paged decode attention for Hopper (sm_90a).
//
// Replaces gllm_tpu/ops/pallas/decode_attention.py::paged_decode_attention
// with v_cache=None (K2m): one query row of 16 heads per sequence over its
// paged latent context, values = the latent row's leading v_dim lanes, over
// a latent in q's dtype or in fp8. The kernels, what bounds them and their
// design are in mla_attention.cuh.

#include "mla_attention.cuh"

// q [S, 16, latent_dim], latent cache [P, page, 1, latent_dim] in q's
// dtype or fp8 (cache code `cache`), kv_lens [S] i32, page_table
// [S, max_pages] i32, out [S, 16, v_dim]; all contiguous on one device.
// (latent_dim, v_dim) is (576, 512) or (96, 64). Each split covers `chunk`
// keys (a multiple of 32, spanning at most 255 pages) and num_splits *
// chunk >= max_pages * page; `part` is scratch of kCounterSlots int32
// split counters, zero and left zero, then S * 16 * num_splits * (v_dim +
// 2) float32 partials (unused, and may be null, when num_splits == 1).
// Returns cudaGetLastError() after the launches.
extern "C" int gllm_mla_decode_attention(
    const void* q, const void* latent, const void* kv_lens,
    const void* page_table, void* out, void* part, int S, int max_pages,
    int latent_dim, int v_dim, int page_size, int page_offset, int chunk,
    int num_splits, float scale, int dtype, int cache, void* stream) {
  using namespace gllm;
  if (!decode_args_ok(S, kMlaHeads, 1, max_pages, page_size, chunk,
                      num_splits, part))
    return (int)cudaErrorInvalidValue;
  const int rc = dispatch_mla(
      dtype, cache, latent_dim, v_dim,
      [&](auto t, auto tc, auto dl, auto dv) {
        return launch_mla<decltype(t), decltype(tc), decltype(dl)::value,
                          decltype(dv)::value, true, false>(
            q, latent, nullptr, static_cast<const int*>(kv_lens),
            static_cast<const int*>(page_table), out,
            static_cast<float*>(part), S, S, max_pages, page_size,
            page_offset, chunk, num_splits, scale,
            static_cast<cudaStream_t>(stream));
      });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
