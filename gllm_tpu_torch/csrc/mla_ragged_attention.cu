// MLA ragged paged attention for Hopper (sm_90a).
//
// Replaces gllm_tpu/ops/pallas/ragged_attention.py::ragged_paged_attention
// with v_cache=None, non-unified (K1m): a packed ragged batch of query
// tokens (16 heads each) attends causally over each sequence's paged latent
// context, values = the latent row's leading v_dim lanes, over a latent in
// q's dtype or in fp8. The kernels, what bounds them and their design are
// in mla_attention.cuh.

#include "mla_attention.cuh"

// q [T, 16, latent_dim], latent cache [P, page, 1, latent_dim] in q's dtype
// or fp8 (cache code `cache`), cu_q_lens [S+1] i32, kv_lens [S] i32,
// page_table [S, max_pages] i32, out [T, 16, v_dim]; all contiguous on one
// device. (latent_dim, v_dim) is
// (576, 512) or (96, 64). Returns cudaGetLastError() after the launch.
extern "C" int gllm_mla_ragged_attention(
    const void* q, const void* latent, const void* cu_q_lens,
    const void* kv_lens, const void* page_table, void* out, int num_tokens,
    int S, int max_pages, int latent_dim, int v_dim, int page_size,
    int page_offset, float scale, int dtype, int cache, void* stream) {
  using namespace gllm;
  if (num_tokens <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int rc = dispatch_mla(
      dtype, cache, latent_dim, v_dim,
      [&](auto t, auto tc, auto dl, auto dv) {
        return launch_mla<decltype(t), decltype(tc), decltype(dl)::value,
                          decltype(dv)::value, false, false>(
            q, latent, static_cast<const int*>(cu_q_lens),
            static_cast<const int*>(kv_lens),
            static_cast<const int*>(page_table), out, nullptr, num_tokens, S,
            max_pages, page_size, page_offset, 0, 1, scale,
            static_cast<cudaStream_t>(stream));
      });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
