// Ragged paged attention for Hopper (sm_90a).
//
// Replaces gllm_tpu/ops/pallas/ragged_attention.py::ragged_paged_attention
// in its non-unified GQA mode, with a full-precision cache (K1), an int8
// cache with per-page, per-kv-head float32 scales (K1q, `k_scale`/`v_scale`
// there) or an fp8 cache (the runner's float8_e4m3fn). The kernels, what
// bounds them and their design are in ragged_attention.cuh.

#include "ragged_attention.cuh"

// q [T, Hq, D], k/v cache [P, page, Hkv, D] of cache code `cache`: q's
// dtype, int8 with k_scale/v_scale [P, Hkv] float32, or fp8 (e4m3; the
// scales are null but for int8),
// cu_q_lens [S+1] i32, kv_lens [S] i32, page_table [S, max_pages] i32,
// out [T, Hq, D]; all contiguous on one device. Returns cudaGetLastError()
// after the launch.
extern "C" int gllm_ragged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* cu_q_lens,
    const void* kv_lens, const void* page_table, void* out, int num_tokens,
    int S, int max_pages, int num_q_heads, int num_kv_heads, int head_dim,
    int page_size, int page_offset, float scale, int dtype, int cache,
    void* stream) {
  using namespace gllm;
  if (!ragged_args_ok(num_tokens, S, num_q_heads, num_kv_heads) ||
      !scales_ok(cache, k_scale, v_scale))
    return (int)cudaErrorInvalidValue;
  const int rc = dispatch_types<true>(
      dtype, cache, head_dim, [&](auto t, auto tc, auto d) {
        using T = decltype(t);
        using TC = decltype(tc);
        return launch_ragged<T, TC, decltype(d)::value, false>(
            q, k_cache, v_cache, static_cast<const float*>(k_scale),
            static_cast<const float*>(v_scale),
            static_cast<const int*>(cu_q_lens),
            static_cast<const int*>(kv_lens),
            static_cast<const int*>(page_table), out, num_tokens, S,
            max_pages, num_q_heads, num_kv_heads, page_size, page_offset,
            scale, static_cast<cudaStream_t>(stream));
      });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
