// Paged decode attention for Hopper (sm_90a).
//
// Replaces gllm_tpu/ops/pallas/decode_attention.py::paged_decode_attention
// (GQA) with a full-precision cache (K2), an int8 cache with per-page,
// per-kv-head float32 scales (K2q, `k_scale`/`v_scale` there) or an fp8
// cache (the runner's float8_e4m3fn). The kernels, what bounds them and
// their design are in decode_attention.cuh.

#include "decode_attention.cuh"

// q [S, Hq, D], k/v cache [P, page, Hkv, D] of cache code `cache`: q's
// dtype, int8 with k_scale/v_scale [P, Hkv] float32, or fp8 (e4m3; the
// scales are null but for int8),
// kv_lens [S] i32, page_table [S, max_pages] i32, out [S, Hq, D]; all
// contiguous on one device. Each split covers `chunk` keys (a multiple of
// 32, spanning at most 255 pages) and num_splits * chunk >= max_pages *
// page; `part` is scratch of kCounterSlots int32 split counters, zero and
// left zero, then S * Hq * num_splits * (D + 2) float32 partials (unused,
// and may be null, when num_splits == 1). Returns cudaGetLastError() after
// the launches.
extern "C" int gllm_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* kv_lens,
    const void* page_table, void* out, void* part, int S, int max_pages,
    int num_q_heads, int num_kv_heads, int head_dim, int page_size,
    int page_offset, int chunk, int num_splits, float scale, int dtype,
    int cache, void* stream) {
  using namespace gllm;
  if (!decode_args_ok(S, num_q_heads, num_kv_heads, max_pages, page_size,
                      chunk, num_splits, part) ||
      !scales_ok(cache, k_scale, v_scale))
    return (int)cudaErrorInvalidValue;
  const int rc = dispatch_types<true>(
      dtype, cache, head_dim, [&](auto t, auto tc, auto d) {
        using T = decltype(t);
        using TC = decltype(tc);
        return launch_decode<T, TC, decltype(d)::value, false>(
            q, k_cache, v_cache, static_cast<const float*>(k_scale),
            static_cast<const float*>(v_scale), nullptr,
            static_cast<const int*>(kv_lens),
            static_cast<const int*>(page_table), out,
            static_cast<float*>(part), S, max_pages, num_q_heads,
            num_kv_heads, page_size, page_offset, chunk, num_splits, scale,
            static_cast<cudaStream_t>(stream));
      });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
