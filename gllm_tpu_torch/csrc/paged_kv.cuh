// Paged KV addressing and tile loads shared by the attention kernels.
//
// Counterpart of gllm_tpu/ops/pallas/paged_kv.py (make_fetch_fns,
// block_kv): the cache layout [num_pages, page_size, num_kv_heads,
// head_dim] and the page-table -> address rule live here and nowhere
// else. A kernel gets ONE flat cache covering every layer ([L*P, page,
// Hkv, D]); `page_offset` (= layer * P) is added to every page id it reads
// from the page table, so the page table itself stays per-model.
//
// int8 caches (kv_cache_dtype="int8") carry one float32 scale per page and
// kv head, [L*P, Hkv], addressed with the same page_offset; a stored value
// x dequantizes to x * scale[page, h] (block_kv's rule). int8 -> float is
// exact, so every kernel dequantizes with one float32 multiply, as the
// plain versions do.
// fp8 caches (kv_cache_dtype="fp8", e4m3) carry no scale: the write path
// rounds each value once, and every kernel widens what it reads, which is
// exact (bf16 and fp16 hold every e4m3 value; NaN stays NaN), as block_kv
// widens its tiles to float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace gllm {

// dtype codes shared with the Python wrappers (ops/cuda/build.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };
// cache codes shared with the Python wrappers: the cache holds q's dtype,
// int8 with per-page scales, or fp8 (e4m3) without scales
enum CacheCode : int { kCacheNative = 0, kCacheInt8 = 1, kCacheFp8 = 2 };

using fp8_t = __nv_fp8_e4m3;

template <typename TC>
__host__ __device__ constexpr bool is_q8() {
  return std::is_same<TC, int8_t>::value;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_float(fp8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// Page id (offset into the flat cache) holding key j of a sequence.
__device__ __forceinline__ int64_t kv_page(const int* pt_row, int j,
                                           int page_size, int page_offset) {
  return (int64_t)pt_row[j / page_size] + page_offset;
}

// Element offset of (key j of a sequence, kv head h, dim 0) in the cache.
// 64-bit: a whole-model cache holds more than 2^31 elements.
__device__ __forceinline__ int64_t kv_row_offset(const int* pt_row, int j,
                                                 int page_size,
                                                 int page_offset,
                                                 int num_kv_heads,
                                                 int head_dim, int h) {
  const int64_t page = kv_page(pt_row, j, page_size, page_offset);
  const int64_t slot = page * page_size + (j % page_size);
  return (slot * num_kv_heads + h) * head_dim;
}

// 16-byte vector of T, converted to float element by element.
template <typename T>
struct Chunk {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(float* dst, const T* src) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_float(e[i]);
  }
};

// Load keys [j0, j0 + rows) of one sequence and kv head `h` from the paged
// cache into shared memory as float, row stride `ld`; an int8 cache is
// dequantized with its page's scale (`scale` is unused, and may be null,
// for a full-precision cache). Rows at or past `n_valid` are zero-filled:
// the kernels never read a key (or its scale) at or beyond kv_len,
// whatever the padded page table holds, and a zero row keeps a masked
// (p = 0) key from multiplying garbage.
template <typename TC, int D>
__device__ __forceinline__ void load_kv_tile(float* dst, int ld,
                                             const TC* cache,
                                             const float* scale,
                                             const int* pt_row, int j0,
                                             int rows, int n_valid,
                                             int page_size, int page_offset,
                                             int num_kv_heads, int h) {
  constexpr int CH = Chunk<TC>::N;
  constexpr int CPR = D / CH;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CPR; c += blockDim.x) {
    const int r = c / CPR;
    const int col = (c % CPR) * CH;
    float* d = dst + r * ld + col;
    if (r < n_valid) {
      const int j = j0 + r;
      const int64_t page = kv_page(pt_row, j, page_size, page_offset);
      const int64_t off =
          ((page * page_size + j % page_size) * num_kv_heads + h) * D;
      Chunk<TC>::load(d, cache + off + col);
      if constexpr (is_q8<TC>()) {
        const float s = scale[page * num_kv_heads + h];
#pragma unroll
        for (int i = 0; i < CH; ++i) d[i] *= s;
      }
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) d[i] = 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr float kLog2e = 1.4426950408889634f;

// ---- unified step (gllm_tpu/ops/pallas/ragged_attention.py unified=True) --
//
// The batch's decode prefix is the longest run of sequences 0, 1, ... with
// exactly one query token each (cu_q_lens[s + 1] == s + 1), found on the
// device from cu_q_lens alone as _decode_prefix_len does, so the wrapper
// needs no host sync. Its rows run the decode-class (split-KV) path, every
// other sequence the ragged path. Both helpers are called by a whole warp
// and give every lane the same answer.

__device__ __forceinline__ int decode_prefix_len(const int* cu_q_lens,
                                                 int S) {
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool stop = s < S && cu_q_lens[s + 1] != s + 1;
    const unsigned m = __ballot_sync(0xffffffffu, stop);
    if (m) return s0 + __ffs(m) - 1;
  }
  return S;
}

// Is sequence s inside the decode prefix (sequences 0..s all one-token)?
// A null cu_q_lens: the host knows the step is pure decode (every row is
// a decode row, token s is sequence s; padding rows have kv_len 0), so
// every sequence is.
__device__ __forceinline__ bool in_decode_prefix(const int* cu_q_lens,
                                                 int s) {
  if (cu_q_lens == nullptr) return true;
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 <= s; s0 += 32) {
    const int i = s0 + lane;
    const bool bad = i <= s && cu_q_lens[i + 1] != i + 1;
    if (__any_sync(0xffffffffu, bad)) return false;
  }
  return true;
}

// ---- host: run-time dtype / cache / head_dim -> template instance ---------
//
// f(T{}, TC{}, std::integral_constant<int, D>{}) for q and output type T,
// cache element type TC (T, int8_t or fp8_t, from the cache code) and head
// dim D. With WIDE, head dim 256 (Qwen3-Next's full-attention layers) is
// instantiated too, for a full-precision or an fp8 cache: the hybrid
// family takes no int8 cache and no unified step, so those instances are
// not built.

template <typename T, typename TC, bool WIDE, typename F>
static int dispatch_dim(int head_dim, F& f) {
  switch (head_dim) {
    case 32:
      return f(T{}, TC{}, std::integral_constant<int, 32>{});
    case 64:
      return f(T{}, TC{}, std::integral_constant<int, 64>{});
    case 128:
      return f(T{}, TC{}, std::integral_constant<int, 128>{});
  }
  if constexpr (WIDE && !is_q8<TC>()) {
    if (head_dim == 256)
      return f(T{}, TC{}, std::integral_constant<int, 256>{});
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool WIDE, typename F>
static int dispatch_cache(int cache, int head_dim, F& f) {
  switch (cache) {
    case kCacheNative:
      return dispatch_dim<T, T, WIDE>(head_dim, f);
    case kCacheInt8:
      return dispatch_dim<T, int8_t, WIDE>(head_dim, f);
    case kCacheFp8:
      return dispatch_dim<T, fp8_t, WIDE>(head_dim, f);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool WIDE, typename F>
static int dispatch_types(int dtype, int cache, int head_dim, F&& f) {
  switch (dtype) {
    case kFloat32:
      return dispatch_cache<float, WIDE>(cache, head_dim, f);
    case kBFloat16:
      return dispatch_cache<__nv_bfloat16, WIDE>(cache, head_dim, f);
    case kFloat16:
      return dispatch_cache<__half, WIDE>(cache, head_dim, f);
  }
  return (int)cudaErrorInvalidValue;
}

// Do the scale pointers match the cache code? Both for int8, neither else.
static inline bool scales_ok(int cache, const void* k_scale,
                             const void* v_scale) {
  const bool quant = cache == kCacheInt8;
  return quant == (k_scale != nullptr) && quant == (v_scale != nullptr);
}

}  // namespace gllm
