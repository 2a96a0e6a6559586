// Paged KV addressing and tile loads shared by the attention kernels.
//
// Counterpart of gllm_tpu/ops/pallas/paged_kv.py (make_fetch_fns,
// block_kv): the cache layout [num_pages, page_size, num_kv_heads,
// head_dim] and the page-table -> address rule live here and nowhere
// else. A kernel gets ONE flat cache covering every layer ([L*P, page,
// Hkv, D]); `page_offset` (= layer * P) is added to every page id it reads
// from the page table, so the page table itself stays per-model.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gllm {

// dtype codes shared with the Python wrappers (ops/cuda/build.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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

// Element offset of (key j of a sequence, kv head h, dim 0) in the cache.
// 64-bit: a whole-model cache holds more than 2^31 elements.
__device__ __forceinline__ int64_t kv_row_offset(const int* pt_row, int j,
                                                 int page_size,
                                                 int page_offset,
                                                 int num_kv_heads,
                                                 int head_dim, int h) {
  const int64_t page = (int64_t)pt_row[j / page_size] + page_offset;
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
// cache into shared memory as float, row stride `ld`. Rows at or past
// `n_valid` are zero-filled: the kernels never read a key at or beyond
// kv_len, whatever the padded page table holds, and a zero row keeps a
// masked (p = 0) key from multiplying garbage.
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(float* dst, int ld,
                                             const T* cache,
                                             const int* pt_row, int j0,
                                             int rows, int n_valid,
                                             int page_size, int page_offset,
                                             int num_kv_heads, int h) {
  constexpr int CH = Chunk<T>::N;
  constexpr int CPR = D / CH;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CPR; c += blockDim.x) {
    const int r = c / CPR;
    const int col = (c % CPR) * CH;
    float* d = dst + r * ld + col;
    if (r < n_valid) {
      const int64_t off = kv_row_offset(pt_row, j0 + r, page_size,
                                        page_offset, num_kv_heads, D, h);
      Chunk<T>::load(d, cache + off + col);
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

}  // namespace gllm
