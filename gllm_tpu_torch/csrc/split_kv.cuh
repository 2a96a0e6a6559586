// Pieces shared by the split-KV decode blocks of decode_attention.cuh (GQA:
// K2, K1u's decode class) and mla_attention.cuh (MLA: K2m, K1um's decode
// class): tensor-core fragments read straight from staged tiles in the
// cache's storage type, the page-table prefetch, and the merge of a row's
// splits folded into the last block that finishes one.
//
// Fragments (mma.sync m16n8k16, lane = 4 g + t4). The sum over the head dim
// of Q.K^T may take its 16 terms in any order, so the k index of each
// 16-wide step is permuted: MMA k 2t4+e is dim 4t4+e and k 2t4+8+e is dim
// 4t4+2+e (e = 0, 1). Then lane (g, t4) finds both halves of its B
// fragment of key g in ONE load of 4 consecutive elements (8 bytes of a
// 16-bit cache, 4 bytes of a one-byte one), and its A fragment of Q the
// same way. For P.V the output columns are permuted instead: in a group
// of 8 NJ columns (NJ = 4, or 2 for a 16-column group), n-tile j's column
// g is column NJ g + j, so lane (g, t4) loads NJ consecutive elements of
// each of its four key rows (2t4, 2t4+1, 2t4+8, 2t4+9) and cuts the B
// fragments of NJ n-tiles out of them; its accumulators then hold the
// consecutive columns 2 NJ t4 .. 2 NJ t4 + 2 NJ - 1 of the group
// (out_col). One-byte elements are widened exactly in registers (bf16 and
// fp16 hold every int8 and e4m3 value), so a one-byte tile crosses shared
// memory once, at one byte an element.
#pragma once

#include "paged_kv.cuh"
#include "ragged_attention.cuh"

namespace gllm {

// Two one-byte values (bits 0..15; the lower one first) widened to a
// packed pair of T (the lower one in the low half): exact.
template <typename T, typename TC>
__device__ __forceinline__ uint32_t widen2(uint32_t two) {
  if constexpr (is_q8<TC>()) {
    return Mma<T>::pack((float)(int8_t)(two & 0xffu),
                        (float)(int8_t)((two >> 8) & 0xffu));
  } else {
    const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(two & 0xffffu), __NV_E4M3);
    if constexpr (std::is_same<T, __half>::value) {
      return (uint32_t)r.x | ((uint32_t)r.y << 16);
    } else {
      __half2 h;
      h.x = __half(__half_raw{r.x});
      h.y = __half(__half_raw{r.y});
      return Mma<T>::pack(__low2float(h), __high2float(h));
    }
  }
}

// The B fragment (b[0], b[1]) of one key row for one 16-wide k step, in the
// permuted order: elements 4t4 .. 4t4+3 of the row at `p` (p already points
// there).
template <typename T, typename TC>
__device__ __forceinline__ void load_k_frag(uint32_t* b, const TC* p) {
  if constexpr (sizeof(TC) == 1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    b[0] = widen2<T, TC>(w);
    b[1] = widen2<T, TC>(w >> 16);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    b[0] = w.x;
    b[1] = w.y;
  }
}

// NJ consecutive elements of one row (NJ = 2 or 4) as raw bits: 16-bit
// elements in r[0] (and r[1]), one-byte ones in the low bytes of r[0].
template <typename TC, int NJ>
__device__ __forceinline__ void load_row_bits(uint32_t* r, const TC* p) {
  constexpr int BYTES = NJ * (int)sizeof(TC);
  if constexpr (BYTES == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    r[0] = w.x;
    r[1] = w.y;
  } else if constexpr (BYTES == 4) {
    r[0] = *reinterpret_cast<const uint32_t*>(p);
    r[1] = 0;
  } else {
    r[0] = *reinterpret_cast<const uint16_t*>(p);
    r[1] = 0;
  }
}

// Element j of rows a and b (from load_row_bits), packed as a pair of T
// (row a's in the low half).
template <typename T, typename TC>
__device__ __forceinline__ uint32_t pair_of(const uint32_t* a,
                                            const uint32_t* b, int j) {
  if constexpr (sizeof(TC) == 1) {
    return widen2<T, TC>(__byte_perm(a[0], b[0], j | ((j + 4) << 4)));
  } else {
    const uint32_t x = a[j >> 1], y = b[j >> 1];
    return __byte_perm(x, y, (j & 1) ? 0x7632 : 0x5410);
  }
}

// The B fragments of the NJ n-tiles of one column group for P.V over 16
// keys: `v` points at (key 0 of the step, the group's first column), rows
// `ld` elements apart.
template <typename T, typename TC, int NJ>
__device__ __forceinline__ void load_v_frags(uint32_t (*b)[2], const TC* v,
                                             int ld, int g, int t4) {
  uint32_t r0[2], r1[2], r8[2], r9[2];
  const TC* p = v + NJ * g;
  load_row_bits<TC, NJ>(r0, p + (2 * t4) * ld);
  load_row_bits<TC, NJ>(r1, p + (2 * t4 + 1) * ld);
  load_row_bits<TC, NJ>(r8, p + (2 * t4 + 8) * ld);
  load_row_bits<TC, NJ>(r9, p + (2 * t4 + 9) * ld);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    b[j][0] = pair_of<T, TC>(r0, r1, j);
    b[j][1] = pair_of<T, TC>(r8, r9, j);
  }
}

// The output column of accumulator element e (0 or 1: c0/c2 or c1/c3) of
// n-tile j of a column group, relative to the group.
template <int NJ>
__device__ __forceinline__ int out_col(int t4, int j, int e) {
  return NJ * (2 * t4 + e) + j;
}

// Page-table prefetch: the page ids of keys [j_begin, j_end) of a split,
// from pt_row to spt[0 ..]; spt[i] holds the page of keys in page
// j_begin / page_size + i. Called by the whole block; ends with a barrier.
__device__ __forceinline__ void prefetch_pages(int* spt, const int* pt_row,
                                               int j_begin, int j_end,
                                               int page_size) {
  const int p0 = j_begin / page_size;
  const int n = (j_end - 1) / page_size - p0 + 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) spt[i] = pt_row[p0 + i];
  __syncthreads();
}

// Page id (offset into the flat cache) of key j, from the prefetched page
// ids of a split that starts at j_begin.
__device__ __forceinline__ int64_t split_page(const int* spt, int j,
                                              int j_begin, int page_size,
                                              int page_offset) {
  return (int64_t)spt[j / page_size - j_begin / page_size] + page_offset;
}

// Element offset of (key j, kv head h, dim 0) in the cache, from the
// prefetched page ids.
__device__ __forceinline__ int64_t split_row_offset(const int* spt, int j,
                                                    int j_begin,
                                                    int page_size,
                                                    int page_offset,
                                                    int num_kv_heads,
                                                    int head_dim, int h) {
  const int64_t page = split_page(spt, j, j_begin, page_size, page_offset);
  return ((page * page_size + j % page_size) * num_kv_heads + h) * head_dim;
}

// Slots of the split counters at the head of the decode kernels' scratch
// buffer (one per (sequence, kv head) row, zero between calls), and the
// float32 partials that follow them.
constexpr int kCounterSlots = 1 << 16;

__host__ __device__ __forceinline__ float* split_partials(float* part) {
  return part + kCounterSlots;
}

// Called by the whole block after it wrote its split's partials of rows
// [row0, row0 + nrows): DV unnormalised sums per row at pvals[(row *
// num_splits + split) * DV], and (max, sum) at pstats[(row * num_splits +
// split) * 2]. The last of the row's n_live live splits to finish merges
// them, in split order (deterministic), into `out` and sets the counter
// back to zero, so no second launch and no host-side reset are needed.
// Merge: threads split the rows (128 / nrows a row, at most 16 rows), each
// owns 4-column groups 32 apart, and reads each split's group as one
// float4.
template <typename T, int DV>
__device__ __forceinline__ void merge_if_last(const float* pvals,
                                              const float* pstats,
                                              int* counter, int n_live,
                                              T* out, int64_t row0,
                                              int nrows, int num_splits) {
  constexpr int TPR = 8;          // threads a row (16 rows, 128 threads)
  constexpr int NC = DV / (4 * TPR);  // float4 column groups a thread
  static_assert(DV % (4 * TPR) == 0, "merge columns");
  __shared__ int s_last;
  __threadfence();  // this block's partials are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // and so are those of the splits counted before
  const int r = threadIdx.x / TPR, c0 = (threadIdx.x % TPR) * 4;
  if (r < nrows) {
    const int64_t pr = (row0 + r) * num_splits;
    float mx = -INFINITY;
    for (int i = 0; i < n_live; ++i)
      mx = fmaxf(mx, __ldcg(pstats + 2 * (pr + i)));
    float l = 0.f;
    float4 acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < n_live; ++i) {
      const float2 st =
          __ldcg(reinterpret_cast<const float2*>(pstats + 2 * (pr + i)));
      const float w = exp2f(st.x - mx);
      l = fmaf(w, st.y, l);
      const float* v = pvals + (pr + i) * DV + c0;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(v + 32 * k));
        acc[k].x = fmaf(w, x.x, acc[k].x);
        acc[k].y = fmaf(w, x.y, acc[k].y);
        acc[k].z = fmaf(w, x.z, acc[k].z);
        acc[k].w = fmaf(w, x.w, acc[k].w);
      }
    }
    const float inv = 1.f / l;
    T* o = out + (row0 + r) * DV + c0;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      o[32 * k] = from_float<T>(acc[k].x * inv);
      o[32 * k + 1] = from_float<T>(acc[k].y * inv);
      o[32 * k + 2] = from_float<T>(acc[k].z * inv);
      o[32 * k + 3] = from_float<T>(acc[k].w * inv);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

}  // namespace gllm
