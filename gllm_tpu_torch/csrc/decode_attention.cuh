// Split-KV paged decode attention: the kernels and their launcher, shared by
// decode_attention.cu (K2, K2q) and unified_attention.cu (the decode-class
// blocks of K1u).
//
// One query row per sequence attends over that sequence's paged KV context,
// online softmax in float32. Bound on the card: bytes. Each (sequence, kv
// head) must stream kv_len * 2 * D cache elements once and does 4 * G * D
// flops per key, far below the ~295 flops per byte where the tensor cores
// would be the limit; an int8 or fp8 cache halves the bytes.
// Design: one block per (sequence, kv head, split of `chunk` keys), so a K/V
// row is read from device memory exactly once and shared by the G query
// heads of its group (warp g handles query row g), and a long context at a
// small batch still spreads over the SMs (the wrapper picks the split length
// from the size of the grid). The block walks its split's pages in 32-key
// tiles: K and V tiles go to shared memory as float (an int8 tile is
// dequantized with its page's scale on the way, an fp8 tile widened),
// lane j scores key j of the tile, and each lane accumulates D/32 output
// dims.
// With one split the block writes the output itself; with more, each block
// writes its unnormalised partial sum and (max, sum) to a float32 scratch
// buffer and a second pass merges the splits (no atomics). Rows with
// kv_len == 0 (batch padding) come out as zeros.
// UNIFIED (K1u's decode class): q and out are the step's flat [T, Hq, D]
// tokens, and only the sequences of the batch's decode prefix run (token s
// is sequence s there); every other block exits at once, since the ragged
// blocks of the same step own those rows.
// Not yet done: overlapping the next tile's loads with this tile's math
// (cp.async / TMA), and running the decode and ragged classes of a unified
// step in one launch.
#pragma once

#include "paged_kv.cuh"

namespace gllm {

constexpr int kDecodeTile = 32;  // keys per tile: one per lane
constexpr int kDecodeMaxGroup = 16;

// Shared memory of a decode block: a K tile (row stride D + 1, odd: lane j
// reads row j conflict-free), a V tile and the group's q rows, all float.
// Static up to D 128 (41 KB with room for 16 q rows); at D 256 it is 74 KB
// for Qwen3-Next's group of 8, above the 48 KB a block may hold statically,
// so those instances take it as dynamic shared memory sized by the group.
// (Dynamic shared memory at every D measured K2 at D 64 17% slower on an
// H100, 0.0753 ms against 0.0643: PERF.md.)
template <int D>
struct DecodeSmem {
  static constexpr int LDK = D + 1;
  static constexpr bool DYNAMIC = D > 128;
  static constexpr size_t bytes(int group) {
    return DYNAMIC ? (kDecodeTile * LDK + kDecodeTile * D + group * D) *
                         sizeof(float)
                   : 0;
  }
};

template <typename T, typename TC, int D, bool UNIFIED>
__global__ void __launch_bounds__(32 * kDecodeMaxGroup)
    decode_attention_kernel(const T* __restrict__ q,
                            const TC* __restrict__ kc,
                            const TC* __restrict__ vc,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs,
                            const int* __restrict__ cu_q_lens,
                            const int* __restrict__ kv_lens,
                            const int* __restrict__ page_table,
                            T* __restrict__ out, float* __restrict__ part,
                            int max_pages, int num_q_heads, int num_kv_heads,
                            int group, int page_size, int page_offset,
                            int chunk, int num_splits, float scale_log2) {
  constexpr int LDK = DecodeSmem<D>::LDK;
  constexpr int DPL = D / 32;  // output dims per lane
  float *sk, *sv, *sq;         // sq: [group][D]
  if constexpr (DecodeSmem<D>::DYNAMIC) {
    extern __shared__ float decode_smem[];
    sk = decode_smem;
    sv = sk + kDecodeTile * LDK;
    sq = sv + kDecodeTile * D;
  } else {
    __shared__ float k_tile[kDecodeTile * LDK];
    __shared__ float v_tile[kDecodeTile * D];
    __shared__ float q_rows[kDecodeMaxGroup * D];
    sk = k_tile;
    sv = v_tile;
    sq = q_rows;
  }

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if constexpr (UNIFIED) {
    if (!in_decode_prefix(cu_q_lens, s)) return;  // block-uniform
  }
  const int kv_len = kv_lens[s];
  const int row0 = s * num_q_heads + h * group;  // first query row (s, head)
  const int j_begin = split * chunk;
  if (j_begin >= kv_len) {
    // nothing to read; with one split this block owns the output rows
    if (num_splits == 1)
      for (int i = threadIdx.x; i < group * D; i += blockDim.x)
        out[(int64_t)row0 * D + i] = from_float<T>(0.f);
    return;
  }
  const int j_end = min(kv_len, j_begin + chunk);
  const T* qp = q + (int64_t)row0 * D;
  for (int i = threadIdx.x; i < group * D; i += blockDim.x)
    sq[i] = to_float(qp[i]) * scale_log2;  // scores in the log2 domain
  const int* pt_row = page_table + (int64_t)s * max_pages;

  float acc[DPL], acc2[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = acc2[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += kDecodeTile) {
    const int n = min(kDecodeTile, j_end - j0);
    __syncthreads();  // the previous tile has been consumed
    load_kv_tile<TC, D>(sk, LDK, kc, ks, pt_row, j0, kDecodeTile, n,
                        page_size, page_offset, num_kv_heads, h);
    load_kv_tile<TC, D>(sv, D, vc, vs, pt_row, j0, kDecodeTile, n,
                        page_size, page_offset, num_kv_heads, h);
    __syncthreads();

    // q . k for key `lane`, four independent partial sums
    float sc = -INFINITY;
    if (lane < n) {
      const float* qr = sq + warp * D;
      const float* kr = sk + lane * LDK;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < D; d += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = fmaf(qr[d + u], kr[d + u], a[u]);
      sc = (a[0] + a[1]) + (a[2] + a[3]);
    }
    // finite: lane 0 is live
    const float m_new = fmaxf(m, warp_max(sc));
    const float p = (lane < n) ? exp2f(sc - m_new) : 0.f;
    const float alpha = exp2f(m - m_new);  // 0 on the first tile
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[i] *= alpha;
      acc2[i] *= alpha;
    }
    // keys past n have p == 0 and zero-filled V rows: the full tile is
    // summed, in two independent chains (even and odd keys)
#pragma unroll 8
    for (int jj = 0; jj < kDecodeTile; jj += 2) {
      const float p0 = __shfl_sync(0xffffffffu, p, jj);
      const float p1 = __shfl_sync(0xffffffffu, p, jj + 1);
      const float* v0 = sv + jj * D + lane;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        acc[i] = fmaf(p0, v0[32 * i], acc[i]);
        acc2[i] = fmaf(p1, v0[D + 32 * i], acc2[i]);
      }
    }
    m = m_new;
  }

  const int row = row0 + warp;
  if (num_splits == 1) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      out[(int64_t)row * D + lane + 32 * i] =
          from_float<T>((acc[i] + acc2[i]) * inv);
    return;
  }
  // partial of this split: [D] unnormalised sums, then (max, sum)
  float* pp = part + ((int64_t)row * num_splits + split) * (D + 2);
#pragma unroll
  for (int i = 0; i < DPL; ++i) pp[lane + 32 * i] = acc[i] + acc2[i];
  if (lane == 0) {
    pp[D] = m;
    pp[D + 1] = l;
  }
}

// Second pass: merge the live splits of each (sequence, query head) row.
// One warp per row; a split is live when it holds at least one key, so its
// max is finite.
template <typename T, int D, bool UNIFIED>
__global__ void __launch_bounds__(32)
    decode_merge_kernel(const float* __restrict__ part,
                        const int* __restrict__ cu_q_lens,
                        const int* __restrict__ kv_lens, T* __restrict__ out,
                        int num_q_heads, int chunk, int num_splits) {
  constexpr int DPL = D / 32;
  const int s = blockIdx.x;
  if constexpr (UNIFIED) {
    if (!in_decode_prefix(cu_q_lens, s)) return;
  }
  const int row = s * num_q_heads + blockIdx.y;
  const int lane = threadIdx.x;
  const int n = min(num_splits, (kv_lens[s] + chunk - 1) / chunk);
  T* o = out + (int64_t)row * D;
  if (n <= 0) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[lane + 32 * i] = from_float<T>(0.f);
    return;
  }
  const float* pp = part + (int64_t)row * num_splits * (D + 2);
  float mx = -INFINITY;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, pp[i * (D + 2) + D]);
  float acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;
  float l = 0.f;
  for (int i = 0; i < n; ++i) {
    const float* p = pp + i * (D + 2);
    const float w = exp2f(p[D] - mx);
    l = fmaf(w, p[D + 1], l);
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = fmaf(w, p[lane + 32 * c], acc[c]);
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int c = 0; c < DPL; ++c) o[lane + 32 * c] = from_float<T>(acc[c] * inv);
}

// Launch the decode kernel (and the merge pass when num_splits > 1) over
// S sequences. cu_q_lens is read only when UNIFIED.
template <typename T, typename TC, int D, bool UNIFIED>
static int launch_decode(const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* cu,
                         const int* kv_lens, const int* pt, void* out,
                         float* part, int S, int max_pages, int hq, int hkv,
                         int page_size, int page_offset, int chunk,
                         int num_splits, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  dim3 grid(S, hkv, num_splits);
  auto kern = decode_attention_kernel<T, TC, D, UNIFIED>;
  static bool configured = !DecodeSmem<D>::DYNAMIC;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)DecodeSmem<D>::bytes(kDecodeMaxGroup));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<grid, 32 * group, DecodeSmem<D>::bytes(group), stream>>>(
          static_cast<const T*>(q), static_cast<const TC*>(k),
          static_cast<const TC*>(v), ks, vs, cu, kv_lens, pt,
          static_cast<T*>(out), part, max_pages, hq, hkv, group, page_size,
          page_offset, chunk, num_splits, scale * kLog2e);
  if (num_splits > 1)
    decode_merge_kernel<T, D, UNIFIED><<<dim3(S, hq), 32, 0, stream>>>(
        part, cu, kv_lens, static_cast<T*>(out), hq, chunk, num_splits);
  return 0;
}

// The arguments the decode launcher takes, checked on the host.
static inline bool decode_args_ok(int S, int hq, int hkv, int max_pages,
                                  int page_size, int chunk, int num_splits,
                                  const void* part) {
  const int group = hkv > 0 ? hq / hkv : 0;
  return S > 0 && group >= 1 && group <= kDecodeMaxGroup &&
         group * hkv == hq && num_splits >= 1 && chunk >= kDecodeTile &&
         chunk % kDecodeTile == 0 && (num_splits == 1 || part != nullptr) &&
         (int64_t)num_splits * chunk >= (int64_t)max_pages * page_size;
}

}  // namespace gllm
