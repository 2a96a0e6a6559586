// Ragged paged attention: the float32 kernel and what the ragged blocks
// share (ragged_wgmma.cuh holds the bf16 / fp16 block and the launcher;
// mla_attention.cuh's blocks use locate_block and the mma.sync and
// cp.async helpers here).
//
// A flat packed batch of query tokens (decode rows and prefill chunks of
// several sequences) attends causally over each sequence's paged KV. Token
// t of sequence s sits at absolute position kv_len - q_len + t and sees
// keys 0..that position; batch-padding tokens (past cu_q_lens[S]) come out
// as zeros.
//
// float32 (the reference paths; the tensor cores take no full-precision
// float32): the grid is (cdiv(T, BQ) + S, Hkv); each block finds its own
// (sequence, q tile) from cu_q_lens with a warp scan, so the wrapper needs
// no host sync, and blocks beyond the real work zero the padding tokens or
// exit. A block holds 64 query rows (BQ = floor(64 / G) tokens times the G
// query heads of one kv head), so every K/V tile it loads serves all of
// them, and it walks the sequence's pages only up to the last key its rows
// can see, with a float32 online softmax on plain FMA over register tiles
// out of shared memory. An int8 tile is dequantized, an fp8 one widened,
// as it loads.
// UNIFIED: the sequences of the batch's decode prefix get no tiles here
// (the decode-class blocks of the same step own them).
#pragma once

#include "paged_kv.cuh"

namespace gllm {

constexpr int kRows = 64;  // query rows per block of the float32 kernel

// Which (sequence, q tile) is this block's? Sequence s owns
// cdiv(q_len_s, bq) consecutive block indices (none when UNIFIED puts it
// in the decode prefix); warp 0 scans cu_q_lens 32 sequences at a time.
// Past the real work seq is -1 and tile counts the excess blocks.
template <bool UNIFIED>
__device__ __forceinline__ void locate_block(const int* cu_q_lens, int S,
                                             int bq, int* s_seq,
                                             int* s_tile) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int b = blockIdx.x;
    const int nd = UNIFIED ? decode_prefix_len(cu_q_lens, S) : 0;
    int base = 0, seq = -1, tile = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const int nt = s < S && s >= nd
                         ? (cu_q_lens[s + 1] - cu_q_lens[s] + bq - 1) / bq
                         : 0;
      int inc = nt;  // inclusive prefix sum over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const int first = base + inc - nt;
      const unsigned mine =
          __ballot_sync(0xffffffffu, b >= first && b < first + nt);
      if (mine) {
        const int src = __ffs(mine) - 1;
        seq = s0 + src;
        tile = b - __shfl_sync(0xffffffffu, first, src);
        break;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (seq < 0) tile = b - base;
    if (lane == 0) {
      *s_seq = seq;
      *s_tile = tile;
    }
  }
  __syncthreads();
}

// Block e of the excess zeroes padding tokens [cu[S] + e*bq, +bq) of this
// kv head's query heads. The excess blocks always cover all T - cu[S]
// padding tokens.
template <typename T>
__device__ __forceinline__ void zero_padding(T* out, const int* cu_q_lens,
                                             int S, int tile, int bq,
                                             int num_tokens, int num_q_heads,
                                             int group, int D, int h) {
  const int t0 = cu_q_lens[S] + tile * bq;
  const int n = min(bq, num_tokens - t0);
  for (int i = threadIdx.x; i < n * group * D; i += blockDim.x) {
    const int t = i / (group * D);
    const int rest = i % (group * D);
    out[((int64_t)(t0 + t) * num_q_heads + (int64_t)h * group) * D + rest] =
        from_float<T>(0.f);
  }
}

// ---- float32: plain FMA ----------------------------------------------------

constexpr int kTileK = 32;  // keys per tile
constexpr int kThreads = 256;

template <int D>
struct RaggedSmem {
  static constexpr int LDQ = D + 1;
  static constexpr int LDK = D + 1;
  static constexpr int LDP = kTileK + 1;
  static constexpr int Q = 0;
  static constexpr int K = Q + kRows * LDQ;
  static constexpr int V = K + kTileK * LDK;
  static constexpr int P = V + kTileK * D;
  static constexpr int M = P + kRows * LDP;
  static constexpr int L = M + kRows;
  static constexpr int A = L + kRows;
  static constexpr int FLOATS = A + kRows;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename T, typename TC, int D, bool UNIFIED>
__global__ void __launch_bounds__(kThreads)
    ragged_attention_kernel(const T* __restrict__ q, const TC* __restrict__ kc,
                            const TC* __restrict__ vc,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs,
                            const int* __restrict__ cu_q_lens,
                            const int* __restrict__ kv_lens,
                            const int* __restrict__ page_table,
                            T* __restrict__ out, int num_tokens, int S,
                            int max_pages, int num_q_heads, int num_kv_heads,
                            int group, int page_size, int page_offset,
                            float scale_log2) {
  using SM = RaggedSmem<D>;
  extern __shared__ float smem[];
  float* sq = smem + SM::Q;
  float* sk = smem + SM::K;
  float* sv = smem + SM::V;
  float* sp = smem + SM::P;
  float* sm = smem + SM::M;
  float* sl = smem + SM::L;
  float* sa = smem + SM::A;
  __shared__ int s_seq, s_tile;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int bq = kRows / group;  // query tokens per block
  locate_block<UNIFIED>(cu_q_lens, S, bq, &s_seq, &s_tile);
  const int seq = s_seq;
  const int tile = s_tile;
  if (seq < 0) {
    zero_padding(out, cu_q_lens, S, tile, bq, num_tokens, num_q_heads, group,
                 D, h);
    return;
  }

  const int q_start = cu_q_lens[seq];
  const int q_len = cu_q_lens[seq + 1] - q_start;
  const int kv_len = kv_lens[seq];
  const int t_first = tile * bq;              // first token of the tile
  const int n_tok = min(bq, q_len - t_first);
  const int n_rows = n_tok * group;
  const int pos0 = kv_len - q_len + t_first;  // position of token t_first
  const int kv_end = min(kv_len, pos0 + n_tok);  // keys any row can see
  const int* pt_row = page_table + (int64_t)seq * max_pages;

  // Query rows r = t * group + g: the group's heads of one token are
  // contiguous in q. Scores are kept in the log2 domain.
  {
    constexpr int CH = Chunk<T>::N;
    constexpr int CPR = D / CH;
    for (int c = tid; c < kRows * CPR; c += blockDim.x) {
      const int r = c / CPR;
      const int col = (c % CPR) * CH;
      float* d = sq + r * SM::LDQ + col;
      if (r < n_rows) {
        const int t = r / group, g = r % group;
        const T* src = q + ((int64_t)(q_start + t_first + t) * num_q_heads +
                            (int64_t)h * group + g) * D + col;
        Chunk<T>::load(d, src);
#pragma unroll
        for (int i = 0; i < CH; ++i) d[i] *= scale_log2;
      } else {
#pragma unroll
        for (int i = 0; i < CH; ++i) d[i] = 0.f;
      }
    }
    if (tid < kRows) {
      sm[tid] = -INFINITY;
      sl[tid] = 0.f;
    }
  }

  // score micro-tile: rows 2*ty + {0,1}, keys tx + 8*c
  const int ty = tid >> 3, tx = tid & 7;
  // softmax pass: row tid/4, keys 8*(tid%4) .. +7
  const int srow = tid >> 2, spart = tid & 3;
  // output micro-tile: rows 4*ry + {0..3}, dims cx + 16*c
  constexpr int DC = D / 16;
  const int ry = tid >> 4, cx = tid & 15;
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += kTileK) {
    const int n = min(kTileK, kv_end - j0);
    __syncthreads();  // previous tile consumed (and q tile stored)
    load_kv_tile<TC, D>(sk, SM::LDK, kc, ks, pt_row, j0, kTileK, n,
                        page_size, page_offset, num_kv_heads, h);
    load_kv_tile<TC, D>(sv, D, vc, vs, pt_row, j0, kTileK, n, page_size,
                        page_offset, num_kv_heads, h);
    __syncthreads();

    // S = Q K^T on the tile, causal mask, into sp
    {
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
      const float* q0 = sq + (2 * ty) * SM::LDQ;
      const float* q1 = q0 + SM::LDQ;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float a0 = q0[d], a1 = q1[d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = sk[(tx + 8 * c) * SM::LDK + d];
          s[0][c] = fmaf(a0, kv, s[0][c]);
          s[1][c] = fmaf(a1, kv, s[1][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * ty + i;
        const int pos = pos0 + r / group;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jj = tx + 8 * c;
          const bool ok = r < n_rows && jj < n && j0 + jj <= pos;
          sp[r * SM::LDP + jj] = ok ? s[i][c] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: new row max, p = 2^(s - m), running sum, rescale
    {
      float* pr = sp + srow * SM::LDP + spart * 8;
      const float m_old = sm[srow];
      float mt = -INFINITY;
#pragma unroll
      for (int k = 0; k < 8; ++k) mt = fmaxf(mt, pr[k]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_old, mt);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float p = exp2f(pr[k] - m_safe);
        pr[k] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (spart == 0) {
        const float alpha = exp2f(m_old - m_safe);
        sa[srow] = alpha;
        sl[srow] = sl[srow] * alpha + sum;
        sm[srow] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V
    {
      float al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) al[i] = sa[4 * ry + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= al[i];
#pragma unroll 4
      for (int jj = 0; jj < kTileK; ++jj) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = sp[(4 * ry + i) * SM::LDP + jj];
        const float* vr = sv + jj * D + cx;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float vv = vr[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ry + i;
    if (r >= n_rows) continue;
    const float lsum = sl[r];
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    const int t = r / group, g = r % group;
    T* o = out + ((int64_t)(q_start + t_first + t) * num_q_heads +
                  (int64_t)h * group + g) * D + cx;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[16 * c] = from_float<T>(acc[i][c] * inv);
  }
}

// ---- tensor-core and copy helpers (mma.sync, cp.async, ldmatrix) -----------

// mma.sync m16n8k16 with float32 accumulators, and the packing of two
// floats into one 32-bit A-fragment register (lower index in the low half)
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// asynchronous copies global -> shared of 16 or 4 bytes; zero-fill when
// !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i, and r[i] holds this lane's pair of it.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

}  // namespace gllm
