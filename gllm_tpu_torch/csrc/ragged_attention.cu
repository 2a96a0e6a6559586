// Ragged paged attention for Hopper (sm_90a).
//
// Replaces gllm_tpu/ops/pallas/ragged_attention.py::ragged_paged_attention
// in its non-unified, full-precision-cache GQA mode: a flat packed batch of
// query tokens (decode rows and prefill chunks of several sequences) attends
// causally over each sequence's paged KV. Token t of sequence s sits at
// absolute position kv_len - q_len + t and sees keys 0..that position;
// batch-padding tokens (past cu_q_lens[S]) come out as zeros.
//
// Bound on the card: operations, for the prefill chunks that dominate a
// mixed step (4 * Hq * D flops per visible key per query token).
// Design: the TPU kernel's grid of flat 512-token q blocks that straddle
// sequences (found by searchsorted in the wrapper, sized by the VMEM limit)
// does not carry over. The grid here is fixed, (cdiv(T, BQ) + S, Hkv): each
// block finds its own (sequence, q tile) from cu_q_lens with a warp scan,
// so the wrapper needs no host sync, and blocks beyond the real work zero
// the padding tokens or exit. A block holds 64 query rows (BQ = 64 / G
// tokens times the G query heads of one kv head), so every K/V tile it
// loads serves all of them, and it walks the sequence's pages only up to
// the last key its rows can see, with a float32 online softmax.
// bf16 / fp16: tensor cores (mma.sync m16n8k16, float32 accumulators), one
// warp per 16 query rows, 64-key K/V tiles double-buffered in shared memory
// with cp.async so the next tile's loads overlap this tile's products; a
// warp skips a tile none of its rows can see. float32: the same walk with
// plain FMA on register tiles out of shared memory (the tensor cores take
// no full-precision float32). wgmma, TMA and warp specialisation are later
// work.

#include <type_traits>

#include "paged_kv.cuh"

namespace gllm {

constexpr int kRows = 64;  // query rows per block (both kernels)

// Which (sequence, q tile) is this block's? Sequence s owns
// cdiv(q_len_s, bq) consecutive block indices; warp 0 scans cu_q_lens 32
// sequences at a time. Past the real work seq is -1 and tile counts the
// excess blocks.
__device__ __forceinline__ void locate_block(const int* cu_q_lens, int S,
                                             int bq, int* s_seq,
                                             int* s_tile) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int b = blockIdx.x;
    int base = 0, seq = -1, tile = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const int nt =
          s < S ? (cu_q_lens[s + 1] - cu_q_lens[s] + bq - 1) / bq : 0;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc,
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
  locate_block(cu_q_lens, S, bq, &s_seq, &s_tile);
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
    load_kv_tile<T, D>(sk, SM::LDK, kc, pt_row, j0, kTileK, n, page_size,
                       page_offset, num_kv_heads, h);
    load_kv_tile<T, D>(sv, D, vc, pt_row, j0, kTileK, n, page_size,
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

// ---- bf16 / fp16: tensor cores ---------------------------------------------

constexpr int kMmaKeys = 64;  // keys per tile
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

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

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

template <typename T, int D>
struct MmaSmem {
  static constexpr int LD = D + 8;  // row stride: conflict-free fragments
  static constexpr int TILE = kMmaKeys * LD;
  static constexpr size_t BYTES = 4 * TILE * sizeof(T);  // 2 x (K, V)
};

// Issue the cp.async copies of keys [j0, j0 + kMmaKeys) of one kv head into
// shared K and V tiles; rows at or past n_valid are zero-filled, so no key
// at or beyond kv_len is read and a masked key never multiplies garbage.
template <typename T, int D>
__device__ __forceinline__ void issue_kv_tile(T* sk, T* sv, const T* kc,
                                              const T* vc, const int* pt_row,
                                              int j0, int n_valid,
                                              int page_size, int page_offset,
                                              int num_kv_heads, int h) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int LD = MmaSmem<T, D>::LD;
  for (int c = threadIdx.x; c < kMmaKeys * CPR; c += blockDim.x) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const bool valid = r < n_valid;
    const int64_t off =
        valid ? kv_row_offset(pt_row, j0 + r, page_size, page_offset,
                              num_kv_heads, D, h) + col
              : 0;
    cp_async16(sk + r * LD + col, kc + off, valid);
    cp_async16(sv + r * LD + col, vc + off, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    ragged_attention_mma_kernel(const T* __restrict__ q,
                                const T* __restrict__ kc,
                                const T* __restrict__ vc,
                                const int* __restrict__ cu_q_lens,
                                const int* __restrict__ kv_lens,
                                const int* __restrict__ page_table,
                                T* __restrict__ out, int num_tokens, int S,
                                int max_pages, int num_q_heads,
                                int num_kv_heads, int group, int page_size,
                                int page_offset, float scale_log2) {
  using SM = MmaSmem<T, D>;
  constexpr int LD = SM::LD;
  constexpr int NK = kMmaKeys / 8;  // key n-tiles of S
  constexpr int ND = D / 8;         // dim n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_seq, s_tile;

  const int h = blockIdx.y;
  const int bq = kRows / group;
  locate_block(cu_q_lens, S, bq, &s_seq, &s_tile);
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
  const int t_first = tile * bq;
  const int n_tok = min(bq, q_len - t_first);
  const int n_rows = n_tok * group;
  const int pos0 = kv_len - q_len + t_first;
  const int kv_end = min(kv_len, pos0 + n_tok);
  const int* pt_row = page_table + (int64_t)seq * max_pages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  // this thread's two rows (i = 0: row g, i = 1: row g + 8 of the warp),
  // r = token * group + head; a row past n_rows sees no key (pos -1)
  int pos[2];
  int64_t row_off[2];  // element offset of the row in q and out
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const bool live = r < n_rows;
    pos[i] = live ? pos0 + r / group : -1;
    row_off[i] = ((int64_t)(q_start + t_first + (live ? r / group : 0)) *
                      num_q_heads +
                  (int64_t)h * group + (live ? r % group : 0)) * D;
  }
  // the last position any row of this warp can see
  const int warp_rows = min(16, n_rows - warp * 16);
  const int warp_last = warp_rows > 0
                            ? pos0 + (warp * 16 + warp_rows - 1) / group
                            : -1;

  // Q as A fragments, for the whole walk
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool live = pos[i] >= 0;
      const T* src = q + row_off[i] + kk * 16 + 2 * t4;
      qa[kk][i] = live ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      qa[kk][i + 2] = live ? *reinterpret_cast<const uint32_t*>(src + 8) : 0u;
    }

  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int n_tiles = (kv_end + kMmaKeys - 1) / kMmaKeys;
  if (n_tiles > 0)
    issue_kv_tile<T, D>(smem, smem + SM::TILE, kc, vc, pt_row, 0,
                        min(kMmaKeys, kv_end), page_size, page_offset,
                        num_kv_heads, h);
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * kMmaKeys;
    if (it + 1 < n_tiles) {
      T* nk = smem + ((it + 1) & 1) * 2 * SM::TILE;
      issue_kv_tile<T, D>(nk, nk + SM::TILE, kc, vc, pt_row, j0 + kMmaKeys,
                          min(kMmaKeys, kv_end - j0 - kMmaKeys), page_size,
                          page_offset, num_kv_heads, h);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);  // keep the count even
    }
    asm volatile("cp.async.wait_group 1;\n" ::);  // this tile has landed
    __syncthreads();
    const T* sk = smem + (it & 1) * 2 * SM::TILE;
    const T* sv = sk + SM::TILE;

    if (j0 <= warp_last) {  // warp-uniform: some row sees this tile
      // S = Q K^T: B fragment pairs are contiguous in a K row
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        const T* kr = sk + (j * 8 + g) * LD + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Mma<T>::run(s[j], qa[kk],
                      *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                      *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
      }
      // causal mask, log2-domain scale, online softmax per row
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = j0 + j * 8 + 2 * t4 + e;
            const float v =
                key <= pos[i] ? s[j][2 * i + e] * scale_log2 : -INFINITY;
            s[j][2 * i + e] = v;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[j][2 * i + e] - m_safe);
            s[j][2 * i + e] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float alpha = exp2f(m[i] - m_safe);  // 0 before the first key
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          o[dn][2 * i] *= alpha;
          o[dn][2 * i + 1] *= alpha;
        }
      }
      // O += P V: P's accumulator layout is the A fragment layout of k16
#pragma unroll
      for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
        const uint32_t pa[4] = {
            Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
            Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
            Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        // lanes 8i..8i+7 address keys kk*16 + (i&1)*8 + 0..7, dims of the
        // n-tile dn + (i>>1): r[0..1] are B of dim tile dn, r[2..3] of dn+1
        const int mi = lane >> 3;
        const T* vr = sv + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD +
                      (mi >> 1) * 8;
#pragma unroll
        for (int dn = 0; dn < ND; dn += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vr + dn * 8);
          Mma<T>::run(o[dn], pa, b[0], b[1]);
          Mma<T>::run(o[dn + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (pos[i] < 0) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = out + row_off[i];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t4) =
          Mma<T>::pack(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
  }
}

// ---- launch ----------------------------------------------------------------

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const int* cu,
                  const int* kv_lens, const int* pt, void* out, int T_,
                  int S, int max_pages, int hq, int hkv, int page_size,
                  int page_offset, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const int bq = kRows / group;
  dim3 grid((T_ + bq - 1) / bq + S, hkv);
  static bool configured = false;
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = RaggedSmem<D>::BYTES;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          ragged_attention_kernel<T, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    ragged_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), cu, kv_lens, pt, static_cast<T*>(out), T_,
        S, max_pages, hq, hkv, group, page_size, page_offset,
        scale * kLog2e);
  } else {
    constexpr size_t smem = MmaSmem<T, D>::BYTES;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          ragged_attention_mma_kernel<T, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    ragged_attention_mma_kernel<T, D><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), cu, kv_lens, pt, static_cast<T*>(out), T_,
        S, max_pages, hq, hkv, group, page_size, page_offset,
        scale * kLog2e);
  }
  return 0;
}

template <typename T>
static int dispatch_dim(int D, const void* q, const void* k, const void* v,
                        const int* cu, const int* kv_lens, const int* pt,
                        void* out, int T_, int S, int max_pages, int hq,
                        int hkv, int page_size, int page_offset, float scale,
                        cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, cu, kv_lens, pt, out, T_, S, max_pages,
                           hq, hkv, page_size, page_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, cu, kv_lens, pt, out, T_, S, max_pages,
                           hq, hkv, page_size, page_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, cu, kv_lens, pt, out, T_, S, max_pages,
                            hq, hkv, page_size, page_offset, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace gllm

// q [T, Hq, D], k/v cache [P, page, Hkv, D], cu_q_lens [S+1] i32,
// kv_lens [S] i32, page_table [S, max_pages] i32, out [T, Hq, D]; all
// contiguous on one device. Returns cudaGetLastError() after the launch.
extern "C" int gllm_ragged_attention(const void* q, const void* k_cache,
                                     const void* v_cache,
                                     const void* cu_q_lens,
                                     const void* kv_lens,
                                     const void* page_table, void* out,
                                     int num_tokens, int S, int max_pages,
                                     int num_q_heads, int num_kv_heads,
                                     int head_dim, int page_size,
                                     int page_offset, float scale, int dtype,
                                     void* stream) {
  using namespace gllm;
  const int group = num_q_heads / num_kv_heads;
  if (num_tokens <= 0 || S <= 0 || group < 1 || kRows % group != 0 ||
      group * num_kv_heads != num_q_heads)
    return (int)cudaErrorInvalidValue;
  const int* cu = static_cast<const int*>(cu_q_lens);
  const int* kl = static_cast<const int*>(kv_lens);
  const int* pt = static_cast<const int*>(page_table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      rc = dispatch_dim<float>(head_dim, q, k_cache, v_cache, cu, kl, pt, out,
                               num_tokens, S, max_pages, num_q_heads,
                               num_kv_heads, page_size, page_offset, scale,
                               st);
      break;
    case kBFloat16:
      rc = dispatch_dim<__nv_bfloat16>(
          head_dim, q, k_cache, v_cache, cu, kl, pt, out, num_tokens, S,
          max_pages, num_q_heads, num_kv_heads, page_size, page_offset, scale,
          st);
      break;
    case kFloat16:
      rc = dispatch_dim<__half>(head_dim, q, k_cache, v_cache, cu, kl, pt,
                                out, num_tokens, S, max_pages, num_q_heads,
                                num_kv_heads, page_size, page_offset, scale,
                                st);
      break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
