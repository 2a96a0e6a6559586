// Split-KV paged decode attention: the kernels and their launcher, shared by
// decode_attention.cu (K2, K2q, K2 over fp8) and ragged_attention.cu (the
// decode-class blocks of K1 and K1u).
//
// One query row per sequence attends over that sequence's paged KV context,
// online softmax in float32. Bound on the card: bytes. Each (sequence, kv
// head) must stream kv_len * 2 * D cache elements once and does 4 * G * D
// flops per key, far below the ~295 flops per byte where the tensor cores
// would be the limit; an int8 or fp8 cache halves the bytes.
//
// bf16 / fp16 q: a tensor-core block (mma.sync m16n8k16, float32
// accumulators) per (sequence, kv head, split of `chunk` keys). The G <= 16
// query heads of the kv head are the MMA's 16 rows (zero-padded), so each
// K/V element crosses shared memory once per block, in its storage type:
// - four warps; each 64-key tile gives every warp 16 keys, and each warp
//   keeps its own online-softmax state (max, sum and a 16 x D float32
//   output) over its keys, so a tile needs ONE block-wide barrier (the one
//   that makes the landed tile visible); the four states are merged once,
//   through shared memory, at the end of the split;
// - a ring of kDecodeStages tiles loaded with cp.async, so two tiles are in
//   flight while one is computed; the split's page ids are prefetched into
//   shared memory before its first tile, so no copy waits on a page-table
//   load;
// - fragments come straight from the staged tiles (split_kv.cuh): a
//   permuted head-dim order makes each B fragment of K one 8-byte (16-bit
//   cache) or 4-byte (one-byte cache) load, and a permuted column order
//   does the same for V; int8 and fp8 elements are widened exactly in
//   registers, so a one-byte tile moves half the bytes of a bf16 one
//   through shared memory too. int8: the key scale multiplies the float32
//   scores and the value scale the float32 probabilities;
// - P.V stays as accurate as float32 FMA: each probability is split into
//   two halves of T (hi = T(p), lo = T(p - hi)), each with its own MMA, so
//   P carries about 16 (bf16) or 22 (fp16) bits; V is exact in T;
// - a split writes its merged (unnormalised) partial and (max, sum) to the
//   float32 scratch, and the last live split of a row to finish merges the
//   row's partials in split order (merge_if_last): no second launch. A row
//   with one live split writes its output directly.
// float32 q (the card's float32 reference runs): an FMA block with one warp
// per query head, tiles widened to float in shared memory, and a second
// launch that merges the splits.
// Rows with kv_len == 0 (batch padding) come out as zeros.
// UNIFIED (the decode class of K1 and K1u): q and out are the step's flat [T, Hq, D]
// tokens, and only the sequences of the batch's decode prefix run (token s
// is sequence s there); every other block exits at once, since the ragged
// blocks of the same step own those rows.
#pragma once

#include "paged_kv.cuh"
#include "split_kv.cuh"

namespace gllm {

// ---- bf16 / fp16 q: tensor cores -----------------------------------------

constexpr int kDecodeWarps = 4;
constexpr int kDecodeKeys = 16 * kDecodeWarps;  // keys per tile
constexpr int kDecodeStages = 3;                // tiles in the cp.async ring
constexpr int kPtSlots = 256;  // prefetched page ids: a split spans fewer
constexpr int kDecodeMaxGroup = 16;

// Blocks an SM must hold by registers (__launch_bounds__' minimum): a
// thread holds D / 2 float32 accumulators (and, up to D 128, Q's D / 4
// fragment registers), so 4 blocks (128 registers) up to D 64, 3 (170) at
// D 128 and 2 (255) at D 256.
template <int D>
struct DecodeRegCap {
  static constexpr int value = D <= 64 ? 4 : (D <= 128 ? 3 : 2);
};

// Shared memory of the tensor-core block, in bytes: kDecodeStages stages of
// a K and a V tile of kDecodeKeys rows in the cache's type (and, for int8,
// the rows' key and value scales), Q's 16 rows in T, and the split's page
// ids; at the end of the split the ring holds the warps' states for the
// merge. Row strides keep the fragment loads free of bank conflicts: 16-bit
// K and Q rows D + 16 elements (8 mod 32 words: a half-warp's 8-byte loads
// of 4 rows hit 4 distinct 8-word groups), 16-bit V rows D + 8 (4 mod 16
// words: rows 2t4 land 8 words apart), one-byte K and V rows D + 16 bytes
// (an odd multiple of 4 words). Blocks per SM: by shared memory (228 KB an
// SM, 1 KB reserved per block), capped by DecodeRegCap. ops/cuda/
// decode_attention.py computes the same numbers for its split plan.
template <typename T, typename TC, int D>
struct DecodeMmaSmem {
  static constexpr bool NARROW = sizeof(TC) == 1;
  static constexpr int LDQ = D + 16;
  static constexpr int LDK = D + 16;
  static constexpr int LDV = NARROW ? D + 16 : D + 8;
  static constexpr size_t K_BYTES = (size_t)kDecodeKeys * LDK * sizeof(TC);
  static constexpr size_t V_BYTES = (size_t)kDecodeKeys * LDV * sizeof(TC);
  static constexpr size_t SC_BYTES =
      is_q8<TC>() ? 2 * kDecodeKeys * sizeof(float) : 0;
  static constexpr size_t STAGE = K_BYTES + V_BYTES + SC_BYTES;
  static constexpr size_t Q_OFF = kDecodeStages * STAGE;
  static constexpr size_t PT_OFF = Q_OFF + 16 * LDQ * sizeof(T);
  static constexpr size_t LOOP = PT_OFF + kPtSlots * sizeof(int);
  static constexpr int LDO = D + 4;  // merge: a warp's output rows, float
  static constexpr size_t MERGE =
      (size_t)kDecodeWarps * 16 * (LDO + 2) * sizeof(float);
  static constexpr size_t BYTES = LOOP > MERGE ? LOOP : MERGE;
  static constexpr int BY_SMEM = (int)(233472 / (BYTES + 1024));
  static constexpr int BLOCKS_PER_SM =
      BY_SMEM < DecodeRegCap<D>::value ? BY_SMEM : DecodeRegCap<D>::value;
};

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// (x0, x1) as a hi pair of T and the lo pair of what hi leaves out.
template <typename T>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = Mma<T>::pack(x0, x1);
  const float2 h = unpack2<T>(hi);
  lo = Mma<T>::pack(x0 - h.x, x1 - h.y);
}

template <typename T, typename TC, int D, bool UNIFIED>
__global__ void __launch_bounds__(32 * kDecodeWarps,
                                  (DecodeMmaSmem<T, TC, D>::BLOCKS_PER_SM))
    decode_mma_kernel(const T* __restrict__ q, const TC* __restrict__ kc,
                      const TC* __restrict__ vc, const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ cu_q_lens,
                      const int* __restrict__ kv_lens,
                      const int* __restrict__ page_table,
                      T* __restrict__ out, float* __restrict__ part,
                      int max_pages, int num_q_heads, int num_kv_heads,
                      int group, int page_size, int page_offset, int chunk,
                      int num_splits, float scale_log2) {
  using SM = DecodeMmaSmem<T, TC, D>;
  constexpr bool Q8 = is_q8<TC>();
  constexpr bool QREG = D <= 128;  // Q's fragments in registers
  constexpr int KSTEPS = D / 16;
  constexpr int GROUPS = D / 32;   // output column groups of 4 n-tiles
  constexpr int NACC = KSTEPS >= 8 ? 2 : 1;  // Q.K^T accumulator sets
  extern __shared__ __align__(16) unsigned char decode_mma_smem[];
  unsigned char* smem = decode_mma_smem;
  T* sq = reinterpret_cast<T*>(smem + SM::Q_OFF);
  int* spt = reinterpret_cast<int*>(smem + SM::PT_OFF);

  const int s = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (UNIFIED) {
    if (!in_decode_prefix(cu_q_lens, s)) return;  // block-uniform
  }
  const int kv_len = kv_lens[s];
  const int64_t row0 = (int64_t)s * num_q_heads + (int64_t)h * group;
  const int j_begin = split * chunk;
  if (j_begin >= kv_len) {
    // nothing to read; with kv_len == 0 split 0 owns the zero output rows
    if (split == 0)
      for (int i = tid; i < group * D; i += blockDim.x)
        out[row0 * D + i] = from_float<T>(0.f);
    return;
  }
  const int j_end = min(kv_len, j_begin + chunk);
  const int n_live = min(num_splits, (kv_len + chunk - 1) / chunk);
  // Q's rows (zero past the group), in flight while the page ids load;
  // committed with the first tile
  constexpr int QCH = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  for (int c = tid; c < 16 * QCH; c += blockDim.x) {
    const int r = c / QCH, col = (c % QCH) * (16 / (int)sizeof(T));
    const bool valid = r < group;
    cp_async16(sq + r * SM::LDQ + col,
               q + (valid ? (row0 + r) * D + col : 0), valid);
  }
  prefetch_pages(spt, page_table + (int64_t)s * max_pages, j_begin, j_end,
                 page_size);
  // stage st of the ring: K tile, V tile (and the int8 scales)
  auto stage_k = [&](int st) {
    return reinterpret_cast<TC*>(smem + st * SM::STAGE);
  };
  auto stage_v = [&](int st) {
    return reinterpret_cast<TC*>(smem + st * SM::STAGE + SM::K_BYTES);
  };
  auto stage_sc = [&](int st) {  // key scales, then value scales
    return reinterpret_cast<float*>(smem + st * SM::STAGE + SM::K_BYTES +
                                    SM::V_BYTES);
  };
  // keys [j0, j0 + kDecodeKeys) into stage st; keys at or past j_end are
  // zero-filled (no key or scale at or beyond kv_len is read). TPR threads
  // copy a row (a warp moves whole 128-byte runs), and each computes the
  // row's address once.
  auto load_tile = [&](int st, int j0) {
    constexpr int CH = 16 / (int)sizeof(TC);
    constexpr int CPR = D / CH;
    constexpr int TPR = CPR < 8 ? CPR : 8;
    for (int r = tid / TPR; r < kDecodeKeys; r += 32 * kDecodeWarps / TPR) {
      TC* sk = stage_k(st) + r * SM::LDK;
      TC* sv = stage_v(st) + r * SM::LDV;
      const int j = j0 + r;
      const bool valid = j < j_end;
      const int64_t page =
          valid ? split_page(spt, j, j_begin, page_size, page_offset) : 0;
      const int64_t off =
          valid ? ((page * page_size + j % page_size) * num_kv_heads + h) * D
                : 0;
#pragma unroll
      for (int cc = tid % TPR; cc < CPR; cc += TPR) {
        cp_async16(sk + cc * CH, kc + off + cc * CH, valid);
        cp_async16(sv + cc * CH, vc + off + cc * CH, valid);
      }
      if constexpr (Q8) {
        if (tid % TPR == 0) {
          float* sc = stage_sc(st) + r;
          const int64_t i = page * num_kv_heads + h;
          cp_async4(sc, ks + i, valid);
          cp_async4(sc + kDecodeKeys, vs + i, valid);
        }
      }
    }
    cp_async_commit();
  };

  const int n_tiles = (j_end - j_begin + kDecodeKeys - 1) / kDecodeKeys;
#pragma unroll
  for (int st = 0; st < kDecodeStages - 1; ++st) {
    if (st < n_tiles)
      load_tile(st, j_begin + st * kDecodeKeys);
    else
      cp_async_commit();  // keep the group count
  }

  // Q's A fragment of 16-wide step kk, in the permuted dim order
  auto q_frag = [&](uint32_t* a, int kk) {
    const uint2 r0 =
        *reinterpret_cast<const uint2*>(sq + g * SM::LDQ + kk * 16 + 4 * t4);
    const uint2 r8 = *reinterpret_cast<const uint2*>(
        sq + (g + 8) * SM::LDQ + kk * 16 + 4 * t4);
    a[0] = r0.x;
    a[1] = r8.x;
    a[2] = r0.y;
    a[3] = r8.y;
  };
  uint32_t qf[QREG ? KSTEPS : 1][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDecodeStages - 2));
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    {
      const int nx = it + kDecodeStages - 1;  // into tile it - 1's stage
      if (nx < n_tiles)
        load_tile(nx % kDecodeStages, j_begin + nx * kDecodeKeys);
      else
        cp_async_commit();
    }
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) q_frag(qf[kk], kk);
      }
    }
    const int st = it % kDecodeStages;
    const int jw = j_begin + it * kDecodeKeys + warp * 16;  // warp's keys
    if (jw >= j_end) continue;  // warp-uniform: all of them masked
    const TC* sk = stage_k(st) + warp * 16 * SM::LDK;
    const TC* sv = stage_v(st) + warp * 16 * SM::LDV;

    // S = Q K^T over the warp's 16 keys: two n-tiles of 8, each summed in
    // NACC independent accumulators (shorter MMA dependency chains)
    float acc[NACC][2][4];
#pragma unroll
    for (int u = 0; u < NACC; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[u][i / 4][i % 4] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        q_frag(a, kk);
      }
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        uint32_t b[2];
        load_k_frag<T, TC>(b, sk + (jt * 8 + g) * SM::LDK + kk * 16 + 4 * t4);
        Mma<T>::run(acc[kk % NACC][jt], a, b[0], b[1]);
      }
    }
    float sc[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x = acc[0][i / 4][i % 4];
#pragma unroll
      for (int u = 1; u < NACC; ++u) x += acc[u][i / 4][i % 4];
      sc[i / 4][i % 4] = x;
    }
    // scores in the log2 domain; rows g (e < 2) and g + 8 (e >= 2)
    const float* sks = Q8 ? stage_sc(st) + warp * 16 : nullptr;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kw = jt * 8 + 2 * t4 + (e & 1);  // key within the warp's
        float x = sc[jt][e] * scale_log2;
        if constexpr (Q8) x *= sks[kw];
        x = jw + kw < j_end ? x : -INFINITY;
        sc[jt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use[i]);  // 0 before the first key
      m[i] = m_new;
    }
    const float* svs = Q8 ? stage_sc(st) + kDecodeKeys + warp * 16 : nullptr;
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[jt][e] - m_use[e >> 1]);
        sum[e >> 1] += p;
        // P.V takes p times the key's value scale (int8)
        sc[jt][e] = Q8 ? p * svs[jt * 8 + 2 * t4 + (e & 1)] : p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // P as the A fragment of one 16-key step (the S accumulators' layout),
    // in two halves of T
    uint32_t ph[4], pl[4];
    split_pair<T>(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_pair<T>(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_pair<T>(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_pair<T>(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int cg = 0; cg < GROUPS; ++cg) {
      uint32_t b[4][2];
      load_v_frags<T, TC, 4>(b, sv + cg * 32, SM::LDV, g, t4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Mma<T>::run(o[cg * 4 + j], ph, b[j][0], b[j][1]);
        Mma<T>::run(o[cg * 4 + j], pl, b[j][0], b[j][1]);
      }
    }
  }

  // merge the four warps' states: through the (drained) ring
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  float* so = reinterpret_cast<float*>(smem);             // [w][16][LDO]
  float* sml = so + kDecodeWarps * 16 * SM::LDO;          // [w][16][2]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* dst = so + (warp * 16 + g + 8 * half) * SM::LDO;
#pragma unroll
    for (int cg = 0; cg < GROUPS; ++cg)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[cg * 32 + out_col<4>(t4, j, e)] = o[cg * 4 + j][2 * half + e];
    if (t4 == 0) {
      sml[(warp * 16 + g + 8 * half) * 2] = m[half];
      sml[(warp * 16 + g + 8 * half) * 2 + 1] = l[half];
    }
  }
  __syncthreads();
  float* pvals = split_partials(part);
  float* pstats = pvals + (int64_t)gridDim.x * num_q_heads * num_splits * D;
  for (int e = tid; e < group * (D / 4); e += blockDim.x) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float mw[kDecodeWarps], mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      mw[w] = sml[(w * 16 + r) * 2];
      mx = fmaxf(mx, mw[w]);  // finite: key j_begin is warp 0's
    }
    float lsum = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float wt = exp2f(mw[w] - mx);
      lsum = fmaf(wt, sml[(w * 16 + r) * 2 + 1], lsum);
      const float* src = so + (w * 16 + r) * SM::LDO + c;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(wt, src[i], acc[i]);
    }
    if (n_live == 1) {
      const float inv = 1.f / lsum;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[(row0 + r) * D + c + i] = from_float<T>(acc[i] * inv);
    } else {
      const int64_t pr = (row0 + r) * num_splits + split;
      *reinterpret_cast<float4*>(pvals + pr * D + c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      if (c == 0) *reinterpret_cast<float2*>(pstats + 2 * pr) =
          make_float2(mx, lsum);
    }
  }
  if (n_live > 1)
    merge_if_last<T, D>(pvals, pstats,
                        reinterpret_cast<int*>(part) +
                            (int64_t)s * num_kv_heads + h,
                        n_live, out, row0, group, num_splits);
}

// ---- float32 q: plain FMA ---------------------------------------------------

constexpr int kDecodeTile = 32;  // keys per tile: one per lane

// Shared memory of the float32 block: a K tile (row stride D + 1, odd: lane j
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
    decode_fma_kernel(const T* __restrict__ q,
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

// The float32 path: the FMA block and, with more than one split, the merge
// pass (partials after the scratch's counters, which it leaves alone).
template <typename T, typename TC, int D, bool UNIFIED>
static void launch_decode_fma(const void* q, const void* k, const void* v,
                              const float* ks, const float* vs,
                              const int* cu, const int* kv_lens,
                              const int* pt, void* out, float* part, int S,
                              int max_pages, int hq, int hkv, int page_size,
                              int page_offset, int chunk, int num_splits,
                              float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const dim3 grid(S, hkv, num_splits);
  float* parts = part ? split_partials(part) : nullptr;
  auto kern = decode_fma_kernel<T, TC, D, UNIFIED>;
  static bool configured = !DecodeSmem<D>::DYNAMIC;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)DecodeSmem<D>::bytes(kDecodeMaxGroup));
    if (e != cudaSuccess) return;
    configured = true;
  }
  kern<<<grid, 32 * group, DecodeSmem<D>::bytes(group), stream>>>(
      static_cast<const T*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), ks, vs, cu, kv_lens, pt,
      static_cast<T*>(out), parts, max_pages, hq, hkv, group, page_size,
      page_offset, chunk, num_splits, scale * kLog2e);
  if (num_splits > 1)
    decode_merge_kernel<T, D, UNIFIED><<<dim3(S, hq), 32, 0, stream>>>(
        parts, cu, kv_lens, static_cast<T*>(out), hq, chunk, num_splits);
}

// Launch the decode kernel over S sequences: the tensor-core block for
// bf16 / fp16 q (splits merged in the kernel), or the FMA block and, with
// more than one split, the merge pass for float32 q. cu_q_lens is read only
// when UNIFIED.
template <typename T, typename TC, int D, bool UNIFIED>
static int launch_decode(const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* cu,
                         const int* kv_lens, const int* pt, void* out,
                         float* part, int S, int max_pages, int hq, int hkv,
                         int page_size, int page_offset, int chunk,
                         int num_splits, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const dim3 grid(S, hkv, num_splits);
  if constexpr (!std::is_same<T, float>::value) {
    using SM = DecodeMmaSmem<T, TC, D>;
    auto kern = decode_mma_kernel<T, TC, D, UNIFIED>;
    static bool configured = false;
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SM::BYTES);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    kern<<<grid, 32 * kDecodeWarps, SM::BYTES, stream>>>(
        static_cast<const T*>(q), static_cast<const TC*>(k),
        static_cast<const TC*>(v), ks, vs, cu, kv_lens, pt,
        static_cast<T*>(out), part, max_pages, hq, hkv, group, page_size,
        page_offset, chunk, num_splits, scale * kLog2e);
  } else {
    launch_decode_fma<T, TC, D, UNIFIED>(q, k, v, ks, vs, cu, kv_lens, pt,
                                         out, part, S, max_pages, hq, hkv,
                                         page_size, page_offset, chunk,
                                         num_splits, scale, stream);
  }
  return 0;
}

// The arguments the decode launchers take (GQA, and MLA with hq 16 over one
// latent stream), checked on the host: a split spans at most kPtSlots
// pages, and the rows fit the scratch's counters.
static inline bool decode_args_ok(int S, int hq, int hkv, int max_pages,
                                  int page_size, int chunk, int num_splits,
                                  const void* part) {
  const int group = hkv > 0 ? hq / hkv : 0;
  return S > 0 && group >= 1 && group <= kDecodeMaxGroup &&
         group * hkv == hq && num_splits >= 1 && chunk >= kDecodeTile &&
         chunk % kDecodeTile == 0 && page_size >= 1 &&
         (chunk + page_size - 1) / page_size + 1 <= kPtSlots &&
         (num_splits == 1 ||
          (part != nullptr && (int64_t)S * hkv <= kCounterSlots)) &&
         (int64_t)num_splits * chunk >= (int64_t)max_pages * page_size;
}

}  // namespace gllm
