// MLA paged attention over one shared latent cache: the kernels and their
// launcher, shared by mla_decode_attention.cu (K2m) and
// mla_ragged_attention.cu (K1m).
//
// DeepSeek's absorbed attention is MQA over a latent cache: each token keeps
// one row [c_kv | k_pe] of DL = kv_lora_rank + qk_rope_head_dim values (576
// at DeepSeek-V2-Lite), every query head scores over the whole row, and the
// values are the row's leading DV = kv_lora_rank lanes (512). The TPU kernel
// (ragged_paged_attention / paged_decode_attention with v_cache=None) reads
// each latent page once, for both products; so do these kernels: a tile of
// keys lands in shared memory once, its rows feed Q.K^T, and its first DV
// columns are V for P.V.
//
// Bound on the card. Per key the 16 query heads do 16 * 2 * (DL + DV)
// flops (34.8 kflop at V2-Lite) over DL * 2 bytes (1152 in bf16), about 30
// flops per byte: a decode step is still bound by bytes against the bf16
// tensor cores (295 flops per byte) but not against float32 FMA, and a
// prefill chunk, whose key tiles serve 64 query rows, is bound by
// operations. So both modes run on the tensor cores with float32
// accumulators.
//
// Ragged mode (bf16 / fp16; mla_ragged_wgmma_kernel below): a block of 4
// tokens x 16 heads = 64 rows, the M of a warpgroup product, walks its
// keys in 64-key latent tiles with wgmma for both products (two
// warpgroups: the tile's keys split for Q.K^T, the output columns for
// P.V). Its first design (mma.sync, one warp per 16 rows x 8 keys)
// reloaded Q's fragments for every tile and read V once per row group:
// shared memory, not the tensor cores, bound it (10% of the bf16 rate).
// wgmma is kept over an mma.sync block that holds Q's fragments in
// registers: a 64 x 512 float32 output needs 128 registers a thread
// across two warpgroups already, so an mma.sync block could keep neither
// Q nor more than one 16-row tile per warp in registers and would read
// its operands from shared memory several times a tile; wgmma reads them
// by descriptor, and its first build ran more than twice as fast as the
// mma.sync block at the serving path's mixed shape (PERF.md).
// Decode mode has a block of its own (mla_decode_mma_kernel below: one
// token, one split of its keys, mma.sync with the 16 heads as the m16,
// a deeper ring, fewer barriers). float32 runs a plain FMA kernel (one
// token per block) for the reference paths; the tensor cores take no
// full-precision float32. The FMA kernel widens an fp8 latent as it loads.
// UNIFIED (K1um, mla_unified_attention.cu): decode blocks run only for the
// batch's decode prefix and ragged blocks only for the other sequences, as
// the GQA kernels' unified classes do (paged_kv.cuh).
// Not yet done: TMA and a producer warp for the latent tiles, and one
// launch for UNIFIED's two classes.
#pragma once

#include "decode_attention.cuh"
#include "ragged_attention.cuh"
#include "wgmma.cuh"

namespace gllm {

constexpr int kMlaHeads = 16;  // query heads over the one latent stream
constexpr int kMlaKeys = 32;   // keys per latent tile
constexpr int kMlaQuarters = 4;  // warps per 16-row group

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Zero the output rows [row0, row0 + rows) of width DV.
template <typename T, int DV>
__device__ __forceinline__ void zero_rows(T* out, int64_t row0, int rows) {
  for (int i = threadIdx.x; i < rows * DV; i += blockDim.x)
    out[row0 * DV + i] = from_float<T>(0.f);
}

// Which sequence, token tile and key range is this block's? Returns false
// when the block has no key to read (it has then written what it owns) or,
// UNIFIED, no row of its class.
template <typename T, int DV, bool DECODE, bool UNIFIED>
__device__ __forceinline__ bool mla_locate(const int* cu_q_lens,
                                           const int* kv_lens, T* out, int S,
                                           int num_tokens, int bq, int chunk,
                                           int num_splits, int* s_seq,
                                           int* s_tile, int& seq,
                                           int& q_start, int& t_first,
                                           int& n_tok, int& pos0,
                                           int& j_begin, int& j_end) {
  int q_len;
  if constexpr (DECODE) {
    seq = blockIdx.x;
    if constexpr (UNIFIED) {
      if (!in_decode_prefix(cu_q_lens, seq)) return false;  // block-uniform
    }
    q_start = seq;  // token s is sequence s (UNIFIED: in the decode prefix)
    q_len = 1;
    t_first = 0;
    j_begin = blockIdx.z * chunk;
  } else {
    locate_block<UNIFIED>(cu_q_lens, S, bq, s_seq, s_tile);
    seq = *s_seq;
    if (seq < 0) {
      zero_padding(out, cu_q_lens, S, *s_tile, bq, num_tokens, kMlaHeads,
                   kMlaHeads, DV, 0);
      return false;
    }
    q_start = cu_q_lens[seq];
    q_len = cu_q_lens[seq + 1] - q_start;
    // a sequence's last tokens see the most keys: its blocks take its
    // tiles last first, so the longest walks start early, not in the tail
    t_first = ((q_len + bq - 1) / bq - 1 - *s_tile) * bq;
    j_begin = 0;
  }
  const int kv_len = kv_lens[seq];
  n_tok = min(bq, q_len - t_first);
  pos0 = kv_len - q_len + t_first;
  j_end = DECODE ? min(kv_len, j_begin + chunk) : min(kv_len, pos0 + n_tok);
  if (j_begin >= j_end) {
    // nothing to read; with one split this block owns its output rows
    if (!DECODE || num_splits == 1)
      zero_rows<T, DV>(out, (int64_t)(q_start + t_first) * kMlaHeads,
                       n_tok * kMlaHeads);
    return false;
  }
  return true;
}

// ---- bf16 / fp16, ragged mode: wgmma ---------------------------------------
//
// One block per 4 tokens of one sequence: 64 query rows (token = row / 16,
// head = row % 16), the M of one wgmma. Two warpgroups (256 threads, one
// block an SM) walk the block's keys in 64-key latent tiles. Per tile:
// - S = Q K^T: warpgroup w scores keys 32 w .. 32 w + 31 of the tile for
//   all 64 rows (m64n32k16 over DL, Q and the tile read by descriptor);
//   warp i of a warpgroup holds token i's 16 rows.
// - The online softmax runs in registers. The two warpgroups swap their
//   row maxima and row sums through shared memory (two barriers), so both
//   keep the same running (max, sum) for every row; P (bf16 / fp16) goes
//   once through shared memory, swizzled as a K-major A operand.
// - O += P V: warpgroup w owns output columns [w DV / 2, (w + 1) DV / 2)
//   (m64n256k16: 128 float32 accumulators a thread); V is the tile's
//   leading DV columns, read in place as an MN-major B operand.
// The latent tiles come through a two-stage cp.async ring into the
// swizzled layout both descriptors read (four threads a key row, the row's
// address computed once); Q (64 x DL) stays for the whole walk. At (576,
// 512) that is 72 KB of Q, two 72 KB stages and 8 KB of P: 225 KB. A
// tile costs three block barriers (tile landed, maxima, P). fp8 latent:
// two one-byte stages (36 KB each) and ONE tile of T, into which each
// stage is widened exactly once it lands (a fourth barrier); the block
// keeps the same size. (96, 64), the small test models' geometry: the
// tile's second column block holds 32 lanes, and warpgroup 0 alone does
// P.V (m64n64k16).

constexpr int kMlaWgKeys = 64;                     // keys per latent tile
constexpr int kMlaWgThreads = 256;                 // two warpgroups
constexpr int kMlaWgRows = 64;                     // query rows a block
constexpr int kMlaWgTokens = kMlaWgRows / kMlaHeads;

template <typename T, typename TC, int DL, int DV>
struct MlaWgSmem {
  static constexpr bool NARROW = sizeof(TC) == 1;
  static constexpr int DLB = (DL + 63) / 64;        // 64-lane column blocks
  static constexpr int PVN = DV >= 128 ? DV / 2 : DV;  // P.V columns a WG
  static constexpr int PV_WG = DV / PVN;            // warpgroups doing P.V
  static constexpr size_t BLOCK_Q = (size_t)kMlaWgRows * 128;
  static constexpr size_t BLOCK_K = (size_t)kMlaWgKeys * 128;
  static constexpr size_t TILE = DLB * BLOCK_K;
  static constexpr int STAGES = NARROW ? 1 : 2;     // tiles of T
  static constexpr size_t K_OFF = DLB * BLOCK_Q;
  static constexpr size_t P_OFF = K_OFF + STAGES * TILE;
  static constexpr size_t N_OFF = P_OFF + (size_t)kMlaWgRows * 128;
  static constexpr size_t STAGE8 = (size_t)kMlaWgKeys * DL;  // fp8 bytes
  static constexpr size_t X_OFF = N_OFF + (NARROW ? 2 * STAGE8 : 0);
  // row maxima and sums of each warpgroup: [2][2][64] float32
  static constexpr size_t BYTES = X_OFF + 4 * kMlaWgRows * sizeof(float);
  static constexpr size_t ALLOC = BYTES + 1024;  // the base aligned to 1 KB
  static_assert(ALLOC <= 232448, "MLA ragged block over 227 KB");
};

template <typename T, typename TC, int DL, int DV, bool UNIFIED>
__global__ void __launch_bounds__(kMlaWgThreads, 1)
    mla_ragged_wgmma_kernel(const T* __restrict__ q,
                            const TC* __restrict__ lat,
                            const int* __restrict__ cu_q_lens,
                            const int* __restrict__ kv_lens,
                            const int* __restrict__ page_table,
                            T* __restrict__ out, float* __restrict__ part,
                            int num_tokens, int S, int max_pages,
                            int page_size, int page_offset, int chunk,
                            int num_splits, float scale_log2) {
  using SM = MlaWgSmem<T, TC, DL, DV>;
  constexpr bool NARROW = SM::NARROW;
  constexpr int PVN = SM::PVN;
  constexpr int KSTEPS = DL / 16;
  static_assert(DL % 16 == 0 && DV % 64 == 0 && DV <= DL &&
                    (PVN == 256 || PVN == 64),
                "MLA geometry");
  extern __shared__ __align__(1024) unsigned char mla_wg_raw[];
  unsigned char* smem =
      mla_wg_raw + ((1024u - (smem_addr(mla_wg_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_addr(smem);
  float* sx = reinterpret_cast<float*>(smem + SM::X_OFF);  // [2][2][64]
  __shared__ int s_seq, s_tile;

  int seq, q_start, t_first, n_tok, pos0, j_begin, j_end;
  if (!mla_locate<T, DV, false, UNIFIED>(
          cu_q_lens, kv_lens, out, S, num_tokens, kMlaWgTokens, chunk,
          num_splits, &s_seq, &s_tile, seq, q_start, t_first, n_tok, pos0,
          j_begin, j_end))
    return;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;                   // warpgroup
  const int warp = (tid >> 5) & 3;           // warp in the warpgroup: token
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n_rows = n_tok * kMlaHeads;
  const int64_t row_base = (int64_t)(q_start + t_first) * kMlaHeads;
  const int* pt_row = page_table + (int64_t)seq * max_pages;
  const bool live = warp < n_tok;            // warp-uniform
  const int pos = pos0 + warp;   // the last key this warp's token sees

  // Q (zero past n_rows), committed with the first tile
  {
    constexpr int CPR = DL / 8;
    for (int i = tid; i < kMlaWgRows * CPR; i += kMlaWgThreads) {
      const int r = i / CPR, c = i % CPR;
      const bool valid = r < n_rows;
      cp_async16(smem + sw128_offset<kMlaWgRows>(r, c),
                 q + (valid ? (row_base + r) * DL + c * 8 : 0), valid);
    }
  }
  // stage `st` of the ring: key rows j0 .. j0 + 63 (zero past j_end), four
  // threads a row; over fp8 into the byte stage, unswizzled
  auto issue = [&](int st, int j0) {
    const int r = tid >> 2, part4 = tid & 3;
    const bool valid = r < j_end - j0;
    const TC* src =
        lat + (valid ? kv_row_offset(pt_row, j0 + r, page_size, page_offset,
                                     1, DL, 0)
                     : 0);
    if constexpr (NARROW) {
      unsigned char* dst = smem + SM::N_OFF + st * SM::STAGE8 + r * DL;
      for (int c = part4; c < DL / 16; c += 4)
        cp_async16(dst + c * 16, src + c * 16, valid);
    } else {
      unsigned char* dst = smem + SM::K_OFF + st * SM::TILE;
      for (int c = part4; c < DL / 8; c += 4)
        cp_async16(dst + sw128_offset<kMlaWgKeys>(r, c), src + c * 8, valid);
    }
    cp_async_commit();
  };

  float o[PVN / 2];
#pragma unroll
  for (int i = 0; i < PVN / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int row0 = warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const int n_tiles = (j_end - j_begin + kMlaWgKeys - 1) / kMlaWgKeys;
  issue(0, j_begin);
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = j_begin + it * kMlaWgKeys;
    asm volatile("cp.async.wait_group 0;\n" ::);
    uint32_t kt;
    if constexpr (NARROW) {
      __syncthreads();  // both warpgroups' P.V of the last tile is done
      const unsigned char* src = smem + SM::N_OFF + (it & 1) * SM::STAGE8;
      constexpr int CH = DL / 16;
      for (int i = tid; i < kMlaWgKeys * CH; i += kMlaWgThreads) {
        const int r = i / CH, c = i % CH;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * DL + c * 16);
        const uint32_t* wd = reinterpret_cast<const uint32_t*>(&raw);
        uint32_t w[8];  // pairs widened by one cvt each (split_kv.cuh)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[2 * k] = widen2<T, TC>(wd[k]);
          w[2 * k + 1] = widen2<T, TC>(wd[k] >> 16);
        }
        unsigned char* dst = smem + SM::K_OFF;
        *reinterpret_cast<uint4*>(dst + sw128_offset<kMlaWgKeys>(r, 2 * c)) =
            make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst +
                                  sw128_offset<kMlaWgKeys>(r, 2 * c + 1)) =
            make_uint4(w[4], w[5], w[6], w[7]);
      }
      kt = sbase + SM::K_OFF;
    } else {
      kt = sbase + SM::K_OFF + (it & 1) * SM::TILE;
    }
    fence_proxy_async();
    __syncthreads();  // the tile is in (and, 16-bit, the last one is done)
    if (it + 1 < n_tiles) issue((it + 1) & 1, j0 + kMlaWgKeys);

    // S = Q K^T over this warpgroup's 32 keys
    float s[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint64_t da = gmma_desc(
          sbase + (kk >> 2) * SM::BLOCK_Q + (kk & 3) * 32, 16, 1024);
      const uint64_t db = gmma_desc(
          kt + (kk >> 2) * SM::BLOCK_K + wg * 32 * 128 + (kk & 3) * 32, 16,
          1024);
      Wgmma<T, 32>::template run<0>(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<16>(s);

    // masked scores (log2 domain) and this warpgroup's row maxima
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = j0 + wg * 32 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const bool ok = live && j < j_end && j <= pos;
      s[i] = ok ? s[i] * scale_log2 : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t4 == 0) sx[wg * kMlaWgRows + row0 + 8 * h] = mx[h];
    }
    __syncthreads();  // both warpgroups' maxima
    float alpha[2], m_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const float m_new =
          fmaxf(m_run[h], fmaxf(sx[r], sx[kMlaWgRows + r]));
      m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m_run[h] - m_safe[h]);  // 0 before the first key
      m_run[h] = m_new;
    }
    // P into shared memory (K-major, swizzled) and the row sums
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int chunk = wg * 4 + i;  // 16-byte chunk of the 64-key row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        const float p0 = exp2f(s[4 * i + 2 * h] - m_safe[h]);
        const float p1 = exp2f(s[4 * i + 2 * h + 1] - m_safe[h]);
        sum[h] += p0 + p1;
        *reinterpret_cast<uint32_t*>(smem + SM::P_OFF + r * 128 +
                                     ((chunk ^ (r & 7)) << 4) + 4 * t4) =
            Mma<T>::pack(p0, p1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      if (t4 == 0) sx[(2 + wg) * kMlaWgRows + row0 + 8 * h] = sum[h];
    }
    fence_proxy_async();
    __syncthreads();  // P and both warpgroups' sums
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      l_run[h] = l_run[h] * alpha[h] + sx[2 * kMlaWgRows + r] +
                 sx[3 * kMlaWgRows + r];
    }

    // O = O * alpha + P V over this warpgroup's columns
    if (wg < SM::PV_WG) {
#pragma unroll
      for (int i = 0; i < PVN / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      fence_regs<PVN / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kMlaWgKeys / 16; ++kk) {
        const uint64_t da =
            gmma_desc(sbase + SM::P_OFF + kk * 32, 16, 1024);
        const uint64_t db = gmma_desc(
            kt + kk * 2048 + wg * (PVN / 64) * SM::BLOCK_K,
            (uint32_t)SM::BLOCK_K, 1024);
        Wgmma<T, PVN>::template run<1>(o, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<PVN / 2>(o);
    }
  }

  if (!live || wg >= SM::PV_WG) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const float inv = l_run[h] > 0.f ? 1.f / l_run[h] : 0.f;
    T* orow = out + (row_base + r) * DV + wg * PVN + 2 * t4;
#pragma unroll
    for (int i = 0; i < PVN / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) =
          Mma<T>::pack(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
  }
}

// ---- decode mode, bf16 / fp16: tensor cores ---------------------------------
//
// One block per (token, split of `chunk` keys): the token's 16 heads are
// the 16 rows of every MMA. The block holds GROUPS groups of four warps;
// group gi takes the split's 32-key tiles gi, gi + GROUPS, ... with its
// own running softmax state, and the groups' states merge once at the end
// of the split (two groups over a bf16 / fp16 latent, whose ring leaves
// room for one block an SM: the second group keeps the SM busy while the
// first waits at a barrier). In a group, for each tile warp w scores keys
// 8w .. 8w + 7 over the whole latent row, and then every warp takes all 32
// keys for its quarter of the DV output columns. The tile's row max and
// row sums are exchanged through shared memory, so a tile costs three
// barriers of its group (tile landed; maxima; probabilities: named
// barriers, one per group), and every warp of a group keeps the same
// running (max, sum) for its rows. The latent tiles come through a ring
// of kMlaDecodeStages cp.async stages shared out among the groups, the
// split's page ids are prefetched, and the splits are sized by the
// wrapper for one wave of blocks, so a block walks many tiles per Q load.
// A row with one live split writes its output; otherwise the last split
// to finish merges the token's splits (merge_if_last).
// fp8 latent: the bytes are staged and read straight into the fragments
// (split_kv.cuh: permuted dims for Q.K^T, permuted columns for P.V),
// widened in registers; Q's rows are then read in the permuted dim order
// too. bf16 / fp16 latent: ldmatrix, as in ragged mode.

constexpr int kMlaDecodeStages = 4;

template <typename TC>
struct MlaDecodeGroups {
  static constexpr int value = sizeof(TC) == 1 ? 1 : 2;
};

template <typename T, typename TC, int DL, int DV>
struct MlaDecodeSmem {
  static constexpr bool NARROW = sizeof(TC) == 1;
  static constexpr int GROUPS = MlaDecodeGroups<TC>::value;
  static constexpr int THREADS = 32 * kMlaQuarters * GROUPS;
  // fp8: rows D + 16 (bytes: an odd multiple of 4 words; Q: 8 mod 32
  // words); 16-bit: D + 8, as in ragged mode
  static constexpr int LDK = NARROW ? DL + 16 : DL + 8;
  static constexpr int LDQ = NARROW ? DL + 16 : DL + 8;
  static constexpr int LDP = kMlaKeys + 8;
  static constexpr size_t TILE = (size_t)kMlaKeys * LDK * sizeof(TC);
  static constexpr size_t Q_OFF = kMlaDecodeStages * TILE;
  static constexpr size_t P_OFF = Q_OFF + (size_t)kMlaHeads * LDQ * sizeof(T);
  static constexpr size_t X_OFF =
      P_OFF + (size_t)GROUPS * kMlaHeads * LDP * sizeof(T);
  static constexpr size_t PT_OFF =
      X_OFF + (size_t)GROUPS * 2 * kMlaQuarters * kMlaHeads * sizeof(float);
  static constexpr size_t BYTES = PT_OFF + kPtSlots * sizeof(int);
  // at the end of the split: the second group's output and (max, sum)
  static constexpr size_t MERGE =
      (size_t)kMlaHeads * (DV + 2) * sizeof(float);
  static_assert(MERGE <= Q_OFF, "the group merge reuses the ring");
  static constexpr int BY_SMEM = (int)(233472 / (BYTES + 1024));
  // a thread holds DV / 8 float32 accumulators: one block of two groups
  // (255 registers), or of one group 2 blocks at DV 512, 4 below
  static constexpr int BY_REGS = GROUPS > 1 ? 1 : (DV >= 512 ? 2 : 4);
  static constexpr int BLOCKS_PER_SM = BY_SMEM < BY_REGS ? BY_SMEM : BY_REGS;
};

template <typename T, typename TC, int DL, int DV, bool UNIFIED>
__global__ void __launch_bounds__((MlaDecodeSmem<T, TC, DL, DV>::THREADS),
                                  (MlaDecodeSmem<T, TC, DL, DV>::BLOCKS_PER_SM))
    mla_decode_mma_kernel(const T* __restrict__ q, const TC* __restrict__ lat,
                          const int* __restrict__ cu_q_lens,
                          const int* __restrict__ kv_lens,
                          const int* __restrict__ page_table,
                          T* __restrict__ out, float* __restrict__ part,
                          int max_pages, int page_size, int page_offset,
                          int chunk, int num_splits, float scale_log2) {
  using SM = MlaDecodeSmem<T, TC, DL, DV>;
  constexpr bool NARROW = SM::NARROW;
  constexpr int GROUPS = SM::GROUPS;
  constexpr int SPG = kMlaDecodeStages / GROUPS;  // ring stages a group
  constexpr int GT = 32 * kMlaQuarters;           // threads a group
  constexpr int DVW = DV / kMlaQuarters;  // output columns per warp
  constexpr int NDW = DVW / 8;            // their n-tiles
  constexpr int NJ = DVW >= 32 ? 4 : 2;   // fp8: n-tiles per column group
  constexpr int NACC = (DL / 16) % 4 == 0 ? 4 : 2;  // Q.K^T accumulators
  static_assert(DL % 16 == 0 && DVW % 16 == 0 && DV <= DL, "MLA geometry");
  static_assert(SPG >= 2, "a group needs a tile in flight");
  extern __shared__ __align__(16) unsigned char mla_dec_smem[];
  unsigned char* smem = mla_dec_smem;
  T* sq = reinterpret_cast<T*>(smem + SM::Q_OFF);
  int* spt = reinterpret_cast<int*>(smem + SM::PT_OFF);

  const int seq = blockIdx.x, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int gi = tid / GT, gtid = tid % GT, warp = gtid / 32;
  const int g = lane >> 2, t4 = lane & 3;
  // this group's P [row][key], and its warps' row maxima and sums
  T* sp = reinterpret_cast<T*>(smem + SM::P_OFF) + gi * kMlaHeads * SM::LDP;
  float* smax = reinterpret_cast<float*>(smem + SM::X_OFF) +
                gi * 2 * kMlaQuarters * kMlaHeads;   // [warp][row]
  float* ssum = smax + kMlaQuarters * kMlaHeads;     // [warp][row]
  auto group_sync = [&]() {
    if constexpr (GROUPS == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gi), "n"(GT));
  };
  if constexpr (UNIFIED) {
    if (!in_decode_prefix(cu_q_lens, seq)) return;  // block-uniform
  }
  const int kv_len = kv_lens[seq];
  const int64_t row0 = (int64_t)seq * kMlaHeads;  // token seq's rows
  const int j_begin = split * chunk;
  if (j_begin >= kv_len) {
    if (split == 0) zero_rows<T, DV>(out, row0, kMlaHeads);  // kv_len == 0
    return;
  }
  const int j_end = min(kv_len, j_begin + chunk);
  const int n_live = min(num_splits, (kv_len + chunk - 1) / chunk);
  // Q's rows, in flight while the page ids load
  constexpr int QCPR = DL / 8;  // 16-byte chunks of a Q row
  for (int c = tid; c < kMlaHeads * QCPR; c += blockDim.x) {
    const int r = c / QCPR, col = (c % QCPR) * 8;
    cp_async16(sq + r * SM::LDQ + col, q + (row0 + r) * DL + col, true);
  }
  prefetch_pages(spt, page_table + (int64_t)seq * max_pages, j_begin, j_end,
                 page_size);
  // the group's stage s of the ring
  auto stage = [&](int s) {
    return reinterpret_cast<TC*>(smem + (gi * SPG + s) * SM::TILE);
  };
  // TPR threads of the group copy a latent row (a warp moves whole
  // 128-byte runs), and each computes the row's address once
  auto load_tile = [&](int s, int j0) {
    constexpr int CH = 16 / (int)sizeof(TC);
    constexpr int CPR = DL / CH;
    constexpr int TPR = CPR < 8 ? (CPR < 4 ? CPR : 4) : 8;
    for (int r = gtid / TPR; r < kMlaKeys; r += GT / TPR) {
      TC* dst = stage(s) + r * SM::LDK;
      const int j = j0 + r;
      const bool valid = j < j_end;
      const int64_t off =
          valid ? split_row_offset(spt, j, j_begin, page_size, page_offset,
                                   1, DL, 0)
                : 0;
#pragma unroll 3
      for (int cc = gtid % TPR; cc < CPR; cc += TPR)
        cp_async16(dst + cc * CH, lat + off + cc * CH, valid);
    }
    cp_async_commit();
  };
  // the group's k-th tile is the split's tile gi + GROUPS k
  const int n_tiles = (j_end - j_begin + kMlaKeys - 1) / kMlaKeys;
  const int n_mine = (n_tiles - gi + GROUPS - 1) / GROUPS;
  auto tile_j0 = [&](int k) { return j_begin + (gi + GROUPS * k) * kMlaKeys; };
#pragma unroll
  for (int k = 0; k < SPG - 1; ++k) {
    if (k < n_mine)
      load_tile(k, tile_j0(k));
    else
      cp_async_commit();
  }
  // Q (copied by every group) and each group's first tile
  asm volatile("cp.async.wait_group %0;\n" ::"n"(SPG - 2));
  __syncthreads();

  const int dv0 = warp * DVW;
  float o[NDW][4];
#pragma unroll
  for (int dn = 0; dn < NDW; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k = 0; k < n_mine; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(SPG - 2));
    group_sync();  // tile k landed; the group is done with tile k - 1
    {
      const int kn = k + SPG - 1;
      if (kn < n_mine)
        load_tile(kn % SPG, tile_j0(kn));
      else
        cp_async_commit();
    }
    const TC* sk = stage(k % SPG);
    const int j0 = tile_j0(k);

    // S = Q K^T: 16 rows x this warp's 8 keys, over DL, in NACC
    // independent accumulators (the DL / 16 MMAs would chain otherwise)
    float acc[NACC][4];
#pragma unroll
    for (int u = 0; u < NACC; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
    if (j0 + warp * 8 < j_end) {  // warp-uniform
      const TC* kr = sk + (warp * 8 + g) * SM::LDK;
#pragma unroll 12
      for (int kk = 0; kk < DL / 16; ++kk) {
        uint32_t a[4], b[2];
        if constexpr (NARROW) {
          const uint2 r0 = *reinterpret_cast<const uint2*>(
              sq + g * SM::LDQ + kk * 16 + 4 * t4);
          const uint2 r8 = *reinterpret_cast<const uint2*>(
              sq + (g + 8) * SM::LDQ + kk * 16 + 4 * t4);
          a[0] = r0.x;
          a[1] = r8.x;
          a[2] = r0.y;
          a[3] = r8.y;
          load_k_frag<T, TC>(b, kr + kk * 16 + 4 * t4);
        } else {
          ldmatrix_x4(a, sq + (lane & 15) * SM::LDQ + (lane >> 4) * 8 +
                             kk * 16);
          b[0] = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 2 * t4);
          b[1] = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8 + 2 * t4);
        }
        Mma<T>::run(acc[kk % NACC], a, b[0], b[1]);
      }
    }
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = acc[0][e];
#pragma unroll
      for (int u = 1; u < NACC; ++u) s[e] += acc[u][e];
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + warp * 8 + 2 * t4 + (e & 1);
      s[e] = j < j_end ? s[e] * scale_log2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (t4 == 0) smax[warp * kMlaHeads + g + 8 * i] = mx[i];
    }
    group_sync();  // the warps' maxima

    // every warp: the tile max of its rows g and g + 8, the new running
    // max; this warp's 8 probabilities of each row to shared memory
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int w = 0; w < kMlaQuarters; ++w)
        tmax = fmaxf(tmax, smax[w * kMlaHeads + g + 8 * i]);
      const float m_new = fmaxf(m[i], tmax);  // finite: key j0 is live
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use[i]);  // 0 before the first key
      m[i] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[e] - m_use[e >> 1]);
      sum[e >> 1] += p;
      sp[(g + 8 * (e >> 1)) * SM::LDP + warp * 8 + 2 * t4 + (e & 1)] =
          from_float<T>(p);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      if (t4 == 0) ssum[warp * kMlaHeads + g + 8 * i] = sum[i];
    }
    group_sync();  // P and the row sums

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float ts = 0.f;
#pragma unroll
      for (int w = 0; w < kMlaQuarters; ++w)
        ts += ssum[w * kMlaHeads + g + 8 * i];
      l[i] = l[i] * alpha[i] + ts;
    }
#pragma unroll
    for (int dn = 0; dn < NDW; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }
    // O += P V on this warp's DV / 4 columns; V is the tile's first DV
    // columns
#pragma unroll
    for (int kk = 0; kk < kMlaKeys / 16; ++kk) {
      const T* pr = sp + g * SM::LDP + kk * 16 + 2 * t4;
      const uint32_t pa[4] = {
          *reinterpret_cast<const uint32_t*>(pr),
          *reinterpret_cast<const uint32_t*>(pr + 8 * SM::LDP),
          *reinterpret_cast<const uint32_t*>(pr + 8),
          *reinterpret_cast<const uint32_t*>(pr + 8 * SM::LDP + 8)};
      if constexpr (NARROW) {
#pragma unroll
        for (int cg = 0; cg < NDW / NJ; ++cg) {
          uint32_t b[NJ][2];
          load_v_frags<T, TC, NJ>(b, sk + kk * 16 * SM::LDK + dv0 + cg * 8 * NJ,
                                  SM::LDK, g, t4);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            Mma<T>::run(o[cg * NJ + j], pa, b[j][0], b[j][1]);
        }
      } else {
        const int mi = lane >> 3;
        const TC* vr = sk + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * SM::LDK +
                       dv0 + (mi >> 1) * 8;
#pragma unroll
        for (int dn = 0; dn < NDW; dn += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vr + dn * 8);
          Mma<T>::run(o[dn], pa, b[0], b[1]);
          Mma<T>::run(o[dn + 1], pa, b[2], b[3]);
        }
      }
    }
  }

  // the output column of accumulator (n-tile dn, element e of a pair)
  auto col = [&](int dn, int e) {
    if constexpr (NARROW)
      return dv0 + (dn / NJ) * 8 * NJ + out_col<NJ>(t4, dn % NJ, e);
    else
      return dv0 + dn * 8 + 2 * t4 + e;
  };
  if constexpr (GROUPS > 1) {
    // the second group's state, through the drained ring, into the first
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    float* so = reinterpret_cast<float*>(smem);  // [row][DV], then (m, l)
    float* sml = so + kMlaHeads * DV;
    if (gi == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int dn = 0; dn < NDW; ++dn)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            so[(g + 8 * i) * DV + col(dn, e)] = o[dn][2 * i + e];
        if (warp == 0 && t4 == 0) {
          sml[2 * (g + 8 * i)] = m[i];
          sml[2 * (g + 8 * i) + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (gi == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = sml[2 * (g + 8 * i)];
        const float mx = fmaxf(m[i], m1);  // finite: tile 0 is group 0's
        const float w0 = exp2f(m[i] - mx), w1 = exp2f(m1 - mx);
        l[i] = w0 * l[i] + w1 * sml[2 * (g + 8 * i) + 1];
        m[i] = mx;
#pragma unroll
        for (int dn = 0; dn < NDW; ++dn)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[dn][2 * i + e] = w0 * o[dn][2 * i + e] +
                               w1 * so[(g + 8 * i) * DV + col(dn, e)];
      }
    }
  }
  if (n_live == 1) {
    if (gi == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float inv = 1.f / l[i];
        T* orow = out + (row0 + g + 8 * i) * DV;
#pragma unroll
        for (int dn = 0; dn < NDW; ++dn)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            orow[col(dn, e)] = from_float<T>(o[dn][2 * i + e] * inv);
      }
    }
    return;
  }
  float* pvals = split_partials(part);
  float* pstats =
      pvals + (int64_t)gridDim.x * kMlaHeads * num_splits * DV;
  if (gi == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t pr = (row0 + g + 8 * i) * num_splits + split;
      float* pp = pvals + pr * DV;
#pragma unroll
      for (int dn = 0; dn < NDW; ++dn)
#pragma unroll
        for (int e = 0; e < 2; ++e) pp[col(dn, e)] = o[dn][2 * i + e];
      if (warp == 0 && t4 == 0)
        *reinterpret_cast<float2*>(pstats + 2 * pr) =
            make_float2(m[i], l[i]);
    }
  }
  merge_if_last<T, DV>(pvals, pstats, reinterpret_cast<int*>(part) + seq,
                       n_live, out, row0, kMlaHeads, num_splits);
}

// ---- float32: plain FMA, one token (16 rows) per block ---------------------

constexpr int kMlaFmaThreads = 256;

template <int DL>
struct MlaFmaSmem {
  static constexpr int LDK = DL + 1;  // odd stride: lane j reads row j
  static constexpr int LDP = kMlaKeys + 1;
  static constexpr int K = kMlaHeads * DL;
  static constexpr int P = K + kMlaKeys * LDK;
  static constexpr int A = P + kMlaHeads * LDP;
  static constexpr int M = A + kMlaHeads;
  static constexpr int L = M + kMlaHeads;
  static constexpr size_t BYTES = (L + kMlaHeads) * sizeof(float);
};

template <typename T, typename TC, int DL, int DV, bool DECODE,
          bool UNIFIED>
__global__ void __launch_bounds__(kMlaFmaThreads)
    mla_attention_fma_kernel(const T* __restrict__ q,
                             const TC* __restrict__ lat,
                             const int* __restrict__ cu_q_lens,
                             const int* __restrict__ kv_lens,
                             const int* __restrict__ page_table,
                             T* __restrict__ out, float* __restrict__ part,
                             int num_tokens, int S, int max_pages,
                             int page_size, int page_offset, int chunk,
                             int num_splits, float scale_log2) {
  using SM = MlaFmaSmem<DL>;
  constexpr int DC = DV / 16;  // output columns per thread
  extern __shared__ float fsmem[];
  float* sq = fsmem;
  float* sk = fsmem + SM::K;
  float* sp = fsmem + SM::P;
  float* sa = fsmem + SM::A;
  float* sm = fsmem + SM::M;
  float* sl = fsmem + SM::L;
  __shared__ int s_seq, s_tile;

  int seq, q_start, t_first, n_tok, pos0, j_begin, j_end;
  if (!mla_locate<T, DV, DECODE, UNIFIED>(
          cu_q_lens, kv_lens, out, S, num_tokens, 1, chunk, num_splits,
          &s_seq, &s_tile, seq, q_start, t_first, n_tok, pos0, j_begin,
          j_end))
    return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t row_base = (int64_t)(q_start + t_first) * kMlaHeads;
  const int* pt_row = page_table + (int64_t)seq * max_pages;
  const int pos = DECODE ? j_end - 1 : pos0;
  for (int i = tid; i < kMlaHeads * DL; i += blockDim.x)
    sq[i] = to_float(q[row_base * DL + i]) * scale_log2;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // P.V mapping: row pr, columns pc + 16 * c
  const int pr = tid >> 4, pc = tid & 15;
  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += kMlaKeys) {
    const int n = min(kMlaKeys, j_end - j0);
    __syncthreads();  // the previous tile has been consumed
    load_kv_tile<TC, DL>(sk, SM::LDK, lat, nullptr, pt_row, j0, kMlaKeys, n,
                        page_size, page_offset, 1, 0);
    __syncthreads();
    // warp w scores rows w and w + 8, lane j key j
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp + 8 * i;
      const bool ok = lane < n && j0 + lane <= pos;
      float sc = -INFINITY;
      if (ok) {
        const float* qr = sq + row * DL;
        const float* kr = sk + lane * SM::LDK;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int d = 0; d < DL; d += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] = fmaf(qr[d + u], kr[d + u], a[u]);
        sc = (a[0] + a[1]) + (a[2] + a[3]);
      }
      // finite: key j0 <= pos is visible to every row
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = ok ? exp2f(sc - m_new) : 0.f;
      const float alpha = exp2f(m[i] - m_new);  // 0 on the first tile
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      sp[row * SM::LDP + lane] = p;
      if (lane == 0) sa[row] = alpha;
    }
    __syncthreads();
    const float al = sa[pr];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= al;
    for (int jj = 0; jj < kMlaKeys; ++jj) {
      const float p = sp[pr * SM::LDP + jj];
      const float* vr = sk + jj * SM::LDK + pc;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] = fmaf(p, vr[16 * c], acc[c]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sm[warp + 8 * i] = m[i];
      sl[warp + 8 * i] = l[i];
    }
  }
  __syncthreads();
  if (!DECODE || num_splits == 1) {
    const float inv = 1.f / sl[pr];  // key pos0 (or the split's first) seen
#pragma unroll
    for (int c = 0; c < DC; ++c)
      out[(row_base + pr) * DV + pc + 16 * c] = from_float<T>(acc[c] * inv);
    return;
  }
  float* pp = part + ((row_base + pr) * num_splits + blockIdx.z) * (DV + 2);
#pragma unroll
  for (int c = 0; c < DC; ++c) pp[pc + 16 * c] = acc[c];
  if (pc == 0) {
    pp[DV] = sm[pr];
    pp[DV + 1] = sl[pr];
  }
}

// ---- launch ----------------------------------------------------------------

// Launch the MLA kernel over S sequences (DECODE: one token each, in
// num_splits splits of `chunk` keys; else T_ ragged tokens): tensor cores
// for bf16 / fp16 (decode: mla_decode_mma_kernel, which merges its own
// splits), FMA for float32 (decode: its splits merged by
// decode_merge_kernel). The latent holds TC: T, or fp8_t. UNIFIED: only
// the rows of this block class (cu must be given in both modes).
template <typename T, typename TC, int DL, int DV, bool DECODE, bool UNIFIED>
static int launch_mla(const void* q, const void* lat, const int* cu,
                      const int* kv_lens, const int* pt, void* out,
                      float* part, int T_, int S, int max_pages,
                      int page_size, int page_offset, int chunk,
                      int num_splits, float scale, cudaStream_t stream) {
  using Kernel = void (*)(const T*, const TC*, const int*, const int*,
                          const int*, T*, float*, int, int, int, int, int,
                          int, int, float);
  constexpr bool MMA = !std::is_same<T, float>::value;
  if constexpr (MMA && DECODE) {
    using SM = MlaDecodeSmem<T, TC, DL, DV>;
    auto kern = mla_decode_mma_kernel<T, TC, DL, DV, UNIFIED>;
    static bool configured = false;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SM::BYTES);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    kern<<<dim3(S, 1, num_splits), SM::THREADS, SM::BYTES, stream>>>(
        static_cast<const T*>(q), static_cast<const TC*>(lat), cu, kv_lens,
        pt, static_cast<T*>(out), part, max_pages, page_size, page_offset,
        chunk, num_splits, scale * kLog2e);
    return 0;
  } else {
    Kernel kern;
    size_t smem;
    int threads, bq;  // threads and tokens per block
    if constexpr (MMA) {
      kern = mla_ragged_wgmma_kernel<T, TC, DL, DV, UNIFIED>;
      smem = MlaWgSmem<T, TC, DL, DV>::ALLOC;
      threads = kMlaWgThreads;
      bq = kMlaWgTokens;
    } else {
      kern = mla_attention_fma_kernel<T, TC, DL, DV, DECODE, UNIFIED>;
      smem = MlaFmaSmem<DL>::BYTES;
      threads = kMlaFmaThreads;
      bq = 1;
    }
    static bool configured = false;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    // float32 decode: partials after the scratch's counters, merged by a
    // second pass
    float* parts = DECODE && part ? split_partials(part) : nullptr;
    const dim3 grid = DECODE ? dim3(S, 1, num_splits)
                             : dim3((T_ + bq - 1) / bq + S, 1, 1);
    kern<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const TC*>(lat), cu, kv_lens,
        pt, static_cast<T*>(out), parts, T_, S, max_pages, page_size,
        page_offset, chunk, num_splits, scale * kLog2e);
    if (DECODE && num_splits > 1)
      decode_merge_kernel<T, DV, UNIFIED>
          <<<dim3(S, kMlaHeads), 32, 0, stream>>>(
              parts, cu, kv_lens, static_cast<T*>(out), kMlaHeads, chunk,
              num_splits);
    return 0;
  }
}

// f(T{}, TC{}, DL, DV) for the dtype code, the cache code (q's dtype or
// fp8; an int8 latent is not taken) and one of the latent geometries the
// kernels are built for: DeepSeek V2/V3's (576, 512), and (96, 64) for
// small test models.
template <typename F>
static int dispatch_mla(int dtype, int cache, int latent_dim, int v_dim,
                        F&& f) {
  auto dims = [&](auto t, auto tc) -> int {
    if (latent_dim == 576 && v_dim == 512)
      return f(t, tc, std::integral_constant<int, 576>{},
               std::integral_constant<int, 512>{});
    if (latent_dim == 96 && v_dim == 64)
      return f(t, tc, std::integral_constant<int, 96>{},
               std::integral_constant<int, 64>{});
    return (int)cudaErrorInvalidValue;
  };
  auto caches = [&](auto t) -> int {
    switch (cache) {
      case kCacheNative:
        return dims(t, t);
      case kCacheFp8:
        return dims(t, fp8_t{});
    }
    return (int)cudaErrorInvalidValue;
  };
  switch (dtype) {
    case kFloat32:
      return caches(float{});
    case kBFloat16:
      return caches(__nv_bfloat16{});
    case kFloat16:
      return caches(__half{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace gllm
