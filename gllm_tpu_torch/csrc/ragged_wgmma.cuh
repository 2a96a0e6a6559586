// The GQA ragged block on Hopper (bf16 / fp16 q; wgmma, warp-specialised)
// and the launcher of ragged_attention.cu, which serves K1 and K1u.
//
// Replaces the tensor-core part of
// gllm_tpu/ops/pallas/ragged_attention.py::ragged_paged_attention (GQA):
// a flat packed batch of query tokens attends causally over each
// sequence's paged K/V, over a full-precision, an int8 (per-page scales) or
// an fp8 cache, at head_dim 32, 64, 128 and 256.
//
// One launcher for both entry points. The batch's decode prefix (the
// longest run of one-token sequences at its head, found on the device by
// decode_prefix_len) runs the split-KV decode blocks of
// decode_attention.cuh; every other sequence runs the ragged blocks below
// (float32 q: the FMA kernel of ragged_attention.cuh). The two classes
// write disjoint output rows.
//
// Bound on the card. A key row serves the 64 / G tokens x G heads of a
// warpgroup's rows; a chunk's prefill is bound by operations, its re-reads
// of the context come from L2. The earlier block (mma.sync, one warp per
// 16 rows, two barriers a tile, a two-stage ring, Q.K^T done twice at
// D 256) ran at 6-14x its bound; shared memory and barriers held it. This
// one is held by each warpgroup's serial chain a tile (Q.K^T, softmax,
// P.V): at D 64 the softmax, whose 2^x and bf16 packing share the
// special-function and conversion units of an SM sub-partition with the
// other warpgroup's, takes about half of it, and the longest walk (a
// chunk's last tile over its whole context) sets the tail
// (tools/ragged_block_trace.py measures each phase).
//
// Design:
// - A block holds two consumer warpgroups and one producer warpgroup (384
//   threads, one block an SM). Consumer warpgroup w owns 64 query rows,
//   the M of one wgmma: tokens [w bq, (w + 1) bq) of the block's tile of a
//   sequence, bq = floor(64 / G), row = token * G + head (a group that
//   does not divide 64 leaves at most G - 1 rows idle). Every K/V tile
//   serves both, 128 rows.
// - S = Q K^T: m64n64k16 over the head dim, Q (loaded once, swizzled) and
//   the K tile [64 keys, D] (a K-major B) read by descriptor. The online
//   softmax (classic rescaling, log2 domain) stays in registers. O += P V:
//   P from registers (WgmmaRS: the accumulator's pairs are the A fragment),
//   V read in place as an MN-major B, N = the head dim (one warpgroup owns
//   every output column: 128 float32 accumulators a thread at D 256, so
//   no product is done twice). P never goes through shared memory.
// - The producer warpgroup fills a ring of 64-key K/V stages in the
//   128-byte swizzle both descriptors read, with full and empty mbarriers:
//   consumers wait on a stage's full barrier and release it; no block-wide
//   barrier runs in the key loop. setmaxnreg moves registers from the
//   producer (56) to the consumers (224). Stages: 4 up to D 128, 2 at
//   D 256 (Q's 64 KB and three 64 KB stages do not fit in 227 KB).
// - Loads: cp.async issued by the producer, each thread's copies of a
//   stage signalled with cp.async.mbarrier.arrive.noinc; the consumers
//   fence the async proxy after the wait. cp.async and not TMA: a 64-key
//   tile spans 4 to 16 pages at the served page sizes, so TMA would take a
//   box a page (and a second box a page at D 128 and 256 for the 128-byte
//   swizzle's row limit), and a one-byte cache has to be widened by threads
//   anyway; the tensor map would also be one more host object a call.
// - One-byte caches (int8, fp8): the producer lands each tile in its
//   one-byte form (3 raw stages, 1 at D 256), then widens it once, exactly,
//   into the bf16 / fp16 stage. int8: each key column's scale multiplies
//   its float32 score (exact); each value row's scale is folded into P
//   before P is rounded for the tensor cores, so P.V is one wgmma chain
//   and the integers reach the tensor cores exactly. The fold is relative
//   to the value scale of the key holding the row's running max (the
//   output is rescaled when that key changes, as for the max itself), so
//   that key's probability stays exactly 1 in bf16: folding the bare
//   scale rounds the largest probability too, which leaves RAGGED_TOL on
//   the first rows of a fresh chunk (a few keys each; the CPU emulation
//   tests/test_torch_ragged_block.py shows both).
// - Head dim 32 runs the same block with every tile padded to 64 columns
//   of zeros (no served model has it; one swizzle and one descriptor
//   scheme for all dims).
// - Work order: the tiles of all sequences are numbered level by level,
//   each sequence's last tile (whose tokens see the most keys) first
//   (locate_longest_first), so the longest walks start in the first wave.
//   Found on the device from cu_q_lens: no host sync.
#pragma once

#include "decode_attention.cuh"
#include "ragged_attention.cuh"
#include "split_kv.cuh"
#include "wgmma.cuh"

namespace gllm {

constexpr int kWgRows = 64;      // query rows a consumer warpgroup
constexpr int kWgKeys = 64;      // keys a tile
constexpr int kWgConsumers = 2;  // consumer warpgroups a block
constexpr int kWgThreads = 128 * (1 + kWgConsumers);
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kWgConsumers <=
                  65536,
              "register split over the SM's file");

// Shared memory, in bytes from a 1024-aligned base: each consumer's Q, the
// ring of K/V stages (swizzled 64-column blocks), for a one-byte cache the
// raw stages (K, V and, int8, the keys' scales) and, int8, each stage's
// scales, the full and empty barriers, and the producer's row offsets.
template <typename T, typename TC, int D>
struct WgSmem {
  static constexpr bool NARROW = sizeof(TC) == 1;
  static constexpr bool Q8 = is_q8<TC>();
  static constexpr int DP = D < 64 ? 64 : D;  // head dim in shared memory
  static constexpr size_t BLOCK = 64 * 128;   // a 64-row column block
  static constexpr size_t TILE = (DP / 64) * BLOCK;  // Q of a WG, K or V
  static constexpr size_t STAGE = 2 * TILE;
  static constexpr int STAGES = DP >= 256 ? 2 : 4;
  static constexpr int RAW_STAGES = !NARROW ? 0 : (DP >= 256 ? 1 : 3);
  static constexpr size_t RAW_TILE = (size_t)kWgKeys * D;  // one-byte rows
  static constexpr size_t SCALES = Q8 ? 2 * kWgKeys * sizeof(float) : 0;
  static constexpr size_t RAW = 2 * RAW_TILE + SCALES;
  static constexpr size_t RING_OFF = kWgConsumers * TILE;
  static constexpr size_t RAW_OFF = RING_OFF + STAGES * STAGE;
  static constexpr size_t SC_OFF = RAW_OFF + RAW_STAGES * RAW;
  static constexpr size_t BAR_OFF = SC_OFF + STAGES * SCALES;
  // the producer's row offsets of a tile (and, int8, its scales' index),
  // one set a raw stage, or two (this tile's and the next's)
  static constexpr int OFF_SETS = NARROW ? RAW_STAGES : 2;
  static constexpr size_t OFF_OFF = BAR_OFF + 2 * STAGES * sizeof(uint64_t);
  static constexpr size_t SIDX_OFF =
      OFF_OFF + OFF_SETS * kWgKeys * sizeof(int64_t);
  static constexpr size_t BYTES =
      SIDX_OFF + (Q8 ? OFF_SETS * kWgKeys * sizeof(int) : 0);
  static constexpr size_t ALLOC = BYTES + 1024;  // the base aligned to 1 KB
  static_assert(ALLOC <= 232448, "ragged block over 227 KB");
};

// Which (sequence, tile of `span` tokens) is item `item`? A sequence past
// the decode prefix owns nt = cdiv(q_len, span) tiles. Items are numbered
// level by level: level r holds the r-th tile from the end of every
// sequence with more than r tiles, in sequence order. Past the real work
// seq is -1 and tile counts the excess items (they zero the padding
// tokens). Warp 0 finds it; every thread gets it after the barrier.
__device__ __forceinline__ void locate_longest_first(const int* cu_q_lens,
                                                     int S, int span,
                                                     int item, int* s_seq,
                                                     int* s_tile) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    // the first 32 sequences' bounds in one round of reads, and the decode
    // prefix from them unless it runs past them
    const int c1 = lane < S ? cu_q_lens[lane + 1] : 0;
    const int cz = lane == 0 ? cu_q_lens[0] : 0;
    const int up = __shfl_up_sync(0xffffffffu, c1, 1);
    const int c0 = lane ? up : cz;
    const unsigned stop =
        __ballot_sync(0xffffffffu, lane < S && c1 != lane + 1);
    const int nd = stop ? __ffs(stop) - 1
                        : (S <= 32 ? S : decode_prefix_len(cu_q_lens, S));
    auto tiles = [&](int s) {
      return s < S && s >= nd
                 ? (cu_q_lens[s + 1] - cu_q_lens[s] + span - 1) / span
                 : 0;
    };
    // the first 32 sequences' counts stay in a register: a batch of up to
    // 32 sequences reads cu_q_lens once
    const int nt0 =
        lane < S && lane >= nd ? (c1 - c0 + span - 1) / span : 0;
    auto nt_at = [&](int s0) { return s0 == 0 ? nt0 : tiles(s0 + lane); };
    // items on the levels below r: the sum over sequences of min(nt, r)
    auto below = [&](int r) {
      int c = 0;
      for (int s0 = 0; s0 < S; s0 += 32) c += min(nt_at(s0), r);
      return __reduce_add_sync(0xffffffffu, c);
    };
    int top = 0;
    for (int s0 = 0; s0 < S; s0 += 32) top = max(top, nt_at(s0));
    top = __reduce_max_sync(0xffffffffu, top);
    const int total = below(top);
    int seq = -1, tile = item - total;
    if (item < total) {
      int lo = 0, hi = top - 1;  // the level: below(lo) <= item < below(lo + 1)
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (below(mid) <= item)
          lo = mid;
        else
          hi = mid - 1;
      }
      int k = item - below(lo);  // the k-th sequence with more than lo tiles
      for (int s0 = 0; s0 < S; s0 += 32) {
        const int nt = nt_at(s0);
        const unsigned m = __ballot_sync(0xffffffffu, nt > lo);
        const int c = __popc(m);
        if (k < c) {
          const unsigned who = __ballot_sync(
              0xffffffffu,
              nt > lo && __popc(m & ((1u << lane) - 1u)) == k);
          const int src = __ffs(who) - 1;
          seq = s0 + src;
          tile = __shfl_sync(0xffffffffu, nt, src) - 1 - lo;
          break;
        }
        k -= c;
      }
    }
    if (lane == 0) {
      *s_seq = seq;
      *s_tile = tile;
    }
  }
  __syncthreads();
}

// 2^x on the special-function unit (-inf gives 0); the probabilities are
// rounded to bf16 / fp16 for the tensor cores, far coarser than its error
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four int8 values (a 32-bit word, the lowest first) widened exactly to two
// packed pairs of T on the integer and FMA pipes: 2^23 + (x + 128) placed
// in a float's mantissa, less 2^23 + 128, is x, and its upper half is x in
// bf16 (|x| <= 128 needs 8 bits); fp16 takes 1024 + (x + 128) in a half,
// less 1152. I2F and F2F would share the conversion unit with the
// consumers' 2^x and bf16 packing.
template <typename T>
__device__ __forceinline__ void widen_i8x4(uint32_t w, uint32_t* out) {
  const uint32_t u = w ^ 0x80808080u;  // x + 128, byte by byte
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 off = __floats2half2_rn(1152.f, 1152.f);
    const uint32_t lo = __byte_perm(u, 0x64646464u, 0x4140);
    const uint32_t hi = __byte_perm(u, 0x64646464u, 0x4342);
    const __half2 a = __hsub2(*reinterpret_cast<const __half2*>(&lo), off);
    const __half2 b = __hsub2(*reinterpret_cast<const __half2*>(&hi), off);
    out[0] = *reinterpret_cast<const uint32_t*>(&a);
    out[1] = *reinterpret_cast<const uint32_t*>(&b);
  } else {
    uint32_t f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __float_as_uint(
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
          8388736.f);
    out[0] = __byte_perm(f[0], f[1], 0x7632);
    out[1] = __byte_perm(f[2], f[3], 0x7632);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The producer warpgroup: fills stage i % STAGES with keys [64 i, 64 i + 64)
// for i < n_tiles (rows at or past kv_end zero, nothing read there; columns
// past D zero), waiting on the stage's empty barrier from its second use.
// A tile's row offsets (one page-table read a row) are found by 64 threads
// at once, a tile ahead of its copies, and kept in shared memory: read by
// every copying thread in turn, each would wait out a page-table read per
// row it copies.
template <typename T, typename TC, int D>
__device__ __forceinline__ void ragged_produce(
    unsigned char* smem, uint32_t full0, uint32_t empty0, const TC* kc,
    const TC* vc, const float* ks, const float* vs, const int* pt_row,
    int n_tiles, int kv_end, int page_size, int page_offset,
    int num_kv_heads, int h) {
  using SM = WgSmem<T, TC, D>;
  constexpr int NS = SM::STAGES;
  const int tid = threadIdx.x % 128;
  int64_t* offs = reinterpret_cast<int64_t*>(smem + SM::OFF_OFF);
  int* sidx = reinterpret_cast<int*>(smem + SM::SIDX_OFF);
  // row `tid` of tile i: its element offset in the cache (-1 past kv_end)
  // and, int8, its scales' index
  auto find = [&](int i, int set) {
    const int j = i * kWgKeys + tid;
    const bool valid = i < n_tiles && j < kv_end;
    const int64_t page =
        valid ? kv_page(pt_row, j, page_size, page_offset) : 0;
    offs[set * kWgKeys + tid] =
        valid ? ((page * page_size + j % page_size) * num_kv_heads + h) * D
              : -1;
    if constexpr (SM::Q8)
      sidx[set * kWgKeys + tid] = (int)(page * num_kv_heads + h);
  };
  if constexpr (!SM::NARROW) {
    constexpr int CPR = SM::DP / 8;  // 16-byte chunks a row
    const int c = tid % CPR;
    if (tid < kWgKeys) find(0, 0);
    named_sync(1, 128);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % NS;
      // the next tile's offsets, read now, stored after this tile's copies
      int64_t nxt = -1;
      if (tid < kWgKeys && i + 1 < n_tiles) {
        const int j = (i + 1) * kWgKeys + tid;
        if (j < kv_end)
          nxt = kv_row_offset(pt_row, j, page_size, page_offset,
                              num_kv_heads, D, h);
      }
      if (i >= NS) mbar_wait(empty0 + 8 * st, (i / NS - 1) & 1);
      unsigned char* kt = smem + SM::RING_OFF + st * SM::STAGE;
      const int64_t* o = offs + (i & 1) * kWgKeys;
      for (int r = tid / CPR; r < kWgKeys; r += 128 / CPR) {
        const int64_t ro = o[r];
        const bool valid = ro >= 0 && c < D / 8;
        const int64_t off = valid ? ro + c * 8 : 0;
        const uint32_t so = sw128_offset<kWgKeys>(r, c);
        cp_async16(kt + so, kc + off, valid);
        cp_async16(kt + SM::TILE + so, vc + off, valid);
      }
      cp_async_mbar_arrive(full0 + 8 * st);
      if (tid < kWgKeys) offs[((i + 1) & 1) * kWgKeys + tid] = nxt;
      named_sync(1, 128);  // the next offsets in; this tile's read
    }
    cp_async_wait<0>();
  } else {
    constexpr int NN = SM::RAW_STAGES;
    constexpr int CPR = D / 16;  // 16-byte chunks a one-byte row
    // copies of tile i into raw stage i % NN, from offset set i % NN
    auto issue = [&](int i) {
      unsigned char* raw = smem + SM::RAW_OFF + (i % NN) * SM::RAW;
      const int64_t* o = offs + (i % NN) * kWgKeys;
      const int c = tid % CPR;
      for (int r = tid / CPR; r < kWgKeys; r += 128 / CPR) {
        const int64_t ro = o[r];
        const bool valid = ro >= 0;
        const int64_t off = valid ? ro + c * 16 : 0;
        cp_async16(raw + r * D + c * 16, kc + off, valid);
        cp_async16(raw + SM::RAW_TILE + r * D + c * 16, vc + off, valid);
      }
      if constexpr (SM::Q8) {
        float* sc = reinterpret_cast<float*>(raw + 2 * SM::RAW_TILE);
        if (tid < kWgKeys) {
          const bool valid = o[tid] >= 0;
          const int x = valid ? sidx[(i % NN) * kWgKeys + tid] : 0;
          cp_async4(sc + tid, ks + x, valid);
          cp_async4(sc + kWgKeys + tid, vs + x, valid);
        }
      }
    };
    if (tid < kWgKeys)
      for (int i = 0; i + 1 < NN; ++i) find(i, i);
    named_sync(1, 128);
    for (int i = 0; i + 1 < NN; ++i) {
      if (i < n_tiles) issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      // the offsets of the tile issued below, into the set its raw stage
      // had (all threads are past issuing from it)
      if (tid < kWgKeys) find(i + NN - 1, (i + NN - 1) % NN);
      if constexpr (NN == 1) {
        named_sync(1, 128);  // its offsets in; tile i - 1 widened
        issue(i);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<NN - 2>();
      }
      named_sync(1, 128);  // tile i has landed, every thread's copies
      if constexpr (NN > 1) {
        // into the raw stage tile i - 1 was widened from
        if (i + NN - 1 < n_tiles) issue(i + NN - 1);
        cp_async_commit();
      }
      const int st = i % NS;
      if (i >= NS) mbar_wait(empty0 + 8 * st, (i / NS - 1) & 1);
      const unsigned char* raw = smem + SM::RAW_OFF + (i % NN) * SM::RAW;
      unsigned char* kt = smem + SM::RING_OFF + st * SM::STAGE;
      for (int x = tid; x < 2 * kWgKeys * CPR; x += 128) {
        const int m = x / (kWgKeys * CPR);  // 0: K, 1: V
        const int r = x % (kWgKeys * CPR) / CPR, c = x % CPR;
        const uint4 v = *reinterpret_cast<const uint4*>(
            raw + m * SM::RAW_TILE + r * D + c * 16);
        const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
        uint32_t w[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (SM::Q8) {
            widen_i8x4<T>(wd[k], w + 2 * k);
          } else {  // pairs widened by one cvt each (split_kv.cuh)
            w[2 * k] = widen2<T, TC>(wd[k]);
            w[2 * k + 1] = widen2<T, TC>(wd[k] >> 16);
          }
        }
        unsigned char* dst = kt + m * SM::TILE;
        *reinterpret_cast<uint4*>(dst + sw128_offset<kWgKeys>(r, 2 * c)) =
            make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst +
                                  sw128_offset<kWgKeys>(r, 2 * c + 1)) =
            make_uint4(w[4], w[5], w[6], w[7]);
      }
      if constexpr (D < 64) {  // the padding columns
        constexpr int PAD = 8 - D / 8;
        for (int x = tid; x < 2 * kWgKeys * PAD; x += 128) {
          const int m = x / (kWgKeys * PAD);
          const int r = x % (kWgKeys * PAD) / PAD, c = D / 8 + x % PAD;
          *reinterpret_cast<uint4*>(kt + m * SM::TILE +
                                    sw128_offset<kWgKeys>(r, c)) =
              make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if constexpr (SM::Q8) {
        const float* sc =
            reinterpret_cast<const float*>(raw + 2 * SM::RAW_TILE);
        reinterpret_cast<float*>(smem + SM::SC_OFF + st * SM::SCALES)[tid] =
            sc[tid];
      }
      fence_proxy_async();
      mbar_arrive(full0 + 8 * st);
    }
  }
}

template <typename T, typename TC, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    ragged_wgmma_kernel(const T* __restrict__ q, const TC* __restrict__ kc,
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
  using SM = WgSmem<T, TC, D>;
  constexpr int DP = SM::DP;
  constexpr int NS = SM::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* smem =
      wg_raw + ((1024u - (smem_addr(wg_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_addr(smem);
  __shared__ int s_seq, s_tile;

  const int h = blockIdx.x % num_kv_heads;
  const int bq = kWgRows / group;        // tokens a consumer warpgroup
  const int span = kWgConsumers * bq;  // tokens a block
  locate_longest_first(cu_q_lens, S, span, blockIdx.x / num_kv_heads,
                       &s_seq, &s_tile);
  const int seq = s_seq;
  if (seq < 0) {
    zero_padding(out, cu_q_lens, S, s_tile, span, num_tokens, num_q_heads,
                 group, D, h);
    return;
  }
  const int q_start = cu_q_lens[seq];
  const int q_len = cu_q_lens[seq + 1] - q_start;
  const int kv_len = kv_lens[seq];
  const int t_first = s_tile * span;
  const int n_tok = min(span, q_len - t_first);
  const int pos0 = kv_len - q_len + t_first;  // position of token t_first
  const int kv_end = min(kv_len, pos0 + n_tok);  // keys any row can see
  const int n_tiles = (kv_end + kWgKeys - 1) / kWgKeys;
  const int consumers = (n_tok + bq - 1) / bq;  // warpgroups with rows
  const int* pt_row = page_table + (int64_t)seq * max_pages;
  const uint32_t full0 = sbase + SM::BAR_OFF;
  const uint32_t empty0 = full0 + 8 * NS;
  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full0 + 8 * st, 128);
      mbar_init(empty0 + 8 * st, 128 * consumers);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    ragged_produce<T, TC, D>(smem, full0, empty0, kc, vc, ks, vs, pt_row,
                             n_tiles, kv_end, page_size, page_offset,
                             num_kv_heads, h);
    return;
  }
  if (wg > consumers) return;
  setmaxnreg_inc<kConsumerRegs>();

  const int w = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int tok0 = t_first + w * bq;  // the warpgroup's first token
  const int n_rows = min(bq, n_tok - w * bq) * group;
  const int first = pos0 + w * bq;  // the first token's position
  const int last = first + n_rows / group - 1;  // the last key it sees
  const uint32_t q_addr = sbase + w * SM::TILE;
  {
    // Q's rows, zero past n_rows and past D
    constexpr int CPR = DP / 8;
    unsigned char* sq = smem + w * SM::TILE;
    for (int x = tid; x < kWgRows * CPR; x += 128) {
      const int r = x / CPR, c = x % CPR;
      const bool valid = r < n_rows && c < D / 8;
      const int64_t off =
          valid ? ((int64_t)(q_start + tok0 + r / group) * num_q_heads +
                   (int64_t)h * group + r % group) * D + c * 8
                : 0;
      cp_async16(sq + sw128_offset<kWgRows>(r, c), q + off, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    named_sync(2 + w, 128);
  }
  // this thread's rows: warp * 16 + g + 8 hh; a row past n_rows sees no key
  int pos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    pos[hh] = r < n_rows ? first + r / group : -1;
  }
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float vref[2] = {1.f, 1.f};  // int8: the scale P's values are relative to
  float fold[2] = {1.f, 1.f};  // int8: 1 / vref

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % NS;
    const int j0 = it * kWgKeys;
    mbar_wait(full0 + 8 * st, (it / NS) & 1);
    if (j0 <= last) {  // warpgroup-uniform: some row sees this tile
      fence_proxy_async();  // the producer's cp.async writes, for wgmma
      const uint32_t kt = sbase + SM::RING_OFF + st * SM::STAGE;
      const uint32_t vt = kt + SM::TILE;
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t da =
            gmma_desc(q_addr + (kk >> 2) * SM::BLOCK + (kk & 3) * 32, 16,
                      1024);
        const uint64_t db =
            gmma_desc(kt + (kk >> 2) * SM::BLOCK + (kk & 3) * 32, 16, 1024);
        Wgmma<T, 64>::template run<0>(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(s);

      // int8: this thread's columns' key and value scales (columns 8 k +
      // 2 t4 + {0, 1}: a pair a k)
      float2 ks2[8], vs2[8];
      if constexpr (SM::Q8) {
        const float* sc = reinterpret_cast<const float*>(
            smem + SM::SC_OFF + st * SM::SCALES);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          ks2[k] = *reinterpret_cast<const float2*>(sc + 8 * k + 2 * t4);
          vs2[k] =
              *reinterpret_cast<const float2*>(sc + kWgKeys + 8 * k + 2 * t4);
        }
      }
      // raw scores (int8: times the key scale), masked causally unless
      // every row of the warpgroup sees the whole tile (a row past n_rows
      // has a zero Q row: unmasked it scores 0 and is never written), and
      // each row's maximum, in two partial maxima a row (shorter chains)
      const bool whole = j0 + kWgKeys - 1 <= first;  // warpgroup-uniform
      float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int hh = (i >> 1) & 1;
        float x = s[i];
        if constexpr (SM::Q8) x *= (i & 1) ? ks2[i >> 2].y : ks2[i >> 2].x;
        if (!whole && j0 + col > pos[hh]) x = -INFINITY;
        s[i] = x;
        mx[hh][(i >> 2) & 1] = fmaxf(mx[hh][(i >> 2) & 1], x);
      }
      // alpha rescales the row sum, o_scale the output (int8: and moves it
      // to the new reference scale); the log2-domain scale is applied in
      // the exponent's FMA
      float alpha[2], o_scale[2], neg[2];
      float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float m = fmaxf(mx[hh][0], mx[hh][1]);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float m_tile = m * scale_log2;
        const float m_new = fmaxf(m_run[hh], m_tile);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        neg[hh] = -m_safe;
        alpha[hh] = ex2(m_run[hh] - m_safe);  // 0 before the first key
        o_scale[hh] = alpha[hh];
        if constexpr (SM::Q8) {
          // P carries v_scale / vref, vref the value scale of the running
          // max's key, so that key's probability stays exactly 1 in bf16
          // (the largest such scale on a tie, the same on the row's four
          // lanes; a page of zeros, scale 0, never becomes the reference)
          float best = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (s[4 * k + 2 * hh] == m) best = fmaxf(best, vs2[k].x);
            if (s[4 * k + 2 * hh + 1] == m) best = fmaxf(best, vs2[k].y);
          }
          best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 1));
          best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 2));
          if (m_tile > m_run[hh] && best > 0.f && best != vref[hh]) {
            o_scale[hh] *= vref[hh] / best;
            fold[hh] = 1.f / best;
            vref[hh] = best;
          }
        }
        m_run[hh] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const float p = ex2(fmaf(s[i], scale_log2, neg[hh]));
        sum[hh][(i >> 2) & 1] += p;
        if constexpr (SM::Q8) {
          s[i] = p * (((i & 1) ? vs2[i >> 2].y : vs2[i >> 2].x) * fold[hh]);
        } else {
          s[i] = p;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float t = sum[hh][0] + sum[hh][1];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        l_run[hh] = l_run[hh] * alpha[hh] + t;
      }
      // the output rescale, skipped while no row of the warp moved
      if (!__all_sync(0xffffffffu, o_scale[0] == 1.f && o_scale[1] == 1.f)) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= o_scale[(i >> 1) & 1];
      }
      // P as the A fragments of the four k16 steps
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = Mma<T>::pack(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      fence_regs<DP / 2>(o);
      fence_regs_u32<16>(&pa[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) {
        const uint64_t db =
            gmma_desc(vt + kk * 2048, (uint32_t)SM::BLOCK, 1024);
        WgmmaRS<T, DP>::template run<1>(o, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<DP / 2>(o);
      fence_regs_u32<16>(&pa[0][0]);
    }
    mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (pos[hh] < 0) continue;
    const int r = warp * 16 + g + 8 * hh;
    const float inv = l_run[hh] > 0.f ? vref[hh] / l_run[hh] : 0.f;
    T* orow = out + ((int64_t)(q_start + tok0 + r / group) * num_q_heads +
                     (int64_t)h * group + r % group) * D;
#pragma unroll
    for (int k = 0; k < DP / 8; ++k) {
      const int col = 8 * k + 2 * t4;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) = Mma<T>::pack(
            o[4 * k + 2 * hh] * inv, o[4 * k + 2 * hh + 1] * inv);
    }
  }
}

// ---- launch ----------------------------------------------------------------

// The ragged blocks over every sequence past the decode prefix: the FMA
// kernel for a float32 q, the wgmma block for bf16 / fp16.
template <typename T, typename TC, int D>
static int launch_ragged(const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* cu,
                         const int* kv_lens, const int* pt, void* out,
                         int T_, int S, int max_pages, int hq, int hkv,
                         int page_size, int page_offset, float scale,
                         cudaStream_t stream) {
  const int group = hq / hkv;
  static bool configured = false;
  const T* qt = static_cast<const T*>(q);
  const TC* kt = static_cast<const TC*>(k);
  const TC* vt = static_cast<const TC*>(v);
  T* ot = static_cast<T*>(out);
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = RaggedSmem<D>::BYTES;
    auto kern = ragged_attention_kernel<T, TC, D, true>;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    const int bq = kRows / group;
    kern<<<dim3((T_ + bq - 1) / bq + S, hkv), kThreads, smem, stream>>>(
        qt, kt, vt, ks, vs, cu, kv_lens, pt, ot, T_, S, max_pages, hq, hkv,
        group, page_size, page_offset, scale * kLog2e);
  } else {
    constexpr size_t smem = WgSmem<T, TC, D>::ALLOC;
    auto kern = ragged_wgmma_kernel<T, TC, D>;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    const int span = kWgConsumers * (kWgRows / group);
    // every real and padding tile
    const int items = (T_ + span - 1) / span + S;
    kern<<<items * hkv, kWgThreads, smem, stream>>>(
        qt, kt, vt, ks, vs, cu, kv_lens, pt, ot, T_, S, max_pages, hq, hkv,
        group, page_size, page_offset, scale * kLog2e);
  }
  return 0;
}

// One paged-attention step: the decode prefix on the split-KV decode
// blocks, every other sequence on the ragged blocks. When the caller knows
// the batch is pure decode, the decode blocks take every row (padding rows
// write their zeros there) and the ragged blocks, which would find no
// work, are not launched.
template <typename T, typename TC, int D>
static int launch_paged_step(const void* q, const void* k, const void* v,
                             const float* ks, const float* vs, const int* cu,
                             const int* kv_lens, const int* pt, void* out,
                             float* part, int T_, int S, int max_pages,
                             int hq, int hkv, int page_size, int page_offset,
                             int chunk, int num_splits, float scale,
                             bool decode_only, cudaStream_t stream) {
  const int r = launch_decode<T, TC, D, true>(
      q, k, v, ks, vs, decode_only ? nullptr : cu, kv_lens, pt, out, part,
      S, max_pages, hq, hkv, page_size, page_offset, chunk, num_splits,
      scale, stream);
  if (r != 0 || decode_only) return r;
  return launch_ragged<T, TC, D>(q, k, v, ks, vs, cu, kv_lens, pt, out, T_,
                                 S, max_pages, hq, hkv, page_size,
                                 page_offset, scale, stream);
}

// The arguments the step's launchers take, checked on the host: a GQA
// group of at most kDecodeMaxGroup (the decode blocks' rows).
static inline bool ragged_args_ok(int T_, int S, int hq, int hkv) {
  const int group = hkv > 0 ? hq / hkv : 0;
  return T_ > 0 && S > 0 && group >= 1 && group <= kDecodeMaxGroup &&
         group * hkv == hq;
}

}  // namespace gllm
