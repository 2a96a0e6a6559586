// Gated-delta-rule chunk scan (K3) for Hopper (sm_90a).
//
// Replaces gllm_tpu/ops/pallas/gdn_scan.py::gdn_chunk_scan: the sequential
// inter-chunk recurrence of the chunked gated delta rule (Qwen3-Next's
// Gated-DeltaNet layers). The in-chunk triangular work (decay, (I + A)^-1,
// v2, k_cumdecay, the masked local scores) is batched PyTorch in
// ops/gdn.py, as it is XLA in the JAX package; this kernel takes its
// results. For each (sequence, head) b, with S the running [Dk, Dv] state
// and chunks n = 0 .. N-1 in order:
//   v_new = v2 - kcd @ S
//   out   = (q * e^g) @ S + attn @ v_new
//   S     = e^{g_C} * S + (k * e^{g_C - g})^T @ v_new
// everything to float32 accuracy, as the TPU kernel and the plain version
// compute it.
//
// Bound on the card. A chunk of C = 64 rows at Dk = Dv = 128 does
// 6 C Dk Dv + 2 C^2 Dv = 7.3 MFLOP over about 180 KB of operands and
// outputs. On the tensor cores at float32 accuracy (3xTF32 below: three
// TF32 products per float32 product) that is 22 MFLOP of TF32 work
// against 495 TFLOP/s, less time than the bytes take at 3.35 TB/s: the
// function is bound by bytes (0.78 ms at the hybrid mixed step's shape),
// and the kernel by how close its products come to the tensor-core rate.
//
// Design.
// - Tensor cores at float32 accuracy: mma.sync m16n8k8 .tf32 with float32
//   accumulators. Every float32 operand x is split into hi = tf32(x) and
//   lo = x - hi and a product sums lo.hi + hi.lo + hi.hi (3xTF32; the
//   lo.lo term is below float32's rounding). One TF32 pass keeps about
//   three decimal digits: it stays inside the smoke's tolerance at the
//   serving path's statistics but not inside the float32 one of the card
//   tests (tests/test_torch_gdn_tf32.py shows both on the CPU).
// - One block per (sequence, head), holding every state column: q, k,
//   kcd and the scores are read from device memory once (a block per
//   column tile would read them once per tile). 16 warps. The state S
//   lives in shared memory, transposed (S^T [Dv, Dk], so the update is
//   (w v_new)^T @ k with k's rows as they are stored): phase A's two
//   products read it there, and in phase B each warp loads its own tiles
//   into the update product's accumulators and writes them back. Holding
//   S in those accumulators across every chunk (the first build) kept 32
//   registers a thread live through phase A, over the 128 a thread of a
//   512-thread block may have: it spilled.
// - Row scalings out of the operand path: (q e^g) @ S = diag(e^g) (q @ S)
//   and (k e^{g_C - g})^T @ v_new = k^T @ (diag(e^{g_C - g}) v_new), so q,
//   k, kcd and the scores travel raw by cp.async, and the scalings touch
//   accumulators or fragments in registers.
// - Loads one phase ahead: a chunk is phase A (v_new = v2 - kcd @ S and
//   q @ S, reading q, kcd and S) and phase B (attn @ v_new and the state
//   update, reading the scores, v_new and k). k and the scores of chunk n
//   land while phase A(n) computes, q and kcd of chunk n + 1 while phase
//   B(n) does; v2 of chunk n + 1 is loaded into the accumulators of
//   v_new, which are dead in phase B. Two block barriers a chunk. Each
//   operand has one buffer, so the block fits in 210 KB of shared memory
//   at Dk = Dv = 128 (one block an SM; a two-stage ring of every operand
//   would need 400 KB).
// - Fragment loads without bank conflicts: phase A's operands are read as
//   float4s that cover two k-steps (the MMA's k index is permuted:
//   logical column t of k-step 2j + h is dimension 16 j + 4 t + 2 h, and
//   t + 4 is 16 j + 4 t + 2 h + 1, for A and B alike), the other tiles as
//   scalars; the rows are XOR-swizzled so the 8 or 16 lanes of one
//   shared-memory phase hit distinct banks (scan_swz_* below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace gllm {

constexpr int kScanWarps = 16;
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kScanMaxChunk = 64;  // chunk sizes 16, 32 and 64
constexpr int kScanLdA = kScanMaxChunk + 4;  // score rows: conflict-free

// Warp layouts and shared memory (in floats). out and v_new [C, DV]: warp
// w owns 16 rows (m-tile w % 4) and DV / 4 columns (n-group w / 4, NO
// n-tiles of 8). S^T [DV, DK]: MS x NS tiles of 16 x 8 over a GM x GN
// grid of warps, PM x PN tiles each (warps past the grid hold none at
// the smallest dims). Tiles: q, kcd and k [64][DK], v_new [64][DV], S^T
// [DV][DK] (swizzled, unpadded), the scores [64][kScanLdA], g and the
// update weights e^{g_C - g} [64].
template <int DK, int DV>
struct ScanGeo {
  static constexpr int NO = DV / 32;
  static constexpr int MS = DV / 16;
  static constexpr int NS = DK / 8;
  static constexpr int GM = MS < 4 ? MS : 4;
  static constexpr int PM = MS / GM;
  static constexpr int GN = kScanWarps / GM;
  static constexpr int PN = NS / GN > 0 ? NS / GN : 1;
  static constexpr int Q = 0;
  static constexpr int KCD = Q + kScanMaxChunk * DK;
  static constexpr int K = KCD + kScanMaxChunk * DK;
  static constexpr int VN = K + kScanMaxChunk * DK;
  static constexpr int ST = VN + kScanMaxChunk * DV;
  static constexpr int A = ST + DV * DK;
  static constexpr int G = A + kScanMaxChunk * kScanLdA;
  static constexpr int W = G + kScanMaxChunk;
  static constexpr int FLOATS = W + kScanMaxChunk;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(DK >= 32 && DV >= 32 && DK % 32 == 0 && DV % 32 == 0,
                "gdn_chunk_scan geometry");
};

// Swizzles (a float's column within its row). q, kcd: odd rows swap the
// 16-float halves of each 32 (float4 reads of rows g, g + 1). S^T: rows
// by their two low bits over bits 4 and 3 (float4 reads of rows g, g + 1;
// float2 writes of rows g .. g + 3). k, v_new: rows by their two low bits
// over bits 3 and 4 (scalar reads of rows t, columns g).
__device__ __forceinline__ int scan_swz_a(int r, int c) {
  return c ^ ((r & 1) << 4);
}
__device__ __forceinline__ int scan_swz_s(int r, int c) {
  return c ^ ((r & 1) << 4) ^ ((r & 2) << 2);
}
__device__ __forceinline__ int scan_swz_b(int r, int c) {
  return c ^ ((r & 3) << 3);
}

__device__ __forceinline__ void scan_cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void scan_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void scan_cp_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// x = hi + lo for the TF32 MMA. hi: x rounded to TF32, to nearest with
// ties away (add half of the 13 dropped bits' range to the magnitude, then
// clear them), bit for bit what cvt.rna.tf32.f32 gives, in two integer
// operations (the conversion pipe runs at a quarter of their rate, and
// every fragment element is split). lo = x - hi, exact; the MMA reads only
// its TF32 bits (truncation: |error| < 2^-21 |x|).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct AFrag {  // m16 x k8, split
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    tf32_split(a0, hi[0], lo[0]);
    tf32_split(a1, hi[1], lo[1]);
    tf32_split(a2, hi[2], lo[2]);
    tf32_split(a3, hi[3], lo[3]);
  }
};
struct BFrag {  // k8 x n8, split
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    tf32_split(b0, hi[0], lo[0]);
    tf32_split(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at float32 accuracy (3xTF32), the small terms first
__device__ __forceinline__ void mma3(float* c, const AFrag& a,
                                     const BFrag& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kScanThreads, 1)
    gdn_chunk_scan_kernel(const float* __restrict__ qc,
                          const float* __restrict__ kc,
                          const float* __restrict__ v2,
                          const float* __restrict__ kcd,
                          const float* __restrict__ attn,
                          const float* __restrict__ gcum,
                          const float* __restrict__ init,
                          float* __restrict__ out,
                          float* __restrict__ final_state, int N, int C) {
  using G = ScanGeo<DK, DV>;
  constexpr int NO = G::NO, PM = G::PM, PN = G::PN;
  extern __shared__ float4 scan_smem4[];
  float* smem = reinterpret_cast<float*>(scan_smem4);
  float* sq = smem + G::Q;
  float* skcd = smem + G::KCD;
  float* sk = smem + G::K;
  float* svn = smem + G::VN;
  float* sst = smem + G::ST;
  float* sa = smem + G::A;
  float* sg = smem + G::G;
  float* sw = smem + G::W;

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this warp's out / v_new tile: rows r0, r1 (+ 8), columns dvo ..
  const int mo = warp & 3;
  const bool orow = mo * 16 < C;  // warp-uniform
  const int r0 = mo * 16 + g, r1 = r0 + 8;
  const int dvo = (warp >> 2) * (DV / 4);
  // this warp's state tiles: S^T rows (dv) from ms0, columns (dk) from ns0
  const int wn = warp / G::GM;
  const bool srow = wn * PN < G::NS;
  const int ms0 = (warp % G::GM) * 16 * PM, ns0 = wn * 8 * PN;

  float acc_v[NO][4];  // v2, then v_new
  float acc_o[NO][4];  // out

  auto load_a = [&](int n) {  // q, kcd and g of chunk n
    const int64_t row0 = (b * N + n) * C;
    const float* gq = qc + row0 * DK;
    const float* gk = kcd + row0 * DK;
    for (int i = tid; i < C * (DK / 4); i += kScanThreads) {
      const int r = i / (DK / 4), c = (i % (DK / 4)) * 4;
      scan_cp16(sq + r * DK + scan_swz_a(r, c), gq + (int64_t)r * DK + c);
      scan_cp16(skcd + r * DK + scan_swz_a(r, c), gk + (int64_t)r * DK + c);
    }
    if (tid < C / 4) scan_cp16(sg + tid * 4, gcum + row0 + tid * 4);
    scan_cp_commit();
  };
  auto load_b = [&](int n) {  // k and the scores of chunk n
    const int64_t row0 = (b * N + n) * C;
    const float* gk = kc + row0 * DK;
    for (int i = tid; i < C * (DK / 4); i += kScanThreads) {
      const int r = i / (DK / 4), c = (i % (DK / 4)) * 4;
      scan_cp16(sk + r * DK + scan_swz_b(r, c), gk + (int64_t)r * DK + c);
    }
    const float* ga = attn + row0 * C;
    for (int i = tid; i < C * (C / 4); i += kScanThreads) {
      const int r = i / (C / 4), c = (i % (C / 4)) * 4;
      scan_cp16(sa + r * kScanLdA + c, ga + (int64_t)r * C + c);
    }
    scan_cp_commit();
  };
  auto load_v2 = [&](int n) {  // v2 of chunk n into acc_v
    if (!orow) return;
    const float* p = v2 + (b * N + n) * C * DV + dvo + 2 * t4;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const float2 x0 =
          *reinterpret_cast<const float2*>(p + (int64_t)r0 * DV + 8 * j);
      const float2 x1 =
          *reinterpret_cast<const float2*>(p + (int64_t)r1 * DV + 8 * j);
      acc_v[j][0] = x0.x;
      acc_v[j][1] = x0.y;
      acc_v[j][2] = x1.x;
      acc_v[j][3] = x1.y;
    }
  };

  // the initial state, transposed, into shared memory
  {
    const float* st = init + b * DK * DV;
    for (int i = tid; i < DK * DV; i += kScanThreads) {
      const int dk = i / DV, dv = i % DV;
      sst[dv * DK + scan_swz_s(dv, dk)] = st[i];
    }
  }
  load_a(0);
  load_v2(0);

  for (int n = 0; n < N; ++n) {
    scan_cp_wait();
    __syncthreads();  // q, kcd, g of chunk n and S are in; B(n-1) is done
    load_b(n);

    // ---- phase A: v_new = v2 - kcd @ S, out = q @ S (scaled below)
    if (orow) {
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_o[j][e] = 0.f;
#pragma unroll 2
      for (int kp = 0; kp < DK / 16; ++kp) {
        const int c = 16 * kp + 4 * t4;
        const float4 xk0 = ld4(skcd + r0 * DK + scan_swz_a(r0, c));
        const float4 xk1 = ld4(skcd + r1 * DK + scan_swz_a(r1, c));
        const float4 xq0 = ld4(sq + r0 * DK + scan_swz_a(r0, c));
        const float4 xq1 = ld4(sq + r1 * DK + scan_swz_a(r1, c));
        AFrag ak[2], aq[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ak[h].set(-comp(xk0, 2 * h), -comp(xk1, 2 * h),
                    -comp(xk0, 2 * h + 1), -comp(xk1, 2 * h + 1));
          aq[h].set(comp(xq0, 2 * h), comp(xq1, 2 * h),
                    comp(xq0, 2 * h + 1), comp(xq1, 2 * h + 1));
        }
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int dv = dvo + 8 * j + g;
          const float4 y = ld4(sst + dv * DK + scan_swz_s(dv, c));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            BFrag bb;
            bb.set(comp(y, 2 * h), comp(y, 2 * h + 1));
            mma3(acc_v[j], ak[h], bb);
            mma3(acc_o[j], aq[h], bb);
          }
        }
      }
      const float e0 = expf(sg[r0]), e1 = expf(sg[r1]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = dvo + 8 * j + 2 * t4;
        st2(svn + r0 * DV + scan_swz_b(r0, col), acc_v[j][0], acc_v[j][1]);
        st2(svn + r1 * DV + scan_swz_b(r1, col), acc_v[j][2], acc_v[j][3]);
        acc_o[j][0] *= e0;
        acc_o[j][1] *= e0;
        acc_o[j][2] *= e1;
        acc_o[j][3] *= e1;
      }
    }
    const float g_last = sg[C - 1];
    const float decay = expf(g_last);
    if (tid < C) sw[tid] = expf(g_last - sg[tid]);
    scan_cp_wait();
    __syncthreads();  // k and the scores are in; v_new, w are visible
    if (n + 1 < N) {
      load_a(n + 1);
      load_v2(n + 1);
    }

    // ---- phase B: out += attn @ v_new; S = decay S + (w v_new)^T k
    if (orow) {
#pragma unroll 2
      for (int kk = 0; kk < C / 8; ++kk) {
        const int c0 = 8 * kk + t4;
        AFrag a;
        a.set(sa[r0 * kScanLdA + c0], sa[r1 * kScanLdA + c0],
              sa[r0 * kScanLdA + c0 + 4], sa[r1 * kScanLdA + c0 + 4]);
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int dv = dvo + 8 * j + g;
          BFrag bb;
          bb.set(svn[c0 * DV + scan_swz_b(c0, dv)],
                 svn[(c0 + 4) * DV + scan_swz_b(c0 + 4, dv)]);
          mma3(acc_o[j], a, bb);
        }
      }
      float* po = out + (b * N + n) * C * DV + dvo + 2 * t4;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        st2(po + (int64_t)r0 * DV + 8 * j, acc_o[j][0], acc_o[j][1]);
        st2(po + (int64_t)r1 * DV + 8 * j, acc_o[j][2], acc_o[j][3]);
      }
    }
    if (srow) {
      // this warp's S^T tiles, decayed (their last reads by phase A were
      // before the barrier above; no other warp touches them)
      float acc_s[PM][PN][4];
#pragma unroll
      for (int i = 0; i < PM; ++i)
#pragma unroll
        for (int j = 0; j < PN; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int dv = ms0 + 16 * i + g + 8 * h;
            const int dk = ns0 + 8 * j + 2 * t4;
            const float2 x = *reinterpret_cast<const float2*>(
                sst + dv * DK + scan_swz_s(dv, dk));
            acc_s[i][j][2 * h] = x.x * decay;
            acc_s[i][j][2 * h + 1] = x.y * decay;
          }
#pragma unroll 2
      for (int kk = 0; kk < C / 8; ++kk) {
        const int c0 = 8 * kk + t4, c1 = c0 + 4;
        const float w0 = sw[c0], w1 = sw[c1];
        AFrag a[PM];
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          const int dv = ms0 + 16 * i + g;
          a[i].set(svn[c0 * DV + scan_swz_b(c0, dv)] * w0,
                   svn[c0 * DV + scan_swz_b(c0, dv + 8)] * w0,
                   svn[c1 * DV + scan_swz_b(c1, dv)] * w1,
                   svn[c1 * DV + scan_swz_b(c1, dv + 8)] * w1);
        }
#pragma unroll
        for (int j = 0; j < PN; ++j) {
          const int dk = ns0 + 8 * j + g;
          BFrag bb;
          bb.set(sk[c0 * DK + scan_swz_b(c0, dk)],
                 sk[c1 * DK + scan_swz_b(c1, dk)]);
#pragma unroll
          for (int i = 0; i < PM; ++i) mma3(acc_s[i][j], a[i], bb);
        }
      }
      if (n + 1 < N) {  // S^T back for the next chunk's phase A
#pragma unroll
        for (int i = 0; i < PM; ++i)
#pragma unroll
          for (int j = 0; j < PN; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int dv = ms0 + 16 * i + g + 8 * h;
              const int dk = ns0 + 8 * j + 2 * t4;
              st2(sst + dv * DK + scan_swz_s(dv, dk), acc_s[i][j][2 * h],
                  acc_s[i][j][2 * h + 1]);
            }
      } else {  // the last chunk: the final state from the accumulators
        float* fs = final_state + b * DK * DV;
#pragma unroll
        for (int i = 0; i < PM; ++i)
#pragma unroll
          for (int j = 0; j < PN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int dv = ms0 + 16 * i + g + 8 * (e >> 1);
              const int dk = ns0 + 8 * j + 2 * t4 + (e & 1);
              fs[(int64_t)dk * DV + dv] = acc_s[i][j][e];
            }
      }
    }
  }
}

template <int DK, int DV>
static int launch_scan(const float* qc, const float* kc, const float* v2,
                       const float* kcd, const float* attn,
                       const float* gcum, const float* init, float* out,
                       float* final_state, int B, int N, int C,
                       cudaStream_t stream) {
  constexpr size_t smem = ScanGeo<DK, DV>::BYTES;
  auto kern = gdn_chunk_scan_kernel<DK, DV>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<B, kScanThreads, smem, stream>>>(qc, kc, v2, kcd, attn, gcum, init,
                                          out, final_state, N, C);
  return 0;
}

template <int DK>
static int dispatch_dv(int dv, const float* qc, const float* kc,
                       const float* v2, const float* kcd, const float* attn,
                       const float* gcum, const float* init, float* out,
                       float* final_state, int B, int N, int C,
                       cudaStream_t stream) {
  switch (dv) {
    case 32:
      return launch_scan<DK, 32>(qc, kc, v2, kcd, attn, gcum, init, out,
                                 final_state, B, N, C, stream);
    case 64:
      return launch_scan<DK, 64>(qc, kc, v2, kcd, attn, gcum, init, out,
                                 final_state, B, N, C, stream);
    case 128:
      return launch_scan<DK, 128>(qc, kc, v2, kcd, attn, gcum, init, out,
                                  final_state, B, N, C, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace gllm

// qc, kc, kcd [B, N, C, Dk]; v2 [B, N, C, Dv]; attn [B, N, C, C];
// gcum [B, N, C]; init [B, Dk, Dv]; out [B, N, C, Dv]; final_state
// [B, Dk, Dv]: all float32, contiguous, 16-byte aligned, on one device.
// Dk and Dv in {32, 64, 128}; C in {16, 32, 64}. Returns
// cudaGetLastError() after the launch.
extern "C" int gllm_gdn_chunk_scan(const void* qc, const void* kc,
                                   const void* v2, const void* kcd,
                                   const void* attn, const void* gcum,
                                   const void* init, void* out,
                                   void* final_state, int B, int N, int C,
                                   int dk, int dv, void* stream) {
  using namespace gllm;
  if (B <= 0 || N <= 0 || (C != 16 && C != 32 && C != 64))
    return (int)cudaErrorInvalidValue;
  const float* a[7] = {static_cast<const float*>(qc),
                       static_cast<const float*>(kc),
                       static_cast<const float*>(v2),
                       static_cast<const float*>(kcd),
                       static_cast<const float*>(attn),
                       static_cast<const float*>(gcum),
                       static_cast<const float*>(init)};
  float* o = static_cast<float*>(out);
  float* f = static_cast<float*>(final_state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
  switch (dk) {
    case 32:
      rc = dispatch_dv<32>(dv, a[0], a[1], a[2], a[3], a[4], a[5], a[6], o,
                           f, B, N, C, st);
      break;
    case 64:
      rc = dispatch_dv<64>(dv, a[0], a[1], a[2], a[3], a[4], a[5], a[6], o,
                           f, B, N, C, st);
      break;
    case 128:
      rc = dispatch_dv<128>(dv, a[0], a[1], a[2], a[3], a[4], a[5], a[6], o,
                            f, B, N, C, st);
      break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
