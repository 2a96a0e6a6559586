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
// everything in float32, as the TPU kernel and the plain version are.
//
// Bound on the card: operations. A chunk of C = 64 rows at Dk = Dv = 128
// does 6 C Dk Dv + 2 C^2 Dv = 7.3 MFLOP over about 180 KB of operands and
// outputs, 40 flops per byte, above the float32 FMA rate's balance point
// (67 TFLOP/s over 3.35 TB/s, 20 flops per byte). The tensor cores take no
// full-precision float32; TF32 or split-bf16 products are later work with
// a tolerance of their own.
//
// Design. On the TPU the chunk axis is a sequential ("arbitrary") grid axis
// and the state lives in VMEM across grid steps. Blocks on the card run in
// no order, so the chunk loop runs inside a block. Column j of S, v_new and
// out depends only on column j of S, v2 and out, so a block owns one
// (sequence-head b, tile of kCols state columns) pair: B * Dv / 32 blocks,
// enough to fill the SMs at a small batch. The block keeps its [Dk, 32]
// state tile in shared memory for all N chunks, loads each chunk's
// [C, Dk] operands (q scaled by e^g and k by e^{g_C - g} on the way) and
// its [C, C] scores once, writes out per chunk, and writes the state once
// at the end. 256 threads: for the [C, 32] products thread (r, c) owns
// rows r, r + 32 and four adjacent columns (float4 reads of the state and
// v_new rows); for the state update rows r, r + 32, ... of the [Dk, 32]
// tile. Not yet done: overlapping the next chunk's loads with this one's
// products (cp.async), register-blocked tiles, tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace gllm {

constexpr int kScanCols = 32;      // state columns per block
constexpr int kScanThreads = 256;
constexpr int kScanMaxChunk = 64;  // chunk sizes 16, 32 and 64
constexpr int kScanRowGroups = kScanThreads / (kScanCols / 4);  // 32

// Shared memory in floats: the state tile [DK][LDS], q, k, kcd [64][LDA],
// the scores [64][LDC], v2 and v_new tiles [64][LDS], and g [64]. Row
// strides are padded by 4 so the row groups of a warp hit distinct banks
// and every row stays 16-byte aligned.
template <int DK>
struct ScanSmem {
  static constexpr int LDA = DK + 4;
  static constexpr int LDS = kScanCols + 4;
  static constexpr int LDC = kScanMaxChunk + 4;
  static constexpr int S = 0;
  static constexpr int Q = S + DK * LDS;
  static constexpr int K = Q + kScanMaxChunk * LDA;
  static constexpr int KCD = K + kScanMaxChunk * LDA;
  static constexpr int A = KCD + kScanMaxChunk * LDA;
  static constexpr int V = A + kScanMaxChunk * LDC;
  static constexpr int VN = V + kScanMaxChunk * LDS;
  static constexpr int G = VN + kScanMaxChunk * LDS;
  static constexpr int FLOATS = G + kScanMaxChunk;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void fma4(float* acc, float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kScanThreads)
    gdn_chunk_scan_kernel(const float* __restrict__ qc,
                          const float* __restrict__ kc,
                          const float* __restrict__ v2,
                          const float* __restrict__ kcd,
                          const float* __restrict__ attn,
                          const float* __restrict__ gcum,
                          const float* __restrict__ init,
                          float* __restrict__ out,
                          float* __restrict__ final_state, int N, int C) {
  using SM = ScanSmem<DK>;
  constexpr int RPT = kScanMaxChunk / kScanRowGroups;  // chunk rows a thread
  constexpr int KPT = DK / kScanRowGroups;             // state rows a thread
  static_assert(DK % kScanRowGroups == 0 && DV % kScanCols == 0,
                "gdn_chunk_scan geometry");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sS = smem + SM::S;
  float* sq = smem + SM::Q;
  float* sk = smem + SM::K;
  float* skcd = smem + SM::KCD;
  float* sa = smem + SM::A;
  float* sv = smem + SM::V;
  float* sn = smem + SM::VN;
  float* sg = smem + SM::G;

  const int64_t b = blockIdx.x;
  const int j0 = blockIdx.y * kScanCols;
  const int tid = threadIdx.x;
  const int rg = tid / (kScanCols / 4);       // row group
  const int c4 = (tid % (kScanCols / 4)) * 4;  // first of four columns

  {
    const float* st = init + b * DK * DV + j0;
    for (int i = tid; i < DK * (kScanCols / 4); i += kScanThreads) {
      const int r = i / (kScanCols / 4), c = (i % (kScanCols / 4)) * 4;
      st4(sS + r * SM::LDS + c, ld4(st + (int64_t)r * DV + c));
    }
  }

  for (int n = 0; n < N; ++n) {
    const int64_t row0 = (b * N + n) * C;  // first row of the chunk
    __syncthreads();  // the last chunk is done with every tile
    for (int i = tid; i < C; i += kScanThreads) sg[i] = gcum[row0 + i];
    __syncthreads();
    const float g_last = sg[C - 1];
    for (int i = tid; i < C * (DK / 4); i += kScanThreads) {
      const int r = i / (DK / 4), c = (i % (DK / 4)) * 4;
      const int64_t off = (row0 + r) * DK + c;
      const float eq = expf(sg[r]);
      const float ek = expf(g_last - sg[r]);
      float4 x = ld4(qc + off);
      st4(sq + r * SM::LDA + c,
          make_float4(x.x * eq, x.y * eq, x.z * eq, x.w * eq));
      x = ld4(kc + off);
      st4(sk + r * SM::LDA + c,
          make_float4(x.x * ek, x.y * ek, x.z * ek, x.w * ek));
      st4(skcd + r * SM::LDA + c, ld4(kcd + off));
    }
    for (int i = tid; i < C * (C / 4); i += kScanThreads) {
      const int r = i / (C / 4), c = (i % (C / 4)) * 4;
      st4(sa + r * SM::LDC + c, ld4(attn + (row0 + r) * C + c));
    }
    for (int i = tid; i < C * (kScanCols / 4); i += kScanThreads) {
      const int r = i / (kScanCols / 4), c = (i % (kScanCols / 4)) * 4;
      st4(sv + r * SM::LDS + c, ld4(v2 + (row0 + r) * DV + j0 + c));
    }
    __syncthreads();

    // v_new = v2 - kcd @ S and the inter-chunk part (q e^g) @ S, one pass
    // over the state tile. Rows past C compute on stale tiles and are never
    // stored.
    float vp[RPT][4], o[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) vp[i][e] = o[i][e] = 0.f;
#pragma unroll 4
    for (int k = 0; k < DK; ++k) {
      const float4 s = ld4(sS + k * SM::LDS + c4);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + kScanRowGroups * i;
        fma4(vp[i], skcd[r * SM::LDA + k], s);
        fma4(o[i], sq[r * SM::LDA + k], s);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + kScanRowGroups * i;
      if (r < C) {
        const float4 v = ld4(sv + r * SM::LDS + c4);
        st4(sn + r * SM::LDS + c4,
            make_float4(v.x - vp[i][0], v.y - vp[i][1], v.z - vp[i][2],
                        v.w - vp[i][3]));
      }
    }
    __syncthreads();

    // out = (q e^g) @ S + attn @ v_new
    for (int c = 0; c < C; ++c) {
      const float4 v = ld4(sn + c * SM::LDS + c4);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        fma4(o[i], sa[(rg + kScanRowGroups * i) * SM::LDC + c], v);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + kScanRowGroups * i;
      if (r < C)
        st4(out + (row0 + r) * DV + j0 + c4,
            make_float4(o[i][0], o[i][1], o[i][2], o[i][3]));
    }

    // S = e^{g_C} S + (k e^{g_C - g})^T @ v_new: each thread updates the
    // state elements it owns (the reads of S above are behind the barrier)
    float u[KPT][4];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[i][e] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float4 v = ld4(sn + c * SM::LDS + c4);
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        fma4(u[i], sk[c * SM::LDA + rg + kScanRowGroups * i], v);
    }
    const float decay = expf(g_last);
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      float* p = sS + (rg + kScanRowGroups * i) * SM::LDS + c4;
      const float4 s = ld4(p);
      st4(p, make_float4(fmaf(decay, s.x, u[i][0]), fmaf(decay, s.y, u[i][1]),
                         fmaf(decay, s.z, u[i][2]),
                         fmaf(decay, s.w, u[i][3])));
    }
  }
  __syncthreads();
  float* fs = final_state + b * DK * DV + j0;
  for (int i = tid; i < DK * (kScanCols / 4); i += kScanThreads) {
    const int r = i / (kScanCols / 4), c = (i % (kScanCols / 4)) * 4;
    st4(fs + (int64_t)r * DV + c, ld4(sS + r * SM::LDS + c));
  }
}

template <int DK, int DV>
static int launch_scan(const float* qc, const float* kc, const float* v2,
                       const float* kcd, const float* attn,
                       const float* gcum, const float* init, float* out,
                       float* final_state, int B, int N, int C,
                       cudaStream_t stream) {
  constexpr size_t smem = ScanSmem<DK>::BYTES;
  auto kern = gdn_chunk_scan_kernel<DK, DV>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<dim3(B, DV / kScanCols), kScanThreads, smem, stream>>>(
      qc, kc, v2, kcd, attn, gcum, init, out, final_state, N, C);
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
