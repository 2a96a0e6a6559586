// Seeded Gumbel noise: JAX's threefry2x32 draws of seeded sampling rows
// (ops/cuda/threefry.py, plain version ops/threefry.py::seeded_noise_).
//
// Replaces no Pallas kernel: the JAX package draws a seeded row's noise
// with jax.random (gllm_tpu/ops/sampling.py, sample:269, _row_base_keys:304,
// spec_verify:373), elementwise code that XLA fuses into the sampling
// program. Written out in PyTorch the same draw is over a hundred
// elementwise launches a sampled step; this is one.
//
// Row r of ``out`` [rows, V] (4-byte elements, rows contiguous) draws from
// seed s = r / group (r when group is 0), only when seed[s] >= 0: its key
// is fold_in(key(seed[s]), step[s]), then fold_in(., r % group) when group
// > 0 (a verify row's position), then fold_in(., stream_fold) when it is
// >= 0; element i is b0 ^ b1 of threefry2x32(key, (0, i)) (JAX's
// partitionable random bits). Rows of a negative seed are left as they
// are. ``mode``: 0 the raw bits, 1 a uniform in [0, 1), 2 Gumbel noise
// -log(-log(u)) with u uniform in [FLT_MIN, 1) (jax.random.gumbel's "low"
// mode). Seeds and steps are read on the device, so a CUDA graph replays
// the draw with each step's staged values.
//
// Bound by integer operations: one thread an element, 20 rounds of
// threefry2x32 in registers (72 int32 operations, of which the 40 rotates
// and xors issue only on the integer pipe), 4 bytes written; no shared
// memory. Each thread derives its row's key (one to three more
// hashes) once and draws 8 elements, a warp's neighbouring threads on
// neighbouring addresses.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
}

// the Threefry-2x32 hash of the counts (x0, x1) under the key (k0, k1),
// in place: JAX's _threefry2x32_lowering, unrolled
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// jax.random.fold_in: the key becomes the hash of the counts (0, data)
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

__global__ void __launch_bounds__(kThreads)
threefry_noise_kernel(const int* __restrict__ seed,
                      const int* __restrict__ step,
                      uint32_t* __restrict__ out, int V, int group,
                      int stream_fold, int mode) {
  const int row = blockIdx.x;
  const int s = group > 0 ? row / group : row;
  const int sd = seed[s];
  if (sd < 0) return;
  // key(seed) for a seed below 2^32: (seed >> 32, seed) = (0, seed)
  uint32_t k0 = 0u, k1 = static_cast<uint32_t>(sd);
  fold_in(k0, k1, static_cast<uint32_t>(step[s]));
  if (group > 0) fold_in(k0, k1, static_cast<uint32_t>(row % group));
  if (stream_fold >= 0) fold_in(k0, k1, static_cast<uint32_t>(stream_fold));
  uint32_t* o = out + static_cast<size_t>(row) * V;
  const int base = blockIdx.y * (kThreads * kPerThread) + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = base + e * kThreads;
    if (i >= V) return;
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(i);
    threefry2x32(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    if (mode == 0) {
      o[i] = bits;
      continue;
    }
    // the top 23 bits as the mantissa of a float in [1, 2), less one
    float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    if (mode == 2) {
      const float u = fmaxf(f + FLT_MIN, FLT_MIN);
      f = -logf(-logf(u));
    }
    o[i] = __float_as_uint(f);
  }
}

}  // namespace

extern "C" int gllm_threefry_noise(const int* seed, const int* step,
                                   void* out, int rows, int V, int group,
                                   int stream_fold, int mode,
                                   cudaStream_t stream) {
  if (rows <= 0 || V <= 0) return 0;
  const int per_block = kThreads * kPerThread;
  dim3 grid(rows, (V + per_block - 1) / per_block);
  threefry_noise_kernel<<<grid, kThreads, 0, stream>>>(
      seed, step, static_cast<uint32_t*>(out), V, group, stream_fold, mode);
  return cudaGetLastError();
}
