#!/usr/bin/env python3
"""Where the GQA ragged block's time goes, by phase, on the card.

Copies ``gllm_tpu_torch/csrc`` into ``build/ragged_trace/``, adds clock64
stamps to the copy of ``ragged_wgmma_kernel`` (the committed sources stay
as they are), builds it with the package's nvcc flags, and runs K1 through
the package's wrapper on the smoke's mixed batch (Llama-3.2-1B attention
over a bf16, an int8 and an fp8 cache, then head_dim 256 at Hq 16, Hkv 2).
For every block it records, in SM clock cycles: the work-order lookup, the
time to the consumers' first tile (Q loaded), and, for consumer warpgroup
0's first thread, the summed waits for a full stage, the Q.K^T product
(issue to done), the softmax and the P.V product; for the producer's first
thread (16-bit caches), its waits for an empty stage, its copy issue and
its barrier. Prints the card's name and power limit, then a summary per
case: cycles per tile of each phase, mean block cycles, and the summed
block cycles per SM.

    python3 tools/ragged_block_trace.py
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

COPY = ROOT / "build" / "ragged_trace"
SLOTS = 16
BLOCKS = 4096


def _stamp(src: str) -> str:
    """The kernel source with the clock64 stamps added."""
    def rep(old, new):
        assert src.count(old) == 1, old
        return src.replace(old, new)
    src = rep('''namespace gllm {

constexpr int kWgRows = 64;''', f'''namespace gllm {{
__device__ unsigned long long g_trace[{BLOCKS}][{SLOTS}];
#define TRACE_ON (blockIdx.x < {BLOCKS})

constexpr int kWgRows = 64;''')
    src = rep('''  const int tid = threadIdx.x % 128;
  int64_t* offs''', '''  const int tid = threadIdx.x % 128;
  unsigned long long pe = 0, pi = 0, ps = 0, ta, tb;
  int64_t* offs''')
    src = rep('''      if (i >= NS) mbar_wait(empty0 + 8 * st, (i / NS - 1) & 1);
      unsigned char* kt = smem + SM::RING_OFF + st * SM::STAGE;
      const int64_t* o = offs''', '''      ta = clock64();
      if (i >= NS) mbar_wait(empty0 + 8 * st, (i / NS - 1) & 1);
      tb = clock64();
      pe += tb - ta;
      unsigned char* kt = smem + SM::RING_OFF + st * SM::STAGE;
      const int64_t* o = offs''')
    src = rep('''      cp_async_mbar_arrive(full0 + 8 * st);
      if (tid < kWgKeys) offs[((i + 1) & 1) * kWgKeys + tid] = nxt;
      named_sync(1, 128);  // the next offsets in; this tile's read
    }
    cp_async_wait<0>();''', '''      cp_async_mbar_arrive(full0 + 8 * st);
      ta = clock64();
      pi += ta - tb;
      if (tid < kWgKeys) offs[((i + 1) & 1) * kWgKeys + tid] = nxt;
      named_sync(1, 128);  // the next offsets in; this tile's read
      ps += clock64() - ta;
    }
    cp_async_wait<0>();
    if (tid == 0 && TRACE_ON) {
      g_trace[blockIdx.x][9] = pe;
      g_trace[blockIdx.x][10] = pi;
      g_trace[blockIdx.x][11] = ps;
    }''')
    src = rep('''  __shared__ int s_seq, s_tile;
''', '''  __shared__ int s_seq, s_tile;
  const unsigned long long t_entry = clock64();
''')
    src = rep('''  const int seq = s_seq;
  if (seq < 0) {''', '''  const int seq = s_seq;
  if (threadIdx.x == 0 && TRACE_ON) {
    unsigned int smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    g_trace[blockIdx.x][0] = t_entry;
    g_trace[blockIdx.x][1] = clock64();
    g_trace[blockIdx.x][14] = smid;
  }
  if (seq < 0) {''')
    src = rep('''
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % NS;
    const int j0 = it * kWgKeys;
    mbar_wait(full0 + 8 * st, (it / NS) & 1);
    if (j0 <= last) {  // warpgroup-uniform: some row sees this tile''',
              '''
  unsigned long long cf = 0, cs = 0, cx = 0, cp = 0, ct = 0, ta, tb;
  const unsigned long long t_first_tile = clock64();
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % NS;
    const int j0 = it * kWgKeys;
    ta = clock64();
    mbar_wait(full0 + 8 * st, (it / NS) & 1);
    tb = clock64();
    cf += tb - ta;
    if (j0 <= last) {  // warpgroup-uniform: some row sees this tile
      ++ct;''')
    src = rep('''      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(s);
''', '''      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(s);
      ta = clock64();
      cs += ta - tb;
''')
    src = rep('''      fence_regs<DP / 2>(o);
      fence_regs_u32<16>(&pa[0][0]);
      wgmma_fence();''', '''      fence_regs<DP / 2>(o);
      fence_regs_u32<16>(&pa[0][0]);
      tb = clock64();
      cx += tb - ta;
      wgmma_fence();''')
    src = rep('''      wgmma_commit();
      wgmma_wait_all();
      fence_regs<DP / 2>(o);
      fence_regs_u32<16>(&pa[0][0]);
    }
    mbar_arrive(empty0 + 8 * st);
  }
''', '''      wgmma_commit();
      wgmma_wait_all();
      fence_regs<DP / 2>(o);
      fence_regs_u32<16>(&pa[0][0]);
      cp += clock64() - tb;
    }
    mbar_arrive(empty0 + 8 * st);
  }
  if (w == 0 && tid == 0 && TRACE_ON) {
    g_trace[blockIdx.x][2] = t_first_tile;
    g_trace[blockIdx.x][3] = cf;
    g_trace[blockIdx.x][4] = cs;
    g_trace[blockIdx.x][5] = cx;
    g_trace[blockIdx.x][6] = cp;
    g_trace[blockIdx.x][7] = ct;
    g_trace[blockIdx.x][8] = clock64();
    g_trace[blockIdx.x][13] = n_tiles;
  }
''')
    return src


def build_traced():
    """The traced library's K1 entry point and its trace reader."""
    from gllm_tpu_torch.ops.cuda import build
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "gllm_tpu_torch" / "csrc", COPY)
    hdr = COPY / "ragged_wgmma.cuh"
    hdr.write_text(_stamp(hdr.read_text()))
    entry = COPY / "ragged_attention.cu"
    entry.write_text(entry.read_text() + f'''
extern "C" int gllm_ragged_trace(void* dst, int clear) {{
  static unsigned long long zero[{BLOCKS}][{SLOTS}];
  if (clear)
    return (int)cudaMemcpyToSymbol(gllm::g_trace, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(dst, gllm::g_trace, sizeof(zero));
}}
''')
    lib_path = COPY / "libragged_trace.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(COPY),
                    "-o", str(lib_path), str(entry)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.gllm_ragged_attention
    fn.argtypes = build._SIGNATURES["ragged_attention"][1]
    fn.restype = ctypes.c_int
    build.kernel("ragged_attention")  # load the package's libraries
    build._libs["ragged_attention"] = fn   # K1's wrapper now calls the copy
    read = lib.gllm_ragged_trace
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    return read


def summary(name, buf):
    live = buf[:, 13] > 0
    b = buf[live]
    tiles, mine = b[:, 13].sum(), b[:, 7].sum()
    dur = b[:, 8] - b[:, 0]
    per_sm = {}
    for sm, d in zip(b[:, 14], dur):
        per_sm[sm] = per_sm.get(sm, 0) + d
    sums = np.array(list(per_sm.values()))
    print(f"{name}: {int(live.sum())} blocks with keys, {tiles} tiles "
          f"({mine} computed by warpgroup 0)")
    print(f"  per tile, consumer: full-wait {b[:, 3].sum() / tiles:.0f}, "
          f"Q.K^T {b[:, 4].sum() / mine:.0f}, softmax "
          f"{b[:, 5].sum() / mine:.0f}, P.V {b[:, 6].sum() / mine:.0f}")
    if b[:, 10].any():
        print(f"  per tile, producer: empty-wait {b[:, 9].sum() / tiles:.0f}"
              f", issue {b[:, 10].sum() / tiles:.0f}, barrier "
              f"{b[:, 11].sum() / tiles:.0f}")
    print(f"  per block: work-order lookup {np.mean(b[:, 1] - b[:, 0]):.0f}"
          f", to the first tile {np.mean(b[:, 2] - b[:, 1]):.0f}, whole "
          f"{dur.mean():.0f} (longest {dur.max()}); summed per SM: mean "
          f"{sums.mean():.0f}, max {sums.max()} over {len(sums)} SMs",
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("ragged_block_trace: no CUDA device", file=sys.stderr)
        return 2
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    read = build_traced()
    dev = torch.device("cuda")

    def trace(name, x, kc, vc, sc):
        def call():
            return rag.ragged_paged_attention(
                x["q"], kc, vc, x["cu"], x["kvl"], x["pt"],
                scale=x["q"].shape[2] ** -0.5, **sc)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        assert read(None, 1) == 0
        call()
        torch.cuda.synchronize()
        buf = np.zeros((BLOCKS, SLOTS), np.uint64)
        assert read(buf.ctypes.data, 0) == 0
        summary(name, buf.astype(np.int64))

    rng = np.random.default_rng(cs.SEED)
    cs.decode_shape(rng, dev)
    x = cs.mixed_shape(rng, dev)
    for cache, (kc, vc, sc, _, _) in cs._caches(x).items():
        trace(f"K1, Hq 32, Hkv 8, D 64, {cache} cache", x, kc, vc, sc)
    geo = dict(Hq=16, Hkv=2, D=256, quant=False)
    rng = np.random.default_rng(cs.SEED)
    cs.decode_shape(rng, dev, **geo)
    x = cs.mixed_shape(rng, dev, **geo)
    trace("K1, Hq 16, Hkv 2, D 256, bf16 cache", x, x["kc"], x["vc"], {})
    return 0


if __name__ == "__main__":
    sys.exit(main())
