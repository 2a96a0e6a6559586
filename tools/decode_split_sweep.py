#!/usr/bin/env python3
"""Time the split-KV decode kernels at the smoke's decode shapes for several
split plans (the SPLIT_WAVES / MLA_SPLIT_WAVES of
gllm_tpu_torch/ops/cuda/decode_attention.py), on one CUDA card:

    python3 tools/decode_split_sweep.py

Shapes are chip_smoke.py's decode batch (S 32, contexts 260..1996, page 16):
K2 at D 64 over a bf16, int8 and fp8 cache (Hq 32, Hkv 8), K2 at D 256 over
bf16 and fp8 (Hq 16, Hkv 2) and K2m over a bf16 and an fp8 latent (16 heads,
576 / 512). Prints, per number of waves, each kernel's device time per call
(torch.profiler) and its plan (splits x keys per split).
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from gllm_tpu_torch.ops.cuda import decode_attention as dec  # noqa: E402

FP8 = torch.float8_e4m3fn


def cases(dev):
    """(name, call, (q, cache, page table, v_dim)) at the smoke's shapes."""
    out = []
    x = cs.decode_shape(np.random.default_rng(cs.SEED), dev)
    for cache, (kc, vc, sc, _, _) in cs._caches(x).items():
        out.append((f"K2 D64 {cache}", lambda kc=kc, vc=vc, sc=sc:
                    dec.paged_decode_attention(x["q"], kc, vc, x["kvl"],
                                               x["pt"], scale=0.125, **sc),
                    (x["q"], kc, x["pt"], None)))
    y = cs.decode_shape(np.random.default_rng(cs.SEED), dev, Hq=16, Hkv=2,
                        D=256, quant=False)
    for cache in ("bf16", "fp8"):
        kc, vc = ((y["kc"].to(FP8), y["vc"].to(FP8)) if cache == "fp8"
                  else (y["kc"], y["vc"]))
        out.append((f"K2 D256 {cache}", lambda kc=kc, vc=vc:
                    dec.paged_decode_attention(y["q"], kc, vc, y["kvl"],
                                               y["pt"], scale=0.0625),
                    (y["q"], kc, y["pt"], None)))
    z = cs.decode_shape(np.random.default_rng(cs.SEED), dev, Hq=16, Hkv=1,
                        D=576, quant=False)
    for cache in ("bf16", "fp8"):
        lat = z["kc"].to(FP8) if cache == "fp8" else z["kc"]
        out.append((f"K2m {cache}", lambda lat=lat:
                    dec.paged_decode_attention(z["q"], lat, None, z["kvl"],
                                               z["pt"], scale=0.1147,
                                               v_dim=512),
                    (z["q"], lat, z["pt"], 512)))
    return out


def main():
    if not torch.cuda.is_available():
        print("decode_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]))
    todo = cases(torch.device("cuda"))
    for waves in (1, 2, 3, 4):
        dec.SPLIT_WAVES = dec.MLA_SPLIT_WAVES = waves
        row = []
        for name, fn, (q, cache, pt, v_dim) in todo:
            chunk, n, _ = dec.split_plan(q, cache, pt, v_dim)
            row.append(f"{name}: {cs.device_ms(fn, 30):.5f} ({n}x{chunk})")
        print(f"waves={waves}: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
