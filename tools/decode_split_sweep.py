#!/usr/bin/env python3
"""Time the split-KV decode kernels at the smoke's decode shapes for several
split plans (the SPLIT_WAVES / MLA_SPLIT_WAVES and MLA_MIN_SPLIT_KEYS of
gllm_tpu_torch/ops/cuda/decode_attention.py), on one CUDA card:

    python3 tools/decode_split_sweep.py
    python3 tools/decode_split_sweep.py --package DIR

Shapes are chip_smoke.py's decode batch (S 32, contexts 260..1996, page 16):
K2 at D 64 over a bf16, int8 and fp8 cache (Hq 32, Hkv 8), K2 at D 256 over
bf16 and fp8 (Hq 16, Hkv 2) and K2m over a bf16 and an fp8 latent (16 heads,
576 / 512); and, for K2m, the decode steps of the smoke's profiled window
(S 8, contexts 513..536, the page table padded to the engine's 64-page
bucket). Prints, per number of waves, each kernel's device time per call
(torch.profiler, every launch of a call summed) and its plan (splits x keys
per split); then, per minimum MLA split length, K2m's at both batch shapes.
With ``--package DIR`` (a directory holding another tree's
``gllm_tpu_torch``, e.g. an older commit unpacked with ``git archive``) it
times only K2m at both shapes, with that tree's kernels and split plan: put
two trees in one call to compare them on one card.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

dec = None  # ops.cuda.decode_attention of the tree under test (main)

FP8 = torch.float8_e4m3fn
MLA_SCALE = 0.1147


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
    return out + mla_cases(dev, "S32", mla_decode_shape(dev))


def mla_decode_shape(dev):
    z = cs.decode_shape(np.random.default_rng(cs.SEED), dev, Hq=16, Hkv=1,
                        D=576, quant=False)
    return z["q"], z["kc"], z["kvl"], z["pt"]


def window_shape(dev, S=8, page=16, bucket=64):
    """The profiled window's decode steps: 8 rows of 512 prompt tokens
    plus up to 24 generated ones, page table padded as the engine pads
    it (bucket_size of 34 pages: 64)."""
    rng = np.random.default_rng(cs.SEED + 7)
    kv = rng.integers(513, 537, S)
    lat, _, pt = cs._paged(rng, kv, 1, 576, page, torch.bfloat16, dev)
    pad = torch.zeros((S, bucket), dtype=torch.int32, device=dev)
    pad[:, :pt.shape[1]] = pt
    q = cs._randn((S, 16, 576), dev)
    return q, lat, torch.from_numpy(kv.astype(np.int32)).to(dev), pad


def mla_cases(dev, tag, shape):
    q, lat_bf16, kvl, pt = shape
    out = []
    for cache in ("bf16", "fp8"):
        lat = lat_bf16.to(FP8) if cache == "fp8" else lat_bf16
        out.append((f"K2m {tag} {cache}", lambda lat=lat:
                    dec.paged_decode_attention(q, lat, None, kvl, pt,
                                               scale=MLA_SCALE, v_dim=512),
                    (q, lat, pt, 512)))
    return out


def timed(todo):
    row = []
    for name, fn, (q, cache, pt, v_dim) in todo:
        chunk, n, _ = dec.split_plan(q, cache, pt, v_dim)
        row.append(f"{name}: {cs.device_ms(fn, 30):.5f} ({n}x{chunk})")
    return "; ".join(row)


def main():
    global dec
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", help="time K2m only, with the "
                    "gllm_tpu_torch found in this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.package:
        root = str(Path(args.package).resolve())
        sys.path.insert(0, root)
    from gllm_tpu_torch.ops.cuda import decode_attention
    dec = decode_attention
    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]))
    print(f"package: {Path(dec.__file__).parents[2]}")
    dev = torch.device("cuda")
    if args.package:
        mla = (mla_cases(dev, "S32", mla_decode_shape(dev))
               + mla_cases(dev, "S8", window_shape(dev)))
        print(f"K2m: {timed(mla)}", flush=True)
        return 0
    saved = dec.SPLIT_WAVES, dec.MLA_SPLIT_WAVES, dec.MLA_MIN_SPLIT_KEYS
    todo = cases(dev)
    for waves in (1, 2, 3, 4):
        dec.SPLIT_WAVES = dec.MLA_SPLIT_WAVES = waves
        print(f"waves={waves}: {timed(todo)}", flush=True)
    dec.SPLIT_WAVES, dec.MLA_SPLIT_WAVES = saved[:2]
    mla = (mla_cases(dev, "S32", mla_decode_shape(dev))
           + mla_cases(dev, "S8", window_shape(dev)))
    for min_keys in (0, 64, 128, 256, 512):
        dec.MLA_MIN_SPLIT_KEYS = min_keys
        print(f"mla_min_split_keys={min_keys}: {timed(mla)}", flush=True)
    dec.MLA_MIN_SPLIT_KEYS = saved[2]
    return 0


if __name__ == "__main__":
    sys.exit(main())
