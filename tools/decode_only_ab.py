#!/usr/bin/env python3
"""What ``decode_only`` saves K1u and K1um on a pure-decode step. Times the
unified kernels on the card at the smoke's decode shape (32 one-token rows,
contexts 260..1996: Llama-3.2-1B attention over a bf16 and an fp8 cache,
and DeepSeek-V2-Lite's latent over a bf16 one), two ways:

- ``hint``: ``decode_only=True``, as the runner calls them on a decode
  step: the decode blocks alone;
- ``none``: no hint: the decode blocks, then the ragged blocks, which find
  no work.

Both must give the same rows (checked bitwise). Device time per call
(torch.profiler, every launch summed; a reading below the card's bound is
taken again, as the smoke does) and the wrapper's CUDA-event time back to
back, in turns: none, hint, hint, none, three times. Prints the card's
name and power limit, then one JSON line per kernel.

    python3 tools/decode_only_ab.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("decode_only_ab: no CUDA device", file=sys.stderr)
        return 2
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cases = []
    x = cs.decode_shape(np.random.default_rng(cs.SEED), dev)
    caches = cs._caches(x)
    S, page = len(x["kv"]), x["page"]
    for cache in ("bf16", "fp8"):
        kc, vc, _, _, _ = caches[cache]
        cases.append((f"K1u, {cache} cache", x["q"], kc, vc,
                       dict(scale=64 ** -0.5),
                       cs._kv_bytes(x["kv"], page, 8, 64, cache)))
    cfg = cs.deepseek_v2_lite()
    m = cs.decode_shape(np.random.default_rng(cs.SEED), dev, Hq=16, Hkv=1,
                        D=cfg.mla_cache_width, quant=False)
    lat_bytes = sum(m["kv"]) * cfg.mla_cache_width * 2
    cases.append(("K1um, bf16 latent", m["q"], m["kc"], None,
                  dict(scale=cfg.mla_cache_width ** -0.5,
                       v_dim=cfg.kv_lora_rank), lat_bytes))
    cu = torch.arange(S + 1, dtype=torch.int32, device=dev)
    for name, q, kc, vc, kw, nbytes in cases:
        md = x if vc is not None else m

        def call(hint, q=q, kc=kc, vc=vc, kw=kw, md=md):
            return rag.ragged_paged_attention(
                q, kc, vc, cu, md["kvl"], md["pt"], unified=True,
                decode_only=hint, **kw)
        same = torch.equal(call(True), call(False))
        floor = cs.bound(nbytes, 0)[0]
        times = {"none": [], "hint": []}
        events = {"none": [], "hint": []}
        for _ in range(3):
            for arm in ("none", "hint", "hint", "none"):
                fn = (lambda: call(arm == "hint"))
                split = cs.timed_above_bound(fn, 50, floor)
                times[arm].append(sum(split.values()))
                events[arm].append(cs.cuda_ms(fn, 50))
        print(json.dumps({"kernel": name, "same_rows": same,
                          "hint_ms": times["hint"],
                          "none_ms": times["none"],
                          "hint_events_ms": events["hint"],
                          "none_events_ms": events["none"], "card": smi}),
              flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
