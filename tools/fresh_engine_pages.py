#!/usr/bin/env python3
"""KV pages of one serving configuration's engine built first in a fresh
process, against which the same engine in ``chip_smoke.py``'s serve phase
(after other models' engines were built and freed) is read.

    python3 tools/fresh_engine_pages.py [configuration ...]

Each configuration (a key of ``chip_smoke.SERVE``, by default
``qwen3_next``) is built in a process of its own, from the smoke's model
configuration and dummy weights from its seed, and prints its free memory
before the engine, the free and stranded memory it was sized from, its
pages and the memory by allocator pool (``chip_smoke.memory_breakdown``).
Needs one CUDA card.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(name: str) -> None:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM
    torch.cuda.memory._record_memory_history(enabled="state",
                                             stacks="python")
    model, kw = smoke.SERVE[name][0], dict(smoke.SERVE[name][1])
    kv = kw.pop("kv_cache_dtype", "auto")
    free0 = torch.cuda.mem_get_info()[0]
    llm = LLM(model_cfg=model(), config=EngineConfig(
        load_format="dummy", dtype="bfloat16", seed=smoke.SEED,
        cache=CacheConfig(kv_cache_dtype=kv), **kw))
    sz = llm.runner.sizing
    print(f"[fresh {name}] {llm.runner.num_pages} KV pages; "
          f"{free0 / 2**30:.3f} GiB free before the engine; sized from "
          f"{sz['free'] / 2**30:.3f} GiB free with "
          f"{(sz['reserved'] - sz['allocated']) / 2**30:.3f} GiB stranded; "
          f"memory by pool: {smoke.memory_breakdown(4)}", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    rc = 0
    for name in sys.argv[1:] or ["qwen3_next"]:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              name]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
