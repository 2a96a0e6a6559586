#!/usr/bin/env python3
"""Device memory an engine leaves behind once it is freed: builds, warms,
serves and frees one engine after another at the full width of
Llama-3.2-1B or DeepSeek-V2-Lite (the smoke's configurations, dummy
weights from its seed, shared by every engine), and prints after each the card's memory by allocator
pool (``chip_smoke.memory_breakdown``), the part outside the allocator,
and the CUDA graphs and runners still alive.

    python3 tools/engine_memory_cycle.py [--model llama|deepseek] [mode ...]

Modes (default: graph overlap multi multi slot slot): ``graph`` (the sync
loop over CUDA graphs), ``overlap`` (the pipelined loop), ``multi`` (blocks
under on-device finish) and ``slot`` (the multi engine with persistent
slots), each served by 16 greedy requests of the smoke's shape, a quarter
of its length; modes joined by ``+`` are built one after the other and
freed together, alive at once as the smoke's twins are. Last, it takes
256 MiB blocks until the card has none left, to see whether memory outside
the allocator comes back under pressure. After each engine is freed it also asks the CUDA runtime to
trim the memory it caches for graphs (``cudaDeviceGraphMemTrim``) and
prints what is outside the allocator then. Needs one CUDA card.
"""

import ctypes
import gc
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402

MODES = {"graph": {}, "overlap": smoke.OVERLAP, "multi": smoke.MULTI,
         "slot": smoke.SLOT}


def live(kind):
    return sum(isinstance(o, kind) for o in gc.get_objects())


def main() -> int:
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, SamplingParams
    from gllm_tpu_torch.runner.graphs import DecodeGraphs
    args = sys.argv[1:]
    model = smoke.llama_3_2_1b
    if args[:1] == ["--model"]:
        model = {"llama": smoke.llama_3_2_1b,
                 "deepseek": smoke.deepseek_v2_lite}[args[1]]
        args = args[2:]
    modes = args or ["graph", "overlap", "multi", "multi", "slot", "slot"]
    cfg = model()
    cudart = ctypes.CDLL("/usr/local/cuda/lib64/libcudart.so")
    params = None
    rng = np.random.default_rng(smoke.SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(16, 384, 16)]
    sps = [SamplingParams(temperature=0.0, max_tokens=int(m),
                          ignore_eos=True)
           for m in rng.integers(8, 33, 16)]
    print(f"[cycle] before any engine: {smoke.memory_breakdown()}",
          flush=True)
    for i, mode in enumerate(modes):
        engines = []
        for one in mode.split("+"):
            llm = LLM(model_cfg=cfg, params=params, config=EngineConfig(
                load_format="dummy", dtype="bfloat16", seed=smoke.SEED,
                cache=CacheConfig(num_pages=smoke.TWIN_PAGES),
                **MODES[one]))
            params = llm.runner.params
            llm.runner.warmup(decode_buckets=smoke.MULTI_BLOCK_BUCKETS,
                              block_buckets=smoke.MULTI_BLOCK_BUCKETS)
            llm.generate(prompt_token_ids=prompts, sampling_params=sps)
            engines.append(llm)
        torch.cuda.synchronize()
        print(f"[cycle] {i} {mode} served: {smoke.memory_breakdown()}",
              flush=True)
        del llm, engines
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[cycle] {i} {mode} freed: {live(torch.cuda.CUDAGraph)} "
              f"CUDA graphs and {live(DecodeGraphs)} DecodeGraphs alive; "
              f"{smoke.memory_breakdown()}", flush=True)
        rc = cudart.cudaDeviceGraphMemTrim(torch.cuda.current_device())
        print(f"[cycle] {i} {mode} after cudaDeviceGraphMemTrim (rc {rc}): "
              f"{smoke.memory_breakdown()}", flush=True)
    # does the card give what lies outside the allocator back under
    # pressure? Take 256 MiB blocks until none is left
    free = torch.cuda.mem_get_info()[0]
    held = []
    try:
        while True:
            held.append(torch.empty(256 << 20, dtype=torch.uint8,
                                    device="cuda"))
    except torch.OutOfMemoryError:
        pass
    got = len(held) * 256 << 20
    del held
    torch.cuda.empty_cache()
    print(f"[cycle] under pressure: {got / 2**30:.3f} GiB allocated of "
          f"{free / 2**30:.3f} GiB free; afterwards "
          f"{smoke.memory_breakdown()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
