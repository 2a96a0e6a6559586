#!/usr/bin/env python3
"""Does replaying the DeepSeek-V2-Lite graph engines' CUDA graphs inside
torch.profiler windows (CPU and CUDA activity) crash the process? ROADMAP
C 9: a segfault in ``CUDAGraph.replay`` inside ``chip_smoke.py``'s
DeepSeek profile window, twice in many runs.

Builds the engines as ``chip_smoke.py``'s serve phase does, at full width
with dummy bf16 weights: the sync graph engine (decode and mixed keys),
warmed at its sequence buckets; on the same weights a multi twin (blocks
of decode steps whose sub-steps sit in IF nodes) and a host-driven
speculative engine (verify keys). Then it opens and closes a profiler
window around one generate of each engine in turn, ``--windows`` times,
and prints each window's kind and the graph replays inside it, by kind.

Each mode runs in a child process of its own, so that a crash ends only
that child and is counted:

- ``nosync``: each window entered and left as the smoke entered them
  before the repair, with work possibly still queued on the card;
- ``sync``: ``torch.cuda.synchronize()`` before the profiler starts and
  before it stops (the smoke's and the server's windows since the
  repair);
- ``cpu``: as ``sync``, the profiler recording host activity only;
- ``noprof``: the same generates with no profiler at all;
- ``keep``: as ``sync``, with ``TEARDOWN_CUPTI=0`` in the child's
  environment (Kineto then leaves CUPTI attached between profiler
  sessions instead of tearing it down after each);
- ``empty``: as ``sync``, the caching allocator's free blocks handed back
  to the card (``torch.cuda.empty_cache()``) before each window;
- ``roomy``: as ``sync``, the graph engine's KV pool sized from 0.6 of
  the card's memory instead of 0.9, which leaves about 24 GB more free.

``--kinds`` limits the windows to some engines (graph, blocks, verify).

    python3 tools/profile_replay_probe.py [--windows 50] [--mode nosync,sync]

Prints, per mode, the clean windows and how the child ended. Needs one
CUDA card.
"""

import argparse
import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def engines(memory_util):
    import chip_smoke as cs
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, SamplingParams
    warm = SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True)
    base = dict(load_format="dummy", dtype="bfloat16", seed=cs.SEED)
    graph = LLM(model_cfg=cs.deepseek_v2_lite(), config=EngineConfig(
        **base, cache=CacheConfig(memory_util=memory_util)))
    graph.generate(prompt_token_ids=[[1, 2, 3, 4]], sampling_params=warm)
    graph.runner.warmup(decode_buckets=cs.SERVE_BUCKETS)
    twins = {"graph": graph}
    for name, flags in (("blocks", cs.MULTI), ("verify", cs.SPEC_HOST)):
        e = LLM(model_cfg=graph.model_cfg, params=graph.runner.params,
                config=EngineConfig(**base, **flags, cache=CacheConfig(
                    num_pages=cs.TWIN_PAGES)))
        e.generate(prompt_token_ids=[[1, 2, 3, 4]], sampling_params=warm)
        if name == "blocks":
            e.runner.warmup(decode_buckets=cs.MULTI_BLOCK_BUCKETS,
                            block_buckets=cs.MULTI_BLOCK_BUCKETS[-1:])
        twins[name] = e
    return twins


def child(mode, windows, kinds):
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from gllm_tpu_torch import SamplingParams
    t0 = time.monotonic()
    es = engines(0.6 if mode == "roomy" else 0.9)
    vocab = es["graph"].model_cfg.vocab_size
    prompts, _ = cs.drafty_workload(vocab, n=8)
    prompts = [p[:256] for p in prompts]
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    print(f"[{mode}] engines built in {time.monotonic() - t0:.1f} s on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    kinds = [k for k in es if k in kinds]
    busy = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    clean = collections.Counter()
    for i in range(windows):
        kind = kinds[i % len(kinds)]
        e = es[kind]
        g = e.runner.graphs
        before = {k: v["replays"] for k, v in g.by_kind.items()}
        # the window's generate first runs unprofiled once, as the smoke's
        # windows do, so that nothing is captured inside the window
        if i < len(kinds):
            e.generate(prompt_token_ids=prompts, sampling_params=sp)
            before = {k: v["replays"] for k, v in g.by_kind.items()}
        # products queued just before the window opens (a few ms of the
        # card's time), so that without the synchronize the card is busy
        # when the profiler starts
        for _ in range(8):
            busy @ busy
        print(f"[{mode}] window {i + 1} {kind}: start", flush=True)
        if mode != "nosync":
            torch.cuda.synchronize()
        if mode == "empty":
            torch.cuda.empty_cache()
        if mode == "noprof":
            e.generate(prompt_token_ids=prompts, sampling_params=sp)
            torch.cuda.synchronize()
            n_events = 0
        else:
            acts = [ProfilerActivity.CPU]
            if mode != "cpu":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                e.generate(prompt_token_ids=prompts, sampling_params=sp)
                if mode != "nosync":
                    torch.cuda.synchronize()
            n_events = len(prof.events())
        replays = {k: v["replays"] - before[k] for k, v in g.by_kind.items()
                   if v["replays"] - before[k]}
        clean[kind] += 1
        print(f"[{mode}] window {i + 1} {kind}: replays {replays}, "
              f"{n_events} profiler events: clean", flush=True)
    print(f"[{mode}] {windows} windows clean ({dict(clean)}) in "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--windows", type=int, default=50)
    p.add_argument("--mode", default="nosync,sync",
                   help="comma-separated: nosync, sync, cpu, noprof")
    p.add_argument("--kinds", default="graph,blocks,verify")
    p.add_argument("--child", action="store_true")
    args = p.parse_args()
    kinds = args.kinds.split(",")
    if args.child:
        child(args.mode, args.windows, kinds)
        return 0
    out = {}
    modes = args.mode.split(",")
    for mode in modes:
        if mode not in ("nosync", "sync", "cpu", "noprof", "keep", "empty",
                        "roomy"):
            raise SystemExit(f"unknown mode {mode!r}")
        t0 = time.monotonic()
        env = dict(os.environ)
        if mode == "keep":
            env["TEARDOWN_CUPTI"] = "0"
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--mode",
             mode, "--windows", str(args.windows), "--kinds", args.kinds],
            capture_output=True, text=True, cwd=ROOT, env=env)
        lines = res.stdout.splitlines()
        sys.stdout.write(res.stdout)
        if res.returncode:
            # the Python traceback, then the end of what followed it
            err = res.stderr
            start = err.find("Traceback")
            sys.stdout.write(err[max(0, start):][:6000] + "\n...\n"
                             + err[-1500:])
        done = sum(1 for line in lines if line.endswith(": clean"))
        ended = ("exited 0" if res.returncode == 0
                 else f"killed by signal {-res.returncode}"
                 if res.returncode < 0 else f"exited {res.returncode}")
        out[mode] = (done, ended)
        print(f"[probe] {mode}: {done} of {args.windows} windows clean, "
              f"child {ended}, {time.monotonic() - t0:.1f} s", flush=True)
    print(f"[probe] summary: {out}", flush=True)
    return 0 if all(e == "exited 0" for _, e in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
