#!/usr/bin/env python3
"""What does the step-trace ring's recording (and the request spans) cost
the smoke's reference phase? Runs ``chip_smoke.phase_reference`` (depth-cut
float32 engines on the card beside the same engines on the CPU) four
times in one process, recording on, off, on, off, after building the
kernels once; "off" makes ``TRACE.record`` a no-op and builds every
engine with ``tracing=False``. Prints each run's wall and where it went
(the phase's own split: the card's engines, the CPU's, the replays).

With ``--cpu``, a rehearsal that needs no card: a tiny float32 Llama
(2 layers, width 256) under the reference phase's engine kinds (sync,
unified, overlap, multi, slot), three prompts of 40, 75 and 130 tokens
and 8 greedy tokens each, on one torch thread, recording on and off in
turn for ``--rounds`` rounds; prints the median build and run of an
engine either way.

    python3 tools/trace_cost.py [--cpu] [--rounds 6]

Prints one JSON line per run and a summary line.
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class Recording:
    """Turns the ring's recording and the engines' spans off and on."""

    def __init__(self):
        from gllm_tpu_torch import LLM
        from gllm_tpu_torch.obs.steptrace import TRACE
        self.trace, self.llm = TRACE, LLM
        self.record, self.init = TRACE.record, LLM.__init__

    def set(self, on: bool) -> None:
        if on:
            self.trace.record = self.record
            self.llm.__init__ = self.init
            return
        init = self.init

        def untraced(llm, *a, **kw):
            kw["config"] = dataclasses.replace(kw["config"], tracing=False)
            init(llm, *a, **kw)

        self.trace.record = lambda *a, **k: None
        self.llm.__init__ = untraced


def card(rounds: int) -> None:
    import chip_smoke
    chip_smoke.SMI = chip_smoke.phase_device()
    chip_smoke.phase_build()
    rec = Recording()
    walls = {True: [], False: []}
    for i in range(rounds):
        on = i % 2 == 0
        rec.set(on)
        t0 = time.monotonic()
        spent = chip_smoke.phase_reference()
        wall = time.monotonic() - t0
        walls[on].append(wall)
        print(json.dumps({"recording": on, "wall_s": round(wall, 2),
                          "spent_s": {k: round(v, 2)
                                      for k, v in spent.items()}}),
              flush=True)
    rec.set(True)
    print(json.dumps({"card": chip_smoke.SMI,
                      "median_on_s": statistics.median(walls[True]),
                      "median_off_s": statistics.median(walls[False])}))


def cpu(rounds: int) -> None:
    import numpy as np
    from gllm_tpu_torch import (CacheConfig, EngineConfig, LLM, ModelConfig,
                                SamplingParams, SchedulerConfig)
    from gllm_tpu_torch.models import dense
    torch.set_num_threads(1)
    cfg = ModelConfig(architecture="LlamaForCausalLM", vocab_size=4096,
                      hidden_size=256, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=64, intermediate_size=512,
                      max_position=4096, rope_theta=500000.0,
                      tie_word_embeddings=True)
    params = dense.init_params(cfg, 0, torch.float32, "cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (40, 75, 130)]
    kinds = {"sync": {}, "unified": dict(unified_step=True),
             "overlap": dict(pipelined_loop=True),
             "multi": dict(pipelined_loop=True, ondevice_finish=True),
             "slot": dict(pipelined_loop=True, ondevice_finish=True,
                          decode_slot_batching=True, chain_under_prefill=8)}
    rec = Recording()
    times = {(on, part): [] for on in (True, False)
             for part in ("build", "run")}
    for i in range(rounds + 1):
        on = i % 2 == 0
        rec.set(on)
        for flags in kinds.values():
            t0 = time.perf_counter()
            ec = EngineConfig(dtype="float32", seed=0, max_model_len=512,
                              scheduler=SchedulerConfig(max_prefill_tokens=64),
                              cache=CacheConfig(num_pages=128), **flags)
            llm = LLM(model_cfg=cfg, config=ec, params=params, device="cpu")
            t1 = time.perf_counter()
            for seq in [llm._allocate_seq(p, sp) for p in prompts]:
                llm.add_seq(seq)
            while llm.has_unfinished:
                llm.step()
            if i:       # the first round warms the process
                times[on, "build"].append(t1 - t0)
                times[on, "run"].append(time.perf_counter() - t1)
    rec.set(True)
    print(json.dumps({
        f"{'on' if on else 'off'}_{part}_ms_median":
            round(statistics.median(v) * 1e3, 3)
        for (on, part), v in times.items()} | {"engines_each": len(
            times[True, "run"])}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args()
    if args.cpu:
        cpu(args.rounds or 6)
    else:
        card(args.rounds or 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
