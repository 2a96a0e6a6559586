#!/usr/bin/env python3
"""What does a decode block, a decode step or a mixed step cost a short
context when it runs at the largest page bucket instead of the one its
context needs? Builds
Llama-3.2-1B at full width (dummy bf16 weights) under the smoke's absorb
flags (the unified step under overlap, persistent slots, blocks of 16
under on-device finish) and times, for each row count at each context, a
block of 16 sub-steps, a single decode step and a mixed step (the rows
less one decoding, then a ``--chunk``-token prompt chunk, at the unified
step's one token bucket, as an absorb is) at the page bucket the
context needs and at the pinned largest bucket (``max_model_len`` over
the 16-token page: 256 pages at the default 4096 tokens, 128 at
bench.py's 2048)
(``BatchBuilder.pin_pages``): the wall of a dispatch and its collect, the
median of 20 after one warm-up (the graph's capture), in the order
needed, pinned, pinned, needed. The throwaway rows' pages are all the
dummy page 0, as ``ModelRunner.warmup``'s are: the attention reads the
same number of pages as real rows would.

    python3 tools/block_bucket_cost.py [--rows 8,16,64,128,256]
        [--contexts 300,1000] [--max-model-len 4096] [--chunk 512]

Needs one CUDA card; prints one JSON line per shape.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gllm_tpu_torch import (EngineConfig, LLM, ModelConfig,  # noqa: E402
                            SamplingParams)
from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq  # noqa
from gllm_tpu_torch.sequence import Sequence  # noqa: E402
from gllm_tpu_torch.utils import bucket_size, cdiv  # noqa: E402

K = 16
REPS = 20


def engine(max_model_len):
    cfg = ModelConfig(architecture="LlamaForCausalLM", vocab_size=128256,
                      hidden_size=2048, num_layers=16, num_heads=32,
                      num_kv_heads=8, head_dim=64, intermediate_size=8192,
                      max_position=4096, rope_theta=500000.0,
                      tie_word_embeddings=True)
    return LLM(model_cfg=cfg, config=EngineConfig(
        load_format="dummy", dtype="bfloat16", max_model_len=max_model_len,
        pipelined_loop=True,
        unified_step=True, decode_slot_batching=True, ondevice_finish=True))


def timed(fn):
    fn()                      # the capture
    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[REPS // 2] * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="8,16,64,128,256")
    ap.add_argument("--contexts", default="300,1000")
    ap.add_argument("--max-model-len", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=512)
    args = ap.parse_args()
    llm = engine(args.max_model_len)
    runner = llm.runner
    b = runner.builder
    page = llm.config.cache.page_size
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    runner._warming = True          # throwaway rows: no page or slot queues
    for nseq in [int(r) for r in args.rows.split(",")]:
        for ctx in [int(c) for c in args.contexts.split(",")]:
            needed = bucket_size(cdiv(ctx + K, page), 4, b.max_pages_per_seq)
            seqs = runner._warm_seqs(nseq, needed, ctx, 0.0, K + 1)

            def block():
                runner.collect(runner.step_multi([ScheduledBatch(
                    [ScheduledSeq(s, 1, ctx + j) for s in seqs])
                    for j in range(K)]))

            def single():
                runner.collect(runner.step_async(ScheduledBatch(
                    [ScheduledSeq(s, 1, ctx) for s in seqs])))

            # a prompt chunk after the decode rows (the decode prefix
            # first, as an absorb orders them), its pages the dummy page 0
            chunk = Sequence(nseq, [1] * args.chunk,
                             SamplingParams(temperature=0.0, max_tokens=4))
            chunk.page_table = [0] * cdiv(args.chunk, page)

            def mixed():
                runner.collect(runner.step_async(ScheduledBatch(
                    [ScheduledSeq(s, 1, ctx) for s in seqs[:nseq - 1]]
                    + [ScheduledSeq(chunk, args.chunk, 0)])))
            out = {"rows": nseq, "context": ctx, "pages_needed": needed,
                   "pages_pinned": b.max_pages_per_seq, "K": K,
                   "chunk": args.chunk,
                   "mixed_pages_needed": bucket_size(
                       max(needed, cdiv(args.chunk, page)), 4,
                       b.max_pages_per_seq),
                   "card": smi}
            for name, fn in (("block", block), ("single", single),
                             ("mixed", mixed)):
                ms = {}
                for pinned in (False, True, True, False):
                    b.pin_pages = pinned
                    ms.setdefault(pinned, []).append(timed(fn))
                out[f"{name}_ms_needed"] = ms[False]
                out[f"{name}_ms_pinned"] = ms[True]
            b.pin_pages = True
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
