#!/usr/bin/env python3
"""Which loops give which greedy streams on the card, by cache dtype.

    python3 tools/overlap_streams_diag.py

The tiny float32 Llama of tests/test_torch_cuda.py (two layers, 16-token
pages) serves tests/test_torch_cuda.py's staggered twelve-request
workload: first an int8 cache on the CPU (plain versions) and on the card,
then, for an int8, an fp8 and a full-precision cache, the card's sync loop
against overlap scheduling and the pipelined loop at depths 1, 2 and 3,
each also with its CUDA graphs dropped (every step eager). Prints whether
each run's streams equal the sync loop's, which requests differ, and the
dispatches by (step kind, entries in flight). Needs a CUDA card.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import test_torch_cuda as T  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("overlap_streams_diag: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sync = T._tiny_engine(dev, kv_cache_dtype="int8")
    params = sync.runner.params
    cpu = T._tiny_engine("cpu", kv_cache_dtype="int8", params={
        g: ({k: v.cpu() for k, v in x.items()} if isinstance(x, dict)
            else x.cpu()) for g, x in params.items()})
    print("int8: card sync loop == CPU sync loop:",
          T._serve_greedy(sync) == T._serve_greedy(cpu), flush=True)
    for kv in ("int8", "fp8", "auto"):
        ref = T._serve_greedy(T._tiny_engine(dev, params=params,
                                             kv_cache_dtype=kv))
        for flags in (dict(overlap_scheduling=True),
                      dict(pipelined_loop=True)):
            for depth in (1, 2, 3):
                for graphs in (True, False):
                    llm = T._tiny_engine(dev, params=params,
                                         kv_cache_dtype=kv,
                                         overlap_depth=depth, **flags)
                    if not graphs:
                        llm.runner.graphs = None
                    got = T._serve_greedy(llm)
                    differ = [i for i, (a, b) in enumerate(zip(got, ref))
                              if a != b]
                    print(f"{kv} {flags} depth {depth} graphs {graphs}: "
                          f"equal to the sync loop {got == ref}, requests "
                          f"differing {differ}, dispatches "
                          f"{dict(llm.dispatches)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
