#!/usr/bin/env python3
"""Does a garbage collection inside a CUDA graph capture, one that frees an
engine left in a reference cycle, break the capture? Builds and serves a
small engine (tests/test_torch_cuda.py's ``_tiny_engine``, bf16) so that it
holds decode graphs, drops it in a reference cycle with automatic
collection held off, then builds a second engine and serves it while a
collection is forced at the start of every capture wherever the collector
is on. Run twice: as the port captures (the collector off for the
capture: the second engine captures and serves), and with that turned
off (``gc.disable`` made a no-op: the capture fails).

    python3 tools/capture_gc_probe.py

Needs one CUDA card.
"""

import gc
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import test_torch_cuda as t  # noqa: E402


def run(collector_left_on: bool) -> str:
    dev = torch.device("cuda")
    old = t._tiny_engine(dev, dtype="bfloat16")
    t._serve_greedy(old)
    enter = torch.cuda.graphs.graph.__enter__

    def enter_and_collect(self):
        out = enter(self)
        if gc.isenabled():
            gc.collect()
        return out
    torch.cuda.graphs.graph.__enter__ = enter_and_collect
    disable = gc.disable
    if collector_left_on:
        gc.disable = lambda: None
    thresholds = gc.get_threshold()
    gc.set_threshold(0)
    try:
        old.cycle = old
        del old
        new = t._tiny_engine(dev, dtype="bfloat16")
        t._serve_greedy(new)
        return "captured and served"
    except Exception as e:  # noqa: BLE001 — the outcome is the report
        return f"{type(e).__name__}: {str(e)[:300]}"
    finally:
        gc.set_threshold(*thresholds)
        gc.disable = disable
        torch.cuda.graphs.graph.__enter__ = enter


if __name__ == "__main__":
    print("collector off in capture:", run(False), flush=True)
    # last: a failed capture may leave the CUDA context unusable
    print("collector left on:", run(True), flush=True)
