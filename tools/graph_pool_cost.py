#!/usr/bin/env python3
"""How much of the graphs' memory pools does each key that
``ModelRunner.warmup`` captures hold, against what
``ModelRunner.activation_headroom`` keeps free for them? Builds
Llama-3.2-1B at full width (dummy bf16 weights; or DeepSeek-V2-Lite at
full width with its depth cut to ``--layers``) under the OpenAI server's
defaults and the flags of one of the smoke's HTTP servers (``full``:
bench.py's full profile, fused speculation with 4 drafts over chains of
32; ``absorb``: blocks of 16, no speculation) or none (``sync``: the
sync loop, no block), and captures the keys of
``warmup`` one at a time: first the mixed step of the warmup's mixed pass
(a full prefill chunk and nseq - 1 decode rows, at the unified step's one
token bucket) at the smallest sequence bucket, greedy and sampled, into
the empty pool (what the mixed steps' own transients take), then the
largest sequence bucket first: the single decode step greedy and
sampled, the longest block (a spec block under speculation) greedy and
sampled, then the mixed step greedy and sampled. Then the extras keys,
which serving captures at first sight: at the largest sequence bucket a
decode step with every adjustment and logprobs, greedy and sampled, and
a mixed step that adds prompt logprobs. After each it reads the bytes
each pool holds (the graphs' pool, the IF-node bodies' pool). The
summary puts the mixed keys' growth beside ``mixed_pool_bytes``, the
extras keys' beside ``extras_pool_bytes`` (the headroom's reckonings of
them), the growth the mixed keys added first, and the copies of a
[rows, vocab] float32 tensor each pool holds.

    python3 tools/graph_pool_cost.py [--profile full|absorb|sync]
        [--rows 256,128,64,32,16,8] [--model llama|deepseek] [--layers 4]

Needs one CUDA card; prints one JSON line per key and a summary line.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from gllm_tpu_torch import LLM  # noqa: E402
from gllm_tpu_torch.entrypoints.api_server import (  # noqa: E402
    build_engine_config, make_parser)
from gllm_tpu_torch.runner.runner import (  # noqa: E402
    ACTIVATION_HEADROOM, GRAPH_POOL_MIXED_ROWS)

MiB = 2 ** 20


def pools_mib(graphs) -> dict:
    """MiB each of the runner's graph pools holds."""
    names = {graphs.pool: "graphs", graphs.cond_pool: "bodies"}
    out = dict.fromkeys(("graphs", "bodies"), 0.0)
    for seg in torch.cuda.memory_snapshot():
        name = names.get(tuple(seg.get("segment_pool_id", ())))
        if name is not None:
            out[name] += seg["total_size"] / MiB
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", choices=("full", "absorb", "sync"),
                    default="full")
    ap.add_argument("--rows", default="256,128,64,32,16,8")
    ap.add_argument("--model", choices=("llama", "deepseek"),
                    default="llama")
    ap.add_argument("--layers", type=int, default=4,
                    help="DeepSeek's depth (the transients are a layer's)")
    args = ap.parse_args()
    flags = {"full": smoke.HTTP_SERVERS["full profile"],
             "absorb": smoke.HTTP_SERVERS["absorb"], "sync": ()}[args.profile]
    config = build_engine_config(make_parser().parse_args(
        ["--model", "unused", "--load-format", "dummy", "--dtype",
         "bfloat16", *flags]))
    model = (smoke.llama_3_2_1b() if args.model == "llama" else
             smoke.deepseek_v2_lite(num_hidden_layers=args.layers))
    llm = LLM(model_cfg=model, config=config)
    runner = llm.runner
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    spec = config.spec_fused
    rows = runner.builder.max_seqs
    k1 = 1 + config.spec_k if config.spec_decode else 1
    # the headroom's graph part: [rows * k1, vocab] float32 copies over
    # the pools (activation_headroom, graph_pool_copies)
    per_copy = rows * k1 * llm.model_cfg.vocab_size * 4 / MiB
    npages = runner.builder.max_pages_per_seq
    K = runner.block_len
    block = runner._warm_spec_block if spec else runner._warm_block
    runner._warming = True          # throwaway rows: no page or slot queues
    before = pools_mib(runner.graphs)
    rows_list = [int(r) for r in args.rows.split(",")]
    # the mixed steps' own transients: their keys at the smallest bucket
    # captured first, into an empty pool (the sampling transients of a
    # few rows are small beside the forward's at the token bucket)
    for temp in (0.0, 1.0):
        runner._warm_mixed(min(rows_list), npages, temp)
    torch.cuda.synchronize()
    now = pools_mib(runner.graphs)
    alone_mib = now["graphs"] - before["graphs"]
    print(json.dumps({
        "profile": args.profile, "model": args.model, "key": "mixed first",
        "rows": min(rows_list), "pages": npages,
        "tokens": runner.builder.max_tokens, "graphs_mib": now["graphs"],
        "graphs_growth_mib": alone_mib}), flush=True)
    before = now
    mixed_mib = 0.0
    for nseq in rows_list:
        blocks = ((("spec block" if spec else "block", 0.0),
                   ("spec block" if spec else "block", 1.0)) if K > 1
                  else ())
        for kind, temp in (("single", 0.0), ("single", 1.0), *blocks,
                           ("mixed", 0.0), ("mixed", 1.0)):
            if kind == "single":
                runner._warm_step(nseq, npages, temp)
            elif kind == "mixed":
                runner._warm_mixed(nseq, npages, temp)
            else:
                block(nseq, npages, K, temp)
            torch.cuda.synchronize()
            now = pools_mib(runner.graphs)
            if kind == "mixed":
                mixed_mib += now["graphs"] - before["graphs"]
            print(json.dumps({
                "profile": args.profile, "model": args.model, "key": kind,
                "rows": nseq, "sampled": temp > 0, "pages": npages,
                "tokens": runner.builder.max_tokens if kind == "mixed"
                else nseq,
                "K": 1 if kind in ("single", "mixed") else K,
                "graphs_mib": now["graphs"],
                "graphs_growth_mib": now["graphs"] - before["graphs"],
                "bodies_mib": now["bodies"],
                "bodies_growth_mib": now["bodies"] - before["bodies"]}),
                flush=True)
            before = now
    # the extras keys (adjust and lp; a mixed one with plp too) at the
    # largest sequence bucket, captured after the plain ones
    extras = dict(repetition_penalty=1.2, presence_penalty=0.3,
                  logit_bias={5: 1.0}, logprobs=5)
    extras_mib = 0.0
    for kind, temp in (("single", 0.0), ("single", 1.0), ("mixed", 1.0)):
        if kind == "single":
            runner._warm_step(rows_list[0], npages, temp, **extras)
        else:
            runner._warm_mixed(rows_list[0], npages, temp,
                               prompt_logprobs=2, **extras)
        torch.cuda.synchronize()
        now = pools_mib(runner.graphs)
        grown = sum(now.values()) - sum(before.values())
        extras_mib += grown
        print(json.dumps({
            "profile": args.profile, "model": args.model,
            "key": kind + " extras", "rows": rows_list[0],
            "sampled": temp > 0, "pages": npages,
            "graphs_mib": now["graphs"],
            "graphs_growth_mib": now["graphs"] - before["graphs"],
            "bodies_mib": now["bodies"],
            "bodies_growth_mib": now["bodies"] - before["bodies"]}),
            flush=True)
        before = now
    print(json.dumps({
        "profile": args.profile, "model": args.model, "card": smi,
        "kv_pages": runner.num_pages,
        "mixed_first_mib": alone_mib,
        "mixed_growth_mib": mixed_mib,
        "mixed_reckoned_mib": runner.mixed_pool_bytes() / MiB,
        "mixed_rows": GRAPH_POOL_MIXED_ROWS,
        "extras_growth_mib": extras_mib,
        "extras_reckoned_mib": runner.extras_pool_bytes() / MiB,
        "graphs": len(runner.graphs), "pools_mib": before,
        "pools_total_mib": sum(before.values()),
        "headroom_graph_part_mib": runner.graph_pool_copies() * per_copy,
        "headroom_beyond_activations_mib": (
            runner.activation_headroom() - ACTIVATION_HEADROOM) / MiB,
        "headroom_mib": runner.activation_headroom() / MiB,
        "logit_rows": rows * k1, "copies": runner.graph_pool_copies(),
        "measured_copies": {name: mib / per_copy
                            for name, mib in before.items()}}), flush=True)


if __name__ == "__main__":
    main()
