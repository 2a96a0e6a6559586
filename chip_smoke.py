#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gllm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--memory-history]

(``--memory-history``: the allocator records each allocation's Python
stack, and each memory line names what holds the segments with the most
stranded space.) Phases, in order; any failure ends the run with a
non-zero exit code and no result line:

1. device    torch / CUDA / nvcc versions, the card's name and power limit
2. build     nvcc builds every kernel from gllm_tpu_torch/csrc into
             build/gllm_tpu_torch/ (ptxas register and shared-memory lines)
3. kernels   each kernel against its plain PyTorch version at the serving
             path's shapes (Llama-3.2-1B attention: Hq 32, Hkv 8, D 64,
             page 16, bf16 q; a bf16, int8 or fp8 cache), with the device
             time (profiler) of the kernel, the plain version and one
             PyTorch library call (over the cache widened to bf16 before
             the timed region for a one-byte cache), the kernel wrapper's
             CUDA-event time, and the card's bound: ragged (K1), decode
             (K2), their int8 (K1q, K2q) and fp8 modes, and the unified
             kernel (K1u) over each cache (the mixed rows also beside one
             varlen flash call over the real tokens, and split by launch:
             decode class, ragged class), and K1 at a GQA group of 7 (Hq 28,
             Hkv 4, D 128) on the mixed lengths; then the MLA modes at
             DeepSeek-V2-Lite's latent geometry (Hq 16 over one 576-wide
             latent row, values its leading 512, bf16 q) on the same batch
             lengths: ragged (K1m), decode (K2m) and the unified step's
             kernel (K1um, the mixed batch and the decode rows as one-token
             rows), over a bf16 and an fp8 latent; then Qwen3-Next's: K1
             and K2 at head_dim 256 (Hq 16, Hkv 2) over a bf16 and an fp8
             cache on the same lengths, and the gated-delta-rule chunk scan
             (K3, float32 accuracy on the tensor cores: 3xTF32) at the
             hybrid mixed step's layout (K1's
             lengths padded to [27 rows, 1024], 32 heads, Dk = Dv = 128,
             chunks of 64), with the GDN layer's peak memory at that shape;
             K2 (D 64 over each cache, D 256), K2m (over each latent) and
             the decode classes of K1u (over a bf16 and an fp8 cache) and
             K1um (over each latent) also on the decode batch with every
             fourth row a hole row of a persistent-slot chain (context one
             token in the dummy page 0), at the same tolerances
4. serve     LLM.generate at the full Llama-3.2-1B width (dummy bf16
             weights from a seed) for 16 greedy requests, in six
             configurations: the bf16 sync loop, an int8 KV cache, the
             unified step, the unified step over an int8 cache, an fp8 KV
             cache and the unified step over an fp8 cache; then
             DeepSeek-V2-Lite at full width (27 layers, 64 experts, latent
             512 + 64) after the Llama engines are freed: the legacy step
             and the unified step, over an fp8 latent and both, the later
             engines on the first one's weights; then Qwen3-Next-80B-A3B at
             full width, depth cut to 12 layers (9 GDN, 3 gated full
             attention; 512 experts, top-10), then over an fp8 cache on the
             same weights, after DeepSeek is freed. Every engine replays
             its pure-decode steps as CUDA graphs (enforce_eager off, the
             default): llm.runner.warmup() captures JAX's bucket combos
             first (graphs, seconds and pool MiB printed), and each decode
             step must be one replay. The bf16, unified, DeepSeek (both
             steps) and Qwen3-Next configurations also serve an eager twin
             (enforce_eager) on the same weights, runs in the order eager,
             graph, graph, eager, both medians and their ratio printed, and
             the twins' greedy streams must be identical (else the first
             differing token and the eager logits there are printed, and
             the run fails); the others run once. The bf16, DeepSeek and
             Qwen3-Next configurations also serve an overlap twin (the
             pipelined loop at overlap depth 2, its graphs warmed) on the
             same weights, runs eager, graph, overlap, overlap, graph,
             eager: its greedy streams must equal the sync graph engine's,
             both medians and their ratio are printed, with the decode
             entries dispatched while another was in flight (most must
             be), the largest in-flight count, chain breaks and stalls by
             reason, rebuilds and divergences, and no page or slot may
             leak (the hybrid twin chains and never re-forms). The bf16
             and DeepSeek configurations also serve a multi twin (blocks
             of decode steps: the pipelined loop at depth 2 with on-device
             finish, chains of 16, each block one CUDA graph whose
             sub-steps after the first sit in conditional nodes), runs
             eager, graph, overlap, multi, multi, overlap, graph, eager:
             its medians and ratios, decode dispatches and decoded
             sub-steps a run, blocks by K, dead row-sub-steps; its
             streams are held to its own batches (a block's links at the
             block's signature) run one at a time through the sync
             engine; the DeepSeek twin then serves a stop-token run
             (each request stops at a token of its greedy stream at about
             half its output; the dummy Llama's stream repeats one
             token), whose streams must be the sync engine's (or, where
             bf16 batches part them, its own batches replayed) and some
             block of which must stop early. The bf16, DeepSeek and
             Qwen3-Next configurations also serve a slot twin (persistent
             slots with chains of 16 decode steps under waiting prefill:
             the multi twin's flags, the overlap twin's for Qwen3-Next),
             runs eager, graph, overlap, multi, slot, slot, multi,
             overlap, graph, eager: its medians and ratios, decoded
             sub-steps a run, joins, hole row-sub-steps and compactions a
             run, breaks by reason (none for a finish), its streams held
             to its own batches replayed (hole rows dead in their
             places); the DeepSeek slot twin serves the stop-token run
             too. The unified Llama and DeepSeek configurations serve an
             absorb twin (the unified step under overlap: the slot twin's
             flags without chain_under_prefill, a chain absorbing waiting
             prefill through mixed re-forms), runs eager, graph, absorb,
             absorb, graph, eager: the same numbers as the slot twin's,
             absorbs and mixed entries dispatched ahead a run, no
             "waiting" break, its streams held to its own batches
             replayed through the unified sync engine. The bf16 and
             unified Llama configurations then serve the staggered-arrival
             run (the 16 requests, 4 at start and 2 more each time
             another 64 output tokens commit) by the sync graph engine
             and the slot or absorb twin, runs graph, twin, twin, graph:
             medians and ratio, sub-steps, breaks by reason and absorbs a
             run, the twin's batches replayed; the absorb twin must absorb
             there. Every twin has 2048 KV pages and must not preempt, and
             one that does not fit beside the primary engine raises by
             name. Each engine's construction logs the memory it was
             sized from (free, and stranded in partly used segments) and
             the card's memory by allocator pool and outside it, as does
             each model's release of its engines. Every engine with
             graphs: one replay per decode dispatch (a single step or a
             block), and a block's executed sub-steps launch the decode
             kernels too.
             Each must launch exactly its kernels and no plain version,
             replays counted (DeepSeek: K1m on every layer of every mixed
             step, K2m on every layer of every decode step, K1um on every
             layer of every step under the unified step; Qwen3-Next: K3 on
             every GDN layer and K1 at D 256 on every full layer of every
             mixed step, K2 at D 256 on every full layer of every decode
             step; the fp8 configurations the same kernels' fp8 modes), and
             leave the decode kernels' split counters at zero; each fp8
             configuration's KV pages beside its full-precision twin's; a
             profiled window of the graph engine of the bf16 (and of its
             eager, overlap, multi and slot twins: host launch calls per
             decoded
             sub-step beside per dispatch), unified-int8, DeepSeek (both steps)
             and Qwen3-Next configurations, and of the unified Llama
             graph engine and absorb twin under staggered arrivals (2 at
             start, 2 more each 16 output tokens): device time by kernel, busy
             share, kernels per step, host launch calls per dispatched
             decode entry, the dispatches' share of the wall by kind and
             the share spent waiting in collect
5. reference depth cut to 2 layers (4 for the hybrid period), float32:
             the port on the card
             (kernels, decode steps as CUDA graphs) against the port on the
             CPU (plain versions) — first-step logits and greedy tokens —
             with a bf16-width float32 cache, an int8 cache, the unified
             step and an fp8 cache, a DeepSeek model (one dense layer, one
             MoE layer) at the MLA kernels' small latent geometry (64 +
             32), also under the unified step and over an fp8 latent, and a
             hybrid model of one Qwen3-Next period (3 GDN + 1 full layer;
             GDN Dk = Dv = 32, head_dim 128, two experts and a shared one),
             also over an fp8 cache; the float32, unified, both DeepSeek
             and the hybrid cases also run an eager engine on the card,
             and the float32, DeepSeek and hybrid cases an overlap engine
             (the pipelined loop), the float32 and DeepSeek cases a multi
             engine (blocks under on-device finish) and a slot engine
             (the same with persistent slots), whose tokens must be the
             same
6. http      the port's OpenAI server as users start it (``python -m
             gllm_tpu_torch.entrypoints.api_server``), a process of its
             own: Llama-3.2-1B at full width (config.json written under
             build/http_model, dummy bf16 weights from seed 0) under the
             absorb twin's flags (the unified step under overlap,
             persistent slots, blocks of 16 under on-device finish),
             driven by benchmarks/backend_request_func.run_requests: 32
             streamed greedy requests (the serve phase's 16 prompts
             twice) at concurrency 16 with Poisson arrivals at 8 req/s,
             in passes until one captures no CUDA graph (at most
             HTTP_PASSES; the server's warmup leaves out block keys that
             this traffic meets, and each is captured, stalling every
             stream, the first time it is met), each pass labelled with
             the graphs it captured, then one whole request, one of
             n = 2 and one stream closed after 4 chunks; every request
             finishes with its count,
             /metrics agrees with the client (finishes by reason, 1
             abort, TTFTs), the gauges and KV use read 0 afterwards, K1u
             is the only kernel the run launched (/server_info), and the
             server exits on SIGTERM; TTFT, TPOT and ITL at p50 / p99
             from the client and from the server's histograms, output
             tok/s beside the serve phase's absorb twin, absorbs and
             chain breaks, for every pass
7. a {"kernels": [...]} line, then the last line
             {"ok": true, "device": {...}}

It imports nothing of jax or the JAX package.
"""

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# the card's name and power limit (nvidia-smi), set by main()
SMI = ""
FP8 = torch.float8_e4m3fn
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the dense bf16 and TF32
# tensor rates. K3 computes its float32 products on the tensor cores as
# 3xTF32 (each operand split into two TF32 halves; hi.hi + hi.lo + lo.hi),
# the least work that keeps float32 accuracy there, so its operations
# bound counts every float32 product three times at the TF32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# bf16 outputs, kernel vs plain, as allclose(rtol, atol), per kernel. Both
# sum in f32 and round the output to bf16 (one step is 2e-3 at |out| in
# [0.25, 0.5)). The kernels with tensor-core blocks (ragged, and the
# unified kernel's ragged blocks) also feed the tensor cores bf16
# probabilities (times the value scales over an int8 cache), and the
# first rows of a fresh chunk see a few keys only, so |out| reaches 2..4,
# where one bf16 step is 0.0156: hence their rtol. The decode kernels and
# the unified kernel on a pure-decode batch stay in float32 throughout.
DECODE_TOL = (1e-2, 2e-3)
RAGGED_TOL = (2e-2, 3e-3)
# The MLA kernels (K1m, K2m) both feed bf16 probabilities to the tensor
# cores too, and at DeepSeek's softmax scale over a 576-wide row the
# scores are peaky (std ~2.8): several keys hold probabilities of 0.1..0.5,
# each rounded by up to 2^-9 of itself, against values |v| <= 4, so an
# output of any size may move by up to 2^-9 * 4 ~ 0.008: hence their atol.
MLA_TOL = (2e-2, 8e-3)
# K3: float32 accuracy on both sides (the kernel's products are 3xTF32),
# sums over Dk = 128 and C = 64 terms in another order, carried through 16
# chained chunks (|out| up to about 10): a few float32 ulps a term, far
# inside 1e-3. One chunk's state update left out moves the outputs of every
# later chunk by O(|v|).
GDN_TOL = (1e-3, 1e-3)
TOL = {"paged_decode_attention": DECODE_TOL,
       "paged_decode_attention_int8": DECODE_TOL,
       "ragged_paged_attention": RAGGED_TOL,
       "ragged_paged_attention_int8": RAGGED_TOL,
       "ragged_paged_attention_unified_decode": DECODE_TOL,
       "ragged_paged_attention_unified": RAGGED_TOL,
       "ragged_paged_attention_unified_int8": RAGGED_TOL,
       "ragged_paged_attention_mla": MLA_TOL,
       "paged_decode_attention_mla": MLA_TOL,
       # at head_dim 256 the scores q.k / 16 have the spread they have at
       # D 64 (standard normal q and k), so K1's and K2's reasons hold
       "ragged_paged_attention_d256": RAGGED_TOL,
       # a GQA group of 7 at D 128: the same softmax and rounding as K1
       "ragged_paged_attention_g7": RAGGED_TOL,
       "paged_decode_attention_d256": DECODE_TOL,
       "gdn_chunk_scan": GDN_TOL,
       # K1um: K1m's ragged blocks and K2m's decode blocks, whose reasons
       # hold (bf16 probabilities into the tensor cores in both)
       "ragged_paged_attention_unified_mla": MLA_TOL,
       "ragged_paged_attention_unified_mla_decode": MLA_TOL}
# fp8 modes: widening e4m3 is exact, and both sides read the same fp8
# bytes, so each keeps its full-precision twin's tolerance
FP8_TWINS = {
    "paged_decode_attention_fp8": "paged_decode_attention",
    "ragged_paged_attention_fp8": "ragged_paged_attention",
    "ragged_paged_attention_unified_fp8_decode":
        "ragged_paged_attention_unified_decode",
    "ragged_paged_attention_unified_fp8": "ragged_paged_attention_unified",
    "paged_decode_attention_mla_fp8": "paged_decode_attention_mla",
    "ragged_paged_attention_mla_fp8": "ragged_paged_attention_mla",
    "ragged_paged_attention_unified_mla_fp8":
        "ragged_paged_attention_unified_mla",
    "ragged_paged_attention_unified_mla_fp8_decode":
        "ragged_paged_attention_unified_mla_decode",
    "paged_decode_attention_d256_fp8": "paged_decode_attention_d256",
    "ragged_paged_attention_d256_fp8": "ragged_paged_attention_d256"}
TOL.update({name: TOL[twin] for name, twin in FP8_TWINS.items()})
# kernels-line entry → (launch counter, serve configuration it runs in,
# source, the TPU kernel it replaces)
PALLAS = "gllm_tpu/ops/pallas/"
KERNELS = {
    "ragged_paged_attention": (
        "ragged_paged_attention", "bf16", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429"),
    "paged_decode_attention": (
        "paged_decode_attention", "bf16", "decode_attention.cu",
        PALLAS + "decode_attention.py:188"),
    "ragged_paged_attention_int8": (
        "ragged_paged_attention_int8", "int8", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (k_scale/v_scale; dequant "
        "paged_kv.py:107)"),
    "paged_decode_attention_int8": (
        "paged_decode_attention_int8", "int8", "decode_attention.cu",
        PALLAS + "decode_attention.py:188 (k_scale/v_scale)"),
    "ragged_paged_attention_unified_decode": (
        "ragged_paged_attention_unified", "unified", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True)"),
    "ragged_paged_attention_unified": (
        "ragged_paged_attention_unified", "unified", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True)"),
    "ragged_paged_attention_unified_int8": (
        "ragged_paged_attention_unified_int8", "unified_int8",
        "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, k_scale/v_scale)"),
    "ragged_paged_attention_mla": (
        "ragged_paged_attention_mla", "deepseek", "mla_ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (v_cache=None, v_dim)"),
    "paged_decode_attention_mla": (
        "paged_decode_attention_mla", "deepseek", "mla_decode_attention.cu",
        PALLAS + "decode_attention.py:188 (v_cache=None, v_dim)"),
    "ragged_paged_attention_d256": (
        "ragged_paged_attention", "qwen3_next", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (head_dim 256)"),
    "paged_decode_attention_d256": (
        "paged_decode_attention", "qwen3_next", "decode_attention.cu",
        PALLAS + "decode_attention.py:188 (head_dim 256)"),
    "gdn_chunk_scan": (
        "gdn_chunk_scan", "qwen3_next", "gdn_scan.cu",
        PALLAS + "gdn_scan.py:64"),
    "ragged_paged_attention_unified_mla_decode": (
        "ragged_paged_attention_unified_mla", "deepseek_unified",
        "mla_unified_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, v_cache=None)"),
    "ragged_paged_attention_unified_mla": (
        "ragged_paged_attention_unified_mla", "deepseek_unified",
        "mla_unified_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, v_cache=None)"),
    "paged_decode_attention_fp8": (
        "paged_decode_attention_fp8", "fp8", "decode_attention.cu",
        PALLAS + "decode_attention.py:188 (fp8 cache; widened "
        "paged_kv.py:154-161)"),
    "ragged_paged_attention_fp8": (
        "ragged_paged_attention_fp8", "fp8", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (fp8 cache)"),
    "ragged_paged_attention_unified_fp8_decode": (
        "ragged_paged_attention_unified_fp8", "unified_fp8",
        "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, fp8 cache)"),
    "ragged_paged_attention_unified_fp8": (
        "ragged_paged_attention_unified_fp8", "unified_fp8",
        "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, fp8 cache)"),
    "paged_decode_attention_mla_fp8": (
        "paged_decode_attention_mla_fp8", "deepseek_fp8",
        "mla_decode_attention.cu",
        PALLAS + "decode_attention.py:188 (v_cache=None, fp8 latent)"),
    "ragged_paged_attention_mla_fp8": (
        "ragged_paged_attention_mla_fp8", "deepseek_fp8",
        "mla_ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (v_cache=None, fp8 latent)"),
    "ragged_paged_attention_unified_mla_fp8": (
        "ragged_paged_attention_unified_mla_fp8", "deepseek_unified_fp8",
        "mla_unified_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, v_cache=None, fp8 "
        "latent)"),
    "ragged_paged_attention_unified_mla_fp8_decode": (
        "ragged_paged_attention_unified_mla_fp8", "deepseek_unified_fp8",
        "mla_unified_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, v_cache=None, fp8 "
        "latent)"),
    "paged_decode_attention_d256_fp8": (
        "paged_decode_attention_fp8", "qwen3_next_fp8", "decode_attention.cu",
        PALLAS + "decode_attention.py:188 (head_dim 256, fp8 cache)"),
    "ragged_paged_attention_d256_fp8": (
        "ragged_paged_attention_fp8", "qwen3_next_fp8", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (head_dim 256, fp8 cache)"),
    # no served configuration has a group of 7: its launches are those of
    # the same kernel (K1, bf16) in the bf16 serve configuration
    "ragged_paged_attention_g7": (
        "ragged_paged_attention", "bf16", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (GQA group 7, head_dim 128)"),
}


def log(*args):
    print(*args, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def device_split(fn, iters, warmup=2, tries=3):
    """Device time per call of ``fn`` by kernel, in ms, as torch.profiler
    (CUPTI) reads it, so neither the host's issue time nor the gaps
    between calls count. A profile that saw no device time lost its
    records (seen on the H100 in the first profile of a run, after the
    kernels' build): it is taken again, at most ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                name = e.key.split("(")[0].removeprefix("void ")
                split[name] = split.get(name, 0.0) + (
                    e.self_device_time_total / iters / 1e3)
        if sum(split.values()) > 0:
            return split
        log("[kernels] the profiler saw no device time; profiling again")
    raise SystemExit("[kernels] the profiler saw no device time "
                     f"{tries} times")


def device_ms(fn, iters, warmup=2):
    """Device time per call of ``fn``: the summed time of every kernel it
    launches."""
    return sum(device_split(fn, iters, warmup).values())


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, peak_flops=PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---- 1. device -----------------------------------------------------------

def phase_device():
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    from gllm_tpu_torch.ops.cuda import build
    nvcc = run([build.nvcc_path(), "--version"]).splitlines()[-1]
    log(f"[device] nvcc: {nvcc}")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    log(smi)
    log(f"[device] torch sees {torch.cuda.device_count()} x "
        f"{torch.cuda.get_device_name(0)}")
    return smi


# ---- 2. build ------------------------------------------------------------

def phase_build():
    from gllm_tpu_torch.ops.cuda import build
    t0 = time.monotonic()
    build.build()
    log(f"[build] {time.monotonic() - t0:.1f} s wall (nvcc "
        f"{build.build_seconds:.1f} s, parallel, one per source)")
    # ptxas -v per kernel instance: registers, and the spills, if any
    # (the whole output is in the .log beside each library)
    for name, text in build.build_log.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills, fn = [], "?"
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1).rstrip(":")
            elif re.search(r"[1-9]\d* bytes spill", line):
                spills.append((demangle(fn), line.strip()))
        log(f"[build] {name}: {len(regs)} kernels, {min(regs, default=0)}.."
            f"{max(regs, default=0)} registers, {len(spills)} with spills")
        for fn, line in spills:
            log(f"[build] {name}:   {fn[:110]}: {line}")


def demangle(symbol):
    """A kernel's C++ name from its symbol, with the CUDA toolkit's
    cu++filt beside nvcc (the symbol itself when there is none)."""
    from pathlib import Path
    from gllm_tpu_torch.ops.cuda import build
    tool = Path(build.nvcc_path()).with_name("cu++filt")
    if not tool.exists():
        return symbol
    return run([str(tool), symbol]).removeprefix("void ")


# ---- 3. kernels ----------------------------------------------------------

def _paged(rng, kv_lens, Hkv, D, page, dtype, dev):
    """Random K/V pages for the given contexts, scattered over the pool
    in random order, and the padded page table."""
    n_pages = [-(-int(k) // page) for k in kv_lens]
    P = 1 + sum(n_pages)
    order = rng.permutation(np.arange(1, P)).astype(np.int32)
    pt = np.zeros((len(kv_lens), max(max(n_pages), 1)), np.int32)
    at = 0
    for i, n in enumerate(n_pages):
        pt[i, :n] = order[at:at + n]
        at += n
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kc = torch.randn((P, page, Hkv, D), generator=gen, device=dev).to(dtype)
    vc = torch.randn((P, page, Hkv, D), generator=gen, device=dev).to(dtype)
    return kc, vc, torch.from_numpy(pt).to(dev)


def _randn(shape, dev):
    """A bf16 tensor of standard normal values drawn from the seed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _quantize(cache):
    """An int8 cache and its per-page, per-kv-head scales from a
    full-precision one (the write path's absmax grid), and the
    dequantized bf16 cache the library call reads."""
    x = cache.float()
    scale = (x.abs().amax(dim=(1, 3)) / 127.0).clamp(min=1e-30)
    q8 = torch.round(x / scale[:, None, :, None]).clamp(-127, 127).to(
        torch.int8)
    return q8, scale, (q8.float() * scale[:, None, :, None]).to(cache.dtype)


def _dense_kv(kc, vc, pt, kv_lens, page):
    """K/V gathered into dense per-sequence [S, Hkv, Kmax, D] tensors (for
    the library yardstick)."""
    kmax = max(kv_lens)
    idx = pt[:, :-(-kmax // page)].long()
    S, Hkv, D = len(kv_lens), kc.shape[2], kc.shape[3]
    k = kc[idx].reshape(S, -1, Hkv, D)[:, :kmax].transpose(1, 2)
    v = vc[idx].reshape(S, -1, Hkv, D)[:, :kmax].transpose(1, 2)
    return k.contiguous(), v.contiguous()


def _flat(x):
    """One float32 vector of a tensor or of a tuple of tensors (K3 returns
    its outputs and its final state)."""
    if isinstance(x, tuple):
        return torch.cat([t.float().flatten() for t in x])
    return x.float()


def check(name, out, want, dropped):
    """Kernel output against its plain version at the kernel's tolerance.
    ``dropped`` is the plain version perturbed (the last key of some rows
    left out; for K3 one chunk's state update): the tolerance must reject
    it, or it could not see such a fault."""
    rtol, atol = TOL[name]
    o, w, d = _flat(out), _flat(want), _flat(dropped)
    err = (o - w).abs()
    return dict(
        ok=bool(torch.isfinite(o).all()) and torch.allclose(
            o, w, rtol=rtol, atol=atol),
        max_abs_err=err.max().item(),
        # the largest share of the tolerance that any element uses
        tol_used=(err / (atol + rtol * w.abs())).max().item(),
        drop_rejected=not torch.allclose(d, w, rtol=rtol, atol=atol),
        drop_max_abs=(d - w).abs().max().item())


def hole_check(name, kernel, plain, kvl, pt, every=4):
    """``kernel(kv_lens, page_table)`` against ``plain`` on a decode batch
    whose every ``every``-th row is a hole row of a persistent-slot chain
    (its context one token in the dummy page 0, its page-table row all
    zeros; the split plan still the batch's), at the kernel's tolerance:
    (ok, max_abs_err, hole rows)."""
    kvl, pt = kvl.clone(), pt.clone()
    kvl[::every] = 1
    pt[::every] = 0
    out = kernel(kvl, pt)
    torch.cuda.synchronize()
    want = plain(kvl, pt)
    rtol, atol = TOL[name]
    o, w = out.float(), want.float()
    return dict(ok=bool(torch.isfinite(o).all()) and torch.allclose(
        o, w, rtol=rtol, atol=atol), max_abs_err=(o - w).abs().max().item(),
        rows=len(range(0, kvl.shape[0], every)))


def measure(name, kernel, plain, plain_dropped, library, iters, nbytes,
            flops, peak_flops=PEAK_BF16_FLOPS, varlen=None, **info):
    """Check a kernel against its plain version, then time it: device time
    per call (profiler) of the kernel, the plain version and the library
    call (None where no one PyTorch call computes the function), and of
    ``varlen`` (a second library call over the real tokens only, with its
    output; kept where it agrees with the plain version); and the kernel's
    CUDA-event time per call when its wrapper is called back to back (host
    launch time included)."""
    out = kernel()
    torch.cuda.synchronize()
    want = plain()
    r = check(name, out, want, plain_dropped())
    b_ms, b_by = bound(nbytes, flops, peak_flops)
    split = timed_above_bound(kernel, iters, b_ms)
    lib_split = timed_above_bound(library, 5, b_ms) if library else None
    varlen_ms = None
    if varlen is not None:
        # (the call, its output[, the plain version over the cache the
        # call reads, where that is not the kernel's: an int8 cache's
        # bf16 dequantization])
        fn, got = varlen[:2]
        rtol, atol = TOL[name]
        w = (varlen[2] if len(varlen) > 2 else want)[:got.shape[0]].float()
        err = (got.float() - w).abs().max().item()
        if torch.allclose(got.float(), w, rtol=rtol, atol=atol):
            varlen_ms = sum(timed_above_bound(fn, 5, b_ms).values())
        else:
            log(f"[kernels] {name}: the varlen flash call disagrees with the "
                f"plain version (max_abs {err}); not timed")
    r.update(ms=sum(split.values()), split=split,
             plain_ms=device_ms(plain, 3),
             library_ms=sum(lib_split.values()) if library else None,
             library_backend=sdpa_backend(lib_split) if library else None,
             varlen_library_ms=varlen_ms,
             wrapper_ms=cuda_ms(kernel, iters), bytes=nbytes, flops=flops,
             bound_ms=b_ms, bound_by=b_by, **info)
    return r


def timed_above_bound(fn, iters, bound_ms, tries=3):
    """device_split of ``fn``, measured again while it reads below the
    bound: no call can beat the card's bound for the function, so such a
    reading lost kernel records (seen on the H100: a decode kernel read at
    a seventh of its time, once in a run)."""
    for _ in range(tries):
        split = device_split(fn, iters)
        if sum(split.values()) >= bound_ms:
            return split
        log(f"[kernels] a reading of {sum(split.values())} ms is below the "
            f"bound {bound_ms} ms; measuring again")
    raise SystemExit("[kernels] device time read below the bound "
                     f"{tries} times")


def sdpa_backend(split):
    """The backend scaled_dot_product_attention took, read from the names
    of the kernels it launched."""
    names = " ".join(split).lower()
    for key, backend in (("flash", "flash"), ("cudnn", "cudnn"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in names:
            return backend
    return "math (" + ", ".join(n[:40] for n in list(split)[:3]) + ")"


def decode_shape(rng, dev, Hq=32, Hkv=8, D=64, quant=True):
    """The decode step of the serving path: S 32 rows, contexts 256..2048,
    a bf16 cache and its int8 form. The lengths depend only on ``rng``'s
    state, so a second generator from the same seed gives the MLA shape
    (Hq 16 over one latent row, Hkv 1) the same rows."""
    page = 16
    S = 32
    kv = rng.integers(256, 2049, S)
    kc, vc, pt = _paged(rng, kv, Hkv, D, page, torch.bfloat16, dev)
    q = _randn((S, Hq, D), dev)
    kvl = torch.from_numpy(kv.astype(np.int32)).to(dev)
    return dict(q=q, kc=kc, vc=vc, pt=pt, kvl=kvl, kv=kv.tolist(), page=page,
                quant=_quantize(kc) + _quantize(vc) if quant else None)


def mixed_shape(rng, dev, Hq=32, Hkv=8, D=64, quant=True):
    """A mixed step of the serving path: 24 decode rows + chunks (512 of a
    2048 context, 300 of 812, a fresh 1024), padded to the runner's
    buckets (T 2048, S 32)."""
    page = 16
    seqs = ([(1, int(k)) for k in rng.integers(256, 2049, 24)]
            + [(512, 2048), (300, 812), (1024, 1024)])
    S_real, S_pad, T_pad = len(seqs), 32, 2048
    T_real = sum(ql for ql, _ in seqs)
    kv = [k for _, k in seqs] + [0] * (S_pad - S_real)
    kc, vc, pt = _paged(rng, kv[:S_real], Hkv, D, page, torch.bfloat16, dev)
    pt = torch.cat([pt, torch.zeros((S_pad - S_real, pt.shape[1]),
                                    dtype=pt.dtype, device=dev)])
    cu = np.zeros(S_pad + 1, np.int32)
    cu[1:S_real + 1] = np.cumsum([ql for ql, _ in seqs])
    cu[S_real + 1:] = T_real
    q = _randn((T_pad, Hq, D), dev)
    kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
    # the one-token rows lose their last key (a chunk's rows would shift)
    kvl_drop = kvl - torch.tensor([int(ql == 1) for ql, _ in seqs]
                                  + [0] * (S_pad - S_real),
                                  dtype=torch.int32, device=dev)
    return dict(q=q, kc=kc, vc=vc, pt=pt, kvl=kvl, kvl_drop=kvl_drop,
                cu=torch.from_numpy(cu).to(dev), cu_np=cu, seqs=seqs,
                kv=kv, page=page, T_real=T_real,
                quant=_quantize(kc) + _quantize(vc) if quant else None)


def _decode_library(x, kd, vd, scale):
    """scaled_dot_product_attention of one query row per sequence over
    dense K/V."""
    import torch.nn.functional as F
    mask = (torch.arange(kd.shape[2], device=kd.device)[None, :]
            < x["kvl"][:, None].long())[:, None, None, :]
    qd = x["q"][:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)


def _mixed_library(x, kd, vd, scale):
    """scaled_dot_product_attention of the mixed batch: q padded to
    [S, Hq, max_q, D] with a causal bool mask, over dense K/V."""
    import torch.nn.functional as F
    seqs, cu, q = x["seqs"], x["cu_np"], x["q"]
    dev = q.device
    qmax = max(ql for ql, _ in seqs)
    qd = torch.zeros((len(seqs), q.shape[1], qmax, q.shape[2]), device=dev,
                     dtype=q.dtype)
    mask = torch.zeros((len(seqs), 1, qmax, kd.shape[2]), dtype=torch.bool,
                       device=dev)
    mask[..., 0] = True            # padded rows: one key, no NaN rows
    for i, (ql, k) in enumerate(seqs):
        qd[i, :, :ql] = q[cu[i]:cu[i] + ql].transpose(0, 1)
        pos = k - ql + torch.arange(ql, device=dev)
        mask[i, 0, :ql] = (torch.arange(kd.shape[2], device=dev)[None, :]
                           <= pos[:, None])
    return lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)


# the second library call of the mixed rows
VARLEN_CALL = ("torch.ops.aten._flash_attention_forward (varlen, causal, "
               "GQA) over the real tokens and K/V gathered dense and packed "
               "per sequence")


def _varlen_library(x, kb, vb, scale):
    """One varlen flash call over the mixed batch: the real tokens packed
    [T_real, Hq, D], each sequence's K/V gathered dense and packed, causal
    with the queries at the end of their context. Returns (the call, its
    output), or None, logged, where this torch refuses it. Set-up (the
    gathers) is outside the call."""
    seqs, cu, q, pt, page = x["seqs"], x["cu_np"], x["q"], x["pt"], x["page"]
    dev = q.device
    Hkv, D = kb.shape[2], kb.shape[3]
    ks, vs = [], []
    for i, (_, k) in enumerate(seqs):
        pages = pt[i, :-(-k // page)].long()
        ks.append(kb[pages].reshape(-1, Hkv, D)[:k])
        vs.append(vb[pages].reshape(-1, Hkv, D)[:k])
    kp, vp = torch.cat(ks).contiguous(), torch.cat(vs).contiguous()
    qp = q[:x["T_real"]].contiguous()
    cq = torch.tensor(cu[:len(seqs) + 1], dtype=torch.int32, device=dev)
    ck = torch.tensor(np.cumsum([0] + [k for _, k in seqs]),
                      dtype=torch.int32, device=dev)
    max_q = max(ql for ql, _ in seqs)
    max_k = max(k for _, k in seqs)

    def call():
        return torch.ops.aten._flash_attention_forward(
            qp, kp, vp, cq, ck, max_q, max_k, 0.0, True, False,
            scale=scale)[0]
    try:
        out = call()
        torch.cuda.synchronize()
    except Exception as e:  # the yardstick only: the port never calls it
        log(f"[kernels] varlen flash refused on torch {torch.__version__}: "
            f"{e!r}"[:400])
        return None
    return call, out


def _kv_bytes(kv_lens, page, Hkv, D, cache):
    """Bytes of K and V the contexts need: each key row of each kv head
    once (1 byte a value for an "int8" or "fp8" cache, 2 for "bf16"),
    plus, for int8, the scale row (one float32 per kv head, K and V) of
    every page read."""
    ctx = sum(int(k) for k in kv_lens)
    pages = sum(-(-int(k) // page) for k in kv_lens)
    return ctx * Hkv * 2 * D * (2 if cache == "bf16" else 1) + (
        pages * Hkv * 2 * 4 if cache == "int8" else 0)


# how each cache's library call reads it
LIB_NOTE = {"bf16": "", "int8": " (dequantized to bf16 before the timed "
            "region; the varlen call is held to the plain version over that "
            "cache)",
            "fp8": " (widened to bf16 before the timed region)"}


def _caches(x):
    """The serving path's three caches of a shape: cache → (K, V, the
    wrapper's scale keywords, the bf16 K and V the library call reads)."""
    k8, ks, kdq, v8, vs, vdq = x["quant"]
    kf, vf = x["kc"].to(FP8), x["vc"].to(FP8)
    return {"bf16": (x["kc"], x["vc"], {}, x["kc"], x["vc"]),
            "int8": (k8, v8, dict(k_scale=ks, v_scale=vs), kdq, vdq),
            "fp8": (kf, vf, {}, kf.to(torch.bfloat16),
                    vf.to(torch.bfloat16))}


def phase_kernels():
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    Hq, Hkv, D = 32, 8, 64
    scale = D ** -0.5
    results = {}

    # ---- decode shape: K2 over each cache, and K1u on 32 one-token ragged
    # rows over a bf16 and an fp8 cache
    x = decode_shape(rng, dev)
    q, kvl, pt, kv, page = x["q"], x["kvl"], x["pt"], x["kv"], x["page"]
    S = len(kv)
    caches = _caches(x)
    ctx = sum(kv)
    # q read and out written once (bf16), kv_lens and the pages' ids
    io = 2 * q.numel() * 2 + S * 4 + sum(-(-k // page) for k in kv) * 4
    flops = 4 * Hq * D * ctx
    shapes = (f"S={S} ctx {min(kv)}..{max(kv)} (sum {ctx}) Hq={Hq} "
              f"Hkv={Hkv} D={D} page={page} bf16 q")
    lib_call = ("scaled_dot_product_attention(enable_gqa) over K/V "
                "gathered dense per sequence")
    for name, cache in (("paged_decode_attention", "bf16"),
                        ("paged_decode_attention_int8", "int8"),
                        ("paged_decode_attention_fp8", "fp8")):
        kc, vc, sc, kb, vb = caches[cache]
        kd, vd = _dense_kv(kb, vb, pt, kv, page)
        results[name] = measure(
            name,
            lambda: dec.paged_decode_attention(q, kc, vc, kvl, pt,
                                               scale=scale, **sc),
            lambda: dec.paged_decode_attention_plain(q, kc, vc, kvl, pt,
                                                     scale=scale, **sc),
            lambda: dec.paged_decode_attention_plain(q, kc, vc, kvl - 1, pt,
                                                     scale=scale, **sc),
            _decode_library(x, kd, vd, scale), 50,
            _kv_bytes(kv, page, Hkv, D, cache) + io, flops,
            shapes=shapes + f", {cache} cache",
            library_call=lib_call + LIB_NOTE[cache])
        results[name]["hole_rows"] = hole_check(
            name,
            lambda lens, table: dec.paged_decode_attention(
                q, kc, vc, lens, table, scale=scale, **sc),
            lambda lens, table: dec.paged_decode_attention_plain(
                q, kc, vc, lens, table, scale=scale, **sc), kvl, pt)
    # the same rows as a ragged batch of 32 one-token sequences
    cu = torch.arange(S + 1, dtype=torch.int32, device=dev)
    for name, cache in (("ragged_paged_attention_unified_decode", "bf16"),
                        ("ragged_paged_attention_unified_fp8_decode", "fp8")):
        kc, vc, _, kb, vb = caches[cache]
        kd, vd = _dense_kv(kb, vb, pt, kv, page)
        results[name] = measure(
            name,
            lambda: rag.ragged_paged_attention(q, kc, vc, cu, kvl, pt,
                                               scale=scale, unified=True,
                                               decode_only=True),
            lambda: rag.ragged_paged_attention_plain(q, kc, vc, cu, kvl, pt,
                                                     scale=scale,
                                                     unified=True),
            lambda: rag.ragged_paged_attention_plain(q, kc, vc, cu, kvl - 1,
                                                     pt, scale=scale,
                                                     unified=True),
            _decode_library(x, kd, vd, scale), 50,
            _kv_bytes(kv, page, Hkv, D, cache) + io + (S + 1) * 4, flops,
            shapes=f"pure decode as a ragged batch of one-token rows, T={S}"
            f" (decode_only, as the runner's decode steps call it), "
            f"{shapes}, {cache} cache",
            library_call=lib_call + LIB_NOTE[cache])
        # the decode class as a block's sub-steps call it, hole rows among
        # the rows (the unified step under overlap with slots)
        results[name]["hole_rows"] = hole_check(
            name,
            lambda lens, table, kc=kc, vc=vc: rag.ragged_paged_attention(
                q, kc, vc, cu, lens, table, scale=scale, unified=True,
                decode_only=True),
            lambda lens, table, kc=kc, vc=vc:
                rag.ragged_paged_attention_plain(
                    q, kc, vc, cu, lens, table, scale=scale, unified=True),
            kvl, pt)
    del x, kd, vd, caches

    # ---- mixed shape: K1 and K1u over each cache
    rng_g7 = np.random.default_rng(SEED)   # the same lengths, for K1 at G 7
    rng_g7.bit_generator.state = rng.bit_generator.state
    x = mixed_shape(rng, dev)
    q, cu, kvl, pt, kv, page = (x["q"], x["cu"], x["kvl"], x["pt"], x["kv"],
                                x["page"])
    seqs, T_real, T_pad = x["seqs"], x["T_real"], x["q"].shape[0]
    S_real, S_pad = len(seqs), len(kv)
    caches = _caches(x)
    visible = sum(k - ql + t + 1 for ql, k in seqs for t in range(ql))
    flops = 4 * Hq * D * visible
    # the T_real real q rows read, all T_pad out rows written (the padding
    # rows get zeros), cu_q_lens, kv_lens and the pages' ids
    row = Hq * D * 2
    io = (T_real * row + T_pad * row + (2 * S_pad + 1) * 4
          + sum(-(-k // page) for k in kv) * 4)
    shapes = (f"T={T_pad} ({T_real} real: 24 decode rows + chunks 512/300/"
              f"1024) S={S_pad} ({S_real} real) ctx<=2048 Hq={Hq} Hkv={Hkv} "
              f"D={D} page={page} bf16 q")
    lib_call = ("scaled_dot_product_attention(enable_gqa, bool mask) over q "
                "padded to [S, Hq, 1024, D] and K/V gathered dense per "
                "sequence")
    for name, unified, cache in (
            ("ragged_paged_attention", False, "bf16"),
            ("ragged_paged_attention_int8", False, "int8"),
            ("ragged_paged_attention_fp8", False, "fp8"),
            ("ragged_paged_attention_unified", True, "bf16"),
            ("ragged_paged_attention_unified_int8", True, "int8"),
            ("ragged_paged_attention_unified_fp8", True, "fp8")):
        kc, vc, sc, kb, vb = caches[cache]
        kw = dict(scale=scale, unified=unified, **sc)
        kd, vd = _dense_kv(kb, vb, pt[:S_real], kv[:S_real], page)
        varlen = _varlen_library(x, kb, vb, scale)
        if varlen is not None and cache == "int8":
            # the call reads the int8 cache dequantized to bf16: held to the
            # plain version over that cache
            varlen += (rag.ragged_paged_attention_plain(
                q, kb, vb, cu, kvl, pt, scale=scale, unified=unified),)
        results[name] = measure(
            name,
            lambda: rag.ragged_paged_attention(q, kc, vc, cu, kvl, pt, **kw),
            lambda: rag.ragged_paged_attention_plain(q, kc, vc, cu, kvl, pt,
                                                     **kw),
            lambda: rag.ragged_paged_attention_plain(
                q, kc, vc, cu, x["kvl_drop"], pt, **kw),
            _mixed_library(x, kd, vd, scale), 20,
            _kv_bytes(kv, page, Hkv, D, cache) + io, flops,
            varlen=varlen, shapes=shapes + f", {cache} cache",
            library_call=lib_call + LIB_NOTE[cache],
            varlen_library_call=VARLEN_CALL + LIB_NOTE[cache])
        del kd, vd
    del x, caches
    results.update(group7_kernel(dev, rng_g7))

    results.update(mla_kernels(dev))
    results.update(hybrid_kernels(dev))

    for name, r in results.items():
        rtol, atol = TOL[name]
        log(f"[kernels] {name}: {r['shapes']}")
        log(f"[kernels] {name}: ok={r['ok']} max_abs_err={r['max_abs_err']}"
            f" (allclose rtol={rtol} atol={atol}; {r['tol_used']:.3f} of it"
            f" used); perturbed plain (the last key dropped; K3: one "
            f"chunk's state update left out): max_abs {r['drop_max_abs']}, "
            f"rejected={r['drop_rejected']}")
        log(f"[kernels] {name}: device ms per call: kernel={r['ms']} plain="
            f"{r['plain_ms']} library={r['library_ms']}; kernel wrapper "
            f"back to back (CUDA events) {r['wrapper_ms']} ms; bound_ms="
            f"{r['bound_ms']} ({r['bound_by']}; {r['bytes']} bytes, "
            f"{r['flops']} flops)")
        log(f"[kernels] {name}: library backend {r['library_backend']}; "
            f"varlen flash {r.get('varlen_library_ms')} ms")
        if "hole_rows" in r:
            h = r["hole_rows"]
            log(f"[kernels] {name}: with {h['rows']} of the rows hole rows "
                f"(context 1 in the dummy page 0): ok={h['ok']} "
                f"max_abs_err={h['max_abs_err']}")
        if len(r["split"]) > 1:
            log(f"[kernels] {name}: device ms per call by launch: "
                + ", ".join(f"{k} {v}" for k, v in r["split"].items()))
            classes = {"decode class": "decode", "ragged class": "ragged"}
            log(f"[kernels] {name}: by class: " + ", ".join(
                f"{c} {sum(v for k, v in r['split'].items() if key in k)}"
                for c, key in classes.items()))
    bad = [n for n, r in results.items()
           if not r["ok"] or not r.get("hole_rows", {"ok": True})["ok"]]
    if bad:
        raise SystemExit(f"[kernels] kernel disagrees with its plain "
                         f"version: {bad}")
    blind = [n for n, r in results.items() if not r["drop_rejected"]]
    if blind:
        raise SystemExit(f"[kernels] tolerance accepts the perturbed plain: "
                         f"{blind}")
    return results


def group7_kernel(dev, rng):
    """K1 at a GQA group of 7 (Hq 28 over Hkv 4, D 128: Qwen2-7B's
    attention shape) on the mixed batch lengths, bf16 q and cache."""
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    name = "ragged_paged_attention_g7"
    Hq, Hkv, D = 28, 4, 128
    scale = D ** -0.5
    x = mixed_shape(rng, dev, Hq=Hq, Hkv=Hkv, D=D, quant=False)
    q, cu, kvl, pt, kv, page = (x["q"], x["cu"], x["kvl"], x["pt"], x["kv"],
                                x["page"])
    kc, vc = x["kc"], x["vc"]
    seqs, T_real, T_pad = x["seqs"], x["T_real"], q.shape[0]
    S_real, S_pad = len(seqs), len(kv)
    visible = sum(k - ql + t + 1 for ql, k in seqs for t in range(ql))
    row = Hq * D * 2
    io = (T_real * row + T_pad * row + (2 * S_pad + 1) * 4
          + sum(-(-k // page) for k in kv) * 4)
    kd, vd = _dense_kv(kc, vc, pt[:S_real], kv[:S_real], page)
    r = measure(
        name,
        lambda: rag.ragged_paged_attention(q, kc, vc, cu, kvl, pt,
                                           scale=scale),
        lambda: rag.ragged_paged_attention_plain(q, kc, vc, cu, kvl, pt,
                                                 scale=scale),
        lambda: rag.ragged_paged_attention_plain(q, kc, vc, cu,
                                                 x["kvl_drop"], pt,
                                                 scale=scale),
        _mixed_library(x, kd, vd, scale), 20,
        _kv_bytes(kv, page, Hkv, D, "bf16") + io, 4 * Hq * D * visible,
        varlen=_varlen_library(x, kc, vc, scale),
        shapes=(f"T={T_pad} ({T_real} real: 24 decode rows + chunks "
                f"512/300/1024) S={S_pad} ({S_real} real) ctx<=2048 Hq={Hq} "
                f"Hkv={Hkv} (G 7) D={D} page={page} bf16 q, bf16 cache"),
        library_call="scaled_dot_product_attention(enable_gqa, bool mask) "
        "over q padded to [S, Hq, 1024, D] and K/V gathered dense per "
        "sequence", varlen_library_call=VARLEN_CALL)
    return {name: r}


def mla_kernels(dev):
    """K2m, K1m and K1um at DeepSeek-V2-Lite's latent geometry (16 query
    heads over one [c_kv | k_pe] row of 576, values its leading 512, its
    softmax scale) on K2's decode and K1's mixed batch lengths: K2m and
    K1um (one-token rows) on the decode batch, also with hole rows, K1m
    and K1um on the mixed one, each over a bf16 and an fp8 latent."""
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    from gllm_tpu_torch.ops.rope import yarn_softmax_scale_mult
    cfg = deepseek_v2_lite()
    Hq, lora, Dl = cfg.num_heads, cfg.kv_lora_rank, cfg.mla_cache_width
    scale = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
             * yarn_softmax_scale_mult(cfg.rope_scaling))
    geo = dict(Hq=Hq, Hkv=1, D=Dl, quant=False)
    rng = np.random.default_rng(SEED)      # K2's, then K1's lengths
    results = {}
    lib_call = ("scaled_dot_product_attention(enable_gqa) over the latent "
                "gathered dense per sequence: k = the 576-wide row shared "
                "by the 16 heads, v = k[..., :512]")
    kw = dict(scale=scale, v_dim=lora)

    x = decode_shape(rng, dev, **geo)
    q, kvl, pt, kv, page = x["q"], x["kvl"], x["pt"], x["kv"], x["page"]
    lats = {"bf16": x.pop("kc"), "fp8": None}
    lats["fp8"] = lats["bf16"].to(FP8)
    del x["vc"]
    S, ctx = len(kv), sum(kv)
    pages = sum(-(-k // page) for k in kv)
    cu = torch.arange(S + 1, dtype=torch.int32, device=dev)
    shapes = (f"S={S} ctx {min(kv)}..{max(kv)} (sum {ctx}) Hq={Hq} latent "
              f"[P, {page}, 1, {Dl}] v_dim={lora} bf16 q, scale {scale:.5f}")
    for name, cache, unified in (
            ("paged_decode_attention_mla", "bf16", False),
            ("paged_decode_attention_mla_fp8", "fp8", False),
            ("ragged_paged_attention_unified_mla_decode", "bf16", True),
            ("ragged_paged_attention_unified_mla_fp8_decode", "fp8", True)):
        lat = lats[cache]
        kd = _dense_kv(lat.to(torch.bfloat16), lat.to(torch.bfloat16), pt,
                       kv, page)[0]
        # each latent row once; q read, out written, kv_lens, the pages'
        # ids (and cu_q_lens for the unified kernel)
        nbytes = (ctx * Dl * lat.element_size() + S * Hq * (Dl + lora) * 2
                  + S * 4 + pages * 4 + ((S + 1) * 4 if unified else 0))
        if unified:
            def run(fn, lens, lat=lat, table=pt):
                hint = ({"decode_only": True}
                        if fn is rag.ragged_paged_attention else {})
                return fn(q, lat, None, cu, lens, table, unified=True, **kw,
                          **hint)
            kernel, plain = rag.ragged_paged_attention, \
                rag.ragged_paged_attention_plain
        else:
            def run(fn, lens, lat=lat, table=pt):
                return fn(q, lat, None, lens, table, **kw)
            kernel, plain = dec.paged_decode_attention, \
                dec.paged_decode_attention_plain
        results[name] = measure(
            name, lambda: run(kernel, kvl), lambda: run(plain, kvl),
            lambda: run(plain, kvl - 1),
            _decode_library(x, kd, kd[..., :lora], scale), 50, nbytes,
            2 * Hq * (Dl + lora) * ctx,
            shapes=(("pure decode as a ragged batch of one-token rows "
                     "(decode_only), " if unified else "") + shapes
                    + f", {cache} latent"),
            library_call=lib_call + LIB_NOTE[cache])
        results[name]["hole_rows"] = hole_check(
            name, lambda lens, table: run(kernel, lens, table=table),
            lambda lens, table: run(plain, lens, table=table), kvl, pt)
        del kd
    del x, lats

    x = mixed_shape(rng, dev, **geo)
    q, cu, kvl, pt, kv, page = (x["q"], x["cu"], x["kvl"], x["pt"], x["kv"],
                                x["page"])
    lats = {"bf16": x.pop("kc")}
    lats["fp8"] = lats["bf16"].to(FP8)
    del x["vc"]
    seqs, T_real, T_pad = x["seqs"], x["T_real"], q.shape[0]
    S_real, S_pad = len(seqs), len(kv)
    visible = sum(k - ql + t + 1 for ql, k in seqs for t in range(ql))
    pages = sum(-(-k // page) for k in kv)
    for name, cache, unified in (
            ("ragged_paged_attention_mla", "bf16", False),
            ("ragged_paged_attention_mla_fp8", "fp8", False),
            ("ragged_paged_attention_unified_mla", "bf16", True),
            ("ragged_paged_attention_unified_mla_fp8", "fp8", True)):
        lat = lats[cache]
        # each context's latent rows once, the real q rows, all out rows
        # (the padding rows get zeros), cu_q_lens, kv_lens, the pages' ids
        nbytes = (sum(kv) * Dl * lat.element_size() + T_real * Hq * Dl * 2
                  + T_pad * Hq * lora * 2 + (2 * S_pad + 1) * 4 + pages * 4)
        kb = lat.to(torch.bfloat16)
        kd = _dense_kv(kb, kb, pt[:S_real], kv[:S_real], page)[0]
        del kb

        def run(fn, lens, lat=lat, unified=unified):
            return fn(q, lat, None, cu, lens, pt, unified=unified, **kw)
        results[name] = measure(
            name, lambda: run(rag.ragged_paged_attention, kvl),
            lambda: run(rag.ragged_paged_attention_plain, kvl),
            lambda: run(rag.ragged_paged_attention_plain, x["kvl_drop"]),
            _mixed_library(x, kd, kd[..., :lora], scale), 20, nbytes,
            2 * Hq * (Dl + lora) * visible,
            shapes=(f"T={T_pad} ({T_real} real: 24 decode rows + chunks "
                    f"512/300/1024) S={S_pad} ({S_real} real) ctx<=2048 "
                    f"Hq={Hq} latent [P, {page}, 1, {Dl}] v_dim={lora} bf16 "
                    f"q, scale {scale:.5f}, {cache} latent"),
            library_call=lib_call + ", q padded to [S, 16, 1024, 576] with a "
            "causal bool mask" + LIB_NOTE[cache])
        del kd
    return results


def hybrid_kernels(dev):
    """Qwen3-Next's kernels: K2 and K1 at head_dim 256 (Hq 16 over Hkv 2),
    over a bf16 and an fp8 cache, on K2's decode and K1's mixed batch
    lengths, and K3 on the layout the
    GDN layer builds for K1's mixed lengths: the 27 real rows padded to the
    longest (1024), 32 value heads, Dk = Dv = 128, chunks of 64."""
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    cfg = qwen3_next()
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = D ** -0.5
    geo = dict(Hq=Hq, Hkv=Hkv, D=D, quant=False)
    rng = np.random.default_rng(SEED)      # K2's, then K1's lengths
    results = {}

    x = decode_shape(rng, dev, **geo)
    q, kvl, pt, kv, page = x["q"], x["kvl"], x["pt"], x["kv"], x["page"]
    S, ctx = len(kv), sum(kv)
    io = 2 * q.numel() * 2 + S * 4 + sum(-(-k // page) for k in kv) * 4
    for name, cache in (("paged_decode_attention_d256", "bf16"),
                        ("paged_decode_attention_d256_fp8", "fp8")):
        kc, vc = x["kc"], x["vc"]
        if cache == "fp8":
            kc, vc = kc.to(FP8), vc.to(FP8)
        kd, vd = _dense_kv(kc.to(torch.bfloat16), vc.to(torch.bfloat16), pt,
                           kv, page)
        results[name] = measure(
            name,
            lambda: dec.paged_decode_attention(q, kc, vc, kvl, pt,
                                               scale=scale),
            lambda: dec.paged_decode_attention_plain(q, kc, vc, kvl, pt,
                                                     scale=scale),
            lambda: dec.paged_decode_attention_plain(q, kc, vc, kvl - 1, pt,
                                                     scale=scale),
            _decode_library(x, kd, vd, scale), 50,
            _kv_bytes(kv, page, Hkv, D, cache) + io, 4 * Hq * D * ctx,
            shapes=(f"S={S} ctx {min(kv)}..{max(kv)} (sum {ctx}) Hq={Hq} "
                    f"Hkv={Hkv} D={D} page={page} bf16 q, {cache} cache"),
            library_call="scaled_dot_product_attention(enable_gqa) over K/V "
            "gathered dense per sequence" + LIB_NOTE[cache])
        results[name]["hole_rows"] = hole_check(
            name,
            lambda lens, table: dec.paged_decode_attention(
                q, kc, vc, lens, table, scale=scale),
            lambda lens, table: dec.paged_decode_attention_plain(
                q, kc, vc, lens, table, scale=scale), kvl, pt)
        del kd, vd
    del x

    x = mixed_shape(rng, dev, **geo)
    q, cu, kvl, pt, kv, page = (x["q"], x["cu"], x["kvl"], x["pt"], x["kv"],
                                x["page"])
    seqs, T_real, T_pad = x["seqs"], x["T_real"], q.shape[0]
    S_real, S_pad = len(seqs), len(kv)
    visible = sum(k - ql + t + 1 for ql, k in seqs for t in range(ql))
    row = Hq * D * 2
    io = (T_real * row + T_pad * row + (2 * S_pad + 1) * 4
          + sum(-(-k // page) for k in kv) * 4)
    kw = dict(scale=scale)
    for name, cache in (("ragged_paged_attention_d256", "bf16"),
                        ("ragged_paged_attention_d256_fp8", "fp8")):
        kc, vc = x["kc"], x["vc"]
        if cache == "fp8":
            kc, vc = kc.to(FP8), vc.to(FP8)
        kd, vd = _dense_kv(kc.to(torch.bfloat16), vc.to(torch.bfloat16),
                           pt[:S_real], kv[:S_real], page)
        results[name] = measure(
            name,
            lambda: rag.ragged_paged_attention(q, kc, vc, cu, kvl, pt, **kw),
            lambda: rag.ragged_paged_attention_plain(q, kc, vc, cu, kvl, pt,
                                                     **kw),
            lambda: rag.ragged_paged_attention_plain(q, kc, vc, cu,
                                                     x["kvl_drop"], pt, **kw),
            _mixed_library(x, kd, vd, scale), 20,
            _kv_bytes(kv, page, Hkv, D, cache) + io, 4 * Hq * D * visible,
            varlen=_varlen_library(x, kc.to(torch.bfloat16),
                                   vc.to(torch.bfloat16), scale),
            varlen_library_call=VARLEN_CALL + LIB_NOTE[cache],
            shapes=(f"T={T_pad} ({T_real} real: 24 decode rows + chunks "
                    f"512/300/1024) S={S_pad} ({S_real} real) ctx<=2048 "
                    f"Hq={Hq} Hkv={Hkv} D={D} page={page} bf16 q, {cache} "
                    "cache"),
            library_call="scaled_dot_product_attention(enable_gqa, bool "
            "mask) over q padded to [S, Hq, 1024, D] and K/V gathered dense "
            "per sequence" + LIB_NOTE[cache])
        del kd, vd
    results.update(gdn_scan_kernel(dev, cfg, [ql for ql, _ in seqs]))
    return results


def gdn_scan_kernel(dev, cfg, q_lens):
    """K3 on the operands ``chunk_gated_delta_rule`` builds for rows of
    ``q_lens`` real tokens padded to the longest (g = beta = 0 past a
    row's end), random q, k, v, decay and write strength from the seed;
    then one full-width GDN layer at the same rows, for its peak memory
    against ``gdn_transient_bytes``."""
    from gllm_tpu_torch.models import hybrid
    from gllm_tpu_torch.ops.cuda import gdn_scan as scan
    from gllm_tpu_torch.ops.gdn import chunk_scan_operands
    H, Dk, Dv = (cfg.linear_num_value_heads, cfg.linear_key_head_dim,
                 cfg.linear_value_head_dim)
    R, Q = len(q_lens), max(q_lens)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    valid = (torch.arange(Q, device=dev)[None, :]
             < torch.tensor(q_lens, device=dev)[:, None])[..., None]
    g = torch.where(valid, -torch.rand((R, Q, H), generator=gen, device=dev)
                    * 0.5, 0.0)
    beta = torch.where(valid, torch.rand((R, Q, H), generator=gen,
                                         device=dev), 0.0)
    args = chunk_scan_operands(randn(R, Q, H, Dk), randn(R, Q, H, Dk),
                               randn(R, Q, H, Dv), g, beta,
                               randn(R, H, Dk, Dv))
    del g, beta
    B, N, C, _ = args[0].shape
    skip = N // 2    # the chunk whose state update the perturbed run skips

    def skipped():
        """The plain scan with chunk ``skip``'s state update left out."""
        def part(lo, hi, state):
            if lo >= hi:
                return [], state
            out, state = scan.gdn_chunk_scan_plain(
                *[a[:, lo:hi] for a in args[:6]], state)
            return [out], state
        o0, s0 = part(0, skip, args[6])
        o1, _ = part(skip, skip + 1, s0)
        o2, s2 = part(skip + 1, N, s0)
        return torch.cat(o0 + o1 + o2, dim=1), s2

    # each input read once, each output written once, float32
    nbytes = 4 * (B * N * C * (3 * Dk + Dv + C + 1) + B * Dk * Dv
                  + B * N * C * Dv + B * Dk * Dv)
    flops = B * N * (6 * C * Dk * Dv + 2 * C * C * Dv)
    real = sum(q_lens)
    real_chunks = sum(-(-n // C) for n in q_lens)
    r = measure(
        "gdn_chunk_scan",
        lambda: scan.gdn_chunk_scan(*args),
        lambda: scan.gdn_chunk_scan_plain(*args), skipped, None, 20,
        nbytes, 3 * flops, peak_flops=PEAK_TF32_FLOPS,
        shapes=(f"B={B} (rows {R} x {H} heads) N={N} C={C} Dk={Dk} Dv={Dv}"
                f" float32: {len(q_lens)} rows of {min(q_lens)}..{Q} real "
                f"tokens (sum {real}) padded to {N * C}; padded share of "
                f"the cells {1 - real / (R * N * C):.4f}, of the chunks "
                f"{1 - real_chunks / (R * N):.4f}"),
        library_call="none (no one PyTorch call computes the scan)")
    del args
    # one full-width GDN layer (bf16) at the same rows: its peak memory
    # beyond its inputs against the headroom the runner reckons for it
    from gllm_tpu_torch.batching import StepBatch
    from gllm_tpu_torch.ops.attention import AttentionMetadata
    lp = {k: v[0] for k, v in hybrid.init_params(
        qwen3_next(num_hidden_layers=1, num_experts=1, vocab_size=16,
                   layer_types=["linear_attention"]),
        SEED, torch.bfloat16, dev)["gdn_layers"].items()}
    T = 2048
    cu = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    cu[1:] = torch.tensor(np.cumsum(q_lens), device=dev)
    slots = torch.arange(1, R + 1, dtype=torch.int32, device=dev)
    conv, rec = (torch.zeros(shape[1:], device=dev) for shape in
                 hybrid.ssm_shapes(cfg, R + 1))
    batch = StepBatch(token_ids=None, positions=None, slot_mapping=None,
                      logits_indices=None,
                      attn=AttentionMetadata(cu, cu[1:], None),
                      sampling=None, ssm_slots=slots, num_seqs=R,
                      max_seq_q=Q)
    x = randn(T, cfg.hidden_size).to(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hybrid._gdn_layer(lp, x, batch, conv, rec, cfg, max_q_len=T)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    reckoned = hybrid.gdn_transient_bytes(cfg, R * Q, R)
    log(f"[kernels] gdn layer (bf16, full width) at {R} rows x {Q}: peak "
        f"{peak / 2**30:.3f} GiB beyond its inputs; the runner reckons "
        f"{reckoned / 2**30:.3f} GiB for that shape")
    assert peak <= reckoned, "[kernels] the GDN layer outgrew its headroom"
    r["gdn_layer_peak_gib"] = peak / 2**30
    return {"gdn_chunk_scan": r}


# ---- 4. serve ------------------------------------------------------------

def llama_3_2_1b(**kw):
    from gllm_tpu_torch import ModelConfig
    cfg = dict(architecture="LlamaForCausalLM", vocab_size=128256,
               hidden_size=2048, num_layers=16, num_heads=32, num_kv_heads=8,
               head_dim=64, intermediate_size=8192, max_position=4096,
               rope_theta=500000.0, tie_word_embeddings=True)
    cfg.update(kw)
    return ModelConfig(**cfg)


def deepseek_v2_lite(**kw):
    """DeepSeek-V2-Lite's published config.json (the keys the port reads),
    parsed by the port's from_hf_config; ``kw`` overrides HF keys."""
    from gllm_tpu_torch import from_hf_config
    hf = dict(
        architectures=["DeepseekV2ForCausalLM"], vocab_size=102400,
        hidden_size=2048, num_hidden_layers=27, num_attention_heads=16,
        num_key_value_heads=16, q_lora_rank=None, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        intermediate_size=10944, moe_intermediate_size=1408,
        n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2,
        first_k_dense_replace=1, moe_layer_freq=1, topk_method="greedy",
        n_group=1, topk_group=1, scoring_func="softmax",
        norm_topk_prob=False, routed_scaling_factor=1.0, rope_theta=10000,
        rope_scaling={"type": "yarn", "factor": 40,
                      "original_max_position_embeddings": 4096,
                      "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                      "mscale_all_dim": 0.707},
        max_position_embeddings=163840, rms_norm_eps=1e-6,
        tie_word_embeddings=False, bos_token_id=100000,
        eos_token_id=100001)
    hf.update(kw)
    return from_hf_config(hf)


def qwen3_next(**kw):
    """Qwen3-Next-80B-A3B-Instruct's published config.json (the keys the
    port reads), parsed by the port's from_hf_config, with the depth cut
    to 12 layers (3 periods: 9 GDN, 3 gated full attention); ``kw``
    overrides HF keys. The published file gives full_attention_interval 4
    and no layer_types; the list is spelled out from the interval here."""
    from gllm_tpu_torch import from_hf_config
    hf = dict(
        architectures=["Qwen3NextForCausalLM"], vocab_size=151936,
        hidden_size=2048, num_hidden_layers=12, num_attention_heads=16,
        num_key_value_heads=2, head_dim=256, partial_rotary_factor=0.25,
        rope_theta=10000000, rms_norm_eps=1e-6,
        max_position_embeddings=262144, full_attention_interval=4,
        linear_num_key_heads=16, linear_num_value_heads=32,
        linear_key_head_dim=128, linear_value_head_dim=128,
        linear_conv_kernel_dim=4, num_experts=512, num_experts_per_tok=10,
        norm_topk_prob=True, moe_intermediate_size=512,
        shared_expert_intermediate_size=512, intermediate_size=5120,
        decoder_sparse_step=1, mlp_only_layers=[], hidden_act="silu",
        tie_word_embeddings=False, bos_token_id=151643,
        eos_token_id=151645)
    hf.update(kw)
    if "layer_types" not in hf:
        every = hf["full_attention_interval"]
        hf["layer_types"] = [
            "full_attention" if (i + 1) % every == 0 else "linear_attention"
            for i in range(hf["num_hidden_layers"])]
    return from_hf_config(hf)


def _wrappers():
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import gdn_scan as scan
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    return ((rag.ragged_paged_attention, dec.paged_decode_attention,
             scan.gdn_chunk_scan),
            (rag.ragged_paged_attention_plain,
             dec.paged_decode_attention_plain, scan.gdn_chunk_scan_plain))


def reset_counters():
    kernels, plains = _wrappers()
    for fn in kernels:
        for k in fn.launches:
            fn.launches[k] = 0
    for fn in plains:
        fn.calls = 0


def read_counters():
    kernels, plains = _wrappers()
    counts = {k: n for fn in kernels for k, n in fn.launches.items()}
    counts["plain_calls"] = sum(fn.calls for fn in plains)
    return counts


def memory_breakdown(holders=0):
    """The card's memory by caching-allocator pool, from
    torch.cuda.memory_snapshot(): per pool (the default one, each CUDA
    graph pool) its segments, reserved and allocated GiB, and the free
    space stranded in segments that still hold a tensor (empty_cache
    cannot return it); then what lies outside the allocator (the CUDA
    context, loaded modules, instantiated graphs, other processes): the
    card's used memory less everything reserved. With ``holders``, as
    many segments with the most stranded space, each with its live
    blocks' sizes and, when the allocator records its history
    (``--memory-history``), where the largest was allocated."""
    pools = {}
    stranded = []
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id") or (0, 0))
        name = "default" if pid == (0, 0) else f"pool{pid}"
        p = pools.setdefault(name, [0, 0, 0, 0])
        free = seg["total_size"] - seg["allocated_size"]
        p[0] += 1
        p[1] += seg["total_size"]
        p[2] += seg["allocated_size"]
        if seg["allocated_size"] and free:
            p[3] += free
            stranded.append((free, name, seg))
    free, total = torch.cuda.mem_get_info()
    reserved = sum(p[1] for p in pools.values())
    text = "; ".join(
        f"{n} {p[0]} segments {p[1] / 2**30:.3f} reserved "
        f"{p[2] / 2**30:.3f} allocated {p[3] / 2**30:.3f} stranded"
        for n, p in sorted(pools.items())) or "nothing reserved"
    text += (f"; outside the allocator "
             f"{(total - free - reserved) / 2**30:.3f} GiB")
    for gap, name, seg in sorted(stranded, key=lambda s: -s[0])[:holders]:
        live = [b for b in seg["blocks"] if b["state"] == "active_allocated"]
        big = max(live, key=lambda b: b["size"])
        where = [f"{f['filename'].rsplit('/', 1)[-1]}:{f['line']} "
                 f"{f['name']}" for f in big.get("frames", [])
                 if "gllm_tpu_torch" in f["filename"]
                 or "chip_smoke" in f["filename"]][:3]
        text += (f"\n    stranded {gap / 2**20:.1f} MiB in a {name} "
                 f"{seg['segment_type']} segment of "
                 f"{seg['total_size'] / 2**20:.1f} MiB held by "
                 f"{len(live)} blocks (largest {big['size'] / 2**20:.2f} "
                 f"MiB" + (f", from {' < '.join(where)}" if where else "")
                 + ")")
    return text


def split_counters_clear():
    """Are the split counters of the decode kernels' scratch all zero (the
    last split of each row resets its counter)?"""
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    torch.cuda.synchronize()
    buf = dec.decode_scratch(torch.device("cuda", torch.cuda.current_device()),
                             0)
    return not buf[:dec.COUNTER_SLOTS].view(torch.int32).any().item()


# serve configurations: (model, EngineConfig keywords, runs, the kernels
# each layer of a step of each kind must launch, profiled). Every engine
# replays its decode steps as CUDA graphs (enforce_eager False, the
# default) after llm.runner.warmup(); a configuration in TWINS also serves
# an eager twin on the same weights, in the order eager, graph, graph,
# eager (its runs entry is not read)
SERVE = {
    "bf16": (llama_3_2_1b, dict(), 2,
             {"mixed": ("ragged_paged_attention",),
              "decode": ("paged_decode_attention",)}, True),
    "int8": (llama_3_2_1b, dict(kv_cache_dtype="int8"), 1,
             {"mixed": ("ragged_paged_attention_int8",),
              "decode": ("paged_decode_attention_int8",)}, False),
    "unified": (llama_3_2_1b, dict(unified_step=True), 2,
                {"mixed": ("ragged_paged_attention_unified",),
                 "decode": ("ragged_paged_attention_unified",)}, False),
    "unified_int8": (llama_3_2_1b,
                     dict(unified_step=True, kv_cache_dtype="int8"), 1,
                     {"mixed": ("ragged_paged_attention_unified_int8",),
                      "decode": ("ragged_paged_attention_unified_int8",)},
                     True),
    "fp8": (llama_3_2_1b, dict(kv_cache_dtype="fp8"), 1,
            {"mixed": ("ragged_paged_attention_fp8",),
             "decode": ("paged_decode_attention_fp8",)}, False),
    "unified_fp8": (llama_3_2_1b,
                    dict(unified_step=True, kv_cache_dtype="fp8"), 1,
                    {"mixed": ("ragged_paged_attention_unified_fp8",),
                     "decode": ("ragged_paged_attention_unified_fp8",)},
                    False),
    "deepseek": (deepseek_v2_lite, dict(), 2,
                 {"mixed": ("ragged_paged_attention_mla",),
                  "decode": ("paged_decode_attention_mla",)}, True),
    # the DeepSeek engines after the first reuse its weights
    "deepseek_unified": (deepseek_v2_lite, dict(unified_step=True), 2,
                         {"mixed": ("ragged_paged_attention_unified_mla",),
                          "decode": ("ragged_paged_attention_unified_mla",)},
                         True),
    "deepseek_fp8": (deepseek_v2_lite, dict(kv_cache_dtype="fp8"), 1,
                     {"mixed": ("ragged_paged_attention_mla_fp8",),
                      "decode": ("paged_decode_attention_mla_fp8",)}, False),
    "deepseek_unified_fp8": (
        deepseek_v2_lite, dict(unified_step=True, kv_cache_dtype="fp8"), 1,
        {"mixed": ("ragged_paged_attention_unified_mla_fp8",),
         "decode": ("ragged_paged_attention_unified_mla_fp8",)}, False),
    # K3 on the GDN layers, K1 / K2 at head_dim 256 on the full ones
    "qwen3_next": (qwen3_next, dict(), 2,
                   {"mixed": ("ragged_paged_attention", "gdn_chunk_scan"),
                    "decode": ("paged_decode_attention",)}, True),
    "qwen3_next_fp8": (qwen3_next, dict(kv_cache_dtype="fp8"), 1,
                       {"mixed": ("ragged_paged_attention_fp8",
                                  "gdn_chunk_scan"),
                        "decode": ("paged_decode_attention_fp8",)}, False),
}
TWINS = ("bf16", "unified", "deepseek", "deepseek_unified", "qwen3_next")
# twins whose eager engine is profiled too (an eager DeepSeek window's
# trace takes a minute to read back)
PROFILE_EAGER = ("bf16",)
# configurations that also serve an overlap twin: the pipelined loop
# (overlap scheduling under it) at depth 2, graphs warmed, on the same
# weights; the runs go eager, graph, overlap, overlap, graph, eager. The
# hybrid model's twin chains and never re-forms
OVERLAP_TWINS = ("bf16", "deepseek", "qwen3_next")
PROFILE_OVERLAP = ("bf16",)
OVERLAP = dict(pipelined_loop=True, overlap_depth=2)
# configurations that also serve a multi twin: blocks of decode steps (the
# pipelined loop at depth 2 with on-device finish, which lifts the chain
# length to 16), on the same weights; the runs go eager, graph, overlap,
# multi, multi, overlap, graph, eager, and the bf16 twin also serves the
# stop-token run. Its warmup captures the single steps and the longest
# blocks at the sequence buckets the workload takes (its graph pools then
# fit beside the primary engine's and the overlap twin's); other blocks
# are captured at first sight, in its first run
MULTI_TWINS = ("bf16", "deepseek")
PROFILE_MULTI = ("bf16",)
# the configuration whose multi twin serves the stop-token run: the dummy
# Llama ties its embeddings, and its greedy stream repeats one token (no
# stop token can land inside a block), while DeepSeek's varies
STOP_RUN = "deepseek"
MULTI = dict(pipelined_loop=True, overlap_depth=2, ondevice_finish=True)
MULTI_BLOCK_BUCKETS = (8, 16)
# configurations that also serve a slot twin: the multi twin's flags (the
# overlap twin's for the hybrid model, which never fuses) with persistent
# slots (holes, joins at chain boundaries, compaction) and the ramp of 16
# decode steps chained under waiting prefill; the runs go eager, graph,
# overlap, multi, slot, slot, multi, overlap, graph, eager (no multi twin
# for the hybrid model), its second run held to its own batches replayed,
# and the DeepSeek slot twin serves the stop-token run too (a finish
# inside a block becomes a hole)
SLOT_TWINS = ("bf16", "deepseek", "qwen3_next")
PROFILE_SLOT = ("bf16",)
SLOT_FLAGS = dict(decode_slot_batching=True, chain_under_prefill=16)
SLOT = dict(MULTI, **SLOT_FLAGS)
SLOT_HYBRID = dict(OVERLAP, **SLOT_FLAGS)
# configurations that also serve an absorb twin: the unified step under
# overlap, the slot twin's flags with the configuration's unified_step
# (chain_under_prefill, which the unified step retires, left out): a chain
# with prefill work waiting absorbs it through a mixed re-form instead of
# yielding. The runs go eager, graph, absorb, absorb, graph, eager, its
# second run held to its own batches replayed through the unified sync
# engine
ABSORB_TWINS = ("unified", "deepseek_unified")
ABSORB = {k: v for k, v in SLOT.items() if k != "chain_under_prefill"}
# the staggered-arrival run: the configuration's sync graph engine and its
# slot or absorb twin serve the 16 requests arriving as output commits
# (STAGGER_FIRST at start, then STAGGER_MORE each time another
# STAGGER_EVERY output tokens have committed), runs graph, twin, twin,
# graph; the absorb twin's profiled window takes its arrivals the same way
STAGGERED = ("bf16", "unified")
STAGGER_FIRST, STAGGER_EVERY, STAGGER_MORE = 4, 64, 2
PROFILE_ABSORB = ("unified",)
# a twin's KV pool: the workload's 16 requests hold at most 899 pages of
# 16 tokens at once (a block's look-ahead adds one a row), so no twin
# preempts (each asserts it; the primary engine holds the memory the pool
# is sized from); a hybrid twin also holds 16 GDN slots (the workload's),
# not 256
TWIN_PAGES = 2048
# segments with stranded space that each memory line names (4 with
# --memory-history, which also records where their blocks came from)
HOLDERS = 0
# each fp8 configuration's full-precision twin, whose KV pages it doubles
FP8_SERVE_TWINS = {"fp8": "bf16", "unified_fp8": "unified",
                   "deepseek_fp8": "deepseek",
                   "deepseek_unified_fp8": "deepseek_unified",
                   "qwen3_next_fp8": "qwen3_next"}
# models whose later engines reuse the first engine's weights (drawing
# 31 or 41 GB of dummy weights again would cost minutes)
REUSE_WEIGHTS = (deepseek_v2_lite, qwen3_next)


def layers_running(cfg, kernel):
    """Layers of the model that launch ``kernel`` once a step: the GDN
    layers for K3, the attention layers (all of a non-hybrid model's) for
    the attention kernels."""
    if kernel == "gdn_chunk_scan":
        return cfg.num_linear_layers
    return cfg.num_attn_layers


def median(xs):
    return sorted(xs)[len(xs) // 2]


def first_difference(a, b):
    """(request, output index) of the first token where two streams
    differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return i, j
    return None


def explain_difference(eager, prompts, got, want, where):
    """What the eager engine's logits say at the first differing token: the
    context (prompt and the common output prefix) prefilled in one chunk,
    its logits at the two tokens and their largest magnitude."""
    from gllm_tpu_torch import SamplingParams
    i, j = where
    seq = eager._allocate_seq(prompts[i] + want[i][:j],
                              SamplingParams(temperature=0.0, max_tokens=1))
    eager.add_seq(seq)
    batch = eager.scheduler.schedule_once()
    dev, max_q = eager.runner.prepare(batch)
    logits = eager.runner.forward_logits(dev, max_q)[0].float()
    eager.scheduler.process_output(batch, [int(logits.argmax())],
                                   eager.eos_token_ids)
    a, b = want[i][j], got[i][j]
    return (f"request {i}, output token {j}: eager {a}, graph {b}; the "
            f"eager logits of that context (one prefill chunk) give "
            f"{logits[a].item()} and {logits[b].item()} (difference "
            f"{(logits[a] - logits[b]).item()}; max |logit| "
            f"{logits.abs().max().item()})")


def serve(name, model, kw, runs, by_kind, profiled, params=None):
    """Serve one configuration (with ``params``, the weights of an earlier
    engine of the model: only a new KV pool is built): warm the graphs,
    time the runs (alternating with the eager twin where there is one),
    check the launch counts, the replays and the twins' streams; returns
    its numbers and the engine's weights."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, SamplingParams
    kw = dict(kw)
    kv_dtype = kw.pop("kv_cache_dtype", "auto")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.monotonic()
    llm = LLM(model_cfg=model(), params=params,
              config=EngineConfig(load_format="dummy", dtype="bfloat16",
                                  seed=SEED,
                                  cache=CacheConfig(kv_cache_dtype=kv_dtype),
                                  **kw))
    # cached blocks the engine's construction left in partly used
    # segments (its KV pool was sized after emptying the cache)
    spare = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    sz = llm.runner.sizing
    log(f"[serve {name}] LLM up in {time.monotonic() - t0:.1f} s"
        f"{' (weights reused)' if params is not None else ''}: "
        f"{llm.runner.num_pages} KV pages of {llm.config.cache.page_size} "
        f"tokens ({llm.runner.kv_dtype}) on {llm.device}; activation "
        f"headroom {llm.runner.activation_headroom() / 2**30:.2f} GiB; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{spare / 2**30:.3f} GiB reserved and unallocated; "
        f"{free0 / 2**30:.2f} GiB free before the engine; sized from "
        f"{sz['free'] / 2**30:.3f} GiB free with "
        f"{(sz['reserved'] - sz['allocated']) / 2**30:.3f} GiB stranded; "
        f"memory by pool: {memory_breakdown(HOLDERS)}")
    rng = np.random.default_rng(SEED)
    vocab = llm.model_cfg.vocab_size
    warm = SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True)
    # warm-up request (CUDA context, cuBLAS handles); not counted
    llm.generate(prompt_token_ids=[[1, 2, 3, 4]], sampling_params=warm)
    graphs = llm.runner.graphs
    t0 = time.monotonic()
    llm.runner.warmup()
    warm_s = time.monotonic() - t0
    pool_mib = graphs.pool_bytes() / 2**20
    log(f"[serve {name}] warmup: {llm.runner.num_shape_signatures} decode "
        f"graphs captured in {warm_s:.2f} s ({graphs.capture_seconds:.2f} s "
        f"in capture, warm-up runs included); graph pool {pool_mib:.1f} MiB;"
        f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eager = None
    if name in TWINS:
        extra = {"max_num_seqs": 16} if llm.runner.hybrid else {}
        eager = LLM(model_cfg=llm.model_cfg, params=llm.runner.params,
                    config=EngineConfig(
                        load_format="dummy", dtype="bfloat16", seed=SEED,
                        enforce_eager=True, cache=CacheConfig(
                            kv_cache_dtype=kv_dtype, num_pages=TWIN_PAGES),
                        **kw, **extra))
        eager.generate(prompt_token_ids=[[1, 2, 3, 4]], sampling_params=warm)
        log(f"[serve {name}] eager twin on the same weights: "
            f"{TWIN_PAGES} KV pages{', 16 GDN slots' if extra else ''}")
    over = None
    if name in OVERLAP_TWINS:
        extra = {"max_num_seqs": 16} if llm.runner.hybrid else {}
        over = LLM(model_cfg=llm.model_cfg, params=llm.runner.params,
                   config=EngineConfig(
                       load_format="dummy", dtype="bfloat16", seed=SEED,
                       cache=CacheConfig(kv_cache_dtype=kv_dtype,
                                         num_pages=TWIN_PAGES),
                       **OVERLAP, **kw, **extra))
        over.generate(prompt_token_ids=[[1, 2, 3, 4]], sampling_params=warm)
        t0 = time.monotonic()
        over.runner.warmup()
        log(f"[serve {name}] overlap twin on the same weights ({OVERLAP}): "
            f"{TWIN_PAGES} KV pages, {over.runner.num_shape_signatures} "
            f"graphs warmed in {time.monotonic() - t0:.2f} s, graph pool "
            f"{over.runner.graphs.pool_bytes() / 2**20:.1f} MiB")
    lens = rng.integers(64, 1537, 16)
    max_tokens = rng.integers(32, 129, 16)
    prompts = [rng.integers(1, vocab, int(n)).tolist() for n in lens]
    params = [SamplingParams(temperature=0.0, max_tokens=int(m),
                             ignore_eos=True) for m in max_tokens]
    multi = slot = absorb = None
    if name in MULTI_TWINS:
        multi = block_twin(name, "multi", llm, kv_dtype, kw, MULTI)
    if name in SLOT_TWINS:
        slot = block_twin(name, "slot", llm, kv_dtype, kw,
                          SLOT_HYBRID if llm.runner.hybrid else SLOT)
    if name in ABSORB_TWINS:
        absorb = block_twin(name, "absorb", llm, kv_dtype, kw, ABSORB)
        assert absorb.unified and absorb.config.pipelined_loop, \
            f"[serve {name}] the absorb twin is not a unified overlap engine"
    if multi and slot:
        order = [eager, llm, over, multi, slot, slot, multi, over, llm,
                 eager]
    elif slot:
        order = [eager, llm, over, slot, slot, over, llm, eager]
    elif absorb:
        order = [eager, llm, absorb, absorb, llm, eager]
    elif over:
        order = [eager, llm, over, over, llm, eager]
    elif eager:
        order = [eager, llm, llm, eager]
    else:
        order = [llm] * runs
    modes = {id(llm): "graph", id(eager): "eager", id(over): "overlap",
             id(multi): "multi", id(slot): "slot", id(absorb): "absorb"}
    log(f"[serve {name}] 16 requests, prompts {lens.min()}..{lens.max()} "
        f"(sum {lens.sum()}), max_tokens {max_tokens.min()}..."
        f"{max_tokens.max()}, runs "
        + ", ".join(modes[id(e)] for e in order))
    engines = [e for e in (llm, eager, over, multi, slot, absorb)
               if e is not None]
    steps0 = [dict(e.step_counts) for e in engines]
    blocks0 = [dict(e.runner.block_counts) for e in engines]
    replays0 = [e.runner.graphs.replays if e.runner.graphs else 0
                for e in engines]
    sigs0 = llm.runner.num_shape_signatures
    if over:
        over_dispatches0 = over.dispatches.copy()
    twins0 = {id(e): twin_counts(e) for e in (multi, slot, absorb) if e}
    reset_counters()
    rates = {"graph": [], "eager": [], "overlap": [], "multi": [],
             "slot": [], "absorb": []}
    streams = {}
    schedules = {}
    for rep, e in enumerate(order):
        mode = modes[id(e)]
        recording = e in (over, multi, slot, absorb) and mode in streams
        if recording:
            # the second overlap (multi, slot, absorb) run records what it
            # dispatches
            schedules[mode] = record_schedule(e)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = e.generate(prompt_token_ids=prompts, sampling_params=params)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if recording:
            del e.runner.step_async, e.runner.step_multi
            del e.scheduler.discard_batch
        n_out = sum(o.num_output_tokens for o in outs)
        rates[mode].append(n_out / wall)
        log(f"[serve {name}] run {rep} ({mode}): {n_out} tokens in "
            f"{wall:.3f} s = {n_out / wall:.1f} output tok/s")
        assert [o.num_output_tokens for o in outs] == max_tokens.tolist(), \
            f"[serve {name}] a request did not return exactly max_tokens"
        assert all(o.finish_reason == "length" for o in outs)
        assert all(0 <= t < vocab for o in outs for t in o.output_token_ids)
        toks = [o.output_token_ids for o in outs]
        assert streams.setdefault(mode, toks) == toks, \
            f"[serve {name}] two {mode} runs gave different streams"
    counts = read_counters()
    steps = {k: sum(e.step_counts[k] - s0[k]
                    for e, s0 in zip(engines, steps0)) for k in steps0[0]}
    # executed sub-steps of blocks, which launch the decode kernels too
    steps["substeps"] = sum(e.runner.block_counts["substeps"] - b0["substeps"]
                            for e, b0 in zip(engines, blocks0))
    graph_decode = llm.step_counts["decode"] - steps0[0]["decode"]
    replays = graphs.replays - replays0[0]
    first_sight = llm.runner.num_shape_signatures - sigs0
    launched = {k for k, n in counts.items() if k != "plain_calls" and n}
    log(f"[serve {name}] graph median {median(rates['graph']):.1f} output "
        f"tok/s" + (f", eager median {median(rates['eager']):.1f} "
                    f"({median(rates['graph']) / median(rates['eager']):.3f}"
                    f"x)" if eager else "")
        + f"; steps {steps}; graph replays {replays} of {graph_decode} "
        f"decode steps, {first_sight} graphs captured at first sight in "
        f"the runs; launches {counts}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # every engine with graphs: one replay for each decode dispatch (a
    # single step or a block); a block's executed sub-steps as many as its
    # collect counted
    for e, s0, b0, r0 in zip(engines, steps0, blocks0, replays0):
        if e.runner.graphs is None:
            continue
        dispatched = (e.step_counts["decode"] - s0["decode"]
                      + e.runner.block_counts["block"] - b0["block"])
        got = e.runner.graphs.replays - r0
        assert got == dispatched, \
            f"[serve {name}] {modes[id(e)]}: {dispatched} decode " \
            f"dispatches but {got} replays"
    assert replays == graph_decode, \
        f"[serve {name}] {graph_decode} decode steps but {replays} replays"
    if eager:
        where = first_difference(streams["graph"], streams["eager"])
        if where is not None:
            raise SystemExit(f"[serve {name}] graph and eager greedy streams "
                             f"differ: " + explain_difference(
                                 eager, prompts, streams["graph"],
                                 streams["eager"], where))
        log(f"[serve {name}] graph and eager greedy streams identical")
    overlap = None
    if over:
        overlap = check_overlap(name, over, rates, streams, over_dispatches0)
    multi_out = slot_out = absorb_out = None
    if multi:
        multi_out = check_multi(name, multi, "multi", rates, streams,
                                twins0[id(multi)])
    if slot:
        slot_out = check_multi(name, slot, "slot", rates, streams,
                               twins0[id(slot)])
    if absorb:
        absorb_out = check_multi(name, absorb, "absorb", rates, streams,
                                 twins0[id(absorb)])
    assert launched == {k for ks in by_kind.values() for k in ks}, \
        f"[serve {name}] launched {launched}, expected {by_kind}"
    # every layer of every step of a kind launched that kind's kernels
    want = {k: 0 for ks in by_kind.values() for k in ks}
    for kind, kernels in by_kind.items():
        n = steps[kind] + (steps["substeps"] if kind == "decode" else 0)
        for kernel in kernels:
            want[kernel] += n * layers_running(llm.model_cfg, kernel)
    assert all(counts[k] == n for k, n in want.items()), \
        f"[serve {name}] launches {counts}, expected {want} from {steps}"
    assert counts["plain_calls"] == 0, "a plain version ran on the card"
    assert split_counters_clear(), "a decode kernel left a split counter set"
    for e in engines:
        mm = e.memory_manager
        assert mm.num_free_pages == mm.allocator.num_total, "KV pages leaked"
        assert e is llm or not e.scheduler.num_preemptions, \
            f"[serve {name}] the {modes[id(e)]} twin preempted"
        if mm.use_ssm:
            assert mm.ssm_alloc.num_free == mm.ssm_alloc.num_total, \
                "SSM slots leaked"
    for mode, schedule in schedules.items():
        replay_in_sync(name, mode, llm, schedule, prompts, params,
                       streams[mode])
    staggered = None
    if name in STAGGERED:
        staggered = staggered_runs(name, llm, slot or absorb,
                                   "slot" if slot else "absorb", prompts,
                                   params)
    if name == STOP_RUN:
        # the eager and overlap twins are done (their windows are bf16's);
        # their pages and pools make room for the stop-token run's graphs
        eager = over = order = e = None
        engines = [llm, multi, slot]
        gc.collect()
        torch.cuda.empty_cache()
        multi_out["stop_run"] = stop_token_run(name, llm, multi, "multi",
                                               prompts, streams["graph"])
        slot_out["stop_run"] = stop_token_run(name, llm, slot, "slot",
                                              prompts, streams["graph"])
    prof = {}
    if profiled:
        prof["graph"] = profile_window(llm, name + " graph")
        if eager and name in PROFILE_EAGER:
            prof["eager"] = profile_window(eager, name + " eager")
        if over and name in PROFILE_OVERLAP:
            prof["overlap"] = profile_window(over, name + " overlap")
        if multi and name in PROFILE_MULTI:
            prof["multi"] = profile_window(multi, name + " multi")
        if slot and name in PROFILE_SLOT:
            prof["slot"] = profile_window(slot, name + " slot")
    if absorb and name in PROFILE_ABSORB:
        # staggered arrivals: an absorb twin sees mixed re-forms only when
        # requests arrive while its chains run; the sync graph engine
        # under the same arrivals beside it
        prof["graph_staggered"] = profile_window(
            llm, name + " graph, staggered", staggered=True)
        prof["absorb"] = profile_window(absorb, name + " absorb, staggered",
                                        staggered=True)
    out = dict(counts=counts, rates=rates["graph"],
               eager_rates=rates["eager"], overlap_rates=rates["overlap"],
               multi_rates=rates["multi"], slot_rates=rates["slot"],
               absorb_rates=rates["absorb"], overlap=overlap,
               multi=multi_out, slot=slot_out, absorb=absorb_out,
               staggered=staggered,
               pages=llm.runner.num_pages,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               graphs=llm.runner.num_shape_signatures, warm_s=warm_s,
               capture_s=graphs.capture_seconds, pool_mib=pool_mib,
               profile=prof)
    weights = llm.runner.params
    del llm, eager, over, multi, slot, absorb, engines, graphs, order, e
    del modes
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    log(f"[serve {name}] engines freed (the weights held for the caller): "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, "
        f"{free / 2**30:.3f} GiB free; memory by pool: "
        f"{memory_breakdown(HOLDERS)}")
    return out, weights


def block_keys(graphs):
    """The captured blocks of a DecodeGraphs, counted by K."""
    by_k = {}
    for key in graphs.keys:
        if key[0] == "block":
            by_k[key[5]] = by_k.get(key[5], 0) + 1
    return dict(sorted(by_k.items()))


def record_schedule(e):
    """Wrap an engine's dispatches (single steps and blocks) and discards
    (until the caller deletes the wrappers): what it dispatches, in order,
    as a list of links each with its rows (sequence id, computed before,
    new tokens; a hole row's id is HOLE_SEQ_ID) and the signature it runs
    at (a block's: its last link's); and the entries it discards."""
    entries, discarded = [], []
    step_async, step_multi = e.runner.step_async, e.runner.step_multi
    discard = e.scheduler.discard_batch
    shape = e.runner.builder.shape_signature

    def rows(batch):
        return [(it.seq.seq_id, it.computed_before, it.num_new_tokens)
                for it in batch.items]

    def dispatch(batch, prev=None, **kw):
        entries.append((batch, [rows(batch)], shape(batch)))
        return step_async(batch, prev, **kw)

    def block(chain, prev=None):
        entries.append((chain, [rows(b) for b in chain], shape(chain[-1])))
        return step_multi(chain, prev)

    def drop(batch):
        discarded.append(batch)
        return discard(batch)
    e.runner.step_async, e.runner.step_multi = dispatch, block
    e.scheduler.discard_batch = drop
    return dict(entries=entries, discarded=discarded,
                first_id=e._next_seq_id)


def replay_in_sync(name, mode, llm, schedule, prompts, params, want):
    """A twin's dispatched batches again, in its order and composition, one
    synchronous step at a time through the sync engine's runner at the
    signature the twin ran it at, each step's input tokens from the host
    and its finishes checked on the host (length, EOS, stop tokens); a
    block's links one by one at the block's signature, without the rows
    that had finished by then; hole rows as dead rows in their places: the
    greedy streams must be the twin's. (Against the sync loop itself, bf16
    streams may part: the loops form other batches, a block runs at its
    last link's page bucket, and a row's bf16 result depends on its
    batch.)"""
    from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq
    from gllm_tpu_torch.sequence import HOLE_SEQ_ID, Sequence
    mm = llm.memory_manager
    hole = llm.scheduler._hole_seq
    seqs = {}
    skipped = steps = 0
    for batch, links, sig in schedule["entries"]:
        if any(batch is b for b in schedule["discarded"]):
            skipped += 1
            continue
        for rows in links:
            items = []
            for sid, before, n in rows:
                if sid == HOLE_SEQ_ID:
                    # a hole row stays a dead row in its place
                    items.append(ScheduledSeq(hole, 1, 0))
                    continue
                seq = seqs.get(sid)
                if seq is None:
                    i = sid - schedule["first_id"]
                    seq = seqs[sid] = Sequence(sid, prompts[i], params[i])
                    mm.prepare_seq(seq)
                if seq.finish_reason is not None:
                    continue              # dead in this link of a block
                mm.allocate_seq_pages(seq,
                                      before + n - seq.num_computed_tokens)
                items.append(ScheduledSeq(seq, n, before))
            if all(it.seq is hole for it in items):
                continue
            samples = [it.samples for it in items]
            tokens = llm.runner.step(ScheduledBatch(items),
                                     force_signature=sig)
            steps += 1
            for it, sampled, tok in zip(items, samples, tokens):
                seq = it.seq
                if seq is hole:
                    continue
                seq.num_computed_tokens = (it.computed_before
                                           + it.num_new_tokens)
                if sampled:
                    seq.append_token(int(tok))
                    seq.finish_reason = seq.check_finish(llm.eos_token_ids)
                    if seq.finish_reason is not None:
                        mm.free_seq(seq)
    got = [seqs[schedule["first_id"] + i].output_token_ids
           for i in range(len(prompts))]
    where = first_difference(got, want)
    if where is not None or got != want:
        raise SystemExit(
            f"[serve {name}] the {mode} twin's batches run one by one "
            f"give other greedy streams (first difference at request, "
            f"token {where})")
    assert mm.num_free_pages == mm.allocator.num_total, "KV pages leaked"
    log(f"[serve {name}] the {mode} twin's {len(schedule['entries'])} "
        f"dispatched entries ({skipped} discarded, skipped) run as {steps} "
        f"steps one by one through the sync engine (a block's links at its "
        f"signature), input tokens from the host: greedy streams identical "
        f"to the {mode} twin's")


def check_overlap(name, over, rates, streams, dispatches0):
    """The overlap twin against the sync graph engine: both medians and
    their ratio, whether the greedy streams are identical (the first
    difference if not), decode entries dispatched with another in flight
    on most of them, chain breaks and stalls by reason, rebuilds and
    divergences; returns those numbers."""
    where = first_difference(streams["graph"], streams["overlap"])
    if where is None:
        log(f"[serve {name}] overlap and sync-loop greedy streams identical")
    else:
        i, j = where
        log(f"[serve {name}] overlap and sync-loop greedy streams part at "
            f"request {i}, output token {j} (sync "
            f"{streams['graph'][i][j]}, overlap {streams['overlap'][i][j]}):"
            f" the loops run other batches")
    ratio = median(rates["overlap"]) / median(rates["graph"])
    dispatches = over.dispatches - dispatches0
    decode = {d: n for (kind, d), n in dispatches.items() if kind == "decode"}
    ahead = sum(n for d, n in decode.items() if d >= 2)
    n_decode = sum(decode.values())
    deepest = max(d for _, d in dispatches)
    log(f"[serve {name}] overlap median {median(rates['overlap']):.1f} "
        f"output tok/s, sync graph median {median(rates['graph']):.1f} "
        f"({ratio:.3f}x); dispatches by (kind, "
        f"in flight) {dict(sorted(dispatches.items()))}: {ahead} of "
        f"{n_decode} decode entries dispatched with another in flight, "
        f"largest in-flight count {deepest}; chain breaks "
        f"{dict(over.chain_breaks)}; stalls {dict(over.stalls)}; "
        f"futures.rebuilds {over.futures.rebuilds}, divergences "
        f"{over.futures.divergences}")
    assert ahead * 2 > n_decode, \
        f"[serve {name}] overlap ran ahead on {ahead} of {n_decode} decode " \
        f"dispatches only"
    mm = over.memory_manager
    assert not over._in_flight, "an entry was left in flight"
    assert mm.num_free_pages == mm.allocator.num_total, "KV pages leaked"
    if mm.use_ssm:
        assert mm.ssm_alloc.num_free == mm.ssm_alloc.num_total, \
            "SSM slots leaked"
    log(f"[serve {name}] overlap twin: no page or slot leaked, nothing "
        f"left in flight")
    return dict(ratio=ratio, same_as_sync=where is None,
                ahead=ahead, decode_dispatches=n_decode,
                deepest=deepest, chain_breaks=dict(over.chain_breaks),
                stalls=dict(over.stalls), rebuilds=over.futures.rebuilds,
                divergences=over.futures.divergences)


def block_twin(name, mode, llm, kv_dtype, kw, flags):
    """A twin of ``llm`` on its weights under ``flags`` (the multi or the
    slot twin: blocks of decode steps, or a hybrid model's single-step
    chains), TWIN_PAGES KV pages (a hybrid twin 16 GDN slots), its single
    steps and longest blocks captured at MULTI_BLOCK_BUCKETS; its memory
    by pool logged. A twin that does not fit beside the primary engine
    raises by name."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, SamplingParams
    extra = {"max_num_seqs": 16} if llm.runner.hybrid else {}
    t0 = time.monotonic()
    try:
        twin = LLM(model_cfg=llm.model_cfg, params=llm.runner.params,
                   config=EngineConfig(
                       load_format="dummy", dtype="bfloat16", seed=SEED,
                       cache=CacheConfig(kv_cache_dtype=kv_dtype,
                                         num_pages=TWIN_PAGES),
                       **flags, **kw, **extra))
        twin.generate(prompt_token_ids=[[1, 2, 3, 4]],
                      sampling_params=SamplingParams(
                          temperature=0.0, max_tokens=2, ignore_eos=True))
        twin.runner.warmup(decode_buckets=MULTI_BLOCK_BUCKETS,
                           block_buckets=MULTI_BLOCK_BUCKETS)
    except torch.OutOfMemoryError as e:
        raise SystemExit(
            f"[serve {name}] the {mode} twin does not fit beside the "
            f"primary engine ({TWIN_PAGES} KV pages): {e}; memory by pool: "
            f"{memory_breakdown(HOLDERS)}")
    g = twin.runner.graphs
    log(f"[serve {name}] {mode} twin on the same weights ({flags}, chain "
        f"length {twin.config.multi_step_decode}, blocks up to "
        f"{twin.runner.block_len}): {TWIN_PAGES} KV pages; built and warmed "
        f"in {time.monotonic() - t0:.2f} s: {len(g)} graphs "
        f"({sum(k[0] == 'block' for k in g.keys)} blocks, "
        f"{g.capture_seconds:.2f} s in capture), pool "
        f"{g.pool_bytes() / 2**20:.1f} MiB; memory by pool: "
        f"{memory_breakdown(HOLDERS)}")
    return twin


def twin_counts(e):
    """A multi or slot twin's counts, before its runs."""
    return dict(dispatches=e.dispatches.copy(), blocks=e.blocks.copy(),
                substeps=e.block_substeps, dead=e.dead_substeps,
                rows=e.row_substeps, chain_breaks=e.chain_breaks.copy(),
                stalls=e.stalls.copy(), joins=e.joins,
                holes=e.hole_substeps, compactions=e.compactions,
                absorbs=e.absorbs)


def check_multi(name, twin, mode, rates, streams, before):
    """The multi or slot twin (``mode``) against the sync graph, overlap
    and (for the slot twin) multi twins: medians and their ratios, whether
    its greedy streams equal the sync loop's, decode dispatches (single
    steps and blocks) and decoded sub-steps a run, blocks by K, entries
    dispatched ahead, dead row-sub-steps of the sequences' rows, chain
    breaks and stalls by reason, for the slot twin joins, hole
    row-sub-steps and compactions a run (and no break for a finish), and
    no page or slot leaked or entry left in flight; returns those
    numbers."""
    runs = len(rates[mode])
    med = median(rates[mode])
    where = first_difference(streams["graph"], streams[mode])
    if where is None:
        log(f"[serve {name}] {mode} and sync-loop greedy streams identical")
    else:
        i, j = where
        log(f"[serve {name}] {mode} and sync-loop greedy streams part at "
            f"request {i}, output token {j} (sync {streams['graph'][i][j]},"
            f" {mode} {streams[mode][i][j]}): the loops run other batches")
    dispatches = twin.dispatches - before["dispatches"]
    blocks = twin.blocks - before["blocks"]
    decode = sum(n for (kind, _), n in dispatches.items()
                 if kind in ("decode", "block"))
    ahead = sum(n for (kind, d), n in dispatches.items()
                if kind in ("decode", "block") and d >= 2)
    singles = sum(n for (kind, _), n in dispatches.items()
                  if kind == "decode")
    substeps = twin.block_substeps - before["substeps"]
    dead = twin.dead_substeps - before["dead"]
    breaks = dict(twin.chain_breaks - before["chain_breaks"])
    absorbs = twin.absorbs - before["absorbs"]
    mixed_ahead = sum(n for (kind, d), n in dispatches.items()
                      if kind == "mixed" and d >= 2)
    ratios = {other: med / median(rates[other])
              for other in ("graph", "overlap", "multi")
              if other != mode and rates[other]}
    out = dict(ratios=ratios, same_as_sync=where is None,
               decode_dispatches_a_run=decode / runs,
               substeps_a_run=(singles + substeps) / runs,
               blocks_by_k={k: n / runs for k, n in sorted(blocks.items())},
               ahead=ahead, decode_dispatches=decode,
               dead_share=dead / max(1, twin.row_substeps - before["rows"]),
               chain_breaks=breaks,
               stalls=dict(twin.stalls - before["stalls"]),
               rebuilds=twin.futures.rebuilds,
               joins_a_run=(twin.joins - before["joins"]) / runs,
               holes_a_run=(twin.hole_substeps - before["holes"]) / runs,
               compactions_a_run=(twin.compactions
                                  - before["compactions"]) / runs,
               absorbs_a_run=absorbs / runs,
               mixed_ahead_a_run=mixed_ahead / runs)
    log(f"[serve {name}] {mode} median {med:.1f} output tok/s: "
        + ", ".join(f"{r:.3f}x the {other} median"
                    for other, r in ratios.items())
        + f"; a run: {out['decode_dispatches_a_run']:.1f} decode dispatches "
        f"({singles / runs:.1f} single steps, {sum(blocks.values()) / runs:.1f}"
        f" blocks), {out['substeps_a_run']:.1f} decoded sub-steps; blocks "
        f"by K a run {out['blocks_by_k']}; {ahead} of {decode} decode "
        f"dispatches with another in flight; dead row-sub-steps "
        f"{dead} ({100 * out['dead_share']:.1f}% of the sequences' rows); "
        f"joins {out['joins_a_run']:.1f}, hole row-sub-steps "
        f"{out['holes_a_run']:.1f}, compactions "
        f"{out['compactions_a_run']:.1f} a run; absorbs (mixed re-forms) "
        f"{out['absorbs_a_run']:.1f} and mixed entries dispatched with "
        f"another in flight {out['mixed_ahead_a_run']:.1f} a run; chain "
        f"breaks {breaks} ({runs} runs); stalls {out['stalls']}; rebuilds "
        f"{out['rebuilds']}")
    g = twin.runner.graphs
    log(f"[serve {name}] {mode} twin after its runs: {len(g)} graphs "
        f"({sum(k[0] == 'block' for k in g.keys)} blocks, keys by K "
        f"{block_keys(g)}), {g.capture_seconds:.2f} s in capture, pool "
        f"{g.pool_bytes() / 2**20:.1f} MiB")
    if not twin.runner.hybrid:
        assert sum(blocks.values()) > 0, \
            f"[serve {name}] {mode}: no block formed"
    if twin.config.decode_slot_batching:
        assert not breaks.get("finish"), \
            f"[serve {name}] {mode}: a finish broke a chain: {breaks}"
        assert twin.scheduler._hole_seq.num_in_flight == 0, \
            f"[serve {name}] {mode}: a hole row left in flight"
    if twin.unified:
        assert not breaks.get("waiting"), \
            f"[serve {name}] {mode}: a chain broke with 'waiting': {breaks}"
    mm = twin.memory_manager
    assert not twin._in_flight, "an entry was left in flight"
    assert mm.num_free_pages == mm.allocator.num_total, "KV pages leaked"
    if mm.use_ssm:
        assert mm.ssm_alloc.num_free == mm.ssm_alloc.num_total, \
            "SSM slots leaked"
    log(f"[serve {name}] {mode} twin: no page or slot leaked, nothing left "
        f"in flight")
    return out


def stop_token_run(name, llm, twin, mode, prompts, graph_streams):
    """Each request stops at a token of its greedy stream (from the sync
    graph engine's) from output 16 on, the first there that the stream
    has not sampled before, so that the stream reaches it there: every
    request (32 to 122 tokens) stops at about a quarter to half of its
    output, inside the ``mode`` twin's blocks (the multi or the slot
    twin; in the slot twin a row that finished rides on as a hole). Two
    passes: the 16 requests,
    then the first that stops alone (a block dispatched ahead of a finish
    keeps the finished row alive, as the host does, so among many rows an
    early exit is rare; alone, the row's block stops at its stop token).
    Some block must exit early (executed sub-steps below its K) and each
    pass's streams must be the sync engine's (or, where bf16 batches part
    them, its own batches run one by one through the sync engine); prints
    the dead share, the finishes by kind and, for the slot twin, the hole
    row-sub-steps and joins (a finish must break no chain there)."""
    from gllm_tpu_torch import SamplingParams

    def stop(s):
        fresh = [j for j in range(1, len(s)) if s[j] not in s[:j]]
        later = [j for j in fresh if j >= min(16, len(s) // 2)]
        return [s[(later or fresh)[0]]] if fresh else []
    sps = [SamplingParams(temperature=0.0, max_tokens=len(s),
                          stop_token_ids=stop(s)) for s in graph_streams]
    first = next(i for i, sp in enumerate(sps) if sp.stop_token_ids)
    out = {}
    early = 0
    for tag, idx in (("16 requests", range(len(prompts))),
                     ("one request", [first])):
        ps = [prompts[i] for i in idx]
        pass_sps = [dataclasses.replace(sps[i]) for i in idx]
        want = [o.output_token_ids for o in llm.generate(
            prompt_token_ids=ps, sampling_params=pass_sps)]
        runs = []
        stats = twin._block_stats
        twin._block_stats = lambda chain, finish: (
            runs.append((len(chain),
                         int(finish[:chain[0].num_seqs].max()))),
            stats(chain, finish))[1]
        finishes0 = twin.ondevice_finishes.copy()
        dead0, rows0 = twin.dead_substeps, twin.row_substeps
        holes0, joins0 = twin.hole_substeps, twin.joins
        breaks0 = twin.chain_breaks.copy()
        schedule = record_schedule(twin)
        try:
            got = [o.output_token_ids for o in twin.generate(
                prompt_token_ids=ps, sampling_params=pass_sps)]
        finally:
            del twin._block_stats, twin.runner.step_async
            del twin.runner.step_multi, twin.scheduler.discard_batch
        n_early = sum(e < k for k, e in runs)
        early += n_early
        dead = twin.dead_substeps - dead0
        share = dead / max(1, twin.row_substeps - rows0)
        finishes = dict(twin.ondevice_finishes - finishes0)
        breaks = dict(twin.chain_breaks - breaks0)
        where = first_difference(got, want)
        stopped = sum(len(g) < len(graph_streams[i])
                      for g, i in zip(got, idx))
        log(f"[serve {name}] {mode} stop-token run, {tag}: "
            f"{sum(len(t) for t in got)} tokens, {stopped} of {len(got)} "
            f"requests stopped early; {len(runs)} blocks, {n_early} exited "
            f"early (K, executed: {runs}); dead row-sub-steps {dead} "
            f"({100 * share:.1f}%); hole row-sub-steps "
            f"{twin.hole_substeps - holes0}, joins {twin.joins - joins0}; "
            f"chain breaks {breaks}; finishes out of blocks by kind "
            f"{finishes}; streams "
            + ("identical to the sync engine's" if where is None
               and got == want else
               f"part from the sync engine's at (request, token) {where}"))
        if where is not None or got != want:
            # bf16: the loops run other batches (see replay_in_sync)
            replay_in_sync(name, f"{mode} (stop-token run, {tag})", llm,
                           schedule, ps, pass_sps, got)
        mm = twin.memory_manager
        assert not twin._in_flight and \
            mm.num_free_pages == mm.allocator.num_total, "KV pages leaked"
        if twin.config.decode_slot_batching:
            assert not breaks.get("finish"), \
                f"[serve {name}] {mode} stop-token run: a finish broke a " \
                f"chain: {breaks}"
        out[tag] = dict(blocks=len(runs), early=n_early, dead_share=share,
                        finishes=finishes, same_as_sync=where is None,
                        stopped=stopped, chain_breaks=breaks,
                        holes=twin.hole_substeps - holes0,
                        joins=twin.joins - joins0)
    assert early > 0, \
        f"[serve {name}] {mode} stop-token run: no block exited early"
    return out


def staggered_generate(llm, prompts, params, first=STAGGER_FIRST,
                       every=STAGGER_EVERY, more=STAGGER_MORE):
    """Serve ``prompts`` with arrivals keyed to committed output tokens,
    not to loop iterations, so that every engine sees them at the same
    points of the output: ``first`` requests at start, then ``more`` each
    time another ``every`` output tokens have committed (the next ones at
    once when the engine runs dry). Returns the requests' streams."""
    seqs = [llm._allocate_seq(list(p), dataclasses.replace(sp))
            for p, sp in zip(prompts, params)]
    added, due = 0, every

    def add(n):
        nonlocal added
        for s in seqs[added:added + n]:
            llm.add_seq(s)
        added = min(len(seqs), added + n)
    add(first)
    while llm.has_unfinished or added < len(seqs):
        if not llm.has_unfinished:
            add(more)
        llm.step()
        done = sum(s.num_output_tokens for s in seqs[:added])
        while added < len(seqs) and done >= due:
            add(more)
            due += every
    return [s.output_token_ids for s in seqs]


def staggered_runs(name, llm, twin, mode, prompts, params):
    """The staggered-arrival run (``staggered_generate``) by the sync graph
    engine and ``twin`` (the slot or the absorb twin), in the order graph,
    twin, twin, graph: each engine's two runs must give the same streams,
    every request exactly its max_tokens, the twin's second run its own
    batches replayed; prints and returns the medians and their ratio, and
    the twin's decoded sub-steps, breaks by reason and absorbs a run."""
    rates = {"graph": [], mode: []}
    streams = {}
    before = twin_counts(twin)
    steps0 = dict(llm.step_counts)
    schedule = None
    for e in (llm, twin, twin, llm):
        m = "graph" if e is llm else mode
        if e is twin and m in streams:
            schedule = record_schedule(twin)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        toks = staggered_generate(e, prompts, params)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if schedule is not None and e is twin:
            del e.runner.step_async, e.runner.step_multi
            del e.scheduler.discard_batch
        n_out = sum(len(t) for t in toks)
        rates[m].append(n_out / wall)
        log(f"[serve {name}] staggered run ({m}): {n_out} tokens in "
            f"{wall:.3f} s = {n_out / wall:.1f} output tok/s")
        assert [len(t) for t in toks] == [sp.max_tokens for sp in params]
        assert streams.setdefault(m, toks) == toks, \
            f"[serve {name}] two staggered {m} runs gave different streams"
    sync_steps = {k: (llm.step_counts[k] - steps0[k]) / 2 for k in steps0}
    replay_in_sync(name, f"{mode} (staggered)", llm, schedule, prompts,
                   params, streams[mode])
    d = twin.dispatches - before["dispatches"]
    breaks = dict(twin.chain_breaks - before["chain_breaks"])
    out = dict(sync_steps_a_run=sync_steps,
        ratio=median(rates[mode]) / median(rates["graph"]),
        graph_rates=rates["graph"], rates=rates[mode],
        same_as_sync=streams[mode] == streams["graph"],
        substeps_a_run=(sum(n for (k, _), n in d.items() if k == "decode")
                        + twin.block_substeps - before["substeps"]) / 2,
        dispatches_a_run={k: n / 2 for k, n in sorted(d.items())},
        chain_breaks=breaks, absorbs_a_run=(twin.absorbs
                                            - before["absorbs"]) / 2,
        joins_a_run=(twin.joins - before["joins"]) / 2,
        stalls=dict(twin.stalls - before["stalls"]))
    log(f"[serve {name}] staggered arrivals ({STAGGER_FIRST} at start, "
        f"{STAGGER_MORE} more each {STAGGER_EVERY} output tokens): {mode} "
        f"median {median(rates[mode]):.1f}, sync graph median "
        f"{median(rates['graph']):.1f} output tok/s ({out['ratio']:.3f}x);"
        f" sync graph steps a run {sync_steps};"
        f" {mode} a run: {out['substeps_a_run']:.1f} decoded sub-steps, "
        f"absorbs {out['absorbs_a_run']:.1f}, joins {out['joins_a_run']:.1f}"
        f"; dispatches by (kind, in flight) a run "
        f"{out['dispatches_a_run']}; chain breaks {breaks} (2 runs); stalls"
        f" {out['stalls']}; streams "
        + ("identical to the sync engine's" if out["same_as_sync"] else
           "part from the sync engine's (other batches)"))
    if twin.unified:
        assert out["absorbs_a_run"] > 0, \
            f"[serve {name}] the staggered run absorbed nothing"
        assert not breaks.get("waiting"), \
            f"[serve {name}] a chain broke with 'waiting': {breaks}"
    mm = twin.memory_manager
    assert not twin._in_flight and \
        mm.num_free_pages == mm.allocator.num_total, "KV pages leaked"
    return out


def phase_serve():
    results = {}
    names = list(SERVE)
    weights = None
    for i, name in enumerate(names):
        model = SERVE[name][0]
        t0 = time.monotonic()
        results[name], params = serve(name, *SERVE[name], params=weights)
        # keep the weights only for the next engine of the same model
        nxt = SERVE[names[i + 1]][0] if i + 1 < len(names) else None
        weights = params if model in REUSE_WEIGHTS and nxt is model else None
        del params
        log(f"[serve {name}] phase wall {time.monotonic() - t0:.1f} s")
    ratio = results["int8"]["pages"] / results["bf16"]["pages"]
    log(f"[serve] KV pages from the same memory_util: bf16 "
        f"{results['bf16']['pages']}, int8 {results['int8']['pages']} "
        f"({ratio:.3f}x)")
    assert ratio >= 1.8, "int8 should give at least 1.8x the pages of bf16"
    for fp8, twin in FP8_SERVE_TWINS.items():
        ratio = results[fp8]["pages"] / results[twin]["pages"]
        log(f"[serve] KV pages from the same memory_util: {twin} "
            f"{results[twin]['pages']}, {fp8} {results[fp8]['pages']} "
            f"({ratio:.3f}x)")
        assert ratio >= 1.9, f"{fp8} should give about 2x the pages of {twin}"
    log("[serve] summary: config, graph tok/s runs, eager tok/s runs, "
        "overlap tok/s runs, multi tok/s runs, slot tok/s runs, absorb "
        "tok/s runs, graphs, warmup s, capture s, pool MiB, KV pages")
    for name, r in results.items():
        log(f"[serve] {name}: {r['rates']} {r['eager_rates']} "
            f"{r['overlap_rates']} {r['multi_rates']} {r['slot_rates']} "
            f"{r['absorb_rates']} {r['graphs']} "
            f"{r['warm_s']:.3f} {r['capture_s']:.3f} {r['pool_mib']:.1f} "
            f"{r['pages']}")
    return results


# host calls that put work on the card (or copy to or from it); a graph
# replay is one cudaGraphLaunch
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemcpy", "cudaMemsetAsync")


def profile_window(llm, name, staggered=False):
    """Where a serving step's time goes: torch.profiler over a short
    window (8 requests of 512 prompt tokens, 24 greedy tokens each, the
    same prompts for every engine, all at once or, ``staggered``, 2 at
    start and 2 more each time another 16 output tokens commit; run once
    unprofiled first so that no graph is captured inside it): mixed
    entries dispatched with another in flight, device time by kernel, the
    device's
    busy share of the wall, kernels per step, host calls that launch work
    per dispatched decode entry (each dispatch marked with a
    record_function range), the dispatches' share of the wall by kind and
    the share spent waiting in ``collect`` (each wait marked too)."""
    from bisect import bisect_right
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from gllm_tpu_torch import SamplingParams
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, llm.model_cfg.vocab_size, 512).tolist()
               for _ in range(8)]
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)

    def serve_window():
        if staggered:
            staggered_generate(llm, prompts, [sp] * len(prompts), first=2,
                               every=16, more=2)
        else:
            llm.generate(prompt_token_ids=prompts, sampling_params=sp)
    # a pass before the profiled one: the window's decode signatures are
    # captured there, not inside the window
    serve_window()
    steps0 = dict(llm.step_counts)
    dispatches0 = llm.dispatches.copy()
    substeps0 = llm.runner.block_counts["substeps"]
    runner = llm.runner
    step_async, step_multi = runner.step_async, runner.step_multi
    collect = runner.collect

    def marked(batch, prev=None, **kw):
        kind = ("decode" if all(it.num_new_tokens == 1 for it in batch.items)
                else "mixed")
        with record_function("gllm_step_" + kind):
            return step_async(batch, prev, **kw)

    def marked_block(chain, prev=None):
        with record_function("gllm_step_block"):
            return step_multi(chain, prev)

    def waited(handle):
        with record_function("gllm_collect"):
            return collect(handle)
    runner.step_async, runner.step_multi = marked, marked_block
    runner.collect = waited
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            serve_window()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    finally:
        del runner.step_async, runner.step_multi, runner.collect
    steps = {k: llm.step_counts[k] - steps0[k] for k in steps0}
    # a block's executed sub-steps are decode steps too
    steps["substeps"] = runner.block_counts["substeps"] - substeps0
    mixed_ahead = sum(n for (kind, d), n in (llm.dispatches
                                             - dispatches0).items()
                      if kind == "mixed" and d >= 2)
    tag = f"[profile {name}]"
    # kernels only: a CPU op's device time repeats its kernels' times, and
    # so does the device side of the record_function ranges
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("gllm_")), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"{tag} 8 x (512 prompt + 24 out) tokens"
        + (", staggered" if staggered else "") + f", steps {steps} "
        f"({mixed_ahead} mixed dispatched with another in flight): wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}% of wall); kernels by device time:")
    for dev_us, count, key in rows[:12]:
        log(f"{tag}   {100 * dev_us / busy:5.1f}%  {dev_us / 1e3:8.3f} ms"
            f"  x{count:<5d} {key[:90]}")
    # the host side: kernels issued per step, host calls that launch work
    # per decode step, and host time by operator (self time, inflated by
    # the profiler's own cost per op)
    n_steps = sum(steps.values())
    events = prof.events()
    spans = {k: sorted((e.time_range.start, e.time_range.end)
                       for e in events if e.name == name
                       and e.device_type == DeviceType.CPU)
             for k, name in (("decode", "gllm_step_decode"),
                             ("block", "gllm_step_block"),
                             ("mixed", "gllm_step_mixed"),
                             ("collect", "gllm_collect"))}
    decode_spans = sorted(spans["decode"] + spans["block"])
    starts = [a for a, _ in decode_spans]
    calls = {}
    for e in events:
        if e.name in LAUNCH_CALLS:
            i = bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start <= decode_spans[i][1]:
                calls[e.name] = calls.get(e.name, 0) + 1
    n_dec = max(1, len(decode_spans))
    n_sub = max(1, steps["decode"] + steps["substeps"])
    share = {k: sum(b - a for a, b in v) / wall_us for k, v in spans.items()}
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    host_us = sum(r[0] for r in host)
    kernels_per_step = sum(r[1] for r in rows) / n_steps
    launches = sum(calls.values()) / n_dec
    per_sub = sum(calls.values()) / n_sub
    log(f"{tag} {kernels_per_step:.0f} kernels per step (a block's "
        f"sub-steps counted); {launches:.2f} host launch calls per "
        f"dispatched decode entry, {per_sub:.2f} per decoded sub-step "
        f"({calls}); dispatches' share of the wall: decode "
        f"{100 * share['decode']:.1f}%, blocks {100 * share['block']:.1f}%,"
        f" mixed {100 * share['mixed']:.1f}%; "
        f"waiting in collect {100 * share['collect']:.1f}% of the wall; "
        f"host self time {host_us / 1e3:.1f} ms "
        f"({100 * host_us / wall_us:.1f}% of wall), by operator:")
    for cpu_us, count, key in host[:10]:
        log(f"{tag}   {100 * cpu_us / host_us:5.1f}%  {cpu_us / 1e3:8.3f}"
            f" ms  x{count:<6d} {key[:60]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / wall_us, kernels_per_step=kernels_per_step,
                launches_per_decode_step=launches,
                launches_per_substep=per_sub, share=share,
                host_share=host_us / wall_us, steps=steps,
                mixed_ahead=mixed_ahead)


# ---- 5. reference --------------------------------------------------------

def phase_reference():
    """Depth-cut models at float32: the port on the card (CUDA kernels)
    against the port on the CPU (plain versions), same weights: Llama with
    a float32 cache, an int8 cache, the unified step and an fp8 cache,
    DeepSeek (one dense layer, one MoE layer) at the MLA kernels' small
    latent geometry, also under the unified step and over an fp8 latent,
    and one period of Qwen3-Next (K3 at Dk = Dv = 32, K1 / K2 at head_dim
    128), also over an fp8 cache. Each must launch exactly its kernels on
    the card."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, \
        SamplingParams, SchedulerConfig
    from gllm_tpu_torch.models import deepseek, dense, hybrid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    llama = llama_3_2_1b(num_layers=2)
    ds = deepseek_v2_lite(num_hidden_layers=2, hidden_size=256,
                          intermediate_size=512, kv_lora_rank=64,
                          qk_nope_head_dim=32, qk_rope_head_dim=32,
                          v_head_dim=32, n_routed_experts=8,
                          num_experts_per_tok=2, moe_intermediate_size=128)
    qn = qwen3_next(num_hidden_layers=4, hidden_size=256,
                    num_attention_heads=4, num_key_value_heads=2,
                    head_dim=128, linear_num_key_heads=2,
                    linear_num_value_heads=4, linear_key_head_dim=32,
                    linear_value_head_dim=32, num_experts=2,
                    num_experts_per_tok=1, moe_intermediate_size=128,
                    shared_expert_intermediate_size=128)
    weights = {"llama": dense.init_params(llama, SEED, torch.float32, "cuda"),
               "deepseek": deepseek.init_params(ds, SEED, torch.float32,
                                                "cuda"),
               "qwen3_next": hybrid.init_params(qn, SEED, torch.float32,
                                                "cuda")}
    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)

    def on(params, device):
        return {g: ({k: v.to(device) for k, v in x.items()}
                    if isinstance(x, dict) else x.to(device))
                for g, x in params.items()}

    def engine(cfg, p, device, kv_cache_dtype, unified, **flags):
        ec = EngineConfig(dtype="float32", seed=SEED, max_model_len=512,
                          unified_step=unified,
                          scheduler=SchedulerConfig(max_prefill_tokens=64),
                          cache=CacheConfig(num_pages=128,
                                            kv_cache_dtype=kv_cache_dtype),
                          **flags)
        return LLM(model_cfg=cfg, config=ec, params=p, device=device)

    dsl, qnl = ("deepseek (latent 64+32, 16 heads)",
                "qwen3_next (1 period, GDN 32/32, head_dim 128)")
    for label, cfg, params, kv_dtype, unified, kernels in (
            ("float32 cache", llama, weights["llama"], "auto", False,
             {"ragged_paged_attention", "paged_decode_attention"}),
            ("int8 cache", llama, weights["llama"], "int8", False,
             {"ragged_paged_attention_int8", "paged_decode_attention_int8"}),
            ("unified step", llama, weights["llama"], "auto", True,
             {"ragged_paged_attention_unified"}),
            ("fp8 cache", llama, weights["llama"], "fp8", False,
             {"ragged_paged_attention_fp8", "paged_decode_attention_fp8"}),
            (dsl, ds, weights["deepseek"], "auto", False,
             {"ragged_paged_attention_mla", "paged_decode_attention_mla"}),
            (dsl + ", unified step", ds, weights["deepseek"], "auto", True,
             {"ragged_paged_attention_unified_mla"}),
            (dsl + ", fp8 latent", ds, weights["deepseek"], "fp8", False,
             {"ragged_paged_attention_mla_fp8",
              "paged_decode_attention_mla_fp8"}),
            (qnl, qn, weights["qwen3_next"], "auto", False,
             {"gdn_chunk_scan", "ragged_paged_attention",
              "paged_decode_attention"}),
            (qnl + ", fp8 cache", qn, weights["qwen3_next"], "fp8", False,
             {"gdn_chunk_scan", "ragged_paged_attention_fp8",
              "paged_decode_attention_fp8"})):
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in (40, 75, 130)]
        logits, toks = [], []
        reset_counters()
        # the card's engine replays its decode steps as CUDA graphs; the
        # dense, unified, MLA and hybrid cases also run an eager one, the
        # legacy dense, MLA and hybrid ones an overlap engine (the
        # pipelined loop), and the legacy dense and MLA ones a multi
        # engine (blocks under on-device finish)
        engines = [engine(cfg, params, "cuda", kv_dtype, unified),
                   engine(cfg, on(params, "cpu"), "cpu", kv_dtype, unified)]
        kinds = []
        for kind, labels, flags in (
                ("eager", ("float32 cache", "unified step", dsl,
                           dsl + ", unified step", qnl),
                 dict(enforce_eager=True)),
                ("overlap", ("float32 cache", dsl, qnl),
                 dict(pipelined_loop=True)),
                ("multi", ("float32 cache", dsl),
                 dict(pipelined_loop=True, ondevice_finish=True)),
                ("slot", ("float32 cache", dsl, qnl),
                 dict(pipelined_loop=True, ondevice_finish=True,
                      decode_slot_batching=True, chain_under_prefill=8))):
            if label in labels:
                kinds.append(kind)
                engines.append(engine(cfg, params, "cuda", kv_dtype,
                                      unified, **flags))
        for llm in engines:
            seqs = [llm._allocate_seq(p, sp) for p in prompts]
            for seq in seqs:
                llm.add_seq(seq)
            # first step by hand, to read its logits: greedy = argmax
            batch = llm.scheduler.schedule_once()
            dev_batch, max_q = llm.runner.prepare(batch)
            out = llm.runner.forward_logits(dev_batch,
                                            max_q)[:batch.num_seqs]
            logits.append(out.cpu())
            llm.scheduler.process_output(batch, out.argmax(-1).tolist(),
                                         llm.eos_token_ids)
            while llm.has_unfinished:
                llm.step()
            toks.append([seq.output_token_ids for seq in seqs])
        err = (logits[0] - logits[1]).abs().max().item()
        scale = logits[1].abs().max().item()
        counts = read_counters()
        graphed = engines[0].runner
        log(f"[reference] {cfg.num_layers}-layer f32, {label}: first step "
            f"(chunked "
            f"prefill) logits max_abs_err {err} of max |logit| {scale}; "
            f"greedy tokens identical: {toks[0] == toks[1]}"
            + "".join(f", card {kind} engine too: {t == toks[1]}"
                      + (f" ({sum(e.blocks.values())} blocks)"
                         if kind in ("multi", "slot") else "")
                      for kind, t, e in zip(kinds, toks[2:], engines[2:]))
            + f"; {graphed.graphs.replays} decode graph replays "
            f"({graphed.num_shape_signatures} graphs); card launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        assert err <= 1e-3 * max(scale, 1.0), \
            f"[reference] {label}: card and CPU logits disagree"
        assert toks[0] == toks[1], \
            f"[reference] {label}: card and CPU greedy tokens differ"
        assert all(t == toks[1] for t in toks[2:]), \
            f"[reference] {label}: the card's {kinds} engines differ"
        for kind, e in zip(kinds, engines[2:]):
            if kind == "multi" or (kind == "slot" and not e.runner.hybrid):
                assert sum(e.blocks.values()) > 0, \
                    f"[reference] {label}: the {kind} engine formed no block"
        assert graphed.graphs.replays == graphed.step_counts["decode"] > 0
        assert all(len(t) == 8 for t in toks[0])
        launched = {k for k, n in counts.items() if n and k != "plain_calls"}
        assert launched == kernels, \
            f"[reference] {label}: the card launched {launched}"


# ---- 6. http -------------------------------------------------------------

# the server's engine: the smoke's absorb twin (the unified step under
# overlap, persistent slots, blocks of 16 under on-device finish), bf16,
# prefix caching off (the default)
HTTP_FLAGS = ("--pipelined-loop", "--unified-step", "--decode-slot-batching",
              "--ondevice-finish")
# Llama-3.2-1B's published config.json, at the widths llama_3_2_1b()
# spells out
HTTP_CONFIG = dict(
    architectures=["LlamaForCausalLM"], vocab_size=128256, hidden_size=2048,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    head_dim=64, intermediate_size=8192, max_position_embeddings=4096,
    rope_theta=500000.0, tie_word_embeddings=True, bos_token_id=128000,
    eos_token_id=[128001, 128008, 128009], torch_dtype="bfloat16")
HTTP_CONCURRENCY, HTTP_RATE = 16, 8.0
HTTP_STARTUP_S, HTTP_STOP_S = 240.0, 30.0
# passes of the http traffic at most, until one captures no graph
HTTP_PASSES = 4


def _get(port, path, timeout=30.0):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _post(port, path, body, timeout=300.0):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _scrape(port):
    from gllm_tpu_torch.obs.metrics import parse_exposition
    status, body = _get(port, "/metrics")
    assert status == 200, f"[http] /metrics answered {status}"
    typed, samples, dupes = parse_exposition(body.decode())
    assert not dupes, f"[http] /metrics repeats {dupes[:3]}"
    return samples


def _delta(after, before, name, labels=""):
    return (after.get((name, labels), 0.0)
            - before.get((name, labels), 0.0))


def _hist_quantile(after, before, name, q):
    """The q-quantile of a histogram's observations between two scrapes,
    interpolated in its bucket as ``obs.metrics.percentile`` does."""
    bounds, cum = [], []
    for (sname, lbl), v in after.items():
        if sname == name + "_bucket":
            le = lbl.split('le="')[1].rstrip('"}')
            bounds.append(float("inf") if le == "+Inf" else float(le))
            cum.append(v - before.get((sname, lbl), 0.0))
    order = sorted(range(len(bounds)), key=bounds.__getitem__)
    bounds = [bounds[i] for i in order]
    cum = [cum[i] for i in order]
    count = cum[-1] if cum else 0
    if count <= 0:
        return None
    target, prev, lo = q * count, 0.0, 0.0
    for ub, c in zip(bounds, cum):
        n = c - prev
        if c >= target and n > 0:
            hi = ub if ub != float("inf") else lo
            return lo + (hi - lo) * (target - prev) / n
        prev, lo = c, ub if ub != float("inf") else lo
    return lo


def _abort_after(port, payload, chunks=4):
    """A stream that the client closes after ``chunks`` events."""
    import socket
    body = json.dumps(dict(payload, stream=True)).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        buf = b""
        while buf.count(b"data: ") < chunks:
            got = sock.recv(65536)
            assert got, "[http] the stream ended before it was closed"
            buf += got
    finally:
        sock.close()


def _pass(port, payloads, label):
    """One run of ``payloads`` through run_requests (concurrency 16,
    Poisson 8 req/s, seeded): every request must finish with its count.
    Returns the client summary, the wall, and the scrapes and server
    info before and after."""
    from benchmarks.backend_request_func import run_requests, summarize
    m0, info0 = _scrape(port), json.loads(_get(port, "/server_info")[1])
    results, wall = run_requests("127.0.0.1", port, payloads,
                                 HTTP_CONCURRENCY, HTTP_RATE, seed=SEED)
    m1, info1 = _scrape(port), json.loads(_get(port, "/server_info")[1])
    bad = [(i, r.error, r.output_tokens, p["max_tokens"])
           for i, (r, p) in enumerate(zip(results, payloads))
           if not r.success or r.output_tokens != p["max_tokens"]]
    assert not bad, f"[http] {label}: requests short of their counts: {bad}"
    summary = summarize(results, wall)
    e0, e1 = info0["engine_counters"], info1["engine_counters"]
    k0, k1 = info0["kernel_launches"], info1["kernel_launches"]
    launched = {k: n - k0["kernels"].get(k, 0)
                for k, n in k1["kernels"].items()
                if n - k0["kernels"].get(k, 0)}
    assert set(launched) == {"ragged_paged_attention_unified"}, \
        f"[http] {label}: the run launched {launched}"
    assert k1["plain_calls"] == k0["plain_calls"], \
        f"[http] {label}: the run called a plain version"
    steps = {lbl: _delta(m1, m0, name, lbl) for name, lbl in m1
             if name == "gllm_steps_total"}
    breaks = {lbl: _delta(m1, m0, name, lbl) for name, lbl in m1
              if name == "gllm_chain_breaks_total"
              and _delta(m1, m0, name, lbl)}
    server = {f"p{int(q * 100)}": {
        h: _hist_quantile(m1, m0, f"gllm_request_{h}_seconds", q)
        for h in ("ttft", "tpot", "itl")} for q in (0.5, 0.99)}
    out = {"output_tok_s": summary["output_tok_s"], "wall_s": wall,
           "output_tokens": summary["output_tokens"],
           "client_ms": {k: summary[k] for k in ("ttft_ms", "tpot_ms",
                                                 "itl_ms", "e2e_ms")},
           "server_ms": {p: {h: None if v is None else round(v * 1e3, 3)
                             for h, v in hs.items()}
                         for p, hs in server.items()},
           "launches": launched, "steps": steps,
           "absorbs": e1["absorbs"] - e0["absorbs"],
           "block_substeps": e1["block_substeps"] - e0["block_substeps"],
           "graphs_captured": e1["graphs"] - e0["graphs"],
           "capture_s": round(e1["capture_s"] - e0["capture_s"], 3),
           "chain_breaks": breaks}
    # every line of the pass says whether capture stalls are in it
    label = (f"{label} ({out['graphs_captured']} graphs captured in "
             f"{out['capture_s']} s)")
    log(f"[http] {label}: {len(payloads)} streams at concurrency "
        f"{HTTP_CONCURRENCY}, Poisson {HTTP_RATE} req/s, on {SMI}: "
        f"{summary['output_tokens']} output tokens in {wall:.3f} s, "
        f"{summary['output_tok_s']} output tok/s")
    for key in ("ttft_ms", "tpot_ms", "itl_ms", "e2e_ms"):
        log(f"[http] {label}: client {key} {summary[key]} on {SMI}")
    for p, hs in server.items():
        log(f"[http] {label}: server {p} ms (histogram buckets): "
            + ", ".join(f"{h} {v * 1e3:.3f}" if v is not None
                        else f"{h} none" for h, v in hs.items())
            + f" on {SMI}")
    log(f"[http] {label}: launches {launched}; steps by kind {steps}; "
        f"block sub-steps {out['block_substeps']}; absorbs "
        f"{out['absorbs']} (/server_info); chain breaks {breaks} "
        "(/metrics)")
    return out


def phase_http(served):
    """The port's OpenAI server as users start it, in a process of its
    own: Llama-3.2-1B at full width (config.json written here, dummy bf16
    weights from seed 0) under the absorb twin's flags, driven over HTTP by
    benchmarks/backend_request_func.run_requests: 32 streamed greedy
    requests (the serve phase's 16 prompts twice) at concurrency 16 with
    Poisson arrivals at 8 req/s, in passes until one captures no CUDA
    graph (at most HTTP_PASSES: a block key that the server's warmup left
    out is captured the first time it is met, stalling every stream), then
    one whole request, one of n = 2 and one stream the client closes after
    4 chunks. Each pass is labelled with the graphs it captured; the
    first pass that captured none is the one free of capture stalls, and
    if none is, the phase says so (it does not fail). Every request
    finishes with its count, /metrics agrees with the client, the aborted
    stream leaves no page held, K1u served every step, and SIGTERM ends
    the server. The server's log goes to
    build/http_model/server.log."""
    import os
    import signal
    import threading
    from gllm_tpu_torch.runner.runner import reclaim_driver_memory
    # the server's KV pool is sized from the card's free memory: this
    # process gives back what it can
    gc.collect()
    torch.cuda.empty_cache()
    reclaim_driver_memory(torch.device("cuda"))
    log(f"[http] {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free "
        "before the server starts")
    model_dir = os.path.join("build", "http_model")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(HTTP_CONFIG, f)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 1537, 16)
    max_tokens = rng.integers(32, 129, 16)
    prompts = [rng.integers(1, HTTP_CONFIG["vocab_size"], int(n)).tolist()
               for n in lens]
    payloads = [{"prompt": p, "max_tokens": int(m), "temperature": 0.0,
                 "ignore_eos": True}
                for p, m in list(zip(prompts, max_tokens)) * 2]
    cmd = [sys.executable, "-m", "gllm_tpu_torch.entrypoints.api_server",
           "--model", model_dir, "--load-format", "dummy", "--dtype",
           "bfloat16", "--seed", str(SEED), "--host", "127.0.0.1",
           "--port", "0", *HTTP_FLAGS]
    log(f"[http] {' '.join(cmd[1:])}")
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines, bound, port = [], threading.Event(), []
    server_log = open(os.path.join(model_dir, "server.log"), "w")

    def read():
        # the server's log, kept; it must be drained or the server blocks
        # on a full pipe
        for line in proc.stderr:
            lines.append(line)
            server_log.write(line)
            m = re.search(r"serving \S+ on 127\.0\.0\.1:(\d+)", line)
            if m and not port:
                port.append(int(m.group(1)))
                bound.set()
            if ("[startup]" in line or "Error" in line
                    or "captured while serving" in line):
                log(f"[http] server: {line.rstrip()}")
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        while not bound.wait(1.0):
            assert proc.poll() is None, \
                "[http] the server exited:\n" + "".join(lines[-40:])
            assert time.monotonic() - t0 < HTTP_STARTUP_S, \
                "[http] the server did not bind:\n" + "".join(lines[-40:])
        port = port[0]
        while _get(port, "/readyz")[0] != 200:
            assert time.monotonic() - t0 < HTTP_STARTUP_S, \
                "[http] the server never became ready"
            time.sleep(0.5)
        info = json.loads(_get(port, "/server_info")[1])
        log(f"[http] ready on port {port} after "
            f"{time.monotonic() - t0:.1f} s: {info['num_pages']} KV pages, "
            f"attention {info['attention_impl']}, "
            f"{info['parallel']['fast_path']}, "
            f"{info['engine_counters']['graphs']} graphs warmed in "
            f"{info['engine_counters']['capture_s']:.2f} s")
        m0 = _scrape(port)
        passes = []
        while len(passes) < HTTP_PASSES and (
                not passes or passes[-1]["graphs_captured"]):
            passes.append(_pass(port, payloads, f"pass {len(passes) + 1}"))
        free = [i for i, p in enumerate(passes) if not p["graphs_captured"]]
        if free:
            log(f"[http] pass {free[0] + 1} captured no graph: its numbers "
                "are free of capture stalls; passes "
                f"{list(range(1, free[0] + 1))} captured "
                f"{[p['graphs_captured'] for p in passes[:free[0]]]}")
        else:
            log(f"[http] every one of {len(passes)} passes captured graphs "
                f"({[p['graphs_captured'] for p in passes]}): no number of "
                "this phase is free of capture stalls (ROADMAP C 7)")
        # the whole request, n = 2, and the stream closed after 4 chunks
        status, whole = _post(port, "/v1/completions", payloads[0])
        assert status == 200 and whole["usage"]["completion_tokens"] == \
            payloads[0]["max_tokens"], f"[http] whole request: {whole}"
        assert whole["choices"][0]["finish_reason"] == "length"
        status, two = _post(port, "/v1/completions",
                            dict(payloads[1], n=2))
        assert status == 200 and two["usage"]["completion_tokens"] == \
            2 * payloads[1]["max_tokens"], f"[http] n = 2: {two}"
        assert [c["finish_reason"] for c in two["choices"]] == ["length"] * 2
        _abort_after(port, dict(payloads[2], max_tokens=2000))
        limit = time.monotonic() + 60
        while True:
            m2 = _scrape(port)
            idle = (m2.get(("gllm_requests_active", ""), 1) == 0
                    and m2.get(("gllm_sched_running_seqs", '{dp="0"}'), 1)
                    == 0
                    and m2.get(("gllm_sched_waiting_seqs", '{dp="0"}'), 1)
                    == 0
                    and m2.get(("gllm_sched_kv_util", '{dp="0"}'), 1) == 0)
            if idle:
                break
            assert time.monotonic() < limit, \
                "[http] the server did not go idle (a page or a request " \
                "held after the aborted stream)"
            time.sleep(0.5)
        n_len = _delta(m2, m0, "gllm_requests_finished_total",
                       '{reason="length"}')
        others = {lbl: _delta(m2, m0, name, lbl) for name, lbl in m2
                  if name == "gllm_requests_finished_total"
                  and lbl != '{reason="length"}'}
        n_abort = _delta(m2, m0, "gllm_requests_aborted_total")
        n_ttft = _delta(m2, m0, "gllm_request_ttft_seconds_count")
        assert n_len == len(passes) * len(payloads) + 3 \
            and not any(others.values()), \
            f"[http] finishes by reason: length {n_len}, others {others}"
        assert n_abort == 1, f"[http] {n_abort} aborts, not 1"
        # every request that got a token observed a TTFT, the aborted one too
        assert n_ttft == len(passes) * len(payloads) + 4, \
            f"[http] {n_ttft} TTFTs"
        log(f"[http] after {len(passes)} passes: finishes by length "
            f"{n_len:.0f}, "
            f"aborts {n_abort:.0f}, TTFT observations {n_ttft:.0f}; the "
            "gauges and KV use read 0")
        last = passes[free[0] if free else -1]
        log(f"[http] pass {passes.index(last) + 1} "
            f"({last['graphs_captured']} graphs captured) "
            f"{last['output_tok_s']} output tok/s beside the serve phase's "
            "absorb twin offline (16 requests at once): "
            f"{served['unified']['absorb_rates']} tok/s, on {SMI}")
        log("[http] " + json.dumps({"http": {
            f"pass {i + 1}": p for i, p in enumerate(passes)}}))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=HTTP_STOP_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise SystemExit("[http] the server did not exit within "
                                 f"{HTTP_STOP_S:.0f} s of SIGTERM")
        else:
            rc = proc.returncode
        reader.join(timeout=5)
        server_log.close()
    assert rc == 0, f"[http] the server exited with {rc}:\n" + \
        "".join(lines[-20:])
    log(f"[http] the server exited on SIGTERM (rc {rc})")
    return last


def main():
    global HOLDERS, SMI
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--memory-history" in sys.argv[1:]:
        # each allocation keeps its Python stack: the memory lines name
        # what holds the segments with the most stranded space
        torch.cuda.memory._record_memory_history(enabled="state",
                                                 stacks="python")
        HOLDERS = 4
    t_start = time.monotonic()
    smi = SMI = phase_device()
    walls = {}
    for name, phase in (("build", phase_build), ("kernels", phase_kernels),
                        ("serve", phase_serve),
                        ("reference", phase_reference),
                        ("http", lambda: phase_http(walls["serve"][0]))):
        t0 = time.monotonic()
        walls[name] = (phase(), time.monotonic() - t0)
        log(f"[{name}] phase wall {walls[name][1]:.1f} s")
    kernels, served = walls["kernels"][0], walls["serve"][0]
    line = []
    for name, (counter, config, src, replaces) in KERNELS.items():
        r = kernels[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"gllm_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": served[config]["counts"][counter],
            "launches_in": f"serve {config}",
            "max_abs_err": r["max_abs_err"], "rtol": TOL[name][0],
            "atol": TOL[name][1], "tol_used": r["tol_used"],
            "drop_rejected": r["drop_rejected"], "ok": r["ok"],
            "ms": r["ms"], "ms_by_launch": r["split"],
            "wrapper_ms": r["wrapper_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bytes": r["bytes"], "flops": r["flops"],
            "library_ms": r["library_ms"],
            "library_call": r["library_call"],
            "varlen_library_ms": r.get("varlen_library_ms"),
            "varlen_library_call": r.get("varlen_library_call"),
            "library_backend": r["library_backend"], "shapes": r["shapes"],
            "hole_rows_max_abs_err": r.get("hole_rows", {}).get(
                "max_abs_err")})
    log(f"[done] {time.monotonic() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
