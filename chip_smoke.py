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
             token in the dummy page 0), at the same tolerances; and K1,
             K1u, K1m and K1um at the verify geometry of speculative
             decoding (32 rows of 5 query tokens over contexts 260..1996);
             and the seeded-Gumbel kernel (csrc/threefry.cu: JAX's
             threefry2x32 draws of seeded rows, which no Pallas kernel
             had) at S 32 and 256 rows of V 128256, every fourth row
             unseeded: bits equal, Gumbel values within one ulp of each
             log, a verify step's folds bit for bit, bound by int32
             operations
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
             and its mixed pass at the sequence buckets the workload
             meets (SERVE_BUCKETS) first (graphs, capture seconds and the
             pool's growth split into decode and mixed keys, KV pages
             beside PAGES_BEFORE), and each decode step must be one
             replay. Every mixed step of a dense or MLA engine with graphs
             replays its mixed key too (captured at warmup or at first
             sight: the legacy step's token bucket follows the batch),
             a hybrid model's runs eagerly, and each engine prints its
             mixed steps replayed against run eagerly, by reason. The bf16, unified, DeepSeek (both
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
             decode entry and per mixed dispatch, the dispatches' share
             of the wall by kind (the absorb window's mixed share beside
             MIXED_SHARE_BEFORE) and the share spent waiting in collect,
             and the engine's step-trace summary of the same window with
             its device share (1 - bubble_frac) beside the profiler's busy
             share. Each configuration's last run of its graph engine and
             of its best twin (absorb, slot, multi, overlap or eager) is
             bracketed on the step-trace ring (TRACE.mark()) and its
             summary printed (attribution: steps by kind, host ms by
             phase, device ms by kind, overlap efficiency, bubble share,
             MFU against the wall and the device, HBM estimate, in-flight
             depth, compiles); every collected step event must carry its
             phases, device wall and MFU, each window's MFU and device MFU
             must lie in (0, 1.05] and a dense model's HBM estimate be at
             most 1.05 x 3.35 TB/s, else the run fails
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
             same; then a captured mixed step against the same step run
             eagerly on the same batch (mixed_replays): bf16 models at
             depth 2, Llama-3.2-1B's widths over a bf16, an int8 and an
             fp8 cache and the unified step, DeepSeek at the small latent
             geometry over a bf16 and an fp8 latent and the unified step,
             two mixed batches each: the same tokens, the largest logit
             difference to a replay of the same forward printed; then
             each engine's extras case (extras_replay): a mixed step with
             penalties, logit_bias, logprobs and prompt logprobs beside
             plain rows, run eagerly and replayed through its
             "mixed_extras" key: tokens, logprobs and prompt logprobs
             bit for bit
6. spec      prompt-lookup speculative decoding at full width, bf16:
             Llama-3.2-1B and DeepSeek-V2-Lite (its depth cut to 8
             layers, SPEC_DEEPSEEK_LAYERS) each under bench.py's full
             profile (SPEC_FULL: fused spec blocks of up to 32 sub-steps,
             4 drafts from 2-grams, the pipelined loop four deep, the
             unified step, slots, on-device finish) beside the absorb
             twin on the same weights, on the serve phase's 16 requests
             and on a draft-friendly workload (prompts of a repeated
             seeded segment), runs spec, absorb, absorb, spec: tok/s and
             the ratio of medians, acceptance, tokens per dispatch,
             sub-steps, dispatches and blocks by K, and launches (K1u /
             K1um only, no plain version; spec blocks replayed from
             warmup's graphs, none captured while running); one
             host-driven run (SPEC_HOST: the sync loop's verify steps, K1
             and K2 / K1m and K2m) of the draft-friendly workload, twice
             (the first captures the verify keys its token buckets meet,
             the second replays them: verify steps replayed and tok/s
             beside HOST_DRIVEN_BEFORE); then
             float32 greedy streams of the fused and the host-driven
             engines against the plain sync engine's, Llama-3.2-1B at
             full width with a head that makes its stream loop and leave
             the loop its prompts draft (looping_llama: drafts rejected
             and accepted, several a row; its sampled rows too) and
             DeepSeek-V2-Lite with its depth cut to 3 layers: equal, or
             parting only where the plain engine's top two logits lie
             within SPEC_GAP_TOL (SPEC_SAMPLED_GAP for sampled rows); the
             looping Llama's greedy rows once more with penalties (one
             that takes the stream out of its loop) and a -100
             logit_bias, fused and host-driven: equal to the plain
             engine's with the same options
7. sampling  Llama-3.2-1B at full width, bf16, under the absorb flags
             (warmed at 8 and 16 rows): the serve phase's 16 prompts with
             seeded sampled rows, penalties, +100 and -100 logit_bias,
             logprobs 5 and prompt logprobs 1, beside their plain greedy
             twin on the same engine, runs plain, sampling, sampling,
             plain: tok/s and the ratio, the extras steps (every one
             replays its extras key: keys captured at first sight in the
             probe and the first sampling run, none in the second), host
             launch calls an extras dispatch (a profiled run), the
             extras upload's fill and copy at S 256 and max_model_len
             penalty ids, launches (K1u and the seeded-Gumbel kernel, no
             plain version); every request
             finishes with its count, a +100-biased row starts with its
             biased token and a -100-biased row never emits its own
             (both under FLAT_REP, which flattens the dummy model's
             repeat of its last token, as a probe run reads them),
             the seeded rows repeat between the two runs, logprobs <= 0
             with sorted top lists and a greedy row's chosen logprob its
             top one
8. tracing   the tracing twins: Llama-3.2-1B at full width, bf16, under
             the absorb flags on the same weights, one engine with
             tracing (request spans) on and one with it off, runs on, off,
             on, off of the serve phase's 16 greedy requests: tok/s and
             the on/off ratio of medians, the four runs' streams identical
             (else the run fails), the traced window's summary under the
             serve phase's hard checks, one span tree closed a request
9. http      the port's OpenAI server as users start it (``python -m
             gllm_tpu_torch.entrypoints.api_server``), a process of its
             own: Llama-3.2-1B at full width (config.json written under
             build/http_model, dummy bf16 weights from seed 0), once
             under the absorb twin's flags (the unified step under
             overlap, persistent slots, blocks of 16 under on-device
             finish) and once under bench.py's full profile (HTTP_SERVERS),
             driven by benchmarks/backend_request_func.run_requests: 32
             streamed greedy requests (the serve phase's 16 prompts
             twice) at concurrency 16 with Poisson arrivals at 8 req/s,
             in passes until one captures no CUDA graph (at most
             HTTP_PASSES; the first must capture none: warmup covers
             every key this traffic meets, ROADMAP C 7), each pass
             labelled with the graphs it captured, then one whole
             request, one of n = 2 and one stream closed after 4 chunks;
             every request
             finishes with its count,
             /metrics agrees with the client (finishes by reason, 1
             abort, TTFTs), the gauges and KV use read 0 afterwards, K1u
             is the only kernel the run launched (/server_info), and the
             server exits on SIGTERM; TTFT, TPOT and ITL at p50 / p99
             from the client and from the server's histograms, output
             tok/s beside the serve phase's absorb twin, absorbs,
             speculation's counts and chain breaks, for every pass;
             then on the absorb server one request each with logprobs,
             top_logprobs, a seed, penalties, a +100 logit_bias (on a
             probe's second token under FLAT_REP: it comes first),
             best_of 3 with n 1 and echo with prompt_logprobs, each sent
             twice: 200 in OpenAI's shape, the seeded one's tokens
             repeated, the extras keys captured at first sight and none
             by the repeat; on the absorb server after its passes, the
             tracing routes (http_trace): GET /steptrace from a mark taken
             before the passes (next_since, each kind filter exact), the
             passes' window summary under the hard checks of the serve
             phase, compile events in the passes equal to the graphs they
             captured, GET /trace (Chrome JSON with the engine and request
             rows) and POST /profile?seconds=1 (its trace file written)
10. a {"kernels": [...]} line, then the last line
             {"ok": true, "device": {...}}

It imports nothing of jax or the JAX package.
"""

import collections
import dataclasses
import faulthandler
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from gllm_tpu_torch.obs.spans import PEAK_TFLOPS

SEED = 0
# the card's name and power limit (nvidia-smi), set by main()
SMI = ""
FP8 = torch.float8_e4m3fn
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the dense bf16 (the
# port's peak table, obs/spans.py, which the engine's MFU reads too) and
# TF32 tensor rates. K3 computes its float32 products on the tensor cores as
# 3xTF32 (each operand split into two TF32 halves; hi.hi + hi.lo + lo.hi),
# the least work that keeps float32 accuracy there, so its operations
# bound counts every float32 product three times at the TF32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = dict(PEAK_TFLOPS)["NVIDIA H100 80GB HBM3"] * 1e12
PEAK_TF32_FLOPS = 495e12
# int32 operations: the data sheet's 67 TFLOP/s of float32 outside the
# tensor cores is 132 SMs x 128 lanes x 2 (a fused multiply-add) x 1.98
# GHz; an SM has 64 int32 lanes, so 132 x 64 x 1.98e9 integer operations
# a second. The seeded-Gumbel kernel is bound by them. One threefry2x32
# is 20 rounds of an add, a rotate and a xor, and 12 key additions; the
# adds may also issue on the float pipe (as IMAD), the rotates (funnel
# shifts) and xors only on the integer one: 40 of those a hash, and 3
# more (a xor, a shift, an or) turn a hash's two words into the float's
# bits. Each row's key takes one to three more hashes (its step and
# folds). Counted with the adds (75 an element), the bound sat above
# the kernel's time on the H100 (0.1445 ms at S 256)
PEAK_INT32_OPS = 132 * 64 * 1.98e9
THREEFRY_OPS = 40
GUMBEL_INT_OPS_PER_ELEMENT = THREEFRY_OPS + 3
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
       "ragged_paged_attention_unified_mla_decode": MLA_TOL,
       # the verify rows of speculative decoding: the ragged classes at 5
       # query tokens a row, whose reasons hold
       "ragged_paged_attention_verify": RAGGED_TOL,
       "ragged_paged_attention_unified_verify": RAGGED_TOL,
       "ragged_paged_attention_mla_verify": MLA_TOL,
       "ragged_paged_attention_unified_mla_verify": MLA_TOL}
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
# the seeded-Gumbel kernel: its bits are held equal, its Gumbel values to
# one ulp of each of their two logs (gumbel_ulp_bound; CUDA's logf and
# torch's log may round apart), so no (rtol, atol) applies
TOL.update(seeded_gumbel=(0.0, 0.0), seeded_gumbel_s256=(0.0, 0.0))
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
    # the verify rows: the host-driven runs launch K1 / K1m (with their
    # prefill chunks), the fused spec runs K1u / K1um (with every other
    # step of theirs), in the spec phase
    "ragged_paged_attention_verify": (
        "ragged_paged_attention", "spec_llama_host", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (verify rows, q_len 5)"),
    "ragged_paged_attention_unified_verify": (
        "ragged_paged_attention_unified", "spec_llama", "ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, verify rows)"),
    "ragged_paged_attention_mla_verify": (
        "ragged_paged_attention_mla", "spec_deepseek_host",
        "mla_ragged_attention.cu",
        PALLAS + "ragged_attention.py:429 (v_cache=None, verify rows)"),
    "ragged_paged_attention_unified_mla_verify": (
        "ragged_paged_attention_unified_mla", "spec_deepseek",
        "mla_unified_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, v_cache=None, "
        "verify rows)"),
    # no Pallas kernel: JAX's threefry draws are XLA-fused elementwise
    # code; its launches are the sampling phase's
    "seeded_gumbel": (
        "seeded_gumbel", "sampling", "threefry.cu",
        "none (jax.random threefry2x32 in gllm_tpu/ops/sampling.py "
        "sample:269, _row_base_keys:304, spec_verify:373; no Pallas "
        "counterpart)"),
    "seeded_gumbel_s256": (
        "seeded_gumbel", "sampling", "threefry.cu",
        "none (jax.random threefry2x32 in gllm_tpu/ops/sampling.py "
        "sample:269, _row_base_keys:304, spec_verify:373; no Pallas "
        "counterpart)"),
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


def gumbel_ulp_bound(bits):
    """Per element, how far two Gumbel draws of the same uniform bits may
    lie apart when each of their two logs rounds within one ulp: the
    inner log's ulp carried through 1 / y (y = -log u), the outer log's
    ulp and the result's rounding, float64."""
    from gllm_tpu_torch.ops import threefry as tf
    u = tf.uniform_from_bits(bits, tf.TINY).double()
    y = -torch.log(u)
    g = -torch.log(y)
    ulp = lambda x: torch.nextafter(x.abs().float(),  # noqa: E731
                                    torch.tensor(float("inf"),
                                                 device=x.device)).double() \
        - x.abs().float().double()
    return 2 * ulp(g) + ulp(y) / y


def seeded_gumbel_kernels(dev):
    """The seeded-Gumbel kernel (csrc/threefry.cu) against its plain
    version (ops/threefry.py::seeded_noise_) at a sampled step's shapes,
    S 32 and 256 rows of Llama-3.2-1B's vocabulary (V 128256), every
    fourth row unseeded (left as it was): the bits equal, the Gumbel
    values within one ulp of each log, a verify step's draws (S 32 x 5
    verify rows: the uniforms under stream 0, the noise under stream 1)
    bits equal; perturbed plain: each row's output index one later. Timed
    with every row seeded; bound by its int32 operations."""
    from gllm_tpu_torch.ops import threefry as tf
    from gllm_tpu_torch.ops.cuda.threefry import seeded_noise
    V, K1 = 128256, 5
    rng = np.random.default_rng(SEED + 3)
    results = {}
    for name, S in (("seeded_gumbel", 32), ("seeded_gumbel_s256", 256)):
        seed = torch.as_tensor(rng.integers(0, 2**31 - 1, S, dtype=np.int64)
                               .astype(np.int32), device=dev)
        step = torch.as_tensor(rng.integers(0, 4096, S).astype(np.int32),
                               device=dev)
        mixed = seed.clone()
        mixed[::4] = -1

        def draw(fn, mode, seeds=mixed, steps=step, rows=S, group=0,
                 stream=-1, width=V):
            dtype = torch.int32 if mode == tf.BITS else torch.float32
            out = torch.full((rows, width), 7, dtype=dtype, device=dev)
            return fn(out, seeds, steps, group, stream, mode)

        bits_k = draw(seeded_noise, tf.BITS)
        bits_p = draw(tf.seeded_noise_, tf.BITS)
        g_k = draw(seeded_noise, tf.GUMBEL)
        g_p = draw(tf.seeded_noise_, tf.GUMBEL)
        torch.cuda.synchronize()
        live = mixed >= 0
        bits_ok = torch.equal(bits_k, bits_p)
        untouched = bool((g_k[~live] == 7).all())
        raw = bits_p[live].long() & 0xFFFFFFFF
        err = (g_k[live].double() - g_p[live].double()).abs()
        tol_used = (err / gumbel_ulp_bound(raw)).max().item()
        max_abs = err.max().item()
        ulps = (g_k[live].view(torch.int32).long()
                - g_p[live].view(torch.int32).long()).abs()
        # a verify step's draws: S x K1 rows, position and stream folds
        verify_ok = all(
            torch.equal(draw(seeded_noise, tf.BITS, rows=S * K1, group=K1,
                             stream=st, width=w),
                        draw(tf.seeded_noise_, tf.BITS, rows=S * K1,
                             group=K1, stream=st, width=w))
            for st, w in ((0, 1), (1, V)))
        perturbed = draw(tf.seeded_noise_, tf.BITS, steps=step + 1)
        drop_rejected = not torch.equal(perturbed[live], bits_k[live])
        del bits_k, bits_p, g_k, g_p, perturbed, raw, err
        elems = S * V
        nbytes = elems * 4 + 2 * S * 4
        ops = (elems * GUMBEL_INT_OPS_PER_ELEMENT
               + S * 2 * THREEFRY_OPS)
        b_ms, b_by = bound(nbytes, ops, PEAK_INT32_OPS)
        out = torch.empty((S, V), dtype=torch.float32, device=dev)
        kernel = lambda: seeded_noise(out, seed, step)  # noqa: E731
        plain = lambda: tf.seeded_noise_(out, seed, step)  # noqa: E731
        split = timed_above_bound(kernel, 50, b_ms)
        results[name] = dict(
            ok=bits_ok and untouched and verify_ok and tol_used <= 1.0,
            max_abs_err=max_abs, max_ulps=ulps.max().item(), ulps_differing=int(
                (ulps > 0).sum()), tol_used=tol_used, bits_equal=bits_ok,
            unseeded_untouched=untouched, verify_bits_equal=verify_ok,
            drop_rejected=drop_rejected, drop_max_abs=None,
            ms=sum(split.values()), split=split,
            plain_ms=device_ms(plain, 3), library_ms=None,
            library_backend=None, library_call=None,
            wrapper_ms=cuda_ms(kernel, 50), bytes=nbytes, flops=ops,
            bound_ms=b_ms, bound_by=b_by,
            shapes=f"S={S} rows x V={V} (every fourth row unseeded in the "
            f"check; all seeded when timed), float32 Gumbel noise; a "
            f"verify step's {S} x {K1} rows (uniforms, stream 0; noise, "
            f"stream 1) checked bit for bit; ops = integer-pipe operations "
            f"({GUMBEL_INT_OPS_PER_ELEMENT} an element + the rows' keys) "
            f"at {PEAK_INT32_OPS:.3e}/s")
        del out
        log(f"[kernels] {name}: bits equal {bits_ok}, verify-step bits "
            f"equal {verify_ok}, unseeded rows untouched {untouched}; "
            f"Gumbel values: {results[name]['ulps_differing']} of "
            f"{int(live.sum()) * V} differ, by at most "
            f"{results[name]['max_ulps']} ulp of the value, "
            f"{tol_used:.3f} of the one-ulp-a-log bound used")
    return results


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
    results.update(verify_kernels(dev))
    results.update(seeded_gumbel_kernels(dev))

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


def verify_shape(rng, dev, Hq=32, Hkv=8, D=64, quant=False):
    """The verify rows of a spec block: S 32 rows of q_len 5 (the committed
    token and spec_k = 4 drafts) over contexts 260..1996, no padding."""
    page = 16
    seqs = [(5, int(k)) for k in rng.integers(260, 1997, 32)]
    kv = [k for _, k in seqs]
    kc, vc, pt = _paged(rng, kv, Hkv, D, page, torch.bfloat16, dev)
    cu = np.zeros(len(seqs) + 1, np.int32)
    cu[1:] = np.cumsum([ql for ql, _ in seqs])
    T = int(cu[-1])
    kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
    return dict(q=_randn((T, Hq, D), dev), kc=kc, vc=vc, pt=pt, kvl=kvl,
                kvl_drop=kvl - 1, cu=torch.from_numpy(cu).to(dev), cu_np=cu,
                seqs=seqs, kv=kv, page=page, T_real=T, quant=None)


def verify_kernels(dev):
    """K1, K1u, K1m and K1um at the verify geometry of a spec block (the
    ragged class: S 32 rows of 5 query tokens over contexts 260..1996):
    K1 and K1u at Llama-3.2-1B's attention over a bf16 cache, K1m and
    K1um at DeepSeek-V2-Lite's latent geometry over a bf16 latent. The
    host-driven verify step launches K1 / K1m, the fused spec block K1u /
    K1um (the unified step of bench.py's full profile)."""
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    from gllm_tpu_torch.ops.rope import yarn_softmax_scale_mult
    results = {}
    rng = np.random.default_rng(SEED + 3)
    Hq, Hkv, D = 32, 8, 64
    scale = D ** -0.5
    x = verify_shape(rng, dev, Hq, Hkv, D)
    q, cu, kvl, pt, kv, page = (x["q"], x["cu"], x["kvl"], x["pt"], x["kv"],
                                x["page"])
    seqs, T, S = x["seqs"], x["T_real"], len(x["seqs"])
    visible = sum(k - ql + t + 1 for ql, k in seqs for t in range(ql))
    row = Hq * D * 2
    io = 2 * T * row + (2 * S + 1) * 4 + sum(-(-k // page) for k in kv) * 4
    shapes = (f"verify rows: S={S} of q_len 5 (T={T}), ctx {min(kv)}.."
              f"{max(kv)} Hq={Hq} Hkv={Hkv} D={D} page={page} bf16 q, bf16 "
              "cache")
    kd, vd = _dense_kv(x["kc"], x["vc"], pt, kv, page)
    for name, unified in (("ragged_paged_attention_verify", False),
                          ("ragged_paged_attention_unified_verify", True)):
        kw = dict(scale=scale, unified=unified)
        results[name] = measure(
            name,
            lambda kw=kw: rag.ragged_paged_attention(q, x["kc"], x["vc"], cu,
                                                     kvl, pt, **kw),
            lambda kw=kw: rag.ragged_paged_attention_plain(
                q, x["kc"], x["vc"], cu, kvl, pt, **kw),
            lambda kw=kw: rag.ragged_paged_attention_plain(
                q, x["kc"], x["vc"], cu, x["kvl_drop"], pt, **kw),
            _mixed_library(x, kd, vd, scale), 20,
            _kv_bytes(kv, page, Hkv, D, "bf16") + io, 4 * Hq * D * visible,
            varlen=_varlen_library(x, x["kc"], x["vc"], scale),
            shapes=shapes,
            library_call="scaled_dot_product_attention(enable_gqa, bool "
            "mask) over q padded to [S, Hq, 5, D] and K/V gathered dense per "
            "sequence", varlen_library_call=VARLEN_CALL)
    del x, kd, vd
    cfg = deepseek_v2_lite()
    Hq, lora, Dl = cfg.num_heads, cfg.kv_lora_rank, cfg.mla_cache_width
    scale = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
             * yarn_softmax_scale_mult(cfg.rope_scaling))
    x = verify_shape(rng, dev, Hq=Hq, Hkv=1, D=Dl)
    q, cu, kvl, pt, kv = x["q"], x["cu"], x["kvl"], x["pt"], x["kv"]
    lat = x.pop("kc")
    del x["vc"]
    seqs = x["seqs"]
    visible = sum(k - ql + t + 1 for ql, k in seqs for t in range(ql))
    nbytes = (sum(kv) * Dl * 2 + T * Hq * Dl * 2 + T * Hq * lora * 2
              + (2 * S + 1) * 4 + sum(-(-k // page) for k in kv) * 4)
    kd = _dense_kv(lat, lat, pt, kv, page)[0]
    for name, unified in (("ragged_paged_attention_mla_verify", False),
                          ("ragged_paged_attention_unified_mla_verify",
                           True)):
        def run(fn, lens, unified=unified):
            return fn(q, lat, None, cu, lens, pt, unified=unified,
                      scale=scale, v_dim=lora)
        results[name] = measure(
            name, lambda run=run: run(rag.ragged_paged_attention, kvl),
            lambda run=run: run(rag.ragged_paged_attention_plain, kvl),
            lambda run=run: run(rag.ragged_paged_attention_plain,
                                x["kvl_drop"]),
            _mixed_library(x, kd, kd[..., :lora], scale), 20, nbytes,
            2 * Hq * (Dl + lora) * visible,
            shapes=(f"verify rows: S={S} of q_len 5 (T={T}), ctx "
                    f"{min(kv)}..{max(kv)} Hq={Hq} latent [P, {page}, 1, "
                    f"{Dl}] v_dim={lora} bf16 q, bf16 latent, scale "
                    f"{scale:.5f}"),
            library_call="scaled_dot_product_attention(enable_gqa) over the "
            "latent gathered dense per sequence (k the 576-wide row, v its "
            "leading 512), q padded to [S, 16, 5, 576] with a causal bool "
            "mask")
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
    from gllm_tpu_torch.ops import threefry as tf
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import gdn_scan as scan
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    from gllm_tpu_torch.ops.cuda import threefry as tfk
    return ((rag.ragged_paged_attention, dec.paged_decode_attention,
             scan.gdn_chunk_scan, tfk.seeded_noise),
            (rag.ragged_paged_attention_plain,
             dec.paged_decode_attention_plain, scan.gdn_chunk_scan_plain,
             tf.seeded_noise_))


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
# stop-token run. Its warmup captures the single steps at the sequence
# buckets the workload takes and the longest block, greedy and sampled, at
# the largest of them (its graph pools then fit beside the primary
# engine's and the overlap twin's); the block at the smaller bucket is
# captured at first sight, in its first run
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
# the mixed entries' share of the staggered absorb window's wall while
# mixed steps ran eagerly (H100 80GB HBM3, 700.00 W)
MIXED_SHARE_BEFORE = "20.6-36.6%"
# a twin's KV pool: the workload's 16 requests hold at most 899 pages of
# 16 tokens at once (a block's look-ahead adds one a row), so no twin
# preempts (each asserts it; the primary engine holds the memory the pool
# is sized from); a hybrid twin also holds 16 GDN slots (the workload's),
# not 256
TWIN_PAGES = 2048
# the sequence buckets each serve engine warms (decode combos, the mixed
# pass): the 16 requests never batch more rows
SERVE_BUCKETS = (8, 16)
# each configuration's primary KV pages while mixed steps ran eagerly,
# before the headroom reckoned their keys (H100 80GB HBM3, 700.00 W)
PAGES_BEFORE = {"bf16": 134384, "int8": 267763, "unified": 134404,
                "unified_int8": 267763, "fp8": 268809, "unified_fp8": 268809,
                "deepseek": 84166, "deepseek_unified": 83846,
                "deepseek_fp8": 167684, "deepseek_unified_fp8": 167684,
                "qwen3_next": 137551, "qwen3_next_fp8": 275060}
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


def graph_split(g):
    """A DecodeGraphs' keys, capture seconds and pool growth, split into
    the decode side (single steps, blocks, spec blocks), the mixed side
    (mixed and verify steps) and the extras keys (any kind)."""
    sides = {"decode": ("decode", "block", "spec"),
             "mixed": ("mixed", "verify"),
             "extras": ("decode_extras", "mixed_extras", "verify_extras")}
    return {side: dict(
        keys=sum(g.by_kind[k]["captured"] for k in kinds),
        capture_s=round(sum(g.by_kind[k]["capture_s"] for k in kinds), 3),
        pool_mib=round(sum(g.by_kind[k]["pool_bytes"] for k in kinds)
                       / 2**20, 1))
        for side, kinds in sides.items()}


def graph_counts(e):
    """An engine's step counts, eager mixed steps by reason and its
    graphs' replays, captures and capture seconds by kind: what
    ``graph_delta`` takes a run's deltas from."""
    from gllm_tpu_torch.runner.graphs import KINDS
    g = e.runner.graphs
    by = {k: g.by_kind[k] if g else dict(replays=0, captured=0,
                                         capture_s=0.0) for k in KINDS}
    return dict(steps=dict(e.step_counts), eager=dict(e.runner.eager_mixed),
                replays={k: v["replays"] for k, v in by.items()},
                captured={k: v["captured"] for k, v in by.items()},
                capture_s={k: v["capture_s"] for k, v in by.items()})


def graph_delta(e, before):
    """``graph_counts(e)`` since ``before``."""
    now = graph_counts(e)
    d = {part: {k: now[part][k] - before[part][k] for k in now[part]}
         for part in now}
    d["captured_total"] = sum(d["captured"].values())
    return d


MIXED_KINDS = ("mixed", "verify", "mixed_extras", "verify_extras")


def mixed_line(name, e, d):
    """The mixed steps of a run (``graph_delta`` ``d``): replayed (mixed
    and verify keys, with extras or without) against run eagerly, by
    reason. Every mixed step of an engine with graphs replays a graph but
    a hybrid model's; an ``enforce_eager`` engine's are all eager."""
    mixed = d["steps"]["mixed"]
    replayed = sum(d["replays"][k] for k in MIXED_KINDS)
    eager = d["eager"]
    assert replayed + sum(eager.values()) == mixed, \
        f"[{name}] {mixed} mixed steps, {replayed} replayed, eager {eager}"
    assert not eager["extras"], f"[{name}] eager mixed steps {eager}"
    if e.runner.graphs is None:
        assert eager["enforce_eager"] == mixed
    elif e.runner.hybrid:
        assert eager["hybrid"] == mixed
    else:
        assert eager["hybrid"] == eager["enforce_eager"] == 0, \
            f"[{name}] eager mixed steps {eager}"
    by = ", ".join(f"{d['replays'][k]} {k}" for k in MIXED_KINDS)
    return (f"mixed steps {mixed}: {replayed} replayed ({by}), "
            f"{sum(eager.values())} eager ({eager}); mixed keys captured at "
            f"first sight {sum(d['captured'][k] for k in MIXED_KINDS)}")


# the step-trace ring's step events, and what a window's summary prints
STEP_EVENTS = ("prefill", "decode", "unified_step", "fused_block")
ATTRIBUTION_KEYS = ("by_kind", "host_ms_by_phase", "device_ms_by_kind",
                    "overlap_efficiency", "bubble_frac", "mfu", "device_mfu",
                    "hbm_gbps", "mean_inflight_depth", "compiles")
# a window's MFU (wall and device) and a dense model's HBM estimate may
# exceed their bounds by this much before the run fails
ATTRIBUTION_SLACK = 1.05


def dense_model(cfg):
    """A model whose every weight a step reads: its HBM estimate is held to
    the card's rate (an MoE model's counts every expert, as JAX's does)."""
    return not (cfg.use_mla or cfg.num_experts or cfg.use_hybrid)


def attribution(tag, events, dense):
    """The step-trace summary of one window (``summarize`` of the events
    between two ``TRACE.mark()``s), printed; fails the run unless every
    collected step event carries its host phases, device wall and MFU,
    the window's MFU and device MFU lie in (0, ATTRIBUTION_SLACK] and, for
    a dense model, its HBM estimate is at most ATTRIBUTION_SLACK times the
    card's rate. A window with eager steps (events marked ``eager``: their
    bodies ran op by op, the card working through them before the
    dispatch returned, which the device wall ready - max(dispatched,
    previous ready) does not see) prints their count and why its device
    MFU, bubble share and HBM rate are no device measurement, and holds
    its device MFU to (0, inf) only."""
    from gllm_tpu_torch.obs.steptrace import summarize
    steps = [e for e in events if e["kind"] in STEP_EVENTS]
    if not steps:
        raise SystemExit(f"{tag}: no collected step in the window")
    bare = [e for e in steps if not {"ph", "dev_ms", "mfu"} <= set(e)]
    if bare:
        raise SystemExit(f"{tag}: {len(bare)} of {len(steps)} step events "
                         f"lack ph, dev_ms or mfu: {bare[:2]}")
    s = summarize(events)
    out = {k: s[k] for k in ATTRIBUTION_KEYS}
    eager = collections.Counter(e["eager"] for e in steps if "eager" in e)
    out["eager_steps"] = sum(eager.values())
    log(f"{tag} steptrace window on {SMI}: {len(steps)} step events; "
        + json.dumps(out))
    if eager:
        log(f"{tag} {out['eager_steps']} of {len(steps)} step events ran "
            f"op by op ({dict(eager)}): the card works through such a "
            f"body while the host enqueues it, before the dispatch "
            f"returns, and their device wall (ready - max(dispatched, "
            f"previous ready), JAX's) misses that time, so this window's "
            f"device_mfu, bubble_frac and hbm_gbps are no device "
            f"measurement; its device_mfu is held to (0, inf) only")
    for k in ("mfu", "device_mfu"):
        top = (float("inf") if eager and k == "device_mfu"
               else ATTRIBUTION_SLACK)
        if s[k] is None or not 0 < s[k] <= top:
            raise SystemExit(f"{tag}: window {k} {s[k]} outside (0, "
                             f"{top}]")
    bound = ATTRIBUTION_SLACK * PEAK_BYTES_PER_S / 1e9
    if dense and not eager and not (s["hbm_gbps"] or 0) <= bound:
        raise SystemExit(f"{tag}: window hbm_gbps {s['hbm_gbps']} above "
                         f"{bound:.0f} GB/s")
    return out


def serve(name, model, kw, runs, by_kind, profiled, params=None):
    """Serve one configuration (with ``params``, the weights of an earlier
    engine of the model: only a new KV pool is built): warm the graphs,
    time the runs (alternating with the eager twin where there is one),
    check the launch counts, the replays and the twins' streams; returns
    its numbers and the engine's weights."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, SamplingParams
    from gllm_tpu_torch.obs.steptrace import TRACE
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
    llm.runner.warmup(decode_buckets=SERVE_BUCKETS)
    warm_s = time.monotonic() - t0
    pool_mib = graphs.pool_bytes() / 2**20
    warmed = graph_split(graphs)
    log(f"[serve {name}] warmup at sequence buckets {SERVE_BUCKETS}: "
        f"{llm.runner.num_shape_signatures} graphs captured in {warm_s:.2f} "
        f"s ({graphs.capture_seconds:.2f} s in capture, warm-up runs "
        f"included): {warmed}; graph pool {pool_mib:.1f} MiB; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; KV "
        f"pages {llm.runner.num_pages} (before mixed-step capture: "
        f"{PAGES_BEFORE.get(name)}), the mixed keys reckoned at "
        f"{llm.runner.mixed_pool_bytes() / 2**20:.1f} MiB")
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
        over.runner.warmup(decode_buckets=SERVE_BUCKETS)
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
    graphs0 = [graph_counts(e) for e in engines]
    sigs0 = llm.runner.num_shape_signatures
    if over:
        over_dispatches0 = over.dispatches.copy()
    twins0 = {id(e): twin_counts(e) for e in (multi, slot, absorb) if e}
    reset_counters()
    rates = {"graph": [], "eager": [], "overlap": [], "multi": [],
             "slot": [], "absorb": []}
    streams = {}
    schedules = {}
    # each engine's last run, bracketed on the step-trace ring
    windows = {}
    for rep, e in enumerate(order):
        mode = modes[id(e)]
        recording = e in (over, multi, slot, absorb) and mode in streams
        if recording:
            # the second overlap (multi, slot, absorb) run records what it
            # dispatches
            schedules[mode] = record_schedule(e)
        torch.cuda.synchronize()
        mark = TRACE.mark()
        t0 = time.monotonic()
        outs = e.generate(prompt_token_ids=prompts, sampling_params=params)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        windows[mode] = TRACE.events(since=mark)
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
    primary = graph_delta(llm, graphs0[0])
    replays = primary["replays"]["decode"]
    first_sight = llm.runner.num_shape_signatures - sigs0
    launched = {k for k, n in counts.items() if k != "plain_calls" and n}
    log(f"[serve {name}] graph median {median(rates['graph']):.1f} output "
        f"tok/s" + (f", eager median {median(rates['eager']):.1f} "
                    f"({median(rates['graph']) / median(rates['eager']):.3f}"
                    f"x)" if eager else "")
        + f"; steps {steps}; graph replays {replays} of {graph_decode} "
        f"decode steps, {first_sight} graphs captured at first sight in "
        f"the runs ({primary['captured']}, "
        f"{sum(primary['capture_s'].values()):.2f} s); launches {counts}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # every engine with graphs: one replay for each decode dispatch (a
    # single step or a block); a block's executed sub-steps as many as its
    # collect counted
    for e, s0, b0, g0 in zip(engines, steps0, blocks0, graphs0):
        d = graph_delta(e, g0)
        log(f"[serve {name}] {modes[id(e)]}: {mixed_line(name, e, d)}")
        if e.runner.graphs is None:
            continue
        dispatched = (e.step_counts["decode"] - s0["decode"]
                      + e.runner.block_counts["block"] - b0["block"])
        got = d["replays"]["decode"] + d["replays"]["block"]
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
    # the graph engine's last run and its best twin's, on the ring
    best = next((m for m in ("absorb", "slot", "multi", "overlap", "eager")
                 if rates[m]), None)
    attributed = {mode: attribution(f"[serve {name} {mode}]", windows[mode],
                                    dense_model(llm.model_cfg))
                  for mode in ("graph", best) if mode}
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
        log(f"[profile {name} absorb, staggered] mixed entries "
            f"{100 * prof['absorb']['share']['mixed']:.1f}% of the wall "
            f"(before mixed-step capture: {MIXED_SHARE_BEFORE}), "
            f"{prof['absorb']['launches_per_mixed']:.2f} host launch calls "
            f"a mixed dispatch")
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
               warmed=warmed, mixed=graph_delta(llm, graphs0[0]),
               profile=prof, attribution=attributed)
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
    steps captured at MULTI_BLOCK_BUCKETS and its longest blocks at the
    largest of them (the smaller block at first sight); its memory
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
                           block_buckets=MULTI_BLOCK_BUCKETS[-1:])
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
    from gllm_tpu_torch.obs.steptrace import TRACE
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
            mark = TRACE.mark()
            t0 = time.monotonic()
            serve_window()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
            ring = TRACE.events(since=mark)
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
    def launch_calls(inside):
        """Host calls that launch work inside the ``inside`` spans."""
        inside = sorted(inside)
        starts = [a for a, _ in inside]
        calls = {}
        for e in events:
            if e.name in LAUNCH_CALLS:
                i = bisect_right(starts, e.time_range.start) - 1
                if i >= 0 and e.time_range.start <= inside[i][1]:
                    calls[e.name] = calls.get(e.name, 0) + 1
        return calls
    decode_spans = spans["decode"] + spans["block"]
    calls = launch_calls(decode_spans)
    mixed_calls = launch_calls(spans["mixed"])
    n_mixed = max(1, len(spans["mixed"]))
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
        f" mixed {100 * share['mixed']:.1f}% ({len(spans['mixed'])} mixed "
        f"dispatches, {sum(mixed_calls.values()) / n_mixed:.2f} host launch "
        f"calls each: {mixed_calls}); "
        f"waiting in collect {100 * share['collect']:.1f}% of the wall; "
        f"host self time {host_us / 1e3:.1f} ms "
        f"({100 * host_us / wall_us:.1f}% of wall), by operator:")
    for cpu_us, count, key in host[:10]:
        log(f"{tag}   {100 * cpu_us / host_us:5.1f}%  {cpu_us / 1e3:8.3f}"
            f" ms  x{count:<6d} {key[:60]}")
    # the engine's own attribution of the same window: its device share
    # (1 - bubble_frac, from host clocks) beside the profiler's busy share
    traced = attribution(tag, ring, dense_model(llm.model_cfg))
    bubble = traced["bubble_frac"]
    log(f"{tag} device share: profiler busy {100 * busy / wall_us:.1f}% of "
        f"the wall, steptrace 1 - bubble_frac "
        + (f"{100 * (1 - bubble):.1f}%" if bubble is not None else "none")
        + (f" ({traced['eager_steps']} eager steps: no device measurement)"
           if traced["eager_steps"] else "")
        + f" on {SMI}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / wall_us, attribution=traced,
                kernels_per_step=kernels_per_step,
                launches_per_decode_step=launches,
                launches_per_substep=per_sub, share=share,
                launches_per_mixed=sum(mixed_calls.values()) / n_mixed,
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
    the card. Logs where the phase's wall went: building and running the
    card's engines and the CPU's, and the mixed and extras replays."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, \
        SamplingParams, SchedulerConfig
    from gllm_tpu_torch.models import deepseek, dense, hybrid
    t_phase = time.monotonic()
    spent = collections.Counter()
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
        t0 = time.monotonic()
        ec = EngineConfig(dtype="float32", seed=SEED, max_model_len=512,
                          unified_step=unified,
                          scheduler=SchedulerConfig(max_prefill_tokens=64),
                          cache=CacheConfig(num_pages=128,
                                            kv_cache_dtype=kv_cache_dtype),
                          **flags)
        llm = LLM(model_cfg=cfg, config=ec, params=p, device=device)
        spent[f"{device} build"] += time.monotonic() - t0
        return llm

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
            t0 = time.monotonic()
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
            spent[f"{llm.device.type} run"] += time.monotonic() - t0
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
            + f"; {graphed.graphs.by_kind['decode']['replays']} decode and "
            f"{graphed.graphs.by_kind['mixed']['replays']} mixed graph "
            f"replays ({graphed.num_shape_signatures} graphs); card launches "
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
        by = graphed.graphs.by_kind
        assert by["decode"]["replays"] == graphed.step_counts["decode"] > 0
        # the first step ran by hand; a hybrid model's mixed steps eager
        assert (by["mixed"]["replays"] + graphed.eager_mixed["hybrid"]
                == graphed.step_counts["mixed"])
        assert graphed.eager_mixed["hybrid"] == (
            graphed.step_counts["mixed"] if graphed.hybrid else 0)
        assert all(len(t) == 8 for t in toks[0])
        launched = {k for k, n in counts.items() if n and k != "plain_calls"}
        assert launched == kernels, \
            f"[reference] {label}: the card launched {launched}"
        # the engines' graphs hold the split-KV scratch at its size
        engines = llm = graphed = e = None
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    mixed_replays(llama, ds)
    spent["mixed and extras replays"] = time.monotonic() - t0
    spent["rest"] = time.monotonic() - t_phase - sum(spent.values())
    log("[reference] where the phase went (s): "
        + json.dumps({k: round(v, 2) for k, v in spent.items()}))
    return dict(spent)


def mixed_replays(llama, ds):
    """A captured mixed step replayed against the same step run eagerly
    on the same batch: bf16 models at depth 2 (``llama``: Llama-3.2-1B's
    widths; ``ds``: DeepSeek at the MLA kernels' small latent geometry)
    over a bf16, an int8 and an fp8 cache and the unified step, and an MLA
    latent in bf16 and fp8 and the unified step. Two mixed batches an
    engine (three prefill chunks, then their decode rows beside a fourth
    prompt's chunk), each run three ways on the card: the eager forward
    (its logits' argmax), the step through its graph (captured at first
    sight, then replayed), and a replay of the same forward captured on
    the batch's staged views (its logits). The tokens must agree; the
    largest logit difference is printed. Writing a batch's KV again
    writes the same values (a one-byte cache's running scales are
    already past them), so the three runs see the same cache."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, \
        SamplingParams, SchedulerConfig
    from gllm_tpu_torch.models import deepseek, dense
    sp = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
    for family, cfg, init, cases in (
            ("llama", llama, dense.init_params,
             (("auto", False), ("int8", False), ("fp8", False),
              ("auto", True))),
            ("deepseek", ds, deepseek.init_params,
             (("auto", False), ("fp8", False), ("auto", True)))):
        params = init(cfg, SEED, torch.bfloat16, "cuda")
        for kv_dtype, unified in cases:
            label = (f"{family} bf16, {kv_dtype} cache"
                     + (", unified" if unified else ""))
            llm = LLM(model_cfg=cfg, params=params, device="cuda",
                      config=EngineConfig(
                          dtype="bfloat16", seed=SEED, max_model_len=512,
                          unified_step=unified,
                          scheduler=SchedulerConfig(max_prefill_tokens=256),
                          cache=CacheConfig(num_pages=256,
                                            kv_cache_dtype=kv_dtype)))
            runner = llm.runner
            rng = np.random.default_rng(SEED + 2)
            seqs = [llm._allocate_seq(
                rng.integers(1, cfg.vocab_size, n).tolist(), sp)
                for n in (40, 75, 130, 60)]
            for seq in seqs[:3]:
                llm.add_seq(seq)
            worst = 0.0
            for step in range(2):
                if step == 1:
                    llm.add_seq(seqs[3])
                batch = llm.scheduler.schedule_once()
                n = batch.num_seqs
                assert any(it.num_new_tokens > 1 for it in batch.items)
                dev_batch, max_q = runner.prepare(batch)
                eager = runner.forward_logits(dev_batch, max_q)[:n].float()
                replayed = runner.collect(runner.step_async(batch))
                host, _, sig_q = runner._host_batch(batch)
                staged = runner.staging.upload(host)
                probe = torch.cuda.CUDAGraph()
                with torch.cuda.graph(probe, pool=runner.graphs.pool):
                    logits = runner._forward(staged, sig_q)
                probe.replay()
                torch.cuda.synchronize()
                logits = logits[:n].float()
                err = (eager - logits).abs().max().item()
                worst = max(worst, err)
                want = eager.argmax(-1).tolist()
                assert replayed.tolist() == want == \
                    logits.argmax(-1).tolist(), \
                    f"[reference] {label}, mixed step {step}: the replayed " \
                    f"step's tokens are not the eager step's"
                llm.scheduler.process_output(batch, want, llm.eos_token_ids)
            by = runner.graphs.by_kind["mixed"]
            log(f"[reference] mixed replay, {label}: 2 mixed steps "
                f"({by['replays']} replays of {by['captured']} mixed keys) "
                f"give the eager step's tokens; largest logit difference "
                f"to a replay of the same forward {worst}")
            assert by["replays"] == 2
            extras_replay(label, llm, rng)
            assert runner.eager_mixed == dict(extras=0, hybrid=0,
                                              enforce_eager=0)
            # the engine's graphs (and the split-KV scratch they hold at
            # its address) go before the next engine sizes its own
            del llm, runner, probe, logits, staged, dev_batch
            gc.collect()
            torch.cuda.empty_cache()
        del params
    assert split_counters_clear(), "a decode kernel left a split counter set"


def extras_replay(label, llm, rng):
    """The extras case of ``mixed_replays``: two new prompts whose rows
    carry penalties, a logit_bias, logprobs and prompt logprobs (greedy)
    join the engine's running rows (plain: their extras neutral) in one
    mixed step, run eagerly through the runner's step body and then
    through its "mixed_extras" key (captured at first sight, replayed):
    the tokens, the sampled tokens' logprobs and the prompt logprobs
    agree bit for bit."""
    from gllm_tpu_torch import SamplingParams
    runner = llm.runner
    sp = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True,
                        repetition_penalty=1.2, presence_penalty=0.2,
                        logit_bias={7: 2.0, 11: -3.0}, logprobs=5,
                        prompt_logprobs=2)
    for n in (50, 90):
        llm.add_seq(llm._allocate_seq(
            rng.integers(1, llm.model_cfg.vocab_size, n).tolist(), sp))
    batch = llm.scheduler.schedule_once()
    n = batch.num_seqs
    assert any(it.num_new_tokens > 1 for it in batch.items)
    dev_batch, max_q = runner.prepare(batch)
    _, plp = runner._lp_flags(batch)
    assert plp
    with torch.inference_mode():
        runner._prologue(dev_batch)
        want, want_aux = runner._step_body(dev_batch, max_q, True, True, plp)
    want_aux = {k: tuple(x.cpu().numpy() for x in v)
                for k, v in want_aux.items()}
    want = want[:n].tolist()
    handle = runner.step_async(batch)
    got = runner.collect(handle).tolist()
    aux = runner.aux(handle)
    rows = batch.total_tokens
    assert got == want, f"[reference] {label}, extras step: the replayed " \
        "step's tokens are not the eager step's"
    for name, cut in (("lp", n), ("plp", rows)):
        for a, b in zip(aux[name], want_aux[name]):
            assert np.array_equal(a[:cut], b[:cut]), \
                f"[reference] {label}, extras step: {name} differs"
    llm.scheduler.process_output(batch, got, llm.eos_token_ids)
    by = runner.graphs.by_kind["mixed_extras"]
    assert by["replays"] == 1 == by["captured"]
    log(f"[reference] extras replay, {label}: a mixed step with "
        f"penalties, logit_bias, logprobs 5 and prompt logprobs 2 ({n} "
        f"rows, {rows} tokens) replayed its mixed_extras key with the "
        f"eager step's tokens, logprobs and prompt logprobs bit for bit")


# ---- 6. spec -------------------------------------------------------------

# bench.py's full profile (bench.py:608-636): the pipelined loop four
# deep, the unified step, persistent slots, on-device finish, chains of
# 32, and fused prompt-lookup speculation (4 drafts from 2-grams)
SPEC_FULL = dict(overlap_scheduling=True, pipelined_loop=True,
                 unified_step=True, overlap_depth=4, multi_step_decode=32,
                 ondevice_finish=True, decode_slot_batching=True,
                 spec_decode="ngram", spec_k=4, spec_ngram=2, spec_fused=True)
# the host-driven runs' tok/s on the draft-friendly workload while their
# verify steps ran eagerly (H100 80GB HBM3, 700.00 W)
HOST_DRIVEN_BEFORE = {"llama": 848.4, "deepseek": 970.5}
# the host-driven run: the sync loop, whose decode rows carry drafts that
# an eager verify step checks (the legacy kernels: K1 / K1m)
SPEC_HOST = dict(spec_decode="ngram", spec_k=4, spec_ngram=2)
# the sequence buckets of the spec phase's 16 requests, which the spec
# engines warm
SPEC_BUCKETS = (8, 16)
# the spec phase's DeepSeek-V2-Lite keeps its full width and 8 of its 27
# layers (1 dense, 7 MoE): at full depth its spec engines took 108.9 s,
# and the whole smoke 1060.6 s of its 1200 s limit, on an H100 80GB HBM3
# (700 W) with a slow host
SPEC_DEEPSEEK_LAYERS = 8
# float32 greedy streams of the spec engines may part from the plain sync
# engine's only at a token where the plain engine's two largest logits lie
# closer than this: the verify rows' attention (K1u's ragged class) and the
# plain engine's decode steps (its decode blocks) sum in another order
SPEC_GAP_TOL = 1e-3
# a float32 sampled stream (temperature 1) of the looping Llama may part
# from the plain greedy stream only where the plain engine's top two
# logits lie within this: a draw off a token that leads every other of
# the 128256 by 40 has a chance under 128256 * e^-40, about 5e-13
SPEC_SAMPLED_GAP = 40.0
# the repetition penalty of the looping Llama's penalized parity run
PENALTY_PARITY_REP = 100.0


def drafty_workload(vocab, n=16):
    """Prompts of one seeded segment of 8..32 tokens repeated to 128..960
    tokens, with 64..128 output tokens: prompt lookup drafts from them as
    soon as the output repeats."""
    rng = np.random.default_rng(SEED + 7)
    prompts, max_tokens = [], []
    for _ in range(n):
        seg = rng.integers(1, vocab, int(rng.integers(8, 33))).tolist()
        length = int(rng.integers(128, 961))
        prompts.append((seg * (length // len(seg) + 1))[:length])
        max_tokens.append(int(rng.integers(64, 129)))
    return prompts, max_tokens


def serving_workload(vocab):
    """The serve phase's 16 requests."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 1537, 16)
    max_tokens = rng.integers(32, 129, 16)
    return ([rng.integers(1, vocab, int(n)).tolist() for n in lens],
            [int(m) for m in max_tokens])


def spec_run(e, prompts, max_tokens, temperature=0.0, extras=None):
    """One generate through ``e`` (greedy unless ``temperature``; each
    request's further sampling options in ``extras``): (tok/s, streams,
    the run's counts: dispatches by kind, drafts proposed and accepted,
    verify steps, blocks by K, sub-steps, spec tokens by kind, output
    tokens)."""
    from gllm_tpu_torch import SamplingParams
    extras = extras or [{}] * len(prompts)
    params = [SamplingParams(temperature=temperature, max_tokens=m,
                             ignore_eos=True, **x)
              for m, x in zip(max_tokens, extras)]
    before = (collections.Counter(e.dispatches),
              dict(e.scheduler.spec_stats), e.verify_steps,
              collections.Counter(e.blocks), e.block_substeps,
              collections.Counter(e.spec_tokens))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    outs = e.generate(prompt_token_ids=prompts, sampling_params=params)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    streams = [o.output_token_ids for o in outs]
    n_out = sum(len(s) for s in streams)
    disp = collections.Counter(e.dispatches) - before[0]
    by_kind = collections.Counter()
    for (kind, _), n in disp.items():
        by_kind[kind] += n
    stats = {k: v - before[1][k] for k, v in e.scheduler.spec_stats.items()}
    return n_out / wall, streams, dict(
        dispatches=dict(by_kind), proposed=stats["proposed"],
        accepted=stats["accepted"],
        accept_rate=(stats["accepted"] / stats["proposed"]
                     if stats["proposed"] else None),
        tokens_per_dispatch=n_out / max(1, sum(by_kind.values())),
        verify_steps=e.verify_steps - before[2],
        blocks=dict(collections.Counter(e.blocks) - before[3]),
        substeps=e.block_substeps - before[4],
        spec_tokens=dict(collections.Counter(e.spec_tokens) - before[5]),
        output_tokens=n_out)


def spec_family(name, model, by_kind):
    """One family at full width, bf16: the spec engine under SPEC_FULL
    (sized from the card's memory, warmed at SPEC_BUCKETS), its absorb
    twin (the serve phase's flags, no speculation) and a host-driven twin
    (SPEC_HOST), on one set of weights. The serving workload and the
    draft-friendly one each run spec, absorb, absorb, spec (then one
    host-driven run of the draft-friendly one): tok/s and their medians,
    acceptance, tokens per dispatch, sub-steps, dispatches and blocks by
    K. The spec runs launch only ``by_kind['spec']`` (and no plain
    version), the host-driven run ``by_kind['host']``; the spec engine's
    blocks are spec blocks replayed as CUDA graphs it warmed (none
    captured while it runs), and the greedy streams of the three engines
    are reported side by side (bf16 rows depend on their batch)."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, SamplingParams
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    spec = LLM(model_cfg=model(), config=EngineConfig(
        load_format="dummy", dtype="bfloat16", seed=SEED, **SPEC_FULL))
    warm = SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True)
    spec.generate(prompt_token_ids=[[1, 2, 3, 4]], sampling_params=warm)
    t1 = time.monotonic()
    spec.runner.warmup(decode_buckets=SPEC_BUCKETS, block_buckets=SPEC_BUCKETS)
    g = spec.runner.graphs
    warmed = set(g.keys)
    log(f"[spec {name}] spec engine ({SPEC_FULL}): up in {t1 - t0:.1f} s, "
        f"{spec.runner.num_pages} KV pages, activation headroom "
        f"{spec.runner.activation_headroom() / 2**30:.2f} GiB; warmup "
        f"{time.monotonic() - t1:.2f} s: {len(g)} graphs "
        f"({sum(k[0] == 'spec' for k in g.keys)} spec blocks), pool "
        f"{g.pool_bytes() / 2**20:.1f} MiB; memory by pool: "
        f"{memory_breakdown(HOLDERS)}")
    absorb = block_twin(name, "absorb", spec, "auto",
                        dict(unified_step=True), ABSORB)
    host = LLM(model_cfg=spec.model_cfg, params=spec.runner.params,
               config=EngineConfig(load_format="dummy", dtype="bfloat16",
                                   seed=SEED, cache=CacheConfig(
                                       num_pages=TWIN_PAGES), **SPEC_HOST))
    host.generate(prompt_token_ids=[[1, 2, 3, 4]], sampling_params=warm)
    host.runner.warmup(decode_buckets=SPEC_BUCKETS)
    # the mixed pass (the warm-up request's prefill is a key of its own)
    assert host.runner.graphs.by_kind["mixed"]["captured"] >= \
        2 * len(SPEC_BUCKETS)
    vocab = spec.model_cfg.vocab_size
    counts = collections.Counter()
    host_counts = collections.Counter()
    out = {}
    for label, (prompts, max_tokens) in (
            ("serving", serving_workload(vocab)),
            ("draft-friendly", drafty_workload(vocab))):
        rates = {"spec": [], "absorb": []}
        runs = {}
        for e, mode in ((spec, "spec"), (absorb, "absorb"),
                        (absorb, "absorb"), (spec, "spec")):
            reset_counters()
            replays0 = g.replays
            before = graph_counts(e)
            rate, streams, c = spec_run(e, prompts, max_tokens)
            d = graph_delta(e, before)
            assert sum(d["eager"].values()) == 0, \
                f"[spec {name}] {mode}: eager mixed steps {d['eager']}"
            launched = read_counters()
            rates[mode].append(rate)
            runs.setdefault(mode, []).append((streams, c))
            if mode == "spec":
                counts.update(launched)
                assert launched["plain_calls"] == 0, \
                    f"[spec {name}] a plain version ran on the card"
                bad = {k for k, n in launched.items()
                       if n and k != "plain_calls"} - set(by_kind["spec"])
                assert not bad, f"[spec {name}] the spec run launched {bad}"
                assert g.replays > replays0, \
                    f"[spec {name}] no CUDA graph replayed"
                log(f"[spec {name}] {label} spec run: {rate:.1f} tok/s; "
                    f"{c}; launches { {k: n for k, n in launched.items() if n} }")
            else:
                log(f"[spec {name}] {label} absorb run: {rate:.1f} tok/s; "
                    f"dispatches {c['dispatches']}, sub-steps "
                    f"{c['substeps']}, blocks by K {c['blocks']}")
        new = {k for k in g.keys - warmed if k[0] in ("spec", "mixed")}
        assert not new, f"[spec {name}] spec blocks or mixed steps " \
            f"captured while serving: {new}"
        ratio = median(rates["spec"]) / median(rates["absorb"])
        c = runs["spec"][-1][1]
        same = [runs["spec"][-1][0] == runs["absorb"][-1][0],
                runs["spec"][0][0] == runs["spec"][-1][0]]
        log(f"[spec {name}] {label}: spec {[round(r, 1) for r in rates['spec']]}"
            f" tok/s against the absorb twin's "
            f"{[round(r, 1) for r in rates['absorb']]} ({ratio:.3f}x of "
            f"medians); acceptance {c['accept_rate']}, tokens per dispatch "
            f"{c['tokens_per_dispatch']:.2f}, sub-steps {c['substeps']}, "
            f"dispatches {c['dispatches']}, blocks by K {c['blocks']}, spec "
            f"tokens {c['spec_tokens']}; greedy streams: spec = absorb "
            f"{same[0]}, spec run 1 = run 2 {same[1]} (on {SMI})")
        out[label] = dict(spec_rates=rates["spec"],
                          absorb_rates=rates["absorb"], ratio=ratio, **c)
        if label == "draft-friendly":
            assert sum(c["blocks"].values()) > 0 and c["proposed"] > 0, \
                f"[spec {name}] no spec block or no draft: {c}"
            # twice: the first run captures the verify keys its token
            # buckets meet (the legacy step's mixed keys follow the token
            # bucket), the second replays them
            hg = host.runner.graphs
            host_rates = []
            for rep in range(2):
                reset_counters()
                before = graph_counts(host)
                rate, streams, hc = spec_run(host, prompts, max_tokens)
                launched = read_counters()
                host_counts.update(launched)
                d = graph_delta(host, before)
                host_rates.append(rate)
                bad = {k for k, n in launched.items()
                       if n and k != "plain_calls"} - set(by_kind["host"])
                assert not bad and launched["plain_calls"] == 0, \
                    f"[spec {name}] the host-driven run launched {launched}"
                assert hc["verify_steps"] > 0, \
                    f"[spec {name}] the host-driven run verified nothing"
                assert d["replays"]["verify"] == hc["verify_steps"], \
                    f"[spec {name}] {hc['verify_steps']} verify steps but " \
                    f"{d['replays']['verify']} verify replays"
                assert sum(d["eager"].values()) == 0, \
                    f"[spec {name}] eager mixed steps {d['eager']}"
                log(f"[spec {name}] {label} host-driven run {rep + 1} (sync "
                    f"loop): {rate:.1f} tok/s (before mixed-step capture: "
                    f"{HOST_DRIVEN_BEFORE[name]}); verify steps replayed "
                    f"{d['replays']['verify']} of {hc['verify_steps']}, "
                    f"other mixed steps replayed {d['replays']['mixed']}, "
                    f"eager {sum(d['eager'].values())}; keys captured "
                    f"{d['captured']} in "
                    f"{sum(d['capture_s'].values()):.2f} s; {hc}; streams "
                    f"= spec {streams == runs['spec'][-1][0]}")
            assert not graph_delta(host, before)["captured_total"], \
                f"[spec {name}] the second host-driven run captured"
            out["host"] = dict(rate=host_rates[-1], rates=host_rates, **hc)
    for e in (spec, absorb, host):
        assert not e.has_unfinished and \
            e.memory_manager.num_free_pages == \
            e.memory_manager.allocator.num_total, \
            f"[spec {name}] pages held after the runs"
    assert split_counters_clear(), f"[spec {name}] split counters not zero"
    weights = spec.runner.params
    del spec, absorb, host
    return out, dict(counts), dict(host_counts), weights


def plain_top2_gap(plain, prompt, prefix):
    """The plain engine's two largest logits' gap after ``prompt`` and
    ``prefix``, prefilled in one sequence of its own."""
    from gllm_tpu_torch import SamplingParams
    seq = plain._allocate_seq(prompt + prefix, SamplingParams(
        temperature=0.0, max_tokens=1, ignore_eos=True))
    plain.add_seq(seq)
    while True:
        batch = plain.scheduler.schedule_once()
        dev, max_q = plain.runner.prepare(batch)
        logits = plain.runner.forward_logits(dev, max_q)[0].float()
        plain.scheduler.process_output(batch, [int(logits.argmax())],
                                       plain.eos_token_ids)
        if seq.num_output_tokens:
            break
    top = torch.topk(logits, 2).values
    return (top[0] - top[1]).item()


def looping_llama(cfg, params, n=8):
    """Float32 Llama-3.2-1B weights whose greedy stream loops and leaves
    the loop prompt lookup drafts from, and their prompts. The tied dummy
    Llama's greedy stream repeats its last token (its input embedding
    leads the final hidden state), so an untied head whose column j is
    the embedding of the token that j follows walks a successor map
    instead. Each of the ``n`` requests has a segment of 6..12 tokens,
    repeated to a prompt of 128..512 tokens, and a detour of 2..5 other
    tokens: the map runs through the segment, leaves it into the detour
    after one of its tokens and comes back to the next one; every token is
    drawn once. Prompt lookup drafts the segment from the prompt, up to 4
    tokens a row, the detour rejects them, and the stream's own earlier
    loop drafts the rest. Returns (the untied config, weights with
    ``lm_head``, prompts)."""
    rng = np.random.default_rng(SEED + 11)
    lens, detours = rng.integers(6, 13, n), rng.integers(2, 6, n)
    toks = rng.choice(np.arange(1, cfg.vocab_size),
                      int(lens.sum() + detours.sum()), replace=False)
    succ = np.arange(cfg.vocab_size)
    prompts, at = [], 0
    for length, m in zip(lens, detours):
        seg, det = toks[at:at + length], toks[at + length:at + length + m]
        at += length + m
        b = int(rng.integers(length))
        loop = [*seg[:b + 1], *det, *seg[b + 1:]]
        succ[loop] = loop[1:] + loop[:1]
        size = int(rng.integers(128, 513))
        prompts.append((seg.tolist() * (size // length + 1))[:size])
    # column j of the head: the embedding of the token whose successor is j
    follows = torch.as_tensor(np.argsort(succ), device=params["embed"].device)
    params = dict(params, lm_head=params["embed"][follows].t().contiguous())
    cfg = dataclasses.replace(cfg, tie_word_embeddings=False)
    return cfg, params, prompts


def spec_parity(label, cfg, params, prompts=None):
    """Float32 greedy streams of the fused spec engine and the host-driven
    one against the plain sync engine's (8 requests of 48 tokens; the
    draft-friendly workload unless ``prompts``): equal, or parting only
    where the plain engine's top two logits lie within SPEC_GAP_TOL. With
    ``prompts`` (the looping Llama's) each spec engine must also reject
    some drafts and accept some, and draft more than one token a row a
    step on average; and its sampled rows (temperature 1) must reject
    drafts too (the residual resample) and keep to the plain greedy
    streams but where the top-two gap is under SPEC_SAMPLED_GAP."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM
    varies = prompts is not None
    if not varies:
        prompts, _ = drafty_workload(cfg.vocab_size, n=8)
    max_tokens = [48] * len(prompts)
    engines = {}
    for mode, flags in (("plain", {}), ("fused", SPEC_FULL),
                        ("host", SPEC_HOST)):
        engines[mode] = LLM(model_cfg=cfg, params=params, config=EngineConfig(
            dtype="float32", seed=SEED, cache=CacheConfig(num_pages=4096),
            **flags))
    want = spec_run(engines["plain"], prompts, max_tokens)[1]
    for mode in ("fused", "host"):
        for temp in (0.0, 1.0) if varies else (0.0,):
            _, got, c = spec_run(engines[mode], prompts, max_tokens, temp)
            what = f"f32 {mode}{' sampled' if temp else ''}"
            rows = c["output_tokens"] - c["accepted"]
            counts = (f"{c['accepted']} of {c['proposed']} drafts accepted, "
                      f"{c['proposed'] / rows:.2f} drafts a row a step, "
                      f"{c['verify_steps']} verify steps, blocks "
                      f"{c['blocks']}, spec tokens {c['spec_tokens']}")
            where = first_difference(got, want)
            if where is None:
                log(f"[spec {label}] {what}: streams equal the plain "
                    f"engine's greedy streams ({counts})")
            else:
                i, j = where
                gap = plain_top2_gap(engines["plain"], prompts[i],
                                     want[i][:j])
                tol = SPEC_SAMPLED_GAP if temp else SPEC_GAP_TOL
                log(f"[spec {label}] {what}: streams part at request {i}, "
                    f"output token {j} ({got[i][j]} against {want[i][j]}); "
                    f"the plain engine's top-two logit gap there {gap} "
                    f"(tolerance {tol}); {counts}")
                assert gap < tol, \
                    f"[spec {label}] {what} parts from the plain engine " \
                    f"at a gap of {gap}"
            assert c["proposed"] > 0, f"[spec {label}] {what}: no draft"
            if varies:
                assert 0 < c["accepted"] < c["proposed"], \
                    f"[spec {label}] {what}: no draft rejected or none " \
                    f"accepted ({counts})"
                assert c["proposed"] > rows, \
                    f"[spec {label}] {what}: at most one draft a row a " \
                    f"step ({counts})"
                assert mode == "host" or c["spec_tokens"].get("rejected"), \
                    f"[spec {label}] {what}: no rejected spec token"
    if varies:
        # the successor's logit leads every other by far more than a bias
        # of 100 can move: on every other row a repetition penalty of
        # PENALTY_PARITY_REP (any value > 0 is valid) divides the seen
        # tokens' logits below the unseen ones', so its stream leaves the
        # loop; the other rows keep their loops, and their drafts, under
        # mild penalties that the adjusted verify rows apply
        extras = [dict(presence_penalty=0.5, frequency_penalty=0.2,
                       repetition_penalty=(PENALTY_PARITY_REP if i % 2 == 0
                                           else 1.1),
                       logit_bias={p[len(p) // 2]: -100.0})
                  for i, p in enumerate(prompts)]
        want_pen = spec_run(engines["plain"], prompts, max_tokens,
                            extras=extras)[1]
        assert want_pen != want, \
            f"[spec {label}] the penalties changed no stream"
        for mode in ("fused", "host"):
            _, got, c = spec_run(engines[mode], prompts, max_tokens,
                                 extras=extras)
            log(f"[spec {label}] f32 {mode}, penalties and logit_bias: "
                f"streams equal the plain engine's: {got == want_pen} "
                f"({c['accepted']} of {c['proposed']} drafts accepted, "
                f"{c['verify_steps']} verify steps, dispatches "
                f"{c['dispatches']})")
            assert got == want_pen, \
                f"[spec {label}] f32 {mode} with penalties and logit_bias " \
                f"parts from the plain engine at " \
                f"{first_difference(got, want_pen)}"
            assert mode == "fused" or c["verify_steps"] > 0, \
                f"[spec {label}] no verify step under penalties"
    for e in engines.values():
        assert e.memory_manager.num_free_pages == \
            e.memory_manager.allocator.num_total


def phase_spec():
    """Prompt-lookup speculation at full width: Llama-3.2-1B and
    DeepSeek-V2-Lite with its depth cut to SPEC_DEEPSEEK_LAYERS
    (spec_family), then float32 parity: Llama-3.2-1B at
    full width with its looping head (looping_llama) and DeepSeek-V2-Lite
    at full width with its depth cut to 3 layers (its weights alone are
    about 63 GB at float32). Returns the
    launch counts of the spec runs and the host-driven runs, by the
    configuration names the kernels line reads."""
    from gllm_tpu_torch.models import deepseek, dense
    out = {}
    for name, model, by_kind in (
            ("llama", llama_3_2_1b,
             {"spec": ("ragged_paged_attention_unified",),
              "host": ("ragged_paged_attention", "paged_decode_attention")}),
            ("deepseek", lambda: deepseek_v2_lite(
                num_hidden_layers=SPEC_DEEPSEEK_LAYERS),
             {"spec": ("ragged_paged_attention_unified_mla",),
              "host": ("ragged_paged_attention_mla",
                       "paged_decode_attention_mla")})):
        t0 = time.monotonic()
        res, counts, host_counts, weights = spec_family(name, model, by_kind)
        del weights
        out[f"spec_{name}"] = dict(res, counts=counts)
        out[f"spec_{name}_host"] = dict(counts=host_counts)
        log(f"[spec {name}] wall {time.monotonic() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    llama, params, prompts = looping_llama(
        llama_3_2_1b(), dense.init_params(llama_3_2_1b(), SEED,
                                          torch.float32, "cuda"))
    spec_parity("looping llama f32", llama, params, prompts)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ds = deepseek_v2_lite(num_hidden_layers=3)
    spec_parity("deepseek f32 (3 layers)", ds,
                deepseek.init_params(ds, SEED, torch.float32, "cuda"))
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- 7. sampling ---------------------------------------------------------

# the sampling phase's engine: Llama-3.2-1B at full width under the absorb
# flags (the unified step under overlap, persistent slots, blocks under
# on-device finish), warmed at the 16 requests' sequence buckets
SAMPLING_BUCKETS = (8, 16)
# The dummy Llama's tied embeddings (scale 1, width 2048) give the last
# token's repeat a logit near |e|^2 = 2048, against about N(0, 45^2) for
# the others: no bias in [-100, 100] moves its greedy choice. The rows
# that test logit_bias flatten that first with this repetition penalty
# (any value > 0 is valid): the seen tokens' logits fall near 0, the
# unseen ones' top two lie about 10 apart, and a bias of 100 decides
FLAT_REP = 1e4


def sampling_probe(llm, prompts):
    """The top two tokens of each prompt's first step under FLAT_REP
    (greedy, logprobs 2): what the logit_bias rows bias."""
    from gllm_tpu_torch import SamplingParams
    sp = SamplingParams(temperature=0.0, repetition_penalty=FLAT_REP,
                        logprobs=2, max_tokens=1, ignore_eos=True)
    outs = llm.generate(prompt_token_ids=prompts,
                        sampling_params=[sp] * len(prompts))
    return [o.logprobs[0][1] for o in outs]


def sampling_params(top2, max_tokens):
    """The sampling phase's 16 requests' options, by request index mod 8:
    0, 1 seeded sampled rows (temperature 0.8, top-p 0.95); 2 presence and
    frequency penalties, 3 the repetition penalty (greedy); 4 a +100
    logit_bias on the second of the request's ``top2`` (greedy, FLAT_REP);
    5 a -100 logit_bias on the first (greedy, FLAT_REP); 6 logprobs 5 and
    prompt logprobs 1 (greedy); 7 logprobs 5 on a seeded sampled row."""
    from gllm_tpu_torch import SamplingParams
    kinds = [
        lambda i: dict(temperature=0.8, top_p=0.95, seed=SEED + 100 + i),
        lambda i: dict(temperature=0.8, top_p=0.95, seed=SEED + 100 + i),
        lambda i: dict(temperature=0.0, presence_penalty=0.5,
                       frequency_penalty=0.3),
        lambda i: dict(temperature=0.0, repetition_penalty=1.3),
        lambda i: dict(temperature=0.0, repetition_penalty=FLAT_REP,
                       logit_bias={top2[i][1]: 100.0}),
        lambda i: dict(temperature=0.0, repetition_penalty=FLAT_REP,
                       logit_bias={top2[i][0]: -100.0}),
        lambda i: dict(temperature=0.0, logprobs=5, prompt_logprobs=1),
        lambda i: dict(temperature=0.8, seed=SEED + 100 + i, logprobs=5)]
    return [SamplingParams(max_tokens=m, ignore_eos=True, **kinds[i % 8](i))
            for i, m in enumerate(max_tokens)]


def check_sampling_outputs(outs, params, top2):
    """The sampling phase's checks on one run: every request finishes
    with its count; a +100-biased row's first token is its biased one
    (second without the bias), a -100-biased row never emits its biased
    one (first without the bias); logprobs <= 0 with top lists sorted, a
    greedy row's chosen logprob its top one (within 1e-5), and prompt
    logprobs of every prompt position but the first."""
    for i, (o, sp) in enumerate(zip(outs, params)):
        assert o.num_output_tokens == sp.max_tokens, \
            f"[sampling] request {i}: {o.num_output_tokens} tokens, not " \
            f"{sp.max_tokens}"
        toks = o.output_token_ids
        if sp.logit_bias and top2[i][1] in sp.logit_bias:
            assert toks[0] == top2[i][1], \
                f"[sampling] request {i}: +100 bias on {top2[i][1]}, " \
                f"first token {toks[0]}"
        elif sp.logit_bias:
            assert top2[i][0] not in toks, \
                f"[sampling] request {i}: -100 bias on {top2[i][0]}"
        if sp.logprobs is not None:
            assert len(o.logprobs) == len(toks)
            for t, (chosen, ids, lps) in zip(toks, o.logprobs):
                assert chosen <= 0 and all(x <= 0 for x in lps)
                assert len(ids) == sp.logprobs and \
                    all(a >= b for a, b in zip(lps, lps[1:]))
                if sp.temperature == 0.0:
                    assert abs(chosen - lps[0]) <= 1e-5, \
                        f"[sampling] request {i}: greedy {t} chosen " \
                        f"{chosen}, top {ids[0]} {lps[0]}"
        if sp.prompt_logprobs is not None:
            plp = o.prompt_logprobs
            assert len(plp) == len(o.prompt_token_ids) and plp[0] is None
            assert all(e[0] <= 0 and len(e[1]) == 1 for e in plp[1:])


EXTRAS_KINDS = ("decode_extras", "mixed_extras", "verify_extras")
# the sampling phase's numbers while extras steps ran eagerly (H100 80GB
# HBM3, 700.00 W): its tok/s ratio against the plain twin and the host
# launch calls an eager extras dispatch made
SAMPLING_BEFORE = dict(ratio=0.154, launch_calls="918-935")


def upload_cost(llm, iters=10):
    """The extras' upload at its widest: ``max_seqs`` decode rows whose
    penalty ids fill ``max_model_len`` (a repetition penalty, a logit_bias
    pair and logprobs each): the host's fill (the batch built and packed
    into the pinned buffer) and the copy's device time, medians of
    ``iters``; and the MiB copied."""
    from gllm_tpu_torch import SamplingParams
    from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq
    from gllm_tpu_torch.sequence import Sequence
    runner = llm.runner
    b = runner.builder
    ctx = b.penalty_len - 2
    sp = SamplingParams(temperature=0.0, max_tokens=1, logprobs=1,
                        repetition_penalty=1.1, logit_bias={5: 1.0})
    items = []
    for i in range(b.max_seqs):
        seq = Sequence(i, [1 + (j % 1000) for j in range(ctx + 1)], sp)
        seq.page_table = [0] * b.max_pages_per_seq
        seq.num_computed_tokens = ctx
        items.append(ScheduledSeq(seq, 1, ctx))
    batch = ScheduledBatch(items)
    fill, copy = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = b.build(batch)[0]
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        runner.staging.upload(host)
        end.record()
        fill.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        copy.append(start.elapsed_time(end))
    n = b.upload_size(*host.token_ids.shape, *host.attn.page_table.shape) \
        + b.extras_size(host.token_ids.size, b.max_seqs)
    return dict(rows=b.max_seqs, penalty_len=b.penalty_len,
                mib=n * 4 / 2**20, fill_ms=median(fill),
                copy_ms=median(copy))


def extras_launch_calls(llm, prompts, params):
    """Host calls that launch work inside each extras dispatch (a single
    step whose batch carries extras), over a run of ``prompts`` (8 tokens
    each) under torch.profiler, the steps marked with record_function,
    after the same run unprofiled (whose keys it captures first):
    (calls a dispatch, dispatches)."""
    from bisect import bisect_right
    from torch.profiler import ProfilerActivity, profile, record_function
    runner = llm.runner
    step_async = runner.step_async

    def marked(batch, prev=None, **kw):
        tag = ("gllm_extras" if runner.builder.batch_extras(batch)
               else "gllm_plain")
        with record_function(tag):
            return step_async(batch, prev, **kw)
    short = [dataclasses.replace(sp, max_tokens=8) for sp in params]
    llm.generate(prompt_token_ids=prompts, sampling_params=short)
    runner.step_async = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            llm.generate(prompt_token_ids=prompts, sampling_params=short)
    finally:
        del runner.step_async
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "gllm_extras")
    starts = [a for a, _ in spans]
    calls = 0
    for e in events:
        if e.name in LAUNCH_CALLS:
            i = bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start <= spans[i][1]:
                calls += 1
    return calls / max(1, len(spans)), len(spans)


def phase_sampling():
    """Sampling completeness at full width, bf16: Llama-3.2-1B under the
    absorb flags (warmed at SAMPLING_BUCKETS) serves the serve phase's 16
    prompts with the options of ``sampling_params`` and, as its plain
    twin, as greedy rows, runs plain, sampling, sampling, plain: tok/s and
    the ratio of medians, the extras steps and how they ran (every one
    replays its extras key: the first sampling run may capture keys at
    first sight, as JAX compiles them, and the second captures none), the
    kernels launched (K1u and the seeded-Gumbel kernel, no plain version),
    host launch calls an extras dispatch (a profiled run) and the extras
    upload's cost at its widest (``upload_cost``). The seeded rows must
    repeat between the two sampling runs (the same batches), and
    ``check_sampling_outputs`` hold. Returns the launch counts of the
    sampling runs under the name the kernels line reads."""
    from gllm_tpu_torch import EngineConfig, LLM, SamplingParams
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    llm = LLM(model_cfg=llama_3_2_1b(), config=EngineConfig(
        load_format="dummy", dtype="bfloat16", seed=SEED, unified_step=True,
        **ABSORB))
    llm.runner.warmup(decode_buckets=SAMPLING_BUCKETS,
                      block_buckets=SAMPLING_BUCKETS)
    g = llm.runner.graphs
    warmed = len(g)
    log(f"[sampling] absorb engine ({dict(ABSORB, unified_step=True)}) up "
        f"and warmed in {time.monotonic() - t0:.1f} s: {warmed} graphs, "
        f"{llm.runner.num_pages} KV pages, extras reckoned "
        f"{llm.runner.extras_pool_bytes() / 2**20:.1f} MiB of the "
        f"headroom's {llm.runner.activation_headroom() / 2**20:.1f}")
    prompts, max_tokens = serving_workload(llm.model_cfg.vocab_size)
    plain = [SamplingParams(temperature=0.0, max_tokens=m, ignore_eos=True)
             for m in max_tokens]
    pool0 = g.pool_bytes()
    top2 = sampling_probe(llm, prompts)
    params = sampling_params(top2, max_tokens)
    rates = {"plain": [], "sampling": []}
    streams, counts = {}, collections.Counter()
    captures = []
    for mode in ("plain", "sampling", "sampling", "plain"):
        steps0, blocks0 = dict(llm.step_counts), dict(llm.blocks)
        before = graph_counts(llm)
        reset_counters()
        ps = plain if mode == "plain" else params
        torch.cuda.synchronize()
        t1 = time.monotonic()
        outs = llm.generate(prompt_token_ids=prompts, sampling_params=ps)
        torch.cuda.synchronize()
        wall = time.monotonic() - t1
        launched = read_counters()
        d = graph_delta(llm, before)
        n_out = sum(o.num_output_tokens for o in outs)
        rates[mode].append(n_out / wall)
        toks = [o.output_token_ids for o in outs]
        steps = {k: llm.step_counts[k] - steps0.get(k, 0)
                 for k in llm.step_counts}
        blocks = dict(collections.Counter(llm.blocks)
                      - collections.Counter(blocks0))
        # every single step replays a key: extras steps their extras keys
        assert d["replays"]["decode_extras"] == steps["extras"], d
        assert d["replays"]["decode"] == steps["decode"], d
        line = mixed_line(f"sampling {mode}", llm, d)
        if mode == "sampling":
            check_sampling_outputs(outs, params, top2)
            counts.update(launched)
            assert launched["plain_calls"] == 0, \
                "[sampling] a plain version ran on the card"
            bad = {k for k, n in launched.items() if n and k not in (
                "plain_calls", "ragged_paged_attention_unified",
                "seeded_gumbel")}
            assert not bad and launched["seeded_gumbel"] > 0, \
                f"[sampling] the run launched {launched}"
            assert steps["extras"] + d["replays"]["mixed_extras"] > 0
            captures.append(d)
        else:
            assert not d["captured_total"], \
                f"[sampling] the plain run captured {d['captured']}"
        assert streams.setdefault(mode, toks) == toks, \
            f"[sampling] two {mode} runs gave different streams " \
            f"(first difference {first_difference(streams[mode], toks)})"
        extras = {k: d["replays"][k] for k in EXTRAS_KINDS}
        new = {k: n for k, n in d["captured"].items() if n}
        log(f"[sampling] {mode} run: {n_out} tokens in {wall:.3f} s = "
            f"{n_out / wall:.1f} output tok/s; steps by kind {steps} "
            f"(extras replays by kind {extras}), {line}; graphs captured "
            f"{d['captured_total']} ({new}, "
            f"{sum(d['capture_s'].values()):.3f} s); blocks by K "
            f"{blocks}, launches { {k: n for k, n in launched.items() if n} }")
    first, second = captures
    assert not second["captured_total"], \
        f"[sampling] the second sampling run captured {second['captured']}"
    pool_mib = (g.pool_bytes() - pool0) / 2**20
    ratio = median(rates["sampling"]) / median(rates["plain"])
    per, n_disp = extras_launch_calls(llm, prompts, params)
    cost = upload_cost(llm)
    log(f"[sampling] sampling {[round(r, 1) for r in rates['sampling']]} "
        f"tok/s against the plain greedy twin's "
        f"{[round(r, 1) for r in rates['plain']]} ({ratio:.3f}x of "
        f"medians; before extras-step capture {SAMPLING_BEFORE['ratio']}x);"
        f" extras keys captured at first sight (probe and run 1) "
        f"{sum(g.by_kind[k]['captured'] for k in EXTRAS_KINDS)} in "
        f"{sum(g.by_kind[k]['capture_s'] for k in EXTRAS_KINDS):.3f} s, "
        f"pools grew {pool_mib:.1f} MiB (extras reckoned "
        f"{llm.runner.extras_pool_bytes() / 2**20:.1f} MiB); run 2 "
        f"captured none; {per:.2f} host launch calls an extras dispatch "
        f"({n_disp} dispatches profiled; eager before: "
        f"{SAMPLING_BEFORE['launch_calls']}); the extras upload at S "
        f"{cost['rows']}, {cost['penalty_len']} penalty ids a row "
        f"({cost['mib']:.2f} MiB): host fill {cost['fill_ms']:.3f} ms, "
        f"copy {cost['copy_ms']:.3f} ms; seeded rows repeat between the "
        f"two runs; on {SMI}")
    assert not llm.has_unfinished and llm.memory_manager.num_free_pages \
        == llm.memory_manager.allocator.num_total
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    return {"sampling": dict(counts=dict(counts), rates=rates, ratio=ratio,
                             graphs_captured=first["captured_total"],
                             extras_pool_mib=pool_mib,
                             launch_calls=per, upload=cost)}


# ---- 8. tracing ----------------------------------------------------------

# the tracing twins' expected on/off throughput ratio (the layer's budget:
# 2% of throughput); the run prints the ratio beside it, it does not fail
# on it
TRACING_RATIO_EXPECTED = 0.98


def phase_tracing():
    """The tracing layer's cost and identity: two Llama-3.2-1B engines at
    full width under the absorb flags (the unified step under the
    pipelined loop, persistent slots, blocks of 16 under on-device finish)
    on the same weights and TWIN_PAGES KV pages each, one with
    ``tracing`` on (request spans) and one with it off (the step-trace
    ring stays on in both), warmed at SERVE_BUCKETS, serve the serve
    phase's 16 greedy requests, runs on, off, on, off: tok/s of each run
    and the on/off ratio of medians (beside TRACING_RATIO_EXPECTED), the
    greedy streams identical (else the run fails), the traced engine's
    last run's window summary (``attribution``, its hard checks), and its
    span trees: one closed for each request, none left open; none kept by
    the untraced engine. Each engine serves the workload once, unmeasured,
    before the runs."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, SamplingParams
    from gllm_tpu_torch.obs.steptrace import TRACE
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    flags = dict(ABSORB, unified_step=True)
    engines = {}
    params = None
    for mode in ("on", "off"):
        engines[mode] = LLM(model_cfg=llama_3_2_1b(), params=params,
                            config=EngineConfig(
                                load_format="dummy", dtype="bfloat16",
                                seed=SEED, tracing=mode == "on",
                                cache=CacheConfig(num_pages=TWIN_PAGES),
                                **flags))
        engines[mode].runner.warmup(decode_buckets=SERVE_BUCKETS,
                                    block_buckets=SERVE_BUCKETS)
        params = engines[mode].runner.params
    on, off = engines["on"], engines["off"]
    log(f"[tracing] twins ({flags}, {TWIN_PAGES} KV pages each, tracing "
        f"on and off) up and warmed in {time.monotonic() - t0:.1f} s")
    prompts, max_tokens = serving_workload(on.model_cfg.vocab_size)
    sps = [SamplingParams(temperature=0.0, max_tokens=m, ignore_eos=True)
           for m in max_tokens]
    # one unmeasured run each (first-sight costs), then the spans start
    # from none
    for e in (on, off):
        e.generate(prompt_token_ids=prompts, sampling_params=sps)
    on.spans.clear()
    rates = {"on": [], "off": []}
    streams = []
    for mode in ("on", "off", "on", "off"):
        e = engines[mode]
        torch.cuda.synchronize()
        mark = TRACE.mark()
        t1 = time.monotonic()
        outs = e.generate(prompt_token_ids=prompts, sampling_params=sps)
        torch.cuda.synchronize()
        wall = time.monotonic() - t1
        n_out = sum(o.num_output_tokens for o in outs)
        assert n_out == sum(max_tokens), "[tracing] a request fell short"
        rates[mode].append(n_out / wall)
        streams.append([o.output_token_ids for o in outs])
        log(f"[tracing] run {len(streams) - 1} (tracing {mode}): {n_out} "
            f"tokens in {wall:.3f} s = {n_out / wall:.1f} output tok/s")
        if mode == "on":
            window = TRACE.events(since=mark)
    where = first_difference(streams[0], streams[1])
    if where is not None or any(x != streams[0] for x in streams):
        raise SystemExit(f"[tracing] traced and untraced greedy streams "
                         f"differ (first at {where})")
    ratio = median(rates["on"]) / median(rates["off"])
    log(f"[tracing] tok/s on {[round(r, 1) for r in rates['on']]}, off "
        f"{[round(r, 1) for r in rates['off']]}: on/off ratio of medians "
        f"{ratio:.4f} (expected at {TRACING_RATIO_EXPECTED} or above) on "
        f"{SMI}; the greedy streams of all four runs identical")
    summary = attribution("[tracing on]", window, True)
    closed = on.spans.spans()
    assert len(closed) == 2 * len(prompts) and on.spans.open_count == 0, \
        f"[tracing] {len(closed)} spans closed, {on.spans.open_count} open"
    assert all(r["reason"] == "length" and r["phases"][0]["ph"] == "queued"
               for r in closed)
    assert not off.spans.spans() and not off.spans.open_count
    phases = collections.Counter(p["ph"] for r in closed
                                 for p in r["phases"])
    log(f"[tracing] spans: {len(closed)} closed for {2 * len(prompts)} "
        f"requests, 0 open, the untraced engine none; child spans by phase "
        f"{dict(phases)}")
    del on, off, engines, e, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"ratio": ratio, "on": rates["on"], "off": rates["off"],
            "summary": summary}


# ---- 9. http -------------------------------------------------------------

# the servers' engines: the smoke's absorb twin (the unified step under
# overlap, persistent slots, blocks of 16 under on-device finish), and
# bench.py's full profile (SPEC_FULL: the same with the pipelined loop four
# deep, chains of 32 and fused speculation); bf16, prefix caching off
# (the default)
HTTP_FLAGS = ("--pipelined-loop", "--unified-step", "--decode-slot-batching",
              "--ondevice-finish")
HTTP_SERVERS = {
    "absorb": HTTP_FLAGS,
    "full profile": HTTP_FLAGS + (
        "--inflight-depth", "4", "--decode-chain-len", "32",
        "--spec-decode", "ngram", "--spec-k", "4", "--spec-ngram", "2",
        "--spec-fused")}
# each server's KV pages, graph pools (MiB) and its first pass's client
# TTFT p50 / p99 (ms) before extras-step capture, the largest-bucket-first
# warmup and the measured pool reckoning (H100 80GB HBM3, 700.00 W)
HTTP_BEFORE = {"absorb": dict(pages=127745, pools=3820.0,
                              ttft_ms=(78.4, 111.5)),
               "full profile": dict(pages=95233, pools=18146.0,
                                    ttft_ms=(93.0, 151.2))}
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
    spec = {k: {x: n - e0[k].get(x, 0) for x, n in e1[k].items()}
            if isinstance(e1[k], dict) else e1[k] - e0[k]
            for k in ("spec_drafts", "verify_steps", "spec_tokens")}
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
           "chain_breaks": breaks, "spec": spec}
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
        f"{out['absorbs']}, speculation {spec} (/server_info); chain "
        f"breaks {breaks} (/metrics)")
    return out


def http_sampling_pass(port, prompts, label):
    """The sampling options over HTTP, one request each (token-array
    completions: the server has no tokenizer): logprobs, top_logprobs, a
    seed (sent twice, it gives the same tokens), penalties, a
    +100 logit_bias on a probe's second token under FLAT_REP (it comes
    first), best_of 3 with n 1, and echo with prompt_logprobs.
    Every answer is 200 in OpenAI's shape. The requests are then sent
    again: every answer 200 again (the seeded one with its tokens), and
    the repeat captures no CUDA graph (the first sending may capture the
    extras keys at first sight). Returns the extras steps both ran."""
    info0 = json.loads(_get(port, "/server_info")[1])["engine_counters"]
    base = {"prompt": prompts[0], "max_tokens": 12, "ignore_eos": True}
    # the first step's top two under FLAT_REP: the +100 bias goes on the
    # second (the phase_sampling probe over HTTP)
    status, probe = _post(port, "/v1/completions", dict(
        base, max_tokens=1, temperature=0.0, repetition_penalty=FLAT_REP,
        logprobs=2))
    assert status == 200, f"[http] {label} probe: {status} {probe}"
    top = probe["choices"][0]["logprobs"]["top_logprobs"][0]
    second = sorted(top, key=top.get, reverse=True)[1]
    reqs = {
        "logprobs": dict(base, temperature=0.0, logprobs=3),
        "top_logprobs": dict(base, temperature=0.0, logprobs=True,
                             top_logprobs=2),
        "seed": dict(base, temperature=0.8, top_p=0.95, seed=7,
                     logprobs=0),
        "penalties": dict(base, temperature=0.0, presence_penalty=0.5,
                          frequency_penalty=0.4, repetition_penalty=1.2),
        "logit_bias": dict(base, temperature=0.0, logprobs=0,
                           repetition_penalty=FLAT_REP,
                           logit_bias={second: 100}),
        "best_of": dict(base, temperature=0.8, seed=3, best_of=3, n=1),
        "echo": dict(base, prompt=prompts[1][:64], temperature=0.0,
                     echo=True, prompt_logprobs=1, logprobs=1)}
    sent = []
    for _ in range(2):
        answers = {}
        for name, body in reqs.items():
            status, ans = _post(port, "/v1/completions", body)
            assert status == 200, f"[http] {label} {name}: {status} {ans}"
            assert ans["object"] == "text_completion" and \
                len(ans["choices"]) == 1 and \
                ans["usage"]["completion_tokens"] == 12, \
                f"[http] {label} {name}: {ans}"
            answers[name] = ans["choices"][0]
        sent.append((answers, json.loads(
            _get(port, "/server_info")[1])["engine_counters"]))
    (first, info_first), (answers, info1) = sent
    for name in ("logprobs", "top_logprobs", "seed", "logit_bias"):
        lp = answers[name]["logprobs"]
        assert set(lp) == {"tokens", "token_logprobs", "top_logprobs",
                           "text_offset"}, f"[http] {label} {name}: {lp}"
        assert len(lp["tokens"]) == 12 and all(
            x <= 0 for x in lp["token_logprobs"])
    assert all(len(t) == 3 for t in
               answers["logprobs"]["logprobs"]["top_logprobs"])
    assert all(len(t) == 2 for t in
               answers["top_logprobs"]["logprobs"]["top_logprobs"])
    assert answers["logit_bias"]["logprobs"]["tokens"][0] == second, \
        f"[http] {label}: +100 bias on {second}: " \
        f"{answers['logit_bias']['logprobs']['tokens']}"
    assert first["seed"]["logprobs"]["tokens"] == \
        answers["seed"]["logprobs"]["tokens"], \
        f"[http] {label}: a repeated seeded request gave other tokens"
    echo = answers["echo"]["logprobs"]
    n_prompt = len(reqs["echo"]["prompt"])
    assert len(echo["tokens"]) == n_prompt + 12 and \
        echo["token_logprobs"][0] is None and \
        all(x <= 0 for x in echo["token_logprobs"][1:])
    assert answers["best_of"]["finish_reason"] == "length"
    captured = info_first["graphs"] - info0["graphs"]
    repeat = info1["graphs"] - info_first["graphs"]
    extras = info1["extras_steps"] - info0["extras_steps"]
    assert not repeat, f"[http] {label}: the repeat captured {repeat} graphs"
    assert not any(info1["eager_mixed"].values()), \
        f"[http] {label}: eager mixed steps {info1['eager_mixed']}"
    replays = {k: info1["graph_replays"][k] - info0["graph_replays"][k]
               for k in EXTRAS_KINDS}
    log(f"[http] {label}: a probe and {len(reqs)} requests (logprobs, "
        f"top_logprobs, a seed, penalties, a +100 logit_bias on the probe's "
        f"second token, best_of 3 with n 1, echo with prompt_logprobs), "
        f"each sent twice, answered 200 in OpenAI's shape; the seeded "
        f"request repeated its tokens; {extras} pure-decode extras steps, "
        f"extras replays by kind {replays}; graphs captured at first sight "
        f"{captured}, by the repeat {repeat}")
    return extras


def http_trace(port, name, since, passes):
    """The tracing routes of a live server after its passes: ``GET
    /steptrace?since=`` (every event at or after ``since``, a
    ``next_since`` past them that returns nothing new once the server is
    idle, the ``kind`` filter), the passes' window summary
    (``attribution``), the compile events of the passes equal to the
    graphs they captured, ``GET /trace`` (Chrome JSON with the engine's
    and the requests' process rows) and ``POST /profile?seconds=1``, whose
    trace file must exist and parse."""
    import os
    status, body = _get(port, f"/steptrace?since={since}", timeout=120)
    assert status == 200, f"[http {name}] /steptrace answered {status}"
    d = json.loads(body)
    evs = d["events"]
    assert evs and all(e["seq"] >= since for e in evs) \
        and d["next_since"] == evs[-1]["seq"] + 1, \
        f"[http {name}] /steptrace since {since}: next_since " \
        f"{d['next_since']}, {len(evs)} events"
    assert json.loads(_get(port, f"/steptrace?since={d['next_since']}")[1]
                      )["events"] == [], f"[http {name}] events after idle"
    compiles = [e for e in evs if e["kind"] == "compile"]
    captured = sum(p["graphs_captured"] for p in passes)
    if len(compiles) != captured:
        raise SystemExit(f"[http {name}] {len(compiles)} compile events in "
                         f"the passes, {captured} graphs captured")
    summary = attribution(f"[http {name}] passes", evs, True)
    kinds = collections.Counter(e["kind"] for e in evs)
    for kind in kinds:
        got = json.loads(_get(port, f"/steptrace?since={since}&kind={kind}",
                              timeout=120)[1])["events"]
        assert len(got) == kinds[kind] and {e["kind"] for e in got} == {
            kind}, f"[http {name}] /steptrace kind={kind}"
    status, body = _get(port, "/trace", timeout=120)
    assert status == 200, f"[http {name}] /trace answered {status}"
    doc = json.loads(body)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    rows = {e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert {e["pid"] for e in xs} == {1, 2} and rows == {"engine loop",
                                                         "requests"}, \
        f"[http {name}] /trace rows {rows}"
    status, prof = _post(port, "/profile?seconds=1", {})
    assert status == 200 and os.path.isfile(prof["trace"]), \
        f"[http {name}] POST /profile: {status} {prof}"
    with open(prof["trace"]) as f:
        assert "traceEvents" in json.load(f)
    log(f"[http {name}] /steptrace: {len(evs)} events since {since} "
        f"({dict(kinds)}), next_since {d['next_since']}, each kind filter "
        f"exact; {len(compiles)} compile events in the passes = the graphs "
        f"they captured; /trace: {len(xs)} slices on the engine and request "
        f"rows, {len(body) / 2**20:.1f} MiB; POST /profile?seconds=1 wrote "
        f"{prof['trace']}")
    return summary


def http_server(name, flags, served):
    """The port's OpenAI server as users start it, in a process of its
    own: Llama-3.2-1B at full width (config.json written here, dummy bf16
    weights from seed 0) under ``flags`` (HTTP_SERVERS[name]), driven over HTTP by
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
    log(f"[http {name}] {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free "
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
           "--port", "0", *flags]
    log(f"[http {name}] {' '.join(cmd[1:])}")
    t0 = time.monotonic()
    # POST /profile writes its trace beside the server's log
    env = dict(os.environ, GLLM_PROFILE_DIR=os.path.join(
        model_dir, f"profile_{name.replace(' ', '_')}"))
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, env=env)
    lines, bound, port = [], threading.Event(), []
    server_log = open(os.path.join(
        model_dir, f"server_{name.replace(' ', '_')}.log"), "w")

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
                log(f"[http {name}] server: {line.rstrip()}")
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        while not bound.wait(1.0):
            assert proc.poll() is None, \
                f"[http {name}] the server exited:\n" + "".join(lines[-40:])
            assert time.monotonic() - t0 < HTTP_STARTUP_S, \
                f"[http {name}] the server did not bind:\n" + "".join(lines[-40:])
        port = port[0]
        while _get(port, "/readyz")[0] != 200:
            assert time.monotonic() - t0 < HTTP_STARTUP_S, \
                f"[http {name}] the server never became ready"
            time.sleep(0.5)
        info = json.loads(_get(port, "/server_info")[1])
        log(f"[http {name}] ready on port {port} after "
            f"{time.monotonic() - t0:.1f} s: {info['num_pages']} KV pages, "
            f"attention {info['attention_impl']}, "
            f"{info['parallel']['fast_path']}, "
            f"{info['engine_counters']['graphs']} graphs warmed in "
            f"{info['engine_counters']['capture_s']:.2f} s, graph pools "
            f"{info['engine_counters']['graph_pool_mib']:.1f} MiB; before "
            f"extras-step capture: KV pages {HTTP_BEFORE[name]['pages']}, "
            f"graph pools {HTTP_BEFORE[name]['pools']} MiB")
        m0 = _scrape(port)
        since = json.loads(_get(port, "/steptrace?kind=compile")[1]
                           )["next_since"]
        passes = []
        while len(passes) < HTTP_PASSES and (
                not passes or passes[-1]["graphs_captured"]):
            passes.append(_pass(port, payloads,
                                f"{name} pass {len(passes) + 1}"))
        # ROADMAP C 7: the server's warmup leaves no key this traffic meets
        assert not passes[0]["graphs_captured"], \
            f"[http {name}] the first pass captured " \
            f"{passes[0]['graphs_captured']} graphs"
        if name == "absorb":
            http_trace(port, name, since, passes)
        free = [i for i, p in enumerate(passes) if not p["graphs_captured"]]
        if free:
            log(f"[http {name}] pass {free[0] + 1} captured no graph: its numbers "
                "are free of capture stalls; passes "
                f"{list(range(1, free[0] + 1))} captured "
                f"{[p['graphs_captured'] for p in passes[:free[0]]]}")
        else:
            log(f"[http {name}] every one of {len(passes)} passes captured graphs "
                f"({[p['graphs_captured'] for p in passes]}): no number of "
                "this phase is free of capture stalls (ROADMAP C 7)")
        # the whole request, n = 2, and the stream closed after 4 chunks
        status, whole = _post(port, "/v1/completions", payloads[0])
        assert status == 200 and whole["usage"]["completion_tokens"] == \
            payloads[0]["max_tokens"], f"[http {name}] whole request: {whole}"
        assert whole["choices"][0]["finish_reason"] == "length"
        status, two = _post(port, "/v1/completions",
                            dict(payloads[1], n=2))
        assert status == 200 and two["usage"]["completion_tokens"] == \
            2 * payloads[1]["max_tokens"], f"[http {name}] n = 2: {two}"
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
                f"[http {name}] the server did not go idle (a page or a request " \
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
            f"[http {name}] finishes by reason: length {n_len}, others {others}"
        assert n_abort == 1, f"[http {name}] {n_abort} aborts, not 1"
        # every request that got a token observed a TTFT, the aborted one too
        assert n_ttft == len(passes) * len(payloads) + 4, \
            f"[http {name}] {n_ttft} TTFTs"
        log(f"[http {name}] after {len(passes)} passes: finishes by length "
            f"{n_len:.0f}, "
            f"aborts {n_abort:.0f}, TTFT observations {n_ttft:.0f}; the "
            "gauges and KV use read 0")
        ec = json.loads(_get(port, "/server_info")[1])["engine_counters"]
        replayed = sum(ec["graph_replays"][k] for k in MIXED_KINDS)
        assert replayed + sum(ec["eager_mixed"].values()) == ec["mixed_steps"]
        assert not any(ec["eager_mixed"].values()), \
            f"[http {name}] eager mixed steps {ec['eager_mixed']}"
        ttft = passes[0]["client_ms"]["ttft_ms"]
        log(f"[http {name}] mixed steps {ec['mixed_steps']}, all replayed "
            f"({ec['graph_replays']}); pass 1 client TTFT p50 {ttft['p50']} "
            f"ms, p99 {ttft['p99']} ms (before extras-step capture: "
            f"{HTTP_BEFORE[name]['ttft_ms'][0]}, "
            f"{HTTP_BEFORE[name]['ttft_ms'][1]})")
        if name == "absorb":
            http_sampling_pass(port, prompts, f"{name} sampling pass")
        last = passes[free[0] if free else -1]
        log(f"[http {name}] pass {passes.index(last) + 1} "
            f"({last['graphs_captured']} graphs captured) "
            f"{last['output_tok_s']} output tok/s beside the serve phase's "
            "absorb twin offline (16 requests at once): "
            f"{served['unified']['absorb_rates']} tok/s, on {SMI}")
        log(f"[http {name}] " + json.dumps({"http": {
            f"pass {i + 1}": p for i, p in enumerate(passes)}}))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=HTTP_STOP_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise SystemExit(f"[http {name}] the server did not exit within "
                                 f"{HTTP_STOP_S:.0f} s of SIGTERM")
        else:
            rc = proc.returncode
        reader.join(timeout=5)
        server_log.close()
    assert rc == 0, f"[http {name}] the server exited with {rc}:\n" + \
        "".join(lines[-20:])
    log(f"[http {name}] the server exited on SIGTERM (rc {rc})")
    return last


def phase_http(served):
    """Each server of HTTP_SERVERS in turn (http_server): the absorb
    server and the full-profile one; returns each one's last pass."""
    return {name: http_server(name, flags, served)
            for name, flags in HTTP_SERVERS.items()}


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
    # a fault in native code prints the Python stack it came from
    faulthandler.enable()
    t_start = time.monotonic()
    smi = SMI = phase_device()
    walls = {}
    for name, phase in (("build", phase_build), ("kernels", phase_kernels),
                        ("serve", phase_serve),
                        ("reference", phase_reference),
                        ("spec", phase_spec),
                        ("sampling", phase_sampling),
                        ("tracing", phase_tracing),
                        ("http", lambda: phase_http(walls["serve"][0]))):
        t0 = time.monotonic()
        walls[name] = (phase(), time.monotonic() - t0)
        log(f"[{name}] phase wall {walls[name][1]:.1f} s")
    kernels = walls["kernels"][0]
    served = dict(walls["serve"][0], **walls["spec"][0],
                  **walls["sampling"][0])
    line = []
    for name, (counter, config, src, replaces) in KERNELS.items():
        r = kernels[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"gllm_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": served[config]["counts"][counter],
            "launches_in": (f"spec {config}" if config.startswith("spec_")
                            else "sampling" if config == "sampling"
                            else f"serve {config}"),
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
