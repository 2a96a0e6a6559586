#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gllm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and
no result line:

1. device    torch / CUDA / nvcc versions, the card's name and power limit
2. build     nvcc builds every kernel from gllm_tpu_torch/csrc into
             build/gllm_tpu_torch/ (ptxas register and shared-memory lines)
3. kernels   each kernel against its plain PyTorch version at the serving
             path's shapes (Llama-3.2-1B attention: Hq 32, Hkv 8, D 64,
             page 16, bf16), with the device time (profiler) of the
             kernel, the plain version and one PyTorch library call, the
             kernel wrapper's CUDA-event time, and the card's bound
4. serve     LLM.generate at the full Llama-3.2-1B width (dummy bf16
             weights from a seed) for 16 greedy requests, three times;
             both kernels must have launched and no plain attention run
5. reference depth cut to 2 layers, float32: the port on the card
             (kernels) against the port on the CPU (plain versions) —
             first-step logits and greedy tokens
6. a {"kernels": [...]} line, then the last line
             {"ok": true, "device": {...}}

It imports nothing of jax or the JAX package.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# bf16 outputs, kernel vs plain, as allclose(rtol, atol), per kernel. Both
# sum in f32 and round the output to bf16 (one step is 2e-3 at |out| in
# [0.25, 0.5)). The ragged kernel also feeds the tensor cores bf16
# probabilities, and its first rows of a fresh chunk see a few keys only,
# so |out| reaches 2..4, where one bf16 step is 0.0156: hence its rtol.
TOL = {"paged_decode_attention": (1e-2, 2e-3),
       "ragged_paged_attention": (2e-2, 3e-3)}


def log(*args):
    print(*args, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def device_ms(fn, iters, warmup=2):
    """Device time per call of ``fn``: the summed time of every kernel it
    launches, as torch.profiler (CUPTI) reads it, so neither the host's
    issue time nor the gaps between calls count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise SystemExit("[kernels] the profiler saw no device time")
    return us / iters / 1e3


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


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill")):
                log(f"[build] {name}: {line.strip()}")


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


def _dense_kv(kc, vc, pt, kv_lens, page):
    """K/V gathered into dense per-sequence [S, Hkv, Kmax, D] tensors (for
    the library yardstick)."""
    kmax = max(kv_lens)
    idx = pt[:, :-(-kmax // page)].long()
    S, Hkv, D = len(kv_lens), kc.shape[2], kc.shape[3]
    k = kc[idx].reshape(S, -1, Hkv, D)[:, :kmax].transpose(1, 2)
    v = vc[idx].reshape(S, -1, Hkv, D)[:, :kmax].transpose(1, 2)
    return k.contiguous(), v.contiguous()


def check(name, out, want, dropped):
    """Kernel output against its plain version at the kernel's tolerance.
    ``dropped`` is the plain version with the last key of some rows left
    out: the tolerance must reject it, or it could not see such a fault."""
    rtol, atol = TOL[name]
    o, w, d = out.float(), want.float(), dropped.float()
    err = (o - w).abs()
    return dict(
        ok=bool(torch.isfinite(o).all()) and torch.allclose(
            o, w, rtol=rtol, atol=atol),
        max_abs_err=err.max().item(),
        # the largest share of the tolerance that any element uses
        tol_used=(err / (atol + rtol * w.abs())).max().item(),
        drop_rejected=not torch.allclose(d, w, rtol=rtol, atol=atol),
        drop_max_abs=(d - w).abs().max().item())


def timings(kernel, plain, library, iters):
    """Device time per call (profiler) of the kernel, the plain version
    and the library call; and the kernel's CUDA-event time per call when
    its wrapper is called back to back (host issue included)."""
    return dict(ms=device_ms(kernel, iters), plain_ms=device_ms(plain, 3),
                library_ms=device_ms(library, 5),
                wrapper_ms=cuda_ms(kernel, iters))


def phase_kernels():
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    Hq, Hkv, D, page, dt = 32, 8, 64, 16, torch.bfloat16
    scale = D ** -0.5
    results = {}

    # decode: S=32 rows, contexts 256..2048
    S = 32
    kv = rng.integers(256, 2049, S)
    kc, vc, pt = _paged(rng, kv, Hkv, D, page, dt, dev)
    q = torch.randn((S, Hq, D), device=dev).to(dt)
    kvl = torch.from_numpy(kv.astype(np.int32)).to(dev)
    out = dec.paged_decode_attention(q, kc, vc, kvl, pt, scale=scale)
    want = dec.paged_decode_attention_plain(q, kc, vc, kvl, pt, scale=scale)
    dropped = dec.paged_decode_attention_plain(q, kc, vc, kvl - 1, pt,
                                               scale=scale)
    r = check("paged_decode_attention", out, want, dropped)
    kd, vd = _dense_kv(kc, vc, pt, kv.tolist(), page)
    mask = (torch.arange(kd.shape[2], device=dev)[None, :]
            < kvl[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :]
    r.update(timings(
        lambda: dec.paged_decode_attention(q, kc, vc, kvl, pt, scale=scale),
        lambda: dec.paged_decode_attention_plain(q, kc, vc, kvl, pt,
                                                 scale=scale),
        lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True), 50))
    ctx = int(kv.sum())
    # K/V of every context row, q read and out written once, kv_lens and
    # the pages' ids
    nbytes = (ctx * Hkv * 2 * D * 2 + 2 * q.numel() * 2 + S * 4
              + sum(-(-int(k) // page) for k in kv) * 4)
    flops = 4 * Hq * D * ctx
    b_ms, b_by = bound(nbytes, flops)
    r.update(bytes=nbytes, flops=flops, bound_ms=b_ms, bound_by=b_by,
             shapes=f"S={S} ctx {kv.min()}..{kv.max()} (sum {ctx}) Hq={Hq} "
                    f"Hkv={Hkv} D={D} page={page} bf16",
             library_call="scaled_dot_product_attention(enable_gqa) over "
                          "K/V gathered dense per sequence")
    results["paged_decode_attention"] = r

    # ragged: 24 decode rows + chunks (512 of a 2048 context, 300 of 812,
    # a fresh 1024), padded to the runner's buckets (T 2048, S 32)
    seqs = ([(1, int(k)) for k in rng.integers(256, 2049, 24)]
            + [(512, 2048), (300, 812), (1024, 1024)])
    S_real, S_pad = len(seqs), 32
    T_real = sum(ql for ql, _ in seqs)
    T_pad = 2048
    kv = [k for _, k in seqs] + [0] * (S_pad - S_real)
    kc, vc, pt = _paged(rng, kv[:S_real], Hkv, D, page, dt, dev)
    pt = torch.cat([pt, torch.zeros((S_pad - S_real, pt.shape[1]),
                                    dtype=pt.dtype, device=dev)])
    cu = np.zeros(S_pad + 1, np.int32)
    cu[1:S_real + 1] = np.cumsum([ql for ql, _ in seqs])
    cu[S_real + 1:] = T_real
    cu_t = torch.from_numpy(cu).to(dev)
    kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
    q = torch.randn((T_pad, Hq, D), device=dev).to(dt)
    args = (q, kc, vc, cu_t, kvl, pt)
    out = rag.ragged_paged_attention(*args, scale=scale)
    want = rag.ragged_paged_attention_plain(*args, scale=scale)
    # the one-token rows lose their last key (a chunk's rows would shift)
    kvl_drop = kvl - torch.tensor([int(ql == 1) for ql, _ in seqs]
                                  + [0] * (S_pad - S_real),
                                  dtype=torch.int32, device=dev)
    dropped = rag.ragged_paged_attention_plain(q, kc, vc, cu_t, kvl_drop,
                                               pt, scale=scale)
    r = check("ragged_paged_attention", out, want, dropped)
    qmax = max(ql for ql, _ in seqs)
    kd, vd = _dense_kv(kc, vc, pt[:S_real], kv[:S_real], page)
    qd = torch.zeros((S_real, Hq, qmax, D), device=dev, dtype=dt)
    mask = torch.zeros((S_real, 1, qmax, kd.shape[2]), dtype=torch.bool,
                       device=dev)
    mask[..., 0] = True            # padded rows: one key, no NaN rows
    visible = 0
    for i, (ql, k) in enumerate(seqs):
        qd[i, :, :ql] = q[cu[i]:cu[i] + ql].transpose(0, 1)
        pos = k - ql + torch.arange(ql, device=dev)
        mask[i, 0, :ql] = (torch.arange(kd.shape[2], device=dev)[None, :]
                           <= pos[:, None])
        visible += sum(k - ql + t + 1 for t in range(ql))
    r.update(timings(
        lambda: rag.ragged_paged_attention(*args, scale=scale),
        lambda: rag.ragged_paged_attention_plain(*args, scale=scale),
        lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True), 20))
    ctx = sum(kv)
    # K/V of every context row, the T_real real q rows read, all T_pad out
    # rows written (the padding rows get zeros), cu_q_lens, kv_lens and
    # the pages' ids
    row = Hq * D * 2
    nbytes = (ctx * Hkv * 2 * D * 2 + T_real * row + T_pad * row
              + (2 * S_pad + 1) * 4 + sum(-(-k // page) for k in kv) * 4)
    flops = 4 * Hq * D * visible
    b_ms, b_by = bound(nbytes, flops)
    r.update(bytes=nbytes, flops=flops, bound_ms=b_ms, bound_by=b_by,
             shapes=f"T={T_pad} ({T_real} real: 24 decode rows + chunks 512/"
                    f"300/1024) S={S_pad} ({S_real} real) ctx<=2048 Hq={Hq} "
                    f"Hkv={Hkv} D={D} page={page} bf16",
             library_call="scaled_dot_product_attention(enable_gqa, bool "
                          "mask) over q padded to [S, Hq, 1024, D] and K/V "
                          "gathered dense per sequence")
    results["ragged_paged_attention"] = r

    del kc, vc, kd, vd, qd, mask
    for name, r in results.items():
        rtol, atol = TOL[name]
        log(f"[kernels] {name}: {r['shapes']}")
        log(f"[kernels] {name}: ok={r['ok']} max_abs_err={r['max_abs_err']}"
            f" (allclose rtol={rtol} atol={atol}; {r['tol_used']:.3f} of it"
            f" used); last key dropped: max_abs {r['drop_max_abs']}, "
            f"rejected={r['drop_rejected']}")
        log(f"[kernels] {name}: device ms per call: kernel={r['ms']} plain="
            f"{r['plain_ms']} library={r['library_ms']}; kernel wrapper "
            f"back to back (CUDA events) {r['wrapper_ms']} ms; bound_ms="
            f"{r['bound_ms']} ({r['bound_by']}; {r['bytes']} bytes, "
            f"{r['flops']} flops)")
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"[kernels] kernel disagrees with its plain "
                         f"version: {bad}")
    blind = [n for n, r in results.items() if not r["drop_rejected"]]
    if blind:
        raise SystemExit(f"[kernels] tolerance accepts a dropped key: "
                         f"{blind}")
    return results


# ---- 4. serve ------------------------------------------------------------

def llama_3_2_1b(**kw):
    from gllm_tpu_torch import ModelConfig
    cfg = dict(architecture="LlamaForCausalLM", vocab_size=128256,
               hidden_size=2048, num_layers=16, num_heads=32, num_kv_heads=8,
               head_dim=64, intermediate_size=8192, max_position=4096,
               rope_theta=500000.0, tie_word_embeddings=True)
    cfg.update(kw)
    return ModelConfig(**cfg)


def reset_counters():
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    rag.ragged_paged_attention.launches = 0
    dec.paged_decode_attention.launches = 0
    rag.ragged_paged_attention_plain.calls = 0
    dec.paged_decode_attention_plain.calls = 0


def read_counters():
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    return {"ragged_paged_attention": rag.ragged_paged_attention.launches,
            "paged_decode_attention": dec.paged_decode_attention.launches,
            "plain_calls": (rag.ragged_paged_attention_plain.calls
                            + dec.paged_decode_attention_plain.calls)}


def phase_serve():
    from gllm_tpu_torch import EngineConfig, LLM, SamplingParams
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llm = LLM(model_cfg=llama_3_2_1b(),
              config=EngineConfig(load_format="dummy", dtype="bfloat16",
                                  seed=SEED))
    log(f"[serve] LLM up in {time.monotonic() - t0:.1f} s: "
        f"{llm.runner.num_pages} KV pages of "
        f"{llm.config.cache.page_size} tokens on {llm.device}")
    rng = np.random.default_rng(SEED)
    vocab = llm.model_cfg.vocab_size
    # warm-up request (CUDA context, cuBLAS handles); not counted
    llm.generate(prompt_token_ids=[[1, 2, 3, 4]],
                 sampling_params=SamplingParams(temperature=0.0,
                                                max_tokens=2,
                                                ignore_eos=True))
    lens = rng.integers(64, 1537, 16)
    max_tokens = rng.integers(32, 129, 16)
    prompts = [rng.integers(1, vocab, int(n)).tolist() for n in lens]
    params = [SamplingParams(temperature=0.0, max_tokens=int(m),
                             ignore_eos=True) for m in max_tokens]
    log(f"[serve] 16 requests, prompts {lens.min()}..{lens.max()} "
        f"(sum {lens.sum()}), max_tokens {max_tokens.min()}..."
        f"{max_tokens.max()}, 3 runs (the host's pace varies from run to "
        f"run)")
    steps0 = dict(llm.step_counts)
    reset_counters()
    rates = []
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = llm.generate(prompt_token_ids=prompts, sampling_params=params)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        n_out = sum(o.num_output_tokens for o in outs)
        rates.append(n_out / wall)
        log(f"[serve] run {rep}: {n_out} tokens in {wall:.3f} s = "
            f"{n_out / wall:.1f} output tok/s")
        assert [o.num_output_tokens for o in outs] == max_tokens.tolist(), \
            "a request did not return exactly max_tokens tokens"
        assert all(o.finish_reason == "length" for o in outs)
        assert all(0 <= t < vocab for o in outs for t in o.output_token_ids)
    counts = read_counters()
    steps = {k: llm.step_counts[k] - steps0[k] for k in steps0}
    log(f"[serve] median {sorted(rates)[1]:.1f} output tok/s; steps {steps};"
        f" launches {counts}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert counts["ragged_paged_attention"] > 0, "ragged kernel never ran"
    assert counts["paged_decode_attention"] > 0, "decode kernel never ran"
    assert counts["plain_calls"] == 0, "plain attention ran on the card"
    mm = llm.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total, "KV pages leaked"
    profile_window(llm, rng)
    del llm
    torch.cuda.empty_cache()
    return counts


def profile_window(llm, rng):
    """Where a serving step's time goes: torch.profiler over a short
    window (8 requests of 512 prompt tokens, 24 greedy tokens each):
    device time by kernel, and the device's busy share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gllm_tpu_torch import SamplingParams
    prompts = [rng.integers(1, llm.model_cfg.vocab_size, 512).tolist()
               for _ in range(8)]
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    steps0 = dict(llm.step_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        llm.generate(prompt_token_ids=prompts, sampling_params=sp)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    steps = {k: llm.step_counts[k] - steps0[k] for k in steps0}
    # kernels only: a CPU op's device time repeats its kernels' times
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] 8 x (512 prompt + 24 out) tokens, steps {steps}: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}% of wall); kernels by device time:")
    for dev_us, count, key in rows[:12]:
        log(f"[profile]   {100 * dev_us / busy:5.1f}%  {dev_us / 1e3:8.3f} ms"
            f"  x{count:<5d} {key[:90]}")
    # the host side: kernels issued per step, and host time by operator
    # (self time, inflated by the profiler's own cost per op)
    n_steps = sum(steps.values())
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    host_us = sum(r[0] for r in host)
    log(f"[profile] {sum(r[1] for r in rows) / n_steps:.0f} kernels per "
        f"step; host self time {host_us / 1e3:.1f} ms "
        f"({100 * host_us / wall_us:.1f}% of wall), by operator:")
    for cpu_us, count, key in host[:10]:
        log(f"[profile]   {100 * cpu_us / host_us:5.1f}%  {cpu_us / 1e3:8.3f}"
            f" ms  x{count:<6d} {key[:60]}")


# ---- 5. reference --------------------------------------------------------

def phase_reference():
    """Depth-cut model at float32: the port on the card (CUDA kernels)
    against the port on the CPU (plain versions), same weights."""
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, \
        SamplingParams, SchedulerConfig
    from gllm_tpu_torch.models import dense
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_3_2_1b(num_layers=2)
    params = dense.init_params(cfg, SEED, torch.float32, "cuda")
    cpu_params = {"layers": {k: v.cpu() for k, v in params["layers"].items()},
                  **{k: v.cpu() for k, v in params.items() if k != "layers"}}
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (40, 75, 130)]

    def engine(p, device):
        ec = EngineConfig(dtype="float32", seed=SEED, max_model_len=512,
                          scheduler=SchedulerConfig(max_prefill_tokens=64),
                          cache=CacheConfig(num_pages=128))
        return LLM(model_cfg=cfg, config=ec, params=p, device=device)

    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)
    logits, toks = [], []
    for llm in (engine(params, "cuda"), engine(cpu_params, "cpu")):
        seqs = [llm._allocate_seq(p, sp) for p in prompts]
        for seq in seqs:
            llm.add_seq(seq)
        # first step by hand, to read its logits: greedy = argmax
        batch = llm.scheduler.schedule_once()
        host, max_q = llm.runner.builder.build(batch)
        out = llm.runner.forward_logits(llm.runner.staging.upload(host),
                                        max_q)[:batch.num_seqs]
        logits.append(out.cpu())
        llm.scheduler.process_output(batch, out.argmax(-1).tolist(),
                                     llm.eos_token_ids)
        while llm.has_unfinished:
            llm.step()
        toks.append([seq.output_token_ids for seq in seqs])
    err = (logits[0] - logits[1]).abs().max().item()
    scale = logits[1].abs().max().item()
    log(f"[reference] 2-layer f32, first step (chunked prefill): logits "
        f"max_abs_err {err} of max |logit| {scale}; greedy tokens "
        f"identical: {toks[0] == toks[1]}")
    assert err <= 1e-3 * max(scale, 1.0), "card and CPU logits disagree"
    assert toks[0] == toks[1], "card and CPU greedy tokens differ"
    assert all(len(t) == 8 for t in toks[0])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    counts = phase_serve()
    phase_reference()
    line = []
    for name, src, replaces in (
            ("ragged_paged_attention", "ragged_attention.cu",
             "gllm_tpu/ops/pallas/ragged_attention.py:429"),
            ("paged_decode_attention", "decode_attention.cu",
             "gllm_tpu/ops/pallas/decode_attention.py:188")):
        r = kernels[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"gllm_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "rtol": TOL[name][0], "atol": TOL[name][1], "ok": r["ok"],
            "ms": r["ms"], "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bytes": r["bytes"],
            "flops": r["flops"], "library_ms": r["library_ms"],
            "library_call": r["library_call"], "shapes": r["shapes"]})
    log(f"[done] {time.monotonic() - t0:.1f} s on {smi}")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
