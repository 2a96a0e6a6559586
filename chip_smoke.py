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
             page 16, bf16 q; a bf16 or an int8 cache), with the device time
             (profiler) of the kernel, the plain version and one PyTorch
             library call, the kernel wrapper's CUDA-event time, and the
             card's bound: ragged (K1), decode (K2), their int8 modes (K1q,
             K2q) and the unified kernel (K1u) over both caches
4. serve     LLM.generate at the full Llama-3.2-1B width (dummy bf16
             weights from a seed) for 16 greedy requests, in four
             configurations: the bf16 sync loop (once), then an int8 KV
             cache, the unified step, and the unified step over an int8
             cache (three runs each); each must launch exactly its kernels
             and no plain attention; a profiled window of the first and
             the last
5. reference depth cut to 2 layers, float32: the port on the card
             (kernels) against the port on the CPU (plain versions) —
             first-step logits and greedy tokens — with a bf16-width
             float32 cache, an int8 cache, and the unified step
6. a {"kernels": [...]} line, then the last line
             {"ok": true, "device": {...}}

It imports nothing of jax or the JAX package.
"""

import json
import re
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
# [0.25, 0.5)). The kernels with tensor-core blocks (ragged, and the
# unified kernel's ragged blocks) also feed the tensor cores bf16
# probabilities (times the value scales over an int8 cache), and the
# first rows of a fresh chunk see a few keys only, so |out| reaches 2..4,
# where one bf16 step is 0.0156: hence their rtol. The decode kernels and
# the unified kernel on a pure-decode batch stay in float32 throughout.
DECODE_TOL = (1e-2, 2e-3)
RAGGED_TOL = (2e-2, 3e-3)
TOL = {"paged_decode_attention": DECODE_TOL,
       "paged_decode_attention_int8": DECODE_TOL,
       "ragged_paged_attention": RAGGED_TOL,
       "ragged_paged_attention_int8": RAGGED_TOL,
       "ragged_paged_attention_unified_decode": DECODE_TOL,
       "ragged_paged_attention_unified": RAGGED_TOL,
       "ragged_paged_attention_unified_int8": RAGGED_TOL}
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
        "ragged_paged_attention_unified", "unified", "unified_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True)"),
    "ragged_paged_attention_unified": (
        "ragged_paged_attention_unified", "unified", "unified_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True)"),
    "ragged_paged_attention_unified_int8": (
        "ragged_paged_attention_unified_int8", "unified_int8",
        "unified_attention.cu",
        PALLAS + "ragged_attention.py:429 (unified=True, k_scale/v_scale)"),
}


def log(*args):
    print(*args, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def device_split(fn, iters, warmup=2):
    """Device time per call of ``fn`` by kernel, in ms, as torch.profiler
    (CUPTI) reads it, so neither the host's issue time nor the gaps
    between calls count."""
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
    split = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.split("(")[0].removeprefix("void ")
            split[name] = split.get(name, 0.0) + (
                e.self_device_time_total / iters / 1e3)
    if sum(split.values()) <= 0:
        raise SystemExit("[kernels] the profiler saw no device time")
    return split


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


def measure(name, kernel, plain, plain_dropped, library, iters, nbytes,
            flops, **info):
    """Check a kernel against its plain version, then time it: device time
    per call (profiler) of the kernel, the plain version and the library
    call; and the kernel's CUDA-event time per call when its wrapper is
    called back to back (host issue included)."""
    out = kernel()
    torch.cuda.synchronize()
    r = check(name, out, plain(), plain_dropped())
    b_ms, b_by = bound(nbytes, flops)
    split = device_split(kernel, iters)
    r.update(ms=sum(split.values()), split=split,
             plain_ms=device_ms(plain, 3),
             library_ms=device_ms(library, 5),
             wrapper_ms=cuda_ms(kernel, iters), bytes=nbytes, flops=flops,
             bound_ms=b_ms, bound_by=b_by, **info)
    return r


def decode_shape(rng, dev):
    """The decode step of the serving path: S 32 rows, contexts 256..2048,
    a bf16 cache and its int8 form."""
    Hkv, D, page = 8, 64, 16
    S = 32
    kv = rng.integers(256, 2049, S)
    kc, vc, pt = _paged(rng, kv, Hkv, D, page, torch.bfloat16, dev)
    q = _randn((S, 32, D), dev)
    kvl = torch.from_numpy(kv.astype(np.int32)).to(dev)
    return dict(q=q, kc=kc, vc=vc, pt=pt, kvl=kvl, kv=kv.tolist(), page=page,
                quant=_quantize(kc) + _quantize(vc))


def mixed_shape(rng, dev):
    """A mixed step of the serving path: 24 decode rows + chunks (512 of a
    2048 context, 300 of 812, a fresh 1024), padded to the runner's
    buckets (T 2048, S 32)."""
    Hkv, D, page = 8, 64, 16
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
    q = _randn((T_pad, 32, D), dev)
    kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
    # the one-token rows lose their last key (a chunk's rows would shift)
    kvl_drop = kvl - torch.tensor([int(ql == 1) for ql, _ in seqs]
                                  + [0] * (S_pad - S_real),
                                  dtype=torch.int32, device=dev)
    return dict(q=q, kc=kc, vc=vc, pt=pt, kvl=kvl, kvl_drop=kvl_drop,
                cu=torch.from_numpy(cu).to(dev), cu_np=cu, seqs=seqs,
                kv=kv, page=page, T_real=T_real,
                quant=_quantize(kc) + _quantize(vc))


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


def _kv_bytes(kv_lens, page, Hkv, D, quant):
    """Bytes of K and V the contexts need: each key row of each kv head
    once (1 byte a value for int8, else 2), plus, for int8, the scale row
    (one float32 per kv head, K and V) of every page read."""
    ctx = sum(int(k) for k in kv_lens)
    pages = sum(-(-int(k) // page) for k in kv_lens)
    return ctx * Hkv * 2 * D * (1 if quant else 2) + (
        pages * Hkv * 2 * 4 if quant else 0)


def phase_kernels():
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    Hq, Hkv, D = 32, 8, 64
    scale = D ** -0.5
    results = {}

    # ---- decode shape: K2, K2q, and K1u on 32 one-token ragged rows
    x = decode_shape(rng, dev)
    q, kvl, pt, kv, page = x["q"], x["kvl"], x["pt"], x["kv"], x["page"]
    S = len(kv)
    k8, ks, kdq, v8, vs, vdq = x["quant"]
    ctx = sum(kv)
    # q read and out written once (bf16), kv_lens and the pages' ids
    io = 2 * q.numel() * 2 + S * 4 + sum(-(-k // page) for k in kv) * 4
    flops = 4 * Hq * D * ctx
    shapes = (f"S={S} ctx {min(kv)}..{max(kv)} (sum {ctx}) Hq={Hq} "
              f"Hkv={Hkv} D={D} page={page} bf16 q")
    lib_call = ("scaled_dot_product_attention(enable_gqa) over K/V "
                "gathered dense per sequence")
    for name, quant in (("paged_decode_attention", False),
                        ("paged_decode_attention_int8", True)):
        kc, vc = (k8, v8) if quant else (x["kc"], x["vc"])
        sc = dict(k_scale=ks, v_scale=vs) if quant else {}
        kd, vd = _dense_kv(kdq if quant else kc, vdq if quant else vc, pt,
                           kv, page)
        results[name] = measure(
            name,
            lambda: dec.paged_decode_attention(q, kc, vc, kvl, pt,
                                               scale=scale, **sc),
            lambda: dec.paged_decode_attention_plain(q, kc, vc, kvl, pt,
                                                     scale=scale, **sc),
            lambda: dec.paged_decode_attention_plain(q, kc, vc, kvl - 1, pt,
                                                     scale=scale, **sc),
            _decode_library(x, kd, vd, scale), 50,
            _kv_bytes(kv, page, Hkv, D, quant) + io, flops,
            shapes=shapes + (", int8 cache" if quant else ", bf16 cache"),
            library_call=lib_call + (" (dequantized to bf16)" if quant
                                     else ""))
    # the same rows as a ragged batch of 32 one-token sequences
    cu = torch.arange(S + 1, dtype=torch.int32, device=dev)
    kd, vd = _dense_kv(x["kc"], x["vc"], pt, kv, page)
    results["ragged_paged_attention_unified_decode"] = measure(
        "ragged_paged_attention_unified_decode",
        lambda: rag.ragged_paged_attention(q, x["kc"], x["vc"], cu, kvl, pt,
                                           scale=scale, unified=True),
        lambda: rag.ragged_paged_attention_plain(q, x["kc"], x["vc"], cu,
                                                 kvl, pt, scale=scale,
                                                 unified=True),
        lambda: rag.ragged_paged_attention_plain(q, x["kc"], x["vc"], cu,
                                                 kvl - 1, pt, scale=scale,
                                                 unified=True),
        _decode_library(x, kd, vd, scale), 50,
        _kv_bytes(kv, page, Hkv, D, False) + io + (S + 1) * 4, flops,
        shapes=f"pure decode as a ragged batch of one-token rows, T={S}, "
        + shapes + ", bf16 cache", library_call=lib_call)
    del x, kd, vd, k8, v8, kdq, vdq

    # ---- mixed shape: K1, K1q, K1u over both caches
    x = mixed_shape(rng, dev)
    q, cu, kvl, pt, kv, page = (x["q"], x["cu"], x["kvl"], x["pt"], x["kv"],
                                x["page"])
    seqs, T_real, T_pad = x["seqs"], x["T_real"], x["q"].shape[0]
    S_real, S_pad = len(seqs), len(kv)
    k8, ks, kdq, v8, vs, vdq = x["quant"]
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
    for name, unified, quant in (
            ("ragged_paged_attention", False, False),
            ("ragged_paged_attention_int8", False, True),
            ("ragged_paged_attention_unified", True, False),
            ("ragged_paged_attention_unified_int8", True, True)):
        kc, vc = (k8, v8) if quant else (x["kc"], x["vc"])
        kw = dict(scale=scale, unified=unified)
        if quant:
            kw.update(k_scale=ks, v_scale=vs)
        kd, vd = _dense_kv(kdq if quant else x["kc"],
                           vdq if quant else x["vc"], pt[:S_real],
                           kv[:S_real], page)
        results[name] = measure(
            name,
            lambda: rag.ragged_paged_attention(q, kc, vc, cu, kvl, pt, **kw),
            lambda: rag.ragged_paged_attention_plain(q, kc, vc, cu, kvl, pt,
                                                     **kw),
            lambda: rag.ragged_paged_attention_plain(
                q, kc, vc, cu, x["kvl_drop"], pt, **kw),
            _mixed_library(x, kd, vd, scale), 20,
            _kv_bytes(kv, page, Hkv, D, quant) + io, flops,
            shapes=shapes + (", int8 cache" if quant else ", bf16 cache"),
            library_call=lib_call + (" (dequantized to bf16)" if quant
                                     else ""))
        del kd, vd
    del x

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
        if len(r["split"]) > 1:
            log(f"[kernels] {name}: device ms per call by launch: "
                + ", ".join(f"{k} {v}" for k, v in r["split"].items()))
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


def _wrappers():
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    return ((rag.ragged_paged_attention, dec.paged_decode_attention),
            (rag.ragged_paged_attention_plain,
             dec.paged_decode_attention_plain))


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


# serve configurations: (EngineConfig keywords, runs, kernels that must
# launch, profiled)
SERVE = {
    "bf16": (dict(), 1, {"ragged_paged_attention", "paged_decode_attention"},
             True),
    "int8": (dict(kv_cache_dtype="int8"), 3,
             {"ragged_paged_attention_int8", "paged_decode_attention_int8"},
             False),
    "unified": (dict(unified_step=True), 3,
                {"ragged_paged_attention_unified"}, False),
    "unified_int8": (dict(unified_step=True, kv_cache_dtype="int8"), 3,
                     {"ragged_paged_attention_unified_int8"}, True),
}


def serve(name, kw, runs, must_launch, profiled):
    from gllm_tpu_torch import CacheConfig, EngineConfig, LLM, SamplingParams
    kw = dict(kw)
    cache = CacheConfig(kv_cache_dtype=kw.pop("kv_cache_dtype", "auto"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llm = LLM(model_cfg=llama_3_2_1b(),
              config=EngineConfig(load_format="dummy", dtype="bfloat16",
                                  seed=SEED, cache=cache, **kw))
    log(f"[serve {name}] LLM up in {time.monotonic() - t0:.1f} s: "
        f"{llm.runner.num_pages} KV pages of {llm.config.cache.page_size} "
        f"tokens ({llm.runner.kv_dtype}) on {llm.device}")
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
    log(f"[serve {name}] 16 requests, prompts {lens.min()}..{lens.max()} "
        f"(sum {lens.sum()}), max_tokens {max_tokens.min()}..."
        f"{max_tokens.max()}, {runs} run(s) (the host's pace varies from "
        f"run to run)")
    steps0 = dict(llm.step_counts)
    reset_counters()
    rates = []
    for rep in range(runs):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = llm.generate(prompt_token_ids=prompts, sampling_params=params)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        n_out = sum(o.num_output_tokens for o in outs)
        rates.append(n_out / wall)
        log(f"[serve {name}] run {rep}: {n_out} tokens in {wall:.3f} s = "
            f"{n_out / wall:.1f} output tok/s")
        assert [o.num_output_tokens for o in outs] == max_tokens.tolist(), \
            f"[serve {name}] a request did not return exactly max_tokens"
        assert all(o.finish_reason == "length" for o in outs)
        assert all(0 <= t < vocab for o in outs for t in o.output_token_ids)
    counts = read_counters()
    steps = {k: llm.step_counts[k] - steps0[k] for k in steps0}
    launched = {k for k, n in counts.items() if k != "plain_calls" and n}
    log(f"[serve {name}] median {sorted(rates)[len(rates) // 2]:.1f} output "
        f"tok/s; steps {steps}; launches {counts}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert launched == must_launch, \
        f"[serve {name}] launched {launched}, expected {must_launch}"
    assert counts["plain_calls"] == 0, "plain attention ran on the card"
    mm = llm.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total, "KV pages leaked"
    if profiled:
        profile_window(llm, rng, name)
    out = dict(counts=counts, rates=rates, pages=llm.runner.num_pages,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del llm
    torch.cuda.empty_cache()
    return out


def phase_serve():
    results = {}
    for name, (kw, runs, must, profiled) in SERVE.items():
        t0 = time.monotonic()
        results[name] = serve(name, kw, runs, must, profiled)
        log(f"[serve {name}] phase wall {time.monotonic() - t0:.1f} s")
    ratio = results["int8"]["pages"] / results["bf16"]["pages"]
    log(f"[serve] KV pages from the same memory_util: bf16 "
        f"{results['bf16']['pages']}, int8 {results['int8']['pages']} "
        f"({ratio:.3f}x)")
    assert ratio >= 1.8, "int8 should give at least 1.8x the pages of bf16"
    return results


def profile_window(llm, rng, name):
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
    tag = f"[profile {name}]"
    # kernels only: a CPU op's device time repeats its kernels' times
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"{tag} 8 x (512 prompt + 24 out) tokens, steps {steps}: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}% of wall); kernels by device time:")
    for dev_us, count, key in rows[:12]:
        log(f"{tag}   {100 * dev_us / busy:5.1f}%  {dev_us / 1e3:8.3f} ms"
            f"  x{count:<5d} {key[:90]}")
    # the host side: kernels issued per step, and host time by operator
    # (self time, inflated by the profiler's own cost per op)
    n_steps = sum(steps.values())
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    host_us = sum(r[0] for r in host)
    log(f"{tag} {sum(r[1] for r in rows) / n_steps:.0f} kernels per "
        f"step; host self time {host_us / 1e3:.1f} ms "
        f"({100 * host_us / wall_us:.1f}% of wall), by operator:")
    for cpu_us, count, key in host[:10]:
        log(f"{tag}   {100 * cpu_us / host_us:5.1f}%  {cpu_us / 1e3:8.3f}"
            f" ms  x{count:<6d} {key[:60]}")


# ---- 5. reference --------------------------------------------------------

def phase_reference():
    """Depth-cut model at float32: the port on the card (CUDA kernels)
    against the port on the CPU (plain versions), same weights, with a
    float32 cache, an int8 cache, and the unified step."""
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
    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)

    def engine(p, device, kv_cache_dtype, unified):
        ec = EngineConfig(dtype="float32", seed=SEED, max_model_len=512,
                          unified_step=unified,
                          scheduler=SchedulerConfig(max_prefill_tokens=64),
                          cache=CacheConfig(num_pages=128,
                                            kv_cache_dtype=kv_cache_dtype))
        return LLM(model_cfg=cfg, config=ec, params=p, device=device)

    for label, kv_dtype, unified in (("float32 cache", "auto", False),
                                     ("int8 cache", "int8", False),
                                     ("unified step", "auto", True)):
        logits, toks = [], []
        reset_counters()
        for llm in (engine(params, "cuda", kv_dtype, unified),
                    engine(cpu_params, "cpu", kv_dtype, unified)):
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
        log(f"[reference] 2-layer f32, {label}: first step (chunked "
            f"prefill) logits max_abs_err {err} of max |logit| {scale}; "
            f"greedy tokens identical: {toks[0] == toks[1]}; card launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        assert err <= 1e-3 * max(scale, 1.0), \
            f"[reference] {label}: card and CPU logits disagree"
        assert toks[0] == toks[1], \
            f"[reference] {label}: card and CPU greedy tokens differ"
        assert all(len(t) == 8 for t in toks[0])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    smi = phase_device()
    walls = {}
    for name, phase in (("build", phase_build), ("kernels", phase_kernels),
                        ("serve", phase_serve),
                        ("reference", phase_reference)):
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
            "library_call": r["library_call"], "shapes": r["shapes"]})
    log(f"[done] {time.monotonic() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
