"""The port's tracing and step attribution (``gllm_tpu_torch/obs``:
steptrace, spans, dump; the engine's step events and request spans) on
the CPU, held against the JAX package's on the same inputs:

- the step FLOPs model is exactly JAX's for Llama-3.2-1B, DeepSeek-V2-Lite
  and Qwen3-Next (each package's ``from_hf_config`` of one config.json);
- ``summarize``, ``chrome_trace``, ``dump.format_table`` and ``dump
  --format chrome`` give the same output on the same events (the event
  lists of JAX's tests/test_tracing.py and tests/test_metrics.py, and a
  real engine's);
- ``SpanTrace``'s ring, open bound and phase cap behave as JAX's;
- a float32 sync engine (with the prefix cache) and a unified one, run in
  both packages (JAX on XLA attention), record the same step events
  (kind, rows, tokens, mix, k), the same prefix probes and the same span
  phases for each request, every step event with ``ph``, ``dev_ms`` and,
  with ``GLLM_TPU_PEAK_TFLOPS`` set, ``mfu``; a block engine's events
  carry k, k_exec and the dead row-sub-steps;
- the KV read estimate's unit (a context token's cache bytes) is JAX's
  for dense caches of every dtype and the hybrid family, and 576/640 of
  it for DeepSeek's latent row, which the port stores unpadded;
- ``tracing=False`` gives the same streams and records no span;
- abort, deadline and quarantine close a request's span tree;
- every metric the JAX package registers in a module the port has is
  registered by the port with the same type and labels, and every event
  kind the port records is in ``STEP_KINDS``.
"""

import dataclasses
import json
import re
import time
import types

import jax.numpy as jnp
import pytest

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models.config import (ModelConfig as JMC,
                                    from_hf_config as j_from_hf)
from gllm_tpu.obs import dump as jdump
from gllm_tpu.obs import metrics as jobs
from gllm_tpu.obs import spans as jspans
from gllm_tpu.obs import steptrace as jst
from gllm_tpu.runner.runner import ModelRunner as JRunner
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.engine import serving_engine as tse
from gllm_tpu_torch.models.registry import get_model_def
from gllm_tpu_torch.obs import dump as tdump
from gllm_tpu_torch.obs import metrics as tobs
from gllm_tpu_torch.obs import spans as tspans
from gllm_tpu_torch.obs import steptrace as tst
from gllm_tpu_torch.runner.runner import DTYPES

from test_torch_engine import MODEL
from test_torch_serving import (StubTokenizer, _params, engines,  # noqa
                                one_thread)

# ---- configurations: each package parses the same config.json ----------

LLAMA = dict(architectures=["LlamaForCausalLM"], vocab_size=128256,
             hidden_size=2048, num_hidden_layers=16, num_attention_heads=32,
             num_key_value_heads=8, head_dim=64, intermediate_size=8192,
             max_position_embeddings=4096, rope_theta=500000.0,
             tie_word_embeddings=True)
DEEPSEEK = dict(
    architectures=["DeepseekV2ForCausalLM"], vocab_size=102400,
    hidden_size=2048, num_hidden_layers=27, num_attention_heads=16,
    num_key_value_heads=16, q_lora_rank=None, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    intermediate_size=10944, moe_intermediate_size=1408,
    n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2,
    first_k_dense_replace=1, moe_layer_freq=1, topk_method="greedy",
    n_group=1, topk_group=1, scoring_func="softmax", norm_topk_prob=False,
    routed_scaling_factor=1.0, rope_theta=10000,
    rope_scaling={"type": "yarn", "factor": 40,
                  "original_max_position_embeddings": 4096,
                  "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                  "mscale_all_dim": 0.707},
    max_position_embeddings=163840, rms_norm_eps=1e-6,
    tie_word_embeddings=False, eos_token_id=100001)
QWEN3_NEXT = dict(
    architectures=["Qwen3NextForCausalLM"], vocab_size=151936,
    hidden_size=2048, num_hidden_layers=12, num_attention_heads=16,
    num_key_value_heads=2, head_dim=256, partial_rotary_factor=0.25,
    rope_theta=10000000, rms_norm_eps=1e-6, max_position_embeddings=262144,
    full_attention_interval=4, linear_num_key_heads=16,
    linear_num_value_heads=32, linear_key_head_dim=128,
    linear_value_head_dim=128, linear_conv_kernel_dim=4, num_experts=512,
    num_experts_per_tok=10, norm_topk_prob=True, moe_intermediate_size=512,
    shared_expert_intermediate_size=512, intermediate_size=5120,
    decoder_sparse_step=1, mlp_only_layers=[], hidden_act="silu",
    tie_word_embeddings=False, eos_token_id=151645,
    layer_types=["full_attention" if (i + 1) % 4 == 0
                 else "linear_attention" for i in range(12)])
CONFIGS = {"llama": LLAMA, "deepseek": DEEPSEEK, "qwen3_next": QWEN3_NEXT}


def _both(hf):
    return j_from_hf(dict(hf)), gt.from_hf_config(dict(hf))


# ---- the FLOPs model ------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_flops_model_equals_jax(name):
    jmc, tmc = _both(CONFIGS[name])
    jfm = jspans.StepFlopsModel.from_model_config(jmc)
    tfm = tspans.StepFlopsModel.from_model_config(tmc)
    for attr in ("body_per_token", "lm_head_per_row", "attn_coeff"):
        assert getattr(tfm, attr) == getattr(jfm, attr), attr
    rows = [(1, 10, True), (17, 0, True), (64, 200, False), (1, 4095, True)]
    assert tfm.step_flops(rows) == jfm.step_flops(rows)
    for k in (1, 4, 16):
        ctxs = [0, 7, 1000, 4000]
        assert tfm.block_flops(ctxs, k) == jfm.block_flops(ctxs, k)


def test_peak_table_names_the_h100_sxm(monkeypatch):
    monkeypatch.delenv("GLLM_TPU_PEAK_TFLOPS", raising=False)
    assert tspans.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "", "cpu"):
        assert tspans.peak_flops(other) == 0.0
    monkeypatch.setenv("GLLM_TPU_PEAK_TFLOPS", "2.5")
    assert tspans.peak_flops("anything") == jspans.peak_flops("x") == 2.5e12
    monkeypatch.setenv("GLLM_TPU_PEAK_TFLOPS", "bogus")
    assert tspans.peak_flops("NVIDIA H100 80GB HBM3") == 989e12


# ---- summarize / chrome_trace / dump on the same events -------------------

def _step_event(tr, kind, t, sched, build, disp, coll, wall, dev,
                mfu=None, **extra):
    """tests/test_tracing.py's helper: a step event with its attribution
    fields at a pinned ``t``."""
    tr.record(kind, num_seqs=2, tokens=2, wall_ms=coll, rtt_ms=wall,
              ph={"schedule": sched, "build": build, "dispatch": disp,
                  "collect": coll},
              step_wall_ms=wall, dev_ms=dev,
              **({"mfu": mfu} if mfu is not None else {}), **extra)
    tr._buf[(tr._next_seq - 1) % tr.capacity]["t"] = t


def _fixtures():
    """The event lists of JAX's tests (attribution window, plain kinds,
    chrome reconstruction) and a window with every other event kind."""
    out = []
    tr = tst.StepTrace(capacity=64)
    _step_event(tr, "decode", 0.010, 1.0, 2.0, 1.0, 2.0, wall=10.0,
                dev=8.0, mfu=0.5)
    _step_event(tr, "decode", 0.020, 1.0, 2.0, 1.0, 2.0, wall=10.0,
                dev=8.0, mfu=0.5)
    out.append(tr.events())
    tr = tst.StepTrace(capacity=64)
    tr.record("prefill", tokens=512, wall_ms=30.0, num_seqs=4)
    for _ in range(3):
        tr.record("decode", tokens=8, wall_ms=90.0, num_seqs=8)
    tr.record("fused_block", tokens=64, wall_ms=88.0, k=8, num_seqs=8)
    tr.record("compile", dispatch="step")
    tr.record("chain_break", num_seqs=8)
    out.append(tr.events())
    tr = tst.StepTrace(capacity=16)
    _step_event(tr, "prefill", 0.050, 2.0, 3.0, 1.0, 4.0, wall=12.0,
                dev=5.0)
    _step_event(tr, "unified_step", 0.060, 1.0, 1.0, 1.0, 1.0, wall=5.0,
                dev=3.0, mfu=0.25, mix="decode", hbm_gbps=100.0,
                inflight=2)
    _step_event(tr, "fused_block", 0.090, 1.0, 1.0, 1.0, 9.0, wall=20.0,
                dev=15.0, mfu=0.4, k=8, k_exec=6, dead_substeps=3,
                k_drafted=10, k_accepted=7, hbm_gbps=900.0, inflight=1)
    tr.record("prefix", query_tokens=32, hit_tokens=16, pages={"hbm": 4})
    tr.record("loop_stall", reason="depth", depth=2)
    tr.record("quarantine", num_seqs=1)
    tr.record("fault", point="engine_unhealthy", error="x")
    tr.record("chain_break", num_seqs=3, reason="reform")
    out.append(tr.events())
    return out


SPAN_RECORDS = [{"seq_id": 7, "t0": 100.0, "t1": 100.2, "reason": "stop",
                 "prompt_tokens": 5, "output_tokens": 3,
                 "phases": [{"ph": "queued", "t": 100.0, "dur_ms": 10.0},
                            {"ph": "decode_chain", "t": 100.05,
                             "dur_ms": 20.0, "k": 8}]},
                {"seq_id": 9, "t0": 100.1, "t1": None, "reason": None,
                 "prompt_tokens": 2, "output_tokens": 0, "phases": []}]


@pytest.mark.parametrize("i", range(3))
def test_summarize_chrome_and_table_equal_jax(i):
    events = _fixtures()[i]
    assert tst.summarize(events) == jst.summarize(events)
    assert (tspans.chrome_trace(events, SPAN_RECORDS, span_t0=100.0)
            == jspans.chrome_trace(events, SPAN_RECORDS, span_t0=100.0))
    assert tdump.format_table(events) == jdump.format_table(events)


@pytest.mark.parametrize("argv", [[], ["--summary"],
                                  ["--format", "chrome"],
                                  ["--kind", "compile", "--summary"],
                                  ["--since", "2", "--summary"],
                                  ["--kind", "decode,fused_block"]])
def test_dump_cli_equals_jax(tmp_path, capsys, argv):
    tr = tst.StepTrace(capacity=16)
    _step_event(tr, "decode", 0.010, 1.0, 1.0, 1.0, 1.0, wall=5.0, dev=3.0)
    tr.record("fused_block", tokens=32, wall_ms=3.0, k=8, num_seqs=4)
    tr.record("compile", dispatch="step")
    p = tmp_path / "t.jsonl"
    assert tr.to_jsonl(str(p)) == 3
    outs = []
    for mod in (tdump, jdump):
        assert mod.main([str(p)] + argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    # the GET /steptrace payload shape is read too
    p2 = tmp_path / "payload.json"
    p2.write_text(json.dumps({"events": tr.events()}))
    assert tdump.main([str(p2), "--summary"]) == 0
    assert json.loads(capsys.readouterr().out)["compiles"] == 1


def test_steptrace_ring_rollover_and_marks():
    tr = tst.StepTrace(capacity=8)
    for i in range(20):
        tr.record("decode", tokens=i)
    assert len(tr) == 8 and tr.dropped == 12
    assert [e["seq"] for e in tr.events()] == list(range(12, 20))
    mark = tr.mark()
    tr.record("prefill", tokens=99)
    assert [e["kind"] for e in tr.events(since=mark)] == ["prefill"]
    assert [e["kind"] for e in tr.events(kinds=["prefill"])] == ["prefill"]
    tr.clear()
    assert len(tr) == 0 and tr.mark() == 0


def test_trace_cap_from_the_environment(monkeypatch):
    monkeypatch.setenv("GLLM_OBS_TRACE_CAP", "5")
    assert tst.StepTrace().capacity == 5
    monkeypatch.setenv("GLLM_OBS_SPAN_CAP", "3")
    monkeypatch.setenv("GLLM_OBS_SPAN_PHASES", "2")
    sp = tspans.SpanTrace()
    assert (sp.capacity, sp.max_phases) == (3, 2)
    with pytest.raises(ValueError):
        tst.StepTrace(capacity=0)


def test_ring_and_spans_hold_under_threads():
    """The engine thread records while HTTP threads read: 12 threads (more
    than a test host usually has cores) record events and span children
    and read the ring and the trees, at a short switch interval; no
    record is lost and every tree closes with all its children."""
    import sys
    import threading
    tr = tst.StepTrace(capacity=1 << 16)
    sp = tspans.SpanTrace(capacity=4096, max_open=4096, max_phases=1000)
    n_threads, n = 12, 300
    errors = []

    def work(w):
        try:
            for i in range(n):
                tr.record("decode", tokens=1, worker=w)
                sid = w * n + i
                sp.begin(sid, 0.0, 0.0)
                sp.event_many([sid], "decode_step", 0.0, 1.0)
                sp.event(sid, "detokenize", 0.0, 1.0)
                sp.finish(sid, "length", 1.0)
                tst.summarize(tr.events(since=max(0, tr.mark() - 50)))
                sp.spans()
                sp.open_spans()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert tr.mark() == len(tr.events()) == n_threads * n
    assert [e["seq"] for e in tr.events()] == list(range(n_threads * n))
    done = sp.spans()
    assert len(done) == n_threads * n and sp.open_count == 0
    assert all([p["ph"] for p in r["phases"]] == ["decode_step",
                                                  "detokenize"]
               for r in done)


# ---- SpanTrace ------------------------------------------------------------

def _span_story(mod):
    """JAX's span unit tests, as a list of what each step returned."""
    got = []
    tr = mod.SpanTrace(capacity=4, max_open=8, max_phases=64)
    tr.begin(1, arrival_t=10.0, admitted_t=10.5, prompt_tokens=7)
    tr.begin(1, arrival_t=99.0, admitted_t=99.5)
    got.append(tr.open_count)
    tr.event(1, "prefill_chunk", 10.6, 3.0, tokens=7)
    tr.event(999, "decode_step", 0.0, 1.0)
    got.append(tr.finish(1, "stop", 11.0, output_tokens=3))
    got.append(tr.finish(1, "stop", 12.0))
    for sid in range(2, 9):
        tr.begin(sid, sid * 1.0, sid * 1.0 + 0.1)
        tr.event_many([sid, 1000], "decode_step", sid + 0.2, 1.5)
        tr.finish(sid, "length", sid * 1.0 + 1)
    got.append(([r["seq_id"] for r in tr.spans()], tr.dropped))
    tr = mod.SpanTrace(capacity=8, max_open=2, max_phases=3)
    for sid in (1, 2, 3):
        tr.begin(sid, 0.0, 0.1)
    got.append((tr.open_count, tr.untracked, len(tr.open_spans())))
    for i in range(6):
        tr.event(1, "decode_step", float(i), 2.0)
    got.append(tr.finish(1, "length", 10.0))
    tr.clear()
    got.append((tr.open_count, tr.spans(), tr.untracked))
    return got


def test_span_trace_equals_jax():
    got = _span_story(tspans)
    assert got == _span_story(jspans)
    assert got[1]["phases"][0]["dur_ms"] == pytest.approx(500.0)
    assert got[3] == ([5, 6, 7, 8], 4)
    assert got[4] == (2, 1, 2)
    assert len(got[5]["phases"]) == 3
    assert got[5]["agg"]["decode_step"] == {"n": 4, "ms": 8.0}


# ---- engines of both packages ---------------------------------------------

STEP_KINDS = ("prefill", "decode", "unified_step", "fused_block")


def _engine(jax_side, prefix=False, **flags):
    """engines()'s float32 engines, with the prefix cache on request."""
    if not prefix:
        return engines(jax_side, **flags)
    jparams, tparams = _params()
    sched = dict(max_prefill_tokens=32, max_decode_seqs=8)
    if jax_side:
        return JLLM(config=JEC(
            dtype="float32", attention_impl="xla", max_model_len=256,
            max_num_seqs=8, scheduler=JSC(**sched),
            cache=JCC(page_size=4, num_pages=128,
                      enable_prefix_caching=True), **flags),
            model_cfg=JMC(**MODEL), params=jparams,
            tokenizer=StubTokenizer())
    return gt.LLM(config=gt.EngineConfig(
        dtype="float32", max_model_len=256, max_num_seqs=8,
        scheduler=gt.SchedulerConfig(**sched),
        cache=gt.CacheConfig(page_size=4, num_pages=128,
                             enable_prefix_caching=True), **flags),
        model_cfg=gt.ModelConfig(**MODEL), params=tparams,
        tokenizer=StubTokenizer(), device="cpu")


PROMPTS = [[5, 9, 13, 17, 21, 25, 29, 33, 37, 41], [3, 4, 5],
           [5, 9, 13, 17, 21, 25, 29, 33, 37, 41, 7, 8], list(range(1, 40))]


def _run(llm, trace, sp_cls, max_tokens=(6, 9, 4, 7)):
    mark = trace.mark()
    outs = llm.generate(prompt_token_ids=PROMPTS, sampling_params=[
        sp_cls(temperature=0.0, ignore_eos=True, max_tokens=m)
        for m in max_tokens])
    return [o.output_token_ids for o in outs], trace.events(since=mark)


def _shape(events):
    """What both packages must agree on: step events' (kind, rows,
    tokens, mix, k) and prefix probes' counts, in order."""
    out = []
    for e in events:
        if e["kind"] in STEP_KINDS:
            out.append((e["kind"], e["num_seqs"], e["tokens"], e.get("mix"),
                        e.get("k")))
        elif e["kind"] == "prefix":
            out.append(("prefix", e["query_tokens"], e["hit_tokens"],
                        e["pages"]))
    return out


def _phases(llm):
    return {r["seq_id"]: ([p["ph"] for p in r["phases"]], r["reason"],
                          r["output_tokens"])
            for r in llm.spans.spans()}


@pytest.mark.parametrize("mode", ["sync_prefix", "unified"])
def test_engine_events_and_spans_equal_jax(mode, monkeypatch):
    monkeypatch.setenv("GLLM_TPU_PEAK_TFLOPS", "1")
    flags = ({"prefix": True} if mode == "sync_prefix"
             else {"unified_step": True})
    runs = []
    for jax_side, trace, sp in ((True, jst.TRACE, JSP),
                                (False, tst.TRACE, gt.SamplingParams)):
        # twice: with the prefix cache the second run's prompts hit the
        # first's pages; without it the second run meets the same
        # signatures, none new
        llm = _engine(jax_side, **flags)
        runs.append((llm,) + _run(llm, trace, sp) + _run(llm, trace, sp))
    (jllm, jstreams, jev, jstreams2, jev2), \
        (tllm, tstreams, tev, tstreams2, tev2) = runs
    assert tstreams == jstreams == tstreams2 == jstreams2
    assert _shape(tev) == _shape(jev) and _shape(tev2) == _shape(jev2)
    if mode == "unified":
        assert [e for e in tev2 if e["kind"] == "compile"] == []
    tev = tev + tev2
    if mode == "sync_prefix":
        assert any(e[0] == "prefix" and e[2] > 0 for e in _shape(tev))
        assert tllm.memory_manager.cache_hit_rate == \
            jllm.memory_manager.cache_hit_rate > 0
    else:
        assert {e.get("mix") for e in tev if e["kind"] in STEP_KINDS} \
            == {"mixed", "decode"}
    assert _phases(tllm) == _phases(jllm)
    assert tllm.spans.open_count == 0 and len(_phases(tllm)) == 8
    assert all({"ph", "dev_ms", "mfu"} <= set(e) for e in jev + jev2
               if e["kind"] in STEP_KINDS)
    steps = [e for e in tev if e["kind"] in STEP_KINDS]
    for e in steps:
        assert set(e["ph"]) == {"schedule", "build", "dispatch", "collect"}
        assert e["dev_ms"] >= 0 and e["step_wall_ms"] > 0
        assert e["mfu"] > 0 and e["hbm_gbps"] > 0
        assert sum(e["ph"].values()) <= e["step_wall_ms"] * 1.10 + 0.5
    s = tst.summarize(tev)
    assert s["mfu"] > 0 and s["device_mfu"] > 0
    assert set(s["host_ms_by_phase"]) == {"schedule", "build", "dispatch",
                                          "collect"}
    assert s.keys() == jst.summarize(jev).keys()
    assert {e["kind"] for e in tev} <= set(tst.STEP_KINDS)


@pytest.mark.parametrize("spec", [False, True], ids=["blocks", "spec"])
def test_block_events_carry_k_exec_and_chain_spans(monkeypatch, spec):
    monkeypatch.setenv("GLLM_TPU_PEAK_TFLOPS", "1")
    flags = (dict(spec_decode="ngram", spec_fused=True) if spec
             else dict(pipelined_loop=True))
    llm = engines(False, ondevice_finish=True, decode_chain_len=4, **flags)
    streams, ev = _run(llm, tst.TRACE, gt.SamplingParams,
                       max_tokens=(12, 9, 14, 10))
    blocks = [e for e in ev if e["kind"] == "fused_block"]
    assert blocks and all(1 <= e["k_exec"] <= e["k"]
                          and "dead_substeps" in e and e["mfu"] > 0
                          for e in blocks)
    if spec:
        # a spec block's tokens are what it emitted
        assert all({"k_drafted", "k_accepted", "spec_tokens"} <= set(e)
                   and e["tokens"] == e["spec_tokens"] for e in blocks)
        # the prompts, then every output token but the first (which
        # the prefill step samples)
        assert sum(e["tokens"] for e in ev if e["kind"] in STEP_KINDS) \
            == sum(map(len, PROMPTS)) + sum(map(len, streams)) - len(PROMPTS)
    chains = [p for r in llm.spans.spans() for p in r["phases"]
              if p["ph"] == "decode_chain"]
    assert chains and all("k_exec" in c for c in chains)
    s = tst.summarize(ev)
    assert s["decode_substeps_fused"] > 0 and s["mean_inflight_depth"] >= 0
    assert s["dead_substep_frac"] is not None
    assert s["loop_stalls"] == sum(llm.stalls.values())
    assert {e["kind"] for e in ev} <= set(tst.STEP_KINDS)


# ---- the KV read estimate's unit ------------------------------------------

def _jax_tok_bytes(jmc, kv):
    dtype = {"auto": jnp.bfloat16, "int8": jnp.int8,
             "fp8": jnp.float8_e4m3fn}[kv]
    stub = types.SimpleNamespace(
        model_cfg=jmc, mesh=None, kv_quant=kv == "int8",
        config=JEC(cache=JCC(page_size=16, kv_cache_dtype=kv)),
        _kv_dtype=lambda: dtype)
    return JRunner._kv_bytes_per_page(stub) / 16


def _port_tok_bytes(tmc, kv):
    dtype = DTYPES["bfloat16" if kv == "auto" else kv]
    return get_model_def(tmc).kv_bytes_per_page(tmc, 16, dtype) / 16


@pytest.mark.parametrize("name,kv", [("llama", "auto"), ("llama", "int8"),
                                     ("llama", "fp8"),
                                     ("qwen3_next", "auto"),
                                     ("qwen3_next", "fp8"),
                                     ("deepseek", "auto"),
                                     ("deepseek", "fp8")])
def test_kv_read_unit_against_jax(name, kv):
    jmc, tmc = _both(CONFIGS[name])
    want, got = _jax_tok_bytes(jmc, kv), _port_tok_bytes(tmc, kv)
    if name == "deepseek":
        # JAX pads the latent row to 640 lanes; the port stores 576
        assert got / want == pytest.approx(576 / 640, abs=0, rel=1e-12)
    else:
        assert got == want


def test_runner_kv_read_follows_the_context():
    llm = engines(False)
    r = llm.runner
    assert r._kv_rd_tok_bytes == r.kv_bytes_per_page() / 4
    assert r.param_bytes == sum(
        t.nbytes for t in _leaves(r.params))
    llm.generate(prompt_token_ids=[[1, 2, 3]], sampling_params=gt.
                 SamplingParams(temperature=0.0, max_tokens=2,
                                ignore_eos=True))
    # the last dispatch: one decode row whose context is 4 tokens
    assert r.last_phases["kv_bytes"] == int(4 * r._kv_rd_tok_bytes)
    assert r.last_phases["build"] >= 0 and r.last_phases["dispatch"] > 0


def test_eager_steps_are_marked_and_keep_jax_dev_ms(monkeypatch):
    """Every step's device wall is JAX's, ready - max(dispatched,
    previous ready), so never more than its round trip from the runner
    call's return; a step whose body ran op by op says so (``eager``, with
    its reason), a step of the graph path does not."""
    monkeypatch.setenv("GLLM_TPU_PEAK_TFLOPS", "1")
    for flags, mark in (({}, None), ({"enforce_eager": True},
                                     "enforce_eager")):
        streams, ev = _run(engines(False, **flags), tst.TRACE,
                           gt.SamplingParams)
        steps = [e for e in ev if e["kind"] in STEP_KINDS]
        assert steps and all(e.get("eager") == mark for e in steps)
        assert all(0 <= e["dev_ms"] <= e["rtt_ms"] + 1e-3 for e in steps)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---- tracing off, terminal paths ------------------------------------------

def test_tracing_off_same_streams_no_spans():
    on = engines(False)
    off = engines(False, tracing=False)
    assert on.tracing and not off.tracing
    a, ev_on = _run(on, tst.TRACE, gt.SamplingParams)
    b, ev_off = _run(off, tst.TRACE, gt.SamplingParams)
    assert a == b
    assert off.spans.spans() == [] and off.spans.open_count == 0
    assert len(on.spans.spans()) == len(PROMPTS)
    # the step-trace ring stays on
    assert _shape(ev_off) == _shape(ev_on)


def _last(handle):
    last = None
    for c in handle:
        last = c
    return last


def test_abort_deadline_and_quarantine_close_spans():
    from gllm_tpu_torch import SamplingParams
    llm = engines(False)
    collect = llm.runner.collect
    fail = {"n": 0}

    def flaky(handle):
        if fail["n"]:
            fail["n"] -= 1
            raise RuntimeError("device fault")
        return collect(handle)
    llm.runner.collect = flaky
    eng = tse.ServingEngine(llm)
    spans = llm.spans

    def closed(sid):
        limit = time.monotonic() + 10
        while not any(r["seq_id"] == sid for r in spans.spans()):
            assert time.monotonic() < limit, "span never closed"
            time.sleep(0.01)
        return [r for r in spans.spans() if r["seq_id"] == sid][-1]
    try:
        ha = eng.submit([5, 6, 7], SamplingParams(
            temperature=0.0, ignore_eos=True, max_tokens=200))
        first = ha.chunks.get(timeout=60)
        eng.abort(ha.seq_id)
        last = first if first.finish_reason else _last(ha)
        assert last.finish_reason in ("abort", "length")
        assert closed(ha.seq_id)["reason"] == last.finish_reason
        hb = eng.submit([9, 9, 9], SamplingParams(
            temperature=0.0, ignore_eos=True, max_tokens=240),
            deadline_s=0.05)
        assert _last(hb).finish_reason == "deadline"
        assert closed(hb.seq_id)["reason"] == "deadline"
        mark = tst.TRACE.mark()
        fail["n"] = 1
        hc = eng.submit([1, 2, 3], SamplingParams(
            temperature=0.0, ignore_eos=True, max_tokens=8))
        assert _last(hc).finish_reason == "error"
        assert closed(hc.seq_id)["reason"] == "error"
        assert [e["num_seqs"] for e in tst.TRACE.events(
            since=mark, kinds=["quarantine"])] == [1]
        assert spans.open_count == 0
    finally:
        eng.shutdown()


def test_unhealthy_latch_records_a_fault_event():
    llm = engines(False, max_step_failures=1)
    llm.runner.collect = lambda handle: (_ for _ in ()).throw(
        RuntimeError("device fault"))
    mark = tst.TRACE.mark()
    eng = tse.ServingEngine(llm)
    try:
        h = eng.submit([4, 5], gt.SamplingParams(temperature=0.0,
                                                 max_tokens=3))
        assert _last(h).finish_reason == "error"
        faults = tst.TRACE.events(since=mark, kinds=["fault"])
        assert [e["point"] for e in faults] == ["engine_unhealthy"]
        assert llm.spans.open_count == 0
    finally:
        eng.shutdown()


# ---- the metric catalogue -------------------------------------------------

# every module the port has whose JAX counterpart registers metrics
MODULES = ("engine/llm.py", "engine/serving_engine.py", "runner/runner.py",
           "scheduler.py", "memory_manager.py")
# metrics of those JAX modules that belong to options the port does not
# run yet, each with its ROADMAP queue row (none left)
UNPORTED: dict = {}
_REG = re.compile(r'obs\.(counter|gauge|histogram)\(\s*"([^"]+)"')


def test_metric_catalogue_matches_jax():
    import importlib
    for mod in MODULES:
        dotted = mod[:-3].replace("/", ".")
        importlib.import_module("gllm_tpu." + dotted)
        importlib.import_module("gllm_tpu_torch." + dotted)
    checked = []
    for mod in MODULES:
        with open(f"gllm_tpu/{mod}") as f:
            names = _REG.findall(f.read())
        assert names, mod
        for kind, name in names:
            if name in UNPORTED:
                continue
            want = jobs.REGISTRY.get(name)
            got = tobs.REGISTRY.get(name)
            assert got is not None, f"{name} ({mod}) is not registered"
            assert (got.kind, got.labelnames) == (want.kind,
                                                  want.labelnames), name
            assert got.kind == kind, name
            assert getattr(got, "buckets", None) == getattr(
                want, "buckets", None), name
            checked.append(name)
    assert len(checked) == len(set(checked)) >= 40


def test_recorded_kinds_are_in_the_catalogue():
    """Every ``TRACE.record`` kind in the port's sources is in
    ``STEP_KINDS``, and the catalogues are JAX's."""
    import pathlib
    root = pathlib.Path(gt.__file__).parent
    kinds = set()
    for path in root.rglob("*.py"):
        kinds |= set(re.findall(r'TRACE\.record\(\s*"([a-z_]+)"',
                                path.read_text()))
    assert kinds >= {"compile", "chain_break", "loop_stall", "quarantine",
                     "prefix", "fault"}
    assert kinds <= set(tst.STEP_KINDS)
    assert tst.STEP_KINDS == jst.STEP_KINDS
    assert tst.CHAIN_BREAK_REASONS == jst.CHAIN_BREAK_REASONS
    assert tst.LOOP_STALL_REASONS == jst.LOOP_STALL_REASONS
    assert tspans.SPAN_PHASES == jspans.SPAN_PHASES
    assert tspans._ENGINE_TIDS == jspans._ENGINE_TIDS
    assert (tspans._PID_ENGINE, tspans._PID_REQUESTS) == (
        jspans._PID_ENGINE, jspans._PID_REQUESTS)


def test_config_tracing_field_as_jax():
    assert gt.EngineConfig().tracing is JEC().tracing is True
    assert dataclasses.replace(gt.EngineConfig(), tracing=False).tracing \
        is False
