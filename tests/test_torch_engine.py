"""The PyTorch port end to end on the CPU: greedy ``generate`` is
token-identical to the JAX package's ``LLM`` on the same converted float32
weights (through chunked prefill, decode, EOS and length finishes,
arrivals mid-run and a preemption), no page leaks, the device rule, the
options it refuses, and that the port never imports jax or gllm_tpu."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models import dense as jdense
from gllm_tpu.models.config import ModelConfig as JMC
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert

REPO = Path(__file__).resolve().parents[1]
MODEL = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=64,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             intermediate_size=128, max_position=256, rope_theta=500000.0,
             rope_scaling={"rope_type": "llama3", "factor": 8.0,
                           "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                           "original_max_position_embeddings": 64})


# a DeepSeek-V2-shaped MLA + MoE model (with MODEL's other fields)
MLA = dict(architecture="DeepseekV2ForCausalLM", kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
           first_k_dense_replace=1, n_shared_experts=1)


def _jax_params():
    return jdense.init_params(JMC(**MODEL), seed=3, dtype=jnp.float32)


def _port_llm(np_params, model, num_pages, max_prefill):
    cfg = gt.EngineConfig(
        dtype="float32", max_model_len=256,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=max_prefill),
        cache=gt.CacheConfig(page_size=4, num_pages=num_pages))
    return gt.LLM(config=cfg, model_cfg=gt.ModelConfig(**model),
                  params=convert.from_jax_params(np_params), device="cpu")


def _jax_llm(params, model, num_pages, max_prefill, impl):
    cfg = JEC(dtype="float32", attention_impl=impl, max_model_len=256,
              scheduler=JSC(max_prefill_tokens=max_prefill),
              cache=JCC(page_size=4, num_pages=num_pages))
    return JLLM(config=cfg, model_cfg=JMC(**model), params=params)


def _drive(llm, SP, prompts, max_tokens, ignore_eos, arrive_after=2):
    """Requests 0..2 arrive first, the rest after ``arrive_after`` steps;
    returns {seq_id: (output ids, finish reason)}."""
    seqs = [llm._allocate_seq(list(p), SP(temperature=0.0, max_tokens=m,
                                          ignore_eos=ie))
            for p, m, ie in zip(prompts, max_tokens, ignore_eos)]
    for s in seqs[:3]:
        llm.add_seq(s)
    steps = 0
    while llm.has_unfinished or steps <= arrive_after:
        if steps == arrive_after:
            for s in seqs[3:]:
                llm.add_seq(s)
        llm.step()
        steps += 1
    return {s.seq_id: (s.output_token_ids, s.finish_reason) for s in seqs}


def _workload(n, seed=0):
    rng = np.random.default_rng(seed)
    lens = [5, 37, 12, 60, 3, 22, 9][:n]
    prompts = [rng.integers(1, 512, size=k).tolist() for k in lens]
    max_tokens = [6, 9, 4, 12, 7, 10, 5][:n]
    ignore_eos = [True, False, True, False, False, True, False][:n]
    return prompts, max_tokens, ignore_eos


@pytest.mark.parametrize("num_pages,max_prefill", [(128, 32), (30, 16)])
def test_greedy_generate_token_identical_to_jax_xla(num_pages, max_prefill):
    params = _jax_params()
    np_params = jax.tree.map(np.asarray, params)
    prompts, max_tokens, ignore_eos = _workload(7)
    # an EOS id the model really emits, so some requests stop early
    probe = _drive(_port_llm(np_params, MODEL, 128, 32), gt.SamplingParams,
                   prompts, [12] * 7, [True] * 7)
    eos = probe[1][0][3]
    model = dict(MODEL, eos_token_id=eos)

    port = _port_llm(np_params, model, num_pages, max_prefill)
    got = _drive(port, gt.SamplingParams, prompts, max_tokens, ignore_eos)
    want = _drive(_jax_llm(params, model, num_pages, max_prefill, "xla"),
                  JSP, prompts, max_tokens, ignore_eos)
    assert got == want
    assert {r for _, r in got.values()} == {"stop", "length"}
    mm = port.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total
    assert port.step_counts["mixed"] > 0 and port.step_counts["decode"] > 0
    if num_pages == 30:
        assert port.scheduler.num_preemptions > 0



def test_group7_greedy_generate_token_identical_to_jax():
    """A dense model at a GQA group of 7 (14 query over 2 KV heads; the
    card's ragged blocks take floor(64 / 7) tokens a warpgroup): greedy
    streams identical to the JAX LLM at float32, chunked prefill and
    decode steps both."""
    model = dict(MODEL, num_heads=14, num_kv_heads=2)
    params = jdense.init_params(JMC(**model), seed=5, dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    prompts, max_tokens, _ = _workload(5)
    keep = [True] * 5
    port = _port_llm(np_params, model, 128, 16)
    got = _drive(port, gt.SamplingParams, prompts, max_tokens, keep)
    want = _drive(_jax_llm(params, model, 128, 16, "xla"), JSP, prompts,
                  max_tokens, keep)
    assert got == want
    assert port.step_counts["mixed"] > 0 and port.step_counts["decode"] > 0

def _policy_workload():
    """8 requests, 6 of them sharing a 24-token prefix."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, 512, size=24).tolist()
    prompts = [prefix + rng.integers(1, 512, size=k).tolist()
               for k in (3, 9, 1, 14, 6, 11)]
    prompts += [rng.integers(1, 512, size=k).tolist() for k in (17, 30)]
    return prompts, [8, 5, 10, 6, 9, 7, 12, 4], [True] * 8


@pytest.mark.parametrize("method,num_pages", [
    ("token_throttling", 128), ("split_pd", 128),
    ("token_throttling", 18)])      # a pool that preempts
def test_policies_with_prefix_cache_token_identical_to_jax(method,
                                                          num_pages):
    """token_throttling and split_pd with the prefix cache on: the port's
    greedy streams equal the JAX LLM's (f32, XLA attention)."""
    params = _jax_params()
    np_params = jax.tree.map(np.asarray, params)
    prompts, max_tokens, ignore_eos = _policy_workload()
    port = gt.LLM(
        config=gt.EngineConfig(
            dtype="float32", max_model_len=256,
            scheduler=gt.SchedulerConfig(schedule_method=method,
                                         max_prefill_tokens=16),
            cache=gt.CacheConfig(page_size=4, num_pages=num_pages,
                                 enable_prefix_caching=True)),
        model_cfg=gt.ModelConfig(**MODEL),
        params=convert.from_jax_params(np_params), device="cpu")
    jllm = JLLM(config=JEC(dtype="float32", attention_impl="xla",
                           max_model_len=256,
                           scheduler=JSC(schedule_method=method,
                                         max_prefill_tokens=16),
                           cache=JCC(page_size=4, num_pages=num_pages,
                                     enable_prefix_caching=True)),
                model_cfg=JMC(**MODEL), params=params)
    got = _drive(port, gt.SamplingParams, prompts, max_tokens, ignore_eos)
    want = _drive(jllm, JSP, prompts, max_tokens, ignore_eos)
    assert got == want
    assert port.scheduler.num_preemptions == jllm.scheduler.num_preemptions
    if num_pages == 18:
        assert port.scheduler.num_preemptions > 0
    mm = port.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total


def test_greedy_generate_token_identical_to_jax_pallas_interpret():
    params = _jax_params()
    np_params = jax.tree.map(np.asarray, params)
    prompts, max_tokens, ignore_eos = _workload(2, seed=1)
    prompts = [prompts[0], prompts[1][:11]]
    max_tokens = [3, 3]
    got = _drive(_port_llm(np_params, MODEL, 64, 8), gt.SamplingParams,
                 prompts, max_tokens, [True, True])
    want = _drive(_jax_llm(params, MODEL, 64, 8, "pallas"), JSP, prompts,
                  max_tokens, [True, True])
    assert got == want


def test_generate_api_and_leaks():
    llm = _port_llm(jax.tree.map(np.asarray, _jax_params()), MODEL, 64, 16)

    class Tok:
        eos_token_id = None

        def encode(self, text):
            return [ord(c) % 500 + 1 for c in text]

        def decode(self, ids):
            return " ".join(map(str, ids))

    with pytest.raises(ValueError, match="tokenizer"):
        llm.generate("hello")
    outs = llm.generate(prompt_token_ids=[[1, 2, 3], list(range(1, 30))],
                        sampling_params=gt.SamplingParams(
                            temperature=0.8, top_k=20, max_tokens=5,
                            ignore_eos=True))
    assert [o.num_output_tokens for o in outs] == [5, 5]
    assert all(o.finish_reason == "length" for o in outs)
    llm.tokenizer = Tok()
    out = llm.generate("hello", gt.SamplingParams(temperature=0.0,
                                                  max_tokens=3))[0]
    assert out.prompt_token_ids == Tok().encode("hello")
    # the output text is detokenized incrementally, as the JAX package's:
    # the text the output tokens add to a window of the prompt's last ones
    head = out.prompt_token_ids[-6:]
    assert out.text == Tok().decode(head + out.output_token_ids)[
        len(Tok().decode(head)):]
    mm = llm.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total


def test_abort_frees_pages():
    llm = _port_llm(jax.tree.map(np.asarray, _jax_params()), MODEL, 64, 16)
    seqs = [llm._allocate_seq(list(range(1, 20)),
                              gt.SamplingParams(max_tokens=50,
                                                ignore_eos=True))
            for _ in range(2)]
    for s in seqs:
        llm.add_seq(s)
    llm.step()
    llm.abort(seqs[0].seq_id)
    while llm.has_unfinished:
        llm.step()
    assert seqs[0].finish_reason == "abort"
    assert seqs[1].num_output_tokens == 50
    mm = llm.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total


def test_step_kind_follows_the_kernel_dispatch():
    # one-token prompts make prefill steps with max_q_len == 1: they
    # dispatch to the decode kernel, so they count as decode steps
    llm = _port_llm(jax.tree.map(np.asarray, _jax_params()), MODEL, 64, 16)
    llm.generate(prompt_token_ids=[[5], [7]],
                 sampling_params=gt.SamplingParams(max_tokens=3,
                                                   ignore_eos=True))
    assert llm.step_counts == {"mixed": 0, "decode": 3}
    llm.generate(prompt_token_ids=[[5, 6]],
                 sampling_params=gt.SamplingParams(max_tokens=2,
                                                   ignore_eos=True))
    assert llm.step_counts == {"mixed": 1, "decode": 4}


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gt.EngineConfig(load_format="dummy")
    small = gt.ModelConfig(**dict(MODEL, num_layers=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.LLM(config=cfg, model_cfg=small)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.LLM(config=cfg, model_cfg=small, device="cuda")


@pytest.mark.parametrize("field,value", [
    ("spec_fused", True), ("prefix_peers", "x"), ("spec_decode", "ngram"),
    ("quantization", "int8"),
    ("kv_cache_dtype", "float32"), ("tp", 2), ("pp", 2), ("dp", 2),
    ("sp", 2), ("kv_host_pool_gb", 1.0), ("kv_disk_path", "/x"),
    # options a model family does not take (the family rides the field):
    # an MLA latent cache takes no int8, a hybrid model neither, nor prefix
    # caching (it takes the unified step and leaves it inert:
    # tests/test_torch_unified_overlap.py)
    ("mla:kv_cache_dtype", "int8"), ("hybrid:kv_cache_dtype", "int8"),
    ("hybrid:enable_prefix_caching", True)])
def test_validate_refuses_unported_options(field, value):
    cfg = gt.EngineConfig()
    family, _, field = field.rpartition(":")
    for target in (cfg, cfg.cache, cfg.parallel):
        if hasattr(target, field):
            setattr(target, field, value)
            break
    model = None
    if family == "mla":
        model = gt.ModelConfig(**dict(MODEL, **MLA))
    elif family == "hybrid":
        from test_torch_gdn import HF
        model = gt.from_hf_config(HF)
    if family:
        cfg.validate()           # the option alone is taken
    with pytest.raises(NotImplementedError):
        cfg.validate(model)


@pytest.mark.parametrize("kwargs", [
    dict(overlap_scheduling=True), dict(pipelined_loop=True),
    dict(overlap_scheduling=True, multi_step_decode=8),
    dict(overlap_scheduling=True, enforce_eager=True), dict()])
def test_validate_takes_decode_slot_batching(kwargs):
    """Persistent slots are ported: taken with every overlap mode, and
    without overlap (where, as in JAX, they do nothing); enforce_eager
    clears them, as JAX's validate does."""
    cfg = gt.EngineConfig(decode_slot_batching=True, **kwargs)
    cfg.validate()
    assert cfg.decode_slot_batching == (not kwargs.get("enforce_eager"))


def test_validate_takes_int8_kv_and_the_unified_sync_step():
    for dtype in ("bfloat16", "float16", "float32"):
        gt.EngineConfig(dtype=dtype, unified_step=True,
                        cache=gt.CacheConfig(kv_cache_dtype="int8")).validate()
    # the unified step under overlap scheduling is taken and normalized as
    # the JAX package's validate does: it lifts the pipelined loop
    from gllm_tpu.config import EngineConfig as JEC
    cfg = gt.EngineConfig(unified_step=True, overlap_scheduling=True)
    jcfg = JEC(unified_step=True, overlap_scheduling=True)
    cfg.validate()
    jcfg.validate()
    for f in ("unified_step", "overlap_scheduling", "pipelined_loop",
              "chain_under_prefill"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.pipelined_loop


@pytest.mark.parametrize("kwargs", [
    dict(seed=1), dict(repetition_penalty=1.2), dict(presence_penalty=0.5),
    dict(logit_bias={3: 1.0}), dict(logprobs=2), dict(prompt_logprobs=1),
    dict(frequency_penalty=0.5)])
def test_unported_sampling_params_raise(kwargs):
    with pytest.raises(NotImplementedError):
        gt.SamplingParams(**kwargs).validate()


def test_unported_model_families_raise():
    # MoE stays refused on a Llama arch; DeepSeek's MLA is served, its
    # sparse attention (DSA) is not
    for extra in (dict(num_experts=8),
                  dict(MLA, index_topk=64, index_n_heads=4),
                  dict(layer_types=("linear_attention",)),
                  dict(vision_config={})):
        with pytest.raises(NotImplementedError):
            gt.ModelConfig(**dict(MODEL, **extra)).check_supported()
    gt.ModelConfig(**dict(MODEL, **MLA)).check_supported()
    with pytest.raises(NotImplementedError, match="MLA"):
        gt.ModelConfig(**dict(MODEL, kv_lora_rank=64)).check_supported()


def test_port_runs_without_jax_or_gllm_tpu():
    code = (
        "import sys\n"
        "import gllm_tpu_torch as gt\n"
        "cfg = gt.EngineConfig(dtype='float32', load_format='dummy',\n"
        "    max_model_len=64, cache=gt.CacheConfig(page_size=4,\n"
        "    num_pages=32))\n"
        "mc = gt.ModelConfig(architecture='LlamaForCausalLM',\n"
        "    vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,\n"
        "    num_kv_heads=1, head_dim=16, intermediate_size=64,\n"
        "    max_position=64)\n"
        "out = gt.LLM(config=cfg, model_cfg=mc, device='cpu').generate(\n"
        "    prompt_token_ids=[[1, 2, 3]],\n"
        "    sampling_params=gt.SamplingParams(max_tokens=3))\n"
        "assert out[0].num_output_tokens == 3\n"
        "import gllm_tpu_torch.entrypoints.api_server\n"
        "import gllm_tpu_torch.entrypoints.tool_parsers\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'gllm_tpu' or m.startswith('gllm_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_source_imports_no_jax_or_gllm_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gllm_tpu)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((REPO / "gllm_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    # the serving front end and the metrics are scanned too
    for sub in ("entrypoints", "obs"):
        assert any(f.parent.name == sub for f in files), sub
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders
