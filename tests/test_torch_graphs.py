"""The compiled step (``runner/graphs.py``) on the CPU: with
``enforce_eager=False`` the runner runs every pure-decode and mixed step
(but a hybrid model's mixed ones) through the static-buffer body that the
card captures as a CUDA graph, and its greedy streams stay
token-identical to the JAX package's ``LLM`` at float32 on the same
converted weights (dense legacy and unified, an int8 and an fp8 cache,
DeepSeek's MLA + MoE, a hybrid GDN period), through arrivals mid-run, EOS
and length finishes and a 30-page pool that preempts; the device buffer
is allocated once; the signature cache counts the decode and mixed
signatures met; ``warmup`` runs JAX's bucket combos and mixed pass and
leaves no state behind."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models import dense as jdense
from gllm_tpu.models.config import ModelConfig as JMC
from gllm_tpu.runner.prepare import BatchBuilder as JBatchBuilder
from gllm_tpu.runner.runner import ModelRunner as JRunner
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert
from gllm_tpu_torch.runner import graphs

from test_torch_engine import MODEL, _drive, _workload
import test_torch_gdn
import test_torch_mla


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny models: one torch thread, so that parallel test workers do not
    oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(model, params, num_pages, kv="auto", unified=False,
          eager=False):
    return gt.LLM(config=gt.EngineConfig(
        dtype="float32", max_model_len=256, unified_step=unified,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=16),
        cache=gt.CacheConfig(page_size=4, num_pages=num_pages,
                             kv_cache_dtype=kv),
        enforce_eager=eager),
        model_cfg=gt.ModelConfig(**model),
        params=convert.from_jax_params(jax.tree.map(np.asarray, params)),
        device="cpu")


@functools.lru_cache(maxsize=None)
def _dense_params():
    """JAX float32 weights of MODEL, and an EOS id the model really emits
    (request 1's fourth token, as test_torch_engine's probe finds it)."""
    params = jdense.init_params(JMC(**MODEL), seed=3, dtype=jnp.float32)
    prompts, _, _ = _workload(7)
    eos = _drive(_port(MODEL, params, 128), gt.SamplingParams, prompts,
                 [12] * 7, [True] * 7)[1][0][3]
    return params, eos


def _dense_engines(num_pages, kv="auto", unified=False):
    """The JAX LLM and the port's (graph body) on the same float32 weights,
    with an EOS id, so some requests stop early."""
    params, eos = _dense_params()
    model = dict(MODEL, eos_token_id=eos)
    jllm = JLLM(config=JEC(dtype="float32", max_model_len=256,
                           unified_step=unified, attention_impl="xla",
                           scheduler=JSC(max_prefill_tokens=16),
                           cache=JCC(page_size=4, num_pages=num_pages,
                                     kv_cache_dtype=kv)),
                model_cfg=JMC(**model), params=params)
    return jllm, _port(model, params, num_pages, kv, unified)


def _record_signatures(llm):
    """Wrap the runner's dispatch to collect the graph keys of its steps:
    (T, S, max_q_len, pages) and all_greedy, tagged "mixed" for a step
    that is not pure decode (a hybrid model's mixed steps run eagerly and
    have none)."""
    runner, seen = llm.runner, set()
    step_async = runner.step_async

    def recording(batch, prev=None):
        key = runner.builder.shape_signature(batch) + (all(
            it.seq.sampling_params.temperature == 0.0
            for it in batch.items),)
        if all(it.num_new_tokens == 1 for it in batch.items):
            seen.add(key)
        elif not runner.hybrid:
            seen.add(("mixed",) + key)
        return step_async(batch, prev)
    runner.step_async = recording
    return seen


def _check_graph_run(llm, seen):
    runner = llm.runner
    assert llm.config.enforce_eager is False
    assert runner.graphs is not None and not runner.graphs.cuda
    assert runner.staging.allocations == 1
    assert runner.num_shape_signatures == len(seen)
    assert runner.graphs.keys == seen
    decode = {k for k in seen if k[0] != "mixed"}
    assert len({k[3] for k in decode}) > 1     # the page bucket moved
    mixed = llm.step_counts["mixed"]
    assert runner.graphs.by_kind["mixed"]["replays"] == (
        0 if runner.hybrid else mixed)
    assert runner.eager_mixed == {"extras": 0, "enforce_eager": 0,
                                  "hybrid": mixed if runner.hybrid else 0}
    assert llm.scheduler.num_preemptions > 0
    mm = llm.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total
    assert llm.step_counts["mixed"] > 0 and llm.step_counts["decode"] > 0


DENSE = {"dense": {}, "dense_unified": dict(unified=True),
         "int8": dict(kv="int8"), "fp8": dict(kv="fp8")}


@pytest.mark.parametrize("case", list(DENSE))
def test_graph_body_greedy_identical_to_jax(case):
    """The _drive/_workload traffic (arrivals after two steps, EOS and
    length finishes) over a 30-page pool that preempts."""
    jllm, tllm = _dense_engines(30, **DENSE[case])
    prompts, max_tokens, ignore_eos = _workload(7)
    seen = _record_signatures(tllm)
    got = _drive(tllm, gt.SamplingParams, prompts, max_tokens, ignore_eos)
    want = _drive(jllm, JSP, prompts, max_tokens, ignore_eos)
    assert got == want
    assert {r for _, r in got.values()} == {"stop", "length"}
    _check_graph_run(tllm, seen)


def _mla_engines(enforce_eager):
    jmc, tmc = test_torch_mla._configs(dict(test_torch_mla.V2,
                                            vocab_size=512))
    return gt.LLM(config=gt.EngineConfig(
        dtype="float32", max_model_len=128, enforce_eager=enforce_eager,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=16),
        cache=gt.CacheConfig(page_size=4, num_pages=30)),
        model_cfg=tmc, device="cpu")


def _hybrid_engines(enforce_eager):
    _, tmc = test_torch_gdn._configs(dict(test_torch_gdn.HF,
                                          vocab_size=512))
    return gt.LLM(config=gt.EngineConfig(
        dtype="float32", max_model_len=128, max_num_seqs=16,
        enforce_eager=enforce_eager,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=16),
        cache=gt.CacheConfig(page_size=4, num_pages=30)),
        model_cfg=tmc, device="cpu")


def _dense_port(enforce_eager):
    return _port(MODEL, _dense_params()[0], 30, eager=enforce_eager)


@pytest.mark.parametrize("make", [_dense_port, _mla_engines,
                                  _hybrid_engines],
                         ids=["dense", "mla", "hybrid"])
def test_graph_body_greedy_identical_to_eager(make):
    """Twelve requests of short prompts and long outputs (nine arriving
    after two steps) over a 30-page pool that preempts: the sequence
    bucket goes 16 → 8 and the page bucket 4 → 8. The graph body's streams
    equal the per-step path's on the same dummy weights (the JAX package
    holds both: test_torch_mla and test_torch_gdn run the default graph
    body against the JAX LLM)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, int(n)).tolist()
               for n in rng.integers(2, 8, 12)]
    max_tokens = [int(m) for m in rng.integers(12, 30, 12)]
    keep = [True] * 12
    graph, eager = make(False), make(True)
    seen = _record_signatures(graph)
    got = _drive(graph, gt.SamplingParams, prompts, max_tokens, keep, 2)
    want = _drive(eager, gt.SamplingParams, prompts, max_tokens, keep, 2)
    assert got == want
    assert eager.runner.graphs is None
    assert eager.runner.num_shape_signatures == 0
    _check_graph_run(graph, seen)
    # the sequence bucket moved
    assert {k[1] for k in seen if k[0] != "mixed"} == {8, 16}


class _StubRunner:
    """What JAX's ``ModelRunner.warmup`` reads of its runner (its batch
    builder, for the signatures), recording each step it asks for."""

    def __init__(self, config, num_pages):
        self.config = config
        self.num_pages = num_pages
        self.builder = JBatchBuilder(config, config.cache.page_size)
        self.steps = []

    def step(self, batch):
        self.steps.append(batch)


def _decode_steps(batches):
    """(sequences, pages, temperature) of each pure-decode batch."""
    return [(len(b.items), len(b.items[0].seq.page_table),
             b.items[0].seq.sampling_params.temperature)
            for b in batches
            if all(it.num_new_tokens == 1 for it in b.items)]


def _warm_config(unified=False, **kw):
    return gt.EngineConfig(
        dtype="float32", max_model_len=128, max_num_seqs=16,
        unified_step=unified,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=16,
                                     max_decode_seqs=16),
        cache=gt.CacheConfig(page_size=4, num_pages=30,
                             enable_prefix_caching=True, **kw))


@pytest.mark.parametrize("buckets,unified", [
    (None, False), (((8,), (4, 8)), False), (None, True)],
    ids=["default", "given", "unified"])
def test_warmup_runs_jax_combos(buckets, unified):
    """The port's warmup runs JAX's decode combos, greedy and sampled,
    largest sequence and page bucket first (the graphs' pools then grow
    at the first key), and meets the mixed signatures (T, S, pages) that
    JAX's mixed pass leaves in its ``_seen_sigs``, for the legacy and the
    unified step."""
    decode_buckets, page_buckets = buckets or (None, None)
    stub = _StubRunner(JEC(dtype="float32", max_model_len=128,
                           max_num_seqs=16, unified_step=unified,
                           scheduler=JSC(max_prefill_tokens=16,
                                         max_decode_seqs=16),
                           cache=JCC(page_size=4, num_pages=30)), 30)
    JRunner.warmup(stub, decode_buckets, page_buckets)
    want = _decode_steps(stub.steps)
    jax_mixed = {(t, s, p) for t, s, _, p in (
        stub.builder.shape_signature(b) for b in stub.steps
        if any(it.num_new_tokens > 1 for it in b.items))}
    llm = gt.LLM(config=_warm_config(unified),
                 model_cfg=gt.ModelConfig(**MODEL), device="cpu")
    ran = []
    step = llm.runner.step
    llm.runner.step = lambda b: (ran.append(b), step(b))[1]
    llm.runner.warmup(decode_buckets, page_buckets)
    got = _decode_steps(ran)
    assert sorted(got) == sorted(want)
    assert got == sorted(want, key=lambda x: (-x[0], -x[1], x[2]))
    combos = graphs.warmup_combos(16, 32, 30, decode_buckets, page_buckets)
    assert [(n, p) for n, p, _ in want[::2]] == combos
    mixed_rows = [len(b.items) for b in ran
                  if any(it.num_new_tokens > 1 for it in b.items)]
    assert mixed_rows == sorted(mixed_rows, reverse=True)
    keys = llm.runner.graphs.keys
    mixed = {k for k in keys if k[0] == "mixed"}
    assert jax_mixed and {(k[1], k[2], k[4]) for k in mixed} == jax_mixed
    # greedy and sampled: the port's key holds all_greedy
    assert len(mixed) == 2 * len(jax_mixed) == len(ran) - len(want)
    if unified:
        assert {k[1] for k in mixed} == {llm.runner.builder.max_tokens}
    assert llm.runner.num_shape_signatures == 2 * len(combos) + len(mixed)


def test_warmup_leaves_no_state():
    """Warmup mid-serving over an int8 cache with prefix caching: the step
    counts, launch counters, free pages, prefix hashes, pending scale
    resets, the pages' contents and scales and the generator come out as
    they were, and the streams that follow equal those of a twin that
    never warmed."""
    prompts, max_tokens, _ = _workload(5)
    sp = [gt.SamplingParams(temperature=0.0, max_tokens=m, ignore_eos=True)
          for m in max_tokens]
    llms = [gt.LLM(config=_warm_config(kv_cache_dtype="int8"),
                   model_cfg=gt.ModelConfig(**MODEL), device="cpu")
            for _ in range(2)]
    for x in llms:
        x.generate(prompt_token_ids=prompts[:3], sampling_params=sp[:3])
    llm, twin = llms
    runner, mm = llm.runner, llm.memory_manager

    def state():
        return (dict(llm.step_counts), graphs.launch_counts(),
                mm.num_free_pages, dict(mm.hash_to_page),
                list(mm.scale_resets), runner.kv.k[:, 1:].clone(),
                runner.kv.k_scale[:, 1:].clone(),
                runner.generator.get_state())

    waiting = [x._allocate_seq(list(prompts[3]), sp[3]) for x in llms]
    for x, seq in zip(llms, waiting):
        x.add_seq(seq)
    mm.scale_resets.append(7)            # a pending reset survives too
    before = state()
    assert before[3]                     # prefix hashes exist
    runner.warmup()
    for b, a in zip(before, state()):
        assert torch.equal(b, a) if isinstance(b, torch.Tensor) else b == a
    assert runner.num_shape_signatures > 0
    mm.scale_resets.remove(7)
    outs = [x.generate(prompt_token_ids=prompts[4:], sampling_params=sp[4:])
            for x in llms]
    assert ([o.output_token_ids for o in outs[0]]
            == [o.output_token_ids for o in outs[1]])
    assert waiting[0].output_token_ids == waiting[1].output_token_ids


@pytest.mark.parametrize("T,E,K", [(1, 4, 1), (7, 8, 2), (33, 16, 6)])
def test_every_expert_product_equals_the_grouped_one(T, E, K):
    """The capture-safe expert product that float32 takes on CUDA (every
    expert over every row, unrouted rows weighted zero) gives the grouped
    product's result, repeated experts and unused ones included."""
    from gllm_tpu_torch.models import moe
    rng = np.random.default_rng(T + E)
    H, I = 16, 8
    x = torch.from_numpy(rng.standard_normal((T, H)).astype(np.float32))
    weights = torch.softmax(torch.from_numpy(
        rng.standard_normal((T, K)).astype(np.float32)), -1)
    ids = torch.from_numpy(rng.integers(0, E, (T, K)).astype(np.int32))
    w_gate_up = torch.from_numpy(
        rng.standard_normal((E, H, 2 * I)).astype(np.float32))
    w_down = torch.from_numpy(
        rng.standard_normal((E, I, H)).astype(np.float32))
    want = moe.grouped_experts(x, weights, ids, w_gate_up, w_down)
    got = moe._every_expert(x, weights, ids, w_gate_up, w_down)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
