"""Mixed-step capture in the PyTorch port, on the CPU at float32: with
``enforce_eager`` off every mixed step (prefill chunks, chunks beside
decode rows, an absorb) and every host-driven verify step goes through
``DecodeGraphs.run`` under its key, as the card replays them, and runs the
static-buffer body the card captures. Two different mixed batches of one
key are staged at the same views and give the eager step's and the JAX
``LLM``'s greedy tokens (dense and a 3-layer DeepSeek); an absorb and a
verify step replay their keys with streams equal to JAX's; a verify
step's rows and drafts keep their offsets whatever the variable lists
hold; unified mixed keys take the pinned page bucket where blocks form;
and the steps that stay eager (a hybrid model's mixed steps,
``enforce_eager``) are counted by reason, while a mixed step with extras
replays its "mixed_extras" key. The warmup's mixed signatures
against JAX's are in tests/test_torch_graphs.py
(``test_warmup_runs_jax_combos``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models import deepseek as jds
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging
from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq
from gllm_tpu_torch.sequence import Sequence

import test_torch_mla
from test_torch_overlap import _check_drained, _engine, _hybrid
from test_torch_spec import SPEC, _workload as _drafty
from test_torch_unified_overlap import BLOCKS, KW, UNIFIED, _churn


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- (b) two mixed batches through one key's views --------------------------

# A and B prefill together (chunks of 10 and 5 tokens); C shares A's first
# two pages (a prefix-cache hit) and arrives after that step, so the next
# step holds A's and B's decode rows and C's 4-token chunk: both steps
# have 16 tokens or fewer, at most 8 rows and 4 pages, one legacy key
PREFIX = list(range(20, 28))
PROMPTS = [PREFIX + [41, 42], [51, 52, 53, 54, 55], PREFIX + [61, 62, 63, 64]]
MAX_TOKENS = [6, 5, 7]


@functools.lru_cache(maxsize=None)
def _mla_params():
    jmc, tmc = test_torch_mla._configs(dict(test_torch_mla.V2,
                                            vocab_size=512))
    return jmc, tmc, jds.init_params(jmc, seed=3, dtype=jnp.float32)


def _family(family, jax_side, **flags):
    """The dense model (test_torch_overlap's) or the 3-layer DeepSeek of
    test_torch_mla, JAX's or the port's on the same float32 weights, with
    the prefix cache and a 16-token prefill budget."""
    if family == "dense":
        return _engine(jax_side, max_prefill=16, prefix=True, **flags)
    jmc, tmc, params = _mla_params()
    if jax_side:
        return JLLM(config=JEC(
            dtype="float32", attention_impl="xla", max_model_len=128,
            max_num_seqs=8,
            scheduler=JSC(max_prefill_tokens=16, max_decode_seqs=8),
            cache=JCC(page_size=4, num_pages=64,
                      enable_prefix_caching=True), **flags),
            model_cfg=jmc, params=params)
    return gt.LLM(config=gt.EngineConfig(
        dtype="float32", max_model_len=128, max_num_seqs=8,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=16,
                                     max_decode_seqs=8),
        cache=gt.CacheConfig(page_size=4, num_pages=64,
                             enable_prefix_caching=True), **flags),
        model_cfg=tmc, params=convert.from_jax_params(
            jax.tree.map(np.asarray, params)), device="cpu")


def _two_mixed_steps(llm):
    """A and B, then C after one step: greedy streams."""
    SP = JSP if isinstance(llm, JLLM) else gt.SamplingParams
    seqs = [llm._allocate_seq(list(p), SP(temperature=0.0, max_tokens=m,
                                          ignore_eos=True))
            for p, m in zip(PROMPTS, MAX_TOKENS)]
    llm.add_seq(seqs[0])
    llm.add_seq(seqs[1])
    llm.step()
    llm.add_seq(seqs[2])
    while llm.has_unfinished:
        llm.step()
    return [s.output_token_ids for s in seqs]


def _spy_mixed(llm):
    """Each mixed step's batch and the device views it was staged at
    (every fixed view's address and shape), in order."""
    runner, seen = llm.runner, []
    upload = runner.staging.upload
    step_async = runner.step_async

    def staged(sb):
        out = upload(sb)
        if sb.max_seq_q > 1:
            views = (out.token_ids, out.positions, out.slot_mapping,
                     out.logits_indices, *out.attn, out.sampling.top_k,
                     out.sampling.temperature, out.sampling.seed)
            seen[-1][1].append([(v.data_ptr(), tuple(v.shape))
                                for v in views])
        return out

    def stepping(batch, prev=None, **kw):
        seen.append((batch, []))
        return step_async(batch, prev, **kw)
    runner.staging.upload = staged
    runner.step_async = stepping
    return seen


@pytest.mark.parametrize("family", ["dense", "deepseek"])
def test_two_mixed_batches_of_one_key(family):
    """Two mixed batches that differ in chunk lengths, a prefix-cache hit
    and decode rows are staged at the same views of one key, replay it
    (the CPU runs the captured body), and give the eager step's and the
    JAX ``LLM``'s greedy tokens."""
    graph = _family(family, False)
    seen = _spy_mixed(graph)
    got = _two_mixed_steps(graph)
    assert got == _two_mixed_steps(_family(family, False,
                                           enforce_eager=True))
    assert got == _two_mixed_steps(_family(family, True))
    (b1, v1), (b2, v2) = [x for x in seen if x[1]][:2]
    assert [it.num_new_tokens for it in b1.items] == [10, 5]
    assert [it.num_new_tokens for it in b2.items] == [1, 1, 4]
    assert b2.items[2].computed_before == 8            # the prefix hit
    runner = graph.runner
    keys = {k for k in runner.graphs.keys if k[0] == "mixed"}
    assert keys == {("mixed", 16, 8, 16, 4, True)}
    # the staged views of the capture key: the same addresses and shapes
    assert v1[-1] == v2[-1]
    assert runner.graphs.by_kind["mixed"]["replays"] == 2
    assert graph.step_counts["mixed"] == 2
    assert runner.eager_mixed == {"extras": 0, "hybrid": 0,
                                  "enforce_eager": 0}
    _check_drained(graph)


# ---- (c) an absorb and a host-driven verify step ---------------------------

def _runs_by_kind(llm):
    """Wrap ``DecodeGraphs.run`` to record the kinds of key it serves, and
    whether the dispatch was a chained re-form (an absorb's splice)."""
    runner, seen = llm.runner, []
    run, chained = runner.graphs.run, runner.step_async_chained
    state = {"chained": False}

    def running(key, body):
        seen.append((key[0] if isinstance(key[0], str) else "decode",
                     state["chained"]))
        return run(key, body)

    def chaining(batch, prev):
        state["chained"] = batch.src_rows is not None
        try:
            return chained(batch, prev)
        finally:
            state["chained"] = False
    runner.graphs.run = running
    runner.step_async_chained = chaining
    return seen


def test_absorb_replays_its_mixed_key():
    """The unified step under overlap with blocks, slots and on-device
    finish: arrivals mid-chain are absorbed through mixed re-forms, each
    a replay of its mixed key after the splice, at the token bucket and
    the pinned page bucket; streams equal the JAX ``LLM``'s (whose
    dispatches, breaks and absorbs tests/test_torch_unified_overlap.py
    holds)."""
    flags = dict(UNIFIED, **BLOCKS)
    port = _engine(False, **KW, **flags)
    runs = _runs_by_kind(port)
    assert _churn(port) == _churn(_engine(True, **KW, **flags))
    assert port.absorbs > 0
    assert ("mixed", True) in runs                   # an absorb replayed
    g, runner = port.runner.graphs, port.runner
    assert g.by_kind["mixed"]["replays"] == port.step_counts["mixed"] > 0
    assert sum(runner.eager_mixed.values()) == 0
    mixed = [k for k in g.keys if k[0] == "mixed"]
    assert mixed and all(k[1] == runner.builder.max_tokens
                         and k[4] == runner.builder.max_pages_per_seq
                         for k in mixed)


def test_host_driven_verify_replays_its_key():
    """Host-driven speculation in the sync loop: every verify step replays
    its "verify" key (width spec_k + 1, greedy), with streams equal to the
    JAX ``LLM``'s under the same flags."""
    prompts, max_tokens = _drafty(4)
    outs, engines = [], []
    for jax_side in (False, True):
        llm = _engine(jax_side, **SPEC)
        SP = JSP if jax_side else gt.SamplingParams
        got = llm.generate(prompt_token_ids=prompts, sampling_params=[
            SP(temperature=0.0, max_tokens=m, ignore_eos=True)
            for m in max_tokens])
        outs.append([o.output_token_ids for o in got])
        engines.append(llm)
    assert outs[0] == outs[1]
    port = engines[0]
    runner = port.runner
    assert runner.graphs.by_kind["verify"]["replays"] == port.verify_steps
    assert port.verify_steps > 0
    assert sum(runner.eager_mixed.values()) == 0
    verify = {k for k in runner.graphs.keys if k[0] == "verify"}
    # greedy, K1 = spec_k + 1, no drafted row sampling
    assert verify and {k[5:] for k in verify} == {
        (True, port.config.spec_k + 1, False)}
    assert (runner.graphs.by_kind["mixed"]["replays"]
            + port.verify_steps == port.step_counts["mixed"])


# ---- (d) a verify step's views keep their offsets --------------------------

def test_verify_views_keep_their_offsets():
    """A verify step's rows and drafts (and a spec block's seed) sit in
    the part of the upload whose offsets follow the key alone: uploads
    whose scale resets, slots to zero and splice maps differ in length
    stage them at the same addresses."""
    cfg = gt.EngineConfig(dtype="float32", max_model_len=64,
                          spec_decode="ngram", spec_k=4,
                          scheduler=gt.SchedulerConfig(max_prefill_tokens=16))
    builder = BatchBuilder(cfg, 4, use_ssm=True)
    staging = HostStaging("cpu", capacity=4096)
    base = builder.padding(32, 8, 4, verify_width=5)
    ptrs = set()
    for resets, zero, splice in (([], [], []), ([3, 9, 12], [1], [0, 0]),
                                 (list(range(40)), [2, 5, 7],
                                  [0, 1, 2, 0, 1, 2])):
        rows = np.arange(40, dtype=np.int32).reshape(8, 5)
        drafts = np.full((8, 4), len(resets), np.int32)
        up = staging.upload(base._replace(
            spec_rows=rows, spec_drafts=drafts, scale_resets=resets,
            ssm_zero=zero, splice=splice))
        ptrs.add((up.spec_rows.data_ptr(), up.spec_drafts.data_ptr()))
        assert np.array_equal(up.spec_rows.numpy(), rows)
        assert np.array_equal(up.spec_drafts.numpy(), drafts)
        assert (up.scale_resets is None) == (not resets)
    assert len(ptrs) == 1
    seed = np.arange(8 * 12, dtype=np.int32).reshape(8, 12)
    a = staging.upload(builder.padding(8, 8, 4)._replace(spec_seed=seed))
    b = staging.upload(builder.padding(8, 8, 4)._replace(
        spec_seed=seed, scale_resets=[1, 2, 3], ssm_zero=[4]))
    assert a.spec_seed.data_ptr() == b.spec_seed.data_ptr()
    assert np.array_equal(b.spec_seed.numpy(), seed)


# ---- (e) pinned mixed keys -------------------------------------------------

@pytest.mark.parametrize("flags,pinned", [
    (dict(overlap_scheduling=True, multi_step_decode=4), True),
    (dict(overlap_scheduling=True), False), (dict(), False)],
    ids=["blocks", "overlap", "sync"])
def test_unified_mixed_keys_take_the_pinned_page_bucket(flags, pinned):
    """Where blocks form (``pin_pages``) a unified mixed step's signature
    takes the largest page bucket, whatever its contexts; elsewhere the
    bucket its contexts need."""
    cfg = gt.EngineConfig(dtype="float32", max_model_len=256,
                          unified_step=True, **flags,
                          scheduler=gt.SchedulerConfig(
                              max_prefill_tokens=32, max_decode_seqs=8))
    builder = BatchBuilder(cfg, 4)
    assert builder.pin_pages == pinned
    items = []
    for i, (n, ctx) in enumerate(((12, 0), (1, 9), (1, 20))):
        seq = Sequence(i, list(range(1, ctx + n + 1)),
                       gt.SamplingParams(max_tokens=4))
        seq.page_table = list(range(1, (ctx + n + 3) // 4 + 1))
        items.append(ScheduledSeq(seq, n, ctx))
    t, s, q, p = builder.shape_signature(ScheduledBatch(items))
    assert (t, s, q) == (builder.max_tokens, 8, builder.max_tokens)
    assert p == (builder.max_pages_per_seq if pinned else 8)


# ---- (f) the steps that stay eager, counted by reason ----------------------

@pytest.mark.parametrize("case", ["hybrid", "extras", "enforce_eager"])
def test_eager_mixed_steps_are_counted(case):
    """A hybrid model's mixed steps (its GDN layer loops over row groups
    on the host) and every step under ``enforce_eager`` run eagerly: each
    mixed one counted by its reason, none through a mixed key. A mixed
    step carrying logprobs replays its "mixed_extras" key: none eager."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 500, int(n)).tolist() for n in (9, 14, 5)]
    sp = dict(temperature=0.0, max_tokens=6, ignore_eos=True)
    if case == "hybrid":
        llm = _hybrid()
    else:
        llm = _engine(False, enforce_eager=case == "enforce_eager")
    if case == "extras":
        sp["logprobs"] = 2
    llm.generate(prompt_token_ids=prompts,
                 sampling_params=gt.SamplingParams(**sp))
    mixed = llm.step_counts["mixed"]
    assert mixed > 0
    want = {"extras": 0, "hybrid": 0, "enforce_eager": 0}
    if case != "extras":
        want[case] = mixed
    assert llm.runner.eager_mixed == want
    g = llm.runner.graphs
    if case == "enforce_eager":
        assert g is None
    else:
        assert g.by_kind["mixed"]["replays"] == 0
        assert not any(k[0] == "mixed" for k in g.keys)
        extras = g.by_kind["mixed_extras"]["replays"]
        assert extras == (mixed if case == "extras" else 0)
