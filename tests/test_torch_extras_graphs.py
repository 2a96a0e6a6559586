"""Extras-step capture in the PyTorch port, on the CPU at float32: with
``enforce_eager`` off a step whose batch carries penalties, logit_bias,
logprobs or prompt logprobs goes through ``DecodeGraphs.run`` under its
kind's "_extras" key (the flags adjust, lp, plp), as the card replays it,
and runs the static-buffer body the card captures. Two batches of one key
that differ in penalty lengths, bias counts and logprob N are staged at
the same views and give the eager engine's and the JAX ``LLM``'s streams,
logprobs and prompt logprobs (dense and a 3-layer DeepSeek, mixed and
decode steps, with the mask's fast path on); a host-driven verify step
with penalties and logprobs replays its key; a penalized request that
grows from 20 to 300 tokens meets one key per page bucket; the extras
keep their offsets whatever the variable lists hold; and the mask's
bounded fast path equals the port's sort form and JAX's two masks on the
cases of tests/test_sampling_fastpath.py. The absorb loop's extras steps
against JAX are in tests/test_torch_sampling_engine.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gllm_tpu.ops import sampling as jsampling
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.ops import sampling as tsampling
from gllm_tpu_torch.runner.prepare import (BIAS_PAIRS, BatchBuilder,
                                           HostStaging)
from gllm_tpu_torch.utils import bucket_size, cdiv

from test_torch_mixed_graphs import PREFIX, _family
from test_torch_overlap import MODEL, _check_drained, _engine
from test_torch_sampling import LP_TOL, _lp_close
from test_torch_spec import SPEC, _workload as _drafty

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- (a) two batches of one extras key --------------------------------------

# A and B prefill together; C (a prefix-cache hit on A's first two pages)
# arrives after that step, so the second step holds A's and B's decode rows
# and C's chunk: both mixed steps take one "mixed_extras" key, with other
# penalty lengths, bias counts and logprob N; the decode steps that follow
# take one "decode_extras" key as the sequences grow
PROMPTS = [PREFIX + [41, 42], [51, 52, 53, 54, 55], PREFIX + [61, 62, 63, 64]]
EXTRAS = [
    dict(temperature=0.0, repetition_penalty=1.3, logit_bias={5: 3.0},
         logprobs=1, prompt_logprobs=2, max_tokens=7),
    dict(temperature=0.8, top_p=0.9, seed=17, presence_penalty=0.5,
         logit_bias={7: -2.0, 9: 4.0, 11: 1.5}, logprobs=4, max_tokens=6),
    dict(temperature=0.0, frequency_penalty=0.3, logprobs=2,
         prompt_logprobs=1, logit_bias={3: 2.0, 8: -1.0, 13: 0.5, 21: 1.0,
                                        34: -0.5}, max_tokens=8)]


def _two_extras_steps(llm):
    """A and B, then C after one step: (tokens, output logprobs, prompt
    logprobs) of each."""
    SP = gt.SamplingParams if isinstance(llm, gt.LLM) else JSP
    seqs = [llm._allocate_seq(list(p), SP(ignore_eos=True, **sp))
            for p, sp in zip(PROMPTS, EXTRAS)]
    llm.add_seq(seqs[0])
    llm.add_seq(seqs[1])
    llm.step()
    llm.add_seq(seqs[2])
    while llm.has_unfinished:
        llm.step()
    return [(s.output_token_ids, s.output_logprobs, s.prompt_logprobs)
            for s in seqs]


def _spy_extras(llm):
    """Each extras step's key and the device views its extras were staged
    at (address and shape of each), in order."""
    runner, seen = llm.runner, []
    upload, run = runner.staging.upload, runner.graphs.run

    def staged(sb):
        out = upload(sb)
        md = out.sampling
        views = [v for v in (out.penalty_ids, md.repetition_penalty,
                             md.bias_ids, md.bias_vals, out.plp_targets)
                 if v is not None]
        seen.append([None, [(v.data_ptr(), tuple(v.shape))
                            for v in views]])
        return out

    def running(key, body):
        seen[-1][0] = key
        return run(key, body)
    runner.staging.upload = staged
    runner.graphs.run = running
    return seen


@pytest.mark.parametrize("family", ["dense", "deepseek"])
def test_two_extras_batches_of_one_key(family, monkeypatch):
    """Two mixed batches (chunks with every extra, then decode rows beside
    a prefix hit's chunk) and the decode steps after them: each kind's
    extras key replayed by batches with other penalty lengths, bias
    counts and logprob N, staged at the same views, giving the eager
    engine's streams and logprobs exactly and the JAX ``LLM``'s within
    ``LP_TOL`` (a seeded sampled row through the mask's fast path, whose
    bound is shrunk below the vocabulary); no step ran eagerly."""
    monkeypatch.setattr(tsampling, "TOPK_FAST_BOUND", 16)
    graph = _family(family, False)
    seen = _spy_extras(graph)
    got = _two_extras_steps(graph)
    eager = _two_extras_steps(_family(family, False, enforce_eager=True))
    assert got == eager
    want = _two_extras_steps(_family(family, True))
    for g, w in zip(got, want):
        assert g[0] == w[0]
        _lp_close(g[1], w[1])
        _lp_close(g[2], w[2])
    assert [len(g[1]) for g in got] == [7, 6, 8]
    runner = graph.runner
    by = runner.graphs.by_kind
    views = {}
    for key, v in seen:
        views.setdefault(key, []).append(v)
    # every replay of a key staged its extras at the key's views
    assert all(v == vs[0] for vs in views.values() for v in vs)
    keys = [key for key, _ in seen]
    assert keys[:2] == [("mixed_extras", 16, 8, 16, 4, False, True, True,
                         True)] * 2
    decode = {k for k in keys[2:]}
    # the decode keys differ in the page bucket and all_greedy alone
    assert {k[:4] + k[6:] for k in decode} == {
        ("decode_extras", 8, 8, 1, True, True, False)}
    assert max(keys.count(k) for k in decode) >= 3
    assert by["mixed_extras"]["replays"] == 2 == graph.step_counts["mixed"]
    assert by["decode_extras"]["replays"] == graph.step_counts["extras"]
    assert graph.step_counts["decode"] == 0
    assert by["mixed"]["replays"] == by["decode"]["replays"] == 0
    assert runner.eager_mixed == {"extras": 0, "hybrid": 0,
                                  "enforce_eager": 0}
    _check_drained(graph)


# ---- (b) a host-driven verify step with penalties and logprobs --------------

def test_host_driven_verify_with_extras_replays_its_key():
    """Host-driven speculation, penalties and logprobs on greedy rows:
    every verify step replays its "verify_extras" key (adjusted logits,
    the verify rows' logprobs), with streams equal to the JAX ``LLM``'s
    and logprobs within ``LP_TOL``."""
    prompts, max_tokens = _drafty(4)
    kinds = [dict(repetition_penalty=1.2, logprobs=2),
             dict(presence_penalty=0.4, frequency_penalty=0.2),
             dict(logprobs=0), dict()]
    outs = []
    for jax_side in (False, True):
        llm = _engine(jax_side, **SPEC)
        SP = JSP if jax_side else gt.SamplingParams
        got = llm.generate(prompt_token_ids=prompts, sampling_params=[
            SP(temperature=0.0, max_tokens=m, ignore_eos=True, **k)
            for m, k in zip(max_tokens, kinds)])
        outs.append([(o.output_token_ids, o.logprobs) for o in got])
        if not jax_side:
            port = llm
    for g, w in zip(*outs):
        assert g[0] == w[0]
        _lp_close(g[1], w[1])
    runner = port.runner
    by = runner.graphs.by_kind
    assert port.verify_steps > 0
    assert by["verify_extras"]["replays"] == port.verify_steps
    assert by["verify"]["replays"] == 0
    verify = {k for k in runner.graphs.keys if k[0] == "verify_extras"}
    # greedy, K1 = spec_k + 1, no drafted row sampling, adjust; lp while
    # a row that asks for logprobs runs
    k1 = port.config.spec_k + 1
    assert {k[5:] for k in verify} == {(True, k1, False, True, True, False),
                                       (True, k1, False, True, False, False)}
    assert sum(runner.eager_mixed.values()) == 0
    _check_drained(port)


# ---- (c) the keys do not follow a sequence's length -------------------------

def test_penalized_request_keys_follow_page_buckets_only():
    """A penalized request with logit_bias and logprobs growing from 20 to
    300 tokens: its decode steps take one "decode_extras" key per page
    bucket (the penalty ids are ``max_model_len`` wide whatever the
    length), its prefill one mixed key."""
    llm = gt.LLM(config=gt.EngineConfig(
        dtype="float32", load_format="dummy", max_model_len=320,
        max_num_seqs=8, scheduler=gt.SchedulerConfig(
            max_prefill_tokens=32, max_decode_seqs=8),
        cache=gt.CacheConfig(page_size=4, num_pages=96)),
        model_cfg=gt.ModelConfig(**dict(MODEL, max_position=512)),
        device="cpu")
    out, = llm.generate(prompt_token_ids=[list(range(100, 120))],
                        sampling_params=[gt.SamplingParams(
                            temperature=0.0, max_tokens=280,
                            ignore_eos=True, repetition_penalty=1.1,
                            logit_bias={4: 1.0}, logprobs=3)])
    assert out.num_output_tokens == 280 and len(out.logprobs) == 280
    keys = llm.runner.graphs.keys
    decode = sorted(k for k in keys if k[0] == "decode_extras")
    # a decode step's context ends at 21..299 tokens, in 4-token pages
    assert [k[4] for k in decode] == sorted(
        {bucket_size(cdiv(n, 4), 4, 80) for n in range(21, 300)})
    assert {k[1:4] + k[5:] for k in decode} == {
        (8, 8, 1, True, True, True, False)}
    assert len(keys) == len(decode) + 1
    assert llm.runner.builder.penalty_len == 320
    _check_drained(llm)


# ---- (d) the extras keep their offsets --------------------------------------

def test_extras_views_keep_their_offsets():
    """The extras (penalties, penalty ids, logit_bias pairs, prompt-logprob
    targets) sit in the part of the upload whose offsets follow the key
    alone: uploads whose scale resets, slots to zero and splice maps
    differ in length stage them at the same addresses, at their fixed
    widths."""
    cfg = gt.EngineConfig(dtype="float32", max_model_len=64,
                          scheduler=gt.SchedulerConfig(max_prefill_tokens=16))
    builder = BatchBuilder(cfg, 4, use_ssm=True)
    b = builder
    staging = HostStaging("cpu", capacity=b.upload_size(32, 8, 4)
                          + b.extras_size(32, 8) + 64)
    base = builder.padding(32, 8, 4, adjust=True, plp=True)
    assert base.penalty_ids.shape == (8, 64)
    assert base.sampling.bias_ids.shape == (8, BIAS_PAIRS)
    ptrs = set()
    for resets, zero, splice in (([], [], []), ([3, 9, 12], [1], [0, 0]),
                                 (list(range(40)), [2, 5, 7],
                                  [0, 1, 2, 0, 1, 2])):
        ids = np.full((8, 64), -1, np.int32)
        ids[0, :len(resets) + 1] = 7
        md = base.sampling._replace(
            repetition_penalty=np.full(8, 1.0 + len(resets), np.float32))
        up = staging.upload(base._replace(
            penalty_ids=ids, sampling=md, scale_resets=resets,
            ssm_zero=zero, splice=splice))
        views = (up.penalty_ids, up.sampling.repetition_penalty,
                 up.sampling.presence_penalty, up.sampling.frequency_penalty,
                 up.sampling.bias_ids, up.sampling.bias_vals,
                 up.plp_targets)
        ptrs.add(tuple(v.data_ptr() for v in views))
        assert np.array_equal(up.penalty_ids.numpy(), ids)
        assert (up.sampling.repetition_penalty.numpy()
                == 1.0 + len(resets)).all()
        assert up.sampling.bias_vals.dtype == torch.float32
    assert len(ptrs) == 1


# ---- (e) the mask's bounded fast path ---------------------------------------

VOCAB = 97


def _rows(seed=0, S=9, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(S, vocab)) * 3.0).astype(np.float32)


def _params(S, vocab, rng):
    top_k = rng.choice([-1, 1, 3, 10, vocab], size=S).astype(np.int32)
    top_p = rng.choice([0.1, 0.5, 0.9, 1.0], size=S).astype(np.float32)
    min_p = rng.choice([0.0, 0.05, 0.3], size=S).astype(np.float32)
    return top_k, top_p, min_p


def _masks(logits, top_k, top_p, min_p, with_jax=True):
    """(port fast, port sort[, JAX fast, JAX sort]) masks as numpy, with
    the branch the port's fast path took."""
    taken = []

    def select(flag, fast, slow):
        taken.append(bool(flag))
        return tsampling.host_select(flag, fast, slow)
    t = [None if a is None else torch.from_numpy(a)
         for a in (logits, top_k, top_p, min_p)]
    masks = [tsampling.topk_topp_mask(*t, select=select).numpy(),
             tsampling.topk_topp_mask_sort(*t).numpy()]
    if with_jax:
        j = [None if a is None else jnp.asarray(a)
             for a in (logits, top_k, top_p, min_p)]
        masks += [np.asarray(jsampling._topk_topp_mask(*j)),
                  np.asarray(jsampling._topk_topp_mask_sort(*j))]
    return masks, taken


@pytest.mark.parametrize("bound", [8, 16, 64])
def test_fast_path_matches_sort_form_and_jax(monkeypatch, bound):
    """Shrunk bounds over a 97-token vocabulary, rows of every top-k,
    top-p and min-p: the port's fast path equals its sort form, with and
    without min-p, and (first draw) JAX's fast and sort masks."""
    monkeypatch.setattr(tsampling, "TOPK_FAST_BOUND", bound)
    monkeypatch.setattr(jsampling, "_TOPK_FAST_BOUND", bound)
    rng = np.random.default_rng(bound)
    for seed in range(4):
        logits = _rows(seed)
        tk, tp, mp = _params(logits.shape[0], VOCAB, rng)
        for m in (mp, None):
            masks, taken = _masks(logits, tk, tp, m, with_jax=seed == 0)
            assert len(taken) == 1
            for x in masks[1:]:
                np.testing.assert_array_equal(masks[0], x)


def test_fast_path_falls_back_for_a_wide_nucleus(monkeypatch):
    """top_p 0.999 over near-uniform logits keeps more than the bound:
    the fallback gives the sort form's mask."""
    monkeypatch.setattr(tsampling, "TOPK_FAST_BOUND", 8)
    monkeypatch.setattr(jsampling, "_TOPK_FAST_BOUND", 8)
    logits = (np.random.default_rng(7).normal(size=(4, VOCAB)) * 0.01
              ).astype(np.float32)
    masks, taken = _masks(logits, np.full(4, -1, np.int32),
                          np.full(4, 0.999, np.float32), None)
    assert taken == [False]
    for x in masks[1:]:
        np.testing.assert_array_equal(masks[0], x)
    assert int(np.isfinite(masks[1]).sum(axis=-1).max()) > 8


def test_fast_path_keeps_top_k_only_rows(monkeypatch):
    """A top-k batch (top_p 1) stays on the fast branch: five kept a row,
    the sort form's mask."""
    monkeypatch.setattr(tsampling, "TOPK_FAST_BOUND", 8)
    monkeypatch.setattr(jsampling, "_TOPK_FAST_BOUND", 8)
    logits = _rows(3)
    S = logits.shape[0]
    masks, taken = _masks(logits, np.full(S, 5, np.int32),
                          np.ones(S, np.float32), None)
    assert taken == [True]
    assert (np.isfinite(masks[0]).sum(axis=-1) == 5).all()
    for x in masks[1:]:
        np.testing.assert_array_equal(masks[0], x)


def test_sample_end_to_end_identical(monkeypatch):
    """``sample`` draws the same tokens whichever mask runs (the same
    generator state: the same Gumbel argmax); at the full bound a small
    vocabulary takes the sort form directly, as in JAX."""
    rng = np.random.default_rng(11)
    S = 8
    logits = torch.from_numpy(_rows(5, S=S))
    md = tsampling.SamplingMetadata(
        temperature=torch.from_numpy(rng.uniform(0.5, 1.5, S)
                                     .astype(np.float32)),
        top_p=torch.from_numpy(rng.choice([0.5, 0.9], S).astype(np.float32)),
        top_k=torch.from_numpy(rng.choice([4, 7], S).astype(np.int32)),
        min_p=torch.zeros(S))
    tokens = []
    for bound in (0, 16, tsampling.TOPK_FAST_BOUND):
        monkeypatch.setattr(tsampling, "TOPK_FAST_BOUND", bound)
        tokens.append(tsampling.sample(
            logits, md, torch.Generator().manual_seed(3)).tolist())
    assert tokens[0] == tokens[1] == tokens[2]
    jlogits = jnp.asarray(logits.numpy())
    tk, tp = jnp.asarray(md.top_k.numpy()), jnp.asarray(md.top_p.numpy())
    np.testing.assert_array_equal(
        tsampling.topk_topp_mask(logits, md.top_k, md.top_p).numpy(),
        np.asarray(jsampling._topk_topp_mask(jlogits, tk, tp)))
