"""Prompt-lookup speculative decoding in the PyTorch port, on the CPU at
float32, held against the JAX package's: the host proposer, the on-device
proposer, the ring, the verify rule (greedy exactly; sampled with its
draws fixed, against a numpy rendering of JAX's rule), the FutureMap's
over-promise trim and the AIMD draft length, one function at a time; then
whole engines against the JAX ``LLM`` with the same flags, host-driven
(sync and under overlap, where speculation owns decode dispatch) and fused
into the blocks (alone, with on-device finish, slots and the unified
step, or with on-device finish and slots, and under bench.py's full flag
set), for the dense and DeepSeek
families: greedy streams, dispatches in order (verify steps, spec blocks
by K), drafts proposed and accepted, each sequence's draft length at the
end, chain breaks by reason and ``gllm_spec_fused_tokens_total`` by kind
are equal, over EOS inside an accepted run, length caps, a run near
``max_model_len``, the prefix cache cold and warm, memory pressure,
arrival churn with joins, int8 and fp8 caches and stop strings (text and
usage too). Sampled rows beside greedy ones, the option rules, the hybrid
refusal and a failing step inside a fused chain close it."""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gllm_tpu import scheduler as jsched
from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine import llm as jllm_mod
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.engine.pipeline import (FutureMap as JFutureMap,
                                      InFlight as JInFlight)
from gllm_tpu.memory_manager import make_memory_manager as j_make_mm
from gllm_tpu.models import deepseek as jds
from gllm_tpu.obs.steptrace import TRACE
from gllm_tpu.ops import sampling as jsamp
from gllm_tpu.sampling_params import SamplingParams as JSP
from gllm_tpu.sequence import Sequence as JSeq

import gllm_tpu_torch as gt
from gllm_tpu_torch import scheduler as tsched
from gllm_tpu_torch.engine import llm as tllm_mod
from gllm_tpu_torch.engine.pipeline import FutureMap, InFlight
from gllm_tpu_torch.memory_manager import make_memory_manager
from gllm_tpu_torch.models import convert
from gllm_tpu_torch.ops import sampling as tsamp
from gllm_tpu_torch.sequence import Sequence

import test_torch_mla
from test_torch_overlap import _check_drained, _engine
from test_torch_serving import _stop_run, engines as _tok_engines

SPEC = dict(spec_decode="ngram")
FLAGS = {
    "host": SPEC,
    # host-driven speculation owns decode dispatch under overlap
    "host_overlap": dict(SPEC, pipelined_loop=True, multi_step_decode=4),
    "fused": dict(SPEC, spec_fused=True),
    # the slot twin's flags: persistent slots and on-device finish, the
    # ramp (chains yield to prefill for 8 links)
    "fused_slots": dict(SPEC, spec_fused=True, ondevice_finish=True,
                        decode_slot_batching=True, pipelined_loop=True,
                        chain_under_prefill=8),
    # bench.py's full profile (bench.py:608-636)
    "bench": dict(SPEC, spec_fused=True, overlap_scheduling=True,
                  pipelined_loop=True, unified_step=True, overlap_depth=4,
                  multi_step_decode=32, ondevice_finish=True,
                  decode_slot_batching=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload(n=6, seed=0):
    """Prompts of a few repeated random segments: the tiny model's greedy
    output falls into loops that prompt lookup drafts (about half the
    drafts accepted), with 10..47 output tokens each."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n):
        seg = rng.integers(2, 500, int(rng.integers(3, 7))).tolist()
        prompts.append(seg * int(rng.integers(2, 5))
                       + rng.integers(2, 500, int(rng.integers(0, 3))
                                      ).tolist())
    return prompts, [int(m) for m in rng.integers(10, 48, n)]


# ---- the functions, one at a time -----------------------------------------

@pytest.mark.parametrize("n,k,window", [(1, 4, 4096), (2, 4, 4096),
                                        (3, 2, 4096), (2, 5, 9)])
def test_propose_ngram_drafts_matches_jax(n, k, window):
    rng = np.random.default_rng(n * 10 + k)
    for _ in range(60):
        toks = rng.integers(0, 5, int(rng.integers(1, 40))).tolist()
        assert (tsched.propose_ngram_drafts(toks, n, k, window)
                == jsched.propose_ngram_drafts(toks, n, k, window))


def _ring(seqs, R):
    ring = np.full((len(seqs), R), -1, np.int32)
    rlen = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        tail = s[-R:]
        ring[i, R - len(tail):] = tail
        rlen[i] = len(tail)
    return ring, rlen


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_propose_matches_jax_and_the_host_proposer(n):
    """The on-device proposer over right-aligned rings equals JAX's, and
    the host proposer's drafts over the ring's tokens, -1 padded."""
    R, k = 16, 4
    rng = np.random.default_rng(n)
    seqs = [rng.integers(0, 4, int(rng.integers(1, 30))).tolist()
            for _ in range(24)]
    ring, rlen = _ring(seqs, R)
    got = tsamp.ngram_propose(torch.from_numpy(ring),
                              torch.from_numpy(rlen), n=n, k=k).numpy()
    want = np.asarray(jsamp.ngram_propose(jnp.asarray(ring),
                                          jnp.asarray(rlen), n=n, k=k))
    np.testing.assert_array_equal(got, want)
    for row, s in zip(got, seqs):
        host = tsched.propose_ngram_drafts(s[-R:], n, k)
        assert row.tolist() == list(host) + [-1] * (k - len(host))
    assert (got >= 0).any()


def test_ring_shift_in_matches_jax():
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 50, int(rng.integers(0, 14))).tolist()
            for _ in range(12)]
    ring, rlen = _ring(seqs, 8)
    toks = rng.integers(0, 50, (12, 5)).astype(np.int32)
    counts = rng.integers(0, 6, 12).astype(np.int32)
    counts[:2] = (0, 5)
    got = tsamp.ring_shift_in(*(torch.from_numpy(x) for x in
                                (ring, rlen, toks, counts)))
    want = jsamp.ring_shift_in(*(jnp.asarray(x) for x in
                                 (ring, rlen, toks, counts)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _np_spec_verify(logits, drafts, temp, top_k, top_p, min_p, u, gumbel):
    """JAX's rule (``gllm_tpu/ops/sampling.py:373``) in numpy, the mask by
    JAX's own ``_topk_topp_mask``, with the draws given."""
    S, K1, V = logits.shape
    K = K1 - 1
    greedy = logits.argmax(-1).astype(np.int32)
    ok_g = greedy[:, :-1] == drafts
    rep = lambda a: np.repeat(a, K1, axis=0)              # noqa: E731
    masked = np.asarray(jsamp._topk_topp_mask(
        jnp.asarray((logits / np.maximum(temp, 1e-6)[:, None, None])
                    .reshape(S * K1, V)),
        jnp.asarray(rep(top_k)), jnp.asarray(rep(top_p)),
        jnp.asarray(rep(min_p))), np.float64)
    e = np.exp(masked - masked.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True)).reshape(S, K1, V)
    tok = np.empty((S, K1), np.int32)
    ok = np.zeros((S, K), bool)
    for s in range(S):
        for i in range(K1):
            q = p[s, i].copy()
            if i < K and drafts[s, i] >= 0:
                ok[s, i] = u[s, i] < q[drafts[s, i]]
                q[drafts[s, i]] = 0.0
            with np.errstate(divide="ignore"):
                logq = np.where(q > 0, np.log(np.maximum(q, 1e-30)), -np.inf)
            corr = int(np.argmax(logq + gumbel[s, i]))
            tok[s, i] = drafts[s, i] if i < K and ok[s, i] else corr
    greedy_rows = temp == 0.0
    ok = np.where(greedy_rows[:, None], ok_g, ok)
    accept = np.cumprod(ok.astype(np.int32), axis=-1).sum(-1)
    return np.where(greedy_rows[:, None], greedy, tok), accept


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_spec_verify_matches_jax_rule(mode):
    """Greedy: the argmax-prefix rule, exactly JAX's (with and without the
    sampled path). Sampled rows beside greedy ones, with temperature,
    top-k, top-p and min-p, and the uniforms and Gumbel noise fixed:
    the accepted runs and tokens of a numpy rendering of JAX's rule."""
    S, K, V = 8, 4, 40
    rng = np.random.default_rng(11)
    logits = (2.0 * rng.standard_normal((S, K + 1, V))).astype(np.float32)
    drafts = logits[:, :K].argmax(-1).astype(np.int32)
    # break some runs, pad some rows
    drafts[1, 2] = (drafts[1, 2] + 1) % V
    drafts[3, 0] = (drafts[3, 0] + 5) % V
    drafts[5, 2:] = -1
    drafts[6, :] = -1
    if mode == "greedy":
        temp = np.zeros(S, np.float32)
    else:
        temp = np.array([0, 0.7, 1.3, 0, 1.0, 0.9, 1.0, 2.0], np.float32)
        # a sampled row's draft that its distribution rarely picks
        drafts[2, 1] = logits[2, 1].argmin()
    top_k = np.array([-1, 5, -1, -1, 3, -1, 10, -1], np.int32)
    top_p = np.array([1, 1, 0.9, 1, 1, 0.8, 1, 1], np.float32)
    min_p = np.array([0, 0, 0, 0, 0.05, 0, 0, 0.1], np.float32)
    u = rng.random((S, K + 1)).astype(np.float32)
    gumbel = (-np.log(rng.exponential(size=(S, K + 1, V)))
              ).astype(np.float32)
    md = tsamp.SamplingMetadata(*(torch.from_numpy(x) for x in
                                  (temp, top_p, top_k, min_p)))
    args = (torch.from_numpy(logits), torch.from_numpy(drafts), md)
    want_tok, want_acc = _np_spec_verify(logits, drafts, temp, top_k, top_p,
                                         min_p, u, gumbel)
    tok, acc = tsamp.spec_verify(*args, draws=(torch.from_numpy(u),
                                               torch.from_numpy(gumbel)))
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    if mode == "greedy":
        jmd = jsamp.SamplingMetadata(
            *(jnp.asarray(x) for x in (temp, top_p, top_k)),
            repetition_penalty=jnp.ones(S), step_key=jax.random.key(0),
            min_p=jnp.asarray(min_p))
        jtok, jacc = jsamp.spec_verify(jnp.asarray(logits),
                                       jnp.asarray(drafts), jmd,
                                       sampled=False)
        gtok, gacc = tsamp.spec_verify(*args, sampled=False)
        for got in ((gtok, gacc), (tok, acc)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(jtok))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(jacc))
        assert 0 < int(acc.sum()) and int(acc.min()) == 0
    else:
        assert 0 < int(acc[temp > 0].sum()) < 4 * int((temp > 0).sum())


def _fake_chain(pkg, seqs, cbs, spec=True):
    """A spec chain of ``pkg``'s (JAX's or the port's) scheduler classes:
    one link per entry of ``cbs`` ([link][row] computed_before)."""
    SS, SB = pkg.ScheduledSeq, pkg.ScheduledBatch
    return [SB([SS(seq, 1, cb) for seq, cb in zip(seqs, row)],
               spec_block=spec) for row in cbs]


def test_trim_overpromise_matches_jax():
    """Three spec entries in flight (the oldest two chained, one invalid)
    and a plain one: both FutureMaps trim the same tokens off the same
    links."""
    got = []
    for pkg, Inf, FM, Seq in ((jsched, JInFlight, JFutureMap, JSeq),
                              (tsched, InFlight, FutureMap, Sequence)):
        seqs = [Seq(i, [1, 2, 3]) for i in range(3)]
        e1 = _fake_chain(pkg, seqs, [[20, 30, 40], [25, 35, 45]])
        e2 = _fake_chain(pkg, seqs, [[34, 44, 54], [39, 49, 59]])
        e3 = _fake_chain(pkg, seqs, [[50, 60, 70]])
        e4 = _fake_chain(pkg, seqs, [[60, 70, 80]], spec=False)
        extra = (0.0, None if Inf is JInFlight else {})
        flight = [Inf(e1, None, *extra, chained=True),
                  Inf(e2, None, *extra, chained=True),
                  Inf(e3, None, *extra, chained=True, invalid=True),
                  Inf(e4, None, *extra, chained=True)]
        n = FM.trim_overpromise(flight, {0: 17, 1: 30, 2: 41})
        got.append((n, [[[it.computed_before for it in b.items] for b in e]
                        for e in (e1, e2, e3, e4)]))
    assert got[0] == got[1]
    assert got[1][0] == 3 + 0 + 0


def test_aimd_collapse_and_regrowth():
    """A drafted row's draft length on both packages' schedulers: a clean
    sweep adds one (capped at spec_k), a rejection collapses it to the
    accepted run (at least 1)."""
    seen = []
    for pkg, Seq, SP, mm in (
            (jsched, JSeq, JSP, j_make_mm),
            (tsched, Sequence, gt.SamplingParams, make_memory_manager)):
        cfg = (JEC if pkg is jsched else gt.EngineConfig)(
            max_model_len=256, spec_decode="ngram")
        sched = pkg.Scheduler(cfg, mm(64, 16, False))
        sched.spec_cfg = (2, 4)
        seq = Seq(0, list(range(1, 9)), SP(max_tokens=100, ignore_eos=True))
        seq.status = seq.status.__class__.RUNNING
        sched.running.append(seq)
        trace = []
        for drafts, accepted in ((4, 4), (4, 1), (1, 1), (2, 2), (3, 0),
                                 (1, 1), (2, 2), (3, 3), (4, 4), (4, 4)):
            cb = seq.num_tokens - 1
            it = pkg.ScheduledSeq(seq, 1, cb,
                                  draft_tokens=tuple(range(drafts)))
            seq.num_in_flight += 1
            sched.process_output_multi(pkg.ScheduledBatch([it]),
                                       [[7] * (accepted + 1)], None)
            trace.append(getattr(seq, "spec_k_cur", None))
        seen.append((trace, dict(sched.spec_stats),
                     seq.num_computed_tokens))
    assert seen[0] == seen[1]
    assert seen[1][0] == [4, 1, 2, 3, 1, 2, 3, 4, 4, 4]


# ---- engines against the JAX LLM ------------------------------------------

def _watch(llm):
    """What ``llm`` dispatches, in order: ("one", rows), ("verify", rows),
    ("block", K, rows), ("spec", K, rows)."""
    runner, seen = llm.runner, []
    one, multi, spec = (runner.step_async, runner.step_multi,
                        runner.step_spec_multi)

    def watch_one(batch, *a, **kw):
        seen.append(("verify" if batch.has_drafts else "one",
                     batch.num_seqs))
        return one(batch, *a, **kw)

    def watch_multi(chain, *a, **kw):
        seen.append(("block", len(chain), chain[0].num_seqs))
        return multi(chain, *a, **kw)

    def watch_spec(chain, *a, **kw):
        seen.append(("spec", len(chain), chain[0].num_seqs))
        return spec(chain, *a, **kw)
    runner.step_async = watch_one
    runner.step_multi = watch_multi
    runner.step_spec_multi = watch_spec
    return seen


def _spec_kinds(mod):
    return {k: mod._M_SPEC_FUSED.get(kind=k)
            for k in ("accepted", "rejected", "correction")}


def _run(llm, prompts, sps, arrive_after=None):
    """Generate (requests after the first three arrive ``arrive_after``
    steps in, when given); returns the streams, chain breaks by reason and
    the spec token counter's increments by kind."""
    jax_side = isinstance(llm, JLLM)
    SP = JSP if jax_side else gt.SamplingParams
    mod = jllm_mod if jax_side else tllm_mod
    before = _spec_kinds(mod)
    mark = TRACE.mark()
    breaks0 = collections.Counter(getattr(llm, "chain_breaks", {}))
    seqs = [llm._allocate_seq(list(p), SP(**sp))
            for p, sp in zip(prompts, sps)]
    first = seqs if arrive_after is None else seqs[:3]
    for s in first:
        llm.add_seq(s)
    steps = 0
    while llm.has_unfinished or (arrive_after is not None
                                 and steps <= arrive_after):
        if arrive_after is not None and steps == arrive_after:
            for s in seqs[3:]:
                llm.add_seq(s)
        llm.step()
        steps += 1
    if jax_side:
        breaks = collections.Counter(
            e["reason"] for e in TRACE.events(since=mark)
            if e["kind"] == "chain_break")
    else:
        breaks = collections.Counter(llm.chain_breaks) - breaks0
        _check_drained(llm)
    spec_tokens = {k: v - before[k] for k, v in _spec_kinds(mod).items()}
    streams = [(s.output_token_ids, s.finish_reason) for s in seqs]
    k_cur = [getattr(s, "spec_k_cur", None) for s in seqs]
    return streams, dict(breaks), spec_tokens, k_cur


@functools.lru_cache(maxsize=None)
def _jax_engine(make, flags: str, kw: tuple):
    """One JAX engine per (family, flag set, options), shared by the tests
    that run workloads through it: its compiled programs are what a run
    costs on the CPU."""
    return make(True, **dict(kw), **FLAGS[flags])


def _against_jax(make, flags, workloads, **kw):
    """The port's engine and the JAX one under ``FLAGS[flags]``, through
    ``workloads`` ((prompts, sampling params, arrive_after) each) in
    turn: streams, dispatches in order, chain breaks, spec tokens by
    kind, draft lengths, drafts proposed and accepted and preemptions
    equal run by run. Returns the port's engine, its streams and
    dispatches."""
    port = make(False, **kw, **FLAGS[flags])
    jax_llm = _jax_engine(make, flags, tuple(sorted(kw.items())))
    seen, jseen = _watch(port), _watch(jax_llm)
    streams = []
    for prompts, sps, arrive_after in workloads:
        n0, j0 = len(seen), len(jseen)
        stats = [(dict(x.scheduler.spec_stats), x.scheduler.num_preemptions)
                 for x in (port, jax_llm)]
        got = _run(port, prompts, sps, arrive_after)
        want = _run(jax_llm, prompts, sps, arrive_after)
        assert got[0] == want[0]                  # streams
        assert seen[n0:] == jseen[j0:]            # dispatches, in order
        assert got[1:] == want[1:]                # breaks, kinds, k_cur
        after = [(dict(x.scheduler.spec_stats), x.scheduler.num_preemptions)
                 for x in (port, jax_llm)]
        deltas = [({k: a[0][k] - b[0][k] for k in a[0]}, a[1] - b[1])
                  for a, b in zip(after, stats)]
        assert deltas[0] == deltas[1]
        streams.append(got[0])
    blocks = collections.Counter(s[1] for s in seen if s[0] == "spec")
    assert dict(port.blocks) == dict(blocks)
    if port.spec_fused:
        assert sum(port.spec_tokens.values()) > 0
    assert port.verify_steps == sum(s[0] == "verify" for s in seen)
    return port, streams, seen


@functools.lru_cache(maxsize=None)
def _ds_params():
    jmc, tmc = test_torch_mla._configs(dict(test_torch_mla.V2,
                                            vocab_size=512))
    params = jds.init_params(jmc, seed=3, dtype=jnp.float32)
    return jmc, tmc, params, convert.from_jax_params(
        jax.tree.map(np.asarray, params))


def _ds_engine(jax_side, *, num_pages=256, **flags):
    """A two-layer DeepSeek (one dense, one MoE layer) on both packages,
    on the same float32 weights: 4-token pages, 8 sequences a batch."""
    jmc, tmc, jparams, tparams = _ds_params()
    kw = dict(dtype="float32", max_model_len=128, max_num_seqs=8)
    if jax_side:
        return JLLM(config=JEC(
            attention_impl="xla", **kw,
            scheduler=JSC(max_prefill_tokens=32, max_decode_seqs=8),
            cache=JCC(page_size=4, num_pages=num_pages), **flags),
            model_cfg=jmc, params=jparams)
    return gt.LLM(config=gt.EngineConfig(
        **kw, scheduler=gt.SchedulerConfig(max_prefill_tokens=32,
                                           max_decode_seqs=8),
        cache=gt.CacheConfig(page_size=4, num_pages=num_pages), **flags),
        model_cfg=tmc, params=tparams, device="cpu")


def _greedy(max_tokens, ignore_eos=True):
    return [dict(temperature=0.0, max_tokens=m, ignore_eos=ignore_eos)
            for m in max_tokens]


@pytest.fixture(scope="module")
def eos_in_run():
    """A token the greedy model emits inside a run a verify step
    accepts: request 2's loop (its first occurrence past output 3)."""
    prompts, maxs = _workload()
    port = _engine(False, **SPEC)
    streams = _run(port, prompts, _greedy(maxs))[0]
    toks = streams[2][0]
    return next(t for j, t in enumerate(toks) if j >= 3 and t in toks[:j]
                and t not in toks[:3])


def _churn():
    """Eight requests, three first and five arriving four steps in; the
    first finishes early, so its slot is a hole the arrivals can join."""
    prompts, maxs = _workload(n=8, seed=3)
    return prompts, _greedy([6, 40, 44] + maxs[3:]), 4


def _counting_drafts(kept, jax_side, **kw):
    """``_engine``, whose port side records the drafts each dispatched
    step carries."""
    llm = _engine(jax_side, **kw)
    if not jax_side:
        one = llm.runner.step_async
        llm.runner.step_async = lambda b, *a, **k: (
            kept.append(sum(len(it.draft_tokens) for it in b.items)),
            one(b, *a, **k))[1]
    return llm


@pytest.mark.parametrize("flags", ["host", "host_overlap", "fused",
                                   "bench"])
def test_dense_identical_to_jax(flags, eos_in_run):
    """The workload of repeated segments with an EOS id the model emits
    inside accepted runs, length caps of 10..47 and one request whose
    drafts run into ``max_model_len``: under "host" over a 40-page pool
    (memory pressure: drafts are dropped, never preempted for), twice
    under "fused" with the prefix cache on (cold, then warm); then, under
    bench's flags, arrival churn."""
    prompts, maxs = _workload()
    # a repeated segment: its drafts run into max_model_len (128)
    prompts.append(([5, 9, 13, 7, 11] * 24)[:118])
    sps = _greedy(maxs, ignore_eos=False) + _greedy([12])
    runs = [(prompts, sps, None)] * (2 if flags == "fused" else 1)
    if flags == "bench":
        runs.append(_churn())
    kw = dict(eos=(eos_in_run,), prefix=flags == "fused")
    kept = []
    if flags == "host":
        # a 40-page pool: memory pressure
        kw["num_pages"] = 40
        make = functools.partial(_counting_drafts, kept)
    else:
        make = _engine
    port, got, seen = _against_jax(make, flags, runs, **kw)
    assert any(r == "stop" for _, r in got[0])
    assert got[0][-1][1] == "length" and len(got[0][-1][0]) == 128 - 118
    assert port.scheduler.spec_stats["accepted"] > 0
    if flags == "host_overlap":
        # speculation owns decode dispatch: every chain refuses
        assert port.chain_breaks["spec"] > 0 and not port.blocks
    elif flags in ("fused", "bench"):
        assert not any(s[0] == "verify" for s in seen)
        assert "spec" not in port.chain_breaks
    if flags == "fused":
        assert port.memory_manager.hit_tokens > 0
    if flags == "host":
        # drafts that did not fit were dropped, and speculation preempted
        # nothing the plain engine does not
        assert port.scheduler.spec_stats["proposed"] > sum(kept) > 0
        plain = _engine(False, **kw)
        assert _run(plain, prompts, sps)[0] == got[0]
        assert (port.scheduler.num_preemptions
                <= plain.scheduler.num_preemptions)


@pytest.mark.parametrize("flags", ["host", "bench"])
def test_deepseek_identical_to_jax(flags):
    prompts, maxs = _workload(seed=0)
    _against_jax(_ds_engine, flags,
                 [(prompts[1:3], _greedy([min(m, 16) for m in maxs[1:3]]),
                   None)])


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_one_byte_caches_and_churn_identical_to_jax(kv):
    """Under the slot flags over a one-byte cache: the workload, then
    (int8) arrival churn, whose arrivals join the spec chain's holes."""
    prompts, maxs = _workload(seed=1)
    runs = [(prompts, _greedy(maxs), None)]
    if kv == "int8":
        runs.append(_churn())
    port, _, _ = _against_jax(_engine, "fused_slots", runs, kv=kv)
    assert (port.joins > 0) == (kv == "int8")


def _commits(llm):
    """Record each commit of several tokens: (sequence, output index of
    its first token, its tokens)."""
    seen = []
    commit = llm.scheduler.process_output_multi

    def record(batch, lists, eos):
        for it, toks in zip(batch.items, lists):
            if len(toks) > 1:
                seen.append((it.seq.seq_id, it.seq.num_output_tokens,
                             list(toks)))
        return commit(batch, lists, eos)
    llm.scheduler.process_output_multi = record
    return seen


def test_stop_strings_identical_to_jax():
    """Stop strings under host-driven speculation: one character first
    met in the middle of a commit of several tokens (the tokens after it
    are cut), one spanning two tokens, one that never occurs, and two
    more from the greedy texts. Text, tokens and usage equal JAX's; a row
    with stop strings drafts at most 2."""
    prompts = _workload(6, seed=0)[0]
    spec_free = _tok_engines(False, eos=(), **SPEC)
    commits = _commits(spec_free)
    free = _stop_run(spec_free, gt.SamplingParams, prompts, [()] * 6)
    r, j = next((sid, first + i) for sid, first, toks in commits
                for i in range(1, len(toks))
                if sid not in (1, 2)
                and free[sid][1][first + i] not in free[sid][1][:first + i])
    stops = [(free[0][1][5],), (free[1][1][7:9],), ("@@never@@",), (),
             (free[4][1][3:5], "zz"), ()]
    stops[r] = (free[r][1][j],)
    port = _tok_engines(False, eos=(), **SPEC)
    widest = []
    commit = port.scheduler.process_output_multi
    port.scheduler.process_output_multi = lambda b, lists, eos: (
        widest.extend(len(t) for it, t in zip(b.items, lists)
                      if it.seq.sampling_params.stop),
        commit(b, lists, eos))[1]
    got = _stop_run(port, gt.SamplingParams, prompts, stops)
    want = _stop_run(_tok_engines(True, eos=(), **SPEC), JSP, prompts,
                     stops)
    assert got == want
    assert got[r][2] == "stop" and len(got[r][0]) == j + 1
    assert [x for _, _, x in got].count("stop") >= 3
    for (ids, text, reason), s, (fids, ftext, _) in zip(got, stops, free):
        assert fids[:len(ids)] == ids and ftext.startswith(text)
        if reason == "stop":
            assert not any(x in text for x in s)
    assert 1 < max(widest) <= 3


def test_sampled_rows_beside_greedy_ones(eos_in_run):
    """Sampled rows in batches with greedy ones under fused speculation:
    the greedy rows equal JAX's and two runs with the same seed are
    equal. Then the distribution: 384 sampled requests (48 batches of 8)
    of request 2's prompt followed by the greedy loop it falls into
    (temperature 1, top-k 3, n-gram 1, so that prompt lookup drafts the
    loop), whose second output token comes from a verify sub-step,
    against the plain port engine's second token: the total-variation
    distance of the two histograms stays under 0.15 (fixed seeds: the
    test is deterministic; the two differ by about 0.08 here, sampling
    noise at 384 draws)."""
    prompts, _ = _workload(n=6, seed=0)
    greedy = dict(temperature=0.0, max_tokens=20, ignore_eos=True)
    sampled = dict(temperature=0.8, top_k=20, max_tokens=20,
                   ignore_eos=True)
    sps = [greedy if i % 2 == 0 else sampled for i in range(6)]
    # the JAX engine of test_dense_identical_to_jax[fused]
    kw = dict(eos=(eos_in_run,), prefix=True)
    spec_a, spec_b = (_run(_engine(False, **kw, **FLAGS["fused"]), prompts,
                           sps)[0] for _ in range(2))
    assert spec_a == spec_b
    want = _run(_jax_engine(_engine, "fused", tuple(sorted(kw.items()))),
                prompts, sps)[0]
    assert spec_a[::2] == want[::2]
    loop = _run(_engine(False), prompts[2:3], [greedy])[0][0][0]
    prompt = prompts[2] + loop
    dist = dict(temperature=1.0, top_k=3, max_tokens=3, ignore_eos=True)
    hist = {}
    for name, flags in (("spec", dict(FLAGS["fused"], spec_ngram=1)),
                        ("plain", {})):
        llm = _engine(False, max_prefill=320, **flags)
        llm.runner.generator.manual_seed(7)
        hist[name] = collections.Counter()
        for _ in range(48):
            out = _run(llm, [prompt] * 8, [dist] * 8)[0]
            hist[name].update(toks[1] for toks, _ in out)
        if name == "spec":
            # the verify accepted some sampled drafts and rejected others
            stats = dict(llm.spec_tokens)
            assert stats["accepted"] > 0 and stats["rejected"] > 0
    tv = 0.5 * sum(abs(hist["spec"][t] - hist["plain"][t])
                   for t in set(hist["spec"]) | set(hist["plain"])) / 384
    assert tv < 0.15, tv


@pytest.mark.parametrize("kw", [
    dict(spec_decode="ngram"),
    dict(spec_decode="ngram", spec_fused=True),
    dict(spec_decode="ngram", spec_fused=True, decode_chain_len=4),
    dict(spec_decode="ngram", spec_fused=True, ondevice_finish=True),
    dict(spec_decode="ngram", spec_fused=True, enforce_eager=True),
    dict(spec_decode="ngram", spec_fused=True, unified_step=True),
    dict(spec_fused=True),
    dict(spec_decode="medusa"),
    dict(spec_decode="ngram", spec_k=0),
    dict(spec_decode="ngram", spec_ngram=0),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_normalized_as_jax(kw):
    fields = ("overlap_scheduling", "multi_step_decode", "spec_fused",
              "pipelined_loop", "spec_k", "spec_ngram", "ondevice_finish")
    out = []
    for cls in (JEC, gt.EngineConfig):
        cfg = cls(**kw)
        try:
            cfg.validate()
        except ValueError:
            out.append("ValueError")
            continue
        out.append({f: getattr(cfg, f) for f in fields})
    assert out[0] == out[1]


@pytest.mark.parametrize("kw", [dict(spec_decode="ngram"),
                                dict(spec_decode="ngram", spec_fused=True)])
def test_hybrid_model_refuses_speculation(kw):
    import test_torch_gdn
    _, tmc = test_torch_gdn._configs(test_torch_gdn.HF)
    with pytest.raises(NotImplementedError, match="A 9"):
        gt.LLM(config=gt.EngineConfig(dtype="float32", **kw),
               model_cfg=tmc, device="cpu")


def test_step_failure_inside_a_fused_chain_unwinds():
    """The third spec block dispatched raises: the quarantine drops the
    sequences of every entry in flight and of the failed launch, every
    page comes back and the engine serves the next requests."""
    prompts, maxs = _workload(seed=0)
    llm = _engine(False, **FLAGS["bench"])
    spec, calls = llm.runner.step_spec_multi, [0]

    def failing(chain, *a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("injected spec block failure")
        return spec(chain, *a, **kw)
    llm.runner.step_spec_multi = failing
    for p, m in zip(prompts, maxs):
        llm.add_seq(llm._allocate_seq(list(p), gt.SamplingParams(
            temperature=0.0, max_tokens=m, ignore_eos=True)))
    with pytest.raises(RuntimeError, match="injected"):
        while llm.has_unfinished:
            llm.step()
    dropped = llm.quarantine_step_failure()
    assert dropped
    while llm.has_unfinished:
        llm.step()
    _check_drained(llm)
    llm.runner.step_spec_multi = spec
    got = _run(llm, prompts[:2], _greedy(maxs[:2]))[0]
    assert got == _run(_engine(False), prompts[:2], _greedy(maxs[:2]))[0]
