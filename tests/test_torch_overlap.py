"""Overlap scheduling and the pipelined loop in the PyTorch port, on the
CPU at float32: with ``overlap_scheduling`` (decode steps chained off the
previous step's tokens on the device) and with ``pipelined_loop``
(re-forms across chain breaks, reconciled when tokens land), greedy
streams are identical to the JAX ``LLM`` with the same flags and to the
port's own sync loop, with the same rebuild, divergence and preemption
counts, no page leak and no entry left in flight (the cases of
tests/test_overlap_scheduling.py and tests/test_pipelined_loop.py); a
DeepSeek and a hybrid model against the port's sync loop (the hybrid
chains and never re-forms); the FutureMap's cascade; the pinned ring of
``HostStaging``; and the option rules shared with the JAX package."""

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
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.engine.pipeline import FutureMap, InFlight
from gllm_tpu_torch.models import convert
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging
from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq
from gllm_tpu_torch.sequence import Sequence

import test_torch_gdn
import test_torch_mla

# the dummy-weight model of tests/test_pipelined_loop.py
MODEL = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=64,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             intermediate_size=128, max_position=256)
FLAGS = {"overlap": dict(overlap_scheduling=True),
         "pipelined": dict(pipelined_loop=True),
         # the ramp: two decode steps chained under prefill pressure
         # before a pass yields
         "ramp": dict(pipelined_loop=True, chain_under_prefill=2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny models: one torch thread, so that parallel test workers do not
    oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    params = jdense.init_params(JMC(**MODEL), seed=3, dtype=jnp.float32)
    return params, convert.from_jax_params(jax.tree.map(np.asarray, params))


def _engine(jax_side, *, num_pages=256, max_model_len=128, max_prefill=32,
            eos=(), kv="auto", max_seqs=8, prefix=False, **flags):
    """The JAX LLM or the port's on the same float32 weights, ``max_seqs``
    sequences a batch, 4-token pages, a ``kv`` cache dtype, the prefix
    cache on with ``prefix``."""
    jparams, tparams = _params()
    if jax_side:
        llm = JLLM(config=JEC(
            dtype="float32", attention_impl="xla",
            max_model_len=max_model_len, max_num_seqs=max_seqs,
            scheduler=JSC(max_prefill_tokens=max_prefill,
                          max_decode_seqs=max_seqs),
            cache=JCC(page_size=4, num_pages=num_pages,
                      kv_cache_dtype=kv, enable_prefix_caching=prefix),
            **flags),
            model_cfg=JMC(**MODEL), params=jparams)
    else:
        llm = gt.LLM(config=gt.EngineConfig(
            dtype="float32", max_model_len=max_model_len,
            max_num_seqs=max_seqs,
            scheduler=gt.SchedulerConfig(max_prefill_tokens=max_prefill,
                                         max_decode_seqs=max_seqs),
            cache=gt.CacheConfig(page_size=4, num_pages=num_pages,
                                 kv_cache_dtype=kv,
                                 enable_prefix_caching=prefix), **flags),
            model_cfg=gt.ModelConfig(**MODEL), params=tparams, device="cpu")
    if eos:
        llm.eos_token_ids = frozenset(eos)
    return llm


def _check_drained(llm):
    mm = llm.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total
    assert not llm._in_flight
    if mm.use_ssm:
        assert mm.ssm_alloc.num_free == mm.ssm_alloc.num_total


def _counts(llm):
    return (llm.futures.rebuilds, llm.futures.divergences,
            llm.scheduler.num_preemptions)


def _generate(llm, prompts, sp):
    SP = JSP if isinstance(llm, JLLM) else gt.SamplingParams
    sps = [SP(**sp) for _ in prompts] if isinstance(sp, dict) else [
        SP(**x) for x in sp]
    outs = llm.generate(prompt_token_ids=[list(p) for p in prompts],
                        sampling_params=sps)
    _check_drained(llm)
    return [(o.output_token_ids, o.finish_reason) for o in outs]


def _count_dispatches(llm):
    """Wrap the runner's dispatch (chained steps go through it too) to
    count the steps dispatched, by the number of rows of each."""
    runner, seen = llm.runner, []
    step_async = runner.step_async

    def counting(batch, *prev, **kw):
        seen.append(batch.num_seqs)
        return step_async(batch, *prev, **kw)
    runner.step_async = counting
    return seen


def _against_jax(prompts, sp, flags, **kw):
    """The port's streams and counts under ``flags`` equal the JAX LLM's
    under the same flags and the port's sync loop's, and so do the steps
    it dispatched, row count by row count; returns the port's engine."""
    port = _engine(False, **kw, **FLAGS[flags])
    dispatched = _count_dispatches(port)
    got = _generate(port, prompts, sp)
    jllm = _engine(True, **kw, **FLAGS[flags])
    jax_dispatched = _count_dispatches(jllm)
    assert got == _generate(jllm, prompts, sp)
    assert got == _generate(_engine(False, **kw), prompts, sp)
    assert _counts(port) == _counts(jllm)
    assert dispatched == jax_dispatched
    return port, got


def _common_token(prompts, max_tokens, **kw):
    """The most common greedy token of the sync loop's streams: an EOS id
    the model really emits, so that sequences finish mid-stream."""
    outs = _generate(_engine(False, **kw), prompts,
                     dict(temperature=0.0, max_tokens=max_tokens,
                          ignore_eos=True))
    toks = [t for o, _ in outs for t in o]
    return max(set(toks), key=toks.count)


# the cases of tests/test_overlap_scheduling.py:37-65 (that file's engine:
# 64-token prefill budget, 128 pages)
OVERLAP_CASES = {
    "long_decode": ([[3, 14, 15], [9, 2, 6, 5, 3], [58, 9]],
                    dict(temperature=0.0, max_tokens=20, ignore_eos=True)),
    "eos_midchain": ([[i, i + 1, i + 2] for i in range(1, 12, 2)],
                     dict(temperature=0.0, max_tokens=30)),
    "max_tokens_1": ([[5, 6], [7, 8, 9]],
                     dict(temperature=0.0, max_tokens=1, ignore_eos=True)),
    "page_boundary": ([[3] * 7],
                      dict(temperature=0.0, max_tokens=13, ignore_eos=True)),
}


@pytest.mark.parametrize("flags", ["overlap", "pipelined"])
@pytest.mark.parametrize("case", list(OVERLAP_CASES))
def test_overlap_greedy_identical_to_jax_and_sync(case, flags):
    prompts, sp = OVERLAP_CASES[case]
    kw = dict(num_pages=128, max_prefill=64)
    if case == "eos_midchain":
        kw["eos"] = [_common_token(prompts, 30, **kw)]
    port, got = _against_jax(prompts, sp, flags, **kw)
    if case == "eos_midchain":
        assert any(r == "stop" for _, r in got)
    if case != "max_tokens_1":
        # steps really ran ahead: decode entries dispatched with another
        # in flight
        assert sum(n for (kind, depth), n in port.dispatches.items()
                   if kind == "decode" and depth >= 2) > 0


@pytest.mark.parametrize("flags", ["overlap", "pipelined"])
def test_single_sequence_eos_midchain_frees_every_page(flags):
    """One sequence finishing by EOS while its chained step is in flight
    (tests/test_overlap_scheduling.py:69): the chain drains and every page
    comes back, in the JAX engine and the port alike."""
    probe = _generate(_engine(False), [[5, 6, 7]],
                      dict(temperature=0.0, max_tokens=8, ignore_eos=True))
    eos = probe[0][0][2]
    port, got = _against_jax([[5, 6, 7]], dict(temperature=0.0,
                                                max_tokens=30),
                             flags, eos=[eos])
    assert got[0][1] == "stop"


def _staggered(seed, n=6, vocab=500):
    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(2, vocab, size=int(m))]
               for m in rng.integers(3, 14, size=n)]
    sps = [dict(temperature=0.0, max_tokens=int(m), ignore_eos=True)
           for m in rng.integers(4, 24, size=n)]
    return prompts, sps


def test_pipelined_staggered_lengths_never_rebuild():
    """Staggered max_tokens (tests/test_pipelined_loop.py:71): every finish
    breaks the chain and the re-form commits the sync loop's tokens;
    deaths by length are known when promised, so nothing is rebuilt."""
    prompts, sps = _staggered(3)
    port, _ = _against_jax(prompts, sps, "pipelined")
    assert port.futures.rebuilds == 0
    assert port.chain_breaks["finish"] > 0


def test_pipelined_eos_rebuilds_as_jax_does():
    """EOS the host cannot predict (tests/test_pipelined_loop.py:82):
    invalidated entries are rebuilt and the streams stay the sync loop's,
    with the JAX engine's rebuild and divergence counts."""
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(2, 60, size=int(m))]
               for m in rng.integers(3, 12, size=6)]
    eos = _common_token(prompts, 40)
    port, got = _against_jax(prompts, dict(temperature=0.0, max_tokens=40),
                             "pipelined", eos=[eos])
    assert any(r == "stop" for _, r in got)
    assert port.futures.rebuilds > 0


def _churn(llm, SP):
    """Staggered arrivals with step() driven by hand
    (tests/test_pipelined_loop.py:129): chain yields, admissions and, in
    a small pool, preemptions while entries are in flight."""
    rng = np.random.default_rng(11)
    seqs, nseq, it = [], 0, 0
    arrivals = {0: 3, 2: 2, 5: 2, 9: 1}
    while nseq < 8 or llm.has_unfinished:
        for _ in range(arrivals.get(it, 0)):
            ids = [int(x) for x in
                   rng.integers(2, 250, size=int(rng.integers(3, 20)))]
            seq = llm._allocate_seq(ids, SP(
                temperature=0.0, max_tokens=int(rng.integers(4, 24))))
            seqs.append(seq)
            llm.add_seq(seq)
            nseq += 1
        llm.step()
        it += 1
        assert it < 2000, "engine stopped making progress"
    _check_drained(llm)
    return [(s.token_ids[:], s.finish_reason) for s in seqs]


@pytest.mark.parametrize("num_pages,flags", [
    (256, "ramp"), (24, "pipelined"), (24, "overlap")])
def test_churn_identical_to_jax_and_sync(num_pages, flags):
    kw = dict(num_pages=num_pages, max_model_len=64, eos=[7])
    port = _engine(False, **kw, **FLAGS[flags])
    dispatched = _count_dispatches(port)
    got = _churn(port, gt.SamplingParams)
    jllm = _engine(True, **kw, **FLAGS[flags])
    jax_dispatched = _count_dispatches(jllm)
    assert got == _churn(jllm, JSP)
    assert got == _churn(_engine(False, **kw), gt.SamplingParams)
    assert _counts(port) == _counts(jllm)
    assert dispatched == jax_dispatched
    if num_pages == 24:
        assert port.scheduler.num_preemptions > 0


def test_reconciliation_rebuilds_exactly_the_speculated_step():
    """Seq A stops at its output index 1, seq B at 2
    (tests/test_pipelined_loop.py:172): A's finish breaks the chain, the
    engine re-forms [B] off promised counts, and B's finish invalidates
    exactly that entry, which is discarded; the streams are the sync
    loop's and JAX's. A third sequence riding in the re-formed batch
    (tests/test_pipelined_loop.py:216) is rebuilt from committed state."""
    pa, pb, pc = [5, 17, 93], [9, 41, 3, 77], [22, 8, 51]
    probe = _generate(_engine(False), [pa, pb],
                      dict(temperature=0.0, max_tokens=8, ignore_eos=True))
    ca, cb = probe[0][0], probe[1][0]
    assert ca[0] != ca[1] and cb[2] not in (cb[0], cb[1])
    sps = [dict(temperature=0.0, max_tokens=20, stop_token_ids=[ca[1]]),
           dict(temperature=0.0, max_tokens=20, stop_token_ids=[cb[2]])]
    llm = _engine(False, **FLAGS["pipelined"])
    discarded = []
    discard = llm.scheduler.discard_batch
    llm.scheduler.discard_batch = lambda b: (discarded.append(b),
                                             discard(b))[1]
    got = _generate(llm, [pa, pb], sps)
    assert got == _generate(_engine(False), [pa, pb], sps)
    assert (llm.futures.divergences, llm.futures.rebuilds) == (1, 1)
    assert len(discarded) == 1 and discarded[0].src_rows is not None
    assert [it.seq.prompt_len for it in discarded[0].items] == [len(pb)]
    assert llm.stalls["rebuild"] == 1
    sps.append(dict(temperature=0.0, max_tokens=16, ignore_eos=True))
    _against_jax([pa, pb, pc], sps, "pipelined")


def _mla(**flags):
    _, tmc = test_torch_mla._configs(dict(test_torch_mla.V2,
                                          vocab_size=512))
    return gt.LLM(config=gt.EngineConfig(
        dtype="float32", max_model_len=128,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=16),
        cache=gt.CacheConfig(page_size=4, num_pages=30), **flags),
        model_cfg=tmc, device="cpu")


def _hybrid(**flags):
    _, tmc = test_torch_gdn._configs(dict(test_torch_gdn.HF,
                                          vocab_size=512))
    return gt.LLM(config=gt.EngineConfig(
        dtype="float32", max_model_len=128, max_num_seqs=16,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=16),
        cache=gt.CacheConfig(page_size=4, num_pages=30), **flags),
        model_cfg=tmc, device="cpu")


@pytest.mark.parametrize("flags", ["overlap", "pipelined"])
@pytest.mark.parametrize("make", [_mla, _hybrid], ids=["mla", "hybrid"])
def test_mla_and_hybrid_identical_to_sync(make, flags):
    """Ten requests of staggered lengths, six arriving mid-run, over a
    30-page pool that preempts: DeepSeek's and the hybrid model's streams
    under overlap (and the pipelined loop) equal the sync loop's on the
    same dummy weights. The hybrid model chains and never re-forms."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, int(n)).tolist()
               for n in rng.integers(2, 9, 10)]
    max_tokens = [int(m) for m in rng.integers(6, 26, 10)]
    keep = [True] * 10
    from test_torch_engine import _drive
    llm = make(**FLAGS[flags])
    reforms = []
    reform = llm.scheduler.schedule_reform
    llm.scheduler.schedule_reform = lambda b, **kw: (
        reforms.append(b), reform(b, **kw))[1]
    got = _drive(llm, gt.SamplingParams, prompts, max_tokens, keep, 2)
    sync = make()
    assert got == _drive(sync, gt.SamplingParams, prompts, max_tokens,
                         keep, 2)
    _check_drained(llm)
    assert llm.scheduler.num_preemptions > 0
    chained = sum(n for (kind, depth), n in llm.dispatches.items()
                  if kind == "decode" and depth >= 2)
    assert chained > 0
    if make is _hybrid:
        assert not reforms
    elif flags == "pipelined":
        assert reforms


def test_sampled_streams_reproducible():
    """Sampled rows under the pipelined loop: the same streams run to run
    (their draws follow dispatch order, not the sync loop's)."""
    prompts, _ = _staggered(7)
    sp = dict(temperature=0.8, top_k=30, max_tokens=12, ignore_eos=True)
    runs = [_generate(_engine(False, **FLAGS["pipelined"]), prompts, sp)
            for _ in range(2)]
    assert runs[0] == runs[1]


def test_reconcile_cascade_stops_at_a_valid_sync_root():
    """A chained entry descending from a later valid sync-rooted entry
    survives an earlier entry's invalidation
    (tests/test_pipelined_loop.py:313)."""
    def e(**kw):
        return InFlight(None, object(), 0.0, {}, **kw)

    fm = FutureMap()
    reform = e(chained=True, promises=frozenset({7}))
    prefill = e()                               # interleaved, no root
    root = e(roots=True)                        # fresh sync decode root
    chain_off_root = e(chained=True)
    entries = [reform, prefill, root, chain_off_root]
    assert fm.reconcile(entries, frozenset({7})) == 1
    assert reform.invalid
    assert not prefill.invalid and not root.invalid
    assert not chain_off_root.invalid           # parent is the valid root
    # without a root in between, the cascade takes the chained entry
    fm2 = FutureMap()
    r2, c2 = (e(chained=True, promises=frozenset({7})), e(chained=True))
    assert fm2.reconcile([r2, e(), c2], frozenset({7})) == 2
    assert r2.invalid and c2.invalid
    assert (fm.rebuilds, fm.divergences, fm2.rebuilds) == (1, 1, 2)


class _StubEvent:
    def __init__(self, log, slot):
        self.log, self.slot = log, slot

    def synchronize(self):
        self.log.append(("wait", self.slot))

    def record(self):
        self.log.append(("record", self.slot))


def test_host_staging_ring_waits_before_refilling_a_slot():
    """The pinned ring: upload k fills slot k mod 3, after waiting for the
    event of that slot's last copy, and records it again after its own
    copy; each slot keeps the step it last staged while the others are
    filled."""
    cfg = gt.EngineConfig(max_model_len=64, cache=gt.CacheConfig(
        page_size=4, num_pages=32))
    builder = BatchBuilder(cfg, 4)
    staging = HostStaging("cpu", slots=3)
    log = []
    staging._events = [_StubEvent(log, i) for i in range(3)]
    staged = []
    for k in range(5):
        seq = Sequence(k, list(range(1, k + 3)))
        seq.page_table = [1]
        host, _ = builder.build(ScheduledBatch([ScheduledSeq(
            seq, k + 2, 0)]))
        dev = staging.upload(host)
        assert dev.token_ids[:k + 2].tolist() == list(range(1, k + 3))
        staged.append(host.token_ids)
    assert log == [(op, k % 3) for k in range(5)
                   for op in ("wait", "record")]
    for k in (2, 3, 4):
        ring = staging._ring[k % 3].numpy()
        assert ring[:staged[k].size].tolist() == staged[k].tolist()


def test_validate_normalizes_as_jax():
    """``enforce_eager`` clears what the JAX package's clears (persistent
    slots among them), ``pipelined_loop`` implies ``overlap_scheduling``,
    ``overlap_depth`` must be at least 1, the chain length resolves as the
    JAX package's, and ``decode_slot_batching`` and the unified step under
    overlap are taken as there."""
    for kw in (dict(enforce_eager=True, overlap_scheduling=True,
                    pipelined_loop=True, chain_under_prefill=3),
               dict(pipelined_loop=True, overlap_depth=3),
               dict(overlap_scheduling=True)):
        cfg, jcfg = gt.EngineConfig(**kw), JEC(**kw)
        cfg.validate()
        jcfg.validate()
        for f in ("overlap_scheduling", "pipelined_loop", "overlap_depth",
                  "chain_under_prefill", "multi_step_decode",
                  "decode_chain_len", "ondevice_finish",
                  "decode_slot_batching"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
    with pytest.raises(ValueError, match="overlap_depth"):
        gt.EngineConfig(overlap_scheduling=True, overlap_depth=0).validate()
    for kw in (dict(multi_step_decode=4), dict(decode_chain_len=4),
               dict(ondevice_finish=True)):
        cfg = gt.EngineConfig(overlap_scheduling=True, **kw)
        jcfg = JEC(overlap_scheduling=True, **kw)
        cfg.validate()
        jcfg.validate()
        for f in ("multi_step_decode", "decode_chain_len",
                  "ondevice_finish"):
            assert getattr(cfg, f) == getattr(jcfg, f), (kw, f)
    # persistent slots are taken (and, as in JAX, kept without overlap,
    # where they do nothing); so is the unified step under overlap, whose
    # fields come out as JAX's
    for kw in (dict(overlap_scheduling=True, decode_slot_batching=True),
               dict(decode_slot_batching=True)):
        cfg, jcfg = gt.EngineConfig(**kw), JEC(**kw)
        cfg.validate()
        jcfg.validate()
        assert cfg.decode_slot_batching == jcfg.decode_slot_batching
    kw = dict(overlap_scheduling=True, unified_step=True, pipelined_loop=True,
              chain_under_prefill=2)
    cfg, jcfg = gt.EngineConfig(**kw), JEC(**kw)
    cfg.validate()
    jcfg.validate()
    for f in ("overlap_scheduling", "pipelined_loop", "unified_step",
              "chain_under_prefill"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
