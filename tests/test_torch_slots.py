"""Persistent-slot decode batching in the PyTorch port, on the CPU at
float32: with ``decode_slot_batching`` under overlap scheduling a finished
row stays in its chain as a dead hole, a decode-ready sequence joins a
hole at a chain boundary (its input token the host's, through the splice
map), and the batch compacts only below its power-of-two sequence bucket.
Greedy streams equal the JAX ``LLM``'s with the same flags and the port's
sync loop's under finishes and arrivals, with the same dispatches (K,
rows), executed sub-steps, chain breaks by reason (none for a finish) and
joined rows, no page or SSM slot leaked and nothing left in flight: the
cases of tests/test_slot_batching.py, blocks off and on and over an fp8
cache; the scheduler's slot accounting beside the JAX scheduler's; a
DeepSeek and a hybrid model against the port's sync loop; hole rows as
the batch builder stages them; and a block with a row dead from its
first sub-step."""

import jax
import numpy as np
import pytest
import torch

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.memory_manager import make_memory_manager as jmake_mm
from gllm_tpu.obs.steptrace import TRACE
from gllm_tpu.runner.prepare import BatchBuilder as JBuilder
from gllm_tpu.sampling_params import SamplingParams as JSP
from gllm_tpu.scheduler import Scheduler as JScheduler
from gllm_tpu.scheduler import ScheduledBatch as JSB, ScheduledSeq as JSS
from gllm_tpu.sequence import (HOLE_SEQ_ID as JHOLE, Sequence as JSeq,
                               make_hole_seq as jmake_hole)

import gllm_tpu_torch as gt
from gllm_tpu_torch.engine.pipeline import FutureMap
from gllm_tpu_torch.memory_manager import make_memory_manager
from gllm_tpu_torch.runner.prepare import BatchBuilder
from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq, Scheduler
from gllm_tpu_torch.sequence import HOLE_SEQ_ID, Sequence, make_hole_seq

from test_torch_multistep import _watch
from test_torch_overlap import _check_drained, _engine, _hybrid, _mla

EOS = 2
# the configuration of tests/test_slot_batching.py:42 (sixteen sequences a
# batch, a 64-token prefill budget, 4-token pages), on the dummy model of
# test_torch_overlap
KW = dict(num_pages=256, max_model_len=128, max_prefill=64, max_seqs=16)
SLOTS = dict(decode_slot_batching=True, chain_under_prefill=8)
FLAGS = {
    # blocks off: single-step chains
    "steps": dict(overlap_scheduling=True, **SLOTS),
    # tests/test_slot_batching.py's engine: blocks of up to 8
    "blocks": dict(overlap_scheduling=True, multi_step_decode=8, **SLOTS),
    # the pipelined loop with on-device finish (blocks of up to 16)
    "pipelined_odf": dict(pipelined_loop=True, ondevice_finish=True,
                          **SLOTS),
    "fp8": dict(pipelined_loop=True, decode_chain_len=8, kv="fp8", **SLOTS),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy_joins(llm):
    """The rows that joined each dispatched chain (``host_rows``), in
    order."""
    runner, joined = llm.runner, []
    step_async, step_multi = runner.step_async, runner.step_multi

    def one(batch, *a, **kw):
        if batch.host_rows:
            joined.append(list(batch.host_rows))
        return step_async(batch, *a, **kw)

    def multi(chain, *a, **kw):
        if chain[0].host_rows:
            joined.append(list(chain[0].host_rows))
        return step_multi(chain, *a, **kw)
    runner.step_async, runner.step_multi = one, multi
    return joined


def _breaks(llm, run):
    """``run()``'s result and the chain breaks by reason it caused: the
    port's counter, the JAX engine's chain_break events."""
    if isinstance(llm, JLLM):
        mark = TRACE.mark()
        out = run()
        breaks = {}
        for e in TRACE.events(since=mark):
            if e["kind"] == "chain_break":
                breaks[e["reason"]] = breaks.get(e["reason"], 0) + 1
        return out, breaks
    return run(), dict(llm.chain_breaks)


def _seqs(llm, lens, maxs, rng):
    SP = JSP if isinstance(llm, JLLM) else gt.SamplingParams
    return [llm._allocate_seq(
        rng.integers(1, 120, size=int(n)).tolist(),
        SP(temperature=0.0, max_tokens=m, ignore_eos=True))
        for n, m in zip(lens, maxs)]


# tests/test_slot_batching.py:58: wave 1 finishes staggered while wave 2
# arrives once every wave-1 sequence has a few output tokens
W1_LENS, W1_MAX = (12, 33, 7, 21, 5, 17), (23, 40, 9, 31, 3, 14)
W2_LENS, W2_MAX = (9, 6, 11, 8), (12, 18, 7, 10)


def _churn(llm):
    rng = np.random.default_rng(7)
    wave1 = _seqs(llm, W1_LENS, W1_MAX, rng)
    wave2 = _seqs(llm, W2_LENS, W2_MAX, rng)
    for s in wave1:
        llm.add_seq(s)
    added = False
    while llm.has_unfinished or not added:
        llm.step()
        if not added and min(s.num_output_tokens for s in wave1) >= 3:
            for s in wave2:
                llm.add_seq(s)
            added = True
    _check_drained(llm)
    toks = [s.output_token_ids for s in wave1 + wave2]
    assert [len(t) for t in toks] == list(W1_MAX + W2_MAX)
    return toks


def _late_join(llm):
    """tests/test_slot_batching.py:118: one quick finisher makes a hole in
    a chain of four; a late arrival, added once it finished, joins it."""
    rng = np.random.default_rng(7)
    wave1 = _seqs(llm, (8, 9, 10, 5), (40, 40, 40, 3), rng)
    late = _seqs(llm, (6,), (10,), rng)
    for s in wave1:
        llm.add_seq(s)
    added = False
    while llm.has_unfinished or not added:
        llm.step()
        if not added and wave1[3].finish_reason is not None:
            llm.add_seq(late[0])
            added = True
    _check_drained(llm)
    return [s.output_token_ids for s in wave1 + late]


def _against_jax(drive, flags):
    """``drive``'s streams, dispatches (K, rows), executed sub-steps under
    on-device finish, chain breaks by reason and joined rows in the port
    under ``flags`` equal the JAX LLM's; its streams equal the port's sync
    loop's. Returns the port's engine, its breaks and its joins."""
    port = _engine(False, **KW, **flags)
    seen, k_exec = _watch(port)
    joins = _spy_joins(port)
    got, breaks = _breaks(port, lambda: drive(port))
    jllm = _engine(True, **KW, **flags)
    jseen, jk_exec = _watch(jllm)
    jjoins = _spy_joins(jllm)
    want, jbreaks = _breaks(jllm, lambda: drive(jllm))
    assert got == want
    assert seen == jseen
    assert breaks == jbreaks
    assert joins == jjoins
    if flags.get("ondevice_finish"):
        assert [k for k in k_exec if k is not None] == jk_exec
    kv = {"kv": flags["kv"]} if "kv" in flags else {}
    assert got == drive(_engine(False, **KW, **kv))
    assert breaks.get("finish", 0) == 0
    assert port.joins == sum(len(j) for j in joins)
    assert port.scheduler._hole_seq.num_in_flight == 0
    return port, breaks, joins


@pytest.mark.parametrize("flags", list(FLAGS))
def test_churn_identical_to_jax_and_sync(flags):
    """Finishes and arrivals while chains are in flight: holes absorb the
    finishes (no "finish" break), the hole row-sub-steps are counted
    apart from the dead share, and blocks form where the flags allow."""
    port, breaks, _ = _against_jax(_churn, FLAGS[flags])
    assert port.hole_substeps > 0
    # bounded by the arrivals, not the finishes
    assert sum(breaks.values()) <= 2 * len(W2_LENS), breaks
    assert bool(port.blocks) == (flags != "steps")
    if flags == "fp8":
        assert port.runner.kv.k.dtype == torch.float8_e4m3fn


def test_slots_break_less_than_legacy():
    """The legacy membership breaks on every finish inside a chain; slots
    break strictly less often, never for a finish."""
    legacy = _engine(False, **KW, overlap_scheduling=True,
                     multi_step_decode=8)
    slots = _engine(False, **KW, **FLAGS["blocks"])
    assert _churn(legacy) == _churn(slots)
    assert legacy.chain_breaks["finish"] > 0
    assert sum(slots.chain_breaks.values()) < sum(
        legacy.chain_breaks.values())
    assert slots.chain_breaks["finish"] == 0


@pytest.mark.parametrize("multi", [1, 8])
def test_join_fills_hole_without_reform(multi):
    """A late arrival seats in an existing hole (a chained dispatch whose
    ``host_rows`` is non-empty) instead of a re-form, depth 3 keeping the
    chain's tip in flight across the arrival's prefill; single steps and
    blocks."""
    flags = dict(FLAGS["steps"], overlap_depth=3, multi_step_decode=multi)
    port, _, joins = _against_jax(_late_join, flags)
    assert joins and port.joins == sum(len(j) for j in joins)


# ---------------------------------------------------------------------------
# the scheduler's slot accounting beside the JAX scheduler's (no model)
# ---------------------------------------------------------------------------

PKGS = {"jax": (JEC, JSC, JCC, jmake_mm, JScheduler, JSeq, JSP, JHOLE),
        "port": (gt.EngineConfig, gt.SchedulerConfig, gt.CacheConfig,
                 make_memory_manager, Scheduler, Sequence,
                 gt.SamplingParams, HOLE_SEQ_ID)}


def _sched(pkg, slot=True, maxd=8, num_pages=128):
    EC, SC, CC, mmf, Sched = PKGS[pkg][:5]
    cfg = EC(max_model_len=num_pages * 4, max_num_seqs=32,
             overlap_scheduling=True, decode_slot_batching=slot,
             scheduler=SC(max_prefill_tokens=256, max_decode_seqs=maxd),
             cache=CC(page_size=4, num_pages=num_pages))
    return Sched(cfg, mmf(num_pages, 4, False))


def _to_decode(pkg, sched, n, first_id=0):
    """n sequences admitted and prefilled: decode-ready."""
    Seq, SP = PKGS[pkg][5:7]
    seqs = [Seq(first_id + i, [1, 3, 4, 5], SP(max_tokens=50))
            for i in range(n)]
    for s in seqs:
        sched.add_seq(s)
    b = sched.schedule_once()
    assert b.num_seqs == n and b.items[0].samples
    sched.process_output(b, [7] * n, EOS)
    return seqs


def _holes(pkg, batch):
    return sum(it.seq.seq_id == PKGS[pkg][7] for it in batch.items)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_finish_becomes_hole_not_break(pkg):
    sched = _sched(pkg)
    _to_decode(pkg, sched, 3)
    b0 = sched.schedule_once()
    c1 = sched.schedule_chain(b0, 1)
    assert len(c1) == 1
    sched.process_output(b0, [7, 7, EOS], EOS)      # row 2 finishes
    c2 = sched.schedule_chain(c1[0], 1)
    assert len(c2) == 1 and c2[0].num_seqs == 3     # signature survives
    assert c2[0].items[2].seq.seq_id == PKGS[pkg][7]
    assert c2[0].active_until == [1, 1, 0]
    assert c2[0].host_rows is None
    sched.process_output(c1[0], [7, 7, 9], EOS)     # the dead token drops
    sched.process_output(c2[0], [7, 7, 9], EOS)
    assert [len(s.output_token_ids) for s in sched.running] == [4, 4]
    assert sched._hole_seq.num_in_flight == 0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_legacy_finish_breaks_chain(pkg):
    sched = _sched(pkg, slot=False)
    _to_decode(pkg, sched, 3)
    b0 = sched.schedule_once()
    c1 = sched.schedule_chain(b0, 1)
    sched.process_output(b0, [7, 7, EOS], EOS)
    assert sched.schedule_chain(c1[0], 1) == []
    assert sched.chain_break_reason == "finish"


@pytest.mark.parametrize("pkg", list(PKGS))
def test_ready_seq_joins_hole_with_host_tokens(pkg):
    sched = _sched(pkg)
    _to_decode(pkg, sched, 3)
    b0 = sched.schedule_once()
    c1 = sched.schedule_chain(b0, 1)
    sched.process_output(b0, [7, 7, EOS], EOS)      # row 2 → hole
    c2 = sched.schedule_chain(c1[0], 1)
    sched.process_output(c1[0], [7, 7, 9], EOS)
    late = _to_decode(pkg, sched, 1, first_id=10)[0]
    c3 = sched.schedule_chain(c2[0], 1)
    assert len(c3) == 1 and c3[0].num_seqs == 3
    assert c3[0].host_rows == [2]
    assert c3[0].items[2].seq is late
    assert c3[0].active_until is None
    sched.process_output(c2[0], [7, 7, 9], EOS)
    sched.process_output(c3[0], [7, 7, 7], EOS)
    assert late.output_token_ids == [7, 7]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_unseatable_arrival_breaks_with_waiting(pkg):
    """More ready sequences than holes: the batch must grow, "waiting";
    at the decode budget the ready work waits instead."""
    sched = _sched(pkg)
    _to_decode(pkg, sched, 3)
    b0 = sched.schedule_once()
    c1 = sched.schedule_chain(b0, 1)
    sched.process_output(b0, [7, 7, 7], EOS)
    _to_decode(pkg, sched, 2, first_id=10)
    assert sched.schedule_chain(c1[0], 1) == []
    assert sched.chain_break_reason == "waiting"
    full = _sched(pkg, maxd=3)
    _to_decode(pkg, full, 3)
    b0 = full.schedule_once()
    c1 = full.schedule_chain(b0, 1)
    full.process_output(b0, [7, 7, 7], EOS)
    _to_decode(pkg, full, 2, first_id=10)
    c2 = full.schedule_chain(c1[0], 1)
    assert len(c2) == 1 and c2[0].host_rows is None


@pytest.mark.parametrize("pkg", list(PKGS))
def test_drained_batch_compacts_below_bucket(pkg):
    """Live rows under the next lower power-of-two bucket: the chain
    re-forms ("shape") instead of dragging its holes; at or above it the
    holes ride on."""
    sched = _sched(pkg, maxd=16, num_pages=256)
    _to_decode(pkg, sched, 16)
    b0 = sched.schedule_once()
    c1 = sched.schedule_chain(b0, 1)
    sched.process_output(b0, [EOS] * 9 + [7] * 7, EOS)   # 7 live < 8
    assert sched.schedule_chain(c1[0], 1) == []
    assert sched.chain_break_reason == "shape"
    if pkg == "port":
        assert sched.num_compactions == 1
    sched2 = _sched(pkg, maxd=16, num_pages=256)
    _to_decode(pkg, sched2, 16, first_id=100)
    b0 = sched2.schedule_once()
    c1 = sched2.schedule_chain(b0, 1)
    sched2.process_output(b0, [EOS] * 6 + [7] * 10, EOS)
    c2 = sched2.schedule_chain(c1[0], 1)
    assert c2 and c2[0].num_seqs == 16 and _holes(pkg, c2[0]) == 6


def test_reform_drops_holes_and_promises_none():
    """A re-form off a chain with holes seats only live rows, and no hole
    is promised."""
    sched = _sched("port")
    _to_decode("port", sched, 3)
    b0 = sched.schedule_once()
    c1 = sched.schedule_chain(b0, 1)
    sched.process_output(b0, [7, 7, EOS], EOS)
    c2 = sched.schedule_chain(c1[0], 1)
    assert _holes("port", c2[0]) == 1
    batch = sched.schedule_reform(c2[0])
    assert [it.seq.seq_id for it in batch.items] == [0, 1]
    assert batch.src_rows == [0, 1]
    assert FutureMap.promised_ids(batch) == frozenset({0, 1})
    hole_batch = ScheduledBatch(c2[0].items, src_rows=[0, 1, 2])
    assert FutureMap.promised_ids(hole_batch) == frozenset({0, 1})


# ---------------------------------------------------------------------------
# hole rows in the batch builder and in a block
# ---------------------------------------------------------------------------

def test_hole_rows_build_as_the_jax_builder_does():
    """A hole row stages as JAX's: token 0 at position 0, its KV slot in
    the dummy page, context 1, page table [0], the dummy SSM slot 0 of a
    hybrid model; its stop set is empty, so a finish never widens E."""
    eos = frozenset({2, 3})
    hole, jhole = make_hole_seq(), jmake_hole()
    assert (hole.token_ids, hole.page_table, hole.status.name) == (
        jhole.token_ids, jhole.page_table, jhole.status.name)
    live, jlive = (Sequence(5, [4, 5, 6, 7, 8], gt.SamplingParams()),
                   JSeq(5, [4, 5, 6, 7, 8], JSP()))
    for s in (live, jlive):
        s.page_table = [3, 4]
        s.num_computed_tokens = 5
    live.ssm_slot = jlive.ssm_slot = 2
    items = [ScheduledSeq(live, 1, 5), ScheduledSeq(hole, 1, 0)]
    jitems = [JSS(jlive, 1, 5), JSS(jhole, 1, 0)]
    key = jax.random.key(0)
    for use_ssm in (False, True):
        builder = BatchBuilder(gt.EngineConfig(max_model_len=64), 4,
                               use_ssm=use_ssm)
        jbuilder = JBuilder(JEC(max_model_len=64), 4, use_ssm=use_ssm)
        got, _ = builder.build(ScheduledBatch(items))
        want, _, _ = jbuilder.build(JSB(jitems), key, device=False)
        names = ("token_ids", "positions", "slot_mapping") + (
            ("ssm_slots",) if use_ssm else ())
        for name in names:
            np.testing.assert_array_equal(
                getattr(got, name)[:2], np.asarray(getattr(want, name))[:2],
                err_msg=name)
        np.testing.assert_array_equal(got.attn.kv_lens[:2], [6, 1])
        np.testing.assert_array_equal(
            got.attn.kv_lens[:2], np.asarray(want.attn.kv_lens)[:2])
        np.testing.assert_array_equal(
            got.attn.page_table[:2], np.asarray(want.attn.page_table)[:2])
        assert not got.attn.page_table[1].any()
        assert (got.token_ids[1], got.positions[1],
                got.slot_mapping[1]) == (0, 0, 0)
        if use_ssm:
            assert got.ssm_slots[:2].tolist() == [2, 0]
    ids, _ = builder.stop_sets(items, 8, eos)
    jids, _ = jbuilder.stop_sets(jitems, 8, eos)
    np.testing.assert_array_equal(ids, jids)
    assert (ids[1] == -1).all()
    assert builder.stop_sets(items[1:], 8, eos) == (None, None)


def test_block_keeps_a_hole_dead_from_its_first_substep():
    """A block whose second row is a hole: the hole's finish step is 0,
    its KV writes land in the dummy page only, and the live row's tokens
    are those of the same block with a padding row in the hole's place
    (the sequence bucket is 8 either way)."""
    llm = _engine(False, num_pages=64, overlap_scheduling=True,
                  multi_step_decode=4)
    runner = llm.runner
    seq = llm._allocate_seq([3, 14, 15, 9, 2], gt.SamplingParams(
        temperature=0.0, max_tokens=20, ignore_eos=True))
    llm.add_seq(seq)
    b = llm.scheduler.schedule_once()
    llm.scheduler.process_output(b, runner.step(b).tolist(),
                                 llm.eos_token_ids)
    cn = seq.num_computed_tokens
    llm.memory_manager.allocate_seq_pages(seq, cn + 4 - cn)
    hole = llm.scheduler._hole_seq

    def chain(with_hole):
        links = []
        for j in range(4):
            items = [ScheduledSeq(seq, 1, cn + j)]
            if with_hole:
                items.append(ScheduledSeq(hole, 1, 0))
            links.append(ScheduledBatch(items))
        if with_hole:
            links[0].active_until = [4, 0]
        return links
    k0, v0 = runner.kv.k.clone(), runner.kv.v.clone()
    plain = runner.collect(runner.step_multi(chain(False)))
    k1, v1 = runner.kv.k.clone(), runner.kv.v.clone()
    runner.kv.k.copy_(k0)
    runner.kv.v.copy_(v0)
    got = runner.collect(runner.step_multi(chain(True)))
    assert got[:4, 0].tolist() == plain[:4, 0].tolist()
    assert got[4].tolist() == [4, 0]
    # every page but the dummy one as the hole-free block left it
    assert torch.equal(runner.kv.k[:, 1:], k1[:, 1:])
    assert torch.equal(runner.kv.v[:, 1:], v1[:, 1:])


# ---------------------------------------------------------------------------
# DeepSeek and the hybrid model against the port's sync loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [_mla, _hybrid], ids=["mla", "hybrid"])
def test_mla_and_hybrid_identical_to_sync(make):
    """Ten requests of staggered lengths, six arriving mid-run, over a
    30-page pool that preempts: the slot loop's streams equal the sync
    loop's; holes ride, no finish breaks a chain, no page or slot leaks.
    DeepSeek forms blocks; the hybrid model chains single steps and its
    "waiting" breaks drain and sync (no re-form)."""
    from test_torch_engine import _drive
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, int(n)).tolist()
               for n in rng.integers(2, 9, 10)]
    max_tokens = [int(m) for m in rng.integers(6, 26, 10)]
    keep = [True] * 10
    llm = make(pipelined_loop=True, ondevice_finish=True, **SLOTS)
    reforms = []
    reform = llm.scheduler.schedule_reform
    llm.scheduler.schedule_reform = lambda b, **kw: (
        reforms.append(b), reform(b, **kw))[1]
    got = _drive(llm, gt.SamplingParams, prompts, max_tokens, keep, 2)
    assert got == _drive(make(), gt.SamplingParams, prompts, max_tokens,
                         keep, 2)
    _check_drained(llm)
    assert llm.chain_breaks["finish"] == 0
    assert llm.hole_substeps > 0
    assert llm.scheduler._hole_seq.num_in_flight == 0
    if make is _hybrid:
        assert not reforms and not llm.blocks
    else:
        assert llm.blocks
