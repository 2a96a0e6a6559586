"""The unified step under overlap scheduling in the PyTorch port, on the CPU
at float32: with ``unified_step`` and ``overlap_scheduling`` a chain with
prefill work waiting no longer yields to it; it absorbs the work through a
mixed re-form (``Scheduler.schedule_reform(prev, allow_prefill=True)``):
the chain's promised decode rows first, their tokens spliced on the
device at their flat token offsets, then prefill chunks whose tokens the
host knows. Greedy streams, chain breaks by reason, mixed re-forms, the
dispatch sequence and the executed sub-steps equal the JAX ``LLM``'s with
the same flags under arrival, finish and preemption churn (the engine
cases of tests/test_unified_step.py; its ``kw4`` cell held to JAX's sync
loop), the ``waiting`` break class stays at zero where the legacy loop
hits it, and no page is leaked or entry left in flight. Beyond JAX's
cases: the splice at a flat token offset after a multi-token chunk, an
invalidated mixed re-form, the prefix cache, int8 and fp8 caches, a
DeepSeek model against its sync loop, the unified sync loop unchanged,
the option rules and the flag's inertness on a hybrid model."""

import logging

import numpy as np
import pytest
import torch

from gllm_tpu.config import EngineConfig as JEC
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.engine.pipeline import FutureMap
from gllm_tpu_torch.runner.runner import StepHandle
from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq
from gllm_tpu_torch.sequence import Sequence, SequenceStatus

from test_torch_multistep import _watch
from test_torch_overlap import _check_drained, _counts, _engine, _hybrid, _mla
from test_torch_slots import _breaks

# tests/test_unified_step.py:279 (make_llm): eight sequences a batch, a
# 32-token prefill budget, 4-token pages, 64-token sequences, EOS 7, on
# the dummy model of test_torch_overlap
KW = dict(max_model_len=64, max_prefill=32, max_seqs=8, eos=(7,))
UNIFIED = dict(overlap_scheduling=True, unified_step=True, overlap_depth=2)
BLOCKS = dict(multi_step_decode=4, decode_slot_batching=True,
              ondevice_finish=True)
# tests/test_unified_step.py:313-320 (churn_run's cells, but the seeded
# one: the port takes no per-request seed yet)
CHURN = {"arrivals": dict(),
         "blocks_slots_odf": BLOCKS,
         "preemption": dict(num_pages=24),
         "kw4": dict(num_pages=24, multi_step_decode=4)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _churn(llm, n=10, arrivals=None, prefix=(), max_tokens=None):
    """tests/test_unified_step.py:292 (churn_run): ``n`` greedy requests
    arriving at loop iterations, mid-chain (``prefix``: a prompt head they
    share); their token ids and finish reasons."""
    SP = JSP if isinstance(llm, JLLM) else gt.SamplingParams
    arrivals = arrivals or {0: 3, 2: 2, 5: 2, 9: 1, 14: 2}
    rng = np.random.default_rng(11)
    seqs, it = [], 0
    while len(seqs) < n or llm.has_unfinished:
        for _ in range(arrivals.get(it, 0)):
            if len(seqs) >= n:
                break
            ids = list(prefix) + [int(x) for x in rng.integers(
                2, 250, size=int(rng.integers(3, 20)))]
            m = max_tokens or int(rng.integers(4, 24))
            s = llm._allocate_seq(ids, SP(temperature=0.0, max_tokens=m,
                                          ignore_eos=max_tokens is not None))
            seqs.append(s)
            llm.add_seq(s)
        llm.step()
        it += 1
        assert it < 3000, "engine stopped making progress"
    _check_drained(llm)
    return [(s.token_ids[:], s.finish_reason) for s in seqs]


def _prefill_row(it) -> bool:
    """A chunk of several tokens, or a row still inside its prompt."""
    return it.num_new_tokens > 1 or it.computed_before < it.seq.prompt_len


def _is_mixed(batch) -> bool:
    return any(_prefill_row(it) for it in batch.items)


def _spy_absorbs(llm):
    """The mixed re-forms the scheduler returns (each is dispatched), as
    (sequence, computed before, new tokens, source row, prefill row)
    rows, in order."""
    sched, seen = llm.scheduler, []
    reform = sched.schedule_reform

    def spy(prev, allow_prefill=False):
        out = reform(prev, allow_prefill=allow_prefill)
        if out is not None and _is_mixed(out):
            seen.append([(it.seq.seq_id, it.computed_before,
                          it.num_new_tokens, src, _prefill_row(it))
                         for it, src in zip(out.items, out.src_rows)])
        return out
    sched.schedule_reform = spy
    return seen


def _port_and_jax(drive, flags, jax=True, **kw):
    """``drive`` through the port under ``flags`` and, with ``jax``,
    through the JAX LLM under the same flags: streams, dispatches (K,
    rows), executed sub-steps under on-device finish, chain breaks by
    reason and mixed re-forms equal. Returns the port's engine, streams,
    breaks and mixed re-forms."""
    port = _engine(False, **kw, **flags)
    seen, k_exec = _watch(port)
    absorbed = _spy_absorbs(port)
    got, breaks = _breaks(port, lambda: drive(port))
    assert port.absorbs == len(absorbed)
    assert breaks.get("waiting", 0) == 0
    if jax:
        jllm = _engine(True, **kw, **flags)
        jseen, jk_exec = _watch(jllm)
        jabsorbed = _spy_absorbs(jllm)
        want, jbreaks = _breaks(jllm, lambda: drive(jllm))
        assert got == want
        assert seen == jseen
        assert breaks == jbreaks
        assert absorbed == jabsorbed
        assert _counts(port) == _counts(jllm)
        if flags.get("ondevice_finish"):
            assert [k for k in k_exec if k is not None] == jk_exec
    return port, got, breaks, absorbed


@pytest.mark.parametrize("case", list(CHURN))
def test_churn_identical_to_jax(case):
    """Arrivals land mid-chain and chains absorb them; with 24 pages the
    sync pass preempts, and mixed re-forms that would need a victim wait
    a pass instead. The ``kw4`` cell (blocks under preemption) is red in
    the JAX package itself (its unified engine parts from its legacy one
    there): the port is held to the JAX sync loop's streams instead."""
    kw = dict(KW, num_pages=CHURN[case].get("num_pages", 256))
    flags = {k: v for k, v in CHURN[case].items() if k != "num_pages"}
    port, got, breaks, absorbed = _port_and_jax(
        _churn, dict(UNIFIED, **flags), jax=case != "kw4", **kw)
    if case == "kw4":
        assert got == _churn(_engine(True, unified_step=True, **kw))
    assert absorbed and port.absorbs > 0
    assert bool(port.blocks) == ("multi_step_decode" in flags)
    if kw["num_pages"] == 24:
        assert port.scheduler.num_preemptions > 0


def test_zero_waiting_breaks_and_mixed_steps():
    """tests/test_unified_step.py:345: the retired break class stays at
    zero while arrivals land mid-chain, and mixed re-forms run dispatched
    ahead of another entry; the legacy loop on the same workload (the
    pipelined loop with slots) does break with ``waiting``, so the absorb
    path carries the case. Both give the same streams."""
    uni = _engine(False, **KW, **UNIFIED, **BLOCKS)
    got = _churn(uni)
    assert uni.chain_breaks["waiting"] == 0 and uni.absorbs > 0
    assert sum(n for (kind, depth), n in uni.dispatches.items()
               if kind == "mixed" and depth >= 2) >= uni.absorbs
    legacy = _engine(False, **KW, pipelined_loop=True, **BLOCKS)
    assert _churn(legacy) == got
    assert legacy.chain_breaks["waiting"] > 0 and legacy.absorbs == 0


def test_mixed_reform_carries_promised_and_prefill_rows():
    """tests/test_unified_step.py:382: under pressure the loop dispatches
    mixed re-forms carrying both a promised decode row (spliced from the
    previous entry's tokens) and a host-known prefill row, the decode rows
    first (the kernels' row-class contract); only the promised rows are
    promises, and each sits at its flat token offset in the splice map."""
    llm = _engine(False, **dict(KW, eos=()), **UNIFIED, **BLOCKS)
    absorbed = _spy_absorbs(llm)
    maps = []
    host_batch = llm.runner._host_batch

    def record(batch, *a, **kw):
        out = host_batch(batch, *a, **kw)
        if batch.src_rows is not None and _is_mixed(batch):
            maps.append((batch, out[0].splice))
        return out
    llm.runner._host_batch = record
    _churn(llm, n=7, arrivals={0: 3, 4: 2, 8: 2}, max_tokens=12)
    assert absorbed, "no chain absorbed a prefill chunk"
    assert any(any(src >= 0 for *_, src, _ in rows)
               and any(src < 0 and pf for *_, src, pf in rows)
               for rows in absorbed)
    for rows in absorbed:
        # the decode prefix: every row before the first prefill row has
        # one token, and every promised row is in it
        first = next(i for i, row in enumerate(rows) if row[-1])
        assert all(n == 1 for _, _, n, _, _ in rows[:first])
        assert all(src < 0 for _, _, _, src, _ in rows[first:])
    assert len(maps) == len(absorbed)
    for batch, splice in maps:
        promised = [j for j, src in enumerate(batch.src_rows) if src >= 0]
        offsets = np.cumsum([0] + [it.num_new_tokens for it in batch.items])
        k = len(promised)
        assert list(splice[:k]) == [offsets[j] for j in promised]
        assert list(splice[k:]) == [batch.src_rows[j] for j in promised]
        assert FutureMap.promised_ids(batch) == {
            batch.items[j].seq.seq_id for j in promised}


def test_splice_at_the_flat_offset_after_a_chunk():
    """A re-formed batch whose promised row comes after a multi-token
    prefill chunk (the kernels take rows in any order): the promised
    token lands at the row's flat offset (the chunk's length), not at its
    row index, and the step samples what it samples with the token known
    on the host. A splice at the row index would overwrite the chunk's
    second token and leave the promised row's token 0."""
    llm = _engine(False, **KW, unified_step=True)
    runner, mm = llm.runner, llm.memory_manager
    sp = gt.SamplingParams(temperature=0.0, max_tokens=8)
    chunk = Sequence(100, list(range(20, 29)), sp)
    done = Sequence(101, list(range(40, 46)), sp)
    for seq in (chunk, done):
        mm.allocate_seq_pages(seq, seq.num_tokens + 1)
    tok = int(runner.step(ScheduledBatch([ScheduledSeq(done, 6, 0)]))[0])
    # the decode row: with its token on the host, and promised
    known = Sequence(101, list(range(40, 46)) + [tok], sp)
    promised = Sequence(101, list(range(40, 46)), sp)
    for seq in (known, promised):
        seq.page_table = list(done.page_table)
        seq.num_computed_tokens = 6
    want = runner.step(ScheduledBatch([ScheduledSeq(chunk, 9, 0),
                                       ScheduledSeq(known, 1, 6)]))
    batch = ScheduledBatch([ScheduledSeq(chunk, 9, 0),
                            ScheduledSeq(promised, 1, 6)], src_rows=[-1, 2])
    assert runner._host_batch(batch)[0].splice == [9, 2]
    prev = torch.tensor([5, 6, tok, 7], dtype=torch.int32)
    got = runner.collect(runner.step_async_chained(
        batch, StepHandle(prev, prev, None)))
    assert got.tolist() == want.tolist()


def test_invalidated_mixed_reform_leaks_nothing():
    """An EOS the model really emits lands inside a chain while a mixed
    re-form that promised the finishing row is in flight: the re-form and
    its descendants are invalidated, its absorbed chunks unwind (a
    sequence it admitted stays RUNNING at its committed count and the
    sync pass prefills it again), no page leaks, nothing stays in flight,
    and the streams and rebuild counts are the JAX LLM's and the sync
    loop's."""
    outs = _churn(_engine(False, **dict(KW, eos=())))
    toks = [t for ids, _ in outs for t in ids[-10:]]
    eos = max(set(toks), key=toks.count)
    kw = dict(KW, eos=(eos,))
    port = _engine(False, **kw, **UNIFIED)
    discard, unwound = port.scheduler.discard_batch, []

    def spy(batch):
        first = batch[0] if isinstance(batch, list) else batch
        discard(batch)
        if _is_mixed(first):
            unwound.append([(it.seq.status, it.seq.num_computed_tokens)
                            for it in first.items
                            if it.computed_before == 0])
    port.scheduler.discard_batch = spy
    got = _churn(port)
    assert any(unwound), "no mixed re-form with an admission was invalidated"
    assert all(status is SequenceStatus.RUNNING and computed == 0
               for rows in unwound for status, computed in rows)
    assert port.futures.rebuilds > 0 and port.chain_breaks["waiting"] == 0
    jllm = _engine(True, **kw, **UNIFIED)
    assert got == _churn(jllm)
    assert _counts(port) == _counts(jllm)
    assert got == _churn(_engine(False, **kw))


def test_prefix_cache_absorbs_like_jax():
    """Prompts sharing a 12-token head under the prefix cache: mixed
    re-forms admit sequences whose head comes from cached pages, as the
    JAX LLM's do."""
    head = list(range(100, 112))
    port, got, _, absorbed = _port_and_jax(
        lambda llm: _churn(llm, prefix=head), dict(UNIFIED, **BLOCKS),
        prefix=True, **dict(KW, num_pages=256))
    assert port.memory_manager.hit_tokens > 0 and absorbed


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_one_byte_caches_absorb_like_jax(kv):
    port, *_ = _port_and_jax(_churn, dict(UNIFIED, **BLOCKS),
                             **dict(KW, kv=kv))
    assert port.absorbs > 0 and port.runner.kv_dtype == {
        "int8": torch.int8, "fp8": torch.float8_e4m3fn}[kv]


def test_mla_absorbs_identical_to_sync():
    """DeepSeek's MLA model (K1um's plain version on the CPU) under the
    unified step with overlap, blocks and slots: its streams are its own
    unified sync loop's on the same dummy weights, with mixed re-forms
    absorbing arrivals and no ``waiting`` break."""
    def drive(llm):
        return _churn(llm, arrivals={0: 3, 3: 3, 7: 2, 12: 2})
    uni = _mla(**UNIFIED, **BLOCKS)
    assert drive(uni) == drive(_mla(unified_step=True))
    assert uni.absorbs > 0 and uni.chain_breaks["waiting"] == 0
    assert uni.runner.attn_impl == "unified"


def test_unified_sync_loop_unchanged():
    """tests/test_unified_step.py:363: without overlap scheduling the
    unified step is the sync loop: its streams equal the legacy sync
    loop's and the JAX unified engine's, with no re-form."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 500, size=int(m)).tolist()
               for m in rng.integers(3, 14, size=5)]
    maxs = [int(m) for m in rng.integers(4, 16, size=5)]

    def run(jax_side, **flags):
        llm = _engine(jax_side, **dict(KW, eos=()), **flags)
        SP = JSP if jax_side else gt.SamplingParams
        outs = llm.generate(prompt_token_ids=prompts, sampling_params=[
            SP(temperature=0.0, max_tokens=m, ignore_eos=True)
            for m in maxs])
        _check_drained(llm)
        return [(o.output_token_ids, o.finish_reason) for o in outs], llm
    got, uni = run(False, unified_step=True)
    assert not uni.config.pipelined_loop and uni.absorbs == 0
    assert set(k for k, _ in uni.dispatches) == {"mixed", "decode"}
    assert got == run(False)[0] == run(True, unified_step=True)[0]


@pytest.mark.parametrize("kw", [
    dict(overlap_scheduling=True, unified_step=True, chain_under_prefill=8),
    dict(overlap_scheduling=True, unified_step=True),
    dict(pipelined_loop=True, unified_step=True, multi_step_decode=4,
         decode_slot_batching=True),
    dict(unified_step=True, chain_under_prefill=3),
    dict(unified_step=True),
    dict(enforce_eager=True, overlap_scheduling=True, unified_step=True,
         chain_under_prefill=8)])
def test_validate_normalizes_unified_as_jax(kw, caplog):
    """``unified_step`` under overlap lifts ``pipelined_loop``; a nonzero
    ``chain_under_prefill`` is zeroed with JAX's warning; without overlap
    the unified step stays the sync loop; ``enforce_eager`` clears the
    overlap options first: the fields equal the JAX package's after
    ``validate``."""
    cfg, jcfg = gt.EngineConfig(**kw), JEC(**kw)
    with caplog.at_level(logging.WARNING, logger="gllm_tpu_torch.config"):
        cfg.validate()
    jcfg.validate()
    for f in ("overlap_scheduling", "pipelined_loop", "chain_under_prefill",
              "unified_step", "multi_step_decode", "decode_slot_batching"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    deprecated = "chain_under_prefill is deprecated" in caplog.text
    assert deprecated == (kw.get("chain_under_prefill", 0) > 0
                          and not kw.get("enforce_eager"))


def test_hybrid_keeps_unified_step_inert(caplog):
    """On a hybrid (GDN) model the flag is taken and left inert, with a
    warning, as the JAX engine does: legacy kernels, signatures and step
    kinds, and under overlap the legacy pipelined loop (single-step
    chains, no re-form, no absorb); the streams are those of the engine
    without the flag."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, int(n)).tolist()
               for n in rng.integers(2, 9, 6)]
    sps = [gt.SamplingParams(temperature=0.0, max_tokens=int(m),
                             ignore_eos=True)
           for m in rng.integers(6, 20, 6)]

    def run(llm):
        outs = llm.generate(prompt_token_ids=prompts, sampling_params=sps)
        _check_drained(llm)
        return [o.output_token_ids for o in outs]
    with caplog.at_level(logging.WARNING,
                         logger="gllm_tpu_torch.engine.llm"):
        inert = _hybrid(unified_step=True, overlap_scheduling=True,
                        chain_under_prefill=4)
    assert "unified_step is inert" in caplog.text
    assert not inert.unified and inert.config.unified_step
    assert inert.runner.attn_impl == "legacy"
    assert not inert.runner.builder.unified
    assert inert.config.pipelined_loop
    assert inert.config.chain_under_prefill == 0
    legacy = _hybrid(pipelined_loop=True)
    assert run(inert) == run(legacy)
    assert inert.dispatches == legacy.dispatches
    assert inert.chain_breaks == legacy.chain_breaks
    assert inert.absorbs == 0
    sync = _hybrid(unified_step=True)
    assert run(sync) == run(_hybrid())
    assert set(k for k, _ in sync.dispatches) == {"mixed", "decode"}


def test_warmup_captures_the_unified_block_keys():
    """Blocks run under the unified step for the first time: their keys
    carry the unified signature (T = S = max_q_len) and the decode class
    (``decode_only``: no ragged launch in a sub-step), and ``warmup``
    captures the longest block at the served (S, page) bucket, so that
    serving there meets no new key of that K."""
    llm = _engine(False, **dict(KW, eos=()), **UNIFIED, **BLOCKS)
    runner = llm.runner
    runner.warmup(decode_buckets=(8,), block_buckets=(8,))
    warmed = set(runner.graphs.keys)
    blocks = {k for k in warmed if k[0] == "block"}
    assert blocks and all(k[1] == k[2] == k[3] for k in blocks)
    served, forward = [], runner._hidden
    runner._hidden = lambda batch, max_q: (served.append(max_q),
                                           forward(batch, max_q))[1]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 250, size=int(n)).tolist()
               for n in rng.integers(36, 44, size=8)]
    llm.generate(prompt_token_ids=prompts, sampling_params=gt.SamplingParams(
        temperature=0.0, max_tokens=16, ignore_eos=True))
    _check_drained(llm)
    new = {k for k in runner.graphs.keys - warmed
           if k[0] == "block" and k[5] == runner.block_len}
    assert llm.blocks[runner.block_len] > 0 and not new, new
    assert all(k[1] == k[2] == k[3] for k in runner.graphs.keys
               if k[0] == "block")
    # every sub-step of a block, as every decode step, is a decode-only
    # call (max_q_len 1); the mixed steps take the token bucket
    assert set(served) == {1, runner.builder.max_tokens}
