"""Multi-step decode and on-device finish in the PyTorch port, on the CPU
at float32: with ``multi_step_decode`` (or ``decode_chain_len``) under
overlap scheduling and the pipelined loop, a chain extends by blocks of
links run as one device program (``ModelRunner.step_multi``), and under
``ondevice_finish`` a row whose token is in its stop set freezes inside
the block, which stops once every row has finished. Greedy streams equal
the JAX ``LLM``'s with the same flags and the port's sync loop's, with
the same dispatches (rows and K, in order), the same executed sub-steps
per block, the same rebuild, divergence and preemption counts, no page
leak and nothing left in flight: the cases of
tests/test_ondevice_finish.py:76-146 and tests/test_chain_run_through.py,
int8 and fp8 caches and a pipeline three deep, blocks on and off; a
DeepSeek and a hybrid model against the port's sync loop (the hybrid
never forms a block); and the stop sets, ``device_stop_ids`` and the
chain-length resolution against the JAX package's."""

import numpy as np
import pytest
import torch

from gllm_tpu.config import EngineConfig as JEC
from gllm_tpu.runner.prepare import BatchBuilder as JBuilder
from gllm_tpu.scheduler import ScheduledSeq as JSS
from gllm_tpu.sequence import Sequence as JSeq
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.runner.prepare import MAX_STOP_IDS, BatchBuilder
from gllm_tpu_torch.scheduler import ScheduledSeq
from gllm_tpu_torch.sequence import Sequence

from test_torch_overlap import (_check_drained, _counts, _engine, _generate,
                                _hybrid, _mla)

PROMPTS = [[3, 14, 15], [9, 2, 6, 5, 3], [58, 9]]
FLAGS = {"multi": dict(overlap_scheduling=True, multi_step_decode=8),
         "odf": dict(overlap_scheduling=True, multi_step_decode=8,
                     ondevice_finish=True),
         # ondevice_finish lifts the chain length to 16
         "pipelined_odf": dict(pipelined_loop=True, ondevice_finish=True),
         "pipelined": dict(pipelined_loop=True, decode_chain_len=8)}
KW = dict(num_pages=128, max_prefill=64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _watch(llm):
    """Record what ``llm`` dispatches, in order, as (K, rows): K 1 for a
    single step, K for a block; and each collected block's executed
    sub-steps."""
    runner, seen, k_exec = llm.runner, [], []
    step_async, step_multi = runner.step_async, runner.step_multi

    def one(batch, *a, **kw):
        seen.append((1, batch.num_seqs))
        return step_async(batch, *a, **kw)

    def multi(chain, *a, **kw):
        seen.append((len(chain), chain[0].num_seqs))
        return step_multi(chain, *a, **kw)
    runner.step_async, runner.step_multi = one, multi
    if isinstance(llm, gt.LLM):
        # blocks invalidated by reconciliation run too, and the runner
        # counts them; the engine's counts are of the blocks it commits
        discard = llm.scheduler.discard_batch
        llm.scheduler.discard_batch = lambda b: (
            isinstance(b, list) and k_exec.append(None), discard(b))[1]
        stats = llm._block_stats
        llm._block_stats = lambda chain, finish: (
            k_exec.append(int(finish[:chain[0].num_seqs].max())),
            stats(chain, finish))[1]
    else:
        stats = llm._ondevice_block_stats
        llm._ondevice_block_stats = lambda finish: (
            k_exec.append(int(finish.max())), stats(finish))[1]
    return seen, k_exec


def _against_jax(prompts, sp, flags, blocks=True, prepare=None, **kw):
    """The port's streams, dispatches and counts under ``flags`` equal the
    JAX LLM's under the same flags; its streams equal the port's sync
    loop's; a block formed (unless not ``blocks``). ``prepare`` sees the
    port's engine first. Returns the port's engine, its streams,
    dispatches and executed sub-steps per block."""
    port = _engine(False, **kw, **flags)
    if prepare is not None:
        prepare(port)
    seen, k_exec = _watch(port)
    got = _generate(port, prompts, sp)
    jllm = _engine(True, **kw, **flags)
    jseen, jk_exec = _watch(jllm)
    assert got == _generate(jllm, prompts, sp)
    assert got == _generate(_engine(False, **kw), prompts, sp)
    assert _counts(port) == _counts(jllm)
    assert seen == jseen
    discarded = k_exec.count(None)
    k_exec = [k for k in k_exec if k is not None]
    if flags.get("ondevice_finish"):
        assert k_exec == jk_exec
    assert any(k > 1 for k, _ in seen) == blocks
    # the engine's counts of the blocks it committed, the runner's of
    # every block it ran
    assert sum(port.blocks.values()) == len(k_exec)
    assert port.block_substeps == sum(k_exec)
    assert port.runner.block_counts["block"] == len(k_exec) + discarded
    assert port.runner.block_counts["substeps"] >= sum(k_exec)
    if not discarded:
        assert port.runner.block_counts["substeps"] == sum(k_exec)
    return port, got, seen, k_exec


@pytest.fixture(scope="module")
def organic():
    """Tokens the greedy model emits at output positions 2 and 4 for
    PROMPTS[0] (tests/test_ondevice_finish.py:62): finishes that land
    inside a block."""
    out = _generate(_engine(False, **KW), [PROMPTS[0]],
                    dict(temperature=0.0, max_tokens=10, ignore_eos=True))
    toks = out[0][0]
    assert toks[2] not in toks[:2] and toks[4] not in toks[:4]
    return toks[2], toks[4]


@pytest.mark.parametrize("flags", ["multi", "odf", "pipelined_odf"])
def test_long_decode(flags):
    _against_jax(PROMPTS, dict(temperature=0.0, max_tokens=20,
                               ignore_eos=True), FLAGS[flags], **KW)


@pytest.mark.parametrize("flags", ["multi", "odf", "pipelined_odf"])
def test_eos_midblock(organic, flags):
    """An EOS the model emits: host-side finish (multi), the row frozen
    inside the block (odf), and under the pipelined loop the entries
    that promised the row alive rebuilt as JAX's are."""
    port, got, _, _ = _against_jax(
        PROMPTS, dict(temperature=0.0, max_tokens=30), FLAGS[flags],
        eos=[organic[0]], **KW)
    assert got[0] == (_generate(_engine(False, **KW), [PROMPTS[0]], dict(
        temperature=0.0, max_tokens=3, ignore_eos=True))[0][0], "stop")
    if flags != "multi":
        assert port.ondevice_finishes["eos"] > 0


def test_stop_token_midblock(organic):
    port, got, _, _ = _against_jax(
        PROMPTS, dict(temperature=0.0, max_tokens=30,
                      stop_token_ids=[organic[1]]), FLAGS["odf"], **KW)
    assert got[0][1] == "stop" and len(got[0][0]) == 5
    assert port.ondevice_finishes["stop"] > 0


@pytest.mark.parametrize("max_tokens", [1, 23])
def test_length_cap(max_tokens):
    """Length finishes only; at one token no decode step, so no block."""
    _, got, _, _ = _against_jax(
        PROMPTS, dict(temperature=0.0, max_tokens=max_tokens,
                      ignore_eos=True), FLAGS["odf"],
        blocks=max_tokens > 1, **KW)
    assert all(r == "length" and len(t) == max_tokens for t, r in got)


def test_min_tokens_arms_detection(organic):
    """The output-2 EOS is ignored until min_tokens tokens exist, on the
    device as in ``Sequence.check_finish``."""
    _, got, _, _ = _against_jax(
        [PROMPTS[0]], dict(temperature=0.0, max_tokens=12, min_tokens=6),
        FLAGS["odf"], eos=[organic[0]], **KW)
    assert len(got[0][0]) > 3


def test_early_exit_when_every_row_finishes(organic):
    """A block whose rows all finish early runs fewer sub-steps than its
    K, and the streams are the sync loop's."""
    _, got, seen, k_exec = _against_jax(
        [PROMPTS[0]], dict(temperature=0.0, max_tokens=30), FLAGS["odf"],
        eos=[organic[0]], **KW)
    assert got[0][1] == "stop"
    blocks = [k for k, _ in seen if k > 1]
    assert any(e < k for e, k in zip(k_exec, blocks)), (seen, k_exec)


def _staggered():
    """tests/test_chain_run_through.py:41: deaths by length inside
    8-step blocks at different offsets."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 120, size=int(n)).tolist()
               for n in (12, 33, 7, 21, 5, 17)]
    sps = [dict(temperature=0.0, max_tokens=m, ignore_eos=True)
           for m in (23, 40, 9, 31, 3, 14)]
    return prompts, sps


@pytest.mark.parametrize("flags", ["multi", "pipelined"])
def test_run_through_length_deaths(flags):
    """Rows that reach max_tokens inside a block run through it dead
    (``active_until``), and the other rows keep the block."""
    seen_au = []

    def spy_on(port):
        chain = port.scheduler.schedule_chain

        def spy(prev, k_max=1, include_prev=False):
            links = chain(prev, k_max, include_prev)
            if links and links[0].active_until is not None:
                seen_au.append(list(links[0].active_until))
            return links
        port.scheduler.schedule_chain = spy
    prompts, sps = _staggered()
    _, got, _, _ = _against_jax(prompts, sps, FLAGS[flags], prepare=spy_on)
    assert [len(t) for t, _ in got] == [23, 40, 9, 31, 3, 14]
    assert any(min(au) < max(au) for au in seen_au)


@pytest.mark.parametrize("kv,depth,flags", [
    ("int8", 3, "overlap"), ("int8", 3, "pipelined_odf"),
    ("fp8", 3, "overlap"), ("fp8", 2, "pipelined")])
def test_one_byte_caches_and_depth(organic, kv, depth, flags):
    """int8 and fp8 caches and a pipeline three deep under overlap, with
    blocks off (single steps) and on: the streams, dispatches and counts
    of the JAX LLM with the same flags and of the port's sync loop. The
    int8 cache's scale resets of every link's minted pages run once,
    before the block."""
    fl = (dict(FLAGS[flags]) if flags in FLAGS
          else dict(overlap_scheduling=True))
    fl["overlap_depth"] = depth
    port = _engine(False, kv=kv, eos=[organic[0]], **KW, **fl)
    seen, _ = _watch(port)
    sp = dict(temperature=0.0, max_tokens=24)
    got = _generate(port, PROMPTS, sp)
    jllm = _engine(True, kv=kv, eos=[organic[0]], **KW, **fl)
    jseen, _ = _watch(jllm)
    assert got == _generate(jllm, PROMPTS, sp)
    assert got == _generate(_engine(False, kv=kv, eos=[organic[0]], **KW),
                            PROMPTS, sp)
    assert seen == jseen and _counts(port) == _counts(jllm)
    assert any(k > 1 for k, _ in seen) == (flags != "overlap")
    assert port.runner.kv.k.dtype == {"int8": torch.int8,
                                      "fp8": torch.float8_e4m3fn}[kv]
    assert any(depth_ >= 2 for (_, depth_) in port.dispatches)


@pytest.mark.parametrize("flags", ["odf", "pipelined_odf"])
def test_mla_identical_to_sync(flags):
    """A 2-layer DeepSeek with staggered requests over a pool that
    preempts: blocks form and the streams equal the sync loop's."""
    from test_torch_engine import _drive
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, int(n)).tolist()
               for n in rng.integers(2, 9, 8)]
    max_tokens = [int(m) for m in rng.integers(6, 26, 8)]
    keep = [True] * 8
    llm = _mla(**FLAGS[flags])
    got = _drive(llm, gt.SamplingParams, prompts, max_tokens, keep, 2)
    assert got == _drive(_mla(), gt.SamplingParams, prompts, max_tokens,
                         keep, 2)
    _check_drained(llm)
    assert sum(llm.blocks.values()) > 0
    assert llm.runner.block_counts["substeps"] == llm.block_substeps > 0


def test_hybrid_takes_the_flags_and_forms_no_block():
    from test_torch_engine import _drive
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, int(n)).tolist()
               for n in rng.integers(2, 9, 6)]
    max_tokens = [int(m) for m in rng.integers(6, 20, 6)]
    keep = [True] * 6
    llm = _hybrid(**FLAGS["pipelined_odf"])
    assert llm.config.multi_step_decode == 16
    got = _drive(llm, gt.SamplingParams, prompts, max_tokens, keep, 2)
    assert got == _drive(_hybrid(), gt.SamplingParams, prompts, max_tokens,
                         keep, 2)
    _check_drained(llm)
    assert not llm.blocks and llm.runner.block_counts["block"] == 0
    assert sum(n for (kind, d), n in llm.dispatches.items()
               if kind == "decode" and d >= 2) > 0


def test_sampled_blocks_reproducible():
    """Sampled rows in blocks: the same streams run to run."""
    sp = dict(temperature=0.8, top_k=30, max_tokens=12, ignore_eos=True)
    runs = [_generate(_engine(False, **KW, **FLAGS["pipelined_odf"]),
                      PROMPTS, sp) for _ in range(2)]
    assert runs[0] == runs[1]


def test_stop_sets_and_device_stop_ids_match_jax():
    """The per-row stop sets, their width bucket and the min_tokens arming
    sub-step of the first link equal the JAX builder's; a set wider than
    the staging buffer takes raises by name."""
    specs = [dict(stop_token_ids=[9, 4]), dict(ignore_eos=True),
             dict(min_tokens=5, stop_token_ids=[7]),
             dict(stop_token_ids=list(range(10, 20)), min_tokens=1)]
    eos = frozenset({2, 3})
    items, jitems = [], []
    for i, kw in enumerate(specs):
        prompt = list(range(1, 4 + i))
        seq, jseq = (Sequence(i, prompt, gt.SamplingParams(**kw)),
                     JSeq(i, prompt, JSP(**kw)))
        assert seq.device_stop_ids(eos) == jseq.device_stop_ids(eos)
        items.append(ScheduledSeq(seq, 1, len(prompt) + i))
        jitems.append(JSS(jseq, 1, len(prompt) + i))
    builder = BatchBuilder(gt.EngineConfig(max_model_len=64), 4)
    jbuilder = JBuilder(JEC(max_model_len=64), 4)
    jitems = [JSS(it.seq, it.num_new_tokens, it.computed_before)
              for it in jitems]
    got = builder.stop_sets(items, 8, eos)
    want = jbuilder.stop_sets(jitems, 8, eos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (8, 16)
    assert builder.stop_sets(items[1:2], 8, eos) == (None, None)
    wide = Sequence(9, [1, 2], gt.SamplingParams(
        stop_token_ids=list(range(100, 100 + MAX_STOP_IDS))))
    with pytest.raises(ValueError, match="stop set of"):
        builder.stop_sets([ScheduledSeq(wide, 1, 2)], 8, eos)
    llm = _engine(False, num_pages=16, **FLAGS["odf"])
    llm.eos_token_ids = [2]
    with pytest.raises(ValueError, match="stop set of"):
        llm.add_seq(llm._allocate_seq([1, 2], gt.SamplingParams(
            stop_token_ids=list(range(100, 100 + MAX_STOP_IDS)))))


def test_chain_length_resolves_as_jax():
    """``decode_chain_len`` wins over ``multi_step_decode``;
    ``ondevice_finish`` under overlap lifts an unset length to 16; the
    options without overlap form no block (a warning), and
    ``enforce_eager`` clears them all."""
    for kw in (dict(overlap_scheduling=True, multi_step_decode=8),
               dict(overlap_scheduling=True, multi_step_decode=8,
                    decode_chain_len=4),
               dict(overlap_scheduling=True, ondevice_finish=True),
               dict(pipelined_loop=True, ondevice_finish=True),
               dict(overlap_scheduling=True, ondevice_finish=True,
                    multi_step_decode=4),
               dict(ondevice_finish=True),
               dict(decode_chain_len=2),
               dict(multi_step_decode=8),
               dict(enforce_eager=True, overlap_scheduling=True,
                    ondevice_finish=True, decode_chain_len=8)):
        cfg, jcfg = gt.EngineConfig(**kw), JEC(**kw)
        cfg.validate()
        jcfg.validate()
        for f in ("overlap_scheduling", "pipelined_loop", "multi_step_decode",
                  "decode_chain_len", "ondevice_finish"):
            assert getattr(cfg, f) == getattr(jcfg, f), (kw, f)
    with pytest.raises(ValueError, match="decode_chain_len"):
        gt.EngineConfig(overlap_scheduling=True,
                        decode_chain_len=0).validate()


def test_warmup_pins_pages_and_warms_sampled_blocks():
    """Where blocks form, every signature takes the one pinned page
    bucket: ``warmup`` refuses ``page_buckets`` there, and at each
    sequence bucket warms single steps, the mixed pass's step and the
    longest block, each for greedy and for sampled rows, at that bucket
    only."""
    llm = _engine(False, **KW, **FLAGS["pipelined_odf"])
    runner = llm.runner
    pinned = runner.builder.max_pages_per_seq
    assert runner.builder.pin_pages and runner.block_len == 16
    with pytest.raises(ValueError, match="page_buckets"):
        runner.warmup(decode_buckets=(8,), page_buckets=(4, 8))
    assert runner.num_shape_signatures == 0
    runner.warmup(decode_buckets=(8,), block_buckets=(8,))
    keys = runner.graphs.keys
    singles = {k for k in keys if k[0] not in ("block", "mixed")}
    blocks = {k for k in keys if k[0] == "block"}
    mixed = {k for k in keys if k[0] == "mixed"}
    assert {(k[1], k[3], k[4]) for k in singles} == {
        (8, pinned, True), (8, pinned, False)}
    # the mixed pass, at the decode bucket and the pinned page bucket
    assert {(k[2], k[4], k[5]) for k in mixed} == {
        (8, pinned, True), (8, pinned, False)}
    assert {(k[2], k[4], k[5], k[6]) for k in blocks} == {
        (8, pinned, 16, True), (8, pinned, 16, False)}
