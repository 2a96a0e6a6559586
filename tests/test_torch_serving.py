"""The serving engine of the PyTorch port on the CPU at float32, held
against the JAX package's: the metrics registry (the same observations
give the same exposition text; every metric the port registers is in
JAX's registry with the same type, labels and buckets), the incremental
detokenizer (with its hold-back of a partial character), stop strings
(through the sync loop and under blocks with on-device finish, where a
sequence with stop strings still commits one token a step), greedy
streams through both ``ServingEngine``s under the sync loop and under the
absorb flags, deadlines, the resident limit, a draining shutdown, and the
quarantine of a step that fails with two entries in flight: the same
sequences end in error chunks, the others finish as in JAX, and no page
leaks. Then the port alone: a launch that raises (a block with a join,
behind an entry in flight) is quarantined with its rows, the unhealthy
latch, and the watchdog's readiness flip."""

import collections
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine import detokenizer as jdetok
from gllm_tpu.engine import serving_engine as jse
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.faults import FAULTS
from gllm_tpu.models import dense as jdense
from gllm_tpu.models.config import ModelConfig as JMC
from gllm_tpu.obs import metrics as jobs
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.engine import detokenizer as tdetok
from gllm_tpu_torch.engine import serving_engine as tse
from gllm_tpu_torch.models import convert
from gllm_tpu_torch.obs import metrics as tobs

from test_torch_engine import MODEL

# the unified step under overlap with persistent slots and blocks of 4
# under on-device finish (the smoke's absorb twin, at K 4)
ABSORB = dict(pipelined_loop=True, unified_step=True,
              decode_slot_batching=True, ondevice_finish=True,
              decode_chain_len=4)
BLOCKS = dict(pipelined_loop=True, ondevice_finish=True, decode_chain_len=4)


class StubTokenizer:
    """tests/test_api_server.py's: a token is one character (its id mod
    127, at least a space), and a text encodes to its characters' codes
    (at most 120)."""
    eos_token_id = 0

    def encode(self, text):
        return [min(ord(c), 120) for c in text][:64]

    def decode(self, ids, skip_special_tokens=False):
        return "".join(chr(max(32, i % 127)) for i in ids)

    def apply_chat_template(self, messages, add_generation_prompt=True,
                            **kw):
        text = " ".join(str(m.get("content", "")) for m in messages)
        return self.encode(text or "hi")


class ByteTokenizer:
    """A token is one byte of UTF-8: a character of several bytes decodes
    to the replacement character until its last byte arrives."""

    def decode(self, ids, skip_special_tokens=False):
        return bytes(i % 256 for i in ids).decode("utf-8", errors="replace")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    params = jdense.init_params(JMC(**MODEL), seed=3, dtype=jnp.float32)
    return params, convert.from_jax_params(jax.tree.map(np.asarray, params))


def engines(jax_side, *, num_pages=128, max_seqs=8, eos=None, **flags):
    """The JAX LLM or the port's on the same float32 weights, with the
    stub tokenizer (EOS 0 unless ``eos``), ``max_seqs`` sequences a batch,
    4-token pages and the options in ``flags``."""
    jparams, tparams = _params()
    if jax_side:
        llm = JLLM(config=JEC(
            dtype="float32", attention_impl="xla", max_model_len=256,
            max_num_seqs=max_seqs,
            scheduler=JSC(max_prefill_tokens=32, max_decode_seqs=max_seqs),
            cache=JCC(page_size=4, num_pages=num_pages), **flags),
            model_cfg=JMC(**MODEL), params=jparams,
            tokenizer=StubTokenizer())
    else:
        llm = gt.LLM(config=gt.EngineConfig(
            dtype="float32", max_model_len=256, max_num_seqs=max_seqs,
            scheduler=gt.SchedulerConfig(max_prefill_tokens=32,
                                         max_decode_seqs=max_seqs),
            cache=gt.CacheConfig(page_size=4, num_pages=num_pages),
            **flags), model_cfg=gt.ModelConfig(**MODEL), params=tparams,
            tokenizer=StubTokenizer(), device="cpu")
    if eos is not None:
        llm.eos_token_ids = frozenset(eos)
    return llm


def _prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=int(k)).tolist()
            for k in rng.integers(3, 40, size=n)]


def collect(handle, timeout=60.0):
    """A handle's chunks, with a wall-clock guard (a hung stream fails
    the test, not the suite)."""
    out, box = [], {}

    def run():
        try:
            out.extend(handle)
        except Exception as e:  # pragma: no cover - raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "stream never terminated"
    if "err" in box:
        raise box["err"]
    return out


def wait_until(cond, timeout=30.0, what="condition"):
    limit = time.monotonic() + timeout
    while time.monotonic() < limit:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def submit_together(eng, reqs):
    """Submit every request before the engine thread admits the first, so
    that both packages' engines see one intake and schedule alike: the
    engine's ``add_seq`` waits until all are in the intake queue."""
    llm, go = eng.llm, threading.Event()
    add = llm.add_seq

    def gated(seq):
        go.wait(10)
        add(seq)
    llm.add_seq = gated
    try:
        handles = [eng.submit(list(ids), sp) for ids, sp in reqs]
    finally:
        go.set()
    return handles


def drained(llm):
    mm = llm.memory_manager
    return (not llm.has_unfinished
            and mm.num_free_pages == mm.allocator.num_total)


def _chunks(chunks):
    return [(c.token_id, c.text, c.finish_reason, c.num_output_tokens)
            for c in chunks]


# ---- metrics --------------------------------------------------------------

def _observe(m):
    reg = m.Registry()
    c = m.counter("t_requests_total", "requests by reason", ("reason",),
                  registry=reg)
    g = m.gauge("t_util", "a gauge\nwith a newline", ("dp",), registry=reg)
    h = m.histogram("t_latency_seconds", "latency", registry=reg)
    f = m.histogram("t_itl_seconds", "inter-token", ("kind",),
                    buckets=m.FAST_LATENCY_BUCKETS, registry=reg)
    for i, v in enumerate([0.0004, 0.003, 0.02, 0.4, 7.0, 200.0, 0.01]):
        h.observe(v)
        f.observe(v / 3, kind="a" if i % 2 else 'b"q')
        c.inc(i, reason="length" if i % 3 else "stop")
    g.set(0.25, dp=0)
    g.inc(0.5, dp=0)
    snap = h.snapshot()
    h.observe(0.05)
    return reg, h, snap


def test_metrics_exposition_identical_to_jax():
    (treg, th, tsnap), (jreg, jh, jsnap) = _observe(tobs), _observe(jobs)
    assert treg.render() == jreg.render()
    assert tobs.parse_exposition(treg.render()) == \
        jobs.parse_exposition(jreg.render())
    assert tobs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS
    assert tobs.FAST_LATENCY_BUCKETS == jobs.FAST_LATENCY_BUCKETS
    for q in (0.5, 0.9, 0.99):
        assert tobs.percentile(th, q) == jobs.percentile(jh, q)
        assert tobs.percentile(th, q, before=tsnap) == \
            jobs.percentile(jh, q, before=jsnap)
    with pytest.raises(ValueError):
        tobs.counter("t_requests_total", "other labels", ("kind",),
                     registry=treg)


def test_port_metrics_exist_in_jax_registry():
    """Every metric the port registers (engine, scheduler, serving engine)
    is in the JAX package's registry with the same type, labels, buckets
    and help."""
    import gllm_tpu.scheduler  # noqa: F401 (registers its metrics)
    import gllm_tpu_torch.scheduler  # noqa: F401
    assert jse is not None and tse is not None
    ported = tobs.REGISTRY.metrics()
    assert len(ported) >= 29
    for m in ported:
        j = jobs.REGISTRY.get(m.name)
        assert j is not None, m.name
        assert (j.kind, j.labelnames, j.help) == (m.kind, m.labelnames,
                                                  m.help), m.name
        assert getattr(j, "buckets", None) == getattr(m, "buckets", None)


# ---- detokenizer ----------------------------------------------------------

@pytest.mark.parametrize("text", ["plain words", "naïve café",
                                  "日本語のテキスト", "emoji 🙂 done"])
def test_detokenizer_matches_jax_with_hold_back(text):
    tok = ByteTokenizer()
    ids = list(b"prompt: ") + list(text.encode())
    outs = []
    for mod in (tdetok, jdetok):
        p, r, emitted, steps = 2, 8, "", []
        for end in range(9, len(ids) + 1):
            new, p, r = mod.detokenize_incrementally(tok, ids, p, r,
                                                     end=end)
            emitted += new
            steps.append((new, p, r))
        outs.append((emitted, steps))
    assert outs[0] == outs[1]
    emitted, steps = outs[0]
    assert emitted == text
    if len(text.encode()) > len(text):
        # a character of several bytes is held back until it completes
        assert any(s[0] == "" for s in steps)
        assert tdetok.REPLACEMENT not in emitted


# ---- stop strings ---------------------------------------------------------

def _stop_run(llm, SP, prompts, stops):
    sps = [SP(temperature=0.0, max_tokens=24, stop=list(s)) if s
           else SP(temperature=0.0, max_tokens=24, ignore_eos=True)
           for s in stops]
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=sps)
    return [(o.output_token_ids, o.text, o.finish_reason) for o in outs]


@pytest.mark.parametrize("flags", [{}, BLOCKS], ids=["sync", "blocks"])
def test_stop_strings_identical_to_jax(flags):
    """Stop strings picked from the greedy texts: one a single character,
    one that spans two tokens, one that never occurs; the other requests
    run without (under ``BLOCKS`` they ride blocks of 4 beside the
    single-step rows of the ones with stop strings)."""
    prompts = _prompts(6)
    free = _stop_run(engines(False, eos=()), gt.SamplingParams, prompts,
                     [()] * 6)
    stops = [(free[0][1][5],), (free[1][1][7:9],), ("@@never@@",), (),
             (free[4][1][3:5], "zz"), ()]
    got = _stop_run(engines(False, eos=(), **flags), gt.SamplingParams,
                    prompts, stops)
    want = _stop_run(engines(True, eos=(), **flags), JSP, prompts, stops)
    assert got == want
    reasons = [r for _, _, r in got]
    assert reasons.count("stop") >= 3 and "length" in reasons
    for (ids, text, reason), s, (fids, ftext, _) in zip(got, stops, free):
        if reason == "stop":
            # the text is cut before the match, the tokens after the one
            # that completed it are gone
            assert not any(x in text for x in s)
            assert ftext.startswith(text) and fids[:len(ids)] == ids
            assert any(x in ftext[:len(ids)] for x in s)


def test_stop_string_rows_commit_one_token_a_step():
    """The stop-string check handles one committed token of a sequence at
    a time: a sequence with stop strings rides no block, so it never
    commits several tokens in one step, while the requests without stop
    strings ride blocks."""
    prompts = _prompts(6)
    llm = engines(False, eos=(), **BLOCKS)
    free = _stop_run(engines(False, eos=()), gt.SamplingParams, prompts,
                     [()] * 6)
    stops = [(free[0][1][9],), (), ("@@never@@",), (), (free[4][1][3:5],),
             ()]
    check, widest = llm._check_stop_strings, [0]

    def counted(outs):
        per_seq = collections.Counter(
            o.seq.seq_id for o in outs
            if o.new_token_id is not None and o.seq.sampling_params.stop)
        widest[0] = max([widest[0], *per_seq.values()])
        return check(outs)
    llm._check_stop_strings = counted
    got = _stop_run(llm, gt.SamplingParams, prompts, stops)
    assert widest[0] == 1
    assert llm.blocks
    assert [r for _, _, r in got].count("stop") >= 2


# ---- the serving engine ---------------------------------------------------

def _serve(jax_side, reqs, **flags):
    llm = engines(jax_side, **flags)
    eng = (jse if jax_side else tse).ServingEngine(llm)
    try:
        handles = submit_together(eng, reqs)
        streams = [_chunks(collect(h)) for h in handles]
        wait_until(lambda: drained(llm), what="engine idle, pages back")
    finally:
        eng.shutdown()
    return streams, llm


@pytest.mark.parametrize("flags", [{}, ABSORB], ids=["sync", "absorb"])
def test_serving_streams_identical_to_jax(flags):
    """The same requests (greedy, lengths, EOS and a stop string) through
    both serving engines: the same chunks, token by token, with the same
    texts, finish reasons and counts."""
    prompts = _prompts(6, seed=1)
    maxes = [5, 17, 9, 3, 12, 8]

    def reqs(SP):
        return [(p, SP(temperature=0.0, max_tokens=m, ignore_eos=i % 2 == 0,
                       stop=["q"] if i == 3 else []))
                for i, (p, m) in enumerate(zip(prompts, maxes))]
    got, port = _serve(False, reqs(gt.SamplingParams), **flags)
    want, _ = _serve(True, reqs(JSP), **flags)
    assert got == want
    for s, m in zip(got, maxes):
        assert s[-1][2] is not None and s[-1][3] <= m
        # one chunk a token; a block's tokens go out together, each chunk
        # with the count at delivery
        assert s[-1][3] == len(s) and all(c[0] is not None for c in s)
    if flags:
        assert port.blocks and port.config.pipelined_loop


def _fail_collect_at(llm, n):
    """The port's collect raises at its ``n``-th call (0-based), as JAX's
    ``step_exception`` fault point fires before its ``n``-th collect."""
    collect_, calls = llm.runner.collect, [0]

    def failing(handle):
        calls[0] += 1
        if calls[0] == n + 1:
            raise RuntimeError("injected step failure")
        return collect_(handle)
    llm.runner.collect = failing


def test_quarantine_with_two_entries_in_flight_as_jax():
    """A step fails at the same collect in both packages, with two entries
    in flight (overlap scheduling at depth 2): the sequences of both
    entries get error chunks, the others finish with JAX's tokens, the
    engine returns to idle and every page comes back."""
    prompts = _prompts(6, seed=2)

    def reqs(SP):
        return [(p, SP(temperature=0.0, max_tokens=10, ignore_eos=True))
                for p in prompts]
    flags = dict(overlap_scheduling=True, max_seqs=2)
    fail_at = 6
    res = []
    for jax_side in (False, True):
        llm = engines(jax_side, **flags)
        depths = []
        if jax_side:
            FAULTS.arm(f"step_exception:{fail_at}:1")
            eng = jse.ServingEngine(llm)
        else:
            _fail_collect_at(llm, fail_at)
            eng = tse.ServingEngine(llm)
        quarantine = llm.quarantine_step_failure

        def watched(*a, **kw):
            depths.append(len(llm._in_flight))
            return quarantine(*a, **kw)
        llm.quarantine_step_failure = watched
        try:
            handles = submit_together(
                eng, reqs(JSP if jax_side else gt.SamplingParams))
            streams = [_chunks(collect(h)) for h in handles]
            wait_until(lambda: drained(llm), what="engine idle")
            assert eng.readiness() == (True, "ok")
        finally:
            eng.shutdown()
            FAULTS.reset()
        assert depths == [2]
        res.append(streams)
    got, want = res
    assert [s[-1][2] for s in got] == [s[-1][2] for s in want]
    # the two entries in flight are chained steps of the same two rows
    errors = [i for i, s in enumerate(got) if s[-1][2] == "error"]
    assert len(errors) == 2, errors
    for i, (g, w) in enumerate(zip(got, want)):
        if i in errors:
            assert [c[:2] for c in g[:-1]] == [c[:2] for c in w[:-1]]
        else:
            assert g == w and g[-1][2] == "length"


def test_deadline_resident_limit_and_drain_as_jax():
    res = []
    for jax_side in (False, True):
        mod = jse if jax_side else tse
        SP = JSP if jax_side else gt.SamplingParams
        long = SP(temperature=0.0, max_tokens=200, ignore_eos=True)
        # a deadline in the waiting queue: one sequence at a time
        llm = engines(jax_side, max_seqs=1)
        eng = mod.ServingEngine(llm)
        before = mod._M_DEADLINE.get()
        try:
            ha = eng.submit([5, 17, 93, 41], long)
            hb = eng.submit([8, 2, 8, 1],
                            SP(temperature=0.0, max_tokens=8, ignore_eos=True,
                               deadline_s=0.1))
            b = collect(hb)
            a = collect(ha)
            wait_until(lambda: drained(llm), what="pages back")
        finally:
            eng.shutdown()
        out = [(b[-1].finish_reason, len(b), a[-1].finish_reason,
                mod._M_DEADLINE.get() - before)]
        # the resident limit
        llm = engines(jax_side, max_resident_requests=1)
        eng = mod.ServingEngine(llm)
        try:
            ha = eng.submit([5, 17, 93, 41], long)
            with pytest.raises(mod.RequestRejected) as ei:
                eng.submit([5, 17], long)
            out.append((ei.value.status, ei.value.reason))
            eng.abort(ha.seq_id)
            out.append(collect(ha)[-1].finish_reason)
            wait_until(lambda: not eng._handles, what="handle reaped")
            hc = eng.submit([5, 17], SP(temperature=0.0, max_tokens=4,
                                        ignore_eos=True))
            out.append(_chunks(collect(hc)))
            wait_until(lambda: drained(llm), what="pages back")
        finally:
            eng.shutdown()
        # a draining shutdown lets a request in flight finish, then admits
        # nothing
        llm = engines(jax_side)
        eng = mod.ServingEngine(llm)
        h = eng.submit([3, 4, 5], SP(temperature=0.0, max_tokens=12,
                                     ignore_eos=True))
        eng.shutdown(drain=True, timeout=30)
        out.append(_chunks(collect(h)))
        with pytest.raises(mod.RequestRejected) as ei:
            eng.submit([3], long)
        out.append((ei.value.status, ei.value.reason))
        res.append(out)
    assert res[0] == res[1]
    assert res[0][0] == ("deadline", 1, "length", 1)
    assert res[0][1] == (429, "resident_limit") and res[0][2] == "abort"
    assert res[0][4][-1][2] == "length" and res[0][5] == (503, "draining")


def test_quarantine_reaches_a_launch_that_raises():
    """A block launch raises (as a graph first met while serving may fail
    to capture) on a chained dispatch with a joined row, behind two
    entries in flight. The joined row was in no entry in flight, yet its
    stream ends in an error chunk as theirs do, every page comes back and
    the engine serves the next request."""
    flags = dict(overlap_scheduling=True, decode_slot_batching=True,
                 chain_under_prefill=8, overlap_depth=3, multi_step_decode=8)
    llm = engines(False, max_seqs=16, **flags)
    rng = np.random.default_rng(7)
    sp = [gt.SamplingParams(temperature=0.0, max_tokens=m, ignore_eos=True)
          for m in (40, 40, 40, 3, 10)]
    prompts = [rng.integers(1, 120, size=n).tolist()
               for n in (8, 9, 10, 5, 6)]
    # the late request reaches the scheduler on the engine thread right
    # after the step in which the quick one finished, so that it joins
    # that one's hole
    add, step, held, quick = llm.add_seq, llm.step, [], []

    def add_seq(seq):
        if seq.prompt_len == 5:
            quick.append(seq)
        if seq.prompt_len == 6:
            held.append(seq)
        else:
            add(seq)

    def stepped():
        outs = step()
        if held and quick[0].finish_reason is not None:
            add(held.pop())
        return outs
    llm.add_seq, llm.step = add_seq, stepped
    step_multi, failed = llm.runner.step_multi, {}

    def launch(chain, *prev):
        if chain[0].host_rows and not failed:
            failed["joined"] = [chain[0].items[r].seq.seq_id
                                for r in chain[0].host_rows]
            failed["depth"] = len(llm._in_flight)
            raise RuntimeError("graph capture failed")
        return step_multi(chain, *prev)
    llm.runner.step_multi = launch
    eng = tse.ServingEngine(llm)
    try:
        handles = submit_together(eng, zip(prompts, sp))
        streams = [collect(h) for h in handles]
        assert failed["depth"] == 2
        assert failed["joined"] == [handles[4].seq_id]
        ends = [s[-1].finish_reason for s in streams]
        assert ends == ["error"] * 3 + ["length", "error"], ends
        assert "graph capture failed" in streams[4][-1].error
        wait_until(lambda: drained(llm), what="every page back")
        assert eng.readiness() == (True, "ok")
        after = collect(eng.submit([5, 17, 93], sp[4]))
        assert after[-1].finish_reason == "length" and len(after) == 10
        wait_until(lambda: drained(llm), what="every page back")
    finally:
        eng.shutdown()


def test_unhealthy_latch_and_watchdog():
    """Two failed steps in a row latch the engine unhealthy (readiness
    off, submits refused with 503, liveness on); a step that blocks past
    ``watchdog_stall_s`` turns readiness off until it returns."""
    llm = engines(False, max_step_failures=2)
    llm.runner.collect = lambda handle: (_ for _ in ()).throw(
        RuntimeError("device fault"))
    eng = tse.ServingEngine(llm)
    sp = gt.SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
    try:
        first = collect(eng.submit([5, 17, 93], sp))
        assert first[-1].finish_reason == "error"
        assert "device fault" in first[-1].error
        assert eng.readiness() == (True, "ok")
        assert collect(eng.submit([5, 17, 93], sp))[-1].finish_reason \
            == "error"
        assert eng.readiness() == (False, "unhealthy") and eng.is_alive
        with pytest.raises(tse.RequestRejected) as ei:
            eng.submit([5], sp)
        assert ei.value.status == 503
        assert tse._M_UNHEALTHY_REASON.get(reason="step_failures") == 1
        mm = llm.memory_manager
        assert mm.num_free_pages == mm.allocator.num_total
    finally:
        eng.shutdown()
    llm = engines(False, watchdog_stall_s=0.25)
    eng = tse.ServingEngine(llm)
    try:
        collect(eng.submit([5, 17, 93], sp))
        wait_until(lambda: eng.readiness() == (True, "ok"), what="ready")
        collect_ = llm.runner.collect

        def slow(handle):
            llm.runner.collect = collect_
            time.sleep(1.2)
            return collect_(handle)
        llm.runner.collect = slow
        h = eng.submit([5, 17, 93], sp)
        wait_until(lambda: eng.readiness() == (False, "stalled"),
                   timeout=5, what="the watchdog's flip")
        wait_until(lambda: eng.readiness() == (True, "ok"), timeout=10,
                   what="readiness back")
        assert collect(h)[-1].finish_reason == "length"
    finally:
        eng.shutdown()
