"""Sampling completeness of the port's engine against the JAX ``LLM`` on
the CPU at float32, on the same weights and requests: seeded sampled
rows, presence / frequency / repetition penalties on greedy rows,
logit_bias and output and prompt logprobs, under the sync loop and the
absorb flags (streams, dispatches in order and chain breaks equal:
penalized rows break chains as in JAX; logprobs within 1e-4; the extras
steps replay their graph keys), under
host-driven speculation (penalties and the verify rows' logprobs) and
fused speculation (seeded rows), a stop string that trims the logprobs of
a verify step's run and seeded streams that do not depend on their batch
(the DeepSeek and hybrid cases are in test_torch_sampling.py, which
``--dist loadfile`` gives another worker). Then the port's HTTP
server against the JAX server: logprobs in completions (with ``echo``)
and chat, best_of ranking, seed + i over ``n`` choices, logit_bias and
penalties give equal answers (floats within 1e-4)."""

import collections
import functools
import json

import numpy as np
import pytest
import torch

from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.entrypoints import api_server as japi
from gllm_tpu.obs.steptrace import TRACE
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.entrypoints import api_server as tapi

from test_torch_api_server import _start, _strip, request
from test_torch_overlap import _check_drained, _engine
from test_torch_sampling import LP_TOL, _lp_close, _outputs
from test_torch_serving import engines as _tok_engines
from test_torch_spec import FLAGS as SPEC_FLAGS, _watch, _workload

# the smoke's absorb twin's flags at this size: the unified step under the
# pipelined loop with on-device finish and persistent slots, blocks of 4
ABSORB = dict(unified_step=True, pipelined_loop=True, overlap_depth=2,
              ondevice_finish=True, decode_slot_batching=True,
              multi_step_decode=4)
LOOPS = {"sync": {}, "absorb": ABSORB}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(make, flags: tuple):
    """One JAX engine per (factory, flag set), shared by the tests: its
    compiled programs are what a run costs on the CPU."""
    return make(True, **dict(flags))


def _mixed_workload(n=8, seed=0):
    """Prompts of 4..7 tokens; requests mixing seeded sampled rows,
    penalties and logit_bias on greedy rows, logprobs and prompt
    logprobs, and plain greedy and unseeded rows, of 6 tokens each (a
    sequence stays within 16 tokens: one penalty-list bucket; the rows
    finish together: few JAX programs)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, 500, int(rng.integers(4, 8))).tolist()
               for _ in range(n)]
    kinds = [
        dict(temperature=0.8, top_p=0.95, seed=11),
        dict(temperature=0.0, presence_penalty=0.5, frequency_penalty=0.3,
             repetition_penalty=1.2),
        dict(temperature=0.0, logit_bias={7: 100.0}),
        dict(temperature=0.0, logprobs=3, prompt_logprobs=2),
        dict(temperature=0.0),
        dict(temperature=0.7, seed=5, logprobs=2),
        dict(temperature=0.0, repetition_penalty=0.9, logit_bias={3: -5.0,
                                                                   9: 4.0}),
        dict(temperature=0.9, top_k=20, seed=2**31 + 77),
    ]
    return prompts, [dict(kinds[i % len(kinds)], max_tokens=6,
                          ignore_eos=True) for i in range(n)]


def _run(llm, prompts, sps):
    """Generate; returns each sequence's (tokens, finish reason, output
    logprobs, prompt logprobs) and the chain breaks by reason (the JAX
    engine's from its ``chain_break`` trace events)."""
    jax_side = isinstance(llm, JLLM)
    SP = JSP if jax_side else gt.SamplingParams
    mark = TRACE.mark()
    breaks0 = collections.Counter(getattr(llm, "chain_breaks", {}))
    seqs = [llm._allocate_seq(list(p), SP(**sp))
            for p, sp in zip(prompts, sps)]
    for seq in seqs:
        llm.add_seq(seq)
    while llm.has_unfinished:
        llm.step()
    if jax_side:
        breaks = collections.Counter(
            e["reason"] for e in TRACE.events(since=mark)
            if e["kind"] == "chain_break")
    else:
        breaks = collections.Counter(llm.chain_breaks) - breaks0
        _check_drained(llm)
    return [(s.output_token_ids, s.finish_reason, s.output_logprobs,
             s.prompt_logprobs) for s in seqs], dict(breaks)


def _against_jax(make, flags, prompts, sps, **kw):
    """The port's engine and the shared JAX one under ``flags``: streams,
    chain breaks and dispatches in order (``test_torch_spec``'s
    ``_watch``) equal, logprobs within LP_TOL. Returns the port's engine
    and its streams."""
    port = make(False, **kw, **flags)
    jax_llm = _jax(make, tuple(sorted(dict(kw, **flags).items())))
    seen, jseen = _watch(port), _watch(jax_llm)
    got, breaks = _run(port, prompts, sps)
    want, jbreaks = _run(jax_llm, prompts, sps)
    assert seen == jseen                          # dispatches, in order
    assert breaks == jbreaks                      # chain breaks by reason
    for g, w in zip(got, want):
        assert g[:2] == w[:2]                     # streams
        _lp_close(g[2], w[2])
        _lp_close(g[3], w[3])
    return port, [g[:2] for g in got]


@pytest.mark.parametrize("loop", list(LOOPS))
def test_extras_streams_and_logprobs_match_jax(loop):
    prompts, sps = _mixed_workload()
    port, streams = _against_jax(_engine, LOOPS[loop], prompts, sps)
    # the +100 bias wins every step; the penalized and biased decode
    # steps replayed their extras keys, and so did the mixed steps with
    # extras (the absorbs' among them): none ran eagerly
    assert set(streams[2][0]) == {7}
    assert port.step_counts["extras"] > 0
    by = port.runner.graphs.by_kind
    assert by["decode_extras"]["replays"] == port.step_counts["extras"]
    assert by["mixed_extras"]["replays"] > 0
    assert sum(port.runner.eager_mixed.values()) == 0
    if loop == "absorb":
        # penalized rows break the chains ...
        assert port.chain_breaks["shape"] > 0
        # ... and seeded rows ride blocks (their output index advances a
        # sub-step on the device)
        seeded = [dict(temperature=0.8 if i % 2 else 0.0, top_p=0.9,
                       seed=40 + i, max_tokens=sp["max_tokens"],
                       ignore_eos=True) for i, sp in enumerate(sps)]
        port, _ = _against_jax(_engine, LOOPS[loop], prompts, seeded)
        assert sum(port.blocks.values()) > 0


def _spec_workload():
    """test_torch_spec's workload, four requests of at most 14 tokens."""
    prompts, maxs = _workload()
    return prompts[:4], [min(m, 14) for m in maxs[:4]]


def test_spec_host_penalties_and_verify_logprobs_match_jax():
    prompts, maxs = _spec_workload()
    sps = [dict(temperature=0.0, max_tokens=m, ignore_eos=True,
                **(dict(presence_penalty=0.4, repetition_penalty=1.1,
                        logprobs=2) if i % 2
                   else dict(logit_bias={5: 3.0}, logprobs=1)))
           for i, m in enumerate(maxs)]
    port, _ = _against_jax(_engine, SPEC_FLAGS["host"], prompts, sps)
    assert port.verify_steps > 0
    assert port.scheduler.spec_stats["accepted"] > 0


def test_spec_fused_seeded_rows_match_jax():
    prompts, maxs = _spec_workload()
    sps = [dict(temperature=0.8 if i % 2 else 0.0, top_p=0.95,
                seed=100 + i, max_tokens=m, ignore_eos=True)
           for i, m in enumerate(maxs)]
    port, _ = _against_jax(_engine, SPEC_FLAGS["fused"], prompts, sps)
    assert sum(port.blocks.values()) > 0
    assert port.scheduler.spec_stats["accepted"] > 0


def test_stop_string_trims_the_logprobs_of_a_verify_run():
    """Host-driven speculation commits a run of tokens at once; a stop
    string inside the run cuts the tokens after it and their logprobs,
    as in JAX: text, tokens and logprobs equal, one logprob a token."""
    prompts, maxs = _workload()
    free = _outputs(_tok_engines(False, eos=()), prompts,
                    [dict(temperature=0.0, max_tokens=m, ignore_eos=True)
                     for m in maxs])
    tok = _tok_engines(False, eos=()).tokenizer
    sps = [dict(temperature=0.0, max_tokens=m, logprobs=2,
                stop=[tok.decode(ids[6:8])] if i % 2 else [])
           for i, ((ids, *_), m) in enumerate(zip(free, maxs))]
    got_llm = _tok_engines(False, eos=(), **SPEC_FLAGS["host"])
    want_llm = _tok_engines(True, eos=(), **SPEC_FLAGS["host"])
    SP = gt.SamplingParams
    got = got_llm.generate(prompt_token_ids=prompts,
                           sampling_params=[SP(**sp) for sp in sps])
    want = want_llm.generate(prompt_token_ids=prompts,
                             sampling_params=[JSP(**sp) for sp in sps])
    stopped = 0
    for g, w in zip(got, want):
        assert (g.output_token_ids, g.text, g.finish_reason) == (
            w.output_token_ids, w.text, w.finish_reason)
        assert len(g.logprobs) == len(g.output_token_ids)
        _lp_close(g.logprobs, w.logprobs)
        stopped += g.finish_reason == "stop"
    assert stopped >= 2 and got_llm.verify_steps > 0


def test_seeded_streams_do_not_depend_on_the_batch():
    """A seeded sampled request alone, and beside seven others in another
    order, gives the same tokens (float32), as the JAX package's does."""
    prompts, sps = _mixed_workload()
    llm = _engine(False)
    alone = _outputs(llm, prompts[:1], sps[:1])[0][0]
    together = _outputs(llm, prompts[::-1], sps[::-1])[-1][0]
    assert alone == together
    assert alone == _outputs(_jax(_engine, ()), prompts[:1], sps[:1])[0][0]


# ---- the HTTP server --------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    """One JAX server and one port server on the same weights."""
    both = [_start(_tok_engines(False), tapi),
            _start(_tok_engines(True), japi)]
    yield [h.server_address[1] for h in both]
    for h in both:
        h.shutdown()
        h.state.engine.shutdown()
        h.server_close()


SERVER_REQUESTS = {
    "completion_logprobs": ("/v1/completions", {
        "prompt": [5, 17, 93, 41], "max_tokens": 6, "temperature": 0,
        "ignore_eos": True, "logprobs": 3}),
    "echo_prompt_logprobs": ("/v1/completions", {
        "prompt": "hello there", "max_tokens": 5, "temperature": 0,
        "ignore_eos": True, "echo": True, "prompt_logprobs": 1,
        "logprobs": 2}),
    "chat_logprobs": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "say something"}],
        "max_tokens": 6, "temperature": 0, "ignore_eos": True,
        "logprobs": True, "top_logprobs": 2}),
    "best_of": ("/v1/completions", {
        "prompt": [44, 2, 18], "max_tokens": 6, "temperature": 0.9,
        "ignore_eos": True, "seed": 21, "best_of": 3, "n": 1}),
    "seed_n2": ("/v1/completions", {
        "prompt": [9, 9, 3], "max_tokens": 6, "temperature": 0.9,
        "ignore_eos": True, "seed": 4, "n": 2}),
    "logit_bias_penalties": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "bias"}],
        "max_tokens": 6, "temperature": 0, "ignore_eos": True,
        "logit_bias": {"65": 100}, "presence_penalty": 0.5,
        "frequency_penalty": 0.5}),
}


def _close(got, want, path="$"):
    """Equal JSON, floats within LP_TOL."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= LP_TOL, path
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


@pytest.mark.parametrize("name", list(SERVER_REQUESTS))
def test_server_sampling_answers_match_jax(servers, name):
    port, jport = servers
    path, req = SERVER_REQUESTS[name]
    answers = []
    for p in (port, jport):
        status, data = request(p, "POST", path, req)
        assert status == 200, data
        answers.append(_strip(json.loads(data)))
    got, want = answers
    _close(got, want)
    choices = got["choices"]
    assert len(choices) == req.get("n", 1)
    if name == "completion_logprobs":
        lp = choices[0]["logprobs"]
        assert len(lp["tokens"]) == len(lp["token_logprobs"]) == 6
        # top ids that decode to one character share a key
        assert all(1 <= len(t) <= 3 for t in lp["top_logprobs"])
    if name == "echo_prompt_logprobs":
        lp = choices[0]["logprobs"]
        assert choices[0]["text"].startswith("hello there")
        # the prompt's 11 tokens (the first without a logprob), then 5
        assert len(lp["tokens"]) == 16 and lp["token_logprobs"][0] is None
    if name == "chat_logprobs":
        content = choices[0]["logprobs"]["content"]
        assert len(content) == 6
        assert all(len(c["top_logprobs"]) == 2 for c in content)
    if name == "logit_bias_penalties":
        assert set(choices[0]["message"]["content"]) == {"A"}
    if name == "seed_n2":
        assert choices[0]["text"] != choices[1]["text"]
        # a repeated seeded request repeats its answer
        status, again = request(port, "POST", path, req)
        assert [c["text"] for c in json.loads(again)["choices"]] == [
            c["text"] for c in choices]
