"""The port's OpenAI-compatible HTTP server on the CPU at float32, held
against the JAX package's server on the same weights and stub tokenizer:
the same requests (a token-array completion, a stream, ``n = 2``, a text
prompt, a chat with ``stop``, a chat with ``tools``) give equal bodies and
SSE chunk texts, once ids and timestamps are stripped, and equal usage.
Then the port alone: a disconnect aborts its request with no page leaked,
the sampling options once refused are served in OpenAI's shape (best_of
above n ranked) and the unported route 404s, ``/steptrace`` (``since``,
``kind``, 400 on a bad ``since``) and ``/trace`` serve the step-trace ring
and the request spans, ``POST /profile`` writes a trace and refuses a
second capture with 409, ``--no-tracing`` turns the spans off with the
same streams,
``/metrics`` parses and its TTFT count follows the finished requests, the
unhealthy latch turns ``/readyz`` to 503, the profiler writes a trace, the
CLI's flags build the options JAX's build, and ``python -m
gllm_tpu_torch.entrypoints.api_server`` serves on the CPU and exits on
SIGTERM."""

import dataclasses
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from gllm_tpu.entrypoints import api_server as japi

import gllm_tpu_torch as gt
from gllm_tpu_torch.engine import serving_engine as tse
from gllm_tpu_torch.entrypoints import api_server as tapi
from gllm_tpu_torch.obs import metrics as tobs

from test_torch_serving import engines, one_thread, wait_until  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _start(llm, mod):
    httpd = mod.serve(llm, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module")
def servers():
    """One JAX server and one port server on the same weights."""
    port_llm, jax_llm = engines(False), engines(True)
    both = [_start(port_llm, tapi), _start(jax_llm, japi)]
    yield [h.server_address[1] for h in both], port_llm
    for h in both:
        h.shutdown()
        h.state.engine.shutdown()
        h.server_close()


def request(port, method, path, body=None, raw=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    if raw:
        return resp.status, data, headers
    return resp.status, data


def _strip(d):
    """A response or chunk without its id and timestamp."""
    return {k: v for k, v in d.items() if k not in ("id", "created")}


def _body(port, path, req):
    status, data = request(port, "POST", path, req)
    assert status == 200, data
    if not req.get("stream"):
        return _strip(json.loads(data))
    events = [e[6:] for e in data.decode().split("\n\n")
              if e.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [_strip(json.loads(e)) for e in events[:-1]]
    # the choices of an n > 1 stream interleave as their threads deliver:
    # compared choice by choice
    return sorted(chunks, key=lambda c: c["choices"][0]["index"])


TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}}}}}]
REQUESTS = {
    "token_array": ("/v1/completions", {
        "prompt": [5, 17, 93, 41], "max_tokens": 6, "temperature": 0,
        "ignore_eos": True}),
    "stream": ("/v1/completions", {
        "prompt": [9, 9, 3, 77, 120], "max_tokens": 7, "temperature": 0,
        "ignore_eos": True, "stream": True}),
    "n2": ("/v1/completions", {
        "prompt": [44, 2, 18], "max_tokens": 5, "temperature": 0,
        "ignore_eos": True, "n": 2}),
    "n2_stream": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "two of them"}],
        "max_tokens": 4, "temperature": 0, "ignore_eos": True, "n": 2,
        "stream": True}),
    "text": ("/v1/completions", {
        "prompt": "hello there", "max_tokens": 8, "temperature": 0}),
    "chat_stop": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "say something"}],
        "max_tokens": 24, "temperature": 0, "stop": ["e", "r"]}),
    "chat_stop_stream": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "say something"}],
        "max_tokens": 24, "temperature": 0, "stop": ["e", "r"],
        "stream": True}),
    "chat_tools": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "weather in Paris?"}],
        "max_tokens": 10, "temperature": 0, "tools": TOOLS}),
    "chat_tools_stream": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "weather in Paris?"}],
        "max_tokens": 10, "temperature": 0, "tools": TOOLS,
        "stream": True}),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_bodies_identical_to_jax(servers, name):
    (port, jport), _ = servers
    path, req = REQUESTS[name]
    got, want = _body(port, path, req), _body(jport, path, req)
    assert got == want
    if not req.get("stream"):
        assert got["usage"]["completion_tokens"] > 0
        assert len(got["choices"]) == req.get("n", 1)
    if name == "chat_stop":
        assert got["choices"][0]["finish_reason"] == "stop"
        assert got["usage"]["completion_tokens"] < req["max_tokens"]


def test_disconnect_aborts_with_no_page_leaked(servers):
    """A client that closes its stream after 4 chunks: the server's next
    writes fail, the request is aborted, and every page comes back."""
    import socket
    (port, _), llm = servers
    aborted = tse._M_ABORTED.get()
    finished = tobs.REGISTRY.get("gllm_requests_finished_total")
    f0 = finished.get(reason="length")
    body = json.dumps({"prompt": [3, 1, 4, 1, 5], "max_tokens": 240,
                       "temperature": 0, "ignore_eos": True,
                       "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\nContent-Length: "
                 + str(len(body)).encode() + b"\r\n\r\n" + body)
    buf = b""
    while buf.count(b"data: ") < 4:
        buf += sock.recv(4096)
    sock.close()
    wait_until(lambda: tse._M_ABORTED.get() == aborted + 1,
               what="the abort")
    mm = llm.memory_manager
    wait_until(lambda: (not llm.has_unfinished
                        and mm.num_free_pages == mm.allocator.num_total),
               what="pages back")
    assert finished.get(reason="length") == f0


@pytest.mark.parametrize("field,value", [("logprobs", 2), ("seed", 7),
                                         ("presence_penalty", 0.5)])
def test_unported_options_get_400(servers, field, value):
    """The options once refused with 400 are served: 200 in OpenAI's
    shape (logprobs: tokens, token_logprobs, top_logprobs of 2 and text
    offsets, one a token)."""
    (port, _), _ = servers
    status, data = request(port, "POST", "/v1/completions", {
        "prompt": [5, 6], "max_tokens": 3, "ignore_eos": True,
        field: value})
    assert status == 200, data
    body = json.loads(data)
    assert body["object"] == "text_completion"
    choice, = body["choices"]
    assert body["usage"]["completion_tokens"] == 3
    lp = choice["logprobs"]
    if field != "logprobs":
        assert lp is None
        return
    assert set(lp) == {"tokens", "token_logprobs", "top_logprobs",
                       "text_offset"}
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == 3
    assert all(x <= 0 for x in lp["token_logprobs"])
    assert all(1 <= len(t) <= 2 for t in lp["top_logprobs"])


def test_unported_routes_and_router_fields(servers):
    (port, _), _ = servers
    assert request(port, "POST", "/fault_inject", {})[0] == 404
    status, data = request(port, "POST", "/v1/completions", {
        "prompt": [5], "max_tokens": 2, "gllm_router": {}})
    assert status == 400 and b"gllm_router" in data
    # best_of above n: the choices ranked by their mean chosen logprob,
    # the best one answered
    status, data = request(port, "POST", "/v1/completions", {
        "prompt": [5], "max_tokens": 2, "best_of": 3, "seed": 1})
    assert status == 200, data
    choice, = json.loads(data)["choices"]
    assert choice["logprobs"] is None and choice["finish_reason"]


def test_metrics_parse_and_count_the_finished(servers):
    (port, _), _ = servers
    ttft = tobs.REGISTRY.get("gllm_request_ttft_seconds")
    finished = tobs.REGISTRY.get("gllm_requests_finished_total")
    t0, f0 = ttft.snapshot()[2], finished.get(reason="length")
    for n in (3, 5, 2):
        request(port, "POST", "/v1/completions", {
            "prompt": [7, 8, 9], "max_tokens": n, "temperature": 0,
            "ignore_eos": True})
    status, data = request(port, "GET", "/metrics")
    assert status == 200
    typed, samples, dupes = tobs.parse_exposition(data.decode())
    assert not dupes
    for name, _ in samples:
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        assert name in typed or base in typed, name
    assert ttft.snapshot()[2] - t0 == finished.get(reason="length") - f0 == 3
    assert samples[("gllm_sched_running_seqs", '{dp="0"}')] == 0
    assert samples[("gllm_sched_kv_util", '{dp="0"}')] == 0
    for path in ("/health", "/healthz", "/readyz", "/version", "/v1/models",
                 "/server_info"):
        assert request(port, "GET", path)[0] == 200


def test_readyz_503_after_the_unhealthy_latch():
    llm = engines(False, max_step_failures=1)
    llm.runner.collect = lambda handle: (_ for _ in ()).throw(
        RuntimeError("device fault"))
    httpd = _start(llm, tapi)
    port = httpd.server_address[1]
    try:
        status, data = request(port, "POST", "/v1/completions", {
            "prompt": [5, 6, 7], "max_tokens": 3, "temperature": 0})
        assert status == 200
        assert json.loads(data)["choices"][0]["finish_reason"] == "error"
        status, data, headers = request(port, "GET", "/readyz", raw=True)
        assert status == 503 and "Retry-After" in headers
        assert json.loads(data)["reason"] == "unhealthy"
        status, data = request(port, "GET", "/healthz")
        assert status == 200 and json.loads(data)["healthy"] is False
        assert request(port, "POST", "/v1/completions", {
            "prompt": [5], "max_tokens": 2})[0] == 503
    finally:
        httpd.shutdown()
        httpd.state.engine.shutdown()
        httpd.server_close()


def test_profile_writes_a_chrome_trace(servers, tmp_path, monkeypatch):
    (port, _), _ = servers
    monkeypatch.setenv("GLLM_PROFILE_DIR", str(tmp_path))
    status, data = request(port, "POST", "/start_profile")
    assert status == 200, data
    assert json.loads(data)["trace_dir"] == str(tmp_path)
    request(port, "POST", "/v1/completions", {
        "prompt": [7, 8], "max_tokens": 3, "temperature": 0})
    status, data = request(port, "POST", "/stop_profile")
    assert status == 200, data
    trace = Path(json.loads(data)["trace"])
    assert trace.parent == tmp_path
    assert any(e.get("ph") == "X"
               for e in json.loads(trace.read_text())["traceEvents"])


def test_profile_refuses_a_client_trace_dir(servers, tmp_path):
    """Where traces go is the server's choice (``GLLM_PROFILE_DIR``): a
    client's ``trace_dir`` is refused and nothing is written there."""
    (port, _), _ = servers
    target = tmp_path / "client_pick"
    status, data = request(port, "POST", "/start_profile",
                           {"trace_dir": str(target)})
    assert status == 400 and b"GLLM_PROFILE_DIR" in data, data
    status, data = request(port, "POST", "/stop_profile")
    assert status == 200 and json.loads(data)["status"] == "noop", data
    assert not target.exists()


def _complete(port, n=4):
    status, data = request(port, "POST", "/v1/completions", {
        "prompt": [5, 6, 7, 8], "max_tokens": n, "temperature": 0,
        "ignore_eos": True})
    assert status == 200, data
    return json.loads(data)


def test_steptrace_since_kind_and_bad_since(servers):
    (port, _), _ = servers
    status, data = request(port, "GET", "/steptrace?kind=compile")
    assert status == 200
    mark = json.loads(data)["next_since"]
    _complete(port)
    status, data = request(port, "GET", f"/steptrace?since={mark}")
    assert status == 200
    d = json.loads(data)
    kinds = {e["kind"] for e in d["events"]}
    assert kinds & {"prefill", "decode"} and d["dropped"] >= 0
    assert all(e["seq"] >= mark for e in d["events"])
    steps = [e for e in d["events"] if e["kind"] in ("prefill", "decode")]
    assert all({"ph", "dev_ms", "step_wall_ms"} <= set(e) for e in steps)
    assert d["summary"]["by_kind"] and d["summary"]["host_ms_by_phase"]
    status, data = request(port, "GET",
                           f"/steptrace?since={mark}&kind=prefill")
    evs = json.loads(data)["events"]
    assert evs and {e["kind"] for e in evs} == {"prefill"}
    status, data = request(port, "GET",
                           f"/steptrace?since={mark}&kind=prefill,decode")
    assert {e["kind"] for e in json.loads(data)["events"]} == {"prefill",
                                                               "decode"}
    # nothing new after next_since
    nxt = d["next_since"]
    assert json.loads(request(port, "GET", f"/steptrace?since={nxt}")[1]
                      )["events"] == []
    for path in ("/steptrace?since=x", "/trace?since=1.5"):
        status, data = request(port, "GET", path)
        assert status == 400 and b"since" in data


def test_trace_serves_chrome_json(servers):
    (port, _), llm = servers
    _complete(port)
    status, data = request(port, "GET", "/trace")
    assert status == 200
    evs = json.loads(data)["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {1, 2}
    assert any(e["name"].endswith(":collect") for e in xs)
    assert all(e["dur"] >= 0 for e in xs)
    names = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert {"engine loop", "requests"} <= names
    assert llm.spans.open_count == 0 and llm.spans.spans()


def test_profile_oneshot_and_409(servers, tmp_path, monkeypatch):
    (port, _), _ = servers
    monkeypatch.setenv("GLLM_PROFILE_DIR", str(tmp_path))
    for bad in ("seconds=0", "seconds=bogus", "seconds=121"):
        assert request(port, "POST", f"/profile?{bad}")[0] == 400
    status, data = request(port, "POST", "/profile?seconds=0.2")
    assert status == 200, data
    d = json.loads(data)
    assert d["status"] == "ok" and d["trace_dir"] == str(tmp_path)
    assert Path(d["trace"]).parent == tmp_path
    assert "traceEvents" in json.loads(Path(d["trace"]).read_text())
    # /start_profile holds the profiler: a one-shot is refused
    assert request(port, "POST", "/start_profile")[0] == 200
    try:
        status, data = request(port, "POST", "/profile?seconds=0.1")
        assert status == 409 and b"start_profile" in data
    finally:
        assert request(port, "POST", "/stop_profile")[0] == 200
    # while a one-shot runs, /stop_profile does not cut it short (409)
    # and a second one-shot is refused
    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "r", request(port, "POST", "/profile?seconds=3")))
    th.start()
    # before the capture starts /stop_profile is a harmless noop (200)
    limit = time.monotonic() + 2.5
    status = 200
    while time.monotonic() < limit and status == 200:
        status = request(port, "POST", "/stop_profile")[0]
        time.sleep(0.05)
    assert status == 409
    assert request(port, "POST", "/profile?seconds=0.1")[0] == 409
    th.join()
    assert box["r"][0] == 200, box["r"][1]


def test_no_tracing_flag_keeps_streams_and_drops_spans():
    args = tapi.make_parser().parse_args(["--model", "m", "--no-tracing"])
    assert tapi.build_engine_config(args).tracing is False
    want = japi.build_engine_config(japi.make_parser().parse_args(
        ["--model", "m", "--no-tracing"]))
    assert want.tracing is False
    outs = []
    for tracing in (True, False):
        llm = engines(False, tracing=tracing)
        httpd = _start(llm, tapi)
        try:
            outs.append(_complete(httpd.server_address[1], 6)
                        ["choices"][0]["text"])
            status, data = request(httpd.server_address[1], "GET", "/trace")
            assert status == 200
            req = {e["pid"] for e in json.loads(data)["traceEvents"]
                   if e["ph"] == "X"}
            assert (2 in req) is tracing
            assert bool(llm.spans.spans()) is tracing
        finally:
            httpd.shutdown()
            httpd.state.engine.shutdown()
            httpd.server_close()
    assert outs[0] == outs[1]


ARGV = ["--model", "m", "--dtype", "float32", "--seed", "3",
        "--max-model-len", "512", "--max-num-seqs", "32",
        "--load-format", "dummy", "--schedule-method", "token_throttling",
        "--maxd", "64", "--maxp", "512", "--minp", "64", "--iterp", "8",
        "--init-new-token-ratio", "0.5", "--min-new-token-ratio", "0.2",
        "--page-size", "8", "--memory-util", "0.8", "--num-pages", "100",
        "--kv-cache-dtype", "int8", "--enable-prefix-caching",
        "--pipelined-loop", "--unified-step", "--inflight-depth", "3",
        "--decode-slot-batching", "--decode-chain-len", "8",
        "--ondevice-finish", "--max-queued-requests", "5",
        "--max-resident-requests", "6", "--request-deadline-s", "7",
        "--max-step-failures", "4", "--watchdog-stall-s", "2",
        "--drain-timeout-s", "9", "--enforce-eager"]


@pytest.mark.parametrize("argv", [["--model", "m"], ARGV[:-1], ARGV],
                         ids=["defaults", "flags", "eager"])
def test_cli_builds_the_options_jax_builds(argv):
    got = tapi.build_engine_config(tapi.make_parser().parse_args(argv))
    want = japi.build_engine_config(japi.make_parser().parse_args(argv))
    got.validate()
    want.validate()

    def common(a, b, where):
        for f in dataclasses.fields(a):
            if not hasattr(b, f.name):
                continue
            x, y = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(x):
                common(x, y, f"{where}.{f.name}")
            else:
                assert x == y, f"{where}.{f.name}: {x!r} != {y!r}"
    common(got, want, "EngineConfig")


def test_main_serves_and_stops_on_sigterm(tmp_path):
    """The CLI on the CPU: config.json in a directory, dummy weights,
    warmup and the first-token request (the ``[startup]`` line), a request
    over HTTP, then SIGTERM ends the process."""
    hf = dict(architectures=["LlamaForCausalLM"], vocab_size=512,
              hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, intermediate_size=128,
              max_position_embeddings=256, rope_theta=10000.0,
              eos_token_id=0)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    (tmp_path / "generation_config.json").write_text(
        json.dumps({"eos_token_id": [0, 7]}))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gllm_tpu_torch.entrypoints.api_server",
         "--model", str(tmp_path), "--load-format", "dummy", "--device",
         "cpu", "--dtype", "float32", "--port", "0", "--host", "127.0.0.1",
         "--max-model-len", "128", "--max-num-seqs", "4", "--maxd", "4",
         "--num-pages", "64", "--page-size", "4"],
        cwd=tmp_path, env=env, stderr=subprocess.PIPE, text=True)
    try:
        lines, port = [], None
        limit = time.monotonic() + 120
        while port is None and time.monotonic() < limit:
            line = proc.stderr.readline()
            assert line, "".join(lines)
            lines.append(line)
            m = re.search(r"serving \S+ on 127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "".join(lines)
        assert any("[startup] phase=first_token" in x for x in lines)
        status, data = request(port, "POST", "/v1/completions", {
            "prompt": [1, 2, 3], "max_tokens": 4, "temperature": 0,
            "ignore_eos": True})
        assert status == 200
        assert json.loads(data)["usage"]["completion_tokens"] == 4
        info = json.loads(request(port, "GET", "/server_info")[1])
        assert info["device"] == "cpu" and info["num_pages"] == 64
        # on the CPU the wrappers take their plain versions
        assert info["kernel_launches"]["plain_calls"] > 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def test_main_refuses_what_is_not_ported(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(dict(
        architectures=["LlamaForCausalLM"], vocab_size=64, hidden_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        intermediate_size=64)))
    for extra in (["--load-format", "auto"], ["--tokenizer", "t"],
                  ["--load-format", "dummy", "--tp", "2"]):
        with pytest.raises(NotImplementedError):
            tapi.main(["--model", str(tmp_path), "--device", "cpu",
                       "--skip-warmup", *extra])
    cfg = gt.EngineConfig(model=str(tmp_path), load_format="dummy",
                          engine_recovery=True)
    with pytest.raises(NotImplementedError, match="engine_recovery"):
        cfg.validate()
