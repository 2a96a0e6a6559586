"""OpenAI-compatible HTTP server, stdlib only (counterpart of
``gllm_tpu/entrypoints/api_server.py``: ``ServerState:40``, ``Handler:177``,
``build_engine_config:973``, ``make_parser:1047``, ``serve:1312``,
``main:1344``).

    python -m gllm_tpu_torch.entrypoints.api_server --model DIR \\
        --load-format dummy [--device cpu] [--port 8000] ...

``DIR`` holds the model's ``config.json`` and, under ``--load-format
auto`` (the default), its checkpoint (``model.safetensors[.index.json]``
or ``pytorch_model.bin[.index.json]``, ``models/loader.py``); ``dummy``
draws the weights from ``--seed``. The tokenizer is ``--tokenizer`` or the
model directory's, read with ``transformers`` where it imports (local
files only); without one, send token-id prompts, or build an ``LLM`` with
a tokenizer object and call :func:`serve`. The engine runs on the CUDA
card unless ``--device cpu`` asks for the CPU; with no card it raises at
startup.

Routes: ``GET /health`` and ``/healthz`` (liveness, with the engine's
health), ``/readyz`` (readiness: 503 with Retry-After when unhealthy,
draining or stalled), ``/metrics`` (Prometheus text), ``/version``,
``/v1/models``, ``/server_info``; ``POST /v1/completions`` and
``/v1/chat/completions`` (streamed as server-sent events or whole, ``n``
choices), ``/start_profile`` and ``/stop_profile`` (``torch.profiler``,
a Chrome trace written to ``GLLM_PROFILE_DIR``) and ``/profile?seconds=N``
(one such capture of N seconds, 409 while another holds the profiler).
``GET /steptrace`` dumps the step-trace ring as JSON with its
``summarize`` (``?since=N`` from a previous dump's ``next_since``,
``?kind=a,b`` by event kind) and ``GET /trace`` the ring and this engine's
request spans as Chrome trace-event JSON (``--no-tracing`` turns the spans
off; the ring stays). A client that disconnects aborts its request. A
ThreadingHTTPServer: one thread a request in flight, each blocking on its
request's stream, beside the one engine thread.

Every sampling option of the JAX server is taken: seeds (choice i of a
request draws with seed + i), penalties, ``logit_bias``, ``logprobs`` /
``top_logprobs`` in chat and completions, ``prompt_logprobs`` with
``echo``, and ``best_of`` above ``n`` (the choices ranked by their mean
chosen logprob).

Not ported, and refused: ``/fault_inject`` answers 404; a request with
``gllm_router`` fields answers 400 with the message; so do multimodal
content parts.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import gllm_tpu_torch
from gllm_tpu_torch.config import (CacheConfig, EngineConfig,
                                   ParallelConfig, SchedulerConfig)
from gllm_tpu_torch.engine.llm import LLM
from gllm_tpu_torch.engine.serving_engine import (RequestRejected,
                                                  ServingEngine)
from gllm_tpu_torch.entrypoints import protocol as proto
from gllm_tpu_torch.obs import metrics as obs_metrics
from gllm_tpu_torch.obs.spans import chrome_trace
from gllm_tpu_torch.obs.steptrace import TRACE, summarize

logger = logging.getLogger(__name__)


class ServerState:
    def __init__(self, llm: LLM, served_model: str,
                 tool_parser: Optional[str] = None):
        from gllm_tpu_torch.entrypoints.tool_parsers import get_tool_parser
        self.llm = llm
        self.engine = ServingEngine(llm)
        self.served_model = served_model
        self.start_time = time.time()
        # the torch.profiler capture between /start_profile and
        # /stop_profile (or of a POST /profile), and where its trace goes;
        # _profile_mu makes each check and transition atomic,
        # _profiling_oneshot marks a /profile capture that /stop_profile
        # must not cut short, and _profile_lock admits one /profile at a
        # time
        self._profiler = None
        self._profile_dir = None
        self._profiling_oneshot = False
        self._profile_mu = threading.Lock()
        self._profile_lock = threading.Lock()
        self.tool_parser = get_tool_parser(
            tool_parser, llm.config.model or served_model,
            architecture=llm.model_cfg.architecture or "")

    # ---- request handling -------------------------------------------------

    def encode_chat(self, req: proto.ChatCompletionRequest):
        # a text-only model: media parts are refused, not dropped (the
        # caller would believe the model saw the image)
        for m in req.messages:
            c = m.get("content")
            if isinstance(c, list) and any(
                    isinstance(p, dict)
                    and p.get("type") in ("image_url", "image", "video",
                                          "video_url")
                    for p in c):
                raise proto.ProtocolError(
                    "this model is not multimodal; image/video content "
                    "parts are not supported")
        tok = self.llm.tokenizer
        if tok is None:
            raise proto.ProtocolError("server has no tokenizer loaded")
        kwargs = dict(req.chat_template_kwargs)
        if req.tools:
            kwargs["tools"] = req.tools
        ids = tok.apply_chat_template(req.messages,
                                      add_generation_prompt=True, **kwargs)
        if ids and isinstance(ids[0], list):
            ids = ids[0]
        return [int(t) for t in ids]

    def encode_completion(self, req: proto.CompletionRequest):
        if isinstance(req.prompt, list):
            return list(req.prompt)
        if self.llm.tokenizer is None:
            raise proto.ProtocolError(
                "server has no tokenizer; send token-array prompts")
        return list(self.llm.tokenizer.encode(req.prompt))


def _profile_dir() -> str:
    """The trace directory: ``GLLM_PROFILE_DIR``, else one under the
    temporary directory. Only the server's side sets it; a client never
    picks where the server writes."""
    return (os.environ.get("GLLM_PROFILE_DIR")
            or os.path.join(tempfile.gettempdir(), "gllm_tpu_torch_profile"))


def _query(path: str) -> dict:
    from urllib.parse import parse_qs, urlparse
    return parse_qs(urlparse(path).query)


def _since(q: dict) -> Optional[int]:
    """The ``since`` of a query (0 when absent; None when not an
    integer)."""
    try:
        return int(q.get("since", ["0"])[0])
    except ValueError:
        return None


def _kernel_launches() -> dict:
    """The kernel wrappers' launch counters (a CUDA graph's replays
    included), and the plain versions' calls (the CPU's path)."""
    from gllm_tpu_torch.runner import graphs
    counts = graphs.launch_counts()
    return {"kernels": {k: n for (_, k), n in counts.items()
                        if k is not None},
            "plain_calls": sum(n for (_, k), n in counts.items()
                               if k is None)}


def _engine_counters(llm: LLM) -> dict:
    """Counters of the engine loop that the JAX package's metrics do not
    carry: the mixed re-forms that absorbed prefill, the sub-steps blocks
    executed, the pure-decode steps with penalties, logit_bias or
    logprobs (each replays its extras key), the mixed steps run eagerly
    by reason, the
    CUDA graphs captured so far with their capture time (a graph first
    met while serving is captured then), their replays by kind and the
    memory their pools hold, and speculation's counts."""
    g = llm.runner.graphs
    return {"absorbs": llm.absorbs, "block_substeps": llm.block_substeps,
            "extras_steps": llm.step_counts["extras"],
            "mixed_steps": llm.step_counts["mixed"],
            "eager_mixed": dict(llm.runner.eager_mixed),
            "graph_replays": ({k: v["replays"] for k, v in g.by_kind.items()}
                              if g is not None else {}),
            "graphs": len(g) if g is not None else 0,
            "capture_s": g.capture_seconds if g is not None else 0.0,
            "graph_pool_mib": (g.pool_bytes() / 2**20 if g is not None
                               else 0.0),
            # speculation: drafts proposed and accepted, verify steps and
            # the tokens of spec blocks by kind
            "spec_drafts": dict(llm.scheduler.spec_stats),
            "verify_steps": llm.verify_steps,
            "spec_tokens": dict(llm.spec_tokens)}


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    state: ServerState = None  # bound by serve()

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)

    # ---- helpers ----------------------------------------------------------

    def _json(self, obj, code=200, headers=None):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _text(self, body: str, content_type: str, code=200):
        raw = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b"{}"
        try:
            d = json.loads(raw)
        except json.JSONDecodeError as e:
            raise proto.ProtocolError(f"invalid JSON body: {e}") from e
        if not isinstance(d, dict):
            raise proto.ProtocolError("request body must be a JSON object")
        if "gllm_router" in d:
            raise proto.ProtocolError(
                "not supported by gllm_tpu_torch yet: gllm_router "
                "(journaled streams and continuations)")
        return d

    def _sse_start(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()

    def _sse(self, obj) -> None:
        self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
        self.wfile.flush()

    # ---- routes -----------------------------------------------------------

    def do_GET(self):
        st = self.state
        eng = st.engine
        if self.path in ("/health", "/healthz"):
            # liveness: 200 while the engine thread runs, unhealthy or not
            alive = eng.is_alive
            body = {"status": "ok" if alive else "dead"}
            body.update(eng.health())
            self._json(body, code=200 if alive else 503)
        elif self.path == "/readyz":
            ready, why = eng.readiness()
            if ready:
                self._json({"status": "ok"})
            else:
                body = {"status": "unavailable", "reason": why}
                if eng._unhealthy_class:
                    body["unhealthy_reason"] = eng._unhealthy_class
                    body["detail"] = eng._unhealthy_reason
                self._json(body, code=503, headers={
                    "Retry-After": str(max(1, int(round(
                        eng.retry_after_s()))))})
        elif self.path == "/metrics":
            self._text(obs_metrics.render(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif self.path.split("?", 1)[0] == "/steptrace":
            # the step-trace ring as JSON (``python -m
            # gllm_tpu_torch.obs.dump -`` prints it as a table)
            q = _query(self.path)
            since = _since(q)
            if since is None:
                self._json(proto.error_response(
                    "since must be an integer"), code=400)
                return
            kinds = [k for part in q.get("kind", [])
                     for k in part.split(",") if k]
            events = TRACE.events(since=since, kinds=kinds or None)
            self._json({"events": events, "dropped": TRACE.dropped,
                        "next_since": TRACE.mark(),
                        "summary": summarize(events)})
        elif self.path.split("?", 1)[0] == "/trace":
            # Chrome trace-event JSON: a track per engine phase and the
            # device's, a track per request of this engine's span ring
            since = _since(_query(self.path))
            if since is None:
                self._json(proto.error_response(
                    "since must be an integer"), code=400)
                return
            spans = st.llm.spans
            self._json(chrome_trace(TRACE.events(since=since),
                                    spans.spans() + spans.open_spans(),
                                    span_t0=TRACE.t0))
        elif self.path == "/version":
            self._json({"version": gllm_tpu_torch.__version__})
        elif self.path == "/v1/models":
            self._json({"object": "list", "data": [{
                "id": st.served_model, "object": "model",
                "created": int(st.start_time), "owned_by": "gllm-tpu"}]})
        elif self.path == "/server_info":
            llm = st.llm
            cfg = llm.config
            self._json({
                "model": cfg.model,
                "uptime_s": round(time.time() - st.start_time, 1),
                "device": str(llm.device),
                "max_model_len": cfg.max_model_len,
                "schedule_method": cfg.scheduler.schedule_method,
                "page_size": cfg.cache.page_size,
                "num_pages": llm.runner.num_pages,
                "prefix_caching": cfg.cache.enable_prefix_caching,
                "parallel": {
                    "tp": 1, "dp": 1, "pp": 1,
                    "fast_path": {
                        "overlap_scheduling": cfg.overlap_scheduling,
                        "pipelined_loop": cfg.pipelined_loop,
                        "unified_step": cfg.unified_step,
                        "decode_slot_batching": cfg.decode_slot_batching,
                        "multi_step_decode": cfg.multi_step_decode,
                        "ondevice_finish": cfg.ondevice_finish,
                        "spec_fused": cfg.spec_fused,
                    },
                },
                "attention_impl": llm.runner.attn_impl,
                "waiting": len(llm.scheduler.waiting),
                "running": len(llm.scheduler.running),
                # read on the engine thread, between steps
                "kernel_launches": eng.run_on_engine(_kernel_launches),
                "engine_counters": eng.run_on_engine(
                    lambda: _engine_counters(llm)),
            })
        else:
            self._json(proto.error_response("not found", 404), code=404)

    def do_POST(self):
        try:
            if self.path == "/v1/chat/completions":
                self._chat()
            elif self.path == "/v1/completions":
                self._completion()
            elif self.path == "/start_profile":
                self._profile(True)
            elif self.path == "/stop_profile":
                self._profile(False)
            elif self.path.split("?", 1)[0] == "/profile":
                self._profile_oneshot()
            else:
                self._json(proto.error_response("not found", 404), code=404)
        except proto.ProtocolError as e:
            self._json(proto.error_response(str(e)), code=400)
        except RequestRejected as e:
            # admission control: 429 over capacity, 503 unavailable, with
            # a Retry-After hint
            self._json(
                proto.error_response(str(e), e.status), code=e.status,
                headers={"Retry-After":
                         str(max(1, int(round(e.retry_after))))})
        except BrokenPipeError:
            pass  # the client went away mid-write
        except Exception as e:  # pragma: no cover
            logger.exception("request failed")
            try:
                self._json(proto.error_response(f"internal error: {e}", 500),
                           code=500)
            except Exception:
                pass

    # ---- chat / completions ----------------------------------------------

    def _submit_choices(self, req, ids, count=None, rank_logprobs=False):
        """Submit ``count`` (default ``n``) sequences for one request:
        choice i of a seeded request draws with seed + i, so that the
        choices differ; ``rank_logprobs`` asks for the chosen tokens'
        logprobs (top 0) where the request did not, for best_of's
        ranking. A partial submit aborts the choices already admitted
        before it raises."""
        import dataclasses as dc
        st = self.state
        handles = []
        try:
            for i in range(req.n if count is None else count):
                sp = dc.replace(req.sampling)
                if sp.seed is not None:
                    sp.seed = sp.seed + i
                if rank_logprobs and sp.logprobs is None:
                    sp.logprobs = 0
                handles.append(st.engine.submit(list(ids), sp))
        except Exception:
            for h in handles:
                st.engine.abort(h.seq_id)
            raise
        return handles

    def _sse_open(self, handles, *chunks) -> bool:
        """Send the SSE preamble (headers and any role chunks). A client
        that disconnected between submit and stream aborts its sequences
        here."""
        try:
            self._sse_start()
            for c in chunks:
                self._sse(c)
            return True
        except (BrokenPipeError, ConnectionResetError):
            for h in handles:
                self.state.engine.abort(h.seq_id)
            return False

    def _stream_many(self, handles, make_chunk):
        """The ``n`` streams of one request as one SSE stream with a
        choice index each; each handle drains on a thread of its own into
        a merged queue, so a slow choice never holds the others."""
        import queue as _q
        merged: "_q.Queue" = _q.Queue()

        def pump(i, h):
            # the end marker goes up even if the iterator raises, or the
            # merge loop would wait forever on a dead choice
            err = None
            try:
                for c in h:
                    merged.put((i, c))
            except Exception as e:       # noqa: BLE001 — raised below
                err = e
            merged.put((i, (None, err)))

        for i, h in enumerate(handles):
            threading.Thread(target=pump, args=(i, h), daemon=True).start()
        done, first_err = 0, None
        try:
            while done < len(handles):
                i, c = merged.get()
                if isinstance(c, tuple):
                    done += 1
                    first_err = first_err or c[1]
                    continue
                self._sse(make_chunk(c.text or "", c.finish_reason, i))
                if c.finish_reason in ("error", "abort", "deadline") \
                        and c.error:
                    self._sse(proto.stream_error_event(c.error,
                                                       c.finish_reason))
            if first_err is not None:
                raise first_err
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            for h in handles:
                self.state.engine.abort(h.seq_id)
        except Exception:
            for h in handles:
                self.state.engine.abort(h.seq_id)
            raise

    def _run_choices(self, req, ids):
        """Submit ``best_of`` choices and collect them; above ``n`` they
        are ranked by their mean chosen logprob and the best ``n`` kept.
        Returns (results, usage)."""
        rank = req.best_of > req.n
        handles = self._submit_choices(req, ids, count=req.best_of,
                                       rank_logprobs=rank)
        results = [self._collect(h) for h in handles]
        if rank:
            def score(r):
                lps = [e[1][0] for e in r["lp"] or [] if e[1] is not None]
                return sum(lps) / len(lps) if lps else float("-inf")
            results.sort(key=score, reverse=True)
        results = results[:req.n]
        prompt_tokens = results[0]["usage"]["prompt_tokens"] if results \
            else 0
        completion = sum(r["usage"]["completion_tokens"] for r in results)
        return results, proto.usage_dict(prompt_tokens, completion)

    def _chat(self):
        st = self.state
        body = self._read_json()
        req = proto.ChatCompletionRequest.from_dict(
            body, default_max_tokens=256)
        ids = st.encode_chat(req)
        if not req.stream:
            results, usage = self._run_choices(req, ids)
            choices = []
            for r in results:
                text, tool_calls = r["text"], None
                if req.tools and req.tool_choice != "none":
                    from gllm_tpu_torch.entrypoints.tool_parsers import (
                        schemas_from_tools)
                    text, calls = st.tool_parser.parse(
                        text, schemas_from_tools(req.tools))
                    tool_calls = [c.to_openai() for c in calls] or None
                lp = None
                if req.sampling.logprobs is not None:
                    lp = proto.chat_logprobs_content(r["lp"],
                                                     self._decode_one)
                choices.append({"text": text,
                                "finish_reason": r["finish"],
                                "tool_calls": tool_calls, "logprobs": lp})
            self._json(proto.chat_completion_response(req.model, choices,
                                                      usage))
            return
        parse_tools = bool(req.tools) and req.tool_choice != "none"
        rid = proto.new_request_id(chat=True)
        if req.n > 1:
            if parse_tools:
                raise proto.ProtocolError(
                    "stream with n > 1 and tool parsing is not supported")
            # submit before the SSE headers go out: a submit error still
            # gets a JSON error response
            handles = self._submit_choices(req, ids)
            if not self._sse_open(handles, *[
                    proto.chat_completion_chunk(rid, req.model, None, None,
                                                role=True, index=i)
                    for i in range(req.n)]):
                return
            self._stream_many(handles, lambda text, fin, i: proto.
                              chat_completion_chunk(rid, req.model, text,
                                                    fin, index=i))
            return
        handle = st.engine.submit(list(ids), req.sampling)
        if parse_tools:
            # text deltas flow as they come; only suffixes that may be
            # tool markup are held back, and a completed call goes out as
            # an OpenAI tool_call delta
            from gllm_tpu_torch.entrypoints.tool_parsers import (
                StreamingToolCalls, schemas_from_tools)
            stream = StreamingToolCalls(st.tool_parser,
                                        schemas_from_tools(req.tools))
            if not self._sse_open([handle], proto.chat_completion_chunk(
                    rid, req.model, None, None, role=True)):
                return

            def emit(text, deltas):
                if text:
                    self._sse(proto.chat_completion_chunk(rid, req.model,
                                                          text, None))
                for d in deltas:
                    chunk = proto.chat_completion_chunk(rid, req.model,
                                                        None, None)
                    chunk["choices"][0]["delta"]["tool_calls"] = [d]
                    self._sse(chunk)

            fin = None
            err_ev = None
            try:
                for chunk_out in handle:
                    emit(*stream.feed(chunk_out.text or ""))
                    fin = chunk_out.finish_reason or fin
                    if fin in ("error", "abort", "deadline") \
                            and chunk_out.error:
                        err_ev = proto.stream_error_event(chunk_out.error,
                                                          fin)
                emit(*stream.finish())
                if stream.saw_tool_calls:
                    fin = "tool_calls"
                self._sse(proto.chat_completion_chunk(rid, req.model, None,
                                                      fin))
                if err_ev is not None:
                    self._sse(err_ev)
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                st.engine.abort(handle.seq_id)
            return
        if not self._sse_open([handle], proto.chat_completion_chunk(
                rid, req.model, None, None, role=True)):
            return
        self._stream(handle, lambda text, fin: proto.chat_completion_chunk(
            rid, req.model, text, fin))

    def _completion(self):
        st = self.state
        body = self._read_json()
        req = proto.CompletionRequest.from_dict(
            body, default_max_tokens=256)
        ids = st.encode_completion(req)
        if req.stream:
            rid = proto.new_request_id(chat=False)
            # submit before the SSE headers (see _chat)
            if req.n > 1:
                handles = self._submit_choices(req, ids)
                if not self._sse_open(handles):
                    return
                self._stream_many(handles, lambda text, fin, i: proto.
                                  completion_chunk(rid, req.model,
                                                   text or "", fin,
                                                   index=i))
                return
            handle = st.engine.submit(ids, req.sampling)
            if not self._sse_open([handle]):
                return
            self._stream(handle, lambda text, fin: proto.completion_chunk(
                rid, req.model, text or "", fin))
            return
        results, usage = self._run_choices(req, ids)
        choices = []
        for r in results:
            text = r["text"]
            lp = None
            if req.sampling.logprobs is not None \
                    or req.sampling.prompt_logprobs is not None:
                entries = []
                if req.echo and r["plp"] is not None:
                    # the prompt's tokens first, position 0 without one
                    entries.extend(zip(ids, r["plp"]))
                entries.extend(r["lp"] or [])
                lp = proto.completion_logprobs(entries, self._decode_one)
            if req.echo and isinstance(req.prompt, str):
                text = req.prompt + text
            choices.append({"text": text, "finish_reason": r["finish"],
                            "logprobs": lp})
        self._json(proto.completion_response(req.model, choices, usage))

    def _collect(self, handle):
        """Drain one request's stream → {"text", "finish", "usage", "lp"
        [(token id, logprob entry)] or None, "plp"}."""
        text_parts, finish = [], "stop"
        usage = proto.usage_dict(0, 0)
        lp, plp, final_text = [], None, None
        for chunk in handle:
            if chunk.text:
                text_parts.append(chunk.text)
            if chunk.token_id is not None and chunk.logprob is not None:
                lp.append((chunk.token_id, chunk.logprob))
            if chunk.finish_reason is not None:
                finish = chunk.finish_reason
                usage = proto.usage_dict(chunk.num_prompt_tokens,
                                         chunk.num_output_tokens)
                plp = chunk.prompt_logprobs
                final_text = chunk.final_text
        text = final_text if final_text is not None \
            else "".join(text_parts)
        return {"text": text, "finish": finish, "usage": usage,
                "lp": lp or None, "plp": plp}

    def _decode_one(self, token_id: int) -> str:
        tok = self.state.llm.tokenizer
        return tok.decode([token_id]) if tok is not None else str(token_id)

    def _stream(self, handle, make_chunk):
        try:
            for chunk in handle:
                # one event per committed token (even when the
                # detokenizer held its text back): clients measure ITL
                # from event arrivals
                self._sse(make_chunk(chunk.text or "", chunk.finish_reason))
                if chunk.finish_reason in ("error", "abort", "deadline") \
                        and chunk.error:
                    self._sse(proto.stream_error_event(chunk.error,
                                                       chunk.finish_reason))
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # the client disconnected: abort its sequence
            self.state.engine.abort(handle.seq_id)

    # ---- profiler ---------------------------------------------------------

    def _profile(self, start: bool):
        """``/start_profile`` starts a ``torch.profiler`` capture (the
        engine thread's host operators, and the card's kernels on CUDA);
        ``/stop_profile`` stops it and writes a Chrome trace into
        ``GLLM_PROFILE_DIR``, else a directory under the temporary one (a
        ``trace_dir`` in the request's body is refused with 400).
        Both run on the engine thread, between steps: the profiler records
        the operators of the thread that starts it. While a ``POST
        /profile`` capture runs, ``/stop_profile`` answers 409 and
        ``/start_profile`` does nothing."""
        st = self.state
        body = self._read_json()
        if "trace_dir" in body:
            self._json(proto.error_response(
                "trace_dir is not taken from a request; the server "
                "writes traces into GLLM_PROFILE_DIR", 400), code=400)
            return
        with st._profile_mu:
            if start and st._profiler is None:
                st._profiler, st._profile_dir = self._start_profiler(), \
                    _profile_dir()
                self._json({"status": "profiling started",
                            "trace_dir": st._profile_dir})
            elif not start and st._profiling_oneshot:
                # a POST /profile capture holds the profiler: stopping it
                # here would cut that capture short
                self._json(proto.error_response(
                    "a one-shot /profile capture is in progress", 409),
                    code=409)
            elif not start and st._profiler is not None:
                prof, trace_dir = st._profiler, st._profile_dir
                st._profiler = st._profile_dir = None
                path = self._stop_profiler(prof, trace_dir)
                self._json({"status": "profiling stopped", "trace": path})
            else:
                self._json({"status": "noop"})

    def _start_profiler(self):
        """A ``torch.profiler`` capture started on the engine thread (the
        host's operators, and the card's kernels on CUDA), after the card
        has run everything queued on it: CUDA activity is switched on with
        no replay in flight (ROADMAP C 9), and off the same way
        (``_stop_profiler``)."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        st = self.state
        device = st.llm.device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)

        def start():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.start()
        st.engine.run_on_engine(start)
        return prof

    def _stop_profiler(self, prof, trace_dir: str) -> str:
        """Stop ``prof`` on the engine thread, the card idle, and write its
        Chrome trace into ``trace_dir``; returns the file's path."""
        import torch
        st = self.state
        device = st.llm.device

        def stop():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.stop()
        st.engine.run_on_engine(stop)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(
            trace_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
            f"{os.getpid()}_{time.monotonic_ns()}.json")
        prof.export_chrome_trace(path)
        return path

    def _profile_oneshot(self):
        """``POST /profile?seconds=N`` (default 3, at most 120): start a
        capture, sleep N seconds while serving goes on, stop it and answer
        the trace's directory and file. 409 while another ``/profile`` or
        a ``/start_profile`` capture holds the profiler."""
        st = self.state
        try:
            seconds = float(_query(self.path).get("seconds", ["3"])[0])
        except ValueError:
            self._json(proto.error_response("seconds must be a number"),
                       code=400)
            return
        if not 0 < seconds <= 120:
            self._json(proto.error_response(
                "seconds must be in (0, 120]"), code=400)
            return
        if not st._profile_lock.acquire(blocking=False):
            self._json(proto.error_response(
                "a profile capture is already running", 409), code=409)
            return
        try:
            trace_dir = _profile_dir()
            with st._profile_mu:
                if st._profiler is not None:
                    self._json(proto.error_response(
                        "profiler already started via /start_profile",
                        409), code=409)
                    return
                st._profiler = self._start_profiler()
                st._profile_dir = trace_dir
                st._profiling_oneshot = True
            try:
                time.sleep(seconds)
            finally:
                with st._profile_mu:
                    prof = st._profiler
                    st._profiler = st._profile_dir = None
                    st._profiling_oneshot = False
                    path = self._stop_profiler(prof, trace_dir)
            self._json({"status": "ok", "seconds": seconds,
                        "trace_dir": trace_dir, "trace": path})
        finally:
            st._profile_lock.release()


def build_engine_config(args) -> EngineConfig:
    """The engine options of the parsed flags (``validate`` refuses the
    ones this port does not implement)."""
    return EngineConfig(
        model=args.model,
        tokenizer=args.tokenizer,
        dtype=args.dtype,
        seed=args.seed,
        max_model_len=args.max_model_len,
        max_num_seqs=args.max_num_seqs,
        load_format=args.load_format,
        allow_hub_download=args.allow_hub_download,
        overlap_scheduling=args.overlap_scheduling,
        pipelined_loop=args.pipelined_loop,
        unified_step=args.unified_step,
        overlap_depth=args.inflight_depth,
        decode_slot_batching=args.decode_slot_batching,
        chain_under_prefill=args.chain_under_prefill,
        decode_chain_len=args.decode_chain_len,
        ondevice_finish=args.ondevice_finish,
        spec_decode=args.spec_decode,
        spec_k=args.spec_k,
        spec_ngram=args.spec_ngram,
        spec_fused=args.spec_fused,
        quantization=args.quantization,
        max_queued_requests=args.max_queued_requests,
        max_resident_requests=args.max_resident_requests,
        request_deadline_s=args.request_deadline_s,
        max_step_failures=args.max_step_failures,
        watchdog_stall_s=args.watchdog_stall_s,
        drain_timeout_s=args.drain_timeout_s,
        engine_recovery=args.engine_recovery,
        watchdog_hard_stall_s=args.watchdog_hard_stall_s,
        tracing=not args.no_tracing,
        scheduler=SchedulerConfig(
            schedule_method=args.schedule_method,
            max_decode_seqs=args.maxd,
            max_prefill_tokens=args.maxp,
            min_prefill_tokens=args.minp,
            iter_smooth=args.iterp,
            init_new_token_ratio=args.init_new_token_ratio,
            min_new_token_ratio=args.min_new_token_ratio,
        ),
        enforce_eager=args.enforce_eager,
        cache=CacheConfig(
            page_size=args.page_size,
            memory_util=args.memory_util,
            num_pages=args.num_pages,
            kv_cache_dtype=args.kv_cache_dtype,
            enable_prefix_caching=args.enable_prefix_caching,
            kv_host_pool_gb=args.kv_host_pool_gb,
            kv_disk_path=args.kv_disk_path,
            prefix_peers=args.prefix_peers,
        ),
        parallel=ParallelConfig(pp=args.pp, tp=args.tp, dp=args.dp,
                                sp=args.sp, enable_ep=args.enable_ep),
    )


def make_parser() -> argparse.ArgumentParser:
    """The JAX server's flags that map onto this port's engine options,
    under the same names and defaults; those the port does not implement
    (quantization, parallelism, KV tiers, recovery) are
    parsed and refused by ``EngineConfig.validate``."""
    p = argparse.ArgumentParser(
        description="gllm-tpu OpenAI-compatible API server on PyTorch/CUDA")
    p.add_argument("--model", required=True,
                   help="model directory: config.json, and the checkpoint "
                        "under --load-format auto")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer directory (default the model's; read "
                        "with transformers where it imports, local files "
                        "only; else token-id prompts only)")
    p.add_argument("--allow-hub-download", action="store_true",
                   help="resolve a non-local model id via HF-hub snapshot "
                        "download (file-lock serialized); default is "
                        "local-path-only")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks a free port (logged once bound)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card (it raises "
                        "when there is none), 'cpu' on request")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-model-len", type=int, default=4096)
    p.add_argument("--max-num-seqs", type=int, default=256)
    p.add_argument("--load-format", default="auto",
                   choices=["auto", "dummy"],
                   help="auto: the model directory's checkpoint "
                        "(safetensors, sharded or single, or .bin); dummy: "
                        "weights drawn from --seed")
    p.add_argument("--schedule-method", default="chunked_prefill",
                   choices=["chunked_prefill", "token_throttling",
                            "split_pd"])
    p.add_argument("--maxd", type=int, default=256)
    p.add_argument("--maxp", type=int, default=2048)
    p.add_argument("--minp", type=int, default=128)
    p.add_argument("--iterp", type=int, default=16)
    p.add_argument("--init-new-token-ratio", type=float, default=0.7)
    p.add_argument("--min-new-token-ratio", type=float, default=0.1)
    p.add_argument("--enforce-eager", action="store_true",
                   help="run every step op by op (no CUDA graphs; clears "
                        "overlap scheduling and the options built on it)")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--memory-util", type=float, default=0.9,
                   help="fraction of device memory for the KV cache")
    p.add_argument("--num-pages", type=int, default=None)
    p.add_argument("--kv-cache-dtype", default="auto",
                   choices=("auto", "bfloat16", "float16", "float32",
                            "fp8", "int8"))
    p.add_argument("--quantization", default=None,
                   choices=["int8", "fp8", "int4", "w8a8", "fp8_block"])
    p.add_argument("--enable-prefix-caching", action="store_true")
    p.add_argument("--kv-host-pool-gb", type=float, default=0.0)
    p.add_argument("--kv-disk-path", default=None)
    p.add_argument("--prefix-peers", default=None)
    p.add_argument("--overlap-scheduling", action="store_true",
                   help="chain decode steps on the device off the previous "
                        "step's tokens")
    p.add_argument("--pipelined-loop", action="store_true",
                   help="re-form the next batch off promised token counts "
                        "across a chain break (implies "
                        "--overlap-scheduling)")
    p.add_argument("--unified-step", action="store_true",
                   help="every step through the unified attention kernel; "
                        "under overlap a chain absorbs waiting prefill "
                        "through mixed re-forms")
    p.add_argument("--inflight-depth", type=int, default=2,
                   help="entries dispatched and not yet collected under "
                        "--overlap-scheduling")
    p.add_argument("--decode-slot-batching", action="store_true",
                   help="persistent-slot decode chains: finished rows "
                        "become holes, ready sequences join them")
    p.add_argument("--chain-under-prefill", type=int, default=0)
    p.add_argument("--decode-chain-len", type=int, default=None,
                   help="decode steps a block (one CUDA graph); default 1, "
                        "or 16 with --ondevice-finish")
    p.add_argument("--ondevice-finish", action="store_true",
                   help="detect EOS / stop-token finishes inside blocks "
                        "and stop a block once every row has finished")
    p.add_argument("--spec-decode", default=None, choices=["ngram"],
                   help="prompt-lookup speculative decoding: verify up to "
                        "--spec-k n-gram drafts a decode step")
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--spec-ngram", type=int, default=2)
    p.add_argument("--spec-fused", action="store_true",
                   help="draft and verify inside the fused decode blocks "
                        "(requires --spec-decode ngram)")
    p.add_argument("--tool-call-parser", default=None,
                   choices=["qwen", "hermes", "deepseek", "none"])
    p.add_argument("--max-queued-requests", type=int, default=0,
                   help="admission bound on the intake queue (429 over it; "
                        "0 = none)")
    p.add_argument("--max-resident-requests", type=int, default=0,
                   help="cap on open request streams (429 over it; 0 = "
                        "none)")
    p.add_argument("--request-deadline-s", type=float, default=0.0,
                   help="default wall-clock budget a request (finish "
                        "reason 'deadline'; 0 = none)")
    p.add_argument("--max-step-failures", type=int, default=3,
                   help="consecutive failed steps before the engine "
                        "latches unhealthy (readiness 503)")
    p.add_argument("--watchdog-stall-s", type=float, default=0.0,
                   help="readiness 503 while the engine heartbeat is older "
                        "than this (0 = no watchdog)")
    p.add_argument("--drain-timeout-s", type=float, default=5.0)
    p.add_argument("--engine-recovery", action="store_true")
    p.add_argument("--watchdog-hard-stall-s", type=float, default=0.0)
    p.add_argument("--no-tracing", action="store_true",
                   help="turn the request spans off (GET /trace's request "
                        "tracks; the step-trace ring and its attribution "
                        "on /steptrace stay on); token streams are the "
                        "same either way")
    p.add_argument("--skip-warmup", action="store_true",
                   help="capture no CUDA graphs before serving (the first "
                        "requests capture theirs)")
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--enable-ep", action="store_true")
    return p


def serve(llm: LLM, host: str, port: int,
          served_model: Optional[str] = None,
          tool_parser: Optional[str] = None) -> ThreadingHTTPServer:
    """Build the HTTP server over ``llm`` (the caller runs
    ``serve_forever``, in the foreground or on a thread)."""
    state = ServerState(llm, served_model or llm.config.model, tool_parser)
    handler = type("BoundHandler", (Handler,), {"state": state})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.state = state
    return httpd


def _stop_on_sigterm(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = make_parser().parse_args(argv)
    t_start = time.monotonic()
    llm = LLM(config=build_engine_config(args), device=args.device)
    if not args.skip_warmup:
        llm.runner.warmup()
        # serving readiness: one real token through the whole engine path
        from gllm_tpu_torch.sampling_params import SamplingParams
        t0 = time.monotonic()
        llm.generate(prompt_token_ids=[[1, 2, 3]],
                     sampling_params=SamplingParams(
                         temperature=0.0, max_tokens=1, ignore_eos=True))
        logger.info("[startup] phase=first_token seconds=%.2f "
                    "total_startup_seconds=%.2f",
                    time.monotonic() - t0, time.monotonic() - t_start)
    httpd = serve(llm, args.host, args.port,
                  args.served_model_name or args.model,
                  tool_parser=args.tool_call_parser)
    # SIGTERM drains as Ctrl-C does
    signal.signal(signal.SIGTERM, _stop_on_sigterm)
    logger.info("serving %s on %s:%d (%s)", args.model, args.host,
                httpd.server_address[1], llm.device)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # stop admitting, let requests in flight finish (bounded), close
        # every open stream with a terminal chunk, join the engine thread
        httpd.state.engine.shutdown(drain=True)
        httpd.server_close()
        logger.info("server stopped")


if __name__ == "__main__":
    main()
