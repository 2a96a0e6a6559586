"""Threaded serving core: the continuous-batching loop and per-request
streams (counterpart of ``gllm_tpu/engine/serving_engine.py``:
``RequestRejected:102``, ``StreamChunk:115``, ``RequestHandle:140``,
``deliver_output:181``, ``ServingEngine:216``).

One engine thread owns the ``LLM`` (scheduler, runner, the card) and runs
the loop; HTTP handler threads submit requests through a thread-safe
intake queue and block on per-request output queues (one chunk per
committed token; under blocks up to K tokens commit, and are put, at
once). A client that goes away aborts its request.

Request lifecycle, as in the JAX package:

- **admission control**: a bounded intake queue and a cap on resident
  requests; a submit over a limit raises :class:`RequestRejected` (HTTP
  429 or 503 with Retry-After) instead of queueing without bound.
- **deadlines**: a wall-clock budget per request
  (``SamplingParams.deadline_s``, the submit argument or
  ``EngineConfig.request_deadline_s``) ends a request still waiting or
  still generating with a terminal "deadline" chunk.
- **fault isolation**: a step that raises quarantines only the sequences
  of the entries in flight (``LLM.quarantine_step_failure``); they get
  terminal error chunks, everything else is scheduled again, and the
  engine returns to idle instead of retrying the failed step. Nothing is
  retried on another device. ``max_step_failures`` consecutive failures
  latch the engine unhealthy (readiness 503, admission closed, liveness
  up).
- **watchdog**: the engine thread beats a heartbeat every pass; a
  watchdog thread turns readiness off while the heartbeat is stale (a
  hung device call blocks the loop in collect) and back on when it
  recovers.
- **graceful drain**: ``shutdown(drain=True)`` stops admitting, lets the
  requests in flight finish (bounded), then closes every open handle with
  a terminal chunk.

Every request's span tree closes on each of its ends: a finishing output
(the engine), an abort, a deadline, a quarantine, the unhealthy latch and
shutdown (here, with the reason of the terminal chunk; the first close
wins). The unhealthy latch, a loop death and a stale heartbeat record a
``fault`` step-trace event (``engine_unhealthy``,
``dispatch_stall_detected``).

The JAX package's in-process recovery (rebuild, request journal, replay)
and its recovery events, fault injection, cross-replica continuations,
prefix pushes, disaggregation and multimodal requests are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import List, Optional

from gllm_tpu_torch.engine.llm import LLM
from gllm_tpu_torch.obs import metrics as obs
from gllm_tpu_torch.obs.steptrace import TRACE
from gllm_tpu_torch.sampling_params import SamplingParams

logger = logging.getLogger(__name__)

_M_SUBMITTED = obs.counter("gllm_requests_submitted_total",
                           "requests submitted to the serving engine")
_M_ACTIVE = obs.gauge("gllm_requests_active",
                      "requests with an open output stream")
_M_ABORTED = obs.counter("gllm_requests_aborted_total",
                         "requests aborted (client disconnect or error)")
_M_REJECTED = obs.counter(
    "gllm_requests_rejected_total",
    "submits rejected by admission control, by reason "
    "(queue_full/resident_limit/unhealthy/recovering/draining)",
    ("reason",))
_M_DEADLINE = obs.counter(
    "gllm_request_deadline_exceeded_total",
    "requests aborted because their wall-clock deadline/TTL expired")
_M_STEP_FAIL = obs.counter(
    "gllm_engine_step_failures_total",
    "engine iterations that raised (each quarantines its batch)")
_M_HEALTHY = obs.gauge(
    "gllm_engine_healthy",
    "1 while the engine accepts work; 0 after the unhealthy latch")
_M_HB_AGE = obs.gauge(
    "gllm_engine_heartbeat_age_seconds",
    "age of the engine thread's last loop-iteration heartbeat")
# 1 on the class of the latch in force, 0 on the others; all 0 while
# healthy (the JAX package's classes; stall and crash_loop belong to its
# recovery, and stay 0 here)
_M_UNHEALTHY_REASON = obs.gauge(
    "gllm_engine_unhealthy_reason",
    "why this engine is not ready: 1 on the active reason class "
    "(step_failures|stall|loop_death|crash_loop), 0 otherwise; all 0 "
    "while healthy", ("reason",))
_UNHEALTHY_REASON_CLASSES = ("step_failures", "stall", "loop_death",
                             "crash_loop")


class RequestRejected(Exception):
    """Admission control refused a submit. ``status`` is the HTTP code the
    server answers with (429 over capacity, 503 unavailable) and
    ``retry_after`` the Retry-After hint in seconds."""

    def __init__(self, reason: str, message: str, status: int = 429,
                 retry_after: float = 1.0):
        super().__init__(message)
        self.reason = reason
        self.status = status
        self.retry_after = retry_after


@dataclasses.dataclass
class StreamChunk:
    token_id: Optional[int]
    text: str
    finish_reason: Optional[str]
    # running counts, for the usage report
    num_prompt_tokens: int = 0
    num_output_tokens: int = 0
    # this token's (chosen logprob, top ids, top logprobs), when the
    # request asked for logprobs
    logprob: Optional[tuple] = None
    # every prompt position's, on the finishing chunk
    prompt_logprobs: Optional[list] = None
    # the whole output text, on the finishing chunk (a stop string's cut
    # may make it shorter than the streamed deltas)
    final_text: Optional[str] = None
    # why a request ended in a failure (quarantine, shutdown, a dead
    # engine thread); the finish reason says which kind of end it was
    error: Optional[str] = None


class RequestHandle:
    # how often a blocked reader checks that the engine thread lives
    POLL_S = 0.5

    def __init__(self, seq_id: int, prompt_len: int, engine):
        self.seq_id = seq_id
        self.prompt_len = prompt_len
        self.chunks: "queue.Queue[StreamChunk]" = queue.Queue()
        # iteration polls the engine's liveness instead of blocking
        # forever on a queue a dead engine thread will never feed
        self._engine = engine

    def __iter__(self):
        while True:
            try:
                chunk = self.chunks.get(timeout=self.POLL_S)
            except queue.Empty:
                if self._engine.is_alive:
                    continue
                # a chunk that raced in before the thread died first
                try:
                    chunk = self.chunks.get_nowait()
                except queue.Empty:
                    yield StreamChunk(None, "", "error",
                                      error="engine thread died")
                    return
            yield chunk
            if chunk.finish_reason is not None:
                return


def deliver_output(llm: LLM, out, handle: RequestHandle,
                   emitted: dict) -> None:
    """One SeqOutput as a StreamChunk on its request's queue: the new
    text is the part of ``seq.output_text`` beyond what the handle has
    streamed (the engine's stop-string scan may have detokenized it
    already)."""
    text = ""
    final_text = None
    if llm.tokenizer is not None:
        if out.new_token_id is not None:
            llm._stream_detokenize(out.seq)
        if out.finish_reason is not None:
            final_text = llm._finalize(out.seq).text
        full = out.seq.output_text
        text = full[emitted.get(out.seq.seq_id, 0):]
        emitted[out.seq.seq_id] = len(full)
    if out.new_token_id is not None or out.finish_reason:
        lp = None
        if out.new_token_id is not None and out.seq.output_logprobs:
            lp = out.seq.output_logprobs[-1]
        handle.chunks.put(StreamChunk(
            token_id=out.new_token_id,
            text=text,
            finish_reason=out.finish_reason,
            num_prompt_tokens=out.seq.prompt_len,
            num_output_tokens=out.seq.num_output_tokens,
            logprob=lp,
            prompt_logprobs=(out.seq.prompt_logprobs
                             if out.finish_reason else None),
            final_text=final_text))
    if out.finish_reason is not None:
        emitted.pop(out.seq.seq_id, None)


class ServingEngine:
    """Owns the LLM on a thread of its own; ``submit`` and ``abort`` may
    be called from any thread."""

    def __init__(self, llm: LLM):
        self.llm = llm
        cfg = llm.config
        # 0: no limit, no deadline, no watchdog
        self.max_queued_requests = cfg.max_queued_requests
        self.max_resident_requests = cfg.max_resident_requests
        self.request_deadline_s = cfg.request_deadline_s
        self.max_step_failures = max(1, cfg.max_step_failures)
        self.watchdog_stall_s = cfg.watchdog_stall_s
        self.drain_timeout_s = cfg.drain_timeout_s

        self._intake: "queue.Queue" = queue.Queue()
        # calls to run on the engine thread between steps (run_on_engine)
        self._calls: "queue.Queue" = queue.Queue()
        self._handles: dict[int, RequestHandle] = {}
        self._seqs: dict[int, object] = {}
        self._emitted: dict[int, int] = {}   # seq_id → characters streamed
        self._deadlines: dict[int, float] = {}  # seq_id → monotonic time
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._draining = False
        self._healthy = True
        self._stalled = False
        self._failed_steps = 0          # consecutive; reset by a success
        self._heartbeat = time.monotonic()
        self._unhealthy_reason = ""          # detail for /readyz
        self._unhealthy_class = ""           # the metric's reason class
        _M_HEALTHY.set(1)
        for c in _UNHEALTHY_REASON_CLASSES:
            _M_UNHEALTHY_REASON.set(0, reason=c)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gllm-engine")
        self._thread.start()
        self._watchdog: Optional[threading.Thread] = None
        if self.watchdog_stall_s > 0:
            self._watchdog = threading.Thread(target=self._watch,
                                              daemon=True,
                                              name="gllm-watchdog")
            self._watchdog.start()

    # ---- health / readiness (any thread) ----------------------------------

    @property
    def is_alive(self) -> bool:
        """Liveness (/healthz): the engine thread runs."""
        return not self._stop and self._thread.is_alive()

    @property
    def heartbeat_age(self) -> float:
        return time.monotonic() - self._heartbeat

    def readiness(self) -> tuple:
        """(ready, reason): may this engine take new requests (/readyz)?
        An unready engine still answers liveness."""
        if not self.is_alive:
            return False, "dead"
        if not self._healthy:
            return False, "unhealthy"
        if self._draining:
            return False, "draining"
        if self._stalled:
            return False, "stalled"
        return True, "ok"

    def retry_after_s(self) -> float:
        """The Retry-After hint of the current readiness state: long for
        the (permanent) unhealthy latch, short otherwise."""
        return 30.0 if not self._healthy else 5.0

    def health(self) -> dict:
        age = self.heartbeat_age
        _M_HB_AGE.set(age)
        ready, why = self.readiness()
        with self._lock:
            resident = len(self._handles)
        return {"alive": self.is_alive, "ready": ready, "reason": why,
                "healthy": self._healthy, "draining": self._draining,
                "stalled": self._stalled,
                "unhealthy_reason": self._unhealthy_class or None,
                "unhealthy_detail": self._unhealthy_reason or None,
                "retry_after_s": round(self.retry_after_s(), 2),
                "heartbeat_age_s": round(age, 3),
                "consecutive_step_failures": self._failed_steps,
                "resident_requests": resident,
                "queued_requests": self._intake.qsize()}

    # ---- client-facing (any thread) ---------------------------------------

    def _admit(self) -> None:
        """Admission control: raises RequestRejected instead of letting
        the intake queue grow without bound (limits of 0: none)."""
        if not self._healthy:
            _M_REJECTED.inc(reason="unhealthy")
            raise RequestRejected(
                "unhealthy", "engine is unhealthy (latched after "
                "repeated step failures)", status=503, retry_after=30.0)
        if self._draining or self._stop:
            _M_REJECTED.inc(reason="draining")
            raise RequestRejected("draining", "engine is shutting down",
                                  status=503, retry_after=5.0)
        if self.max_resident_requests:
            with self._lock:
                resident = len(self._handles)
            if resident >= self.max_resident_requests:
                _M_REJECTED.inc(reason="resident_limit")
                raise RequestRejected(
                    "resident_limit",
                    f"{resident} requests resident (limit "
                    f"{self.max_resident_requests})",
                    status=429, retry_after=1.0)
        if self.max_queued_requests \
                and self._intake.qsize() >= self.max_queued_requests:
            _M_REJECTED.inc(reason="queue_full")
            raise RequestRejected(
                "queue_full",
                f"intake queue full (limit {self.max_queued_requests})",
                status=429, retry_after=1.0)

    def submit(self, token_ids: List[int],
               sampling_params: SamplingParams,
               deadline_s: Optional[float] = None) -> RequestHandle:
        sampling_params.validate()
        self._admit()
        ttl = (deadline_s if deadline_s is not None
               else sampling_params.deadline_s
               if sampling_params.deadline_s is not None
               else self.request_deadline_s)
        with self._lock:
            seq = self.llm._allocate_seq(token_ids, sampling_params)
            handle = RequestHandle(seq.seq_id, len(token_ids), self)
            self._handles[seq.seq_id] = handle
            self._seqs[seq.seq_id] = seq
            if ttl and ttl > 0:
                self._deadlines[seq.seq_id] = time.monotonic() + ttl
            _M_SUBMITTED.inc()
            _M_ACTIVE.set(len(self._handles))
        self._intake.put(seq)
        self._wake.set()
        return handle

    def abort(self, seq_id: int) -> None:
        self.llm.abort(seq_id)
        self._wake.set()

    def run_on_engine(self, fn, timeout: float = 60.0):
        """Run ``fn()`` on the engine thread between two steps (what must
        happen on the thread that drives the device, such as starting and
        stopping a profiler) and return its result; its exception is
        raised here."""
        call = {"fn": fn, "done": threading.Event()}
        self._calls.put(call)
        self._wake.set()
        if not call["done"].wait(timeout):
            raise TimeoutError("the engine thread did not run the call")
        if "error" in call:
            raise call["error"]
        return call.get("result")

    def _run_calls(self) -> None:
        while True:
            try:
                call = self._calls.get_nowait()
            except queue.Empty:
                return
            try:
                call["result"] = call["fn"]()
            except Exception as e:  # noqa: BLE001 — raised by the caller
                call["error"] = e
            call["done"].set()

    def shutdown(self, drain: bool = False,
                 timeout: Optional[float] = None) -> None:
        """Stop the engine. ``drain`` first stops admitting and waits (at
        most ``timeout``, else ``drain_timeout_s``) for the requests in
        flight to finish; either way every handle still open gets a
        terminal chunk, so no HTTP thread waits forever."""
        self._draining = True
        if drain:
            limit = time.monotonic() + (timeout if timeout is not None
                                        else self.drain_timeout_s)
            while time.monotonic() < limit:
                with self._lock:
                    if not self._handles and self._intake.empty():
                        break
                time.sleep(0.01)
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)
        # the loop's finally closed the handles if the thread ended; this
        # is the backstop for a hung thread
        self._close_open_handles("abort", "engine shutdown")

    # ---- engine thread ----------------------------------------------------

    def _run(self) -> None:
        try:
            self._run_loop()
        except Exception as e:
            logger.exception("engine loop died")
            if self._healthy:
                why = f"engine loop died: {type(e).__name__}: {e}"
                self._set_unhealthy_reason("loop_death", why)
                TRACE.record("fault", point="engine_unhealthy",
                             error=why[:200])
            self._healthy = False
            _M_HEALTHY.set(0)
        finally:
            self._close_open_handles("abort", "engine stopped")

    def _run_loop(self) -> None:
        llm = self.llm
        busy = False
        while not self._stop:
            self._heartbeat = time.monotonic()
            drained = False
            while True:
                try:
                    seq = self._intake.get_nowait()
                except queue.Empty:
                    break
                try:
                    llm.add_seq(seq)
                except ValueError as e:
                    self._deliver_error(seq.seq_id, "error", str(e))
                drained = True
            self._run_calls()
            self._expire_deadlines()
            if not llm.has_unfinished:
                if busy:
                    # the scheduler's gauges read the idle state at once,
                    # not at its next pass
                    llm.scheduler.publish_stats()
                    busy = False
                if not drained:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            busy = True
            try:
                outputs = llm.step()
            except Exception as e:
                logger.exception("engine step failed")
                self._on_step_failure(e)
                continue
            self._failed_steps = 0
            for out in outputs:
                handle = self._handles.get(out.seq.seq_id)
                if handle is None:
                    continue
                deliver_output(llm, out, handle, self._emitted)
                if out.finish_reason is not None:
                    with self._lock:
                        self._handles.pop(out.seq.seq_id, None)
                        self._seqs.pop(out.seq.seq_id, None)
                        self._deadlines.pop(out.seq.seq_id, None)
                        _M_ACTIVE.set(len(self._handles))
                    self._emitted.pop(out.seq.seq_id, None)
            # an aborted sequence gives no SeqOutput: its stream closes here
            self._reap_aborted()

    # ---- fault isolation --------------------------------------------------

    def _on_step_failure(self, exc: BaseException) -> None:
        """Quarantine the failed step's sequences; latch unhealthy after
        ``max_step_failures`` consecutive failures."""
        _M_STEP_FAIL.inc()
        self._failed_steps += 1
        detail = f"{type(exc).__name__}: {exc}"
        try:
            failed = self.llm.quarantine_step_failure()
        except Exception:
            logger.exception("quarantine after step failure failed")
            self._latch_unhealthy(f"unrecoverable step failure: {detail}")
            return
        # latch before the terminal chunks go out: a client whose request
        # just failed may probe /readyz at once
        if self._failed_steps >= self.max_step_failures:
            self._latch_unhealthy(
                f"{self._failed_steps} consecutive step failures "
                f"(last: {detail})")
        for sid in failed:
            self._deliver_error(sid, "error", detail)

    def _latch_unhealthy(self, why: str) -> None:
        if not self._healthy:
            return
        logger.error("engine latched unhealthy: %s", why)
        self._set_unhealthy_reason("step_failures", why)
        self._healthy = False
        _M_HEALTHY.set(0)
        TRACE.record("fault", point="engine_unhealthy", error=why[:200])
        try:
            self.llm.quarantine_step_failure(everything=True)
        except Exception:  # pragma: no cover
            logger.exception("full quarantine failed")
        self._close_open_handles("error", why)

    def _set_unhealthy_reason(self, cls: str, detail: str) -> None:
        self._unhealthy_class = cls
        self._unhealthy_reason = detail
        for c in _UNHEALTHY_REASON_CLASSES:
            _M_UNHEALTHY_REASON.set(1 if c == cls else 0, reason=c)

    def _expire_deadlines(self) -> None:
        """Abort the requests past their wall-clock budget, those still
        waiting unscheduled too."""
        if not self._deadlines:
            return
        now = time.monotonic()
        with self._lock:
            expired = [sid for sid, t in self._deadlines.items()
                       if now >= t]
        for sid in expired:
            self.llm.abort(sid)
            _M_DEADLINE.inc()
            self._deliver_error(sid, "deadline")

    def _reap_aborted(self):
        with self._lock:
            dead = [sid for sid, seq in self._seqs.items()
                    if seq.is_finished]
            for sid in dead:
                self._seqs.pop(sid, None)
        for sid in dead:
            self._deliver_error(sid, "abort")

    def _deliver_error(self, seq_id: int, reason: str,
                       detail: Optional[str] = None) -> None:
        if self.llm.tracing:
            # an abort, deadline or error never reaches the engine's
            # finish path: the tree closes with the terminal chunk's reason
            self.llm.spans.finish(seq_id, reason or "error",
                                  time.monotonic())
        with self._lock:
            handle = self._handles.pop(seq_id, None)
            self._seqs.pop(seq_id, None)
            self._deadlines.pop(seq_id, None)
            _M_ACTIVE.set(len(self._handles))
        self._emitted.pop(seq_id, None)
        if handle is not None:
            _M_ABORTED.inc()
            handle.chunks.put(StreamChunk(None, "", reason or "error",
                                          error=detail))

    def _close_open_handles(self, reason: str,
                            detail: Optional[str] = None) -> None:
        """A terminal chunk for every open stream (an engine-wide failure
        or shutdown)."""
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
            self._seqs.clear()
            self._emitted.clear()
            self._deadlines.clear()
            _M_ACTIVE.set(0)
        if handles:
            _M_ABORTED.inc(len(handles))
        if self.llm.tracing:
            now = time.monotonic()
            for h in handles:
                self.llm.spans.finish(h.seq_id, reason or "error", now)
        for h in handles:
            h.chunks.put(StreamChunk(None, "", reason, error=detail))

    # ---- watchdog ---------------------------------------------------------

    def _watch(self) -> None:
        """Turn readiness off while the engine thread's heartbeat is older
        than ``watchdog_stall_s`` (a hung device call blocks the loop in
        collect), and back on when it beats again. Liveness is untouched:
        a supervisor restarts on /healthz, a balancer routes on
        /readyz."""
        stall = self.watchdog_stall_s
        interval = max(0.02, min(stall / 4.0, 1.0))
        while not self._stop:
            time.sleep(interval)
            if not self._thread.is_alive():
                return
            age = time.monotonic() - self._heartbeat
            _M_HB_AGE.set(age)
            if age > stall:
                if not self._stalled:
                    self._stalled = True
                    TRACE.record("fault", point="dispatch_stall_detected",
                                 age_s=round(age, 3))
                    logger.error(
                        "engine heartbeat stale %.2fs (> %.2fs): "
                        "readiness off", age, stall)
            elif self._stalled:
                self._stalled = False
                logger.info("engine heartbeat recovered: readiness on")
