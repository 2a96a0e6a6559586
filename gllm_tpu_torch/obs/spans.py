"""Performance-attribution layer: request-scoped spans, a step FLOPs
model, the card's peak-FLOPs table and the Chrome-trace converter, stdlib
only (counterpart of ``gllm_tpu/obs/spans.py``: ``SpanTrace:67``,
``SPANS:210``, ``peak_flops:224``, ``StepFlopsModel:245-310``,
``chrome_trace:337``; the same arithmetic and the same track layout).

- :class:`SpanTrace` — one span tree per request
  (queued → prefill chunks → decode steps or chains → detokenize →
  finish), completed trees held in a bounded ring like the steptrace;
- :class:`StepFlopsModel` — matmul-path FLOPs per engine step from the
  model config, feeding the ``gllm_step_mfu`` gauge and the per-window
  MFU of ``steptrace.summarize``;
- :func:`peak_flops` — dense bf16 FLOP/s of a CUDA card by its name
  (``torch.cuda.get_device_name()``), 0 when unknown (the CPU);
- :func:`chrome_trace` — steptrace step events + request spans →
  Chrome trace-event JSON (Perfetto / chrome://tracing loadable): one
  track per engine phase, one per request. Shared by ``GET /trace`` and
  ``python -m gllm_tpu_torch.obs.dump --format chrome``.

No tensor is read here and nothing runs on the device: every recorded
number is host arithmetic the engine already had. Span recording is
gated by ``EngineConfig.tracing`` (default on); the steptrace stays on
either way. ``GLLM_OBS_SPAN_CAP`` bounds the completed ring (1024),
``GLLM_OBS_SPAN_OPEN`` the open trees (4096) and
``GLLM_OBS_SPAN_PHASES`` a tree's child list (512).
"""

from __future__ import annotations

import logging
import os
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["SpanTrace", "SPANS", "StepFlopsModel", "peak_flops",
           "chrome_trace", "SPAN_PHASES", "ENGINE_PHASES", "PEAK_TFLOPS"]

# Span phase taxonomy: the child spans a request tree may carry.
# ``queued`` = arrival → first schedule; ``prefill_chunk`` = one scheduled
# prompt chunk (dispatch → collect); ``decode_step`` = one single decode
# dispatch carrying the request; ``decode_chain`` = one fused block (k
# sub-steps, ``k_exec`` executed under on-device finish); ``detokenize``
# = accumulated host detokenization time (one rolled-up span at finish).
SPAN_PHASES = ("queued", "prefill_chunk", "decode_step", "decode_chain",
               "detokenize")

# Engine-loop host phases recorded on every step event (``ph`` field):
# schedule (scheduler passes forming the batch or chain), build (the
# runner's host work up to the launch: the batch build, its upload and a
# first-sight capture), dispatch (the graph replay or eager launch and the
# copy of the tokens out), collect (host blocked on the handle). ``wait``
# is derived: the slack between dispatch end and collect start while the
# handle rode the pipeline (device work hides here). ``device`` is the
# wait-for-tokens delta attributed back to the launching step.
ENGINE_PHASES = ("schedule", "build", "dispatch", "collect")


class SpanTrace:
    """Bounded per-request span trees.

    Open trees live in a dict keyed by seq_id (bounded by ``max_open``
    — beyond it new requests go untracked, counted in ``untracked``);
    ``finish`` moves a tree into a fixed-capacity completed ring.
    A tree caps its child-phase list at ``max_phases``; later events
    roll up into per-phase ``{n, ms}`` aggregates instead of growing
    without bound (a 10k-token decode must not hold 10k dicts).
    """

    def __init__(self, capacity: Optional[int] = None,
                 max_open: Optional[int] = None,
                 max_phases: Optional[int] = None):
        if capacity is None:
            capacity = int(os.environ.get("GLLM_OBS_SPAN_CAP", "1024"))
        if max_open is None:
            max_open = int(os.environ.get("GLLM_OBS_SPAN_OPEN", "4096"))
        if max_phases is None:
            max_phases = int(os.environ.get("GLLM_OBS_SPAN_PHASES",
                                            "512"))
        if capacity <= 0 or max_open <= 0 or max_phases <= 0:
            raise ValueError("span bounds must be positive")
        self.capacity = capacity
        self.max_open = max_open
        self.max_phases = max_phases
        self._lock = threading.Lock()
        self._open: Dict[int, dict] = {}
        self._done: deque = deque(maxlen=capacity)
        self._finished = 0          # lifetime completed-span count
        self.untracked = 0          # begins refused by the open bound

    # ---- lifecycle ---------------------------------------------------------

    def begin(self, seq_id: int, arrival_t: float, admitted_t: float,
              prompt_tokens: int = 0) -> None:
        """Open a request tree at admission; records the ``queued``
        phase [arrival → first schedule]. Idempotent per seq_id."""
        with self._lock:
            if seq_id in self._open:
                return
            if len(self._open) >= self.max_open:
                self.untracked += 1
                return
            rec = {"seq_id": seq_id, "t0": arrival_t, "t1": None,
                   "reason": None, "prompt_tokens": prompt_tokens,
                   "output_tokens": 0, "phases": [], "agg": {}}
            self._open[seq_id] = rec
        if admitted_t > arrival_t:
            self.event(seq_id, "queued", arrival_t,
                       (admitted_t - arrival_t) * 1e3)

    def event(self, seq_id: int, ph: str, t: float, dur_ms: float,
              **meta) -> None:
        """Append one child span (monotonic start ``t``, ``dur_ms``)
        to an open tree; silently dropped when the request is
        untracked (holes, bounded-out requests, tracing off)."""
        with self._lock:
            self._event_locked(seq_id, ph, t, dur_ms, meta)

    def event_many(self, seq_ids, ph: str, t: float, dur_ms: float,
                   meta: Optional[dict] = None) -> None:
        """One identical child span for many requests (a decode batch's
        rows all share one dispatch→collect interval) under a SINGLE
        lock acquisition — the engine hot path records one of these per
        step, so per-row locking would be the dominant tracing cost."""
        with self._lock:
            for sid in seq_ids:
                self._event_locked(sid, ph, t, dur_ms, meta)

    def _event_locked(self, seq_id, ph, t, dur_ms, meta) -> None:
        rec = self._open.get(seq_id)
        if rec is None:
            return
        if len(rec["phases"]) >= self.max_phases:
            agg = rec["agg"].setdefault(ph, {"n": 0, "ms": 0.0})
            agg["n"] += 1
            agg["ms"] += dur_ms
            return
        ev = {"ph": ph, "t": t, "dur_ms": round(dur_ms, 3)}
        if meta:
            ev.update(meta)
        rec["phases"].append(ev)

    def finish(self, seq_id: int, reason: str, t: float,
               output_tokens: int = 0, **meta) -> Optional[dict]:
        """Close a request tree (first close wins — abort/deadline/
        quarantine and the normal output path may race) and push it
        into the completed ring."""
        with self._lock:
            rec = self._open.pop(seq_id, None)
            if rec is None:
                return None
            rec["t1"] = t
            rec["reason"] = reason
            if output_tokens:
                rec["output_tokens"] = output_tokens
            rec.update(meta)
            for ph, agg in rec["agg"].items():
                agg["ms"] = round(agg["ms"], 3)
            if not rec["agg"]:
                del rec["agg"]
            self._done.append(rec)
            self._finished += 1
            return rec

    # ---- reads -------------------------------------------------------------

    @property
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    @property
    def dropped(self) -> int:
        """Completed spans lost to ring rollover."""
        with self._lock:
            return max(0, self._finished - len(self._done))

    def spans(self) -> List[dict]:
        """Completed request trees, oldest first."""
        with self._lock:
            return list(self._done)

    def open_spans(self) -> List[dict]:
        """Still-open trees (shallow copies; phases shared)."""
        with self._lock:
            return [dict(r) for r in self._open.values()]

    def clear(self) -> None:
        with self._lock:
            self._open.clear()
            self._done.clear()
            self._finished = 0
            self.untracked = 0


# Default/standalone instance. Engine code uses a PER-LLM ``SpanTrace``
# (``LLM.spans``) — seq_ids are a per-engine counter starting at 0, so
# two co-resident engines sharing one ring would silently merge each
# other's trees (begin() idempotence absorbs the second engine's open,
# its events land in the first engine's tree). This global remains the
# fallback for components constructed without an engine.
SPANS = SpanTrace()


# ---- FLOPs / peak models ---------------------------------------------------

# Dense bf16 TFLOP/s by CUDA card name (data sheets), the MFU denominator,
# matched by substring against ``torch.cuda.get_device_name()`` lowercased.
# The H100 SXM's 989 TFLOP/s; the PCIe and NVL cards have other names and
# other rates, and give 0 until a row names them, as an unknown chip does.
PEAK_TFLOPS = (("NVIDIA H100 80GB HBM3", 989.0),)


def peak_flops(device_kind: str = "") -> float:
    """Peak dense bf16 FLOP/s for a card's name, or 0.0 when unknown (the
    CPU passes ""). ``GLLM_TPU_PEAK_TFLOPS`` overrides: also the lever
    that makes the MFU plumbing testable on the CPU."""
    ov = os.environ.get("GLLM_TPU_PEAK_TFLOPS")
    if ov:
        try:
            return float(ov) * 1e12
        except ValueError:
            # fall through to the table, but say so, or every MFU field
            # silently nulls while the operator believes the override
            logger.warning("ignoring malformed GLLM_TPU_PEAK_TFLOPS=%r",
                           ov)
    kind = (device_kind or "").lower()
    for tag, tf in PEAK_TFLOPS:
        if tag.lower() in kind:
            return tf * 1e12
    return 0.0


class StepFlopsModel:
    """Matmul-path FLOPs per engine step from the model config.

    The per-step counterpart of bench.py's workload-level
    ``model_flops`` — same decomposition (2×params on the matmul body
    per processed token, one lm_head row per sampling sequence,
    causal token×context attention at 4·Hq·D·L FLOPs per key), so a
    measured pass's per-step sum reconciles with the workload total.
    MoE configs count only the activated expert width (an estimator,
    not an audit). Pure integer arithmetic on counts the scheduler
    already tracks — never touches the device.
    """

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 num_kv_heads: int, head_dim: int,
                 intermediate_size: int, vocab_size: int):
        qkv = hidden_size * (num_heads + 2 * num_kv_heads) * head_dim
        o_proj = num_heads * head_dim * hidden_size
        mlp = 3 * hidden_size * intermediate_size
        self.body_per_token = 2 * num_layers * (qkv + o_proj + mlp)
        self.lm_head_per_row = 2 * vocab_size * hidden_size
        # FLOPs per (query token × context token): QK^T + PV
        self.attn_coeff = 4 * num_layers * num_heads * head_dim

    @classmethod
    def from_model_config(cls, mc) -> "StepFlopsModel":
        inter = mc.intermediate_size
        experts = getattr(mc, "num_experts_per_tok", 0) or 0
        moe_inter = getattr(mc, "moe_intermediate_size", 0) or 0
        if experts and moe_inter:
            inter = experts * moe_inter       # activated width only
        return cls(mc.num_layers, mc.hidden_size, mc.num_heads,
                   mc.num_kv_heads, mc.head_dim or 0, inter,
                   mc.vocab_size)

    def step_flops(self, rows: Iterable[tuple]) -> float:
        """One dispatch of mixed prefill/decode rows.

        ``rows``: (new_tokens, ctx_before, samples) per scheduled item
        — token j of a chunk attends ctx_before + j + 1 keys; a
        sampling row pays one lm_head projection (the runner gathers
        last-token rows before the vocab GEMM).
        """
        f = 0.0
        for n, ctx, samples in rows:
            f += n * self.body_per_token
            if samples:
                f += self.lm_head_per_row
            f += self.attn_coeff * (n * ctx + n * (n + 1) / 2.0)
        return f

    def block_flops(self, ctx_before: Iterable[int], k: int) -> float:
        """One fused decode block: ``k`` executed sub-steps over live
        rows whose contexts start at ``ctx_before`` and grow by one
        per sub-step. Dead/hole rows should not be passed (their
        forward work is real but their attention reads the dummy page
        — close enough for an estimator to skip)."""
        f = 0.0
        for ctx in ctx_before:
            f += k * (self.body_per_token + self.lm_head_per_row)
            f += self.attn_coeff * (k * ctx + k * (k + 1) / 2.0)
        return f


# ---- Chrome trace-event export ---------------------------------------------

# Track (tid) layout of the engine process row in the exported trace;
# ``wait`` and ``device`` are derived tracks (see chrome_trace).
_ENGINE_TIDS = {"schedule": 1, "build": 2, "dispatch": 3, "wait": 4,
                "collect": 5, "device": 6}
_PID_ENGINE = 1
_PID_REQUESTS = 2


def _meta(pid: int, name: str, tid: Optional[int] = None,
          thread: Optional[str] = None) -> dict:
    if tid is None:
        return {"ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": name}}
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": thread or name}}


def _x(name: str, ts_s: float, dur_s: float, pid: int, tid: int,
       args: Optional[dict] = None) -> dict:
    ev = {"name": name, "ph": "X", "ts": round(ts_s * 1e6, 1),
          "dur": round(max(0.0, dur_s) * 1e6, 1), "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def chrome_trace(step_events: Iterable[dict], spans: Iterable[dict] = (),
                 span_t0: float = 0.0) -> dict:
    """steptrace step events + request span trees → Chrome trace-event
    JSON (the ``{"traceEvents": [...]}`` object format; load in
    Perfetto or chrome://tracing).

    Engine phases are reconstructed backwards from each step event's
    collect-end timestamp ``t`` using the recorded phase walls:
    ``[t - step_wall, t]`` holds schedule → build → dispatch → wait →
    collect in order (wait = the pipelined slack between dispatch end
    and collect start), and the device track shows ``[t - dev_ms, t]``.
    Request spans use absolute monotonic times; ``span_t0`` (the
    steptrace ring's epoch) rebases them onto the same axis.
    """
    events: List[dict] = [
        _meta(_PID_ENGINE, "engine loop"),
        _meta(_PID_REQUESTS, "requests"),
    ]
    for name, tid in _ENGINE_TIDS.items():
        events.append(_meta(_PID_ENGINE, name, tid=tid))

    for e in step_events:
        ph = e.get("ph")
        if not isinstance(ph, dict):
            continue                   # compile/chain_break/... events
        end = float(e.get("t", 0.0))
        sched = float(ph.get("schedule", 0.0)) / 1e3
        build = float(ph.get("build", 0.0)) / 1e3
        disp = float(ph.get("dispatch", 0.0)) / 1e3
        coll = float(ph.get("collect", e.get("wall_ms", 0.0))) / 1e3
        wall = float(e.get("step_wall_ms",
                           (sched + build + disp + coll) * 1e3)) / 1e3
        wait = max(0.0, wall - (sched + build + disp + coll))
        args = {"kind": e.get("kind"), "seq": e.get("seq"),
                "num_seqs": e.get("num_seqs"),
                "tokens": e.get("tokens")}
        if "k" in e:
            args["k"] = e["k"]
        t = end - wall
        for name, dur in (("schedule", sched), ("build", build),
                          ("dispatch", disp), ("wait", wait),
                          ("collect", coll)):
            if dur > 0:
                events.append(_x(f"{e.get('kind', 'step')}:{name}", t,
                                 dur, _PID_ENGINE, _ENGINE_TIDS[name],
                                 args if name == "collect" else None))
            t += dur
        dev = float(e.get("dev_ms", 0.0)) / 1e3
        if dev > 0:
            dargs = dict(args)
            if e.get("mfu") is not None:
                dargs["mfu"] = e["mfu"]
            events.append(_x(f"{e.get('kind', 'step')}:device",
                             end - dev, dev, _PID_ENGINE,
                             _ENGINE_TIDS["device"], dargs))

    for rec in spans:
        sid = int(rec.get("seq_id", 0))
        t0 = float(rec.get("t0", 0.0)) - span_t0
        t1 = rec.get("t1")
        t1 = (float(t1) - span_t0) if t1 is not None else None
        events.append(_meta(_PID_REQUESTS, f"req {sid}", tid=sid))
        if t1 is not None and t1 > t0:
            events.append(_x(
                f"request {sid} ({rec.get('reason') or 'open'})", t0,
                t1 - t0, _PID_REQUESTS, sid,
                {"prompt_tokens": rec.get("prompt_tokens"),
                 "output_tokens": rec.get("output_tokens"),
                 "reason": rec.get("reason")}))
        for c in rec.get("phases", ()):
            args = {k: v for k, v in c.items()
                    if k not in ("ph", "t", "dur_ms")}
            events.append(_x(c["ph"], float(c["t"]) - span_t0,
                             float(c["dur_ms"]) / 1e3, _PID_REQUESTS,
                             sid, args or None))
    return {"traceEvents": events, "displayTimeUnit": "ms"}
