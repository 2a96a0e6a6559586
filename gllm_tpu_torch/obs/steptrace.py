"""Ring-buffer step-trace event log, stdlib only (counterpart of
``gllm_tpu/obs/steptrace.py``, a copy: ``StepTrace:106``, ``TRACE:179``,
``summarize:182`` and the event catalogues ``:90-103``).

Every collected engine entry appends one small dict (kind, batch size,
token counts, wall ms, the host phases, the device wall and the MFU and
HBM estimates) to a fixed-capacity ring; compile events (a graph key's
first sighting), chain breaks, loop stalls, prefix probes, quarantines
and faults ride the same ring. The api_server dumps it as JSON
(``GET /steptrace``), ``summarize`` reduces a window of it to the
attribution a benchmark reads, and ``python -m gllm_tpu_torch.obs.dump``
pretty-prints a saved JSONL.

Overhead: one dict and one list slot assignment per collected entry (not
per token, not per layer), behind a lock only the host takes. Nothing
here touches a tensor. ``GLLM_OBS_TRACE_CAP`` sizes the ring (8192).
The kinds ``pp_stage`` and ``recovery`` belong to options this port does
not run yet; they stay in the catalogue so that the two packages'
summaries read the same.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

__all__ = ["StepTrace", "TRACE", "summarize"]

# Step-event kinds recorded by the engine/runner instrumentation:
#   prefill      - step whose batch carries at least one prefill chunk
#                  (retired under --unified-step: see unified_step)
#   decode       - single-step pure-decode dispatch (the UNfused path;
#                  retired under --unified-step: see unified_step)
#   unified_step - one unified mixed-batch dispatch (--unified-step,
#                  docs/overlap_scheduling.md#unified-step): the single
#                  step kind replacing prefill/decode when the flag is
#                  on — the ``mix`` field ("decode" | "mixed") keeps the
#                  composition readable (summarize() folds mix=decode
#                  into the unfused-decode accounting and reports
#                  mixed_step_frac over the window)
#   fused_block  - multi-step decode block (one dispatch, K sub-steps);
#                  under fused on-device speculation
#                  (config.spec_fused) the event also carries
#                  ``k_drafted`` / ``k_accepted`` (draft rows proposed /
#                  accepted on device) and ``tokens`` counts the
#                  actually-committed emission (up to K·(spec_k+1))
#   pp_stage     - one pipeline-stage dispatch of a microbatch
#   compile      - first dispatch of a new (shape-bucket, static-flag)
#                  signature: in this port a CUDA graph key's first
#                  sighting (its capture on the card), or the eager
#                  signature's under enforce_eager
#   chain_break  - overlap scheduling failed to extend a decode chain;
#                  carries a ``reason`` field (docs/overlap_scheduling.md
#                  taxonomy): waiting (prefill pressure / unseated ready
#                  seqs), pages (KV pool), shape (compaction, non-decode
#                  batch, host-work features), spec (host-driven
#                  speculation owns dispatch — retired, zero, under
#                  --spec-fused), finish (legacy membership loss — zero under
#                  --decode-slot-batching), reform (unified step: the
#                  chain re-formed through a mixed/grown batch instead
#                  of waiting — 'waiting' is retired, zero with
#                  --unified-step on)
#   fault        - a robustness event (docs/robustness.md): an injected
#                  fault point fired (``point`` field names it), the
#                  watchdog detected a stale heartbeat
#                  (point=dispatch_stall_detected), or the engine latched
#                  unhealthy (point=engine_unhealthy)
#   quarantine   - a step exception was isolated: the failed dispatch's
#                  sequences were aborted (``num_seqs``), everything else
#                  rescheduled
#   prefix       - one prefix-cache admission probe
#                  (PrefixMemoryManager.match_prefix): ``query_tokens``,
#                  ``hit_tokens``, and ``pages`` — claimed page counts
#                  keyed by the serving tier (hbm/host/disk/peer,
#                  docs/kv_offload.md)
#   loop_stall   - the pipelined engine loop failed to run further ahead
#                  (config.pipelined_loop); ``reason``: readback (the
#                  next step needs host-committed state), rebuild
#                  (promised-vs-actual divergence invalidated speculated
#                  entries — ``invalidated`` counts them), pages (no KV
#                  room to speculate), depth (the overlap_depth cap was
#                  binding); ``depth`` = in-flight entries at the stall
#
# Step events (prefill/decode/fused_block) additionally carry the
# performance-attribution fields (docs/observability.md#tracing):
# ``ph`` = host wall by engine phase {schedule, build, dispatch,
# collect} in ms, ``step_wall_ms`` = schedule-start → collect-end,
# ``dev_ms`` = device wall attributed back to the launching step
# (block-until-ready delta at collect), and optional ``mfu`` /
# ``hbm_gbps`` estimates from the step FLOPs model (obs/spans.py). In this
# port a step whose body ran op by op also carries ``eager`` (the
# reason: enforce_eager, hybrid): the card worked through it while the
# host enqueued it, so its ``dev_ms`` misses that time.
STEP_KINDS = ("prefill", "decode", "unified_step", "fused_block",
              "pp_stage", "compile", "chain_break", "fault",
              "quarantine", "prefix", "loop_stall", "recovery")
# recovery (config.engine_recovery, docs/robustness.md#recovery-
# lifecycle) event phases: begin (latch handed to the supervisor),
# partition (streams split into replayable vs dropped), rebuild_fail
# (one factory attempt raised; backoff doubles), ready (rebuilt engine
# adopted — carries recovery_s/replayed/dropped), crash_loop (K failed
# rebuilds within the window → permanent unhealthy).
RECOVERY_PHASES = ("begin", "partition", "rebuild_fail", "ready",
                   "crash_loop")
CHAIN_BREAK_REASONS = ("waiting", "pages", "shape", "spec", "finish",
                       "reform")
LOOP_STALL_REASONS = ("readback", "rebuild", "pages", "depth")


class StepTrace:
    """Fixed-capacity ring of event dicts with monotonically increasing
    sequence numbers (``mark()``/``events(since=...)`` bracket a window
    even across rollover)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(os.environ.get("GLLM_OBS_TRACE_CAP", "8192"))
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._buf: List[Optional[dict]] = [None] * capacity
        self._next_seq = 0               # total events ever recorded
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def record(self, kind: str, **fields) -> None:
        ev = {"seq": 0, "t": 0.0, "kind": kind}
        ev.update(fields)
        with self._lock:
            ev["seq"] = self._next_seq
            ev["t"] = round(time.monotonic() - self._t0, 6)
            self._buf[self._next_seq % self.capacity] = ev
            self._next_seq += 1

    def mark(self) -> int:
        """Current sequence number; pass to ``events(since=...)`` to read
        only what was recorded after this point."""
        with self._lock:
            return self._next_seq

    @property
    def t0(self) -> float:
        """The ring's monotonic epoch — event ``t`` fields are relative
        to this; the chrome exporter rebases span timestamps onto it."""
        with self._lock:
            return self._t0

    def __len__(self) -> int:
        with self._lock:
            return min(self._next_seq, self.capacity)

    @property
    def dropped(self) -> int:
        """Events lost to rollover since construction/clear."""
        with self._lock:
            return max(0, self._next_seq - self.capacity)

    def events(self, since: int = 0, kinds: Optional[Iterable[str]] = None
               ) -> List[dict]:
        with self._lock:
            first = max(since, self._next_seq - self.capacity)
            out = [self._buf[s % self.capacity]
                   for s in range(first, self._next_seq)]
        if kinds is not None:
            ks = set(kinds)
            out = [e for e in out if e["kind"] in ks]
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._next_seq = 0
            self._t0 = time.monotonic()

    def to_jsonl(self, path: str, since: int = 0) -> int:
        evs = self.events(since)
        with open(path, "w") as f:
            for e in evs:
                f.write(json.dumps(e) + "\n")
        return len(evs)


TRACE = StepTrace()


def summarize(events: List[dict]) -> dict:
    """Attribute wall time by step kind over a window of events.

    Returns a machine-readable blob answering "where did the measured
    pass go": per-kind {steps, wall_ms, tokens, ms_per_step}, fused
    decode sub-step totals, the unfused share of decode wall time (the
    unfused-decode class of finding), and compile/chain-break counts.
    """
    kinds: Dict[str, dict] = {}
    fused_steps = unfused_steps = 0
    fused_ms = unfused_ms = 0.0
    total_ms = 0.0
    # unified-step composition (--unified-step): collected step events
    # vs the share of them that carried at least one prefill row
    step_events = unified_mixed = 0
    compiles = chain_breaks = 0
    break_reasons: Dict[str, int] = {}
    faults_total = quarantines = 0
    fault_points: Dict[str, int] = {}
    # self-healing recovery (config.engine_recovery): completed
    # supervised rebuilds over the window, requests replayed across
    # them, failed rebuild attempts, and total latch-to-ready wall
    recoveries = rebuild_failures = requests_replayed = 0
    recovery_s_total = 0.0
    # pipelined-loop stalls (loop_stall events) + the sustained run-ahead
    # depth (the ``inflight`` field step events carry)
    loop_stalls = 0
    stall_reasons: Dict[str, int] = {}
    inflight_sum = inflight_n = 0
    # on-device finish attribution (fused_block events carry k_exec /
    # dead_substeps when config.ondevice_finish is on): wasted sub-step
    # share of all executed row-sub-steps over the window
    dead_rows = exec_rows = 0
    # fused on-device speculation (config.spec_fused; fused_block
    # events carry k_drafted / k_accepted): window acceptance rate +
    # committed tokens per device dispatch
    spec_drafted = spec_accepted = 0
    total_tokens = dispatches = 0
    # prefix-cache attribution: per-window hit rate + tier split
    pfx_queries = pfx_query_tokens = pfx_hit_tokens = 0
    pfx_pages: Dict[str, int] = {}
    # engine-loop phase breakdown + device-wall attribution (events
    # carrying ``ph``/``dev_ms`` — docs/observability.md#tracing)
    host_phase: Dict[str, float] = {}
    dev_by_kind: Dict[str, float] = {}
    dev_total = hidden_total = 0.0
    mfu_dev = hbm_dev = 0.0          # Σ(estimate · dev_ms) numerators
    mfu_seen = hbm_seen = False
    t_first_start = t_last_end = None
    for e in events:
        k = e["kind"]
        if k == "prefix":
            pfx_queries += 1
            pfx_query_tokens += int(e.get("query_tokens", 0))
            pfx_hit_tokens += int(e.get("hit_tokens", 0))
            for tier, n in (e.get("pages") or {}).items():
                pfx_pages[tier] = pfx_pages.get(tier, 0) + int(n)
            continue
        if k == "compile":
            compiles += 1
            continue
        if k == "chain_break":
            chain_breaks += 1
            r = e.get("reason", "unknown")
            break_reasons[r] = break_reasons.get(r, 0) + 1
            continue
        if k == "fault":
            faults_total += 1
            p = e.get("point", "unknown")
            fault_points[p] = fault_points.get(p, 0) + 1
            continue
        if k == "quarantine":
            quarantines += 1
            continue
        if k == "recovery":
            ph_name = e.get("phase", "")
            if ph_name == "ready":
                recoveries += 1
                requests_replayed += int(e.get("replayed", 0))
                if e.get("recovery_s") is not None:
                    recovery_s_total += float(e["recovery_s"])
            elif ph_name == "rebuild_fail":
                rebuild_failures += 1
            continue
        if k == "loop_stall":
            loop_stalls += 1
            r = e.get("reason", "unknown")
            stall_reasons[r] = stall_reasons.get(r, 0) + 1
            continue
        if k == "pp_stage":
            continue                     # dispatch-side only; no wall
        if e.get("inflight") is not None:
            inflight_sum += int(e["inflight"])
            inflight_n += 1
        row = kinds.setdefault(k, {"steps": 0, "wall_ms": 0.0,
                                   "tokens": 0})
        row["steps"] += 1
        wall = float(e.get("wall_ms", 0.0))
        row["wall_ms"] += wall
        total_ms += wall
        row["tokens"] += int(e.get("tokens", 0))
        total_tokens += int(e.get("tokens", 0))
        dispatches += 1
        if e.get("k_drafted") is not None:
            spec_drafted += int(e["k_drafted"])
            spec_accepted += int(e.get("k_accepted", 0))
        ph = e.get("ph")
        if isinstance(ph, dict):
            for name, ms in ph.items():
                host_phase[name] = host_phase.get(name, 0.0) + float(ms)
            dev = float(e.get("dev_ms", 0.0))
            dev_by_kind[k] = dev_by_kind.get(k, 0.0) + dev
            dev_total += dev
            coll = float(ph.get("collect", wall))
            hidden_total += max(0.0, dev - coll)
            if e.get("mfu") is not None:
                mfu_seen = True
                mfu_dev += float(e["mfu"]) * dev
            if e.get("hbm_gbps") is not None:
                hbm_seen = True
                hbm_dev += float(e["hbm_gbps"]) * dev
            start = float(e["t"]) - float(
                e.get("step_wall_ms", wall)) / 1e3
            if t_first_start is None or start < t_first_start:
                t_first_start = start
            if t_last_end is None or float(e["t"]) > t_last_end:
                t_last_end = float(e["t"])
        step_events += 1
        if k == "decode" or (k == "unified_step"
                             and e.get("mix") == "decode"):
            unfused_steps += 1
            unfused_ms += wall
        elif k == "unified_step":
            unified_mixed += 1
        elif k == "fused_block":
            fused_steps += int(e.get("k", 1))
            fused_ms += wall
            if "dead_substeps" in e:
                dead_rows += int(e["dead_substeps"])
                exec_rows += (int(e.get("k_exec", e.get("k", 1)))
                              * int(e.get("num_seqs", 0)))
    for row in kinds.values():
        row["wall_ms"] = round(row["wall_ms"], 2)
        row["ms_per_step"] = round(row["wall_ms"] / row["steps"], 2)
    decode_ms = fused_ms + unfused_ms
    # window wall: first step's schedule-start → last step's collect-end
    elapsed_ms = ((t_last_end - t_first_start) * 1e3
                  if t_first_start is not None
                  and t_last_end > t_first_start else 0.0)
    return {
        "by_kind": kinds,
        "decode_steps_unfused": unfused_steps,
        "decode_substeps_fused": fused_steps,
        "unfused_decode_wall_frac": (round(unfused_ms / decode_ms, 4)
                                     if decode_ms else None),
        # unfused share of the WHOLE window's wall (prefill included) —
        # the regression class bench.py promotes to its result JSON
        "unfused_frac": (round(unfused_ms / total_ms, 4)
                         if total_ms else None),
        # wasted (dead-row) sub-step share of executed fused-block work;
        # None when no block reported finish steps (ondevice_finish off)
        "dead_substep_frac": (round(dead_rows / exec_rows, 4)
                              if exec_rows else None),
        # fused on-device speculation (config.spec_fused): window draft
        # acceptance rate (None when no block drafted) and committed
        # tokens per collected device dispatch — the dispatch-
        # amortization headline the fused path must raise
        "spec_accept_rate": (round(spec_accepted / spec_drafted, 4)
                             if spec_drafted else None),
        "tokens_per_dispatch": (round(total_tokens / dispatches, 2)
                                if dispatches else None),
        # unified step (--unified-step): share of collected step
        # dispatches that were MIXED unified batches (prefill rows
        # riding the decode stream — chains absorbing arrivals); None
        # when the window saw no unified_step events (flag off)
        "mixed_step_frac": (round(unified_mixed / step_events, 4)
                            if step_events and "unified_step" in kinds
                            else None),
        # per-window prefix-cache hit rate by tier (None when the window
        # saw no admission probes — prefix caching off or pure decode)
        "prefix": ({
            "queries": pfx_queries,
            "query_tokens": pfx_query_tokens,
            "hit_tokens": pfx_hit_tokens,
            "hit_rate": (round(pfx_hit_tokens / pfx_query_tokens, 4)
                         if pfx_query_tokens else 0.0),
            "pages_by_tier": pfx_pages,
        } if pfx_queries else None),
        # ---- performance attribution (docs/observability.md#tracing;
        # None/{} when the window's events predate the tracing layer) --
        # host wall by engine-loop phase over the window
        "host_ms_by_phase": ({k: round(v, 2)
                              for k, v in host_phase.items()}
                             if host_phase else None),
        # device wall (block-until-ready deltas) attributed by step kind
        "device_ms_by_kind": ({k: round(v, 2)
                               for k, v in dev_by_kind.items()}
                              if dev_by_kind else None),
        # share of device wall hidden under host work (1 = the host
        # never blocked on the device; 0 = fully synchronous)
        "overlap_efficiency": (round(hidden_total / dev_total, 4)
                               if dev_total > 0 else None),
        # share of the window's wall clock with the device idle — the
        # gLLM bubble ratio, reproduced from engine-side attribution
        "bubble_frac": (round(max(0.0, 1.0 - dev_total / elapsed_ms), 4)
                        if elapsed_ms > 0 and dev_total > 0 else None),
        # window MFU against the wall clock (Σ step-FLOPs / peak /
        # elapsed) and against device-busy time only; None when the
        # peak is unknown (CPU without GLLM_TPU_PEAK_TFLOPS). 6 digits:
        # a tiny-model window with compile gaps sits at 1e-6 and must
        # not quantize to a fake hard zero
        "mfu": (round(mfu_dev / elapsed_ms, 6)
                if mfu_seen and elapsed_ms > 0 else None),
        "device_mfu": (round(mfu_dev / dev_total, 6)
                       if mfu_seen and dev_total > 0 else None),
        # estimated HBM read bandwidth over device-busy time (weights +
        # KV stream per step; per-device)
        "hbm_gbps": (round(hbm_dev / dev_total, 2)
                     if hbm_seen and dev_total > 0 else None),
        "compiles": compiles,
        "chain_breaks": chain_breaks,
        "chain_breaks_by_reason": break_reasons,
        # pipelined loop (docs/overlap_scheduling.md#pipelined-loop):
        # why the fill pass failed to run further ahead, and the mean
        # run-ahead depth sustained over the window's collected steps
        # (None when the window's events predate the pipelined layer)
        "loop_stalls": loop_stalls,
        "loop_stalls_by_reason": stall_reasons,
        "mean_inflight_depth": (round(inflight_sum / inflight_n, 2)
                                if inflight_n else None),
        "faults": faults_total,
        "faults_by_point": fault_points,
        "quarantines": quarantines,
        # supervised in-process recovery (config.engine_recovery):
        # completed rebuilds over the window, their total latch-to-ready
        # wall, failed rebuild attempts, and requests replayed across
        # the rebuilds (docs/robustness.md#recovery-lifecycle)
        "recoveries": recoveries,
        "recovery_s": (round(recovery_s_total, 3) if recoveries
                       else None),
        "rebuild_failures": rebuild_failures,
        "requests_replayed": requests_replayed,
    }
