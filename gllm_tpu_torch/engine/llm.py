"""Offline LLM engine (counterpart of ``gllm_tpu/engine/llm.py``:
``LLM.__init__:167``, ``add_seq:631``, ``step:680``,
``_commit_outputs:1024``, ``_dispatch_reform:1048``, ``_chain_tip:316``,
``_fuse_ok:1490``, ``_record_logprobs:1734``,
``_record_spec_logprobs:1777``,
``unified:349``, ``_ondevice_block_stats:1139``,
``_spec_block_stats:1152``, ``_commit_spec_block:1170``, the spec set-up
``:263-307``, ``_count_ondevice_finishes:1230``, ``_schedule_multi:1475``,
``_check_stop_strings:1803``, ``_observe_outputs:1434``, ``generate:1894``,
``_stream_detokenize:2044``, ``_finalize:2059``, ``abort:2091``,
``quarantine_step_failure:2101``; ``RequestOutput:147``; the metrics of
``:45-141``; the attribution layer: ``_note_stall:1121``,
``_note_chain_break:1129``, ``_entry_phases:1243``, ``_step_flops:1255``,
``_record_spans:1279``, ``_record_step:1312``,
``_attach_attribution:1400``, the step timer ``:362-364``).

The single-device loop: schedule a batch, dispatch its step, collect the
oldest entry in flight and commit its sampled tokens. Without
``EngineConfig.overlap_scheduling`` one entry is in flight at a time (the
sync loop). With it, up to ``overlap_depth`` are: the next pure-decode
step is chained off the newest entry's sampled tokens on the device
before they reach the host (``Scheduler.schedule_chain``), and under
``pipelined_loop`` a chain that cannot extend (a finish, a join) is
re-formed off the promised token counts instead of draining
(``Scheduler.schedule_reform``), with the promises reconciled as tokens
land (``engine/pipeline.py``). With ``multi_step_decode`` (or
``decode_chain_len``) above 1, a chain extends by a block of up to that
many links, a power of two, dispatched as one device program
(``ModelRunner.step_multi``), and a sync pure-decode batch, or a re-form,
fuses with the links behind it; under ``ondevice_finish`` a row whose
token is in its stop set freezes inside the block and the block stops
once every row has. A block commits link by link. With
``decode_slot_batching`` chain membership is by slot: a finished row stays
in the chain as a dead hole, a decode-ready sequence joins a hole at a
chain boundary, the batch compacts only below its power-of-two sequence
bucket, and the engine keeps the chain's tip past the entries dispatched
after it (a ramp yield's prefill batch under ``chain_under_prefill``), so
the chain carries on off its own tokens. A hybrid model chains single
steps and never re-forms: its GDN state is cumulative, so a discarded
step could not be undone. ``EngineConfig.unified_step`` runs every step
through the unified attention kernel; under overlap scheduling a chain
with prefill work waiting no longer yields to it: the next dispatch is a
mixed re-form (``Scheduler.schedule_reform(prev, allow_prefill=True)``)
that carries the chain's promised decode rows, their tokens spliced on
the device, next to prefill chunks whose tokens the host knows, and the
chain goes on off it (``absorbs`` counts them; the ``waiting`` break
retires, and becomes ``reform`` where slots cannot seat ready
sequences). On a hybrid model the flag is inert, with a warning, as in
the JAX engine. ``docs/overlap_scheduling.md`` (Chain lifecycle,
Persistent-slot membership, On-device finish, Ramp policy, Pipelined
loop, FutureMap, Unified step, Invariants) is the specification; this is
its counterpart without dp, disaggregation and fault points.
``CacheConfig(kv_cache_dtype="int8")`` keeps an int8 KV cache.
``spec_decode="ngram"`` (docs/speculative_decoding.md) verifies
prompt-lookup drafts: host-driven, a decode row's drafts ride its step
as verify rows (an eager mixed step) and the step commits the accepted
run and a correction token, and under overlap scheduling speculation
owns decode dispatch (chains and re-forms refuse with "spec"); with
``spec_fused`` every chain link is a draft+verify sub-step of a fused
spec block (``ModelRunner.step_spec_multi``), which commits link by link
the tokens each row emitted, re-anchors the links on the committed
state and trims the entries in flight (``FutureMap.trim_overpromise``).
Unless
``EngineConfig.enforce_eager``, each step on the card (pure decode,
mixed, absorb, host-driven verify, with penalties, logit_bias or logprobs
or without) replays the CUDA graph of its key (``runner/graphs.py``;
warm them ahead of serving with ``llm.runner.warmup()``; a step with
extras captures its key at first sight), but for a hybrid model's mixed
step. A model directory (``config.model``) gives the config, the
weights under ``load_format="auto"`` (``models/loader.py``) and, where
``transformers`` imports, the tokenizer (JAX's rule, local files only);
else token ids in and out, or a tokenizer object (anything with
``encode``/``decode``) passed to the constructor for a text prompt, its
output text and stop strings. Stop
strings are matched on the host over the incrementally detokenized output
as tokens commit; a sequence with stop strings rides no block and joins no
hole, as in JAX; a drafted step commits several tokens, which the stop scan
replays one at a time, cutting the ones after a match (and their
logprobs). Logprobs of the sampled tokens and of the prompt, where a
request asks for them, come with the collected step (``ModelRunner.aux``)
and are kept on the sequence (``RequestOutput.logprobs``,
``.prompt_logprobs``); a sequence with logprobs or logit_bias rides no
block, and one with penalties no chain (``Scheduler.schedule_chain``), as
in JAX. The engine
observes the request metrics (time to
first token, time per output token, inter-token latency, end-to-end and
queue time) and the step metrics of the JAX package under its names
(``obs/metrics.py``), and ``quarantine_step_failure`` drops the sequences
of a step that raised (the serving engine's fault isolation). Each
collected entry records one step-trace event (``obs/steptrace.py``
``TRACE``): its kind, rows and tokens, the host walls of its phases
(schedule, build, dispatch, collect), the device wall attributed back to
it (the wait for its tokens, floored at the previous collect) and its MFU
and HBM estimates (``obs/spans.py`` ``StepFlopsModel``, the card's peak);
chain breaks, loop stalls and quarantines record theirs. Under
``EngineConfig.tracing`` (default on) every request keeps a span tree on
the engine's own ``spans`` ring: queued, its prefill chunks, decode steps
or chains, the detokenization, and the finish. All of it is host
bookkeeping: no tensor is read and no graph key changes.

The engine runs on the CUDA card unless the caller passes
``device="cpu"``; with no card it raises instead of falling back.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import sys
import time
from typing import List, Optional, Sequence as Seq, Union

import numpy as np
import torch

from gllm_tpu_torch.config import EngineConfig
from gllm_tpu_torch.engine.detokenizer import detokenize_incrementally
from gllm_tpu_torch.engine.pipeline import FutureMap, InFlight
from gllm_tpu_torch.memory_manager import make_memory_manager
from gllm_tpu_torch.models.config import ModelConfig, from_hf_config
from gllm_tpu_torch.obs import metrics as obs
from gllm_tpu_torch.obs.spans import SpanTrace, StepFlopsModel, peak_flops
from gllm_tpu_torch.obs.steptrace import TRACE
from gllm_tpu_torch.runner.prepare import MAX_STOP_IDS
from gllm_tpu_torch.runner.runner import ModelRunner
from gllm_tpu_torch.sampling_params import SamplingParams
from gllm_tpu_torch.scheduler import Scheduler, SeqOutput
from gllm_tpu_torch.sequence import HOLE_SEQ_ID, Sequence, SequenceStatus

logger = logging.getLogger(__name__)

# Step metrics, by the kind of the collected entry: "prefill" (a batch
# with a prefill chunk), "decode" (a single pure-decode step),
# "fused_block" (a block of K decode steps) and, under the unified step,
# "unified_step" for every single step. Timing is the host clock around
# the collect
_M_STEP_LAT = obs.histogram(
    "gllm_step_latency_seconds",
    "engine-iteration collect latency (host blocked on device tokens)",
    ("kind",), buckets=obs.FAST_LATENCY_BUCKETS)
_M_RTT = obs.histogram(
    "gllm_dispatch_rtt_seconds",
    "dispatch-to-collect round trip per engine iteration",
    ("kind",), buckets=obs.FAST_LATENCY_BUCKETS)
_M_STEPS = obs.counter("gllm_steps_total",
                       "engine iterations by step kind", ("kind",))
_M_STEP_TOKENS = obs.counter("gllm_step_tokens_total",
                             "tokens computed by step kind", ("kind",))
_M_DECODE_STEPS = obs.counter(
    "gllm_decode_steps_total",
    "decode steps by fusion (fused counts each sub-step of a block)",
    ("fused",))
# Request latencies: TTFT = arrival to the first sampled token, TPOT =
# the mean time between output tokens after the first, ITL = the time
# between one output token and the next, queue = arrival to the first
# admission. Tokens that commit together (a block) observe an ITL near 0:
# the client receives them together
_M_TTFT = obs.histogram("gllm_request_ttft_seconds",
                        "time to first token per request")
_M_TPOT = obs.histogram("gllm_request_tpot_seconds",
                        "mean time per output token after the first",
                        buckets=obs.FAST_LATENCY_BUCKETS)
_M_ITL = obs.histogram("gllm_request_itl_seconds",
                       "inter-token latency per sampled token",
                       buckets=obs.FAST_LATENCY_BUCKETS)
_M_E2E = obs.histogram("gllm_request_e2e_seconds",
                       "arrival-to-finish latency per request")
_M_QUEUE = obs.histogram("gllm_request_queue_seconds",
                         "arrival-to-first-schedule wait per request")
_M_FINISHED = obs.counter("gllm_requests_finished_total",
                          "requests finished by reason", ("reason",))
# decode-chain breaks under overlap scheduling, by reason (waiting /
# pages / shape / finish / reform: ``Scheduler.chain_break_reason``)
_M_CHAIN_BREAKS = obs.counter(
    "gllm_chain_breaks_total",
    "overlap decode-chain breaks by reason "
    "(waiting/pages/shape/spec/finish)", ("reason",))
# on-device finish: the finishes committed out of blocks, by the kind the
# device saw, and the dead share of the latest block's row-sub-steps (a
# row frozen, or a hole, while the block ran on)
_M_ONDEV_FINISH = obs.counter(
    "gllm_ondevice_finish_total",
    "sequence finishes detected on device inside fused decode blocks",
    ("kind",))
_M_DEAD_FRAC = obs.gauge(
    "gllm_dead_substep_frac",
    "wasted (dead-row) sub-step fraction of the latest fused block")
# fused speculation: the tokens through spec blocks, by what they were:
# accepted drafts, rejected drafts and corrections (each emitting
# sub-step's resampled or bonus token)
_M_SPEC_FUSED = obs.counter(
    "gllm_spec_fused_tokens_total",
    "tokens through fused speculation blocks by kind "
    "(accepted|rejected|correction)", ("kind",))
# the pipelined loop: entries dispatched and not yet collected after the
# latest fill pass
_M_INFLIGHT = obs.gauge(
    "gllm_inflight_depth",
    "dispatched-but-uncollected engine entries after the latest fill "
    "pass (pipelined loop)")
# attribution of the latest collected step: its MFU against its device
# wall (the step FLOPs model over the card's peak), the share of that
# device wall hidden under host work (1: the host never blocked), and its
# estimated HBM read rate (weights and KV over the device wall)
_M_MFU = obs.gauge(
    "gllm_step_mfu",
    "model FLOPs utilization of the latest step's device wall "
    "(0 when the chip peak is unknown)")
_M_OVERLAP = obs.gauge(
    "gllm_overlap_efficiency",
    "share of the latest step's device wall hidden under host work")
_M_HBM = obs.gauge(
    "gllm_step_hbm_gbps",
    "estimated HBM read bandwidth of the latest step (weights + KV "
    "stream over the device wall; per-device)")


@dataclasses.dataclass
class RequestOutput:
    seq_id: int
    prompt_token_ids: List[int]
    output_token_ids: List[int]
    text: str
    finish_reason: Optional[str]
    num_prompt_tokens: int = 0
    num_output_tokens: int = 0
    # per output token: (chosen logprob, top ids, top logprobs); None
    # when not asked for
    logprobs: Optional[list] = None
    # per prompt position, the same (None at position 0)
    prompt_logprobs: Optional[list] = None


def resolve_device(device) -> torch.device:
    """None means the CUDA card; it raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gllm_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class LLM:
    def __init__(
        self,
        *,
        model_cfg: Optional[ModelConfig] = None,
        config: Optional[EngineConfig] = None,
        params=None,
        tokenizer=None,
        device=None,
    ):
        """``config.model`` is a model directory (a hub id is fetched only
        under ``allow_hub_download``); ``model_cfg`` defaults to the one its
        ``config.json`` describes. ``params`` (this port's layout, see
        models/convert.py) defaults to the directory's checkpoint
        (``load_format="auto"``) or to dummy weights drawn from
        ``config.seed``. ``tokenizer`` defaults to
        ``transformers.AutoTokenizer`` of ``config.tokenizer`` or the model
        directory, local files only, where that package imports and finds
        one (``config.tokenizer=""`` asks for none); else token ids in and
        out."""
        config = config or EngineConfig()
        config.validate()
        self.config = config
        if config.model and not os.path.isdir(config.model):
            from gllm_tpu_torch.models.loader import resolve_model_path
            config.model = resolve_model_path(
                config.model, allow_download=config.allow_hub_download)
        if model_cfg is None:
            if not config.model:
                raise ValueError("pass model_cfg or config.model, a "
                                 "directory holding a config.json")
            from gllm_tpu_torch.models.loader import load_hf_config
            model_cfg = from_hf_config(load_hf_config(config.model))
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        if tokenizer is None and config.model and config.tokenizer != "":
            try:
                from transformers import AutoTokenizer
                self.tokenizer = AutoTokenizer.from_pretrained(
                    config.tokenizer or config.model, local_files_only=True)
            except Exception:
                logger.warning("no tokenizer loaded; token-id I/O only")
        self.device = resolve_device(device)
        self.runner = ModelRunner(config, model_cfg, self.device,
                                  params=params)
        # the unified step as the runner resolved it: inert on a hybrid
        # model, as in the JAX engine (legacy kernels, signatures and step
        # kinds there, and no absorb)
        self.unified = self.runner.unified
        if config.unified_step and not self.unified:
            logger.warning(
                "unified_step is inert for hybrid (GDN) models: legacy "
                "dispatch and step kinds retained")
        self.memory_manager = make_memory_manager(
            self.runner.num_pages, config.cache.page_size,
            config.cache.enable_prefix_caching,
            ssm_working_slots=self.runner.ssm_working_slots)
        # int8 KV cache: minted pages queue a scale reset that the runner
        # applies before the next step, so numerics never depend on page
        # reuse; a hybrid model's freed SSM slots queue a zero the same way
        self.memory_manager.track_scale_resets = self.runner.kv_quant
        self.runner.memory_manager = self.memory_manager
        self.scheduler = Scheduler(config, self.memory_manager)
        # speculative decoding (a hybrid model refused it in validate):
        # host-driven drafting in the scheduler, or, fused, on the device,
        # where a sub-step emits up to spec_mult tokens a row
        self.spec_fused = config.spec_fused and config.spec_decode == "ngram"
        if config.spec_decode == "ngram":
            self.scheduler.spec_cfg = (config.spec_ngram, config.spec_k)
        self.scheduler.spec_fused = self.spec_fused
        self.spec_mult = config.spec_k + 1 if self.spec_fused else 1
        self.eos_token_ids = model_cfg.eos_token_ids
        if not self.eos_token_ids and self.tokenizer is not None \
                and getattr(self.tokenizer, "eos_token_id", None) is not None:
            self.eos_token_ids = [self.tokenizer.eos_token_id]
        self._next_seq_id = 0
        # dispatched entries not yet collected, oldest first
        self._in_flight: collections.deque = collections.deque()
        # the batch (or block's chain) a runner call is launching; set
        # only while that call runs, so that a launch that raises is in
        # the failure's reach (quarantine_step_failure)
        self._launching = None
        # decode steps chained while prefill work waited (the
        # chain_under_prefill ramp), and whether this interruption's
        # "waiting" break is counted
        self._chained_under_pressure = 0
        self._yield_noted = False
        # persistent slots: the (batch, handle) the chain extends off, kept
        # past entries dispatched after it; None: no chain rooted (the next
        # sync pure-decode batch roots one)
        self._chain_tip = None
        self.futures = FutureMap()
        # counters in place of the JAX package's observability: chain
        # breaks and loop stalls by reason, and dispatches by (step kind,
        # entries in flight once it was dispatched)
        self.chain_breaks: collections.Counter = collections.Counter()
        self.stalls: collections.Counter = collections.Counter()
        self.dispatches: collections.Counter = collections.Counter()
        # blocks: collected by K, the sub-steps they executed, their dead
        # row-sub-steps (a row frozen while the block ran on) of all their
        # row-sub-steps (rows times executed sub-steps), and the
        # finishes committed out of them under on-device finish, by kind
        # (eos / stop / length)
        self.blocks: collections.Counter = collections.Counter()
        self.block_substeps = 0
        self.dead_substeps = 0
        self.row_substeps = 0
        self.ondevice_finishes: collections.Counter = collections.Counter()
        # persistent slots: sequences that joined a chain through a hole
        # (counted when dispatched), and the hole row-sub-steps of the
        # entries committed (left out of the dead share above)
        self.joins = 0
        self.hole_substeps = 0
        # the unified step under overlap: mixed re-forms dispatched (a
        # re-formed batch that carries a prefill row beside the chain's
        # promised decode rows)
        self.absorbs = 0
        # speculation: verify steps committed (host-driven), and the
        # tokens of committed spec blocks by kind (accepted, rejected,
        # correction: gllm_spec_fused_tokens_total)
        self.verify_steps = 0
        self.spec_tokens: collections.Counter = collections.Counter()
        # attribution: request spans on this engine's own ring (seq ids
        # restart at 0 for each LLM, so engines of one process must not
        # share one), gated by config.tracing; the FLOPs model and the
        # card's peak feed each step event's MFU
        self.tracing = config.tracing
        self.spans = SpanTrace()
        self.scheduler.spans = self.spans
        try:
            self._flops_model = StepFlopsModel.from_model_config(model_cfg)
        except Exception:       # exotic configs: attribution, not audit
            self._flops_model = None
        self._peak_flops = peak_flops(
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "")
        # when the last collect returned: the lower bound of the next
        # step's device wall (ready - max(dispatched, previous ready))
        self._last_ready = 0.0
        # where the current fill pass began (its entry's schedule phase)
        self._t_enter = 0.0
        # GLLM_TPU_STEP_TIMING=1: generate() keeps each collect's wall,
        # kind and tokens and prints one JSON summary line to stderr
        self._step_timer = None
        self._step_timing_enabled = (
            os.environ.get("GLLM_TPU_STEP_TIMING", "0") not in ("", "0"))

    @property
    def compactions(self) -> int:
        """Chains refused because their live rows fell below their
        sequence bucket (persistent slots; counted among the "shape"
        chain breaks)."""
        return self.scheduler.num_compactions

    @property
    def eos_token_ids(self) -> frozenset:
        return self._eos_token_ids

    @eos_token_ids.setter
    def eos_token_ids(self, ids) -> None:
        """The runner detects the same ids inside a block."""
        self._eos_token_ids = frozenset(ids)
        self.runner.eos_token_ids = self._eos_token_ids

    @property
    def step_counts(self) -> dict:
        """Steps by kind: "decode" when every row has one new token, else
        "mixed". Which kernels ran is counted by the kernel wrappers."""
        return self.runner.step_counts

    # ---- intake -----------------------------------------------------------

    def _allocate_seq(self, token_ids: List[int],
                      sp: SamplingParams) -> Sequence:
        sp.validate()
        seq = Sequence(self._next_seq_id, token_ids, sp,
                       arrival_time=time.monotonic())
        self._next_seq_id += 1
        return seq

    def encode(self, prompt: str) -> List[int]:
        if self.tokenizer is None:
            raise ValueError("no tokenizer available; pass prompt_token_ids")
        return list(self.tokenizer.encode(prompt))

    def add_seq(self, seq: Sequence) -> None:
        if self.config.ondevice_finish:
            n = len(seq.device_stop_ids(self.eos_token_ids))
            if n > MAX_STOP_IDS:
                raise ValueError(
                    f"a stop set of {n} token ids (EOS and stop_token_ids)"
                    f" exceeds the {MAX_STOP_IDS} a block takes under "
                    "ondevice_finish")
        self.scheduler.add_seq(seq)

    @property
    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished or bool(self._in_flight)

    # ---- main loop --------------------------------------------------------

    def step(self) -> List[SeqOutput]:
        """One engine iteration: fill the pipeline up to its depth (one
        entry without overlap scheduling), then collect the oldest entry
        and commit its tokens (an invalidated one is discarded)."""
        cfg = self.config
        overlap = cfg.overlap_scheduling
        depth = cfg.overlap_depth if overlap else 1
        cup = cfg.chain_under_prefill if overlap else 0
        multi = cfg.multi_step_decode if overlap else 1
        slot_mode = overlap and cfg.decode_slot_batching
        # the unified step: prefill pressure no longer yields the chain;
        # the next dispatch absorbs the waiting work in a mixed re-form
        unified = self.unified and overlap
        ran_dry = False
        while len(self._in_flight) < depth:
            # from here to the runner call is the schedule phase of the
            # entry this pass puts in flight
            self._t_enter = time.monotonic()
            if overlap and self._in_flight:
                if slot_mode:
                    # the chain's newest entry, which may lie behind
                    # entries dispatched since (a ramp yield's prefill)
                    tip = self._chain_tip
                else:
                    # an invalidated entry is never a tip: its tokens
                    # never commit, so the rebuild roots from committed
                    # state
                    last = self._in_flight[-1]
                    tip = None if last.invalid else last.tip
                pressure = bool(self.scheduler.waiting)
                if not pressure:
                    self._chained_under_pressure = 0
                if unified and tip is not None and pressure:
                    # the chain absorbs the waiting work: one mixed
                    # re-formed dispatch carries its promised decode rows
                    # next to the admitted prefill chunks, with no yield
                    # and no "waiting" break; the chain goes on off it
                    if self._dispatch_reform(*tip, False, multi,
                                             mixed=True):
                        continue
                    # it needs host-committed state: the sync pass admits
                    # what it could not (JAX's ``llm.py:786-790``)
                    self._chain_tip = None
                    tip = None
                allow = tip is not None and (
                    not pressure or self._chained_under_pressure < cup)
                if tip is not None and not allow:
                    # ramp yield: this pass goes to the sync schedule,
                    # which admits the waiting work; one break counted per
                    # interruption of a decode chain
                    prev = tip[0]
                    if (not self._yield_noted
                            and prev.num_decode == prev.num_seqs
                            and not prev.has_drafts):
                        self._note_chain_break(prev, "waiting")
                        self._yield_noted = True
                    self._chained_under_pressure = 0
                if allow:
                    prev_batch, prev_handle = tip
                    chain = self._schedule_multi(prev_batch, multi)
                    if not chain:
                        reason = self.scheduler.chain_break_reason
                        if unified and reason == "waiting":
                            # retired under the unified step: the mixed
                            # re-form below seats the ready sequences
                            reason = "reform"
                        self._note_chain_break(prev_batch, reason)
                        if cfg.pipelined_loop and self._dispatch_reform(
                                prev_batch, prev_handle, pressure, multi,
                                mixed=unified):
                            continue
                        self._chain_tip = None
                        self._chained_under_pressure = 0
                        ran_dry = True
                        break
                    if pressure:
                        self._chained_under_pressure += len(chain)
                    self._yield_noted = False
                    if chain[0].spec_block:
                        # fused speculation: even one link is a spec block
                        self._launch(self.runner.step_spec_multi, chain,
                                     prev_handle, chained=True)
                    elif len(chain) > 1:
                        self._launch(self.runner.step_multi, chain,
                                     prev_handle, chained=True)
                    else:
                        self._launch(self.runner.step_async_chained,
                                     chain[0], prev_handle, chained=True)
                    continue
            batch = self.scheduler.schedule_once()
            if batch is None:
                if (cfg.pipelined_loop and self._in_flight
                        and self.scheduler.has_unfinished):
                    # work left that only committed tokens can schedule
                    self._note_stall("readback")
                ran_dry = True
                break
            if (multi > 1 and not self.scheduler.waiting
                    and batch.num_decode == batch.num_seqs
                    and not batch.has_drafts):
                # a sync pure-decode batch fuses with the links behind it
                # into one block, instead of a single step first; its
                # rows are all alive, so the links' alive counts shift by
                # one
                links = self._schedule_multi_links(batch, multi - 1)
                if links:
                    chain = [self._block_root(batch, links)] + links
                    self._launch(self.runner.step_spec_multi
                                 if links[0].spec_block
                                 else self.runner.step_multi, chain,
                                 roots=True)
                    self._yield_noted = False
                    continue
            entry = self._launch(self.runner.step_async, batch,
                                 roots=(batch.num_decode == batch.num_seqs
                                        and not batch.has_drafts))
            if entry.roots:
                self._yield_noted = False
        if cfg.pipelined_loop:
            _M_INFLIGHT.set(len(self._in_flight))
            if not ran_dry and len(self._in_flight) >= depth:
                self._note_stall("depth")
        if not self._in_flight:
            return []
        entry = self._in_flight.popleft()
        block = isinstance(entry.batch, list)
        t0 = time.monotonic()
        try:
            # a device fault surfaces here, at the wait for the tokens
            if entry.invalid:
                # its tokens never commit: the sync path schedules the
                # same positions again. A block is collected all the same
                # (it is the oldest entry), so that its executed sub-steps
                # count
                if block:
                    self.runner.collect(entry.handle)
                tokens = None
            else:
                tokens = self.runner.collect(entry.handle)
                aux = self.runner.aux(entry.handle)
        except Exception:
            # the failed entry stays in flight, so that
            # quarantine_step_failure drops its sequences too
            self._in_flight.appendleft(entry)
            raise
        if not self._in_flight:
            # drained: the tip is collected; the next chain roots afresh
            self._chain_tip = None
        if tokens is None:
            self.scheduler.discard_batch(entry.batch)
            return []
        extra = None
        if block:
            extra = (self._spec_block_stats(entry.batch, tokens)
                     if entry.batch[0].spec_block
                     else self._block_stats(entry.batch, tokens[-1]))
        self._record_step(entry.batch, t0, entry.t_dispatch, extra,
                          entry.phases)
        if not block:
            self.hole_substeps += _holes(entry.batch)
            if aux:
                # before process_output: ``samples`` reads the sequence's
                # token count, which it advances
                self._record_logprobs(entry.batch, aux)
            if entry.batch.has_drafts:
                outs = self._commit_verify(entry.batch, tokens)
                self._record_spec_logprobs(entry.batch, aux.get("spec_lp"),
                                           outs)
                return self._commit_outputs(outs)
            outs = self.scheduler.process_output(
                entry.batch, tokens.tolist(), self.eos_token_ids)
            return self._commit_outputs(outs)
        if entry.batch[0].spec_block:
            return self._commit_outputs(
                self._commit_spec_block(entry.batch, tokens))
        # a block: [K, n] tokens, then each row's finish step; it commits
        # link by link, and a row's tokens after its finish are dropped
        # (process_output skips a finished sequence)
        chain = entry.batch
        outs = []
        for link, row in zip(chain, tokens[:-1]):
            outs.extend(self.scheduler.process_output(
                link, row.tolist(), self.eos_token_ids))
        if cfg.ondevice_finish:
            self._count_ondevice_finishes(outs)
        return self._commit_outputs(outs)

    def _launch(self, run, batch, *prev, **flags) -> InFlight:
        """Launch ``batch`` (a block's chain) with the runner call ``run``
        off ``prev`` (the handle it chains off, if any) and put it in
        flight. A launch that raises (a graph first met while serving is
        captured there) leaves the batch in ``_launching``: its rows'
        pages and in-flight counts are already taken, so the quarantine
        must drop them with the entries in flight. The entry keeps when the
        call returned and its host phases (``_entry_phases``)."""
        self._launching = batch
        t_sched = time.monotonic()
        handle = run(batch, *prev)
        entry = InFlight(batch, handle, time.monotonic(),
                         self._entry_phases(self._t_enter, t_sched), **flags)
        self._launching = None
        self._dispatch(entry)
        return entry

    def _dispatch(self, entry: InFlight) -> None:
        """Put ``entry`` in flight and count it; under persistent slots a
        chained or chain-rooting entry becomes the chain's tip (an entry
        of mixed steps does not)."""
        self._in_flight.append(entry)
        first = entry.batch
        if isinstance(first, list):
            first = first[0]
            kind = "spec" if first.spec_block else "block"
        else:
            # a hole row is a one-token row: it leaves the kind as it is;
            # a step with drafts is a verify step
            kind = ("verify" if first.has_drafts
                    else "decode" if all(it.num_new_tokens == 1
                                         for it in first.items)
                    else "mixed")
        self.dispatches[kind, len(self._in_flight)] += 1
        self.joins += len(first.host_rows or ())
        if (self.config.overlap_scheduling
                and self.config.decode_slot_batching
                and (entry.chained or entry.roots)):
            self._chain_tip = entry.tip

    def _note_chain_break(self, batch, reason: str) -> None:
        """One chain break of the tip ``batch`` (a block's list: its last
        link): counted, and a ``chain_break`` event."""
        if isinstance(batch, list):
            batch = batch[-1]
        self.chain_breaks[reason] += 1
        TRACE.record("chain_break", num_seqs=batch.num_seqs, reason=reason)
        _M_CHAIN_BREAKS.inc(reason=reason)

    def _note_stall(self, reason: str, **fields) -> None:
        """One stall of the pipelined loop (why the fill pass ran no
        further ahead: readback, rebuild, pages, depth): counted, and a
        ``loop_stall`` event with the entries in flight."""
        self.stalls[reason] += 1
        TRACE.record("loop_stall", reason=reason,
                     depth=len(self._in_flight), **fields)

    def _entry_phases(self, t_enter: float, t_sched_end: float) -> dict:
        """The host walls of one entry at its dispatch (seconds; ms once
        collected): schedule (the fill pass's start to the runner call),
        and the runner's build / dispatch split and KV read estimate
        (``ModelRunner.last_phases``)."""
        ph = {"t_enter": t_enter, "schedule": t_sched_end - t_enter}
        ph.update(self.runner.last_phases)
        return ph

    def _step_flops(self, batch, extra: Optional[dict] = None) -> float:
        """Matmul-path FLOPs of one collected entry (the FLOPs model on
        scheduler counts): a block's executed sub-steps (``k_exec`` under
        on-device finish) over its live rows, a spec block's times
        ``spec_mult`` (each sub-step feeds up to spec_k + 1 verify rows a
        row)."""
        fm = self._flops_model
        if fm is None:
            return 0.0
        if isinstance(batch, list):
            k = (extra or {}).get("k_exec") or len(batch)
            ctxs = [it.computed_before for it in batch[0].items
                    if it.seq.seq_id != HOLE_SEQ_ID]
            f = fm.block_flops(ctxs, k)
            if batch[0].spec_block:
                f *= self.spec_mult
            return f
        return fm.step_flops(
            (it.num_new_tokens, it.computed_before, it.samples)
            for it in batch.items if it.seq.seq_id != HOLE_SEQ_ID)

    def _record_spans(self, batch, t_dispatch: float, now: float,
                      extra: Optional[dict] = None) -> None:
        """One child span [dispatch → collect] for each live sequence of
        a collected entry: ``decode_chain`` (a block, with its k and, under
        on-device finish, k_exec and dead_substeps), ``prefill_chunk`` or
        ``decode_step``; the decode rows' under one lock."""
        dur = (now - t_dispatch) * 1e3
        if isinstance(batch, list):
            meta = {"k": len(batch)}
            if extra and extra.get("k_exec") is not None:
                meta["k_exec"] = extra["k_exec"]
                meta["dead_substeps"] = extra.get("dead_substeps")
            self.spans.event_many(
                [it.seq.seq_id for it in batch[0].items
                 if it.seq.seq_id != HOLE_SEQ_ID],
                "decode_chain", t_dispatch, dur, meta)
            return
        decode_rows = []
        for it in batch.items:
            sid = it.seq.seq_id
            if sid == HOLE_SEQ_ID:
                continue
            if (it.num_new_tokens > 1
                    or it.computed_before < it.seq.prompt_len):
                self.spans.event(sid, "prefill_chunk", t_dispatch, dur,
                                 tokens=it.num_new_tokens)
            else:
                decode_rows.append(sid)
        if decode_rows:
            self.spans.event_many(decode_rows, "decode_step", t_dispatch,
                                  dur)

    def _record_step(self, batch, t0: float, t_dispatch: float,
                     extra: Optional[dict], phases: dict) -> None:
        """The step attribution of one collected entry (JAX's
        ``_record_step:1312``): the collect latency and round-trip
        histograms, steps and tokens by kind, decode steps by fusion (a
        block's scheduled sub-steps), one step-trace event with the host
        phases, the device wall and the MFU and HBM estimates, and, under
        tracing, the rows' spans. ``t0``: when the collect began."""
        now = time.monotonic()
        fused = isinstance(batch, list)
        b = batch[-1] if fused else batch
        mix = None
        if fused:
            kind = "fused_block"
            tokens = sum(x.total_tokens for x in batch)
            if extra and extra.get("spec_tokens") is not None:
                # a spec block commits a variable count: what it emitted
                tokens = extra["spec_tokens"]
        elif self.unified:
            kind = "unified_step"
            mix = ("mixed" if any(
                it.num_new_tokens > 1
                or it.computed_before < it.seq.prompt_len
                for it in b.items if it.seq.seq_id != HOLE_SEQ_ID)
                else "decode")
            tokens = b.total_tokens
        else:
            kind = "decode" if b.num_decode == b.num_seqs else "prefill"
            tokens = b.total_tokens
        wall = now - t0
        _M_STEP_LAT.observe(wall, kind=kind)
        _M_RTT.observe(now - t_dispatch, kind=kind)
        _M_STEPS.inc(kind=kind)
        _M_STEP_TOKENS.inc(tokens, kind=kind)
        if kind == "decode" or mix == "decode":
            _M_DECODE_STEPS.inc(fused="false")
        elif fused:
            _M_DECODE_STEPS.inc(len(batch), fused="true")
        ev = dict(num_seqs=b.num_seqs, tokens=tokens,
                  wall_ms=round(wall * 1e3, 3),
                  rtt_ms=round((now - t_dispatch) * 1e3, 3),
                  # entries still in flight after this collect: the depth
                  # the loop sustained (summarize's mean_inflight_depth)
                  inflight=len(self._in_flight))
        if fused:
            ev["k"] = len(batch)
        if mix is not None:
            ev["mix"] = mix
        if extra:
            ev.update(extra)
        # an early exit (k_exec < k) shrinks the weight re-reads and the
        # KV stream both, as it shrinks the FLOPs
        k_sched = len(batch) if fused else 1
        k_exec = ((extra or {}).get("k_exec") or k_sched) if fused else 1
        rd = (phases.get("kv_bytes", 0) * k_exec / k_sched
              + self.runner.param_bytes * k_exec)
        flops = self._step_flops(batch, extra) if self._peak_flops else 0.0
        self._attach_attribution(ev, phases, wall, now, t_dispatch, flops,
                                 rd)
        TRACE.record(kind, **ev)
        if self.tracing:
            self._record_spans(batch, t_dispatch, now, extra)
        timer = self._step_timer
        if timer is not None:
            timer.append((wall,
                          f"decode_block{len(batch)}" if fused
                          else "decode" if (kind == "decode"
                                            or mix == "decode")
                          else "prefill_mixed", tokens))

    def _attach_attribution(self, ev: dict, phases: dict, wall: float,
                            now: float, t_dispatch: float,
                            flops: float, rd_bytes: float) -> None:
        """The attribution tail of a step event (JAX's
        ``_attach_attribution:1400``): the host phase walls in ms, the
        device wall (ready − max(dispatched, the previous ready): the wait
        for the tokens, floored at the previous collect's return, before
        which the card was busy with the older step; no profiler and no
        device read), and the MFU and HBM estimates with their gauges.
        An eager step (``last_phases["eager"]``: its body ran op by op,
        the card working through it while the host enqueued the rest) is
        marked ``eager`` with the reason: its device wall, on the same
        definition, misses the device time spent before the call
        returned, so its ``dev_ms`` and what is divided by it are no
        device measurement."""
        dev = max(0.0, now - max(t_dispatch, self._last_ready))
        self._last_ready = now
        if "eager" in phases:
            ev["eager"] = phases["eager"]
        ev["ph"] = {
            "schedule": round(phases.get("schedule", 0.0) * 1e3, 3),
            "build": round(phases.get("build", 0.0) * 1e3, 3),
            "dispatch": round(phases.get("dispatch", 0.0) * 1e3, 3),
            "collect": round(wall * 1e3, 3),
        }
        ev["step_wall_ms"] = round(
            (now - phases.get("t_enter", t_dispatch)) * 1e3, 3)
        ev["dev_ms"] = round(dev * 1e3, 3)
        if dev <= 0:
            return
        _M_OVERLAP.set(round(max(0.0, dev - wall) / dev, 4))
        if flops and self._peak_flops:
            # 6 digits, as summarize rounds a window: a tiny model's MFU
            # must not floor to 0
            ev["mfu"] = round(flops / dev / self._peak_flops, 6)
            _M_MFU.set(ev["mfu"])
        if rd_bytes:
            ev["hbm_gbps"] = round(rd_bytes / dev / 1e9, 2)
            _M_HBM.set(ev["hbm_gbps"])

    # ---- blocks -----------------------------------------------------------

    def _fuse_ok(self, batch) -> bool:
        """May ``batch``'s sequences ride a block (JAX's ``_fuse_ok``)?
        Not a hybrid model's (its GDN layers keep the single-step chain),
        nor one with logit_bias or logprobs (a block's body neither
        adjusts its logits nor computes logprobs), or with stop strings,
        which are checked between steps. Penalties are
        refused by ``schedule_chain``; seeded rows fuse (their draws
        follow the output index, which a block advances on the
        device)."""
        if self.runner.hybrid:
            return False
        return not any(it.seq.sampling_params.logit_bias
                       or it.seq.sampling_params.logprobs is not None
                       or it.seq.sampling_params.stop or it.draft_tokens
                       for it in batch.items)

    def _schedule_multi(self, prev_batch, multi: int) -> list:
        """Up to ``multi`` links off ``prev_batch`` for one dispatch (a
        spec block's under fused speculation)."""
        fusable = self._fuse_ok(prev_batch)
        return self.scheduler.schedule_chain(
            prev_batch, multi if fusable else 1,
            **self._spec_mult(fusable))

    def _schedule_multi_links(self, batch, k_max: int) -> list:
        """Links to fuse behind ``batch``, which becomes the block's first
        step."""
        if k_max < 1 or not self._fuse_ok(batch):
            return []
        return self.scheduler.schedule_chain(batch, k_max,
                                             include_prev=True,
                                             **self._spec_mult(True))

    def _spec_mult(self, fusable: bool) -> dict:
        """``schedule_chain``'s stride under fused speculation: the tokens
        a spec sub-step may emit (none passed without it)."""
        return ({"spec_mult": self.spec_mult}
                if self.spec_fused and fusable else {})

    @staticmethod
    def _block_root(batch, links):
        """``batch`` as the first link of a block before ``links``: alive
        in one more sub-step than the links' counts say; before spec
        links, one more token of budget in front of theirs (uncapped:
        budgets are carried across blocks)."""
        au, k = links[0].active_until, 1 + len(links)
        if links[0].spec_block:
            return dataclasses.replace(batch, spec_block=True,
                                       active_until=[d + 1 for d in au])
        return dataclasses.replace(batch, active_until=(
            [min(d + 1, k) for d in au] if au is not None else None))

    def _block_stats(self, chain, finish) -> Optional[dict]:
        """Count a collected block: by K, its executed sub-steps (the
        latest finish step: fewer than K when every row finished early),
        its dead row-sub-steps among the rows of sequences, and its hole
        row-sub-steps; under on-device finish, the dead-fraction gauge over
        every row, holes included, as JAX's
        ``_ondevice_block_stats:1139``, whose step-event fields (k_exec and
        the dead row-sub-steps of every row) it returns then; None
        without on-device finish."""
        finish = finish[:chain[0].num_seqs]
        k_exec = int(finish.max()) if finish.size else 0
        live = np.array([it.seq.seq_id != HOLE_SEQ_ID
                         for it in chain[0].items], bool)
        self.blocks[len(chain)] += 1
        self.block_substeps += k_exec
        self.dead_substeps += int((k_exec - finish[live]).sum())
        self.row_substeps += k_exec * int(live.sum())
        self.hole_substeps += k_exec * int((~live).sum())
        if not self.config.ondevice_finish:
            return None
        dead = int((k_exec - finish).sum())
        if k_exec and finish.size:
            _M_DEAD_FRAC.set(dead / (k_exec * finish.size))
        return {"k_exec": k_exec, "dead_substeps": dead}

    def _commit_verify(self, batch, out) -> List[SeqOutput]:
        """Commit a verify step (host-driven speculation; JAX's
        ``llm.py:998-1018``): a drafted row its accepted drafts and the
        correction token, every other row its sampled token. ``out`` is
        [n, 2 + K1]: the sampled token, the accepted drafts, the verify
        tokens."""
        self.verify_steps += 1
        lists = []
        for i, it in enumerate(batch.items):
            if it.draft_tokens:
                a = min(int(out[i, 1]), len(it.draft_tokens))
                lists.append([int(t) for t in out[i, 2:3 + a]])
            else:
                lists.append([int(out[i, 0])])
        return self.scheduler.process_output_multi(batch, lists,
                                                   self.eos_token_ids)

    def _record_logprobs(self, batch, aux) -> None:
        """Keep a collected step's logprobs on its sequences (JAX's
        ``_record_logprobs``): the sampled token's of each row that
        samples and asks for them (a drafted row's come from its verify
        rows, ``_record_spec_logprobs``), and each prompt position's of a
        prompt chunk whose sequence asks for prompt logprobs."""
        if "lp" in aux:
            chosen, top_ids, top_lps = aux["lp"]
            for i, it in enumerate(batch.items):
                sp = it.seq.sampling_params
                if (not it.samples or sp.logprobs is None
                        or it.draft_tokens):
                    continue
                if it.seq.output_logprobs is None:
                    it.seq.output_logprobs = []
                k = sp.logprobs
                it.seq.output_logprobs.append(
                    (float(chosen[i]), top_ids[i, :k].tolist(),
                     top_lps[i, :k].tolist()))
        if "plp" in aux:
            chosen, top_ids, top_lps = aux["plp"]
            off = 0
            for it in batch.items:
                n, seq = it.num_new_tokens, it.seq
                sp = seq.sampling_params
                if (sp.prompt_logprobs is not None
                        and it.computed_before < seq.prompt_len):
                    if seq.prompt_logprobs is None:
                        # position 0 has no conditional logprob
                        seq.prompt_logprobs = [None] * seq.prompt_len
                    k = sp.prompt_logprobs
                    for j in range(n):
                        pos = it.computed_before + j + 1
                        if pos >= seq.prompt_len:
                            break
                        row = off + j
                        seq.prompt_logprobs[pos] = (
                            float(chosen[row]), top_ids[row, :k].tolist(),
                            top_lps[row, :k].tolist())
                off += n + len(it.draft_tokens)

    def _record_spec_logprobs(self, batch, spec_lp, outs) -> None:
        """The logprobs of a verify step's committed tokens, from its
        verify rows' adjusted distributions (JAX's
        ``_record_spec_logprobs``), after ``process_output_multi``, so
        that their count is that of the tokens committed."""
        if spec_lp is None:
            return
        chosen, top_ids, top_lps = spec_lp
        emitted: dict = {}
        for out in outs:
            if out.new_token_id is not None:
                sid = out.seq.seq_id
                emitted[sid] = emitted.get(sid, 0) + 1
        for i, it in enumerate(batch.items):
            sp = it.seq.sampling_params
            if not it.draft_tokens or sp.logprobs is None:
                continue
            if it.seq.output_logprobs is None:
                it.seq.output_logprobs = []
            k = sp.logprobs
            for j in range(emitted.get(it.seq.seq_id, 0)):
                it.seq.output_logprobs.append(
                    (float(chosen[i, j]), top_ids[i, j, :k].tolist(),
                     top_lps[i, j, :k].tolist()))

    def _spec_block_stats(self, chain, res) -> dict:
        """Count a collected spec block (JAX's ``_spec_block_stats:1152``):
        by K, its executed sub-steps (those in which some row emitted: the
        early exit leaves a zero tail), and its dead row-sub-steps (a row
        of a sequence that emitted nothing in an executed sub-step) and
        hole row-sub-steps; the dead-fraction gauge over every row.
        Returns the step-event fields: k_exec, the dead row-sub-steps of
        every row, the drafts proposed and accepted and the tokens
        emitted."""
        counts = res["counts"]
        k_exec = int((counts > 0).any(axis=1).sum())
        live = np.array([it.seq.seq_id != HOLE_SEQ_ID
                         for it in chain[0].items], bool)
        idle = (counts[:k_exec] == 0)
        if k_exec and live.size:
            _M_DEAD_FRAC.set(int(idle.sum()) / (k_exec * live.size))
        self.blocks[len(chain)] += 1
        self.block_substeps += k_exec
        self.dead_substeps += int(idle[:, live].sum())
        self.row_substeps += k_exec * int(live.sum())
        self.hole_substeps += k_exec * int((~live).sum())
        return {"k_exec": k_exec, "dead_substeps": int(idle.sum()),
                "k_drafted": int(res["drafted"].sum()),
                "k_accepted": int(res["accepted"].sum()),
                "spec_tokens": int(counts.sum())}

    def _commit_spec_block(self, chain, res) -> List[SeqOutput]:
        """Commit a collected spec block (JAX's ``_commit_spec_block:1170``):
        sub-step k of row i commits ``counts[k, i]`` of its verify tokens
        (the accepted run and the correction or bonus token, cut by the
        budget or an on-device stop). Each link's ``computed_before`` was
        a worst-case upper bound: it re-anchors on the sequence's
        committed state before ``process_output_multi`` advances it, the
        entries in flight trim to the actual frontiers, and the draft
        lengths and acceptance counts reconcile from the block's (its
        counts were taken by ``_spec_block_stats`` when it was
        collected)."""
        toks, counts = res["tokens"], res["counts"]
        outs = []
        for k, link in enumerate(chain):
            items, lists = [], []
            for i, it in enumerate(link.items):
                seq = it.seq
                if (seq.seq_id != HOLE_SEQ_ID
                        and seq.status is SequenceStatus.RUNNING):
                    it = dataclasses.replace(
                        it, computed_before=seq.num_computed_tokens)
                items.append(it)
                lists.append([int(t) for t in toks[k, i, :counts[k, i]]])
            outs.extend(self.scheduler.process_output_multi(
                dataclasses.replace(link, items=items), lists,
                self.eos_token_ids))
        drafted = int(res["drafted"].sum())
        accepted = int(res["accepted"].sum())
        emitted = int(counts.sum())
        stats = self.scheduler.spec_stats
        stats["proposed"] += drafted
        stats["accepted"] += accepted
        for kind, n in (("accepted", accepted),
                        ("rejected", drafted - accepted),
                        ("correction", emitted - accepted)):
            if n > 0:
                self.spec_tokens[kind] += n
                _M_SPEC_FUSED.inc(n, kind=kind)
        frontiers = {}
        for i, it in enumerate(chain[0].items):
            seq = it.seq
            if seq.seq_id == HOLE_SEQ_ID:
                continue
            seq.spec_k_cur = max(1, min(int(res["kcur"][i]),
                                        self.config.spec_k))
            frontiers[seq.seq_id] = seq.num_computed_tokens
        if self._in_flight:
            self.futures.trim_overpromise(self._in_flight, frontiers)
        if self.config.ondevice_finish:
            self._count_ondevice_finishes(outs)
        return outs

    def _count_ondevice_finishes(self, outs) -> None:
        """Finishes committed out of a block, by the kind the device saw:
        eos, stop (a stop token) or length."""
        for out in outs:
            if out.finish_reason == "length":
                kind = "length"
            elif out.finish_reason == "stop":
                sp = out.seq.sampling_params
                eos = (not sp.ignore_eos
                       and out.new_token_id in self.eos_token_ids)
                kind = "eos" if eos else "stop"
            else:
                continue
            self.ondevice_finishes[kind] += 1
            _M_ONDEV_FINISH.inc(kind=kind)

    def _commit_outputs(self, outs: List[SeqOutput]) -> List[SeqOutput]:
        """The commit tail of one collected entry: stop strings (a match
        trims the tokens after it), then reconciliation (a finish that
        commits for a sequence some later entry promised alive invalidates
        that entry and the entries chained off it), then the request
        metrics."""
        self._check_stop_strings(outs)
        if self.config.pipelined_loop and self._in_flight:
            finished = frozenset(o.seq.seq_id for o in outs
                                 if o.finish_reason is not None)
            n = self.futures.reconcile(self._in_flight, finished)
            if n:
                self._note_stall("rebuild", invalidated=n)
                # the tip goes only when its own entry was invalidated: a
                # tip descending from a later valid root carries on
                if self._chain_tip is not None and any(
                        e.invalid and e.handle is self._chain_tip[1]
                        for e in self._in_flight):
                    self._chain_tip = None
        self._observe_outputs(outs)
        return outs

    def _observe_outputs(self, outs) -> None:
        """The request metrics over one entry's outputs, after the stop
        strings, so that finish reasons are final (JAX's
        ``_observe_outputs:1434``)."""
        if not outs:
            return
        now = time.monotonic()
        for out in outs:
            seq = out.seq
            if out.new_token_id is not None:
                if not seq.first_token_time:
                    seq.first_token_time = now
                    if seq.arrival_time:
                        _M_TTFT.observe(now - seq.arrival_time)
                        if seq.first_sched_time:
                            _M_QUEUE.observe(seq.first_sched_time
                                             - seq.arrival_time)
                elif seq.last_token_time:
                    _M_ITL.observe(now - seq.last_token_time)
                seq.last_token_time = now
            if out.finish_reason is not None:
                _M_FINISHED.inc(reason=out.finish_reason)
                if seq.arrival_time:
                    _M_E2E.observe(now - seq.arrival_time)
                n = seq.num_output_tokens
                if n > 1 and seq.first_token_time:
                    _M_TPOT.observe((seq.last_token_time
                                     - seq.first_token_time) / (n - 1))
                if self.tracing:
                    # the request's detokenization as one rolled-up
                    # child, then its tree closes
                    detok = getattr(seq, "_detok_s", 0.0)
                    if detok:
                        self.spans.event(seq.seq_id, "detokenize",
                                         now - detok, detok * 1e3,
                                         accumulated=True)
                    self.spans.finish(seq.seq_id, out.finish_reason, now,
                                      output_tokens=n)

    def _check_stop_strings(self, outs) -> None:
        """Stop strings, matched on the host over the incrementally
        detokenized output (JAX's ``_check_stop_strings:1803``); the text
        is cut before the match (OpenAI's rule), and only the tail window
        (the new text and ``len(stop) - 1`` characters before it) is
        scanned again. A sequence with stop strings rides no block
        (``_fuse_ok``) and joins no hole, but a verify step commits
        several of its tokens at once: they are replayed one at a time
        through the incremental detokenizer, the scan a run of single
        steps would make, so the match lands on the token that completed
        it. The tokens after it are cut from the sequence (its ids and
        computed count) and their outputs dropped, so the text and the
        usage (and the logprobs) equal those without speculation."""
        n_new: dict = {}
        for out in outs:
            if out.new_token_id is not None:
                sid = out.seq.seq_id
                n_new[sid] = n_new.get(sid, 0) + 1
        cuts: dict = {}
        for out in outs:
            seq = out.seq
            sp = seq.sampling_params
            if (out.new_token_id is None or not sp.stop
                    or self.tokenizer is None or seq.seq_id in cuts):
                continue
            cuts[seq.seq_id] = None
            max_stop = max(len(x) for x in sp.stop)
            first = seq.num_tokens - n_new[seq.seq_id]
            hit = -1
            for j in range(first, seq.num_tokens):
                text, seq.detok_prefix_offset, seq.detok_read_offset = (
                    detokenize_incrementally(
                        self.tokenizer, seq.token_ids,
                        seq.detok_prefix_offset, seq.detok_read_offset,
                        end=j + 1))
                if not text:
                    continue
                seq.output_text += text
                start = max(0, getattr(seq, "_stop_scanned", 0)
                            - max_stop + 1)
                window = seq.output_text[start:]
                hit = min((start + idx for idx in (window.find(x)
                                                   for x in sp.stop)
                           if idx >= 0), default=-1)
                seq._stop_scanned = len(seq.output_text)
                if hit >= 0:
                    cuts[seq.seq_id] = j + 1 - first
                    break
            if hit < 0:
                continue
            keep = first + cuts[seq.seq_id]
            if keep < seq.num_tokens:
                del seq.token_ids[keep:]
                seq._pt_np = None
                seq.num_computed_tokens = min(seq.num_computed_tokens, keep)
                if seq.output_logprobs is not None:
                    del seq.output_logprobs[keep - seq.prompt_len:]
            seq.output_text = seq.output_text[:hit]
            # nothing trimmed is detokenized again
            seq.detok_read_offset = seq.num_tokens
            seq.detok_prefix_offset = min(seq.detok_prefix_offset,
                                          seq.num_tokens)
            seq._stop_scanned = len(seq.output_text)
            self.scheduler.finish_seq(seq, "stop")
            seq.finish_reason = "stop"
        cuts = {sid: c for sid, c in cuts.items() if c is not None}
        if cuts:
            kept, cnt = [], {}
            for out in outs:
                sid = out.seq.seq_id
                if sid in cuts and out.new_token_id is not None:
                    c = cnt.get(sid, 0)
                    if c >= cuts[sid]:
                        continue           # past the match: dropped
                    cnt[sid] = c + 1
                    out.finish_reason = ("stop" if cnt[sid] == cuts[sid]
                                         else None)
                kept.append(out)
            outs[:] = kept

    def _dispatch_reform(self, prev_batch, prev_handle, pressure: bool,
                         multi: int, mixed: bool = False) -> bool:
        """Re-form the next batch off ``prev_batch``'s promised token
        counts and dispatch it chained off ``prev_handle``, fused with the
        links behind it into one block where it is pure decode and they
        fit; False (a stall counted) when it needs host-committed state.
        ``mixed`` (the unified step): the re-form crosses the phase
        boundary, prefill chunks riding beside the decode rows
        (``schedule_reform(..., allow_prefill=True)``); such a batch runs
        as one eager mixed step and counts as an absorb."""
        if self.runner.hybrid:
            # GDN state is cumulative: a discarded step would leave a
            # slot advanced by a token that never committed, and the
            # rebuild would advance it again. Hybrid models keep the
            # drain-and-sync edge.
            self._note_stall("readback")
            return False
        batch = self.scheduler.schedule_reform(prev_batch,
                                               allow_prefill=mixed)
        if batch is None:
            reason = self.scheduler.reform_fail_reason
            self._note_stall(reason if reason in ("pages", "pp_budget")
                             else "readback")
            return False
        promises = FutureMap.promised_ids(batch)
        # a prefill chunk, or a row whose one remaining token is its
        # prompt's last (a joining sequence still prefilling), keeps the
        # batch a single step; the gate reads chunk positions, so a
        # promised row after a final prefill chunk is a decode row
        decode_only = all(it.num_new_tokens == 1
                          and it.computed_before >= it.seq.prompt_len
                          for it in batch.items)
        if mixed and not decode_only:
            self.absorbs += 1
        links = (self._schedule_multi_links(batch, multi - 1)
                 if multi > 1 and decode_only else [])
        if links:
            chain = [self._block_root(batch, links)] + links
            self._launch(self.runner.step_multi, chain, prev_handle,
                         chained=True, promises=promises)
        else:
            self._launch(self.runner.step_async_chained, batch, prev_handle,
                         chained=True, promises=promises)
        self._yield_noted = False
        if pressure:
            self._chained_under_pressure += 1 + len(links)
        return True

    def generate(
        self,
        prompts: Optional[Union[str, Seq[str]]] = None,
        sampling_params: Optional[Union[SamplingParams,
                                        Seq[SamplingParams]]] = None,
        prompt_token_ids: Optional[Seq[List[int]]] = None,
    ) -> List[RequestOutput]:
        if prompts is not None and prompt_token_ids is not None:
            raise ValueError(
                "pass either prompts or prompt_token_ids, not both")
        if prompts is None and prompt_token_ids is None:
            raise ValueError("pass prompts or prompt_token_ids")
        if prompts is not None and isinstance(prompts, str):
            prompts = [prompts]
        if prompt_token_ids is None:
            prompt_token_ids = [self.encode(p) for p in prompts]
        n = len(prompt_token_ids)
        if sampling_params is None:
            sampling_params = SamplingParams()
        if isinstance(sampling_params, SamplingParams):
            sampling_params = [dataclasses.replace(sampling_params)
                               for _ in range(n)]
        elif len(sampling_params) != n:
            raise ValueError(
                f"{len(sampling_params)} sampling_params for {n} prompts")

        seqs = [self._allocate_seq(ids, sp)
                for ids, sp in zip(prompt_token_ids, sampling_params)]
        for s in seqs:
            self.add_seq(s)
        if self._step_timing_enabled:
            # armed only here: a serving engine drives step() and must
            # not keep rows nobody prints
            self._step_timer = []
            t_gen = time.monotonic()
        try:
            while self.has_unfinished:
                for out in self.step():
                    if (out.new_token_id is not None
                            and self.tokenizer is not None):
                        self._stream_detokenize(out.seq)
            if self._step_timer is not None:
                self._print_step_timing(time.monotonic() - t_gen)
        finally:
            self._step_timer = None
        return [self._finalize(s) for s in seqs]

    def _print_step_timing(self, wall_s: float) -> None:
        """One ``[step timing]`` JSON line on stderr: generate's wall,
        its collects and their wall, and by kind the collects, their wall,
        tokens and ms each (``GLLM_TPU_STEP_TIMING``)."""
        rows = self._step_timer
        by_kind: dict = {}
        for dt, kind, toks in rows:
            e = by_kind.setdefault(kind, [0, 0.0, 0])
            e[0] += 1
            e[1] += dt
            e[2] += toks
        summary = {
            "wall_s": round(wall_s, 2),
            "iters": len(rows),
            "collect_s": round(sum(r[0] for r in rows), 2),
            "kinds": {k: {"iters": v[0], "collect_s": round(v[1], 2),
                          "tokens": v[2],
                          "ms_per_iter": round(v[1] / v[0] * 1e3, 1)}
                      for k, v in sorted(by_kind.items())},
        }
        print("[step timing] " + json.dumps(summary), file=sys.stderr,
              flush=True)

    # ---- output -----------------------------------------------------------

    def _stream_detokenize(self, seq: Sequence) -> str:
        t0 = time.monotonic() if self.tracing else 0.0
        text, seq.detok_prefix_offset, seq.detok_read_offset = (
            detokenize_incrementally(self.tokenizer, seq.token_ids,
                                     seq.detok_prefix_offset,
                                     seq.detok_read_offset))
        seq.output_text += text
        if self.tracing:
            # summed over the request, one "detokenize" span at its finish
            seq._detok_s = (getattr(seq, "_detok_s", 0.0)
                            + (time.monotonic() - t0))
        return text

    def _finalize(self, seq: Sequence) -> RequestOutput:
        text = seq.output_text
        if self.tokenizer is not None:
            if seq.detok_read_offset < seq.num_tokens:
                # the tokens the partial-character check still holds back
                # go out, even if they end in an incomplete character
                done = self.tokenizer.decode(
                    seq.token_ids[seq.detok_prefix_offset:
                                  seq.detok_read_offset])
                full = self.tokenizer.decode(
                    seq.token_ids[seq.detok_prefix_offset:])
                text += full[len(done):]
                seq.detok_read_offset = seq.num_tokens
                seq.output_text = text
            elif not text and seq.detok_read_offset <= seq.prompt_len:
                # never detokenized; a stop string's cut to "" leaves the
                # read offset at the end and is not undone here
                text = self.tokenizer.decode(seq.output_token_ids)
                seq.output_text = text
        return RequestOutput(
            seq_id=seq.seq_id,
            prompt_token_ids=seq.token_ids[:seq.prompt_len],
            output_token_ids=seq.output_token_ids,
            text=text,
            finish_reason=seq.finish_reason,
            num_prompt_tokens=seq.prompt_len,
            num_output_tokens=seq.num_output_tokens,
            logprobs=seq.output_logprobs,
            prompt_logprobs=seq.prompt_logprobs,
        )

    def abort(self, seq_id: int) -> None:
        self.scheduler.abort_seq(seq_id)

    # ---- fault isolation --------------------------------------------------

    def quarantine_step_failure(self, everything: bool = False
                                ) -> List[int]:
        """Bring the engine back to a consistent state after ``step()``
        raised (JAX's ``quarantine_step_failure:2101``). The entries in
        flight (the failed one included: ``step`` keeps it there) and a
        batch whose launch raised are the failure's reach (JAX leaves the
        last out): their device state is unknown, so their sequences
        are dropped wholesale (pages freed, status ABORTED, in-flight
        counts zeroed), with the chain tip; the waiting queue and the
        running sequences of no such entry stay and are scheduled again.
        When neither reaches a sequence (the failure came before a
        launch, in scheduling or staging), the running set is the suspect: scheduling it again would retry
        the failing step. ``everything`` (the unhealthy latch) drops the
        waiting queue too. Returns the dropped sequence ids, for the
        serving engine's error chunks."""
        failed: set = set()
        reach = [entry.batch for entry in self._in_flight]
        if self._launching is not None:
            reach.append(self._launching)
        for batch in reach:
            for b in (batch if isinstance(batch, list) else [batch]):
                for it in b.items:
                    if it.seq.seq_id != HOLE_SEQ_ID:
                        failed.add(it.seq.seq_id)
        self._in_flight.clear()
        self._launching = None
        self._chain_tip = None
        self._chained_under_pressure = 0
        self._yield_noted = False
        sched = self.scheduler
        if everything:
            failed.update(x.seq_id for x in sched.running)
            failed.update(x.seq_id for x in sched.waiting)
        elif not failed:
            failed.update(x.seq_id for x in sched.running)
        sched.quarantine(failed)
        if self.tracing:
            # a quarantined request gives no finishing output: its tree
            # closes here, with the reason of its terminal error chunk
            now = time.monotonic()
            for sid in failed:
                self.spans.finish(sid, "error", now)
        TRACE.record("quarantine", num_seqs=len(failed))
        return sorted(failed)


def _holes(batch) -> int:
    """Hole rows of a batch (persistent slots)."""
    return sum(it.seq.seq_id == HOLE_SEQ_ID for it in batch.items)
