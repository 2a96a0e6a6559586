"""Offline LLM engine (counterpart of ``gllm_tpu/engine/llm.py``:
``LLM.__init__:167``, ``add_seq:631``, ``step:680``,
``_commit_outputs:1024``, ``_dispatch_reform:1048``, ``_chain_tip:316``,
``unified:349``, ``_ondevice_block_stats:1139``,
``_count_ondevice_finishes:1230``, ``_schedule_multi:1475``,
``_check_stop_strings:1803``, ``_observe_outputs:1434``, ``generate:1894``,
``_stream_detokenize:2044``, ``_finalize:2059``, ``abort:2091``,
``quarantine_step_failure:2101``; ``RequestOutput:147``; the metrics of
``:45-141``).

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
its counterpart without speculation, dp, disaggregation and fault
points. ``CacheConfig(kv_cache_dtype="int8")`` keeps an int8 KV cache.
Unless
``EngineConfig.enforce_eager``, each pure-decode step on the card replays
the CUDA graph of its shape signature (``runner/graphs.py``; warm them
ahead of serving with ``llm.runner.warmup()``). Token ids in and out;
a text prompt, its output text and stop strings need a tokenizer object
(anything with ``encode``/``decode``) passed to the constructor. Stop
strings are matched on the host over the incrementally detokenized output
as tokens commit; a sequence with stop strings rides no block and joins no
hole, as in JAX, so it commits one token a step and its match lands on the
token just committed. The engine observes the request metrics (time to
first token, time per output token, inter-token latency, end-to-end and
queue time) and the step metrics of the JAX package under its names
(``obs/metrics.py``), and ``quarantine_step_failure`` drops the sequences
of a step that raised (the serving engine's fault isolation).

The engine runs on the CUDA card unless the caller passes
``device="cpu"``; with no card it raises instead of falling back.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
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
from gllm_tpu_torch.runner.prepare import MAX_STOP_IDS
from gllm_tpu_torch.runner.runner import ModelRunner
from gllm_tpu_torch.sampling_params import SamplingParams
from gllm_tpu_torch.scheduler import Scheduler, SeqOutput
from gllm_tpu_torch.sequence import HOLE_SEQ_ID, Sequence

logger = logging.getLogger(__name__)

# Step metrics, by the kind of the collected entry: "prefill" (a batch
# with a prefill chunk), "decode" (a single pure-decode step),
# "fused_block" (a block of K decode steps) and, under the unified step,
# "unified_step" for every single step
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
# the pipelined loop: entries dispatched and not yet collected after the
# latest fill pass
_M_INFLIGHT = obs.gauge(
    "gllm_inflight_depth",
    "dispatched-but-uncollected engine entries after the latest fill "
    "pass (pipelined loop)")


@dataclasses.dataclass
class RequestOutput:
    seq_id: int
    prompt_token_ids: List[int]
    output_token_ids: List[int]
    text: str
    finish_reason: Optional[str]
    num_prompt_tokens: int = 0
    num_output_tokens: int = 0


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
        """``model_cfg`` defaults to the one ``config.model``'s directory
        describes (its ``config.json``). ``params`` (this port's layout,
        see models/convert.py) defaults to dummy weights drawn from
        ``config.seed``."""
        config = config or EngineConfig()
        config.validate()
        self.config = config
        if model_cfg is None:
            if not config.model:
                raise ValueError("pass model_cfg or config.model, a "
                                 "directory holding a config.json")
            from gllm_tpu_torch.models.loader import load_hf_config
            model_cfg = from_hf_config(load_hf_config(config.model))
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
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
        self.eos_token_ids = model_cfg.eos_token_ids
        if not self.eos_token_ids and tokenizer is not None \
                and getattr(tokenizer, "eos_token_id", None) is not None:
            self.eos_token_ids = [tokenizer.eos_token_id]
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
                            and prev.num_decode == prev.num_seqs):
                        self._note_chain_break("waiting")
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
                        self._note_chain_break(reason)
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
                    if len(chain) > 1:
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
                    self.stalls["readback"] += 1
                ran_dry = True
                break
            if (multi > 1 and not self.scheduler.waiting
                    and batch.num_decode == batch.num_seqs):
                # a sync pure-decode batch fuses with the links behind it
                # into one block, instead of a single step first; its
                # rows are all alive, so the links' alive counts shift by
                # one
                links = self._schedule_multi_links(batch, multi - 1)
                if links:
                    chain = [self._block_root(batch, links)] + links
                    self._launch(self.runner.step_multi, chain, roots=True)
                    self._yield_noted = False
                    continue
            entry = self._launch(self.runner.step_async, batch,
                                 roots=batch.num_decode == batch.num_seqs)
            if entry.roots:
                self._yield_noted = False
        if cfg.pipelined_loop:
            _M_INFLIGHT.set(len(self._in_flight))
            if not ran_dry and len(self._in_flight) >= depth:
                self.stalls["depth"] += 1
        if not self._in_flight:
            return []
        entry = self._in_flight.popleft()
        block = isinstance(entry.batch, list)
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
        self._record_step(entry.batch)
        if not block:
            self.hole_substeps += _holes(entry.batch)
            outs = self.scheduler.process_output(
                entry.batch, tokens.tolist(), self.eos_token_ids)
            return self._commit_outputs(outs)
        # a block: [K, n] tokens, then each row's finish step; it commits
        # link by link, and a row's tokens after its finish are dropped
        # (process_output skips a finished sequence)
        chain = entry.batch
        self._block_stats(chain, tokens[-1])
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
        must drop them with the entries in flight."""
        self._launching = batch
        entry = InFlight(batch, run(batch, *prev), **flags)
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
            kind, first = "block", first[0]
        else:
            # a hole row is a one-token row: it leaves the kind as it is
            kind = ("decode" if all(it.num_new_tokens == 1
                                    for it in first.items)
                    else "mixed")
        self.dispatches[kind, len(self._in_flight)] += 1
        self.joins += len(first.host_rows or ())
        if (self.config.overlap_scheduling
                and self.config.decode_slot_batching
                and (entry.chained or entry.roots)):
            self._chain_tip = entry.tip

    def _note_chain_break(self, reason: str) -> None:
        self.chain_breaks[reason] += 1
        _M_CHAIN_BREAKS.inc(reason=reason)

    def _record_step(self, batch) -> None:
        """The step metrics of one collected entry (JAX's
        ``_record_step:1312``, its counters): steps and tokens by kind,
        and decode steps by fusion (a block's scheduled sub-steps)."""
        fused = isinstance(batch, list)
        b = batch[-1] if fused else batch
        mix = None
        if fused:
            kind = "fused_block"
            tokens = sum(x.total_tokens for x in batch)
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
        _M_STEPS.inc(kind=kind)
        _M_STEP_TOKENS.inc(tokens, kind=kind)
        if kind == "decode" or mix == "decode":
            _M_DECODE_STEPS.inc(fused="false")
        elif fused:
            _M_DECODE_STEPS.inc(len(batch), fused="true")

    # ---- blocks -----------------------------------------------------------

    def _fuse_ok(self, batch) -> bool:
        """May ``batch``'s sequences ride a block (JAX's ``_fuse_ok``)?
        Not a hybrid model's (its GDN layers keep the single-step chain),
        nor one with stop strings, which are checked between steps (the
        other gates, logit_bias and logprobs, are options this port
        refuses)."""
        if self.runner.hybrid:
            return False
        return not any(it.seq.sampling_params.stop for it in batch.items)

    def _schedule_multi(self, prev_batch, multi: int) -> list:
        """Up to ``multi`` links off ``prev_batch`` for one dispatch."""
        return self.scheduler.schedule_chain(
            prev_batch, multi if self._fuse_ok(prev_batch) else 1)

    def _schedule_multi_links(self, batch, k_max: int) -> list:
        """Links to fuse behind ``batch``, which becomes the block's first
        step."""
        if k_max < 1 or not self._fuse_ok(batch):
            return []
        return self.scheduler.schedule_chain(batch, k_max,
                                             include_prev=True)

    @staticmethod
    def _block_root(batch, links):
        """``batch`` as the first link of a block before ``links``: alive
        in one more sub-step than the links' counts say."""
        au, k = links[0].active_until, 1 + len(links)
        return dataclasses.replace(batch, active_until=(
            [min(d + 1, k) for d in au] if au is not None else None))

    def _block_stats(self, chain, finish) -> None:
        """Count a collected block: by K, its executed sub-steps (the
        latest finish step: fewer than K when every row finished early),
        its dead row-sub-steps among the rows of sequences, and its hole
        row-sub-steps; under on-device finish, the dead-fraction gauge over
        every row, holes included, as JAX's
        ``_ondevice_block_stats:1139``."""
        finish = finish[:chain[0].num_seqs]
        k_exec = int(finish.max()) if finish.size else 0
        if self.config.ondevice_finish and k_exec and finish.size:
            _M_DEAD_FRAC.set(int((k_exec - finish).sum())
                             / (k_exec * finish.size))
        live = np.array([it.seq.seq_id != HOLE_SEQ_ID
                         for it in chain[0].items], bool)
        self.blocks[len(chain)] += 1
        self.block_substeps += k_exec
        self.dead_substeps += int((k_exec - finish[live]).sum())
        self.row_substeps += k_exec * int(live.sum())
        self.hole_substeps += k_exec * int((~live).sum())

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
            if self.futures.reconcile(self._in_flight, finished):
                self.stalls["rebuild"] += 1
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

    def _check_stop_strings(self, outs) -> None:
        """Stop strings, matched on the host over the incrementally
        detokenized output (JAX's ``_check_stop_strings:1803``); the text
        is cut before the match (OpenAI's rule), and only the tail window
        (the new text and ``len(stop) - 1`` characters before it) is
        scanned again. A sequence with stop strings commits one token a
        step: ``_fuse_ok`` keeps it out of blocks, the scheduler keeps it
        out of hole joins, and the port has no speculative decoding. So
        the token that completes a match is the one just committed, and
        nothing after it needs trimming (JAX replays a speculative
        commit's tokens one at a time here)."""
        for out in outs:
            seq = out.seq
            sp = seq.sampling_params
            if (out.new_token_id is None or not sp.stop
                    or self.tokenizer is None):
                continue
            if not self._stream_detokenize(seq):
                continue
            max_stop = max(len(x) for x in sp.stop)
            start = max(0, getattr(seq, "_stop_scanned", 0) - max_stop + 1)
            window = seq.output_text[start:]
            hit = min((start + idx for idx in (window.find(x)
                                               for x in sp.stop)
                       if idx >= 0), default=-1)
            seq._stop_scanned = len(seq.output_text)
            if hit < 0:
                continue
            seq.output_text = seq.output_text[:hit]
            seq._stop_scanned = len(seq.output_text)
            self.scheduler.finish_seq(seq, "stop")
            seq.finish_reason = out.finish_reason = "stop"

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
            self.stalls["readback"] += 1
            return False
        batch = self.scheduler.schedule_reform(prev_batch,
                                               allow_prefill=mixed)
        if batch is None:
            reason = self.scheduler.reform_fail_reason
            self.stalls[reason if reason in ("pages", "pp_budget")
                        else "readback"] += 1
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
        while self.has_unfinished:
            for out in self.step():
                if out.new_token_id is not None and self.tokenizer is not None:
                    self._stream_detokenize(out.seq)
        return [self._finalize(s) for s in seqs]

    # ---- output -----------------------------------------------------------

    def _stream_detokenize(self, seq: Sequence) -> str:
        text, seq.detok_prefix_offset, seq.detok_read_offset = (
            detokenize_incrementally(self.tokenizer, seq.token_ids,
                                     seq.detok_prefix_offset,
                                     seq.detok_read_offset))
        seq.output_text += text
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
        return sorted(failed)


def _holes(batch) -> int:
    """Hole rows of a batch (persistent slots)."""
    return sum(it.seq.seq_id == HOLE_SEQ_ID for it in batch.items)
