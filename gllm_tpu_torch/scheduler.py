"""Continuous-batching scheduler (counterpart of ``gllm_tpu/scheduler.py``,
``Scheduler:191``), trimmed to the synchronous single-device loop.

- unified token accounting: each step computes tokens
  ``[computed, computed+n)`` for every scheduled sequence; a sequence whose
  chunk reaches the end of its known tokens samples a next token. Prefill
  and decode are the same code path (chunked prefill).
- three policies: ``chunked_prefill`` (default), ``token_throttling``
  (prefill budget ramps with the KV free ratio, smoothed against waiting
  prefill work) and ``split_pd`` (pure-prefill else pure-decode batches).
- adaptive admission: a waiting sequence is admitted only if the cache can
  hold its chunk plus ``new_token_ratio`` of its expected output; the ratio
  decays from init to min over steps and resets on preemption.
- largest-first preemption under memory pressure; preempted sequences
  return to the head of the waiting queue.
- aborts.

- hybrid models: admission also needs a free SSM working slot
  (``can_admit_seq``), taken after the pages (``prepare_seq``); a
  preempted or finished sequence frees its slot through ``free_seq``, and
  a re-admitted one starts again from a zeroed state.

- overlap scheduling: ``schedule_chain`` commits the next pure-decode
  steps off a batch still in flight (page allocation, positions and slots
  need token counts only; the runner splices the tokens in on the
  device), one link or a block of a power of two of them that runs
  through the length deaths inside it (``active_until``), and
  ``schedule_reform`` re-forms it across a membership change off the
  promised counts (the pipelined loop; ``discard_batch`` unwinds an entry
  the engine invalidates). A sequence that finishes while a step of it is
  still in flight keeps its pages and SSM slot until the last one lands
  (``_deferred_free``).
- the unified step under overlap: ``schedule_reform(prev,
  allow_prefill=True)`` crosses the phase boundary, a MIXED re-form: the
  promised decode rows first, then promised mid-prefill rows continued
  from their frontier, then committed-state prefill work and waiting
  admissions (``_schedule_prefill(..., preempt=False)``), so that a chain
  absorbs prefill work instead of yielding to it.
- persistent slots (``decode_slot_batching``): a chain keeps a finished
  row as a dead hole (the shared ``make_hole_seq`` sentinel), seats
  decode-ready sequences in its holes at a chain boundary (``host_rows``:
  their input token is the host's) and compacts only when its live rows
  fall below its power-of-two sequence bucket.

- fault isolation: ``quarantine`` drops the sequences of a failed step
  wholesale (pages freed, in-flight counts zeroed, deferred frees
  flushed, the hole sentinel's count reset) so that the engine returns to
  idle instead of retrying the failed step.
- metrics: the waiting, running and decode gauges and the KV use (set at
  most once a second from ``schedule_once``, and by ``publish_stats``),
  preemptions, admissions and the throttled prefill budget, under JAX's
  names (``gllm_tpu/scheduler.py:52-72``).

The JAX scheduler's speculative drafting, SSM snapshots
(``_ssm_align_chunk``), host KV tier and spans belong to options this port
does not implement yet, and are not copied.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

from gllm_tpu_torch.config import EngineConfig
from gllm_tpu_torch.memory_manager import MemoryManager
from gllm_tpu_torch.obs import metrics as obs
from gllm_tpu_torch.sequence import (HOLE_SEQ_ID, Sequence, SequenceStatus,
                                     make_hole_seq)
from gllm_tpu_torch.utils import bucket_size, cdiv

logger = logging.getLogger(__name__)

# Scheduler metrics: host gauges and counters set from numbers the
# scheduler already has. The gauges carry the dp replica label of the JAX
# package's ("0": this port runs one replica).
_M_WAITING = obs.gauge("gllm_sched_waiting_seqs",
                       "sequences queued waiting for admission", ("dp",))
_M_RUNNING = obs.gauge("gllm_sched_running_seqs",
                       "sequences admitted and holding KV pages", ("dp",))
_M_DECODE = obs.gauge("gllm_sched_decode_seqs",
                      "running sequences in the decode phase", ("dp",))
_M_KV_UTIL = obs.gauge("gllm_sched_kv_util",
                       "fraction of KV pages in use (0..1)", ("dp",))
_M_PREEMPT = obs.counter("gllm_sched_preemptions_total",
                         "sequences preempted under memory pressure")
_M_ADMIT = obs.counter("gllm_sched_admitted_total",
                       "sequences admitted from the waiting queue")
_M_BUDGET = obs.gauge("gllm_sched_prefill_token_budget",
                      "prefill token budget of the latest schedule pass",
                      ("dp",))


@dataclasses.dataclass
class ScheduledSeq:
    seq: Sequence
    num_new_tokens: int          # tokens computed this step
    computed_before: int         # seq.num_computed_tokens when scheduled

    @property
    def samples(self) -> bool:
        """True when this chunk reaches the end of known tokens → the step
        produces logits for this sequence and samples a token."""
        return (self.computed_before + self.num_new_tokens
                == self.seq.num_tokens)


@dataclasses.dataclass
class ScheduledBatch:
    items: List[ScheduledSeq]
    # the first link of a block (schedule_chain): per item, the links in
    # which it is alive; a sequence that reaches its length limit inside
    # the block freezes there (position held, KV writes to the dummy
    # page) and its later tokens are dropped. None: every item alive in
    # every link. Under on-device finish an upper bound: a sampled EOS or
    # stop token lowers the device's count inside the block. A hole row
    # (persistent slots) has 0: dead for the whole block
    active_until: Optional[List[int]] = None
    # the first link of a chain under persistent slots: the rows whose
    # input token is the host's, sequences that joined the chain through a
    # hole at this boundary (every other row takes the previous entry's
    # token of the same row on the device). None: no join
    host_rows: Optional[List[int]] = None
    # a re-formed batch (schedule_reform): per item, the row of the
    # previous entry's on-device sampled tokens that is its input token
    # (a promised decode row: one token), or -1 when the host knows every
    # input token of the item (a decode-ready sequence joining the batch
    # or, in a mixed re-form of the unified step, a prefill chunk, whose
    # items follow the decode rows). None: not a re-formed batch (a
    # chained step maps row to row)
    src_rows: Optional[List[int]] = None

    @property
    def num_seqs(self) -> int:
        return len(self.items)

    @property
    def total_tokens(self) -> int:
        return sum(it.num_new_tokens for it in self.items)

    @property
    def num_decode(self) -> int:
        return sum(1 for it in self.items if it.num_new_tokens == 1
                   and not it.seq.is_prefilling)


@dataclasses.dataclass
class SeqOutput:
    """One step's result for one sequence (engine-facing)."""
    seq: Sequence
    new_token_id: Optional[int]
    finish_reason: Optional[str]


class Scheduler:
    def __init__(self, config: EngineConfig, memory_manager: MemoryManager):
        self.config = config
        self.sched_cfg = config.scheduler
        self.mm = memory_manager

        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        self._aborted_ids: set[int] = set()
        # finished sequences whose pages (and SSM slot) wait for their
        # last in-flight step to land
        self._deferred_free: set = set()

        self.new_token_ratio = self.sched_cfg.init_new_token_ratio
        self._ratio_decay = (
            (self.sched_cfg.init_new_token_ratio
             - self.sched_cfg.min_new_token_ratio)
            / max(1, self.sched_cfg.new_token_ratio_decay_steps))
        # Rotating offset so decode seqs beyond the per-batch cap are served
        # round-robin.
        self._decode_offset = 0
        self.num_preemptions = 0
        # why the last schedule_chain / schedule_reform refused (None after
        # one that succeeded): finish / shape / pages / waiting, resp. shape
        # / pages / pp_budget
        self.chain_break_reason: Optional[str] = None
        self.reform_fail_reason: Optional[str] = None
        # persistent slots: the dead sequence behind every hole row, the
        # sequence buckets' cap (the batch builder's), and the chains
        # refused because their live rows fell below their bucket
        self._hole_seq = make_hole_seq()
        self._seq_bucket_cap = min(config.max_num_seqs,
                                   self.sched_cfg.max_decode_seqs
                                   + self.sched_cfg.max_prefill_tokens)
        self.num_compactions = 0
        self._last_stats_time = 0.0

    # ---- intake -----------------------------------------------------------

    def add_seq(self, seq: Sequence) -> None:
        if seq.num_tokens == 0:
            raise ValueError("empty prompt")
        if seq.num_tokens + 1 > self.config.max_model_len:
            raise ValueError(
                f"prompt of {seq.num_tokens} tokens exceeds max_model_len "
                f"{self.config.max_model_len}")
        # Reject work that can never fit the KV pool even running alone —
        # otherwise the engine loop would spin on None batches forever.
        max_len = min(seq.num_tokens + seq.sampling_params.max_tokens,
                      self.config.max_model_len)
        need = cdiv(max_len, self.mm.page_size)
        if need > self.mm.allocator.num_total:
            raise ValueError(
                f"request needs {need} KV pages but the pool has only "
                f"{self.mm.allocator.num_total}")
        seq.status = SequenceStatus.WAITING
        self.waiting.append(seq)

    def abort_seq(self, seq_id: int) -> None:
        self._aborted_ids.add(seq_id)

    @property
    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.running)

    # ---- policy budgets ---------------------------------------------------

    def _prefill_token_budget(self) -> int:
        cfg = self.sched_cfg
        if cfg.schedule_method != "token_throttling":
            return cfg.max_prefill_tokens
        # Token throttling: ramp the prefill budget with the KV free ratio
        # so prefill backs off as the cache fills, and smooth it against
        # the amount of waiting prefill work.
        reserve = cfg.throttle_reserve
        ramp = (self.mm.free_ratio - reserve) / max(1e-6, 1.0 - reserve)
        ramp = min(1.0, max(0.0, ramp))
        budget = int(cfg.max_prefill_tokens * ramp)
        wait_tokens = sum(s.num_remaining_tokens for s in self.waiting)
        wait_tokens += sum(s.num_remaining_tokens for s in self.running
                           if s.num_remaining_tokens > 1)
        smooth = wait_tokens // max(1, cfg.iter_smooth)
        budget = min(budget, max(smooth, cfg.min_prefill_tokens))
        budget = max(cfg.min_prefill_tokens,
                     min(budget, cfg.max_prefill_tokens))
        _M_BUDGET.set(budget, dp="0")
        return budget

    # ---- preemption -------------------------------------------------------

    def _do_preempt(self, victim: Sequence) -> None:
        """Evict ``victim`` (already removed from running) to the head of
        the waiting queue; its KV is recomputed on re-admission."""
        self.mm.free_seq(victim)
        victim.preempt()
        self.waiting.appendleft(victim)
        self.num_preemptions += 1
        _M_PREEMPT.inc()
        self.new_token_ratio = self.sched_cfg.init_new_token_ratio

    def _preempt_one(self, protect: set[int]) -> bool:
        """Free memory by preempting the largest unprotected running seq."""
        victims = [s for s in self.running
                   if s.seq_id not in protect and not s.num_in_flight]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.num_tokens)
        self.running.remove(victim)
        self._do_preempt(victim)
        return True

    def _allocate_with_preemption(self, seq: Sequence, n_tokens: int,
                                  protect: set[int]) -> bool:
        need = self.mm.pages_needed(seq, n_tokens)
        while not self.mm.can_allocate(need):
            if not self._preempt_one(protect):
                return False
            if seq.status is not SequenceStatus.RUNNING:
                return False  # preempted ourselves — nothing left to take
        self.mm.allocate_seq_pages(seq, n_tokens)
        return True

    # ---- main entry -------------------------------------------------------

    def schedule_once(self) -> Optional[ScheduledBatch]:
        self._process_aborts()
        self._decay_ratio()

        decode_ready = [s for s in self.running
                        if s.num_remaining_tokens == 1 and not s.num_in_flight]
        prefill_mid = [s for s in self.running
                       if s.num_remaining_tokens > 1 and not s.num_in_flight]
        has_prefill_work = bool(prefill_mid or self.waiting)

        items: List[ScheduledSeq] = []
        if self.sched_cfg.schedule_method == "split_pd" and has_prefill_work:
            self._schedule_prefill(items, self._prefill_token_budget())
            if not items:  # could not admit anything → fall back to decode
                self._schedule_decode(items, decode_ready)
        elif self.sched_cfg.schedule_method == "split_pd":
            self._schedule_decode(items, decode_ready)
        else:
            self._schedule_decode(items, decode_ready)
            self._schedule_prefill(items, self._prefill_token_budget())

        self._maybe_log_stats()
        if not items:
            return None
        for it in items:
            it.seq.num_in_flight += 1
        return ScheduledBatch(items)

    def _schedule_decode(self, items: List[ScheduledSeq],
                         decode_ready: List[Sequence]) -> None:
        budget = self.sched_cfg.max_decode_seqs
        if not decode_ready:
            return
        # Rotate so capped decode scheduling is fair across iterations.
        off = self._decode_offset % len(decode_ready)
        orderd = decode_ready[off:] + decode_ready[:off]
        self._decode_offset += budget
        protect = {it.seq.seq_id for it in items}
        for seq in orderd[:budget]:
            if seq.status is not SequenceStatus.RUNNING:
                # Preempted as a victim by an earlier seq in this same pass
                # (already reset and pushed to waiting).
                continue
            protect.add(seq.seq_id)
            if not self._allocate_with_preemption(seq, 1, protect):
                protect.discard(seq.seq_id)
                if seq.status == SequenceStatus.RUNNING:
                    # No victim available — preempt this seq itself so the
                    # system always makes progress.
                    self.running.remove(seq)
                    self._do_preempt(seq)
                continue
            items.append(ScheduledSeq(seq, 1, seq.num_computed_tokens))

    def _schedule_prefill(self, items: List[ScheduledSeq],
                          token_budget: int, preempt: bool = True) -> None:
        """Prefill chunks under ``token_budget``: running sequences' next
        chunks, then admissions from the waiting queue. ``preempt=False``
        (a mixed re-form of the unified step): a chunk whose pages would
        need a victim is skipped instead, since a preempted victim's freed
        pages could not come back if the re-form is invalidated
        (``gllm_tpu/scheduler.py:509-545``)."""
        protect = {it.seq.seq_id for it in items}
        max_seqs = self.config.max_num_seqs

        # 1) continue partially prefilled running seqs (already admitted).
        for seq in [s for s in self.running
                    if s.num_remaining_tokens > 1 and not s.num_in_flight]:
            if token_budget <= 0 or len(items) >= max_seqs:
                break
            n = min(seq.num_remaining_tokens, token_budget)
            if not preempt:
                if not self.mm.can_allocate(self.mm.pages_needed(seq, n)):
                    continue
                self.mm.allocate_seq_pages(seq, n)
            else:
                protect.add(seq.seq_id)
                if not self._allocate_with_preemption(seq, n, protect):
                    protect.discard(seq.seq_id)
                    continue
            items.append(ScheduledSeq(seq, n, seq.num_computed_tokens))
            token_budget -= n

        # 2) admit from the waiting queue, FIFO with head-of-line blocking.
        while (self.waiting and token_budget > 0
               and len(self.running) < self.config.max_num_seqs
               and len(items) < max_seqs):
            seq = self.waiting[0]
            if seq.seq_id in self._aborted_ids:
                if seq.num_in_flight:
                    break  # let the in-flight step land before freeing
                self.waiting.popleft()
                self._finish_abort(seq)
                continue
            if seq.num_computed_tokens == 0 and not seq.page_table:
                self.mm.match_prefix(seq)
            n = min(seq.num_remaining_tokens, token_budget)
            # Adaptive admission: reserve room for the chunk plus
            # new_token_ratio of the expected decode output. When nothing is
            # running and nothing else got scheduled, drop the reservation —
            # admitting the head seq is the only way to make progress.
            est_extra = int(seq.sampling_params.max_tokens
                            * self.new_token_ratio)
            if not self.running and not items:
                est_extra = 0
            need = self.mm.pages_needed(seq, n) + cdiv(
                est_extra, self.mm.page_size)
            if not self.mm.can_allocate(need):
                break
            if not self.mm.can_admit_seq():
                break  # hybrid: no free SSM working slot
            self.mm.allocate_seq_pages(seq, n)
            self.mm.prepare_seq(seq)
            self.waiting.popleft()
            seq.status = SequenceStatus.RUNNING
            if not seq.first_sched_time:
                # the queue-time anchor; a preempted sequence keeps its
                # first admission's
                seq.first_sched_time = time.monotonic()
            _M_ADMIT.inc()
            self.running.append(seq)
            items.append(ScheduledSeq(seq, n, seq.num_computed_tokens))
            token_budget -= n

    # ---- overlap scheduling -----------------------------------------------

    def schedule_chain(self, prev: ScheduledBatch, k_max: int = 1,
                       include_prev: bool = False) -> List[ScheduledBatch]:
        """Up to ``k_max`` chained pure-decode steps (links) of every row
        of ``prev``, scheduled before ``prev``'s sampled tokens reach the
        host (JAX's ``schedule_chain:617`` without speculation): pages,
        positions and slots follow from token counts alone, and the runner
        carries each row's input token on the device. One link is a
        chained step; more are one block (``ModelRunner.step_multi``).

        Every row must be a RUNNING, not aborted sequence whose chunk
        reaches the end of its known tokens, and, in the legacy
        membership, none may die by length the moment ``prev`` lands. A
        row that dies by length inside the block runs through it dead
        (``active_until`` on the first link: frozen position, KV writes to
        the dummy page, later tokens dropped by ``process_output``).

        Under ``decode_slot_batching`` membership is by slot: a finished
        row becomes a hole (``active_until`` 0; a row dying the moment
        ``prev`` lands is dead the same way), decode-ready sequences join
        the holes (``host_rows``; ``_join_ready_into_holes``), and the
        chain breaks only when ready sequences cannot be seated
        ("waiting"), when no row is live or can take a link, or when the
        live rows fall below the batch's power-of-two sequence bucket
        (compaction, "shape": the re-formed batch lands on a smaller
        signature).

        The page need of the whole chain is checked read-only, link by
        link, before any allocation; the feasible length is then cut to a
        power of two (with ``include_prev``, ``prev`` itself is the
        block's first step, so ``1 +`` the links is). Returns [] (the
        reason in ``chain_break_reason``) when no link is feasible; the
        caller then takes the sync path."""
        self.chain_break_reason = None
        slots = self.config.decode_slot_batching
        base: List[Tuple[Sequence, int]] = []
        hole_rows: List[int] = []
        for i, it in enumerate(prev.items):
            seq = it.seq
            if slots and seq.status is SequenceStatus.FINISHED:
                # the row keeps its slot, dead; the finished sequence's
                # pages go by the deferred free as before
                base.append((self._hole_seq, 0))
                hole_rows.append(i)
                continue
            # a finish committed while this row was in flight (legacy
            # membership), a preemption: the sync path re-forms the batch
            if seq.status is not SequenceStatus.RUNNING:
                return self._chain_fail("finish")
            # an abort: its pages are reaped on the sync pass, in either
            # membership ("finish" stays 0 under slots)
            if seq.seq_id in self._aborted_ids:
                return self._chain_fail("shape")
            # a mid-prompt chunk samples nothing to chain off; a chunk
            # past the host's tokens (a chained step) does
            if it.computed_before + it.num_new_tokens < seq.num_tokens:
                return self._chain_fail("shape")
            base.append((seq, it.computed_before + it.num_new_tokens))
        host_rows: List[int] = []
        if slots:
            host_rows = self._join_ready_into_holes(base, hole_rows)
            if self.chain_break_reason is not None:
                return []         # ready sequences the holes cannot seat
            live = sum(seq.seq_id != HOLE_SEQ_ID for seq, _ in base)
            if not live:
                return self._chain_fail("shape")      # nothing left
            cap = self._seq_bucket_cap
            if bucket_size(live, 8, cap) < bucket_size(len(base), 8, cap):
                # compaction: the sync path re-forms the live rows into
                # the smaller bucket's (already captured) signature
                self.num_compactions += 1
                return self._chain_fail("shape")
        # per row, the links it takes: link j processes token cn0 + j,
        # which exists while the sequence is under its max_tokens and the
        # model length; a hole takes none
        deaths = [0 if seq.seq_id == HOLE_SEQ_ID else
                  min(seq.sampling_params.max_tokens + seq.prompt_len
                      - cn0 - 1, self.config.max_model_len - cn0)
                  for seq, cn0 in base]
        if not slots and min(deaths) < 1:
            # a row dies the moment prev lands
            return self._chain_fail("finish")
        if max(deaths) < 1:
            return self._chain_fail("shape")       # no row takes a link
        page = self.mm.page_size
        feasible = 0
        while feasible < min(k_max, max(deaths)):
            # the whole chain so far, before any allocation: link-by-link
            # checks would each pass near a full pool; dead links take no
            # page
            need = sum(max(0, cdiv(cn0 + min(feasible + 1, d), page)
                           - len(seq.page_table))
                       for (seq, cn0), d in zip(base, deaths))
            if not self.mm.can_allocate(need):
                break
            feasible += 1
        if not feasible:
            return self._chain_fail("pages")
        if include_prev:
            k = (1 << ((feasible + 1).bit_length() - 1)) - 1
            if not k:
                return self._chain_fail("pages")
        else:
            k = 1 << (feasible.bit_length() - 1)
        chain: List[ScheduledBatch] = []
        for j in range(k):
            # a dead link freezes computed_before at the death position,
            # so the next chain off this block fails the gate above (or,
            # under slots, finds the row finished: a hole)
            items = [ScheduledSeq(seq, 1, cn0 + min(j, d))
                     for (seq, cn0), d in zip(base, deaths)]
            for (seq, cn0), d in zip(base, deaths):
                if j < d:
                    # cover [0, cn0 + j + 1): num_computed_tokens has not
                    # advanced yet
                    self.mm.allocate_seq_pages(
                        seq, cn0 + j + 1 - seq.num_computed_tokens)
                seq.num_in_flight += 1
            chain.append(ScheduledBatch(items))
        if any(d < k for d in deaths):
            # a row whose death has passed (a hole; under slots also one
            # that dies by length the moment prev lands) is alive in none
            chain[0].active_until = [max(0, min(d, k)) for d in deaths]
        chain[0].host_rows = host_rows or None
        return chain

    def _join_ready_into_holes(self, base: List[Tuple[Sequence, int]],
                               hole_rows: List[int]) -> List[int]:
        """Seat decode-ready running sequences in the chain's holes
        (JAX's ``_join_ready_into_holes:855``), in place in ``base``; the
        rows filled, whose input token is the host's (their last sampled
        token has landed), are returned for ``host_rows``. When ready
        sequences outnumber the holes, the batch must grow past its
        signature: ``chain_break_reason`` "waiting", and the caller
        re-forms a larger batch, unless the batch is already at the
        decode budget, where a re-form could not seat them either (they
        wait, as under the legacy rotation). A sequence with stop strings
        joins no chain (they are checked between steps), as in JAX; the
        other options that keep one out there (penalties, logit_bias,
        logprobs) are refused by this port's ``SamplingParams.validate``."""
        in_chain = {seq.seq_id for seq, _ in base}
        ready = [s for s in self.running
                 if s.num_remaining_tokens == 1 and not s.num_in_flight
                 and s.seq_id not in in_chain
                 and s.seq_id not in self._aborted_ids]
        if not ready:
            return []
        joins = list(zip(hole_rows, (s for s in ready
                                     if not s.sampling_params.stop)))
        if (len(joins) < len(ready)
                and len(base) < self.sched_cfg.max_decode_seqs):
            self.chain_break_reason = "waiting"
            return []
        for row, seq in joins:
            base[row] = (seq, seq.num_computed_tokens)
        return [row for row, _ in joins]

    def _chain_fail(self, reason: str) -> list:
        self.chain_break_reason = reason
        return []

    def schedule_reform(self, prev: ScheduledBatch,
                        allow_prefill: bool = False
                        ) -> Optional[ScheduledBatch]:
        """Re-form the next batch off ``prev``'s promised token counts,
        before its tokens reach the host (the pipelined loop; JAX's
        ``schedule_reform:905``): where ``schedule_chain`` refused a
        membership change. Rows that finished drop; every other row of
        ``prev`` advances to its promised frontier, its input token
        spliced on the device from ``prev``'s row (``src_rows``); rows
        that die by length once ``prev`` lands drop (the sync loop drops
        them too); decode-ready running sequences join with host-known
        tokens (``src_rows`` -1). EOS is assumed not to happen: the engine
        invalidates the entry when it does. Never preempts (a victim's
        pages could not come back if the entry is invalidated). None, with
        ``reform_fail_reason``, when the batch needs host-committed state.

        ``allow_prefill`` (the unified step under overlap): a MIXED
        re-form. A promised mid-prefill row of ``prev`` continues its
        prompt from its frontier instead of refusing (its tokens are all
        the host's: src -1, no promise); then committed-state prefill work
        and waiting admissions ride the same batch under the prefill token
        budget (``_schedule_prefill(..., preempt=False)``), all with src
        -1. The decode rows come first: K1u and K1um find that decode
        prefix on the device."""
        self.reform_fail_reason = None
        base: List[Tuple[Sequence, int, int]] = []   # (seq, cn0, src row)
        prefill_cont: List[Tuple[Sequence, int]] = []  # (seq, frontier)
        for i, it in enumerate(prev.items):
            seq = it.seq
            if seq.status is SequenceStatus.FINISHED:
                continue                     # a finish, or a hole: drops
            if seq.status is not SequenceStatus.RUNNING:
                return self._reform_fail("shape")      # preempted
            if seq.seq_id in self._aborted_ids:
                # _process_aborts reaps pages on the sync pass only
                return self._reform_fail("shape")
            if it.computed_before + it.num_new_tokens < seq.num_tokens:
                if not allow_prefill:
                    return self._reform_fail("shape")  # mid-prefill row
                # the prompt goes on from the promised frontier: every
                # input token is the host's, and no promise is made (an
                # invalidation unwinds it through the ordinary cascade)
                prefill_cont.append(
                    (seq, it.computed_before + it.num_new_tokens))
                continue
            cn0 = it.computed_before + it.num_new_tokens
            if (cn0 + 1 - seq.prompt_len >= seq.sampling_params.max_tokens
                    or cn0 + 1 >= self.config.max_model_len):
                continue
            base.append((seq, cn0, i))
        # JAX's name: at one pipeline stage the budget is max_decode_seqs,
        # which a batch of final prefill chunks may exceed
        budget = self.sched_cfg.max_decode_seqs
        if len(base) > budget:
            return self._reform_fail("pp_budget")
        in_batch = {seq.seq_id for seq, _, _ in base}
        for s in self.running:
            if (len(base) >= budget or s.num_remaining_tokens != 1
                    or s.num_in_flight or s.seq_id in in_batch
                    or s.seq_id in self._aborted_ids):
                continue
            base.append((s, s.num_computed_tokens, -1))
        if not base and not (allow_prefill and (
                prefill_cont or self.waiting
                or any(s.num_remaining_tokens > 1 and not s.num_in_flight
                       for s in self.running))):
            return self._reform_fail("shape")         # nothing left to run
        base = base[:budget]
        page = self.mm.page_size
        need = sum(max(0, cdiv(cn0 + 1, page) - len(seq.page_table))
                   for seq, cn0, _ in base)
        if not self.mm.can_allocate(need):
            return self._reform_fail("pages")
        items, src_rows = [], []
        for seq, cn0, src in base:
            self.mm.allocate_seq_pages(seq, cn0 + 1 - seq.num_computed_tokens)
            items.append(ScheduledSeq(seq, 1, cn0))
            src_rows.append(src)
        if allow_prefill:
            pf_budget = self._prefill_token_budget()
            max_seqs = self.config.max_num_seqs
            # promised mid-prefill rows continue from their frontier
            for seq, frontier in prefill_cont:
                if pf_budget <= 0 or len(items) >= max_seqs:
                    continue
                n = min(seq.num_tokens - frontier, pf_budget)
                need = max(0, cdiv(frontier + n, page) - len(seq.page_table))
                if not self.mm.can_allocate(need):
                    continue             # never preempt; it waits a pass
                self.mm.allocate_seq_pages(
                    seq, frontier + n - seq.num_computed_tokens)
                items.append(ScheduledSeq(seq, n, frontier))
                src_rows.append(-1)
                pf_budget -= n
            # committed-state prefill work: the sync loop's admission path
            # (running continuations, then the waiting queue), without
            # preemption
            before = len(items)
            self._schedule_prefill(items, pf_budget, preempt=False)
            src_rows += [-1] * (len(items) - before)
            if not items:
                return self._reform_fail("shape")
        for it in items:
            it.seq.num_in_flight += 1
        return ScheduledBatch(items, src_rows=src_rows)

    def _reform_fail(self, reason: str) -> None:
        self.reform_fail_reason = reason
        return None

    def discard_batch(self, batch) -> None:
        """Unwind an entry the engine invalidated (a batch, or a block's
        list of links): the in-flight counts drop without committing
        tokens or advancing computed counts, so the sync path schedules
        the same positions again. Pages allocated toward the promised
        frontier stay on the table; a finished sequence's deferred free
        fires once its last entry drains (the hole sentinel's count falls
        with its rows'). A mixed re-form's absorbed chunks unwind the
        same way: a sequence it admitted stays RUNNING at its committed
        count, and the sync pass schedules its prefill again."""
        for b in (batch if isinstance(batch, list) else [batch]):
            for it in b.items:
                seq = it.seq
                seq.num_in_flight -= 1
                self._free_if_drained(seq)

    def _free_if_drained(self, seq: Sequence) -> None:
        if seq in self._deferred_free and seq.num_in_flight == 0:
            self._deferred_free.discard(seq)
            self.mm.free_seq(seq)

    # ---- output path ------------------------------------------------------

    def process_output(self, batch: ScheduledBatch,
                       sampled_tokens: List[int],
                       eos_token_ids) -> List[SeqOutput]:
        """Advance state after a step. ``sampled_tokens[i]`` is the sampled
        token for batch item i (ignored for items that don't sample).
        ``eos_token_ids`` is a collection of terminator ids (or None)."""
        outputs: List[SeqOutput] = []
        for it, tok in zip(batch.items, sampled_tokens):
            seq = it.seq
            seq.num_in_flight -= 1
            if seq.status is not SequenceStatus.RUNNING:
                # finished at an earlier step while this one was in
                # flight: its pages go once the last such step lands (a
                # hole row: its token is dropped, its count falls as it
                # rose)
                self._free_if_drained(seq)
                continue
            if seq.seq_id in self._aborted_ids:
                continue  # handled in _process_aborts
            seq.num_computed_tokens = it.computed_before + it.num_new_tokens
            self.mm.register_computed_pages(seq)
            if not it.samples:
                outputs.append(SeqOutput(seq, None, None))
                continue
            seq.append_token(int(tok))
            finish = seq.check_finish(eos_token_ids)
            # Hard cap: the KV layout (page table width, rope table) is
            # sized for max_model_len; never decode past it.
            if finish is None and seq.num_tokens >= self.config.max_model_len:
                finish = "length"
            outputs.append(SeqOutput(seq, int(tok), finish))
            if finish is not None:
                self.finish_seq(seq, finish)
        return outputs

    def finish_seq(self, seq: Sequence, reason: str = "stop") -> None:
        """Finish a RUNNING seq and release its pages, or, while a step of
        it is still in flight (a chained step writing its KV), once the
        last one lands."""
        if seq.status is not SequenceStatus.RUNNING:
            return
        seq.status = SequenceStatus.FINISHED
        seq.finish_reason = reason
        self.running.remove(seq)
        if seq.num_in_flight > 0:
            self._deferred_free.add(seq)
        else:
            self.mm.free_seq(seq)

    # ---- aborts, quarantine, stats ----------------------------------------

    def quarantine(self, seq_ids) -> List[Sequence]:
        """Drop the given sequences wholesale after a step failed (the
        engine's ``quarantine_step_failure``; JAX's ``quarantine:1220``):
        their device state is unknown. Their pages free at once (the engine
        has already dropped its entries in flight, so nothing will write
        into them), their in-flight counts reset, a finished one's deferred
        free goes through, and they leave both queues with status ABORTED
        and finish reason "error", so that ``has_unfinished`` can fall to
        False instead of the failed step being retried."""
        ids = set(seq_ids)
        dropped: List[Sequence] = []
        for seq in [s for s in self.running if s.seq_id in ids]:
            self.running.remove(seq)
            self._quarantine_one(seq, dropped)
        for seq in [s for s in self.waiting if s.seq_id in ids]:
            self.waiting.remove(seq)
            self._quarantine_one(seq, dropped)
        for seq in [s for s in self._deferred_free if s.seq_id in ids]:
            # finished already; its pages waited on an entry in flight that
            # will never land now
            self._deferred_free.discard(seq)
            seq.num_in_flight = 0
            self.mm.free_seq(seq)
        self._aborted_ids -= ids
        # the hole rows of the dropped entries never see their
        # process_output decrements
        self._hole_seq.num_in_flight = 0
        return dropped

    def _quarantine_one(self, seq: Sequence,
                        dropped: List[Sequence]) -> None:
        seq.num_in_flight = 0
        seq.status = SequenceStatus.ABORTED
        seq.finish_reason = "error"
        self.mm.free_seq(seq)
        dropped.append(seq)

    def _finish_abort(self, seq: Sequence) -> None:
        seq.status = SequenceStatus.ABORTED
        seq.finish_reason = "abort"
        self.mm.free_seq(seq)
        self._aborted_ids.discard(seq.seq_id)

    def _process_aborts(self) -> None:
        if not self._aborted_ids:
            return
        # In-flight seqs keep their pages until the step lands; they are
        # reaped on a later schedule_once.
        for seq in [s for s in self.running
                    if s.seq_id in self._aborted_ids
                    and not s.num_in_flight]:
            self.running.remove(seq)
            self._finish_abort(seq)
        for seq in [s for s in self.waiting
                    if s.seq_id in self._aborted_ids
                    and not s.num_in_flight]:
            self.waiting.remove(seq)
            self._finish_abort(seq)

    def _decay_ratio(self) -> None:
        self.new_token_ratio = max(self.sched_cfg.min_new_token_ratio,
                                   self.new_token_ratio - self._ratio_decay)

    def _maybe_log_stats(self) -> None:
        """The gauges and a stats line, at most once a second."""
        now = time.monotonic()
        if now - self._last_stats_time < 1.0:
            return
        self._last_stats_time = now
        n_decode, util = self.publish_stats()
        logger.info(
            "sched: wait=%d run=%d prefill=%d decode=%d kv_util=%.1f%%",
            len(self.waiting), len(self.running),
            len(self.running) - n_decode, n_decode, util * 100.0)

    def publish_stats(self):
        """Set the waiting, running, decode and KV-use gauges from the
        current state (the serving engine also calls it when the engine
        goes idle, so that a scrape after a burst reads the idle state);
        returns (decode sequences, KV use)."""
        n_decode = sum(1 for s in self.running if s.num_remaining_tokens == 1)
        util = 1.0 - self.mm.free_ratio
        _M_WAITING.set(len(self.waiting), dp="0")
        _M_RUNNING.set(len(self.running), dp="0")
        _M_DECODE.set(n_decode, dp="0")
        _M_KV_UTIL.set(util, dp="0")
        return n_decode, util
