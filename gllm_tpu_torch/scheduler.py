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

The JAX scheduler's chained/re-formed decode, speculative drafting, SSM
slots, host KV tier, spans and metrics belong to options this port does
not implement yet, and are not copied.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

from gllm_tpu_torch.config import EngineConfig
from gllm_tpu_torch.memory_manager import MemoryManager
from gllm_tpu_torch.sequence import Sequence, SequenceStatus
from gllm_tpu_torch.utils import cdiv


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

        self.new_token_ratio = self.sched_cfg.init_new_token_ratio
        self._ratio_decay = (
            (self.sched_cfg.init_new_token_ratio
             - self.sched_cfg.min_new_token_ratio)
            / max(1, self.sched_cfg.new_token_ratio_decay_steps))
        # Rotating offset so decode seqs beyond the per-batch cap are served
        # round-robin.
        self._decode_offset = 0
        self.num_preemptions = 0

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
        return max(cfg.min_prefill_tokens,
                   min(budget, cfg.max_prefill_tokens))

    # ---- preemption -------------------------------------------------------

    def _do_preempt(self, victim: Sequence) -> None:
        """Evict ``victim`` (already removed from running) to the head of
        the waiting queue; its KV is recomputed on re-admission."""
        self.mm.free_seq(victim)
        victim.preempt()
        self.waiting.appendleft(victim)
        self.num_preemptions += 1
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
                          token_budget: int) -> None:
        protect = {it.seq.seq_id for it in items}
        max_seqs = self.config.max_num_seqs

        # 1) continue partially prefilled running seqs (already admitted).
        for seq in [s for s in self.running
                    if s.num_remaining_tokens > 1 and not s.num_in_flight]:
            if token_budget <= 0 or len(items) >= max_seqs:
                break
            n = min(seq.num_remaining_tokens, token_budget)
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
            self.mm.allocate_seq_pages(seq, n)
            self.waiting.popleft()
            seq.status = SequenceStatus.RUNNING
            self.running.append(seq)
            items.append(ScheduledSeq(seq, n, seq.num_computed_tokens))
            token_budget -= n

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
        """Finish a RUNNING seq and release its pages."""
        if seq.status is not SequenceStatus.RUNNING:
            return
        seq.status = SequenceStatus.FINISHED
        seq.finish_reason = reason
        self.running.remove(seq)
        self.mm.free_seq(seq)

    # ---- aborts -----------------------------------------------------------

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
