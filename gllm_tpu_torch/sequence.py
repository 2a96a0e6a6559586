"""Per-request sequence state (counterpart of ``gllm_tpu/sequence.py``).

All known token ids (prompt + generated), the count of tokens whose KV is
resident (``num_computed_tokens``), the page table, sampling params and
lifecycle status. Prefill and decode are one path: every step computes
tokens [computed, computed+n); a step whose chunk reaches the end of the
known tokens produces logits and samples.
"""

from __future__ import annotations

import enum
from typing import List, Optional

from gllm_tpu_torch.sampling_params import SamplingParams


class SequenceStatus(enum.Enum):
    WAITING = enum.auto()
    RUNNING = enum.auto()
    PREEMPTED = enum.auto()
    FINISHED = enum.auto()
    ABORTED = enum.auto()


# seq_id of the hole rows of persistent-slot decode batches
# (``Scheduler.schedule_chain`` under ``decode_slot_batching``): a finished
# sequence's row stays in its chain, dead, so that the chain's shape
# signature survives the finish; its position is frozen, its KV writes go
# to the dummy page and its sampled tokens are dropped
HOLE_SEQ_ID = -1


def make_hole_seq() -> "Sequence":
    """The dead sequence behind every hole row (JAX's ``make_hole_seq``,
    ``gllm_tpu/sequence.py:38-55``). One is shared by all the hole rows of
    a scheduler: the batch builder reads only its constants (token 0,
    position 0, page table [0], the dummy page; no SSM slot, so a hybrid
    model's dummy slot 0), its ``num_in_flight`` rises and falls with the
    links it rides, and it is never running or waiting and owns no page.
    It ignores EOS, so that it adds no id to a block's stop sets."""
    seq = Sequence(HOLE_SEQ_ID, [0], SamplingParams(
        temperature=0.0, max_tokens=1, ignore_eos=True))
    seq.status = SequenceStatus.FINISHED
    # past its prompt: a hole row counts as a decode row
    seq.num_computed_tokens = 1
    seq.page_table = [0]
    return seq


class Sequence:
    def __init__(
        self,
        seq_id: int,
        prompt_token_ids: List[int],
        sampling_params: Optional[SamplingParams] = None,
        arrival_time: float = 0.0,
    ):
        self.seq_id = seq_id
        self.token_ids: List[int] = list(prompt_token_ids)
        self.prompt_len = len(prompt_token_ids)
        self.sampling_params = sampling_params or SamplingParams()
        self.arrival_time = arrival_time
        # the request's latency anchors (TTFT, TPOT, ITL, queue and
        # end-to-end histograms): set by the scheduler at the first
        # admission and by the engine as sampled tokens commit; 0.0 = not
        # reached yet. A preemption keeps them
        self.first_sched_time = 0.0
        self.first_token_time = 0.0
        self.last_token_time = 0.0
        self.status = SequenceStatus.WAITING
        self.num_computed_tokens = 0
        # Scheduled chunks of this seq not yet collected; an in-flight seq
        # is never rescheduled, preempted or freed until its step lands.
        self.num_in_flight = 0
        self.page_table: List[int] = []
        # hybrid models: the working slot of this sequence's GDN state
        # (conv + recurrent), held from admission until it is freed
        self.ssm_slot: Optional[int] = None
        self._pt_np = None   # np cache of page_table (builder fast path)
        self.finish_reason: Optional[str] = None
        # incremental detokenization: the window's start and the first
        # token not yet emitted. The window starts a few tokens inside the
        # prompt, so that a word-boundary marker renders as the leading
        # space of the first output token
        self.detok_prefix_offset = max(0, len(prompt_token_ids) - 6)
        self.detok_read_offset = len(prompt_token_ids)
        self.output_text = ""

    # ---- token accounting -------------------------------------------------

    @property
    def num_tokens(self) -> int:
        return len(self.token_ids)

    @property
    def num_output_tokens(self) -> int:
        return len(self.token_ids) - self.prompt_len

    @property
    def output_token_ids(self) -> List[int]:
        return self.token_ids[self.prompt_len:]

    @property
    def num_remaining_tokens(self) -> int:
        """Tokens not yet computed into the KV cache."""
        return len(self.token_ids) - self.num_computed_tokens

    @property
    def is_prefilling(self) -> bool:
        return self.num_computed_tokens < self.prompt_len

    def append_token(self, token_id: int) -> None:
        self.token_ids.append(token_id)

    # ---- lifecycle --------------------------------------------------------

    def preempt(self) -> None:
        """Return to waiting state; the caller releases the KV pages."""
        self.status = SequenceStatus.PREEMPTED
        self.num_computed_tokens = 0
        self.page_table = []
        # the batch builder caches the np form of the page table with
        # length-only invalidation; every shrink must drop it
        self._pt_np = None

    def device_stop_ids(self, eos_token_ids) -> List[int]:
        """The token ids whose sampling finishes this sequence inside a
        block under on-device finish: the engine's EOS set (unless
        ``ignore_eos``) and the request's ``stop_token_ids``, the ids
        ``check_finish`` tests, sorted. The ``min_tokens`` gate is
        positional; the batch builder arms it (``stop_from``)."""
        sp = self.sampling_params
        ids = set(sp.stop_token_ids)
        if not sp.ignore_eos and eos_token_ids:
            ids.update(int(t) for t in eos_token_ids)
        return sorted(ids)

    def check_finish(self, eos_token_ids) -> Optional[str]:
        """EOS / stop-token / length check after a token was appended.
        ``eos_token_ids`` is a collection (checkpoints declare several
        terminators)."""
        sp = self.sampling_params
        last = self.token_ids[-1]
        if isinstance(eos_token_ids, int):
            eos_token_ids = (eos_token_ids,)
        if self.num_output_tokens >= sp.min_tokens:
            if not sp.ignore_eos and eos_token_ids and last in eos_token_ids:
                return "stop"
            if last in sp.stop_token_ids:
                return "stop"
        if self.num_output_tokens >= sp.max_tokens:
            return "length"
        return None

    @property
    def is_finished(self) -> bool:
        return self.status in (SequenceStatus.FINISHED, SequenceStatus.ABORTED)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Sequence(id={self.seq_id}, tokens={self.num_tokens}, "
                f"computed={self.num_computed_tokens}, status={self.status.name})")
