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


class Sequence:
    def __init__(
        self,
        seq_id: int,
        prompt_token_ids: List[int],
        sampling_params: Optional[SamplingParams] = None,
    ):
        self.seq_id = seq_id
        self.token_ids: List[int] = list(prompt_token_ids)
        self.prompt_len = len(prompt_token_ids)
        self.sampling_params = sampling_params or SamplingParams()
        self.status = SequenceStatus.WAITING
        self.num_computed_tokens = 0
        # Scheduled chunks of this seq not yet collected; an in-flight seq
        # is never rescheduled, preempted or freed until its step lands.
        self.num_in_flight = 0
        self.page_table: List[int] = []
        self._pt_np = None   # np cache of page_table (builder fast path)
        self.finish_reason: Optional[str] = None

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

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Sequence(id={self.seq_id}, tokens={self.num_tokens}, "
                f"computed={self.num_computed_tokens}, status={self.status.name})")
