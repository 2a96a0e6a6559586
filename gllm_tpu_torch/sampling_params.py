"""Per-request sampling parameters (counterpart of
``gllm_tpu/sampling_params.py``).

The field set and ``validate`` are the JAX package's, so a request
object means the same in both packages. Stop strings are matched on the
host over the incrementally detokenized output
(``LLM._check_stop_strings``), and ``deadline_s`` is a wall-clock budget
from submit that the serving engine enforces (finish reason "deadline").
A seed is folded to 31 bits, so that the int32 batch arrays hold it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1                      # -1 = disabled
    min_p: float = 0.0                   # 0 = disabled (prob floor vs max)
    # OpenAI logit_bias: token id -> additive bias in [-100, 100]
    logit_bias: Optional[Dict[int, float]] = None
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0        # OpenAI additive penalties
    frequency_penalty: float = 0.0
    max_tokens: int = 16
    min_tokens: int = 0
    ignore_eos: bool = False
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    stop: List[str] = dataclasses.field(default_factory=list)
    logprobs: Optional[int] = None       # top-N logprobs per output token
    prompt_logprobs: Optional[int] = None
    seed: Optional[int] = None
    # wall-clock budget in seconds from submit: the serving engine aborts
    # the request with finish reason "deadline" once it expires, waiting or
    # generating. None defers to the engine-wide TTL
    # (``EngineConfig.request_deadline_s``)
    deadline_s: Optional[float] = None

    @property
    def uses_penalty(self) -> bool:
        """The repetition, presence or frequency penalty is on."""
        return (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)

    def validate(self) -> None:
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k == 0 or self.top_k < -1:
            raise ValueError("top_k must be -1 (disabled) or >= 1")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError("min_p must be in [0, 1]")
        if self.logit_bias is not None:
            if len(self.logit_bias) > 300:
                # OpenAI's cap; it also bounds the width of the bias pairs
                # a step stages
                raise ValueError("logit_bias supports at most 300 entries")
            for t, b in self.logit_bias.items():
                if not isinstance(t, int) or t < 0:
                    raise ValueError("logit_bias keys must be token ids")
                if not -100.0 <= b <= 100.0:
                    raise ValueError("logit_bias values must be in "
                                     "[-100, 100]")
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")
        if not -2.0 <= self.presence_penalty <= 2.0:
            raise ValueError("presence_penalty must be in [-2, 2]")
        if not -2.0 <= self.frequency_penalty <= 2.0:
            raise ValueError("frequency_penalty must be in [-2, 2]")
        if self.logprobs is not None and not 0 <= self.logprobs <= 20:
            raise ValueError("logprobs must be in [0, 20]")
        if self.prompt_logprobs is not None \
                and not 0 <= self.prompt_logprobs <= 20:
            raise ValueError("prompt_logprobs must be in [0, 20]")
        if any(not s for s in self.stop):
            raise ValueError("stop strings must be non-empty")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if self.seed is not None:
            if self.seed < 0:
                raise ValueError("seed must be >= 0")
            # a 64-bit client seed folds into the 31-bit key space
            self.seed &= 0x7FFFFFFF
