"""Per-request sampling parameters (counterpart of
``gllm_tpu/sampling_params.py``).

The field set is the JAX package's, so a request object means the same in
both packages. Stop strings are matched on the host over the
incrementally detokenized output (``LLM._check_stop_strings``), and
``deadline_s`` is a wall-clock budget from submit that the serving engine
enforces (finish reason "deadline"). The fields this port does not
implement yet (per-request seeds, penalties, logit_bias, logprobs) make
``validate`` raise instead of being silently ignored.
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
    logit_bias: Optional[Dict[int, float]] = None
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    max_tokens: int = 16
    min_tokens: int = 0
    ignore_eos: bool = False
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    stop: List[str] = dataclasses.field(default_factory=list)
    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    seed: Optional[int] = None
    # wall-clock budget in seconds from submit: the serving engine aborts
    # the request with finish reason "deadline" once it expires, waiting or
    # generating. None defers to the engine-wide TTL
    # (``EngineConfig.request_deadline_s``)
    deadline_s: Optional[float] = None

    def validate(self) -> None:
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k == 0 or self.top_k < -1:
            raise ValueError("top_k must be -1 (disabled) or >= 1")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError("min_p must be in [0, 1]")
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if any(not s for s in self.stop):
            raise ValueError("stop strings must be non-empty")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        unported = []
        if self.seed is not None:
            unported.append("seed")
        if (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0):
            unported.append("penalties")
        if self.logit_bias:
            unported.append("logit_bias")
        if self.logprobs is not None or self.prompt_logprobs is not None:
            unported.append("logprobs")
        if unported:
            raise NotImplementedError(
                "not supported by gllm_tpu_torch yet: "
                + ", ".join(unported))
