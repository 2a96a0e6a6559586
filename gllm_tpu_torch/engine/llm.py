"""Offline LLM engine (counterpart of ``gllm_tpu/engine/llm.py``:
``LLM.__init__:167``, ``add_seq:631``, ``step:680``, ``generate:1894``,
``_finalize:2059``, ``abort:2091``; ``RequestOutput:147``).

The synchronous single-device loop: schedule a batch, run one step, commit
its sampled tokens. ``EngineConfig.unified_step`` runs every step through
the unified attention kernel and ``CacheConfig(kv_cache_dtype="int8")``
keeps an int8 KV cache; both stay on this sync loop. Unless
``EngineConfig.enforce_eager``, each pure-decode step on the card replays
the CUDA graph of its shape signature (``runner/graphs.py``; warm them
ahead of serving with ``llm.runner.warmup()``). Token ids in and out;
a text prompt needs a tokenizer object (anything with ``encode``/
``decode``) passed to the constructor.

The engine runs on the CUDA card unless the caller passes
``device="cpu"``; with no card it raises instead of falling back.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence as Seq, Union

import torch

from gllm_tpu_torch.config import EngineConfig
from gllm_tpu_torch.memory_manager import make_memory_manager
from gllm_tpu_torch.models.config import ModelConfig
from gllm_tpu_torch.runner.runner import ModelRunner
from gllm_tpu_torch.sampling_params import SamplingParams
from gllm_tpu_torch.scheduler import Scheduler, SeqOutput
from gllm_tpu_torch.sequence import Sequence


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
        model_cfg: ModelConfig,
        config: Optional[EngineConfig] = None,
        params=None,
        tokenizer=None,
        device=None,
    ):
        """``model_cfg`` is required: no checkpoint config is read yet.
        ``params`` (this port's layout, see models/convert.py) defaults to
        dummy weights drawn from ``config.seed``."""
        config = config or EngineConfig()
        config.validate()
        self.config = config
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.runner = ModelRunner(config, model_cfg, self.device,
                                  params=params)
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
        self.eos_token_ids = frozenset(model_cfg.eos_token_ids)
        if not self.eos_token_ids and tokenizer is not None \
                and getattr(tokenizer, "eos_token_id", None) is not None:
            self.eos_token_ids = frozenset([tokenizer.eos_token_id])
        self._next_seq_id = 0

    @property
    def step_counts(self) -> dict:
        """Steps by kind: "decode" when every row has one new token, else
        "mixed". Which kernels ran is counted by the kernel wrappers."""
        return self.runner.step_counts

    # ---- intake -----------------------------------------------------------

    def _allocate_seq(self, token_ids: List[int],
                      sp: SamplingParams) -> Sequence:
        sp.validate()
        seq = Sequence(self._next_seq_id, token_ids, sp)
        self._next_seq_id += 1
        return seq

    def encode(self, prompt: str) -> List[int]:
        if self.tokenizer is None:
            raise ValueError("no tokenizer available; pass prompt_token_ids")
        return list(self.tokenizer.encode(prompt))

    def add_seq(self, seq: Sequence) -> None:
        self.scheduler.add_seq(seq)

    @property
    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished

    # ---- main loop --------------------------------------------------------

    def step(self) -> List[SeqOutput]:
        """One engine iteration: schedule, run, commit."""
        batch = self.scheduler.schedule_once()
        if batch is None:
            return []
        tokens = self.runner.step(batch)
        return self.scheduler.process_output(batch, tokens.tolist(),
                                             self.eos_token_ids)

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
            self.step()
        return [self._finalize(s) for s in seqs]

    # ---- output -----------------------------------------------------------

    def _finalize(self, seq: Sequence) -> RequestOutput:
        text = ""
        if self.tokenizer is not None:
            text = self.tokenizer.decode(seq.output_token_ids)
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
