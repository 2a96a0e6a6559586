"""Offline LLM engine (counterpart of ``gllm_tpu/engine/llm.py``:
``LLM.__init__:167``, ``add_seq:631``, ``step:680``,
``_commit_outputs:1024``, ``_dispatch_reform:1048``, ``generate:1894``,
``_finalize:2059``, ``abort:2091``; ``RequestOutput:147``).

The single-device loop: schedule a batch, dispatch its step, collect the
oldest entry in flight and commit its sampled tokens. Without
``EngineConfig.overlap_scheduling`` one entry is in flight at a time (the
sync loop). With it, up to ``overlap_depth`` are: the next pure-decode
step is chained off the newest entry's sampled tokens on the device
before they reach the host (``Scheduler.schedule_chain``), and under
``pipelined_loop`` a chain that cannot extend (a finish, a join) is
re-formed off the promised token counts instead of draining
(``Scheduler.schedule_reform``), with the promises reconciled as tokens
land (``engine/pipeline.py``). A hybrid model chains but never re-forms:
its GDN state is cumulative, so a discarded step could not be undone.
``docs/overlap_scheduling.md`` (Chain lifecycle, Ramp policy, Pipelined
loop, FutureMap, Invariants) is the specification; this is its
counterpart without multi-step chains, persistent slots, speculation,
the unified step, dp, disaggregation and fault points.
``EngineConfig.unified_step`` runs every step through the unified
attention kernel and ``CacheConfig(kv_cache_dtype="int8")`` keeps an int8
KV cache. Unless
``EngineConfig.enforce_eager``, each pure-decode step on the card replays
the CUDA graph of its shape signature (``runner/graphs.py``; warm them
ahead of serving with ``llm.runner.warmup()``). Token ids in and out;
a text prompt needs a tokenizer object (anything with ``encode``/
``decode``) passed to the constructor.

The engine runs on the CUDA card unless the caller passes
``device="cpu"``; with no card it raises instead of falling back.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence as Seq, Union

import torch

from gllm_tpu_torch.config import EngineConfig
from gllm_tpu_torch.engine.pipeline import FutureMap, InFlight
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
        # dispatched entries not yet collected, oldest first
        self._in_flight: collections.deque = collections.deque()
        # decode steps chained while prefill work waited (the
        # chain_under_prefill ramp), and whether this interruption's
        # "waiting" break is counted
        self._chained_under_pressure = 0
        self._yield_noted = False
        self.futures = FutureMap()
        # counters in place of the JAX package's observability: chain
        # breaks and loop stalls by reason, and dispatches by (step kind,
        # entries in flight once it was dispatched)
        self.chain_breaks: collections.Counter = collections.Counter()
        self.stalls: collections.Counter = collections.Counter()
        self.dispatches: collections.Counter = collections.Counter()

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
        ran_dry = False
        while len(self._in_flight) < depth:
            if overlap and self._in_flight:
                # an invalidated entry is never a tip: its tokens never
                # commit, so the rebuild roots from committed state
                last = self._in_flight[-1]
                tip = None if last.invalid else last.tip
                pressure = bool(self.scheduler.waiting)
                if not pressure:
                    self._chained_under_pressure = 0
                allow = tip is not None and (
                    not pressure or self._chained_under_pressure < cup)
                if tip is not None and not allow:
                    # ramp yield: this pass goes to the sync schedule,
                    # which admits the waiting work; one break counted per
                    # interruption of a decode chain
                    prev = tip[0]
                    if (not self._yield_noted
                            and prev.num_decode == prev.num_seqs):
                        self.chain_breaks["waiting"] += 1
                        self._yield_noted = True
                    self._chained_under_pressure = 0
                if allow:
                    prev_batch, prev_handle = tip
                    batch = self.scheduler.schedule_chain(prev_batch)
                    if batch is None:
                        self.chain_breaks[
                            self.scheduler.chain_break_reason] += 1
                        if cfg.pipelined_loop and self._dispatch_reform(
                                prev_batch, prev_handle, pressure):
                            continue
                        self._chained_under_pressure = 0
                        ran_dry = True
                        break
                    if pressure:
                        self._chained_under_pressure += 1
                    self._yield_noted = False
                    self._dispatch(InFlight(
                        batch, self.runner.step_async_chained(
                            batch, prev_handle), chained=True))
                    continue
            batch = self.scheduler.schedule_once()
            if batch is None:
                if (cfg.pipelined_loop and self._in_flight
                        and self.scheduler.has_unfinished):
                    # work left that only committed tokens can schedule
                    self.stalls["readback"] += 1
                ran_dry = True
                break
            entry = InFlight(batch, self.runner.step_async(batch),
                             roots=batch.num_decode == batch.num_seqs)
            self._dispatch(entry)
            if entry.roots:
                self._yield_noted = False
        if cfg.pipelined_loop and not ran_dry \
                and len(self._in_flight) >= depth:
            self.stalls["depth"] += 1
        if not self._in_flight:
            return []
        entry = self._in_flight.popleft()
        if entry.invalid:
            # its tokens never commit and nothing waits for the device:
            # the sync path schedules the same positions again
            self.scheduler.discard_batch(entry.batch)
            return []
        tokens = self.runner.collect(entry.handle)
        outs = self.scheduler.process_output(entry.batch, tokens.tolist(),
                                             self.eos_token_ids)
        return self._commit_outputs(outs)

    def _dispatch(self, entry: InFlight) -> None:
        self._in_flight.append(entry)
        kind = ("decode" if all(it.num_new_tokens == 1
                                for it in entry.batch.items) else "mixed")
        self.dispatches[kind, len(self._in_flight)] += 1

    def _commit_outputs(self, outs: List[SeqOutput]) -> List[SeqOutput]:
        """A finish that commits for a sequence some later entry promised
        alive invalidates that entry and the entries chained off it."""
        if self.config.pipelined_loop and self._in_flight:
            finished = frozenset(o.seq.seq_id for o in outs
                                 if o.finish_reason is not None)
            if self.futures.reconcile(self._in_flight, finished):
                self.stalls["rebuild"] += 1
        return outs

    def _dispatch_reform(self, prev_batch, prev_handle,
                         pressure: bool) -> bool:
        """Re-form the next pure-decode batch off ``prev_batch``'s promised
        token counts and dispatch it chained off ``prev_handle``; False
        (a stall counted) when it needs host-committed state."""
        if self.runner.hybrid:
            # GDN state is cumulative: a discarded step would leave a
            # slot advanced by a token that never committed, and the
            # rebuild would advance it again. Hybrid models keep the
            # drain-and-sync edge.
            self.stalls["readback"] += 1
            return False
        batch = self.scheduler.schedule_reform(prev_batch)
        if batch is None:
            reason = self.scheduler.reform_fail_reason
            self.stalls[reason if reason in ("pages", "pp_budget")
                        else "readback"] += 1
            return False
        self._dispatch(InFlight(
            batch, self.runner.step_async_chained(batch, prev_handle),
            chained=True, promises=FutureMap.promised_ids(batch)))
        self._yield_noted = False
        if pressure:
            self._chained_under_pressure += 1
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
