"""Engine configuration (counterpart of ``gllm_tpu/config.py:18-140``).

The dataclasses keep the JAX package's field names, so a configuration
reads the same in both packages. ``EngineConfig.validate`` raises on every
option this port does not implement yet; it never accepts an option and
then ignores it, except where the JAX package's ``validate`` does the same
(``enforce_eager`` clears overlap scheduling and the options built on it,
with a warning; ``ondevice_finish`` or ``decode_chain_len`` without
overlap scheduling forms no block, with a warning, and
``decode_slot_batching`` without it does nothing; ``chain_under_prefill``
under ``unified_step`` is zeroed, with a warning; and ``unified_step`` on
a hybrid model is taken and left inert, with the engine's warning).
``spec_fused`` without overlap scheduling lifts it, as there.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import TYPE_CHECKING, Optional

from gllm_tpu_torch.utils import cdiv

if TYPE_CHECKING:
    from gllm_tpu_torch.models.config import ModelConfig


@dataclasses.dataclass
class SchedulerConfig:
    """Scheduling policy knobs."""

    schedule_method: str = "chunked_prefill"  # chunked_prefill | token_throttling | split_pd
    max_decode_seqs: int = 256            # decode seqs per batch
    max_prefill_tokens: int = 2048        # prefill token budget per batch
    min_prefill_tokens: int = 128         # throttling lower clamp
    iter_smooth: int = 16                 # waiting-token smoothing divisor
    init_new_token_ratio: float = 0.7     # adaptive KV admission ramp start
    min_new_token_ratio: float = 0.1      # ramp floor
    new_token_ratio_decay_steps: int = 600
    # KV free-ratio reserve of token throttling's prefill budget ramp
    throttle_reserve: float = 0.2


@dataclasses.dataclass
class CacheConfig:
    """Paged KV cache geometry."""

    page_size: int = 16
    memory_util: float = 0.9              # fraction of device memory for KV
    num_pages: Optional[int] = None       # explicit override (tests)
    # auto | bfloat16 | float16 | float32 | int8 (per-page, per-kv-head
    # float32 scales; any model dtype) | fp8 (e4m3, no scales; any model
    # dtype, every model family)
    kv_cache_dtype: str = "auto"
    enable_prefix_caching: bool = False
    # Host-RAM / disk / peer KV tiers: not ported (validate raises).
    kv_host_pool_gb: float = 0.0
    kv_disk_path: Optional[str] = None
    prefix_peers: Optional[str] = None


@dataclasses.dataclass
class ParallelConfig:
    """Device-parallel geometry; this port runs one device (validate
    raises on anything else)."""

    pp: int = 1
    tp: int = 1
    dp: int = 1
    sp: int = 1
    enable_ep: bool = False


logger = logging.getLogger(__name__)

# Options of the JAX engine that this port does not implement yet, with
# the value that means "off" and the ROADMAP item that ports it.
# validate() raises when one is set.
_UNPORTED = {
    # weight quantization (gllm_tpu/ops/quant.py)
    "quantization": (None, "A 10"),
    # the supervised in-process rebuild and its hard-stall trigger
    "engine_recovery": (False, "A 14"),
    "watchdog_hard_stall_s": (0.0, "A 14"),
}


@dataclasses.dataclass
class EngineConfig:
    model: str = ""
    tokenizer: Optional[str] = None
    dtype: str = "bfloat16"               # bfloat16 | float16 | float32
    seed: int = 0
    max_model_len: int = 4096
    max_num_seqs: int = 256
    load_format: str = "auto"             # auto | dummy
    # fetch a hub id that is not a local directory (off: loads are
    # local-path-only, models/loader.py resolve_model_path)
    allow_hub_download: bool = False
    # chain each pure-decode step off the previous step's sampled tokens
    # on the device, dispatched before those tokens reach the host
    # (engine/llm.py; docs/overlap_scheduling.md of the JAX package)
    overlap_scheduling: bool = False
    # entries dispatched and not yet collected under overlap_scheduling
    overlap_depth: int = 2
    # with prefill work waiting, chain up to this many decode steps before
    # yielding one pass to the sync schedule (0: yield at once)
    chain_under_prefill: int = 0
    # across a chain break, re-form the next pure-decode batch off the
    # promised token counts, reconciled when the tokens land (implies
    # overlap_scheduling)
    pipelined_loop: bool = False
    # every paged step through the one unified attention kernel (K1u; K1um
    # over an MLA latent cache); under overlap_scheduling a chain absorbs
    # waiting prefill work through mixed re-forms (it lifts pipelined_loop
    # and retires chain_under_prefill). Inert on a hybrid model, as in
    # the JAX package: legacy kernels, signatures and step kinds there
    unified_step: bool = False
    # persistent-slot chain membership under overlap scheduling: a finished
    # row stays in its chain as a dead hole, a decode-ready sequence joins
    # a hole at a chain boundary, and the batch compacts only below its
    # power-of-two sequence bucket (no effect without overlap scheduling)
    decode_slot_batching: bool = False
    # under overlap scheduling, chain up to this many pure-decode steps
    # into one block: one dispatch (one CUDA graph replay), one upload and
    # one token fetch for K steps (runner ``step_multi``); 1: single steps
    multi_step_decode: int = 1
    # the chain length by its other name; wins over multi_step_decode
    decode_chain_len: Optional[int] = None
    # a row of a block whose sampled token is in its EOS / stop set
    # freezes inside the block, and the block stops once every row has
    # finished; under overlap it lifts an unset chain length to 16
    ondevice_finish: bool = False
    # prompt-lookup speculative decoding (``"ngram"``): up to ``spec_k``
    # drafts a decode row, the continuation of the most recent earlier
    # match of its last ``spec_ngram`` tokens, verified in one step as
    # verify rows after its committed token (greedy rows by argmax,
    # sampled rows by rejection sampling); host-driven, it owns decode
    # dispatch under overlap scheduling (docs/speculative_decoding.md of
    # the JAX package)
    spec_decode: Optional[str] = None
    spec_k: int = 4
    spec_ngram: int = 2
    # drafting, verification and acceptance inside the fused block (one
    # CUDA graph of up to multi_step_decode draft+verify sub-steps, which
    # emits up to spec_k + 1 tokens a row a sub-step); needs spec_decode
    # "ngram" and lifts overlap_scheduling
    spec_fused: bool = False
    quantization: Optional[str] = None
    # False (the JAX package's default): every step on CUDA replays a
    # CUDA graph captured per shape signature (runner/graphs.py), but for
    # a step with penalties, logit_bias or logprobs and a hybrid model's
    # mixed step; True runs every step op by op, as the reference's
    # flag of that name turns CUDA-graph capture off, and, as in the JAX
    # package, clears overlap scheduling and every option built on it
    enforce_eager: bool = False
    # request-scoped span trees (obs/spans.py, GET /trace); the step-trace
    # ring and its phase, device, MFU and HBM fields stay on either way.
    # Host bookkeeping only: token streams are the same with it off
    # (``--no-tracing``)
    tracing: bool = True
    # ---- request lifecycle (engine/serving_engine.py) ----
    # admission control: the serving engine's intake queue and the
    # requests with an open stream; a submit over a limit is refused (HTTP
    # 429 with Retry-After) instead of queueing without bound. 0: no limit
    max_queued_requests: int = 0
    max_resident_requests: int = 0
    # default wall-clock budget of a request from submit, waiting or
    # generating; past it the request ends with finish reason "deadline".
    # A request's SamplingParams.deadline_s overrides it. 0: none
    request_deadline_s: float = 0.0
    # consecutive failed engine steps before the serving engine latches
    # unhealthy (readiness 503, admission closed; liveness stays up); each
    # failure quarantines only the sequences of the failed step
    max_step_failures: int = 3
    # readiness goes 503 while the engine thread's heartbeat is older than
    # this (a hung device call blocks the loop in collect); it must exceed
    # the longest legitimate blocking call. 0: no watchdog
    watchdog_stall_s: float = 0.0
    # shutdown(drain=True): how long in-flight requests may finish before
    # they get terminal chunks
    drain_timeout_s: float = 5.0
    # not ported: supervised in-process recovery (validate raises)
    engine_recovery: bool = False
    watchdog_hard_stall_s: float = 0.0
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    @property
    def max_pages_per_seq(self) -> int:
        return cdiv(self.max_model_len, self.cache.page_size)

    def validate(self, model_cfg: Optional["ModelConfig"] = None) -> None:
        """Raise on options this port does not implement; with
        ``model_cfg``, also on a model it does not serve and on options the
        model's family does not take (an MLA latent cache takes no int8
        cache; a hybrid model neither, nor prefix caching; it takes the
        unified step and leaves it inert). First it normalizes the options
        as the JAX package's ``validate`` does
        (``gllm_tpu/config.py:353-397``): ``enforce_eager`` clears overlap
        scheduling and the options built on it, ``pipelined_loop`` implies
        ``overlap_scheduling``, ``unified_step`` under overlap lifts
        ``pipelined_loop`` and zeroes ``chain_under_prefill`` (a chain
        absorbs prefill work instead of yielding to it), and the chain
        length resolves as there (``:441-462``): ``decode_chain_len`` wins
        over ``multi_step_decode``, and ``ondevice_finish`` under overlap
        lifts an unset one to 16. ``spec_fused`` needs ``spec_decode``
        "ngram", lifts ``overlap_scheduling`` and an unset chain length
        to 8 (``:409-450``); ``spec_k`` and ``spec_ngram`` are at least 1
        (``:495-507``). Speculation on a hybrid model raises: it needs
        the SSM snapshots (ROADMAP A 9)."""
        if model_cfg is not None:
            model_cfg.check_supported()
        if self.enforce_eager:
            if self.overlap_scheduling or self.multi_step_decode > 1:
                logger.warning(
                    "enforce_eager overrides overlap_scheduling/"
                    "multi_step_decode (were %s/%d): plain per-step "
                    "execution", self.overlap_scheduling,
                    self.multi_step_decode)
            self.overlap_scheduling = False
            self.multi_step_decode = 1
            self.decode_chain_len = None
            self.ondevice_finish = False
            self.decode_slot_batching = False
            self.chain_under_prefill = 0
            self.pipelined_loop = False
            self.spec_fused = False
        if self.pipelined_loop:
            self.overlap_scheduling = True
        if self.unified_step:
            if self.overlap_scheduling:
                # absorbing a prefill chunk into a running chain is a
                # mixed re-form: the pipelined loop's machinery
                self.pipelined_loop = True
            if self.chain_under_prefill:
                logger.warning(
                    "chain_under_prefill is deprecated and ignored under "
                    "unified_step: mixed re-formed batches absorb prefill "
                    "chunks, chains never yield")
                self.chain_under_prefill = 0
        if self.chain_under_prefill < 0:
            raise ValueError("chain_under_prefill must be >= 0")
        if self.overlap_depth < 1:
            raise ValueError("overlap_depth must be >= 1")
        if self.spec_fused:
            if self.spec_decode != "ngram":
                raise ValueError("spec_fused (--spec-fused) requires "
                                 "spec_decode='ngram'")
            # the fused draft+verify block is a chained dispatch
            self.overlap_scheduling = True
        if self.decode_chain_len is not None:
            if self.decode_chain_len < 1:
                raise ValueError("decode_chain_len must be >= 1")
            self.multi_step_decode = self.decode_chain_len
        elif self.spec_fused and self.multi_step_decode == 1:
            # one block amortizes several verify rounds a dispatch
            self.multi_step_decode = 8
        elif (self.ondevice_finish and self.overlap_scheduling
                and self.multi_step_decode == 1):
            self.multi_step_decode = 16
        if self.multi_step_decode < 1:
            raise ValueError("multi_step_decode must be >= 1")
        if self.spec_decode not in (None, "ngram"):
            raise ValueError(f"unknown spec_decode {self.spec_decode!r} "
                             "(choices: ngram)")
        if self.spec_decode is not None and (self.spec_k < 1
                                             or self.spec_ngram < 1):
            raise ValueError("spec_k and spec_ngram must be >= 1")
        if self.max_queued_requests < 0 or self.max_resident_requests < 0:
            raise ValueError("admission limits must be >= 0 (0 = off)")
        if self.request_deadline_s < 0 or self.watchdog_stall_s < 0 \
                or self.drain_timeout_s < 0:
            raise ValueError("robustness timeouts must be >= 0")
        if self.max_step_failures < 1:
            raise ValueError("max_step_failures must be >= 1")
        if not self.overlap_scheduling and not self.enforce_eager and (
                self.ondevice_finish or self.decode_chain_len is not None):
            logger.warning(
                "ondevice_finish/decode_chain_len have no effect without "
                "overlap_scheduling: fused decode chains never form")
        unported = [f"{k} (ROADMAP {item})"
                    for k, (off, item) in _UNPORTED.items()
                    if getattr(self, k) != off]
        p = self.parallel
        if p.pp != 1 or p.tp != 1 or p.dp != 1 or p.sp != 1 or p.enable_ep:
            unported.append("pp/tp/dp/sp > 1 (one device only)")
        c = self.cache
        if c.kv_cache_dtype not in ("auto", "int8", "fp8", self.dtype):
            # the attention kernels take q and a full-precision cache in
            # one dtype
            unported.append(f"kv_cache_dtype={c.kv_cache_dtype!r} with "
                            f"dtype={self.dtype!r}")
        if c.kv_host_pool_gb or c.kv_disk_path or c.prefix_peers:
            unported.append("kvswap/kvstore tiers")
        if (model_cfg is not None and model_cfg.use_mla
                and c.kv_cache_dtype == "int8"):
            # the JAX runner refuses it too (runner.py:544-548)
            unported.append("kv_cache_dtype='int8' with an MLA latent cache")
        if model_cfg is not None and model_cfg.use_hybrid:
            # hybrid GDN: the JAX runner refuses int8 (runner.py:549-552)
            # (unified_step stays inert, :297-303: the runner and the
            # engine resolve it); prefix caching needs the SSM snapshot
            # slots and the scheduler's chunk alignment, not ported yet
            if c.kv_cache_dtype == "int8":
                unported.append("kv_cache_dtype='int8' with a hybrid model")
            if c.enable_prefix_caching:
                unported.append("enable_prefix_caching with a hybrid model "
                                "(SSM snapshots)")
            if self.spec_decode is not None or self.spec_fused:
                # the recurrent state advances over rejected draft rows and
                # cannot rewind without the snapshot slots
                unported.append("spec_decode/spec_fused with a hybrid "
                                 "model (SSM snapshots, ROADMAP A 9)")
        if unported:
            raise NotImplementedError(
                "not supported by gllm_tpu_torch yet: "
                + ", ".join(unported))
        if self.dtype not in ("bfloat16", "float16", "float32"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if c.kv_cache_dtype not in ("auto", "bfloat16", "float16",
                                    "float32", "int8", "fp8"):
            raise ValueError(
                f"unknown kv_cache_dtype {c.kv_cache_dtype!r}")
        if self.load_format not in ("auto", "dummy"):
            raise ValueError(f"unknown load_format {self.load_format!r}")
        if c.page_size <= 0:
            raise ValueError("page_size must be positive")
        if self.scheduler.max_prefill_tokens < c.page_size:
            raise ValueError("max_prefill_tokens must cover at least one page")
        if self.scheduler.schedule_method not in (
            "chunked_prefill", "token_throttling", "split_pd",
        ):
            raise ValueError(
                f"unknown schedule_method {self.scheduler.schedule_method!r}")
