"""Engine configuration (counterpart of ``gllm_tpu/config.py:18-140``).

The dataclasses keep the JAX package's field names, so a configuration
reads the same in both packages. ``EngineConfig.validate`` raises on every
option this port does not implement yet; it never accepts an option and
then ignores it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from gllm_tpu_torch.utils import cdiv


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
    kv_cache_dtype: str = "auto"          # auto | bfloat16 | float16 | float32
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


# Options of the JAX engine that this port does not implement yet, with
# the value that means "off". validate() raises when one is set.
_UNPORTED = {
    "overlap_scheduling": False,
    "pipelined_loop": False,
    "unified_step": False,
    "decode_slot_batching": False,
    "ondevice_finish": False,
    "multi_step_decode": 1,
    "decode_chain_len": None,
    "spec_decode": None,
    "spec_fused": False,
    "quantization": None,
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
    overlap_scheduling: bool = False
    pipelined_loop: bool = False
    unified_step: bool = False
    decode_slot_batching: bool = False
    ondevice_finish: bool = False
    multi_step_decode: int = 1
    decode_chain_len: Optional[int] = None
    spec_decode: Optional[str] = None
    spec_fused: bool = False
    quantization: Optional[str] = None
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    @property
    def max_pages_per_seq(self) -> int:
        return cdiv(self.max_model_len, self.cache.page_size)

    def validate(self) -> None:
        unported = [k for k, off in _UNPORTED.items()
                    if getattr(self, k) != off]
        p = self.parallel
        if p.pp != 1 or p.tp != 1 or p.dp != 1 or p.sp != 1 or p.enable_ep:
            unported.append("pp/tp/dp/sp > 1 (one device only)")
        c = self.cache
        if c.kv_cache_dtype in ("int8", "fp8"):
            unported.append(f"kv_cache_dtype={c.kv_cache_dtype!r}")
        elif c.kv_cache_dtype not in ("auto", self.dtype):
            # the attention kernels take q and the caches in one dtype
            unported.append(f"kv_cache_dtype={c.kv_cache_dtype!r} with "
                            f"dtype={self.dtype!r}")
        if c.kv_host_pool_gb or c.kv_disk_path or c.prefix_peers:
            unported.append("kvswap/kvstore tiers")
        if unported:
            raise NotImplementedError(
                "not supported by gllm_tpu_torch yet: "
                + ", ".join(unported))
        if self.dtype not in ("bfloat16", "float16", "float32"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if c.kv_cache_dtype not in ("auto", "bfloat16", "float16",
                                    "float32"):
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
