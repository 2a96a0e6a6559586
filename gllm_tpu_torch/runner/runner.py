"""ModelRunner: owns the parameters, the KV cache and the step (counterpart
of ``gllm_tpu/runner/runner.py``: ``ModelRunner.__init__:273``,
``reset_page_scales:136``, ``_kv_bytes_per_page:570``,
``determine_num_pages:614``, ``_build_step_fn:650``,
``_apply_scale_resets:923``, ``step:1845``; the hybrid slot pool
``:414-433``, ``_ssm_pool_bytes:603``).

One synchronous step: build the batch on the host, copy it over in one
transfer, run forward → logits → sample, and fetch the sampled tokens.
The model family (dense, DeepSeek's MLA + MoE, or the hybrid GDN family)
comes from ``models/registry.py``. A hybrid model keeps its GDN state in
slot pools of ``1 + max_num_seqs`` slots (slot 0: the padding dummy);
the slots freed since the last step ride the step's one upload and are
zeroed (``index_fill_``) before its forward.
PyTorch runs eagerly, so there is no compile cache to warm; the KV cache is
updated in place where JAX donated its buffers. An int8 cache first zeroes
the scales of the pages minted for the step (their ids ride the step's one
upload), so a recycled page quantizes like a fresh one.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from gllm_tpu_torch.config import EngineConfig
from gllm_tpu_torch.models import hybrid
from gllm_tpu_torch.models.config import ModelConfig
from gllm_tpu_torch.models.registry import get_model_def
from gllm_tpu_torch.ops.cuda.common import check_model_shapes
from gllm_tpu_torch.ops.sampling import sample
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging
from gllm_tpu_torch.scheduler import ScheduledBatch
from gllm_tpu_torch.utils import cdiv

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}

# Device memory kept free for a step's activations at the largest batch
# shape (the JAX runner keeps the same 512 MB).
ACTIVATION_HEADROOM = 512 * 1024 * 1024


class ModelRunner:
    def __init__(self, config: EngineConfig, model_cfg: ModelConfig,
                 device: torch.device, params=None):
        config.validate(model_cfg)
        self.config = config
        self.model_cfg = model_cfg
        self.model = get_model_def(model_cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_model_shapes(model_cfg, config.cache.kv_cache_dtype,
                               config.unified_step)
        self.dtype = DTYPES[config.dtype]
        kd = config.cache.kv_cache_dtype
        self.kv_dtype = self.dtype if kd == "auto" else DTYPES[kd]
        self.kv_quant = self.kv_dtype == torch.int8
        # attention kernels (ops/attention.py): the unified kernel for every
        # step, or the legacy decode / ragged pair
        self.attn_impl = "unified" if config.unified_step else "legacy"
        # the engine's memory manager, whose minted pages an int8 cache
        # resets (set by the engine)
        self.memory_manager = None
        if params is not None:
            self.params = params
        elif config.load_format == "dummy" or not config.model:
            self.params = self.model.init_params(model_cfg, config.seed,
                                                 self.dtype, self.device)
        else:
            raise NotImplementedError(
                "gllm_tpu_torch loads no checkpoint yet: use "
                "load_format='dummy' or pass params")
        self.cos_sin = self.model.make_rope_table(model_cfg, self.device)
        self.hybrid = self.model.family == "hybrid"
        # hybrid: one GDN state slot per running sequence, and slot 0
        self.ssm_working_slots = config.max_num_seqs if self.hybrid else 0
        self.builder = BatchBuilder(config, config.cache.page_size,
                                    use_ssm=self.hybrid)
        self.staging = HostStaging(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        # steps by batch: "decode" when every row has one new token, else
        # "mixed" (a prefill chunk or a mix). The legacy kernels split the
        # same way; the unified kernel serves both.
        self.step_counts = {"mixed": 0, "decode": 0}
        self.num_pages = (config.cache.num_pages
                          or self.determine_num_pages())
        slots = ({"num_slots": 1 + self.ssm_working_slots} if self.hybrid
                 else {})
        self.kv = self.model.init_kv_cache(model_cfg, self.num_pages,
                                           config.cache.page_size,
                                           self.kv_dtype, self.device,
                                           **slots)
        logger.info("KV cache: %d pages × %d tokens (%s) on %s",
                    self.num_pages, config.cache.page_size, self.kv_dtype,
                    self.device)

    def kv_bytes_per_page(self) -> int:
        """Device bytes of one page across the layers: K and V (and an int8
        page's scale rows), or one MLA latent row per token and layer, at
        the cache dtype's element size (one byte for int8 and fp8)."""
        return self.model.kv_bytes_per_page(
            self.model_cfg, self.config.cache.page_size, self.kv_dtype)

    def activation_headroom(self) -> int:
        """Device bytes kept free for a step's activations: 512 MB, and for
        a hybrid model also the GDN layer's largest transient at the
        largest batch shape the config can schedule."""
        if not self.hybrid:
            return ACTIVATION_HEADROOM
        rows = self.builder.max_seqs
        cells = hybrid.max_gdn_cells(
            rows, min(self.config.scheduler.max_prefill_tokens,
                      self.config.max_model_len))
        return ACTIVATION_HEADROOM + hybrid.gdn_transient_bytes(
            self.model_cfg, cells, rows)

    def determine_num_pages(self) -> int:
        """Size the KV pool from the device's free memory after the weights
        are resident: ``memory_util`` of the card's total, less what is in
        use, the activation headroom and, for a hybrid model, the GDN slot
        pools."""
        if self.device.type != "cuda":
            return 2048               # CPU: modest default
        # blocks the caching allocator holds unused (the weight init's
        # temporaries) count as free
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(self.device)
        budget = (total * self.config.cache.memory_util - (total - free)
                  - self.activation_headroom())
        if self.hybrid:
            budget -= hybrid.ssm_pool_bytes(self.model_cfg,
                                            1 + self.ssm_working_slots)
        num = int(budget // self.kv_bytes_per_page())
        min_pages = cdiv(self.config.max_model_len,
                         self.config.cache.page_size) + 2
        if num < min_pages:
            raise RuntimeError(
                f"not enough device memory for KV cache: {num} pages "
                f"(need >= {min_pages})")
        return num

    def prepare(self, sched_batch: ScheduledBatch):
        """(device StepBatch, max_q_len) for a scheduled batch: built on the
        host, with the int8 cache's pending scale resets, in one upload."""
        host_batch, max_q = self.builder.build(sched_batch)
        if self.kv_quant and self.memory_manager is not None:
            host_batch = host_batch._replace(
                scale_resets=self.memory_manager.drain_scale_resets())
        if self.hybrid and self.memory_manager is not None:
            host_batch = host_batch._replace(
                ssm_zero=self.memory_manager.drain_ssm_zero())
        return self.staging.upload(host_batch), max_q

    @torch.inference_mode()
    def forward_logits(self, batch, max_q: int) -> torch.Tensor:
        """forward + compute_logits for a device StepBatch → [S, V] f32."""
        if batch.scale_resets is not None:
            # zero the minted pages' scales in every layer: a zero scale
            # makes the first write zero-fill the stale payload and start
            # a new running absmax
            pages = batch.scale_resets.long()
            self.kv.k_scale.index_fill_(1, pages, 0.0)
            self.kv.v_scale.index_fill_(1, pages, 0.0)
        if batch.ssm_zero is not None:
            # freed GDN slots start their next tenant from a zero state
            slots = batch.ssm_zero.long()
            self.kv.conv.index_fill_(1, slots, 0.0)
            self.kv.rec.index_fill_(1, slots, 0.0)
        hidden, residual = self.model.forward(self.params, self.kv, batch,
                                              self.model_cfg,
                                              cos_sin=self.cos_sin,
                                              max_q_len=max_q,
                                              impl=self.attn_impl)
        return self.model.compute_logits(self.params, hidden, residual,
                                         batch, self.model_cfg)

    @torch.inference_mode()
    def step(self, sched_batch: ScheduledBatch) -> np.ndarray:
        """Run one step; returns the sampled token of each batch item."""
        batch, max_q = self.prepare(sched_batch)
        decode = all(it.num_new_tokens == 1 for it in sched_batch.items)
        self.step_counts["decode" if decode else "mixed"] += 1
        logits = self.forward_logits(batch, max_q)
        all_greedy = all(it.seq.sampling_params.temperature == 0.0
                         for it in sched_batch.items)
        tokens = sample(logits, batch.sampling, self.generator,
                        all_greedy=all_greedy)
        return tokens[:sched_batch.num_seqs].cpu().numpy()
