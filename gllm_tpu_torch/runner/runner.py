"""ModelRunner: owns the parameters, the KV cache and the step (counterpart
of ``gllm_tpu/runner/runner.py``: ``ModelRunner.__init__:273``,
``determine_num_pages:614``, ``_build_step_fn:650``, ``step:1845``).

One synchronous step: build the batch on the host, copy it over in one
transfer, run forward → logits → sample, and fetch the sampled tokens.
PyTorch runs eagerly, so there is no compile cache to warm; the KV cache is
updated in place where JAX donated its buffers.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from gllm_tpu_torch.config import EngineConfig
from gllm_tpu_torch.models import dense
from gllm_tpu_torch.models.config import ModelConfig
from gllm_tpu_torch.ops.sampling import sample
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging
from gllm_tpu_torch.scheduler import ScheduledBatch
from gllm_tpu_torch.utils import cdiv

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}

# Device memory kept free for a step's activations at the largest batch
# shape (the JAX runner keeps the same 512 MB).
ACTIVATION_HEADROOM = 512 * 1024 * 1024


class ModelRunner:
    def __init__(self, config: EngineConfig, model_cfg: ModelConfig,
                 device: torch.device, params=None):
        model_cfg.check_supported()
        self.config = config
        self.model_cfg = model_cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[config.dtype]
        kd = config.cache.kv_cache_dtype
        self.kv_dtype = self.dtype if kd == "auto" else DTYPES[kd]
        if params is not None:
            self.params = params
        elif config.load_format == "dummy" or not config.model:
            self.params = dense.init_params(model_cfg, config.seed,
                                            self.dtype, self.device)
        else:
            raise NotImplementedError(
                "gllm_tpu_torch loads no checkpoint yet: use "
                "load_format='dummy' or pass params")
        self.cos_sin = dense.make_rope_table(model_cfg, self.device)
        self.builder = BatchBuilder(config, config.cache.page_size)
        self.staging = HostStaging(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        # steps by the attention kernel they dispatch to: "decode" when
        # max_q_len == 1, else "mixed" (a prefill chunk or a mix)
        self.step_counts = {"mixed": 0, "decode": 0}
        self.num_pages = (config.cache.num_pages
                          or self.determine_num_pages())
        self.kv = dense.init_kv_cache(model_cfg, self.num_pages,
                                      config.cache.page_size, self.kv_dtype,
                                      self.device)
        logger.info("KV cache: %d pages × %d tokens (%s) on %s",
                    self.num_pages, config.cache.page_size, self.kv_dtype,
                    self.device)

    def kv_bytes_per_page(self) -> int:
        cfg, page = self.model_cfg, self.config.cache.page_size
        itemsize = torch.empty(0, dtype=self.kv_dtype).element_size()
        return (2 * cfg.num_layers * page * cfg.num_kv_heads * cfg.head_dim
                * itemsize)

    def determine_num_pages(self) -> int:
        """Size the KV pool from the device's free memory after the weights
        are resident: ``memory_util`` of the card's total, less what is in
        use and the activation headroom."""
        if self.device.type != "cuda":
            return 2048               # CPU: modest default
        free, total = torch.cuda.mem_get_info(self.device)
        budget = (total * self.config.cache.memory_util - (total - free)
                  - ACTIVATION_HEADROOM)
        num = int(budget // self.kv_bytes_per_page())
        min_pages = cdiv(self.config.max_model_len,
                         self.config.cache.page_size) + 2
        if num < min_pages:
            raise RuntimeError(
                f"not enough device memory for KV cache: {num} pages "
                f"(need >= {min_pages})")
        return num

    @torch.inference_mode()
    def forward_logits(self, batch, max_q: int) -> torch.Tensor:
        """forward + compute_logits for a device StepBatch → [S, V] f32."""
        hidden, residual = dense.forward(self.params, self.kv, batch,
                                         self.model_cfg,
                                         cos_sin=self.cos_sin,
                                         max_q_len=max_q)
        return dense.compute_logits(self.params, hidden, residual, batch,
                                    self.model_cfg)

    @torch.inference_mode()
    def step(self, sched_batch: ScheduledBatch) -> np.ndarray:
        """Run one step; returns the sampled token of each batch item."""
        host_batch, max_q = self.builder.build(sched_batch)
        self.step_counts["decode" if max_q == 1 else "mixed"] += 1
        batch = self.staging.upload(host_batch)
        logits = self.forward_logits(batch, max_q)
        all_greedy = all(it.seq.sampling_params.temperature == 0.0
                         for it in sched_batch.items)
        tokens = sample(logits, batch.sampling, self.generator,
                        all_greedy=all_greedy)
        return tokens[:sched_batch.num_seqs].cpu().numpy()
