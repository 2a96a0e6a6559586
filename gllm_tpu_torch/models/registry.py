"""Model families by architecture (counterpart of
``gllm_tpu/models/registry.py:98`` ``get_model_def`` and
``registry_moe.py``, trimmed to the four families this port serves: the
dense GQA decoder, the Mixtral / Qwen2-MoE / Qwen3-MoE family, DeepSeek's
MLA + DeepSeekMoE and the hybrid Gated-DeltaNet family, Qwen3-Next /
Qwen3.5, ``:124-136,144-148,166-172``)."""

from __future__ import annotations

from typing import Callable, NamedTuple

from gllm_tpu_torch.models import deepseek, dense, hybrid, loader, moe
from gllm_tpu_torch.models.config import (DEEPSEEK_ARCHS, HYBRID_ARCHS,
                                          MOE_ARCHS, ModelConfig)


class ModelDef(NamedTuple):
    family: str
    init_params: Callable        # (cfg, seed, dtype, device) → params
    init_kv_cache: Callable      # (cfg, num_pages, page_size, dtype, device
                                 #  [, num_slots: hybrid's SSM slots])
    forward: Callable            # (params, kv, batch, cfg, *, cos_sin, ...)
    compute_logits: Callable     # (params, hidden, residual, batch, cfg)
    compute_full_logits: Callable  # (params, hidden, residual, cfg)
    make_rope_table: Callable    # (cfg, device) → [max_pos, rot_dim] f32
    kv_bytes_per_page: Callable  # (cfg, page_size, kv_dtype) → bytes
    load_params: Callable        # (model_dir, cfg, dtype, device)
                                 #  → (params, load numbers)


def _def(family, module, load_params) -> ModelDef:
    return ModelDef(family, module.init_params, module.init_kv_cache,
                    module.forward, module.compute_logits,
                    module.compute_full_logits,
                    module.make_rope_table, module.kv_bytes_per_page,
                    load_params)


def get_model_def(cfg: ModelConfig) -> ModelDef:
    if cfg.architecture in DEEPSEEK_ARCHS:
        return _def("deepseek", deepseek, loader.load_deepseek_params)
    if cfg.architecture in HYBRID_ARCHS:
        return _def("hybrid", hybrid, hybrid.load_params)
    if cfg.architecture in MOE_ARCHS:
        return _def("moe", moe, loader.load_moe_params)
    return _def("dense", dense, loader.load_dense_params)
