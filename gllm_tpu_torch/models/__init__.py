"""Model definitions (dense decoder family)."""

from gllm_tpu_torch.models.config import ModelConfig, from_hf_config

__all__ = ["ModelConfig", "from_hf_config"]
