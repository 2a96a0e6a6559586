"""Model definitions: the dense decoder family and DeepSeek V2/V3 (MLA +
DeepSeekMoE), picked by architecture in `registry.py`."""

from gllm_tpu_torch.models.config import ModelConfig, from_hf_config

__all__ = ["ModelConfig", "from_hf_config"]
