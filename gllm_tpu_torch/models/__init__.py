"""Model definitions: the dense decoder family, the Mixtral / Qwen-MoE
family, DeepSeek V2/V3 (MLA + DeepSeekMoE) and the hybrid Gated-DeltaNet
family (Qwen3-Next / Qwen3.5), picked by architecture in `registry.py`;
checkpoints read by `loader.py`."""

from gllm_tpu_torch.models.config import ModelConfig, from_hf_config

__all__ = ["ModelConfig", "from_hf_config"]
