"""gllm_tpu_torch — the PyTorch/CUDA port of gllm_tpu for NVIDIA Hopper.

A package of its own beside the JAX package: it imports torch and numpy,
never jax and nothing of ``gllm_tpu``. Module names mirror the JAX
package's, so each module's counterpart is easy to find. The paged
attention kernels are hand-written CUDA C++ for sm_90a under ``csrc/``,
built with nvcc at first use (``ops/cuda/build.py``).
"""

from gllm_tpu_torch.config import (CacheConfig, EngineConfig,
                                   ParallelConfig, SchedulerConfig)
from gllm_tpu_torch.engine.llm import LLM, RequestOutput
from gllm_tpu_torch.models.config import ModelConfig, from_hf_config
from gllm_tpu_torch.sampling_params import SamplingParams

__all__ = ["LLM", "RequestOutput", "EngineConfig", "SchedulerConfig",
           "CacheConfig", "ParallelConfig", "ModelConfig", "from_hf_config",
           "SamplingParams"]
