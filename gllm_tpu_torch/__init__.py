"""gllm_tpu_torch — the PyTorch/CUDA port of gllm_tpu for NVIDIA Hopper.

A package of its own beside the JAX package: it imports torch and numpy,
never jax and nothing of ``gllm_tpu``. Module names mirror the JAX
package's, so each module's counterpart is easy to find. The paged
attention kernels are hand-written CUDA C++ for sm_90a under ``csrc/``,
built with nvcc at first use (``ops/cuda/build.py``). The serving front
end is ``ServingEngine`` (the engine on a thread of its own, with request
streams) under the OpenAI-compatible HTTP server
``python -m gllm_tpu_torch.entrypoints.api_server``.
"""

__version__ = "0.1.0"

from gllm_tpu_torch.config import (CacheConfig, EngineConfig,  # noqa: E402
                                   ParallelConfig, SchedulerConfig)
from gllm_tpu_torch.engine.llm import LLM, RequestOutput  # noqa: E402
from gllm_tpu_torch.engine.serving_engine import ServingEngine  # noqa: E402
from gllm_tpu_torch.models.config import (ModelConfig,  # noqa: E402
                                          from_hf_config)
from gllm_tpu_torch.sampling_params import SamplingParams  # noqa: E402

__all__ = ["LLM", "RequestOutput", "ServingEngine", "EngineConfig",
           "SchedulerConfig", "CacheConfig", "ParallelConfig", "ModelConfig",
           "from_hf_config", "SamplingParams", "__version__"]
