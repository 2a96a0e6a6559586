"""Carry parameters between the JAX package's pytree and this port.

Both sides keep weights as [in, out] and stack layers on a leading axis;
this port fuses q|k|v into ``qkv_proj`` (and their biases into
``qkv_bias``) and gate|up into ``gate_up_proj``. The JAX side is a dict of
numpy arrays (``jax.tree.map(np.asarray, params)``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gllm_tpu_torch.models.config import ModelConfig
from gllm_tpu_torch.models.dense import Params

# port name → the JAX names concatenated on the last axis, in order
_FUSED = {
    "qkv_proj": ("q_proj", "k_proj", "v_proj"),
    "qkv_bias": ("q_bias", "k_bias", "v_bias"),
    "gate_up_proj": ("gate_proj", "up_proj"),
}


def _tensor(x, dtype, device) -> torch.Tensor:
    # through a float32 copy: numpy has no native bfloat16, and arrays
    # taken from jax are read-only
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


def from_jax_params(np_params: Dict, dtype: torch.dtype = torch.float32,
                    device="cpu") -> Params:
    """JAX pytree (numpy leaves) → this port's parameter dict."""
    jl = np_params["layers"]
    layers = {}
    used = set()
    for name, parts in _FUSED.items():
        if parts[0] in jl:
            layers[name] = _tensor(np.concatenate(
                [np.asarray(jl[p], np.float32) for p in parts], axis=-1),
                dtype, device)
            used.update(parts)
    for name, x in jl.items():
        if name not in used:
            layers[name] = _tensor(x, dtype, device)
    params: Params = {"layers": layers}
    for name, x in np_params.items():
        if name != "layers":
            params[name] = _tensor(x, dtype, device)
    return params


def to_jax_params(params: Params, cfg: ModelConfig) -> Dict:
    """This port's parameter dict → the JAX pytree layout (numpy f32)."""
    D = cfg.head_dim
    widths = {
        "qkv_proj": (cfg.num_heads * D, cfg.num_kv_heads * D,
                     cfg.num_kv_heads * D),
        "gate_up_proj": (cfg.intermediate_size, cfg.intermediate_size),
    }
    widths["qkv_bias"] = widths["qkv_proj"]

    def np32(t):
        return t.detach().float().cpu().numpy()

    layers = {}
    for name, t in params["layers"].items():
        if name in _FUSED:
            for part, x in zip(_FUSED[name],
                               torch.split(t, widths[name], dim=-1)):
                layers[part] = np32(x)
        else:
            layers[name] = np32(t)
    out = {"layers": layers}
    for name, t in params.items():
        if name != "layers":
            out[name] = np32(t)
    return out
