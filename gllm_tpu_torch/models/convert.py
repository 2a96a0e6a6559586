"""Carry parameters between the JAX package's pytree and this port.

Both sides keep weights as [in, out] and stack layers on a leading axis,
in one group (``layers``, the dense family), two (``dense_layers`` and
``moe_layers``, DeepSeek) or three (``attn_layers``, ``gdn_layers`` and
``mlp_layers``, the hybrid family, whose q projection carries each head's
output gate beside it, 2 * head_dim a head). This port fuses q|k|v into
``qkv_proj`` (and
their biases into ``qkv_bias``) and every gate|up pair into one tensor:
``gate_up_proj``, the experts' ``w_gate_up`` and the shared experts'
``shared_gate_up_proj``. The JAX side is a dict of numpy arrays
(``jax.tree.map(np.asarray, params)``).
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
    "w_gate_up": ("w_gate", "w_up"),
    "shared_gate_up_proj": ("shared_gate_proj", "shared_up_proj"),
}
# kept in float32 whatever the model dtype (DeepSeek V3's routing bias,
# the GDN layers' decay parameters)
_FLOAT32 = ("e_bias", "dt_bias", "a_log")


def _tensor(name, x, dtype, device) -> torch.Tensor:
    # through a float32 copy: numpy has no native bfloat16, and arrays
    # taken from jax are read-only
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device,
        dtype=torch.float32 if name in _FLOAT32 else dtype)


def _layers_from_jax(jl: Dict, dtype, device) -> Dict[str, torch.Tensor]:
    layers = {}
    used = set()
    for name, parts in _FUSED.items():
        if all(p in jl for p in parts):
            layers[name] = _tensor(name, np.concatenate(
                [np.asarray(jl[p], np.float32) for p in parts], axis=-1),
                dtype, device)
            used.update(parts)
    for name, x in jl.items():
        if name not in used:
            layers[name] = _tensor(name, x, dtype, device)
    return layers


def from_jax_params(np_params: Dict, dtype: torch.dtype = torch.float32,
                    device="cpu") -> Params:
    """JAX pytree (numpy leaves) → this port's parameter dict."""
    return {name: (_layers_from_jax(x, dtype, device) if isinstance(x, dict)
                   else _tensor(name, x, dtype, device))
            for name, x in np_params.items()}


def to_jax_params(params: Params, cfg: ModelConfig) -> Dict:
    """This port's parameter dict → the JAX pytree layout (numpy f32)."""
    D = cfg.head_dim
    q_width = cfg.num_heads * D * (2 if cfg.use_hybrid else 1)
    qkv = (q_width, cfg.num_kv_heads * D, cfg.num_kv_heads * D)

    def np32(t):
        return t.detach().float().cpu().numpy()

    def split(name, t):
        # q|k|v by the heads' widths; every gate|up pair in two halves
        parts = (torch.split(t, qkv, dim=-1) if name.startswith("qkv")
                 else t.chunk(2, dim=-1))
        return {p: np32(x) for p, x in zip(_FUSED[name], parts)}

    out = {}
    for group, x in params.items():
        if not isinstance(x, dict):
            out[group] = np32(x)
            continue
        out[group] = {}
        for name, t in x.items():
            out[group].update(split(name, t) if name in _FUSED
                              else {name: np32(t)})
    return out
