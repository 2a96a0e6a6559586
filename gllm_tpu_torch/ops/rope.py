"""Rotary position embeddings (counterpart of ``gllm_tpu/ops/rope.py:21-153``).

The cos/sin table is computed once per model ([max_pos, rot_dim], float32,
cos half then sin half) and gathered by token position each step.
Frequency variants: default, linear, llama3 and YaRN.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch


def _base_inv_freq(rot_dim: int, theta: float) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32) / rot_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)


def _llama3_scale_inv_freq(inv_freq: torch.Tensor,
                           scaling: Dict[str, Any]) -> torch.Tensor:
    """Llama-3.x rope scaling: three wavelength bands — scaled fully, kept,
    or smoothly interpolated."""
    factor = scaling.get("factor", 8.0)
    low_factor = scaling.get("low_freq_factor", 1.0)
    high_factor = scaling.get("high_freq_factor", 4.0)
    orig_max = scaling.get("original_max_position_embeddings", 8192)

    low_wavelen = orig_max / low_factor
    high_wavelen = orig_max / high_factor
    wavelen = 2 * math.pi / inv_freq
    smooth = ((orig_max / wavelen - low_factor)
              / (high_factor - low_factor))
    return torch.where(
        wavelen > low_wavelen, inv_freq / factor,
        torch.where(wavelen < high_wavelen, inv_freq,
                    (1 - smooth) * inv_freq / factor + smooth * inv_freq))


def _yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_inv_freq(rot_dim: int, theta: float,
                   s: Dict[str, Any]) -> Tuple[torch.Tensor, float]:
    """YaRN NTK-by-parts frequency blend. Returns (inv_freq, mscale)."""
    factor = s.get("factor", 1.0)
    orig_max = s.get("original_max_position_embeddings", 4096)
    beta_fast = s.get("beta_fast", 32)
    beta_slow = s.get("beta_slow", 1)
    mscale = s.get("mscale", 1.0)
    mscale_all_dim = s.get("mscale_all_dim", 0.0)

    def correction_dim(num_rot):
        return (rot_dim * math.log(orig_max / (num_rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low = math.floor(correction_dim(beta_fast))
    high = math.ceil(correction_dim(beta_slow))
    low, high = max(low, 0), min(high, rot_dim - 1)

    pos_freq = torch.tensor(theta, dtype=torch.float32) ** (
        torch.arange(0, rot_dim, 2, dtype=torch.float32) / rot_dim)
    inv_extra = 1.0 / pos_freq
    inv_interp = 1.0 / (factor * pos_freq)
    idx = torch.arange(rot_dim // 2, dtype=torch.float32)
    ramp = torch.clamp((idx - low) / max(high - low, 0.001), 0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = inv_interp * (1 - inv_freq_mask) + inv_extra * inv_freq_mask
    cs_mscale = float(_yarn_get_mscale(factor, mscale)
                      / _yarn_get_mscale(factor, mscale_all_dim))
    return inv_freq, cs_mscale


def compute_rope_cos_sin(
    rot_dim: int,
    max_position: int,
    theta: float = 10000.0,
    rope_scaling: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Returns the [max_position, rot_dim] float32 table: concat(cos, sin)."""
    inv_freq = _base_inv_freq(rot_dim, theta)
    positions = torch.arange(max_position, dtype=torch.float32)
    mscale = 1.0
    if rope_scaling:
        rtype = rope_scaling.get("rope_type",
                                 rope_scaling.get("type", "default"))
        if rtype in ("linear",):
            positions = positions / rope_scaling.get("factor", 1.0)
        elif rtype in ("llama3",):
            inv_freq = _llama3_scale_inv_freq(inv_freq, rope_scaling)
        elif rtype in ("yarn",):
            inv_freq, mscale = _yarn_inv_freq(rot_dim, theta, rope_scaling)
        elif rtype in ("default", None):
            pass
        else:
            raise NotImplementedError(f"rope scaling type {rtype!r}")
    freqs = torch.outer(positions, inv_freq)        # [max_pos, rot_dim/2]
    return torch.cat([torch.cos(freqs) * mscale,
                      torch.sin(freqs) * mscale], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               cos_sin: torch.Tensor):
    """NeoX-style (rotate-half) rotary embedding.

    q: [T, Hq, D], k: [T, Hkv, D], positions: [T] int, cos_sin:
    [max_pos, rot_dim]. rot_dim may be < D (partial rotary); the tail
    passes through.
    """
    rot_dim = cos_sin.shape[-1]
    half = rot_dim // 2
    cs = cos_sin[positions.long()]                   # [T, rot_dim]
    cos = cs[:, None, :half]                         # [T, 1, half]
    sin = cs[:, None, half:]

    def rotate(x):
        x1 = x[..., :half].float()
        x2 = x[..., half:rot_dim].float()
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
        if x.shape[-1] > rot_dim:
            out = torch.cat([out, x[..., rot_dim:]], dim=-1)
        return out

    return rotate(q), rotate(k)


def apply_rope_interleaved(q: torch.Tensor, k: torch.Tensor,
                           positions: torch.Tensor, cos_sin: torch.Tensor):
    """Pair-interleaved rotary (GLM): channel pairs (2i, 2i+1) rotate with
    frequency i. The rotated prefix is de-interleaved into the half layout
    and rotated as usual — one fixed permutation of q and k alike, so
    attention scores equal those of the interleaved formulation."""
    rot_dim = cos_sin.shape[-1]

    def deinterleave(x):
        head, tail = x[..., :rot_dim], x[..., rot_dim:]
        *lead, d = head.shape
        head = head.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(
            *lead, d)
        return torch.cat([head, tail], dim=-1) if tail.shape[-1] else head

    return apply_rope(deinterleave(q), deinterleave(k), positions, cos_sin)
