"""Normalisation and activation ops (counterpart of
``gllm_tpu/ops/layers.py:18-46``). Norms accumulate in float32 and cast back
to the input dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def fused_add_rms_norm(x: torch.Tensor, residual: torch.Tensor,
                       weight: torch.Tensor, eps: float = 1e-6):
    """residual' = x + residual; y = rms_norm(residual'). Returns
    (normed, new_residual)."""
    new_residual = x + residual
    return rms_norm(new_residual, weight, eps), new_residual


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """x = [gate, up] concatenated on the last dim → silu(gate) * up."""
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate.float()).to(x.dtype) * up
