"""Gated DeltaNet ops for the hybrid family (Qwen3-Next / Qwen3.5);
counterpart of ``gllm_tpu/ops/gdn.py`` (``l2norm:30``, ``causal_conv1d:35``,
``recurrent_gated_delta_step:66``, ``chunk_gated_delta_rule:91``,
``rms_norm_gated:198``).

Everything computes in float32, as there. Sequences ride in a padded
[S, T] layout: a padded position carries g = 0 and beta = 0, which is the
identity on the state. The chunked rule keeps the in-chunk triangular
work (decay, A, ``(I + A)^-1`` by ``torch.linalg.solve_triangular``, v2,
k_cumdecay, the masked local scores) as batched PyTorch, as the JAX
package leaves it to XLA; the sequential inter-chunk recurrence goes
through K3's wrapper (``ops/cuda/gdn_scan.py``): the CUDA kernel on the
card, its plain version (the JAX ``lax.scan`` body) on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from gllm_tpu_torch.ops.cuda.gdn_scan import gdn_chunk_scan
from gllm_tpu_torch.utils import next_pow2


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def causal_conv1d(x: torch.Tensor, state: torch.Tensor,
                  weight: torch.Tensor, q_lens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv with carried state, then SiLU.

    x [S, T, C] (rows padded past q_lens[s]); state [S, C, K-1], the last
    K-1 real inputs of earlier chunks; weight [C, K]. Returns
    (silu(conv(x)) [S, T, C] float32, new_state [S, C, K-1]): the last K-1
    real inputs, padding excluded. A sum of K shifted products, not
    ``F.conv1d``: cuDNN would take a float32 convolution in TF32.
    """
    S, T, C = x.shape
    K = weight.shape[-1]
    w = weight.float()
    buf = torch.cat([state.transpose(1, 2).float(), x.float()], dim=1)
    out = buf[:, :T] * w[:, 0]
    for j in range(1, K):
        out.addcmul_(buf[:, j:j + T], w[:, j])
    # buf row i holds input i - (K-1): the state is rows q_len .. q_len+K-2
    idx = q_lens.long()[:, None] + torch.arange(K - 1, device=x.device)
    new_state = torch.gather(buf, 1, idx[:, :, None].expand(S, K - 1, C))
    return F.silu(out), new_state.transpose(1, 2)


def recurrent_gated_delta_step(q, k, v, g, beta, state
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the gated delta rule. q, k [S, H, Dk]; v
    [S, H, Dv]; g (log decay), beta [S, H]; state [S, H, Dk, Dv] float32.
    Returns (out [S, H, Dv], new state)."""
    q = l2norm(q.float())
    k = l2norm(k.float())
    q = q * q.shape[-1] ** -0.5
    state = state * torch.exp(g.float())[..., None, None]
    kv_mem = torch.einsum("shkv,shk->shv", state, k)
    delta = (v.float() - kv_mem) * beta.float()[..., None]
    state = state + k[..., :, None] * delta[..., None, :]
    out = torch.einsum("shkv,shk->shv", state, q)
    return out, state


def chunk_gated_delta_rule(q, k, v, g, beta,
                           initial_state: Optional[torch.Tensor] = None,
                           chunk_size: int = 64
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked gated delta rule over [S, T] rows.

    q, k [S, T, H, Dk]; v [S, T, H, Dv]; g, beta [S, T, H] (0 on padded
    positions); initial_state [S, H, Dk, Dv]. Returns (out [S, T, H, Dv],
    final_state [S, H, Dk, Dv]), float32. Chunks are ``chunk_size`` rows,
    or the next power of two of T (at least 16) when T is shorter.
    """
    S, T, H, _ = q.shape
    Dv = v.shape[-1]
    operands = chunk_scan_operands(q, k, v, g, beta, initial_state,
                                   chunk_size)
    out, final = gdn_chunk_scan(*operands)
    N, C = out.shape[1:3]
    out = out.view(S, H, N * C, Dv).permute(0, 2, 1, 3)[:, :T]
    return out, final.view(S, H, *final.shape[1:])


def chunk_scan_operands(q, k, v, g, beta,
                        initial_state: Optional[torch.Tensor] = None,
                        chunk_size: int = 64):
    """The in-chunk half of :func:`chunk_gated_delta_rule`: K3's inputs
    (qc, kc, v2, kcd, attn, gcum, init_state), each [S*H, ...] float32 and
    contiguous."""
    S, T, H, Dk = q.shape
    Dv = v.shape[-1]
    dev = q.device
    C = min(chunk_size, next_pow2(T, 16))
    pad = (-T) % C
    N = (T + pad) // C

    def chunked(a, scale=None):
        # [S, T, H, D] → [S, H, N, C, D] float32, contiguous
        a = a.float()
        if scale is not None:
            a = scale(a)
        if pad:
            a = F.pad(a, (0, 0, 0, 0, 0, pad))
        return a.reshape(S, N, C, H, -1).permute(0, 3, 1, 2, 4).contiguous()

    def chunked_heads(a):                       # [S, T, H] → [S, H, N, C]
        a = F.pad(a.float(), (0, 0, 0, pad))
        return a.reshape(S, N, C, H).permute(0, 3, 1, 2)

    qc = chunked(q, lambda a: l2norm(a) * Dk ** -0.5)
    kc = chunked(k, l2norm)
    bc = chunked_heads(beta)[..., None]
    v_beta = chunked(v) * bc
    k_beta = kc * bc
    gcum = chunked_heads(g).cumsum(-1).contiguous()   # [S, H, N, C]

    tril = torch.ones((C, C), dtype=torch.bool, device=dev).tril()
    strict = tril.tril(-1)
    # exp of the upper triangle may overflow; where() drops it
    decay = torch.where(tril, torch.exp(gcum[..., :, None]
                                        - gcum[..., None, :]), 0.0)
    A = torch.where(strict, (k_beta @ kc.transpose(-1, -2)) * decay, 0.0)
    eye = torch.eye(C, dtype=torch.float32, device=dev)
    # (I + A)^-1 by one batched triangular solve
    tmat = torch.linalg.solve_triangular(eye + A, eye, upper=False)
    del A
    v2 = tmat @ v_beta
    k_cumdecay = tmat @ (k_beta * torch.exp(gcum)[..., None])
    del tmat, v_beta, k_beta
    attn_local = torch.where(tril, (qc @ kc.transpose(-1, -2)) * decay, 0.0)
    del decay

    B = S * H
    state0 = (torch.zeros((B, Dk, Dv), dtype=torch.float32, device=dev)
              if initial_state is None
              else initial_state.float().reshape(B, Dk, Dv).contiguous())

    def flat(a, *shape):                        # [S, H, ...] → [B, ...]
        return a.reshape(B, *shape).contiguous()

    return (flat(qc, N, C, Dk), flat(kc, N, C, Dk), flat(v2, N, C, Dv),
            flat(k_cumdecay, N, C, Dk), flat(attn_local, N, C, C),
            flat(gcum, N, C, 1), state0)


def rms_norm_gated(x: torch.Tensor, gate: torch.Tensor,
                   weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Norm, then gate (HF Qwen3NextRMSNormGated): rmsnorm(x) * silu(gate),
    the norm rounded to x's dtype before the weight, as the JAX op does."""
    xf = x.float()
    normed = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
              ).to(x.dtype) * weight
    return (normed * F.silu(gate.float())).to(x.dtype)
