"""Dense GQA decoder (Llama / Qwen2 / Qwen3 / GLM-class); counterpart of
``gllm_tpu/models/dense.py`` (``init_kv_cache:57``, ``init_params:80``,
``_attention:131``, ``_mlp:215``, ``forward:222``,
``compute_full_logits:297``, ``compute_logits:310``,
``make_rope_table:330``).

Parameters are a plain dict of tensors in the JAX package's layout: weights
are [in, out] and used as ``x @ W``, per-layer weights are stacked on a
leading [L, ...] axis. Two fusions differ from the JAX pytree, and
``models/convert.py`` maps between the two: ``qkv_proj`` is q|k|v concatenated
on the output axis (one product instead of three) and ``gate_up_proj`` is
gate|up (the [gate, up] input ``silu_and_mul`` takes).

The decoder is a Python loop over layers where JAX used ``lax.scan``. The
KV cache is one stacked tensor per K and V, [L, P, page, Hkv, D], written in
place; each layer addresses it through the flat [L*P, ...] view, with the
layer offset added to the slot mapping (``li * P * page``) and passed to the
attention kernels as ``page_offset = li * P``. Page 0 of every layer is that
layer's dummy page, where padding tokens write. An int8 cache
(kv_cache_dtype="int8") adds per-page, per-kv-head float32 scales
[L, P, Hkv], written by ``write_kv_quant`` and reaching attention through
the flat [L*P, Hkv] view with the same ``page_offset``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gllm_tpu_torch.batching import StepBatch
from gllm_tpu_torch.models.config import ModelConfig
from gllm_tpu_torch.models.dummy import DummyDraws
from gllm_tpu_torch.ops.attention import paged_attention
from gllm_tpu_torch.ops.kv_cache import write_kv, write_kv_quant
from gllm_tpu_torch.ops.layers import fused_add_rms_norm, rms_norm, silu_and_mul
from gllm_tpu_torch.ops.rope import (apply_rope, apply_rope_interleaved,
                                     compute_rope_cos_sin)

Params = Dict[str, object]


class KVCache(NamedTuple):
    """Stacked KV cache: [L, num_pages, page_size, Hkv, D] per K and V, and
    for an int8 cache the scales [L, num_pages, Hkv] float32 (else None)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                  dtype: torch.dtype, device) -> KVCache:
    """Zeroed caches; ``dtype`` torch.int8 adds zero scales (a zero scale
    marks a page no write has touched yet)."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    kv = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(2)]
    if dtype == torch.int8:
        kv += [torch.zeros(shape[:2] + shape[3:4], dtype=torch.float32,
                           device=device) for _ in range(2)]
    return KVCache(*kv)


def kv_bytes_per_page(cfg: ModelConfig, page_size: int,
                      kv_dtype: torch.dtype) -> int:
    """Device bytes of one page across the layers, K and V; an int8 page
    adds its float32 scale rows."""
    itemsize = torch.empty(0, dtype=kv_dtype).element_size()
    per_page = (2 * cfg.num_layers * page_size * cfg.num_kv_heads
                * cfg.head_dim * itemsize)
    if kv_dtype == torch.int8:
        per_page += 2 * cfg.num_layers * cfg.num_kv_heads * 4
    return per_page


def init_params(cfg: ModelConfig, seed: int, dtype: torch.dtype,
                device) -> Params:
    """Random weights with the JAX dummy init's scales, drawn from a
    ``torch.Generator`` (so they never equal the JAX package's draws;
    parity tests carry JAX params across with ``models/convert.py``), one
    float32 draw a tensor through ``models/dummy.py``'s scratch."""
    L, H, D = cfg.num_layers, cfg.hidden_size, cfg.head_dim
    Hq, Hkv, I = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    draws = DummyDraws(seed, dtype, device)

    def w(shape, scale):
        return draws.normal(shape, scale, per_matrix=False)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    scale = H ** -0.5
    qkv = (Hq + 2 * Hkv) * D
    layers = {
        "input_norm": ones(L, H),
        "qkv_proj": w((L, H, qkv), scale),
        "o_proj": w((L, Hq * D, H), (Hq * D) ** -0.5),
        "post_attn_norm": ones(L, H),
        "gate_up_proj": w((L, H, 2 * I), scale),
        "down_proj": w((L, I, H), I ** -0.5),
    }
    if cfg.attention_bias:
        layers["qkv_bias"] = torch.zeros((L, qkv), dtype=dtype,
                                         device=device)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, D)
        layers["k_norm"] = ones(L, D)
    if cfg.sandwich_norms:
        layers["post_self_attn_norm"] = ones(L, H)
        layers["post_mlp_norm"] = ones(L, H)
    params: Params = {"layers": layers,
                      "embed": w((cfg.vocab_size, H), 1.0),
                      "final_norm": ones(H)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((H, cfg.vocab_size), scale)
    draws.draw()
    return params


def _attention(lp, x, batch: StepBatch, kv: KVCache, cfg: ModelConfig,
               cos_sin, *, max_q_len: int, li: int, impl: str
               ) -> torch.Tensor:
    T = x.shape[0]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, P, page = kv.k.shape[:3]
    k_cache = kv.k.view((L * P,) + kv.k.shape[2:])
    v_cache = kv.v.view((L * P,) + kv.v.shape[2:])

    qkv = x @ lp["qkv_proj"]
    if "qkv_bias" in lp:
        qkv = qkv + lp["qkv_bias"]
    q, k, v = qkv.split([Hq * D, Hkv * D, Hkv * D], dim=-1)
    q = q.reshape(T, Hq, D)
    k = k.reshape(T, Hkv, D)
    v = v.reshape(T, Hkv, D)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    rope_fn = apply_rope_interleaved if cfg.rope_interleaved else apply_rope
    q, k = rope_fn(q, k, batch.positions, cos_sin)
    slots = batch.slot_mapping + li * (P * page)
    k_scale = v_scale = None
    if kv.k_scale is not None:
        k_scale = kv.k_scale.view(L * P, Hkv)
        v_scale = kv.v_scale.view(L * P, Hkv)
        write_kv_quant(k_cache, v_cache, k_scale, v_scale, k, v, slots)
    else:
        write_kv(k_cache, v_cache, k, v, slots)
    attn = paged_attention(q.contiguous(), k_cache, v_cache, batch.attn,
                           scale=D ** -0.5, max_q_len=max_q_len,
                           page_offset=li * P, impl=impl, k_scale=k_scale,
                           v_scale=v_scale)
    return attn.reshape(T, Hq * D) @ lp["o_proj"]


def _mlp(lp, x):
    return silu_and_mul(x @ lp["gate_up_proj"]) @ lp["down_proj"]


def forward(params: Params, kv: KVCache, batch: StepBatch, cfg: ModelConfig,
            *, cos_sin: torch.Tensor, max_q_len: int, impl: str = "legacy"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run every layer; returns (hidden, residual). The KV cache is written
    in place (the JAX version returns a new cache under buffer donation).
    ``impl`` picks the attention kernels (ops/attention.py)."""
    hidden = params["embed"][batch.token_ids.long()]
    residual = torch.zeros_like(hidden)
    layers = params["layers"]
    eps = cfg.rms_norm_eps
    for li in range(cfg.num_layers):
        lp = {name: t[li] for name, t in layers.items()}
        normed, residual = fused_add_rms_norm(hidden, residual,
                                              lp["input_norm"], eps)
        attn_out = _attention(lp, normed, batch, kv, cfg, cos_sin,
                              max_q_len=max_q_len, li=li, impl=impl)
        if cfg.sandwich_norms:
            attn_out = rms_norm(attn_out, lp["post_self_attn_norm"], eps)
        normed2, residual = fused_add_rms_norm(attn_out, residual,
                                               lp["post_attn_norm"], eps)
        hidden = _mlp(lp, normed2)
        if cfg.sandwich_norms:
            hidden = rms_norm(hidden, lp["post_mlp_norm"], eps)
    return hidden, residual


def compute_full_logits(params: Params, hidden: torch.Tensor,
                        residual: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """The logits of every row of ``hidden`` [N, V] float32 (JAX's
    ``compute_full_logits``, ``gllm_tpu/models/dense.py:297``: the prompt
    logprobs' path): final norm, then the head."""
    normed = rms_norm(hidden + residual, params["final_norm"],
                      cfg.rms_norm_eps)
    head = (params["embed"].t() if cfg.tie_word_embeddings
            else params["lm_head"])
    return (normed @ head).float()


def compute_logits(params: Params, hidden: torch.Tensor,
                   residual: torch.Tensor, batch: StepBatch,
                   cfg: ModelConfig) -> torch.Tensor:
    """Gather the last token of each sequence, final-norm, project to the
    vocabulary ([S, V] float32). Gathering before the head product keeps
    it at S rows instead of T."""
    idx = batch.logits_indices.long()
    return compute_full_logits(params, hidden[idx], residual[idx], cfg)


def make_rope_table(cfg: ModelConfig,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    rot_dim = int(cfg.head_dim * cfg.partial_rotary_factor)
    return compute_rope_cos_sin(rot_dim, cfg.max_position, cfg.rope_theta,
                                cfg.rope_scaling, device=device)
