"""DeepSeek V2/V3 family: MLA attention over a latent KV cache +
DeepSeekMoE; counterpart of ``gllm_tpu/models/deepseek.py``
(``LatentKVCache:45``, ``deepseek_route:108``, ``_moe_block:143``,
``_mla_attention:323`` without DSA, ``_mla_layer_init:394``,
``init_params:427``, ``forward:477``).

- **MLA, absorbed.** Each token caches one latent row ``[c_kv | k_pe]`` of
  ``kv_lora_rank + qk_rope_head_dim`` values, unpadded (576 for V2/V3; see
  ``ModelConfig.mla_cache_width``). ``q_nope`` is folded through ``w_uk``
  into latent space, attention is MQA over the latent cache with values =
  the row's leading ``kv_lora_rank`` lanes (``paged_attention`` with
  ``v_cache=None``: K1m on mixed steps, K2m on decode steps), and the
  output latent is expanded through ``w_uv``. The JAX package runs both
  absorptions in float32; this port runs them in the model dtype.
- **DeepSeekMoE.** ``first_k_dense_replace`` dense layers, then MoE layers:
  softmax/greedy routing (V2) or sigmoid + ``e_score_correction_bias`` +
  ``noaux_tc`` group pruning (V3), a grouped expert product over the
  expert-sorted assignments, and the always-on shared experts.
- YaRN rope with its mscale in the cos/sin table, and mscale**2 folded into
  the softmax scale (``yarn_softmax_scale_mult``).

Parameters are two stacked groups, ``dense_layers`` and ``moe_layers``, as
in the JAX pytree, with this port's fusions (``models/convert.py``):
``gate_up_proj`` (dense MLP), ``w_gate_up`` [L, E, H, 2I] (experts) and
``shared_gate_up_proj`` (shared experts) hold gate|up. The decoder is a
Python loop over the dense layers, then the MoE layers, over one stacked
latent cache [L, P, page, W] written in place; layer ``li`` addresses it
through the flat [L*P, ...] view with ``page_offset = li * P``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gllm_tpu_torch.batching import StepBatch
from gllm_tpu_torch.models import dense
from gllm_tpu_torch.models.config import ModelConfig
from gllm_tpu_torch.models.dummy import DummyDraws
from gllm_tpu_torch.models.moe import grouped_experts
from gllm_tpu_torch.ops.attention import paged_attention
from gllm_tpu_torch.ops.kv_cache import write_latent
from gllm_tpu_torch.ops.layers import fused_add_rms_norm, rms_norm
from gllm_tpu_torch.ops.rope import (apply_rope_interleaved,
                                     compute_rope_cos_sin,
                                     yarn_softmax_scale_mult)

Params = dense.Params


class LatentKVCache(NamedTuple):
    """latent: [L, num_pages, page_size, kv_lora_rank + qk_rope_head_dim]."""
    latent: torch.Tensor


def init_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                  dtype: torch.dtype, device) -> LatentKVCache:
    return LatentKVCache(torch.zeros(
        (cfg.num_layers, num_pages, page_size, cfg.mla_cache_width),
        dtype=dtype, device=device))


def kv_bytes_per_page(cfg: ModelConfig, page_size: int,
                      kv_dtype: torch.dtype) -> int:
    """One latent row per token and layer: no K/V pair, no kv heads."""
    itemsize = torch.empty(0, dtype=kv_dtype).element_size()
    return cfg.num_layers * page_size * cfg.mla_cache_width * itemsize


def make_rope_table(cfg: ModelConfig,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    return compute_rope_cos_sin(cfg.qk_rope_head_dim, cfg.max_position,
                                cfg.rope_theta, cfg.rope_scaling,
                                device=device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int, dtype: torch.dtype,
                device) -> Params:
    """Random weights with the JAX dummy init's scales, drawn from a
    ``torch.Generator`` one matrix at a time in float32 into tensors of
    ``dtype`` allocated up front (``models/dummy.py``): a float32 draw of a
    whole stacked expert tensor would need twice its final size again (38
    GB for V2-Lite's expert gate|up)."""
    H, Hq = cfg.hidden_size, cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    lora, v = cfg.kv_lora_rank, cfg.v_head_dim
    draws = DummyDraws(seed, dtype, device)
    w = draws.normal

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    scale = H ** -0.5

    def mla_layers(L):
        lp = {
            "input_norm": ones(L, H),
            "post_attn_norm": ones(L, H),
            "kv_a_proj": w((L, H, lora + rope), scale),
            "kv_a_norm": ones(L, lora),
            "w_uk": w((L, Hq, nope, lora), lora ** -0.5),
            "w_uv": w((L, Hq, lora, v), lora ** -0.5),
            "o_proj": w((L, Hq * v, H), (Hq * v) ** -0.5),
        }
        if cfg.q_lora_rank:
            qr = cfg.q_lora_rank
            lp["q_a_proj"] = w((L, H, qr), scale)
            lp["q_a_norm"] = ones(L, qr)
            lp["q_b_proj"] = w((L, qr, Hq * (nope + rope)), qr ** -0.5)
        else:
            lp["q_proj"] = w((L, H, Hq * (nope + rope)), scale)
        return lp

    params: Params = {}
    n_dense = min(cfg.first_k_dense_replace, cfg.num_layers)
    n_moe = cfg.num_layers - n_dense
    if n_dense:
        ld = mla_layers(n_dense)
        I = cfg.intermediate_size
        ld["gate_up_proj"] = w((n_dense, H, 2 * I), scale)
        ld["down_proj"] = w((n_dense, I, H), I ** -0.5)
        params["dense_layers"] = ld
    if n_moe:
        lm = mla_layers(n_moe)
        E, I = cfg.num_experts, cfg.moe_intermediate_size
        lm["router"] = w((n_moe, H, E), scale)
        if cfg.topk_method == "noaux_tc":
            lm["e_bias"] = torch.zeros((n_moe, E), dtype=torch.float32,
                                       device=device)
        lm["w_gate_up"] = w((n_moe, E, H, 2 * I), scale)
        lm["w_down"] = w((n_moe, E, I, H), I ** -0.5)
        if cfg.n_shared_experts:
            SI = cfg.n_shared_experts * I
            lm["shared_gate_up_proj"] = w((n_moe, H, 2 * SI), scale)
            lm["shared_down_proj"] = w((n_moe, SI, H), SI ** -0.5)
        params["moe_layers"] = lm
    params["embed"] = w((cfg.vocab_size, H), 1.0)
    params["final_norm"] = ones(H)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((H, cfg.vocab_size), scale)
    draws.draw()
    return params


# ---------------------------------------------------------------------------
# DeepSeekMoE
# ---------------------------------------------------------------------------

def deepseek_route(router_logits: torch.Tensor,
                   e_bias: Optional[torch.Tensor], cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert choice of each token: (weights [T, K] float32, ids
    [T, K] int32). Softmax or sigmoid scores; ``e_bias`` (V3's correction
    bias) shifts only the choice, not the weights; with ``n_group`` groups
    only the ``topk_group`` best groups stay eligible (a group scores its
    best expert, or, under ``noaux_tc``, the sum of its best two)."""
    T = router_logits.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    logits = router_logits.float()
    if cfg.scoring_func == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    choice = scores + e_bias.float() if e_bias is not None else scores
    if cfg.n_group and cfg.topk_group and cfg.topk_group < cfg.n_group:
        g = cfg.n_group
        grouped = choice.view(T, g, E // g)
        if cfg.topk_method == "noaux_tc":
            group_scores = grouped.topk(2, dim=-1).values.sum(-1)
        else:
            group_scores = grouped.amax(-1)
        top_groups = group_scores.topk(cfg.topk_group, dim=-1).indices
        keep = torch.zeros((T, g), dtype=torch.bool, device=choice.device)
        keep.scatter_(1, top_groups, True)
        choice = choice.masked_fill(
            ~keep.repeat_interleave(E // g, dim=1), float("-inf"))
    ids = choice.topk(K, dim=-1).indices
    weights = scores.gather(-1, ids)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * cfg.routed_scaling_factor, ids.to(torch.int32)


def _moe_block(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Routed experts (``moe.grouped_experts``: the expert-sorted grouped
    product, no host sync) + shared experts for x [T, H]."""
    logits = x.float() @ lp["router"].float()
    weights, ids = deepseek_route(logits, lp.get("e_bias"), cfg)
    combined = grouped_experts(x, weights, ids, lp["w_gate_up"],
                               lp["w_down"])
    if cfg.n_shared_experts:
        combined = combined + dense._mlp(
            {"gate_up_proj": lp["shared_gate_up_proj"],
             "down_proj": lp["shared_down_proj"]}, x)
    return combined


# ---------------------------------------------------------------------------
# MLA attention (absorbed form)
# ---------------------------------------------------------------------------

def _mla_attention(lp, x: torch.Tensor, batch: StepBatch,
                   latent: torch.Tensor, cfg: ModelConfig, cos_sin, *,
                   scale: float, max_q_len: int, li: int, impl: str
                   ) -> torch.Tensor:
    """latent: the flat [L*P, page, W] view of the stacked cache; layer
    ``li``'s pages start at ``li * P``."""
    T = x.shape[0]
    Hq = cfg.num_heads
    nope, rope, lora = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.kv_lora_rank)
    LP, page, width = latent.shape
    P = LP // cfg.num_layers

    if cfg.q_lora_rank:
        qa = rms_norm(x @ lp["q_a_proj"], lp["q_a_norm"], cfg.rms_norm_eps)
        q = qa @ lp["q_b_proj"]
    else:
        q = x @ lp["q_proj"]
    q = q.view(T, Hq, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    kv_a = x @ lp["kv_a_proj"]                        # [T, lora + rope]
    c_kv = rms_norm(kv_a[:, :lora], lp["kv_a_norm"], cfg.rms_norm_eps)
    k_pe = kv_a[:, None, lora:]                       # [T, 1, rope]
    q_pe, k_pe = apply_rope_interleaved(q_pe, k_pe, batch.positions, cos_sin)
    write_latent(latent, torch.cat([c_kv, k_pe[:, 0]], dim=-1),
                 batch.slot_mapping + li * (P * page))

    # q_nope absorbed through W_UK into latent space; MQA over the latent
    # cache, whose leading kv_lora_rank lanes are the values
    q_lat = torch.einsum("thn,hnl->thl", q_nope, lp["w_uk"])
    q_full = torch.cat([q_lat, q_pe], dim=-1)         # [T, Hq, lora + rope]
    out_lat = paged_attention(q_full, latent.view(LP, page, 1, width), None,
                              batch.attn, scale=scale, max_q_len=max_q_len,
                              page_offset=li * P, impl=impl, v_dim=lora)
    out = torch.einsum("thl,hlv->thv", out_lat, lp["w_uv"])
    return out.reshape(T, Hq * cfg.v_head_dim) @ lp["o_proj"]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: Params, kv: LatentKVCache, batch: StepBatch,
            cfg: ModelConfig, *, cos_sin: torch.Tensor, max_q_len: int,
            impl: str = "legacy") -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the dense layers, then the MoE layers; returns (hidden,
    residual). The latent cache is written in place."""
    scale = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
             * yarn_softmax_scale_mult(cfg.rope_scaling))
    L, P = kv.latent.shape[:2]
    latent = kv.latent.view((L * P,) + kv.latent.shape[2:])
    hidden = params["embed"][batch.token_ids.long()]
    residual = torch.zeros_like(hidden)
    eps = cfg.rms_norm_eps
    li = 0
    for group, mlp in (("dense_layers", dense._mlp),
                       ("moe_layers", lambda lp, x: _moe_block(lp, x, cfg))):
        stacked = params.get(group)
        if not stacked:
            continue
        for i in range(stacked["input_norm"].shape[0]):
            lp = {name: t[i] for name, t in stacked.items()}
            normed, residual = fused_add_rms_norm(hidden, residual,
                                                  lp["input_norm"], eps)
            attn_out = _mla_attention(lp, normed, batch, latent, cfg,
                                      cos_sin, scale=scale,
                                      max_q_len=max_q_len, li=li, impl=impl)
            normed2, residual = fused_add_rms_norm(attn_out, residual,
                                                   lp["post_attn_norm"], eps)
            hidden = mlp(lp, normed2)
            li += 1
    return hidden, residual


compute_logits = dense.compute_logits
compute_full_logits = dense.compute_full_logits
