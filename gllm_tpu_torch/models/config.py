"""Model configuration, parsed from HF config.json dicts (counterpart of
``gllm_tpu/models/config.py``: ``ModelConfig:16``, MLA and DeepSeek MoE
fields ``:50-106``, ``from_hf_config:215``).

This port serves three families: the dense GQA decoder (Llama / Qwen2 /
Qwen3 / GLM-class), DeepSeek V2/V3 (MLA latent KV + DeepSeekMoE, without
DSA) and the hybrid Gated-DeltaNet family (Qwen3-Next / Qwen3.5; hybrid
fields ``:137-175``, the ``from_hf_config`` branch ``:307-320``). The
fields that mark the other families (other MoE architectures, DSA, vision
towers) are kept so a config of such a model parses, and
``ModelConfig.check_supported`` refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    architecture: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    max_position: int = 8192
    tie_word_embeddings: bool = False
    attention_bias: bool = False      # qwen2-style qkv bias
    qk_norm: bool = False             # qwen3-style per-head q/k RMSNorm
    partial_rotary_factor: float = 1.0  # GLM: rotate only this prefix of D
    rope_interleaved: bool = False    # GLM pair-interleaved layout
    sandwich_norms: bool = False      # GLM4 post_self_attn/post_mlp norms
    eos_token_id: Any = None
    hidden_act: str = "silu"
    # MoE (DeepSeekMoE here; check_supported refuses experts on any other
    # architecture)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    # Qwen-style sparse block (hybrid family): one shared expert of this
    # width beside the routed ones, gated by sigmoid(x @ gate)
    shared_expert_intermediate_size: int = 0
    # MLA (DeepSeek V2/V3)
    q_lora_rank: int = 0              # 0 → direct q projection (V2-Lite)
    kv_lora_rank: int = 0             # > 0 enables the MLA latent cache
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # DeepSeek MoE routing
    first_k_dense_replace: int = 0
    n_shared_experts: int = 0
    routed_scaling_factor: float = 1.0
    n_group: int = 0
    topk_group: int = 0
    scoring_func: str = "softmax"     # softmax (V2) | sigmoid (V3)
    topk_method: str = "greedy"       # greedy | group_limited_greedy |
                                      # noaux_tc (V3 bias-corrected)
    # Hybrid linear attention (Qwen3-Next / Qwen3.5): layer_types marks
    # each layer "linear_attention" (Gated DeltaNet) or "full_attention"
    layer_types: Tuple[str, ...] = ()
    linear_num_value_heads: int = 0
    linear_num_key_heads: int = 0
    linear_key_head_dim: int = 0
    linear_value_head_dim: int = 0
    linear_conv_kernel_dim: int = 4
    # Families this port does not serve yet (check_supported refuses them):
    # DeepSeek V3.2 sparse attention (DSA), multimodal.
    index_n_heads: int = 0
    index_head_dim: int = 0
    index_topk: int = 0
    vision_config: Optional[Dict[str, Any]] = None

    @property
    def use_hybrid(self) -> bool:
        return "linear_attention" in self.layer_types

    @property
    def num_attn_layers(self) -> int:
        """Full-attention layers: the depth of the paged KV stack."""
        if not self.layer_types:
            return self.num_layers
        return sum(1 for t in self.layer_types if t == "full_attention")

    @property
    def num_linear_layers(self) -> int:
        return sum(1 for t in self.layer_types if t == "linear_attention")

    @property
    def gdn_conv_dim(self) -> int:
        """Channels of the GDN layer's causal conv: q, k and v."""
        return (2 * self.linear_num_key_heads * self.linear_key_head_dim
                + self.linear_num_value_heads * self.linear_value_head_dim)

    @property
    def use_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def mla_cache_width(self) -> int:
        """Width of one latent cache row, ``[c_kv | k_pe]``: kv_lora_rank +
        qk_rope_head_dim (576 for DeepSeek V2/V3). The JAX package pads the
        row to 640, a multiple of the TPU's 128 lanes; the CUDA kernels need
        no such pad, and a decode step, which is bound by bytes, would read
        11% more for it, so this port stores the row unpadded."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def use_dsa(self) -> bool:
        return self.index_topk > 0 and self.index_n_heads > 0

    @property
    def eos_token_ids(self) -> Tuple[int, ...]:
        v = self.eos_token_id
        if v is None:
            return ()
        if isinstance(v, (list, tuple)):
            return tuple(v)
        return (v,)

    def check_supported(self) -> None:
        unported = []
        deepseek = self.architecture in DEEPSEEK_ARCHS
        hybrid = self.architecture in HYBRID_ARCHS
        if self.num_experts and not (deepseek or hybrid):
            unported.append(f"MoE ({self.architecture})")
        if self.kv_lora_rank and not deepseek:
            unported.append(f"MLA ({self.architecture})")
        if deepseek and not self.kv_lora_rank:
            unported.append(f"{self.architecture} without kv_lora_rank")
        if self.use_dsa:
            unported.append("DeepSeek sparse attention (index_topk)")
        if self.use_hybrid and not hybrid:
            unported.append(f"hybrid linear attention ({self.architecture})")
        if hybrid:
            if not self.use_hybrid:
                unported.append(f"{self.architecture} without "
                                "linear_attention layer_types")
            elif len(self.layer_types) != self.num_layers:
                # the JAX package tiles layer_types by its smallest period
                # (hybrid.py:49), which may be the whole list; the port runs
                # the layers in order, and needs one type per layer
                unported.append(f"layer_types of {len(self.layer_types)} "
                                f"layers for {self.num_layers} layers")
        if self.vision_config is not None:
            unported.append("multimodal")
        if self.hidden_act != "silu":
            unported.append(f"hidden_act={self.hidden_act!r}")
        if unported:
            raise NotImplementedError(
                "not supported by gllm_tpu_torch yet: "
                + ", ".join(unported))


# DeepSeek V2/V3 (MLA + DeepSeekMoE); V3.2 (DSA) and Kimi stay refused
DEEPSEEK_ARCHS = ("DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM")
# the hybrid GDN family (gllm_tpu/models/registry.py:166-172)
HYBRID_ARCHS = ("Qwen3NextForCausalLM", "Qwen3_5ForCausalLM",
                "Qwen3_5MoeForCausalLM", "Qwen3_5ForConditionalGeneration",
                "Qwen3_5MoeForConditionalGeneration")


def _eos_tuple(v) -> Optional[Tuple[int, ...]]:
    if v is None:
        return None
    if isinstance(v, (list, tuple)):
        return tuple(v) or None
    return (v,)


def from_hf_config(hf: Dict[str, Any]) -> ModelConfig:
    """Parse a dense decoder's, a DeepSeek model's or a hybrid model's HF
    config.json dict into a ModelConfig."""
    arch = (hf.get("architectures")
            or (hf.get("text_config") or {}).get("architectures")
            or ["LlamaForCausalLM"])[0]
    extra = dict(layer_types=tuple(hf.get("layer_types", ()) or ()))
    if arch in HYBRID_ARCHS:
        # Real Qwen3.5 checkpoints use the *ForConditionalGeneration arch
        # string and may nest the LM under text_config.
        text = dict(hf.get("text_config") or hf)
        extra = dict(
            layer_types=tuple(text.get("layer_types", ())),
            linear_num_value_heads=text.get("linear_num_value_heads", 0),
            linear_num_key_heads=text.get("linear_num_key_heads", 0),
            linear_key_head_dim=text.get("linear_key_head_dim", 0),
            linear_value_head_dim=text.get("linear_value_head_dim", 0),
            linear_conv_kernel_dim=text.get("linear_conv_kernel_dim", 4),
        )
        hf = {**text, "architectures": [arch],
              "eos_token_id": hf.get("eos_token_id",
                                     text.get("eos_token_id"))}
    num_heads = hf["num_attention_heads"]
    hidden = hf["hidden_size"]
    head_dim = hf.get("head_dim") or hidden // num_heads
    qk_norm = arch in ("Qwen3ForCausalLM", "Qwen3MoeForCausalLM") + \
        HYBRID_ARCHS
    is_glm4 = arch in ("Glm4ForCausalLM",)
    is_glm = arch in ("GlmForCausalLM",)
    # HF's Qwen2 attention is bias=True unconditionally, whatever
    # config.json says.
    if arch in ("Qwen2ForCausalLM", "Qwen2MoeForCausalLM"):
        attention_bias = True
    else:
        attention_bias = hf.get("attention_bias", False)
    return ModelConfig(
        architecture=arch,
        vocab_size=hf["vocab_size"],
        hidden_size=hidden,
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=head_dim,
        intermediate_size=hf["intermediate_size"],
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=hf.get("rope_scaling"),
        max_position=hf.get("max_position_embeddings", 8192),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        attention_bias=attention_bias,
        qk_norm=qk_norm,
        partial_rotary_factor=hf.get("partial_rotary_factor", 1.0) or 1.0,
        rope_interleaved=is_glm4 or is_glm,
        sandwich_norms=is_glm4,
        eos_token_id=_eos_tuple(hf.get("eos_token_id")),
        hidden_act=hf.get("hidden_act", "silu"),
        num_experts=hf.get("num_experts",
                           hf.get("num_local_experts",
                                  hf.get("n_routed_experts", 0)) or 0),
        num_experts_per_tok=hf.get("num_experts_per_tok", 0) or 0,
        moe_intermediate_size=hf.get("moe_intermediate_size", 0) or 0,
        norm_topk_prob=hf.get("norm_topk_prob", True),
        shared_expert_intermediate_size=hf.get(
            "shared_expert_intermediate_size", 0) or 0,
        q_lora_rank=hf.get("q_lora_rank", 0) or 0,
        kv_lora_rank=hf.get("kv_lora_rank", 0) or 0,
        qk_nope_head_dim=hf.get("qk_nope_head_dim", 0) or 0,
        qk_rope_head_dim=hf.get("qk_rope_head_dim", 0) or 0,
        v_head_dim=hf.get("v_head_dim", 0) or 0,
        first_k_dense_replace=hf.get("first_k_dense_replace", 0) or 0,
        n_shared_experts=hf.get("n_shared_experts", 0) or 0,
        routed_scaling_factor=hf.get("routed_scaling_factor", 1.0) or 1.0,
        n_group=hf.get("n_group", 0) or 0,
        topk_group=hf.get("topk_group", 0) or 0,
        scoring_func=hf.get("scoring_func", "softmax") or "softmax",
        topk_method=hf.get("topk_method", "greedy") or "greedy",
        index_n_heads=hf.get("index_n_heads", 0) or 0,
        index_head_dim=hf.get("index_head_dim", 0) or 0,
        index_topk=hf.get("index_topk", 0) or 0,
        vision_config=hf.get("vision_config"),
        **extra,
    )
