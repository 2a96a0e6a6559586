"""Model configuration, parsed from HF config.json dicts (counterpart of
``gllm_tpu/models/config.py``: ``ModelConfig:16``, ``from_hf_config:215``).

This port serves the dense GQA decoder family (Llama / Qwen2 / Qwen3 /
GLM-class). The fields that mark the other families (MoE experts, MLA
latent KV, hybrid linear attention, vision towers) are kept so a config of
such a model parses, and ``ModelConfig.check_supported`` refuses it.
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
    # Families this port does not serve yet (check_supported refuses them).
    num_experts: int = 0
    kv_lora_rank: int = 0
    layer_types: Tuple[str, ...] = ()
    vision_config: Optional[Dict[str, Any]] = None

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
        if self.num_experts:
            unported.append("MoE")
        if self.kv_lora_rank:
            unported.append("MLA")
        if "linear_attention" in self.layer_types:
            unported.append("hybrid linear attention")
        if self.vision_config is not None:
            unported.append("multimodal")
        if self.hidden_act != "silu":
            unported.append(f"hidden_act={self.hidden_act!r}")
        if unported:
            raise NotImplementedError(
                "not supported by gllm_tpu_torch yet: "
                + ", ".join(unported))


def _eos_tuple(v) -> Optional[Tuple[int, ...]]:
    if v is None:
        return None
    if isinstance(v, (list, tuple)):
        return tuple(v) or None
    return (v,)


def from_hf_config(hf: Dict[str, Any]) -> ModelConfig:
    """Parse a dense decoder's HF config.json dict into a ModelConfig."""
    arch = (hf.get("architectures")
            or (hf.get("text_config") or {}).get("architectures")
            or ["LlamaForCausalLM"])[0]
    num_heads = hf["num_attention_heads"]
    hidden = hf["hidden_size"]
    head_dim = hf.get("head_dim") or hidden // num_heads
    qk_norm = arch in ("Qwen3ForCausalLM", "Qwen3MoeForCausalLM")
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
        kv_lora_rank=hf.get("kv_lora_rank", 0) or 0,
        layer_types=tuple(hf.get("layer_types", ()) or ()),
        vision_config=hf.get("vision_config"),
    )
