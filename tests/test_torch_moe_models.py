"""The Mixtral / Qwen2-MoE / Qwen3-MoE family on the CPU, held to the JAX
package's ``gllm_tpu/models/moe.py``: the config's fields and the layer
mask (``mlp_only_layers``, ``decoder_sparse_step``), the checkpoint rules
(``moe_rules``: Qwen's ``mlp.experts.*`` and shared expert, Mixtral's
``block_sparse_moe.*``) against JAX's loader exactly, greedy float32
streams from a checkpoint directory against JAX's ``LLM``, and the dummy
init carried across by ``convert`` (``moe_mask`` a bool leaf in JAX, none
in the port)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models import moe as jmoe
from gllm_tpu.models.config import from_hf_config as jfrom_hf
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert, moe
from gllm_tpu_torch.models.registry import get_model_def

from test_torch_loader import (D, E, H, HKV, HQ, I, MI, PAIRINGS, TOPK, V,
                               _w, check_against_jax, check_streams,
                               streams)

torch.set_num_threads(1)


def moe_hf(arch="Qwen3MoeForCausalLM", layers=2, shared=False, bias=False,
           qk_norm=True, mlp_only=(), sparse_step=1):
    """(config.json dict, {tensor name: shape spec}) of an MoE model; a
    layer off the mask carries the dense MLP's tensors instead."""
    mixtral = arch == "MixtralForCausalLM"
    hf = dict(architectures=[arch], vocab_size=V, hidden_size=H,
              num_hidden_layers=layers, num_attention_heads=HQ,
              num_key_value_heads=HKV, head_dim=D, intermediate_size=I,
              max_position_embeddings=128, rope_theta=10000.0,
              rms_norm_eps=1e-6, tie_word_embeddings=False,
              num_experts_per_tok=TOPK, eos_token_id=V - 1)
    if mixtral:
        hf["num_local_experts"] = E
    else:
        hf.update(num_experts=E, moe_intermediate_size=MI,
                  norm_topk_prob=not shared, decoder_sparse_step=sparse_step,
                  mlp_only_layers=list(mlp_only))
        if shared:
            hf["shared_expert_intermediate_size"] = MI
    ei = I if mixtral else MI
    t = {"model.embed_tokens.weight": ("e", (V, H)),
         "model.norm.weight": ("n", (H,)), "lm_head.weight": _w(V, H)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({p + "self_attn.q_proj.weight": _w(HQ * D, H),
                  p + "self_attn.k_proj.weight": _w(HKV * D, H),
                  p + "self_attn.v_proj.weight": _w(HKV * D, H),
                  p + "self_attn.o_proj.weight": _w(H, HQ * D),
                  p + "input_layernorm.weight": ("n", (H,)),
                  p + "post_attention_layernorm.weight": ("n", (H,))})
        if bias:
            for n, w in (("q", HQ * D), ("k", HKV * D), ("v", HKV * D)):
                t[p + f"self_attn.{n}_proj.bias"] = ("b", (w,))
        if qk_norm:
            t[p + "self_attn.q_norm.weight"] = ("n", (D,))
            t[p + "self_attn.k_norm.weight"] = ("n", (D,))
        routed = i not in mlp_only and (sparse_step <= 1
                                        or (i + 1) % sparse_step == 0)
        if not routed:
            t.update({p + "mlp.gate_proj.weight": _w(I, H),
                      p + "mlp.up_proj.weight": _w(I, H),
                      p + "mlp.down_proj.weight": _w(H, I)})
            continue
        block = "block_sparse_moe." if mixtral else "mlp."
        t[p + block + "gate.weight"] = _w(E, H)
        for e in range(E):
            q = p + block + f"experts.{e}."
            names = (("w1", "w3", "w2") if mixtral
                     else ("gate_proj", "up_proj", "down_proj"))
            t.update({q + names[0] + ".weight": _w(ei, H),
                      q + names[1] + ".weight": _w(ei, H),
                      q + names[2] + ".weight": _w(H, ei)})
        if shared:
            t.update({p + "mlp.shared_expert.gate_proj.weight": _w(MI, H),
                      p + "mlp.shared_expert.up_proj.weight": _w(MI, H),
                      p + "mlp.shared_expert.down_proj.weight": _w(H, MI),
                      p + "mlp.shared_expert_gate.weight": _w(1, H)})
    return hf, t


MOE_CASES = {
    "qwen3_moe": lambda: moe_hf(),
    # a mixed stack: layer 0 listed dense, then every second layer routed
    "qwen2_moe": lambda: moe_hf("Qwen2MoeForCausalLM", layers=4,
                                shared=True, bias=True, qk_norm=False,
                                mlp_only=(0,), sparse_step=2),
    "mixtral": lambda: moe_hf("MixtralForCausalLM", qk_norm=False),
}


def test_config_and_layer_mask_match_jax():
    for case, make in MOE_CASES.items():
        hf, _ = make()
        cfg, jcfg = gt.from_hf_config(hf), jfrom_hf(hf)
        cfg.check_supported()
        assert get_model_def(cfg).family == "moe"
        assert moe.moe_layer_mask(cfg) == jmoe.moe_layer_mask(jcfg), case
        for f in ("num_experts", "num_experts_per_tok",
                  "moe_intermediate_size", "norm_topk_prob",
                  "decoder_sparse_step", "mlp_only_layers",
                  "shared_expert_intermediate_size", "attention_bias",
                  "qk_norm"):
            assert getattr(cfg, f) == getattr(jcfg, f), (case, f)
    hf, _ = MOE_CASES["qwen2_moe"]()
    assert moe.moe_layer_mask(gt.from_hf_config(hf)) == (False, True,
                                                         False, True)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_loaded_params_equal_jax_loader(tmp_path, case, pairing):
    got = check_against_jax(tmp_path, case, *PAIRINGS[pairing],
                            cases=MOE_CASES)
    assert "moe_mask" not in got["layers"]
    # a mixed stack carries both MLP variants on every layer, as JAX's
    assert ("gate_up_proj" in got["layers"]) == (case == "qwen2_moe")


@pytest.mark.parametrize("case", ["qwen2_moe", "mixtral"])
def test_greedy_streams_from_a_checkpoint_equal_jax(tmp_path, case):
    port = check_streams(tmp_path, case, cases=MOE_CASES, layout="single")
    assert port.runner.model.family == "moe"


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_convert_carries_moe_params_both_ways(case):
    """Weights in the layout of JAX's MoE ``init_params`` carried across:
    ``from_jax_params`` drops a mixed stack's bool ``moe_mask``,
    ``to_jax_params`` gives it back (every other leaf equal), and the
    port's own dummy init has the same layout."""
    hf, _ = MOE_CASES[case]()
    cfg, jcfg = gt.from_hf_config(hf), jfrom_hf(hf)
    rng = np.random.default_rng(4)
    np_params = jax.tree.map(
        lambda s: (np.asarray(jmoe.moe_layer_mask(jcfg)) if s.dtype == bool
                   else rng.standard_normal(s.shape).astype(s.dtype)),
        jax.eval_shape(lambda: jmoe.init_params(jcfg, dtype=jnp.float32)))
    mixed = case == "qwen2_moe"
    assert ("moe_mask" in np_params["layers"]) == mixed
    params = convert.from_jax_params(np_params)
    assert "moe_mask" not in params["layers"]
    back = convert.to_jax_params(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    mine = moe.init_params(cfg, 0, torch.float32, "cpu")
    assert {k: v.shape for k, v in mine["layers"].items()} == \
        {k: v.shape for k, v in params["layers"].items()}


def test_dummy_init_carried_by_convert_equals_jax():
    """JAX's dummy Qwen3-MoE weights carried across serve the same greedy
    streams as JAX's engine on them."""
    hf, _ = MOE_CASES["qwen3_moe"]()
    cfg, jcfg = gt.from_hf_config(hf), jfrom_hf(hf)
    jp = jmoe.init_params(jcfg, seed=3, dtype=jnp.float32)
    params = convert.from_jax_params(jax.tree.map(np.asarray, jp))

    kw = dict(dtype="float32", max_model_len=64)
    port = gt.LLM(config=gt.EngineConfig(
        **kw, scheduler=gt.SchedulerConfig(max_prefill_tokens=32),
        cache=gt.CacheConfig(page_size=4, num_pages=64)), model_cfg=cfg,
        params=params, device="cpu")
    ref = JLLM(config=JEC(**kw, attention_impl="xla",
                          scheduler=JSC(max_prefill_tokens=32),
                          cache=JCC(page_size=4, num_pages=64)),
               model_cfg=jcfg, params=jp)
    assert streams(port, gt.SamplingParams) == streams(ref, JSP)
