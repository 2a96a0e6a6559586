"""Checkpoints on the CPU: the port's safetensors reader against
``safetensors.safe_open`` bit for bit; the port's loader against the JAX
package's on the same files (``from_jax_params`` of JAX's loaded pytree
equal to the port's loaded parameters exactly, for every rule set, from
bf16 and float32 files, single, sharded with an index, and ``.bin``);
greedy float32 streams of the port's ``LLM`` and JAX's, both loading the
same directory with ``load_format="auto"``; the tokenizer rule (a
WordLevel tokenizer saved beside a checkpoint, text in and out, the
server's ``--tokenizer``); and that a checkpoint load imports no jax.

Each test writes its checkpoint from seeded numpy weights, named as the
HF checkpoints name them."""

import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors import safe_open
from safetensors.torch import save_file

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models import hybrid as jhybrid, loader as jloader
from gllm_tpu.models.config import from_hf_config as jfrom_hf
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert, loader
from gllm_tpu_torch.models.registry import get_model_def
from gllm_tpu_torch.models.safetensors_reader import SafetensorsFile

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

# tiny widths shared by the families
V, H, HQ, HKV, D, I = 96, 32, 4, 2, 8, 48


def _w(out, inp):
    return ("w", (out, inp))


def dense_hf(arch="LlamaForCausalLM", layers=2, tied=False, bias=False,
             qk_norm=False, glm4=False, **extra):
    """(config.json dict, {tensor name: shape spec}) of a dense model."""
    hf = dict(architectures=[arch], vocab_size=V, hidden_size=H,
              num_hidden_layers=layers, num_attention_heads=HQ,
              num_key_value_heads=HKV, head_dim=D, intermediate_size=I,
              max_position_embeddings=128, rope_theta=10000.0,
              rms_norm_eps=1e-6, tie_word_embeddings=tied,
              attention_bias=bias, eos_token_id=V - 1, **extra)
    t = {"model.embed_tokens.weight": ("e", (V, H)),
         "model.norm.weight": ("n", (H,))}
    if not tied:
        t["lm_head.weight"] = _w(V, H)
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({p + "self_attn.q_proj.weight": _w(HQ * D, H),
                  p + "self_attn.k_proj.weight": _w(HKV * D, H),
                  p + "self_attn.v_proj.weight": _w(HKV * D, H),
                  p + "self_attn.o_proj.weight": _w(H, HQ * D),
                  p + "input_layernorm.weight": ("n", (H,)),
                  p + "post_attention_layernorm.weight": ("n", (H,))})
        if glm4:
            t[p + "mlp.gate_up_proj.weight"] = _w(2 * I, H)
            t[p + "post_self_attn_layernorm.weight"] = ("n", (H,))
            t[p + "post_mlp_layernorm.weight"] = ("n", (H,))
        else:
            t[p + "mlp.gate_proj.weight"] = _w(I, H)
            t[p + "mlp.up_proj.weight"] = _w(I, H)
        t[p + "mlp.down_proj.weight"] = _w(H, I)
        if bias:
            for n, w in (("q", HQ * D), ("k", HKV * D), ("v", HKV * D)):
                t[p + f"self_attn.{n}_proj.bias"] = ("b", (w,))
        if qk_norm:
            t[p + "self_attn.q_norm.weight"] = ("n", (D,))
            t[p + "self_attn.k_norm.weight"] = ("n", (D,))
    return hf, t


def chatglm_hf(layers=2):
    hf = dict(architectures=["ChatGLMModel"], padded_vocab_size=V,
              hidden_size=H, num_layers=layers, num_attention_heads=HQ,
              kv_channels=D, multi_query_attention=True,
              multi_query_group_num=HKV, ffn_hidden_size=I,
              layernorm_epsilon=1e-5, seq_length=128, add_qkv_bias=True,
              eos_token_id=V - 1)
    t = {"transformer.embedding.word_embeddings.weight": ("e", (V, H)),
         "transformer.encoder.final_layernorm.weight": ("n", (H,)),
         "transformer.output_layer.weight": _w(V, H)}
    qkv = (HQ + 2 * HKV) * D
    for i in range(layers):
        p = f"transformer.encoder.layers.{i}."
        t.update({p + "input_layernorm.weight": ("n", (H,)),
                  p + "post_attention_layernorm.weight": ("n", (H,)),
                  p + "self_attention.query_key_value.weight": _w(qkv, H),
                  p + "self_attention.query_key_value.bias": ("b", (qkv,)),
                  p + "self_attention.dense.weight": _w(H, HQ * D),
                  p + "mlp.dense_h_to_4h.weight": _w(2 * I, H),
                  p + "mlp.dense_4h_to_h.weight": _w(H, I)})
    return hf, t


# DeepSeek's MLA geometry and routing at tiny widths
NOPE, ROPE, LORA, VD, E, TOPK, MI = 8, 8, 16, 8, 8, 2, 16


def deepseek_hf(v3=False, layers=3):
    hf = dict(architectures=["DeepseekV3ForCausalLM" if v3
                             else "DeepseekV2ForCausalLM"],
              vocab_size=V, hidden_size=H, num_hidden_layers=layers,
              num_attention_heads=HQ, num_key_value_heads=HQ,
              q_lora_rank=24 if v3 else None, kv_lora_rank=LORA,
              qk_nope_head_dim=NOPE, qk_rope_head_dim=ROPE, v_head_dim=VD,
              intermediate_size=I, moe_intermediate_size=MI,
              n_routed_experts=E, num_experts_per_tok=TOPK,
              n_shared_experts=1, first_k_dense_replace=1,
              norm_topk_prob=v3, routed_scaling_factor=1.0,
              max_position_embeddings=128, rope_theta=10000.0,
              rms_norm_eps=1e-6, tie_word_embeddings=False,
              eos_token_id=V - 1)
    if v3:
        hf.update(topk_method="noaux_tc", scoring_func="sigmoid", n_group=2,
                  topk_group=1, routed_scaling_factor=2.5)
    t = {"model.embed_tokens.weight": ("e", (V, H)),
         "model.norm.weight": ("n", (H,)), "lm_head.weight": _w(V, H)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": ("n", (H,)),
                  p + "post_attention_layernorm.weight": ("n", (H,)),
                  p + "self_attn.kv_a_proj_with_mqa.weight":
                      _w(LORA + ROPE, H),
                  p + "self_attn.kv_a_layernorm.weight": ("n", (LORA,)),
                  p + "self_attn.kv_b_proj.weight": _w(HQ * (NOPE + VD), LORA),
                  p + "self_attn.o_proj.weight": _w(H, HQ * VD)})
        if v3:
            t.update({p + "self_attn.q_a_proj.weight": _w(24, H),
                      p + "self_attn.q_a_layernorm.weight": ("n", (24,)),
                      p + "self_attn.q_b_proj.weight":
                          _w(HQ * (NOPE + ROPE), 24)})
        else:
            t[p + "self_attn.q_proj.weight"] = _w(HQ * (NOPE + ROPE), H)
        if i == 0:
            t.update({p + "mlp.gate_proj.weight": _w(I, H),
                      p + "mlp.up_proj.weight": _w(I, H),
                      p + "mlp.down_proj.weight": _w(H, I)})
            continue
        t[p + "mlp.gate.weight"] = _w(E, H)
        if v3:
            t[p + "mlp.gate.e_score_correction_bias"] = ("b", (E,))
        for e in range(E):
            q = p + f"mlp.experts.{e}."
            t.update({q + "gate_proj.weight": _w(MI, H),
                      q + "up_proj.weight": _w(MI, H),
                      q + "down_proj.weight": _w(H, MI)})
        for n, s in (("gate", _w(MI, H)), ("up", _w(MI, H)),
                     ("down", _w(H, MI))):
            t[p + f"mlp.shared_experts.{n}_proj.weight"] = s
    return hf, t


# Qwen3-Next at tiny widths: one period (three GDN layers, one full)
NK, NV, DK, DV, CK = 2, 4, 8, 8, 4


def qwen3_next_hf(layers=4):
    types = ["full_attention" if (i + 1) % 4 == 0 else "linear_attention"
             for i in range(layers)]
    hf = dict(architectures=["Qwen3NextForCausalLM"], vocab_size=V,
              hidden_size=H, num_hidden_layers=layers,
              num_attention_heads=HQ, num_key_value_heads=HKV, head_dim=D,
              partial_rotary_factor=0.5, rope_theta=10000.0,
              rms_norm_eps=1e-6, max_position_embeddings=128,
              layer_types=types, linear_num_key_heads=NK,
              linear_num_value_heads=NV, linear_key_head_dim=DK,
              linear_value_head_dim=DV, linear_conv_kernel_dim=CK,
              num_experts=E, num_experts_per_tok=TOPK, norm_topk_prob=True,
              moe_intermediate_size=MI, shared_expert_intermediate_size=MI,
              intermediate_size=I, tie_word_embeddings=False,
              eos_token_id=V - 1)
    conv = 2 * NK * DK + NV * DV
    t = {"model.embed_tokens.weight": ("e", (V, H)),
         "model.norm.weight": ("z", (H,)), "lm_head.weight": _w(V, H)}
    for i, kind in enumerate(types):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": ("z", (H,)),
                  p + "post_attention_layernorm.weight": ("z", (H,)),
                  p + "mlp.gate.weight": _w(E, H),
                  p + "mlp.shared_expert.gate_proj.weight": _w(MI, H),
                  p + "mlp.shared_expert.up_proj.weight": _w(MI, H),
                  p + "mlp.shared_expert.down_proj.weight": _w(H, MI),
                  p + "mlp.shared_expert_gate.weight": _w(1, H)})
        for e in range(E):
            q = p + f"mlp.experts.{e}."
            t.update({q + "gate_proj.weight": _w(MI, H),
                      q + "up_proj.weight": _w(MI, H),
                      q + "down_proj.weight": _w(H, MI)})
        if kind == "full_attention":
            t.update({p + "self_attn.q_proj.weight": _w(2 * HQ * D, H),
                      p + "self_attn.k_proj.weight": _w(HKV * D, H),
                      p + "self_attn.v_proj.weight": _w(HKV * D, H),
                      p + "self_attn.o_proj.weight": _w(H, HQ * D),
                      p + "self_attn.q_norm.weight": ("z", (D,)),
                      p + "self_attn.k_norm.weight": ("z", (D,))})
        else:
            q = p + "linear_attn."
            t.update({q + "in_proj_qkvz.weight":
                          _w(2 * NK * DK + 2 * NV * DV, H),
                      q + "in_proj_ba.weight": _w(2 * NV, H),
                      q + "conv1d.weight": ("c", (conv, 1, CK)),
                      q + "dt_bias": ("b", (NV,)),
                      q + "A_log": ("b", (NV,)),
                      q + "norm.weight": ("n", (DV,)),
                      q + "out_proj.weight": _w(H, NV * DV)})
    return hf, t


def draw(spec, seed):
    """Seeded float32 values for each tensor of ``spec``: projections
    scaled by their fan-in, norms about 1 (about 0 for the zero-centred
    ones, "z"), biases and embeddings as drawn."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (kind, shape) in spec.items():
        x = rng.standard_normal(shape).astype(np.float32)
        if kind == "w":
            x *= shape[-1] ** -0.5
        elif kind == "n":
            x = 1.0 + 0.1 * x
        elif kind in ("z", "b"):
            x *= 0.1
        elif kind == "c":
            x *= shape[-1] ** -0.5
        out[name] = x
    return out


def write_checkpoint(path, hf, values, file_dtype="bf16", layout="single"):
    """``config.json`` and the weights of ``values`` in ``file_dtype``
    (bf16 or f32): one ``model.safetensors``, two shards with an index
    ("sharded"), or one ``pytorch_model.bin`` ("bin")."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf))
    dt = torch.bfloat16 if file_dtype == "bf16" else torch.float32
    ts = {n: torch.from_numpy(x).to(dt).contiguous()
          for n, x in values.items()}
    if layout == "bin":
        torch.save(ts, path / "pytorch_model.bin")
    elif layout == "single":
        save_file(ts, str(path / "model.safetensors"),
                  metadata={"format": "pt"})
    else:
        names = sorted(ts)
        shards = {"model-00001-of-00002.safetensors": names[::2],
                  "model-00002-of-00002.safetensors": names[1::2]}
        weight_map = {}
        for fname, part in shards.items():
            save_file({n: ts[n] for n in part}, str(path / fname),
                      metadata={"format": "pt"})
            weight_map.update({n: fname for n in part})
        (path / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": 0}, "weight_map": weight_map}))
    return path


CASES = {
    "llama_tied": lambda: dense_hf(tied=True),
    "llama": lambda: dense_hf(),
    "qwen2": lambda: dense_hf("Qwen2ForCausalLM", bias=True),
    "qwen3": lambda: dense_hf("Qwen3ForCausalLM", qk_norm=True),
    "glm4": lambda: dense_hf("Glm4ForCausalLM", glm4=True, bias=True,
                             partial_rotary_factor=0.5),
    "chatglm3": chatglm_hf,
    "deepseek_v2": lambda: deepseek_hf(),
    "deepseek_v3": lambda: deepseek_hf(v3=True),
    "qwen3_next": qwen3_next_hf,
}


def jax_load(path, hf, dtype):
    """The JAX package's loader on ``path`` (its family's loader, as its
    registry picks it) as numpy leaves."""
    jcfg = jfrom_hf(hf)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    arch = jcfg.architecture
    if arch.startswith("Deepseek"):
        params = jloader.load_deepseek_params(str(path), jcfg, dtype=jdt)
    elif arch.startswith("Qwen3Next"):
        params = jhybrid.load_params(str(path), jcfg, dtype=jdt)
    elif arch in ("MixtralForCausalLM", "Qwen2MoeForCausalLM",
                  "Qwen3MoeForCausalLM"):
        params = jloader.load_moe_params(str(path), jcfg, dtype=jdt)
    else:
        params = jloader.load_dense_params(str(path), jcfg, dtype=jdt)
    return jax.tree.map(np.asarray, params)


def port_load(path, hf, dtype):
    cfg = gt.from_hf_config(hf)
    cfg.check_supported()
    return get_model_def(cfg).load_params(str(path), cfg, dtype, "cpu")


def assert_same_params(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_same_params(g, w)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                           w.dtype)
        assert torch.equal(g, w), k


def check_against_jax(tmp_path, case, file_dtype, layout, dtype,
                      cases=CASES):
    hf, spec = cases[case]()
    path = write_checkpoint(tmp_path / case, hf, draw(spec, 1), file_dtype,
                            layout)
    got, stats = port_load(path, hf, dtype)
    want = convert.from_jax_params(jax_load(path, hf, dtype), dtype)
    assert_same_params(got, want)
    assert stats["tensors"] == len(spec) and stats["unwritten"] == []
    return got


# (file dtype, layout, model dtype): bf16 and float32 files, single and
# sharded, loaded at float32 and at bf16
PAIRINGS = {"bf16-single-f32": ("bf16", "single", torch.float32),
            "f32-sharded-bf16": ("f32", "sharded", torch.bfloat16),
            "bf16-sharded-bf16": ("bf16", "sharded", torch.bfloat16),
            "f32-single-f32": ("f32", "single", torch.float32)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_loaded_params_equal_jax_loader(tmp_path, case, pairing):
    check_against_jax(tmp_path, case, *PAIRINGS[pairing])


def test_bin_checkpoint_equals_jax_loader(tmp_path):
    check_against_jax(tmp_path, "qwen2", "bf16", "bin", torch.float32)


def test_reader_equals_safe_open_for_every_dtype(tmp_path):
    g = torch.Generator().manual_seed(0)
    ts = {
        "bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "f16": torch.randn(7, generator=g).half(),
        "f32": torch.randn(2, 3, 4, generator=g),
        "f64": torch.randn(4, generator=g, dtype=torch.float64),
        "i8": torch.randint(-128, 127, (9,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 255, (3, 3), generator=g, dtype=torch.uint8),
        "i16": torch.randint(-999, 999, (5,), generator=g,
                             dtype=torch.int16),
        "i32": torch.randint(-2**30, 2**30, (6,), generator=g,
                             dtype=torch.int32),
        "i64": torch.randint(-2**40, 2**40, (2, 2), generator=g,
                             dtype=torch.int64),
        "bool": torch.rand(11, generator=g) > 0.5,
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(3.5),
    }
    f = tmp_path / "x.safetensors"
    save_file(ts, str(f), metadata={"format": "pt", "k": "v"})
    out = torch.empty(1024, dtype=torch.uint8)
    with SafetensorsFile(str(f)) as mine, \
            safe_open(str(f), framework="pt") as ref:
        assert mine.metadata == ref.metadata()
        assert sorted(mine.keys()) == sorted(ref.keys())
        for name in ref.keys():
            want = ref.get_tensor(name)
            for got in (mine.get_tensor(name),
                        mine.get_tensor(name, out=out)):
                assert got.dtype == want.dtype and got.shape == want.shape
                if want.numel():
                    assert torch.equal(got.reshape(-1).view(torch.uint8),
                                       want.reshape(-1).view(torch.uint8)), \
                        name


def test_reader_refuses_fp8_and_imports_no_safetensors(tmp_path):
    f = tmp_path / "x.safetensors"
    save_file({"w": torch.zeros(4, dtype=torch.float8_e4m3fn)}, str(f))
    with SafetensorsFile(str(f)) as mine:
        with pytest.raises(NotImplementedError, match="F8_E4M3"):
            mine.get_tensor("w")
    src = (REPO / "gllm_tpu_torch" / "models"
           / "safetensors_reader.py").read_text()
    assert "import safetensors" not in src and "from safetensors" not in src


def test_checkpoint_search_order_and_missing(tmp_path):
    hf, spec = dense_hf(layers=1)
    values = draw(spec, 2)
    d = write_checkpoint(tmp_path / "m", hf, values, "f32", "sharded")
    # a stray single file beside an index: the index wins, as in JAX
    save_file({"model.norm.weight": torch.full((H,), 7.0)},
              str(d / "model.safetensors"))
    lazy = loader.LazySafetensors(str(d))
    assert set(lazy.names()) == set(spec)
    assert torch.equal(lazy.get("model.norm.weight"),
                       torch.from_numpy(values["model.norm.weight"]))
    lazy.close()
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        loader.LazySafetensors(str(empty))
    with pytest.raises(ValueError, match="allow-hub-download"):
        loader.resolve_model_path("org/not-a-directory")
    assert loader.resolve_model_path(str(d)) == str(d)


def test_depth_cut_skips_later_layers(tmp_path):
    """A config with fewer layers than the checkpoint reads its own layers
    only (the rules' stage check), as JAX's loader does."""
    hf, spec = dense_hf(layers=3)
    d = write_checkpoint(tmp_path / "m", hf, draw(spec, 3), "bf16")
    cut = dict(hf, num_hidden_layers=2)
    got, stats = port_load(d, cut, torch.float32)
    want = convert.from_jax_params(jax_load(d, cut, torch.float32))
    assert_same_params(got, want)
    assert stats["tensors"] == len(spec) - 9


def test_dsa_indexer_and_quantization_stay_refused(tmp_path):
    hf, spec = deepseek_hf(layers=2)
    spec["model.layers.1.self_attn.indexer.wk.weight"] = _w(8, H)
    d = write_checkpoint(tmp_path / "m", hf, draw(spec, 4), "bf16")
    with pytest.raises(NotImplementedError, match="A 11"):
        port_load(d, hf, torch.float32)
    with pytest.raises(NotImplementedError, match="A 11"):
        gt.from_hf_config(dict(hf, index_topk=8, index_n_heads=2,
                               index_head_dim=8)).check_supported()
    with pytest.raises(NotImplementedError, match="A 10"):
        gt.EngineConfig(quantization="int8").validate()


# ---- the engines: greedy float32 streams from the same directory -------

PROMPTS = [[5, 17, 33, 2, 9, 41, 8], [3, 60, 12], [7, 7, 21, 50, 11]]
MAX_TOKENS = [6, 9, 4]


def port_engine(path, **kw):
    cfg = gt.EngineConfig(
        model=str(path), load_format="auto", dtype="float32",
        max_model_len=64, scheduler=gt.SchedulerConfig(max_prefill_tokens=32),
        cache=gt.CacheConfig(page_size=4, num_pages=64), **kw)
    return gt.LLM(config=cfg, device="cpu")


def jax_engine(path, **kw):
    cfg = JEC(model=str(path), load_format="auto", dtype="float32",
              attention_impl="xla", max_model_len=64,
              scheduler=JSC(max_prefill_tokens=32),
              cache=JCC(page_size=4, num_pages=64), **kw)
    return JLLM(config=cfg)


def streams(llm, SP, prompts=PROMPTS):
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=[
        SP(temperature=0.0, max_tokens=m, ignore_eos=True)
        for m in MAX_TOKENS])
    return [list(o.output_token_ids) for o in outs]


def check_streams(tmp_path, case, cases=CASES, layout="sharded"):
    hf, spec = cases[case]()
    path = write_checkpoint(tmp_path / case, hf, draw(spec, 5), "bf16",
                            layout)
    port = port_engine(path)
    assert port.runner.load_stats["unwritten"] == []
    got = streams(port, gt.SamplingParams)
    want = streams(jax_engine(path), JSP)
    assert got == want
    assert len({t for s in got for t in s}) > 2, got
    return port


@pytest.mark.parametrize("case", ["qwen3", "deepseek_v3", "qwen3_next"])
def test_greedy_streams_from_a_checkpoint_equal_jax(tmp_path, case):
    check_streams(tmp_path, case)


# ---- the tokenizer ---------------------------------------------------------

WORDS = ["<unk>", "<eos>"] + [f"w{i}" for i in range(V - 2)]


def save_tokenizer(path):
    """A WordLevel tokenizer over ``WORDS`` (ids 0..V-1), built offline
    with ``tokenizers`` and saved as the transformers files."""
    from tokenizers import Tokenizer, models, pre_tokenizers, decoders
    from transformers import PreTrainedTokenizerFast
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.decoder = decoders.WordPiece(prefix="##")
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                   eos_token="<eos>")
    fast.save_pretrained(str(path))


def test_tokenizer_rule_text_prompts_match_jax(tmp_path):
    hf, spec = dense_hf()
    path = write_checkpoint(tmp_path / "m", hf, draw(spec, 6), "f32",
                            "single")
    save_tokenizer(path)
    port, ref = port_engine(path), jax_engine(path)
    text = "w3 w17 w40 w5 w9"
    assert port.tokenizer is not None
    ids = list(port.tokenizer.encode(text))
    assert ids == list(ref.tokenizer.encode(text)) == [5, 19, 42, 7, 11]
    sp = dict(temperature=0.0, max_tokens=5, ignore_eos=True)
    got = port.generate([text], gt.SamplingParams(**sp))[0]
    want = ref.generate([text], JSP(**sp))[0]
    assert got.output_token_ids == want.output_token_ids
    assert got.text == want.text and got.text
    # no tokenizer files: token ids in and out, as in JAX
    bare = write_checkpoint(tmp_path / "bare", hf, draw(spec, 6), "f32")
    assert port_engine(bare).tokenizer is None


def test_server_serves_text_with_tokenizer_flag(tmp_path):
    from gllm_tpu_torch.entrypoints import api_server as tapi
    hf, spec = dense_hf()
    path = write_checkpoint(tmp_path / "m", hf, draw(spec, 7), "bf16",
                            "sharded")
    tok_dir = tmp_path / "tok"
    save_tokenizer(tok_dir)
    args = tapi.make_parser().parse_args([
        "--model", str(path), "--tokenizer", str(tok_dir), "--device", "cpu",
        "--dtype", "float32", "--num-pages", "64", "--page-size", "4",
        "--max-model-len", "64", "--maxp", "32"])
    llm = gt.LLM(config=tapi.build_engine_config(args), device="cpu")
    assert llm.config.load_format == "auto" and llm.tokenizer is not None
    httpd = tapi.serve(llm, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        port = httpd.server_address[1]
        body = json.dumps({"prompt": "w1 w2 w3", "max_tokens": 4,
                           "temperature": 0.0, "ignore_eos": True}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["usage"]["completion_tokens"] == 4
        text = out["choices"][0]["text"]
        assert text.split() and all(w in WORDS for w in text.split())
        want = llm.tokenizer.decode(streams_of(llm, llm.tokenizer.encode(
            "w1 w2 w3")))
        assert text.split() == want.split()
    finally:
        httpd.state.engine.shutdown(drain=True)
        httpd.shutdown()
        httpd.server_close()


def streams_of(llm, ids):
    return llm.generate(prompt_token_ids=[list(ids)], sampling_params=(
        gt.SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True))
    )[0].output_token_ids


def test_checkpoint_load_imports_no_jax(tmp_path):
    hf, spec = dense_hf()
    path = write_checkpoint(tmp_path / "m", hf, draw(spec, 8), "bf16",
                            "sharded")
    save_tokenizer(path)
    # the load alone (no tokenizer asked for) imports no safetensors
    # either; transformers' tokenizer path may import it, never jax
    code = (
        "import sys\n"
        "import gllm_tpu_torch as gt\n"
        "def bad(names):\n"
        "    return [m for m in sys.modules if m.split('.')[0] in names]\n"
        "def llm(tok):\n"
        f"    cfg = gt.EngineConfig(model={str(path)!r}, dtype='float32',\n"
        "        tokenizer=tok, max_model_len=64,\n"
        "        cache=gt.CacheConfig(page_size=4, num_pages=32))\n"
        "    return gt.LLM(config=cfg, device='cpu')\n"
        "a = llm('')\n"
        "assert a.runner.load_stats['tensors'] > 0 and a.tokenizer is None\n"
        "out = a.generate(prompt_token_ids=[[3, 4]],\n"
        "                 sampling_params=gt.SamplingParams(max_tokens=3))\n"
        "assert out[0].num_output_tokens == 3\n"
        "assert not bad(('jax', 'gllm_tpu', 'safetensors')), bad(\n"
        "    ('jax', 'gllm_tpu', 'safetensors'))\n"
        "b = llm(None)\n"
        "assert b.tokenizer is not None\n"
        "out = b.generate(['w3 w4'], gt.SamplingParams(max_tokens=3))\n"
        "assert out[0].num_output_tokens == 3\n"
        "assert not bad(('jax', 'gllm_tpu')), bad(('jax', 'gllm_tpu'))\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
