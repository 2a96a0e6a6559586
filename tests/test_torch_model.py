"""Dense model of the PyTorch port against the JAX package's: the parameter
converter, and ``forward`` + ``compute_logits`` on one mixed batch (decode
rows over a pre-filled cache plus prefill chunks) at float32, atol 1e-4,
including the KV rows each writes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.models import dense as jdense
from gllm_tpu.models.config import ModelConfig as JMC
from gllm_tpu.models.config import from_hf_config as j_from_hf
from gllm_tpu.runner.prepare import BatchBuilder as JBuilder
from gllm_tpu.sampling_params import SamplingParams as JSP
from gllm_tpu.scheduler import ScheduledBatch as JBatch
from gllm_tpu.scheduler import ScheduledSeq as JItem
from gllm_tpu.sequence import Sequence as JSeq

from gllm_tpu_torch.config import (CacheConfig, EngineConfig,
                                   SchedulerConfig)
from gllm_tpu_torch.models import convert, dense
from gllm_tpu_torch.models.config import ModelConfig, from_hf_config
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging
from gllm_tpu_torch.sampling_params import SamplingParams
from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq
from gllm_tpu_torch.sequence import Sequence

BASE = dict(architecture="LlamaForCausalLM", vocab_size=256, hidden_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            intermediate_size=96, max_position=128)
VARIANTS = {
    "llama3": dict(rope_theta=500000.0, tie_word_embeddings=True,
                   rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                 "low_freq_factor": 1.0,
                                 "high_freq_factor": 4.0,
                                 "original_max_position_embeddings": 32}),
    "qwen_bias_qk_norm": dict(attention_bias=True, qk_norm=True),
    "glm4_sandwich": dict(sandwich_norms=True, rope_interleaved=True,
                          partial_rotary_factor=0.5),
}
PAGE, PAGES = 4, 24
# (num_new_tokens, computed_before, prompt_len): decode rows over context
# already in the cache, a chunk continuing a prompt, a fresh prompt
ITEMS = [(1, 9, 6), (1, 14, 14), (7, 8, 20), (11, 0, 11)]


def _perturbed_jax_params(cfg, rng):
    params = jax.tree.map(np.array, jdense.init_params(JMC(**cfg), seed=5,
                                                       dtype=jnp.float32))
    for name, x in params["layers"].items():
        if "norm" in name or "bias" in name:
            x[...] = rng.standard_normal(x.shape) * 0.3 + (
                1.0 if "norm" in name else 0.0)
    params["final_norm"][...] = 1.0 + 0.3 * rng.standard_normal(
        params["final_norm"].shape)
    return params


def _batches():
    jitems, titems = [], []
    nxt = 1
    for i, (n, before, plen) in enumerate(ITEMS):
        toks = [(7 * i + 3 * j) % 250 + 1 for j in range(max(plen,
                                                              before + n))]
        pages = list(range(nxt, nxt + -(-(before + n) // PAGE)))
        nxt = pages[-1] + 1
        for Seq, SP, Item, items in ((JSeq, JSP, JItem, jitems),
                                     (Sequence, SamplingParams, ScheduledSeq,
                                      titems)):
            seq = Seq(i, toks[:plen], SP(temperature=0.0))
            seq.token_ids = list(toks)
            seq.num_computed_tokens = before
            seq.page_table = list(pages)
            items.append(Item(seq, n, before))
    return JBatch(jitems), ScheduledBatch(titems)


@pytest.mark.parametrize("hf", [
    dict(architectures=["LlamaForCausalLM"], vocab_size=128256,
         hidden_size=2048, num_hidden_layers=16, num_attention_heads=32,
         num_key_value_heads=8, head_dim=64, intermediate_size=8192,
         rms_norm_eps=1e-5, rope_theta=500000.0,
         rope_scaling=VARIANTS["llama3"]["rope_scaling"],
         max_position_embeddings=131072, tie_word_embeddings=True,
         eos_token_id=[128001, 128008, 128009]),
    dict(architectures=["Qwen3ForCausalLM"], vocab_size=151936,
         hidden_size=1024, num_hidden_layers=28, num_attention_heads=16,
         num_key_value_heads=8, head_dim=128, intermediate_size=3072,
         eos_token_id=151645),
    dict(architectures=["Qwen2ForCausalLM"], vocab_size=1000,
         hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
         intermediate_size=96, attention_bias=False),
])
def test_from_hf_config_matches_jax(hf):
    got = dataclasses.asdict(from_hf_config(hf))
    want = dataclasses.asdict(j_from_hf(hf))
    for name, value in got.items():
        assert value == want[name], name
    from_hf_config(hf).check_supported()


def test_converter_round_trip():
    cfg = dict(BASE, attention_bias=True, qk_norm=True)
    np_params = _perturbed_jax_params(cfg, np.random.default_rng(0))
    params = convert.from_jax_params(np_params)
    assert params["layers"]["qkv_proj"].shape == (2, 64, (4 + 2 * 2) * 16)
    assert params["layers"]["gate_up_proj"].shape == (2, 64, 2 * 96)
    back = convert.to_jax_params(params, ModelConfig(**cfg))
    assert back["layers"].keys() == np_params["layers"].keys()
    for name, x in np_params["layers"].items():
        np.testing.assert_array_equal(back["layers"][name], x)
    np.testing.assert_array_equal(back["embed"], np_params["embed"])
    # [in, out] layout, used as x @ W on both sides
    x = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        (torch.from_numpy(x) @ params["layers"]["qkv_proj"][0])[:, :64],
        x @ np_params["layers"]["q_proj"][0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_logits_match_jax(variant):
    cfg = dict(BASE, **VARIANTS[variant])
    rng = np.random.default_rng(2)
    np_params = _perturbed_jax_params(cfg, rng)
    shape = (cfg["num_layers"], PAGES, PAGE, cfg["num_kv_heads"],
             cfg["head_dim"])
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)

    jbatch, tbatch = _batches()
    jcfg = JEC(max_model_len=128, scheduler=JSC(max_prefill_tokens=32),
               cache=JCC(page_size=PAGE))
    tcfg = EngineConfig(max_model_len=128,
                        scheduler=SchedulerConfig(max_prefill_tokens=32),
                        cache=CacheConfig(page_size=PAGE))
    jsb, max_q, _ = JBuilder(jcfg, PAGE).build(jbatch, jax.random.key(0),
                                               device=False)
    tsb, tq = BatchBuilder(tcfg, PAGE).build(tbatch)
    assert tq == max_q > 1

    jmc = JMC(**cfg)
    hidden, residual, jkv = jdense.forward(
        np_params, jdense.KVCache(jnp.asarray(k0), jnp.asarray(v0)), jsb,
        jmc, cos_sin=jdense.make_rope_table(jmc), attn_impl="xla",
        max_q_len=max_q)
    want = np.asarray(jdense.compute_logits(np_params, hidden, residual,
                                            jsb, jmc))

    tmc = ModelConfig(**cfg)
    kv = dense.KVCache(torch.from_numpy(k0.copy()),
                       torch.from_numpy(v0.copy()))
    batch = HostStaging("cpu").upload(tsb)
    th, tr = dense.forward(convert.from_jax_params(np_params), kv, batch,
                           tmc, cos_sin=dense.make_rope_table(tmc),
                           max_q_len=tq)
    got = dense.compute_logits(convert.from_jax_params(np_params), th, tr,
                               batch, tmc)
    assert got.shape == (8, cfg["vocab_size"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kv.k.numpy(), np.asarray(jkv.k), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(kv.v.numpy(), np.asarray(jkv.v), rtol=1e-4,
                               atol=1e-4)
    assert not np.array_equal(kv.k.numpy(), k0)      # written in place


@pytest.mark.parametrize("per_matrix", [True, False])
def test_dummy_draws_equal_per_unit_draws(per_matrix):
    """The dummy init's one float32 scratch (``models/dummy.py``) gives
    the values of a float32 draw per unit from the same generator, scaled
    and cast: the weights of every seed are those the init drew before."""
    from gllm_tpu_torch.models.dummy import DummyDraws
    draws = DummyDraws(7, torch.bfloat16, "cpu")
    shapes = [((3, 64, 96), 0.5), ((1000, 33), 2.0), ((2, 5, 8, 16), 1.0)]
    got = [draws.normal(shape, scale, per_matrix) for shape, scale in shapes]
    draws.draw()
    gen = torch.Generator()
    gen.manual_seed(7)
    for (shape, scale), out in zip(shapes, got):
        units = ([shape[-2:]] * (int(np.prod(shape)) // (shape[-2]
                                                          * shape[-1]))
                 if per_matrix else [shape])
        want = torch.cat([torch.randn(u, generator=gen).mul_(scale)
                          .to(torch.bfloat16).flatten() for u in units])
        assert torch.equal(out.flatten(), want)
