"""DeepSeek (MLA latent cache + DeepSeekMoE) of the PyTorch port against the
JAX package, on the CPU at float32.

- The MLA modes' plain versions (K1m: ragged, K2m: decode, ``v_cache=None``)
  against the Pallas kernels in interpret mode, tolerance 2e-4 (the JAX
  kernel tests' own). The JAX latent is zero-padded to its 128-lane width
  (and q with it), the port's is not: the pad lanes add zero to every score.
- ``write_latent`` against the JAX scatter, ``deepseek_route`` (V2 greedy,
  V3 ``noaux_tc`` with a nonzero correction bias), one MLA layer and the
  whole model's first-step logits (atol 1e-4, parameters carried across by
  ``models/convert.py``).
- Greedy ``LLM.generate`` token-identical to the JAX ``LLM`` on ``xla`` and
  on ``pallas`` (interpret), with and without ``q_lora_rank``, through a
  preemption; the engine refuses an int8 latent and builds the unified
  step (its streams: tests/test_torch_fp8.py).
The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models import deepseek as jds
from gllm_tpu.models.config import from_hf_config as j_from_hf
from gllm_tpu.ops.pallas.decode_attention import paged_decode_attention
from gllm_tpu.ops.pallas.ragged_attention import ragged_paged_attention
from gllm_tpu.runner.prepare import BatchBuilder as JBuilder
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert
from gllm_tpu_torch.models import deepseek as tds
from gllm_tpu_torch.ops import attention as tattn
from gllm_tpu_torch.ops.cuda import decode_attention as tdec
from gllm_tpu_torch.ops.cuda import ragged_attention as trag
from gllm_tpu_torch.ops.cuda.common import check_mla_geometry
from gllm_tpu_torch.ops.kv_cache import write_latent
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging

from test_torch_cuda import decode_case, ragged_case
from test_torch_engine import _drive
from test_torch_model import PAGE, PAGES, _batches

# tests/test_deepseek.py's BASE geometry (vocab 256 for _batches' tokens)
BASE = dict(
    architectures=["DeepseekV2ForCausalLM"], vocab_size=256,
    hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, intermediate_size=96,
    max_position_embeddings=256, rms_norm_eps=1e-6, rope_theta=10000.0,
    tie_word_embeddings=False, eos_token_id=0, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
    first_k_dense_replace=1, n_shared_experts=1, moe_layer_freq=1,
    routed_scaling_factor=1.5)
V2 = dict(BASE, q_lora_rank=None, topk_method="greedy",
          scoring_func="softmax", norm_topk_prob=False)
V3 = dict(BASE, architectures=["DeepseekV3ForCausalLM"], q_lora_rank=48,
          n_group=4, topk_group=2, topk_method="noaux_tc",
          scoring_func="sigmoid", norm_topk_prob=True,
          rope_scaling={"type": "yarn", "factor": 2.0, "beta_fast": 32,
                        "beta_slow": 1, "mscale": 0.707,
                        "mscale_all_dim": 0.707,
                        "original_max_position_embeddings": 64})
LANES = 128          # the JAX latent row's padded width at this geometry
TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(hf):
    jmc, tmc = j_from_hf(hf), gt.from_hf_config(hf)
    assert tmc.mla_cache_width == 40 and jmc.mla_cache_width == LANES
    return jmc, tmc


def _pad(x, width=LANES):
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, width - x.shape[-1])])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_params(jmc, rng):
    """The JAX dummy init with random norms and routing bias, as numpy."""
    params = jax.tree.map(np.array, jds.init_params(jmc, seed=5,
                                                    dtype=jnp.float32))
    for group in ("dense_layers", "moe_layers"):
        for name, x in params[group].items():
            if "norm" in name:
                x[...] = 1.0 + 0.3 * rng.standard_normal(x.shape)
            elif name == "e_bias":
                x[...] = 0.1 * rng.standard_normal(x.shape)
    params["final_norm"][...] = 1.0 + 0.3 * rng.standard_normal(
        params["final_norm"].shape)
    return params


# ---- kernels: plain versions against the Pallas kernels (interpret) ------

MLA_RAGGED_CASES = {
    # prefill first, then decode rows, a chunk over cached context, padding
    "prefill_first": dict(seqs=[(6, 6), (1, 9), (1, 5), (9, 29), (1, 3)],
                          pad_seqs=2, pad_tokens=5),
    # contexts that end on a page boundary and a chunk that crosses one
    "page_boundary": dict(seqs=[(4, 8), (1, 16), (7, 12), (1, 4)],
                          pad_seqs=0, pad_tokens=3),
}


def _latent_case(rng, seqs, pad_seqs, pad_tokens, Hq=16, Dl=40, page=4,
                 pages=24):
    q, kc, _, cu, kvl, pt = ragged_case(rng, seqs, Hq, 1, Dl, page, pages,
                                        pad_seqs, pad_tokens)
    return q, kc, cu, kvl, pt


@pytest.mark.parametrize("name", sorted(MLA_RAGGED_CASES))
def test_mla_ragged_plain_matches_pallas_interpret(name):
    rng = np.random.default_rng(21)
    q, lat, cu, kvl, pt = _latent_case(rng, **MLA_RAGGED_CASES[name])
    scale = 24 ** -0.5
    want = ragged_paged_attention(
        jnp.asarray(_pad(q)), jnp.asarray(_pad(lat)), None, jnp.asarray(cu),
        jnp.asarray(kvl), jnp.asarray(pt), scale=scale, q_block=8,
        kv_block=16, interpret=True, v_dim=32)
    got = trag.ragged_paged_attention_plain(*_t(q, lat), None,
                                            *_t(cu, kvl, pt), scale=scale,
                                            v_dim=32)
    assert got.shape == (q.shape[0], 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_mla_decode_plain_matches_pallas_interpret():
    rng = np.random.default_rng(22)
    # a context ending on a page boundary, one key, a padded row
    q, kc, _, kvl, pt = decode_case(rng, [8, 1, 13, 0, 16], 16, 1, 40, 4, 24)
    scale = 24 ** -0.5
    want = paged_decode_attention(
        jnp.asarray(_pad(q)), jnp.asarray(_pad(kc)), None, jnp.asarray(kvl),
        jnp.asarray(pt), scale=scale, kv_block=32, interpret=True, v_dim=32)
    got = tdec.paged_decode_attention_plain(*_t(q, kc), None, *_t(kvl, pt),
                                            scale=scale, v_dim=32)
    assert got.shape == (5, 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_mla_dispatch_and_refusals():
    rng = np.random.default_rng(23)
    q, lat, cu, kvl, pt = _t(*_latent_case(rng, **MLA_RAGGED_CASES[
        "page_boundary"]))
    meta = tattn.AttentionMetadata(cu, kvl, pt)
    got = tattn.paged_attention(q, lat, None, meta, scale=0.2, max_q_len=7,
                                v_dim=32)
    want = trag.ragged_paged_attention_plain(q, lat, None, cu, kvl, pt,
                                             scale=0.2, v_dim=32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="v_dim"):
        tattn.paged_attention(q, lat, None, meta, scale=0.2, max_q_len=7)
    # the unified step takes a latent cache too (K1um's plain version)
    got = tattn.paged_attention(q, lat, None, meta, scale=0.2, max_q_len=7,
                                v_dim=32, impl="unified")
    want = trag.ragged_paged_attention_plain(q, lat, None, cu, kvl, pt,
                                             scale=0.2, v_dim=32,
                                             unified=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="int8"):
        tattn.paged_attention(q, lat, None, meta, scale=0.2, max_q_len=7,
                              v_dim=32, k_scale=torch.ones(24, 1),
                              v_scale=torch.ones(24, 1))
    # the MLA kernels take 16 query heads and two latent geometries
    check_mla_geometry(16, 576, 512)
    check_mla_geometry(16, 96, 64)
    with pytest.raises(NotImplementedError, match="128"):
        check_mla_geometry(128, 576, 512)          # DeepSeek-V3's heads
    with pytest.raises(NotImplementedError, match="640"):
        check_mla_geometry(16, 640, 512)


def test_write_latent_matches_jax_scatter():
    rng = np.random.default_rng(24)
    P, page, W = 6, 4, 40
    latent = rng.standard_normal((P, page, W)).astype(np.float32)
    rows = rng.standard_normal((7, W)).astype(np.float32)
    slots = np.array([5, 6, 7, 8, 13, 22, 0], np.int32)
    want = jnp.asarray(_pad(latent)).reshape(P * page, LANES).at[
        jnp.asarray(slots)].set(jnp.asarray(_pad(rows)))
    got = torch.from_numpy(latent.copy())
    write_latent(got, torch.from_numpy(rows), torch.from_numpy(slots))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want).reshape(P, page, LANES)[..., :W])


# ---- model pieces ---------------------------------------------------------

@pytest.mark.parametrize("hf", [V2, V3], ids=["v2_greedy", "v3_noaux_tc"])
def test_deepseek_route_matches_jax(hf):
    jmc, tmc = _configs(hf)
    rng = np.random.default_rng(25)
    logits = rng.standard_normal((19, 8)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(8)).astype(np.float32)
    use_bias = tmc.topk_method == "noaux_tc"
    jw, jid = jds.deepseek_route(jnp.asarray(logits),
                                 jnp.asarray(bias) if use_bias else None, jmc)
    tw, tid = tds.deepseek_route(torch.from_numpy(logits),
                                 torch.from_numpy(bias) if use_bias else None,
                                 tmc)
    jid, jw, tid, tw = (np.asarray(a) for a in (jid, jw, tid, tw))
    # the same experts with the same weights, in any order
    jo, to = np.argsort(jid, axis=1), np.argsort(tid, axis=1)
    np.testing.assert_array_equal(np.take_along_axis(tid, to, 1),
                                  np.take_along_axis(jid, jo, 1))
    np.testing.assert_allclose(np.take_along_axis(tw, to, 1),
                               np.take_along_axis(jw, jo, 1), rtol=1e-6,
                               atol=1e-6)
    if use_bias:
        # the bias moved some choice away from the plain top-k
        plain = np.sort(np.argsort(-logits, axis=1)[:, :2], axis=1)
        assert (np.sort(tid, axis=1) != plain).any()


def _step_inputs(jmc, rng):
    """One mixed batch (decode rows over cached context, chunks) built by
    both packages' batch builders, and a random pre-filled latent cache."""
    jbatch, tbatch = _batches()
    jcfg = JEC(max_model_len=128, scheduler=JSC(max_prefill_tokens=32),
               cache=JCC(page_size=PAGE))
    tcfg = gt.EngineConfig(max_model_len=128,
                           scheduler=gt.SchedulerConfig(max_prefill_tokens=32),
                           cache=gt.CacheConfig(page_size=PAGE))
    jsb, max_q, _ = JBuilder(jcfg, PAGE).build(jbatch, jax.random.key(0),
                                               device=False)
    tsb, tq = BatchBuilder(tcfg, PAGE).build(tbatch)
    assert tq == max_q > 1
    lat = rng.standard_normal((jmc.num_layers, PAGES, PAGE, 40)).astype(
        np.float32)
    return jsb, HostStaging("cpu").upload(tsb), max_q, lat


@pytest.mark.parametrize("hf", [V2, V3], ids=["v2", "v3"])
def test_mla_layer_matches_jax(hf):
    jmc, tmc = _configs(hf)
    rng = np.random.default_rng(26)
    params = _jax_params(jmc, rng)
    jsb, batch, max_q, lat = _step_inputs(jmc, rng)
    x = rng.standard_normal((batch.token_ids.shape[0], 64)).astype(
        np.float32)
    jlp = {k: v[0] for k, v in params["dense_layers"].items()}
    scale = 24 ** -0.5 * tds.yarn_softmax_scale_mult(tmc.rope_scaling)
    flat = _pad(lat[0])
    want, *_ = jds._mla_attention(
        jlp, jnp.asarray(x), jsb, jnp.asarray(flat), jmc,
        jds.make_rope_table(jmc), max_q_len=max_q, scale=scale)
    tlp = {k: v[0] for k, v in convert.from_jax_params(
        params)["dense_layers"].items()}
    cache = torch.from_numpy(lat[0].copy())
    got = tds._mla_attention(tlp, torch.from_numpy(x), batch, cache, tmc,
                             tds.make_rope_table(tmc), scale=scale,
                             max_q_len=max_q, li=0, impl="legacy")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.array_equal(cache.numpy(), lat[0])      # written in place


@pytest.mark.parametrize("hf", [V2, V3], ids=["v2", "v3"])
def test_forward_and_logits_match_jax(hf):
    jmc, tmc = _configs(hf)
    rng = np.random.default_rng(27)
    params = _jax_params(jmc, rng)
    jsb, batch, max_q, lat = _step_inputs(jmc, rng)
    hidden, residual, _ = jds.forward(
        params, jds.LatentKVCache(jnp.asarray(_pad(lat))), jsb, jmc,
        cos_sin=jds.make_rope_table(jmc), attn_impl="xla", max_q_len=max_q)
    want = np.asarray(jds.compute_logits(params, hidden, residual, jsb, jmc))
    tparams = convert.from_jax_params(params)
    assert tparams["moe_layers"]["w_gate_up"].shape == (2, 8, 64, 64)
    th, tr = tds.forward(tparams, tds.LatentKVCache(torch.from_numpy(lat)),
                         batch, tmc, cos_sin=tds.make_rope_table(tmc),
                         max_q_len=max_q)
    got = tds.compute_logits(tparams, th, tr, batch, tmc)
    assert got.shape == (8, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    back = convert.to_jax_params(tparams, tmc)
    for group in ("dense_layers", "moe_layers"):
        assert back[group].keys() == params[group].keys()
        for name, x in params[group].items():
            np.testing.assert_array_equal(back[group][name], x)


# ---- the engine -----------------------------------------------------------

def _engines(hf, impl, num_pages):
    jmc, tmc = _configs(dict(hf, vocab_size=512))
    params = jds.init_params(jmc, seed=3, dtype=jnp.float32)
    jllm = JLLM(config=JEC(dtype="float32", attention_impl=impl,
                           max_model_len=128,
                           scheduler=JSC(max_prefill_tokens=16),
                           cache=JCC(page_size=4, num_pages=num_pages)),
                model_cfg=jmc, params=params)
    tllm = gt.LLM(config=gt.EngineConfig(
        dtype="float32", max_model_len=128,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=16),
        cache=gt.CacheConfig(page_size=4, num_pages=num_pages)),
        model_cfg=tmc, params=convert.from_jax_params(
            jax.tree.map(np.asarray, params)), device="cpu")
    return jllm, tllm


@pytest.mark.parametrize("q_lora", [None, 48])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_greedy_generate_token_identical_to_jax(impl, q_lora):
    rng = np.random.default_rng(28)
    lens = [5, 23, 9, 14, 3] if impl == "xla" else [5, 11, 3]
    prompts = [rng.integers(1, 512, n).tolist() for n in lens]
    max_tokens = [7, 9, 5, 8, 6][:len(lens)]
    ignore = [True] * len(lens)
    # 14 pages of 4 tokens: the xla workload outgrows them and preempts
    pages = 14 if impl == "xla" else 64
    jllm, tllm = _engines(dict(V2, q_lora_rank=q_lora), impl, pages)
    got = _drive(tllm, gt.SamplingParams, prompts, max_tokens, ignore)
    want = _drive(jllm, JSP, prompts, max_tokens, ignore)
    assert got == want
    mm = tllm.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total
    assert tllm.step_counts["mixed"] > 0 and tllm.step_counts["decode"] > 0
    if impl == "xla":
        assert tllm.scheduler.num_preemptions > 0


def test_mla_engine_refuses_int8_and_builds_the_unified_step():
    _, tmc = _configs(V2)
    with pytest.raises(NotImplementedError, match="MLA"):
        gt.LLM(config=gt.EngineConfig(
            dtype="float32", cache=gt.CacheConfig(kv_cache_dtype="int8")),
            model_cfg=tmc, device="cpu")
    llm = gt.LLM(config=gt.EngineConfig(dtype="float32", unified_step=True,
                                        cache=gt.CacheConfig(num_pages=16)),
                 model_cfg=tmc, device="cpu")
    assert llm.runner.attn_impl == "unified"
