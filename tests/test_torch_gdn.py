"""The hybrid Gated-DeltaNet family (Qwen3-Next) of the PyTorch port against
the JAX package, on the CPU at float32.

- ``ops/gdn.py`` against ``gllm_tpu.ops.gdn``: ``l2norm``,
  ``causal_conv1d``, ``recurrent_gated_delta_step``, ``rms_norm_gated``
  (atol 1e-5: one float32 op chain each), and ``chunk_gated_delta_rule``
  against JAX's ``impl="xla"`` and ``impl="pallas"`` (the scan kernel in
  interpret mode), atol 1e-4 (float32 products over chunks of up to 64
  rows and a chain of chunks).
- K3's plain version against ``gdn_chunk_scan(interpret=True)`` with a
  non-zero initial state and several chunks, rtol/atol 1e-4.
- One GDN layer with the port's real-row Qmax against JAX's token-bucket
  Qmax, the MoE block against ``moe_mlp``, and the whole model's logits,
  atol 1e-4 (parameters carried across by ``models/convert.py``).
- Greedy ``LLM.generate`` token-identical to the JAX ``LLM`` on a
  one-period tiny Qwen3-Next, with and without preemption; the SSM slot
  lifecycle; the options ``validate`` refuses with a hybrid model.
The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models import hybrid as jhy
from gllm_tpu.models import moe as jmoe
from gllm_tpu.models.config import from_hf_config as j_from_hf
from gllm_tpu.ops import gdn as jgdn
from gllm_tpu.ops.pallas.gdn_scan import gdn_chunk_scan as j_scan
from gllm_tpu.runner.prepare import BatchBuilder as JBuilder
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert
from gllm_tpu_torch.models import hybrid as thy
from gllm_tpu_torch.models import moe as tmoe
from gllm_tpu_torch.ops import gdn as tgdn
from gllm_tpu_torch.ops.cuda.gdn_scan import gdn_chunk_scan_plain
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging

from test_torch_engine import _drive
from test_torch_model import PAGE, PAGES, _batches

LIN, FULL = "linear_attention", "full_attention"
# one period of Qwen3-Next's pattern at small widths, with the sparse block
HF = dict(
    architectures=["Qwen3NextForCausalLM"], vocab_size=256, hidden_size=64,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, intermediate_size=96, max_position_embeddings=256,
    rms_norm_eps=1e-6, rope_theta=10000.0, partial_rotary_factor=0.25,
    tie_word_embeddings=False, eos_token_id=0,
    layer_types=[LIN, LIN, LIN, FULL], linear_num_value_heads=4,
    linear_num_key_heads=2, linear_key_head_dim=16,
    linear_value_head_dim=16, linear_conv_kernel_dim=4, num_experts=4,
    num_experts_per_tok=2, moe_intermediate_size=32,
    shared_expert_intermediate_size=48, norm_topk_prob=True)
SLOTS = 6            # slot pools of the layer tests: dummy 0, rows 1..4
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _configs(hf=HF):
    return j_from_hf(hf), gt.from_hf_config(hf)


def _jax_params(jmc, rng):
    """The JAX dummy init with random norms and decay parameters."""
    params = jax.tree.map(np.array, jhy.init_params(jmc, seed=5,
                                                    dtype=jnp.float32))
    for group in ("attn_layers", "gdn_layers", "mlp_layers"):
        for name, x in params[group].items():
            if "norm" in name or name in ("dt_bias", "a_log"):
                x[...] = 1.0 + 0.3 * rng.standard_normal(x.shape)
    params["final_norm"][...] = 1.0 + 0.3 * rng.standard_normal(
        params["final_norm"].shape)
    return params


# ---- ops ------------------------------------------------------------------

def test_config_parse_matches_jax():
    jmc, tmc = _configs()
    want = dataclasses.asdict(jmc)
    for name, value in dataclasses.asdict(tmc).items():
        assert value == want[name], name
    tmc.check_supported()
    assert (tmc.use_hybrid, tmc.num_attn_layers, tmc.num_linear_layers,
            tmc.gdn_conv_dim) == (True, 1, 3, 2 * 2 * 16 + 4 * 16)


@pytest.mark.parametrize("op", ["l2norm", "causal_conv1d", "recurrent_step",
                                "rms_norm_gated"])
def test_gdn_ops_match_jax(op):
    rng = np.random.default_rng(40)
    f32 = np.float32
    if op == "l2norm":
        x = rng.standard_normal((5, 3, 16)).astype(f32)
        args = (x,)
    elif op == "causal_conv1d":
        # rows of 7, 3, 0 and 9 real positions in a [4, 9] layout
        x = rng.standard_normal((4, 9, 24)).astype(f32)
        args = (x, rng.standard_normal((4, 24, 3)).astype(f32),
                rng.standard_normal((24, 4)).astype(f32),
                np.array([7, 3, 0, 9], np.int32))
    elif op == "recurrent_step":
        S, H, Dk, Dv = 3, 4, 16, 8
        args = (rng.standard_normal((S, H, Dk)).astype(f32),
                rng.standard_normal((S, H, Dk)).astype(f32),
                rng.standard_normal((S, H, Dv)).astype(f32),
                -rng.uniform(0.01, 1.0, (S, H)).astype(f32),
                rng.uniform(0.05, 0.95, (S, H)).astype(f32),
                rng.standard_normal((S, H, Dk, Dv)).astype(f32))
    else:
        args = (rng.standard_normal((6, 4, 16)).astype(f32),
                rng.standard_normal((6, 4, 16)).astype(f32),
                (1 + 0.3 * rng.standard_normal(16)).astype(f32))
    jfn = {"l2norm": jgdn.l2norm, "causal_conv1d": jgdn.causal_conv1d,
           "recurrent_step": jgdn.recurrent_gated_delta_step,
           "rms_norm_gated": jgdn.rms_norm_gated}[op]
    tfn = {"l2norm": tgdn.l2norm, "causal_conv1d": tgdn.causal_conv1d,
           "recurrent_step": tgdn.recurrent_gated_delta_step,
           "rms_norm_gated": tgdn.rms_norm_gated}[op]
    extra = (1e-6,) if op == "rms_norm_gated" else ()
    want = jfn(*_j(*args), *extra)
    got = tfn(*_t(*args), *extra)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def _gdn_inputs(rng, S, T, H, Dk, Dv, lens=None):
    f32 = np.float32
    q = rng.standard_normal((S, T, H, Dk)).astype(f32)
    k = rng.standard_normal((S, T, H, Dk)).astype(f32)
    v = rng.standard_normal((S, T, H, Dv)).astype(f32)
    g = -rng.uniform(0.01, 0.6, (S, T, H)).astype(f32)
    beta = rng.uniform(0.05, 0.95, (S, T, H)).astype(f32)
    if lens is not None:
        pad = np.arange(T)[None, :] >= np.asarray(lens)[:, None]
        g[pad] = 0.0
        beta[pad] = 0.0
    state = rng.standard_normal((S, H, Dk, Dv)).astype(f32)
    return q, k, v, g, beta, state


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("T,chunk,lens", [(37, 16, None), (150, 64, None),
                                          (70, 64, [70, 5, 33])])
def test_chunk_rule_matches_jax(impl, T, chunk, lens):
    rng = np.random.default_rng(41)
    S = 3 if lens else 2
    q, k, v, g, beta, state = _gdn_inputs(rng, S, T, 4, 16, 8, lens)
    want_o, want_s = jgdn.chunk_gated_delta_rule(
        *_j(q, k, v, g, beta), initial_state=jnp.asarray(state),
        chunk_size=chunk, impl=impl)
    got_o, got_s = tgdn.chunk_gated_delta_rule(
        *_t(q, k, v, g, beta), initial_state=torch.from_numpy(state),
        chunk_size=chunk)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_scan_plain_matches_pallas_interpret():
    rng = np.random.default_rng(42)
    B, N, C, Dk, Dv = 3, 4, 16, 32, 16
    f32 = np.float32
    qc, kc, kcd = (0.2 * rng.standard_normal((B, N, C, Dk))).astype(f32), \
        (0.2 * rng.standard_normal((B, N, C, Dk))).astype(f32), \
        (0.2 * rng.standard_normal((B, N, C, Dk))).astype(f32)
    v2 = rng.standard_normal((B, N, C, Dv)).astype(f32)
    attn = np.tril(0.2 * rng.standard_normal((B, N, C, C))).astype(f32)
    gcum = np.cumsum(-rng.uniform(0.0, 0.1, (B, N, C, 1)), axis=2).astype(f32)
    init = rng.standard_normal((B, Dk, Dv)).astype(f32)
    want_o, want_s = j_scan(*_j(qc, kc, v2, kcd, attn, gcum, init),
                            interpret=True)
    got_o, got_s = gdn_chunk_scan_plain(*_t(qc, kc, v2, kcd, attn, gcum,
                                            init))
    assert got_o.shape == (B, N, C, Dv) and got_s.shape == (B, Dk, Dv)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


# ---- model pieces ---------------------------------------------------------

def _step_inputs(rng, jmc):
    """One mixed batch built by both packages' builders (rows on SSM slots
    1..4), and a random K/V and random slot pools."""
    jbatch, tbatch = _batches()
    for batch in (jbatch, tbatch):
        for i, it in enumerate(batch.items):
            it.seq.ssm_slot = i + 1
    jcfg = JEC(max_model_len=128, scheduler=JSC(max_prefill_tokens=32),
               cache=JCC(page_size=PAGE))
    tcfg = gt.EngineConfig(max_model_len=128,
                           scheduler=gt.SchedulerConfig(max_prefill_tokens=32),
                           cache=gt.CacheConfig(page_size=PAGE))
    jsb, max_q, _ = JBuilder(jcfg, PAGE, use_ssm=True).build(
        jbatch, jax.random.key(0), device=False)
    tsb, tq = BatchBuilder(tcfg, PAGE, use_ssm=True).build(tbatch)
    assert tq == max_q == 32 and tsb.max_seq_q == 11 and tsb.num_seqs == 4
    kv_shape = (jmc.num_attn_layers, PAGES, PAGE, 2, 16)
    conv_shape, rec_shape = thy.ssm_shapes(gt.from_hf_config(HF), SLOTS)
    pools = [rng.standard_normal(s).astype(np.float32)
             for s in (kv_shape, kv_shape, conv_shape, rec_shape)]
    return jsb, HostStaging("cpu").upload(tsb), max_q, pools


def test_gdn_layer_real_row_qmax_matches_jax_bucket(monkeypatch):
    jmc, tmc = _configs()
    rng = np.random.default_rng(43)
    params = _jax_params(jmc, rng)
    jsb, batch, max_q, (_, _, conv, rec) = _step_inputs(rng, jmc)
    x = rng.standard_normal((batch.token_ids.shape[0], 64)).astype(
        np.float32)
    jlp = {k: v[1] for k, v in params["gdn_layers"].items()}
    want, want_conv, want_rec = jhy._gdn_layer(
        jlp, jnp.asarray(x), jsb, jnp.asarray(conv[1]), jnp.asarray(rec[1]),
        jmc, max_q_len=max_q)
    tlp = {k: v[1] for k, v in convert.from_jax_params(
        params)["gdn_layers"].items()}
    # the rows in one group of [4, 11] cells, and one row a group
    monkeypatch.setattr(thy, "GDN_MAX_CELLS", 11)
    grouped = thy._gdn_layer(tlp, torch.from_numpy(x), batch,
                             *_t(conv[1].copy(), rec[1].copy()), tmc,
                             max_q_len=max_q)
    monkeypatch.undo()
    tconv, trec = _t(conv[1].copy(), rec[1].copy())
    got = thy._gdn_layer(tlp, torch.from_numpy(x), batch, tconv, trec, tmc,
                         max_q_len=max_q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # per-row math: only the products' batch sizes differ
    np.testing.assert_allclose(grouped.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)
    # the rows' slots updated in place; the dummy slot 0 and the unused
    # slot 5 untouched (JAX writes its padded rows' state to slot 0)
    np.testing.assert_allclose(tconv.numpy()[1:5],
                               np.asarray(want_conv)[1:5], **TOL)
    np.testing.assert_allclose(trec.numpy()[1:5], np.asarray(want_rec)[1:5],
                               **TOL)
    np.testing.assert_array_equal(trec.numpy()[[0, 5]], rec[1][[0, 5]])


def test_moe_block_matches_jax():
    jmc, tmc = _configs()
    rng = np.random.default_rng(44)
    params = _jax_params(jmc, rng)
    x = rng.standard_normal((19, 64)).astype(np.float32)
    jlp = {k: v[0] for k, v in params["mlp_layers"].items()}
    tlp = {k: v[0] for k, v in convert.from_jax_params(
        params)["mlp_layers"].items()}
    want = jmoe.moe_mlp(jlp, jnp.asarray(x), jmc)
    got = tmoe.moe_mlp(tlp, torch.from_numpy(x), tmc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    w, ids = tmoe.select_experts(torch.from_numpy(x) @ tlp["router"], 2,
                                 True)
    jw, jid = jmoe.select_experts(jnp.asarray(x) @ jlp["router"], 2, True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jid))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense_mlp"])
def test_forward_and_logits_match_jax(moe):
    hf = HF if moe else dict(HF, num_experts=0)
    jmc, tmc = _configs(hf)
    rng = np.random.default_rng(45)
    params = _jax_params(jmc, rng)
    jsb, batch, max_q, pools = _step_inputs(rng, jmc)
    hidden, residual, jkv = jhy.forward(
        params, jhy.HybridKV(*_j(*pools)), jsb, jmc,
        cos_sin=jhy.make_rope_table(jmc), attn_impl="xla", max_q_len=max_q)
    want = np.asarray(jhy.compute_logits(params, hidden, residual, jsb, jmc))
    tparams = convert.from_jax_params(params)
    kv = thy.HybridKV(*_t(*[p.copy() for p in pools]))
    th, tr = thy.forward(tparams, kv, batch, tmc,
                         cos_sin=thy.make_rope_table(tmc), max_q_len=max_q)
    got = thy.compute_logits(tparams, th, tr, batch, tmc)
    assert got.shape == (8, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(kv.k.numpy(), np.asarray(jkv.k), **TOL)
    np.testing.assert_allclose(kv.rec.numpy()[:, 1:5],
                               np.asarray(jkv.rec)[:, 1:5], **TOL)
    back = convert.to_jax_params(tparams, tmc)
    for group in ("attn_layers", "gdn_layers", "mlp_layers"):
        assert back[group].keys() == params[group].keys()
        for name, x in params[group].items():
            np.testing.assert_array_equal(back[group][name], x)


# ---- the engine -----------------------------------------------------------

def _engines(num_pages, impl="xla", max_num_seqs=8):
    jmc, tmc = _configs(dict(HF, vocab_size=512))
    params = jhy.init_params(jmc, seed=3, dtype=jnp.float32)
    common = dict(dtype="float32", max_model_len=128,
                  max_num_seqs=max_num_seqs)
    jllm = JLLM(config=JEC(attention_impl=impl,
                           scheduler=JSC(max_prefill_tokens=16),
                           cache=JCC(page_size=4, num_pages=num_pages),
                           **common), model_cfg=jmc, params=params)
    tllm = gt.LLM(config=gt.EngineConfig(
        scheduler=gt.SchedulerConfig(max_prefill_tokens=16),
        cache=gt.CacheConfig(page_size=4, num_pages=num_pages), **common),
        model_cfg=tmc, params=convert.from_jax_params(
            jax.tree.map(np.asarray, params)), device="cpu")
    return jllm, tllm


@pytest.mark.parametrize("impl,pages", [("xla", 64), ("xla", 14),
                                        ("pallas", 64)],
                         ids=["xla", "xla_preempt", "pallas"])
def test_greedy_generate_token_identical_to_jax(impl, pages):
    rng = np.random.default_rng(46)
    lens = [5, 23, 9, 14, 3] if impl == "xla" else [5, 11, 3]
    prompts = [rng.integers(1, 512, n).tolist() for n in lens]
    max_tokens = [7, 9, 5, 8, 6][:len(lens)]
    ignore = [True] * len(lens)
    jllm, tllm = _engines(pages, impl)
    got = _drive(tllm, gt.SamplingParams, prompts, max_tokens, ignore)
    want = _drive(jllm, JSP, prompts, max_tokens, ignore)
    assert got == want
    mm = tllm.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total
    assert tllm.step_counts["mixed"] > 0 and tllm.step_counts["decode"] > 0
    assert (tllm.scheduler.num_preemptions > 0) == (pages == 14)


def test_ssm_slot_lifecycle():
    """Slots are taken at admission, capped by max_num_seqs, freed at the
    end (and on preemption), and every freed slot is zeroed before it is
    used again."""
    _, tllm = _engines(14, max_num_seqs=3)
    mm, runner = tllm.memory_manager, tllm.runner
    assert mm.ssm_alloc.num_total == 3
    assert runner.kv.conv.shape[1] == runner.kv.rec.shape[1] == 4
    rng = np.random.default_rng(47)
    prompts = [rng.integers(1, 512, n).tolist() for n in (9, 17, 6, 12, 4)]
    seqs = [tllm._allocate_seq(p, gt.SamplingParams(temperature=0.0,
                                                    max_tokens=6,
                                                    ignore_eos=True))
            for p in prompts]
    for s in seqs:
        tllm.add_seq(s)
    max_running = 0
    while tllm.has_unfinished:
        tllm.step()
        held = [s.ssm_slot for s in tllm.scheduler.running]
        assert None not in held and len(set(held)) == len(held)
        max_running = max(max_running, len(held))
    assert max_running == 3
    assert all(s.ssm_slot is None for s in seqs)
    assert mm.ssm_alloc.num_free == 3
    # slots freed before the last step were zeroed by a later step; the
    # last step's frees are pending, and their state is still there
    pending = sorted(mm.ssm_zero)
    assert pending and set(pending) <= {1, 2, 3}
    assert torch.count_nonzero(runner.kv.rec[:, pending]) > 0
    # they ride the next step's upload and are zeroed before its forward
    seq = tllm._allocate_seq([5, 6, 7], gt.SamplingParams(max_tokens=1))
    tllm.add_seq(seq)
    batch = tllm.scheduler.schedule_once()
    dev_batch, _ = runner.prepare(batch)
    assert sorted(dev_batch.ssm_zero.tolist()) == pending
    runner.forward_logits(dev_batch, 3)
    others = [s for s in (1, 2, 3) if s != seq.ssm_slot]
    assert torch.count_nonzero(runner.kv.rec[:, others]) == 0
    assert torch.count_nonzero(runner.kv.conv[:, others]) == 0
    assert torch.count_nonzero(runner.kv.rec[:, seq.ssm_slot]) > 0


@pytest.mark.parametrize("kw,match", [
    (dict(cache=gt.CacheConfig(kv_cache_dtype="int8")), "int8"),
    (dict(cache=gt.CacheConfig(enable_prefix_caching=True)),
     "enable_prefix_caching"),
    (dict(spec_decode="ngram"), "spec_decode"),
], ids=["kw0-int8", "kw2-enable_prefix_caching", "kw3-spec_decode"])
def test_validate_refuses_hybrid_combinations(kw, match):
    _, tmc = _configs()
    config = gt.EngineConfig(dtype="float32", **kw)
    with pytest.raises(NotImplementedError, match=match):
        config.validate(tmc)
    with pytest.raises(NotImplementedError, match=match):
        gt.LLM(model_cfg=tmc, config=config, device="cpu")
    # the dense model takes the same options
    gt.EngineConfig(dtype="float32", **kw).validate(
        gt.ModelConfig("LlamaForCausalLM", 256, 64, 2, 4, 2, 16, 96))


def test_validate_keeps_unified_step_inert_on_hybrid():
    """The unified step is taken on a hybrid model and left inert, as the
    JAX engine leaves it (``gllm_tpu/engine/llm.py:349-355``): the engine
    runs the legacy kernels and signatures."""
    _, tmc = _configs()
    config = gt.EngineConfig(dtype="float32", unified_step=True)
    config.validate(tmc)
    llm = gt.LLM(model_cfg=tmc, config=config, device="cpu")
    assert not llm.unified and llm.runner.attn_impl == "legacy"
    assert not llm.runner.builder.unified


def test_hybrid_refusals_of_the_config():
    with pytest.raises(NotImplementedError, match="layer_types"):
        gt.from_hf_config(dict(HF, num_hidden_layers=8)).check_supported()
    with pytest.raises(NotImplementedError, match="hybrid linear"):
        gt.from_hf_config(dict(HF, architectures=["LlamaForCausalLM"])
                          ).check_supported()
