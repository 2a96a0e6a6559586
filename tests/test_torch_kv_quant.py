"""int8 KV cache of the PyTorch port against the JAX package's.

- ``write_kv_quant`` (running per-page, per-head absmax with
  rescale-on-grow) on the same numpy writes: the int8 bytes are identical
  and the scales bit-equal, through a first write, a grow, duplicate pages
  in one step and the zero-fill of a zero-scale page.
- The dense model over an int8 cache: one mixed batch's logits (atol 1e-4)
  and the caches and scales it writes.
- The engine: first-step logits (atol 1e-4 of the largest) and greedy
  streams identical to the JAX int8 engine's on the same carried float32
  weights; recycled pages quantize like fresh ones; the int8 cache gets at
  least 1.8x the pages of bf16 from one budget; the minted pages' scale
  resets ride the step's one upload.
The int8 kernels' plain versions are held to the Pallas kernels in
tests/test_torch_attention.py and tests/test_torch_unified.py, and the CUDA
kernels to their plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models import dense as jdense
from gllm_tpu.models.config import ModelConfig as JMC
from gllm_tpu.ops.kv_cache import write_kv_quant as j_write_kv_quant
from gllm_tpu.runner.prepare import BatchBuilder as JBuilder
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert, dense
from gllm_tpu_torch.ops.kv_cache import QMAX, write_kv_quant
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging
from gllm_tpu_torch.runner.runner import ModelRunner

from test_torch_engine import MODEL, _jax_params
from test_torch_model import BASE, PAGE, PAGES, _batches, \
    _perturbed_jax_params

P, PS, H, D = 9, 4, 2, 16
# (slots, row scale) of successive steps
WRITES = {
    "first_write": [(np.arange(4, 14), 1.0)],
    # a later, larger row grows pages 3 and 4: their rows are re-quantized
    "rescale_on_grow": [(np.arange(4, 14), 1.0),
                        (np.array([14, 15, 16, 17]), 6.0)],
    # one step writes several rows of each page, and padding rows all land
    # in the dummy page's slot 0
    "duplicate_pages": [(np.array([4, 5, 6, 7, 8, 0, 0, 0]), 1.0),
                        (np.array([9, 10, 8, 11, 0, 0]), 3.0)],
    # a page whose scale was reset to 0 (a minted page) zero-fills the
    # stale payload of its other slots on its first write
    "zero_scale_page": [(np.arange(4, 16), 2.0), "reset 2",
                        (np.array([9]), 0.5)],
}


@pytest.mark.parametrize("name", list(WRITES))
def test_write_kv_quant_matches_jax_bitwise(name):
    rng = np.random.default_rng(0)
    c = np.zeros((P, PS, H, D), np.int8)
    s = np.zeros((P, H), np.float32)
    jstate = [jnp.asarray(c), jnp.asarray(c), jnp.asarray(s),
              jnp.asarray(s)]
    tstate = [torch.from_numpy(c.copy()), torch.from_numpy(c.copy()),
              torch.from_numpy(s.copy()), torch.from_numpy(s.copy())]
    for step in WRITES[name]:
        if isinstance(step, str):          # the runner's scale reset
            page = int(step.split()[1])
            jstate[2] = jstate[2].at[page].set(0.0)
            jstate[3] = jstate[3].at[page].set(0.0)
            tstate[2][page] = 0.0
            tstate[3][page] = 0.0
            continue
        slots, mult = step
        k = (rng.standard_normal((len(slots), H, D)) * mult).astype(
            np.float32)
        v = (rng.standard_normal((len(slots), H, D)) * 2 * mult).astype(
            np.float32)
        jstate = list(j_write_kv_quant(
            *jstate, jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(slots.astype(np.int32)), PS))
        write_kv_quant(*tstate, torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(slots.astype(np.int32)))
        for want, got in zip(jstate[:2], tstate[:2]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for want, got in zip(jstate[2:], tstate[2:]):
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          np.asarray(want).view(np.int32))
    # the scales are the running absmax / QMAX of what each page holds
    kc, ks = tstate[0].numpy(), tstate[2].numpy()
    assert (np.abs(kc).max(axis=(1, 3)) <= QMAX).all()
    if name == "zero_scale_page":
        # page 2 holds only the new row (slot 9): its other slots are zero
        assert not kc[2, [0, 2, 3]].any() and kc[2, 1].any()
        assert ks[2].max() < ks[3].max()


def test_int8_forward_and_logits_match_jax():
    cfg = dict(BASE)
    rng = np.random.default_rng(2)
    np_params = _perturbed_jax_params(cfg, rng)
    shape = (cfg["num_layers"], PAGES, PAGE, cfg["num_kv_heads"],
             cfg["head_dim"])
    k0, v0 = (rng.integers(-127, 128, shape).astype(np.int8)
              for _ in range(2))
    ks0, vs0 = (rng.uniform(0.01, 0.05, shape[:2] + shape[3:4]).astype(
        np.float32) for _ in range(2))
    jbatch, tbatch = _batches()
    sched = dict(max_prefill_tokens=32)
    jsb, max_q, _ = JBuilder(JEC(max_model_len=128, scheduler=JSC(**sched),
                                 cache=JCC(page_size=PAGE)), PAGE).build(
        jbatch, jax.random.key(0), device=False)
    tsb, tq = BatchBuilder(gt.EngineConfig(
        max_model_len=128, scheduler=gt.SchedulerConfig(**sched),
        cache=gt.CacheConfig(page_size=PAGE)), PAGE).build(tbatch)
    jmc = JMC(**cfg, kv_cache_quant=True)
    hidden, residual, jkv = jdense.forward(
        np_params, jdense.KVCache(*map(jnp.asarray, (k0, v0, ks0, vs0))),
        jsb, jmc, cos_sin=jdense.make_rope_table(jmc), attn_impl="xla",
        max_q_len=max_q)
    want = np.asarray(jdense.compute_logits(np_params, hidden, residual,
                                            jsb, jmc))
    tmc = gt.ModelConfig(**cfg)
    kv = dense.KVCache(*(torch.from_numpy(a.copy())
                         for a in (k0, v0, ks0, vs0)))
    batch = HostStaging("cpu").upload(tsb)
    params = convert.from_jax_params(np_params)
    th, tr = dense.forward(params, kv, batch, tmc,
                           cos_sin=dense.make_rope_table(tmc), max_q_len=tq)
    got = dense.compute_logits(params, th, tr, batch, tmc)
    assert got.shape == (8, cfg["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the rows each writes: the same integers on the same grid (a value
    # whose float32 projection differs in the last bit may round to the
    # neighbouring integer, so at most one quantum apart)
    for mine, theirs in ((kv.k, jkv.k), (kv.v, jkv.v)):
        diff = np.abs(mine.numpy().astype(int) - np.asarray(theirs).astype(
            int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for mine, theirs in ((kv.k_scale, jkv.k_scale),
                         (kv.v_scale, jkv.v_scale)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-5)
    assert not np.array_equal(kv.k.numpy(), k0)      # written in place


def _port_llm(np_params, num_pages=64, prefix=False, kv="int8"):
    cfg = gt.EngineConfig(
        dtype="float32", max_model_len=128, max_num_seqs=8,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=32,
                                     max_decode_seqs=8),
        cache=gt.CacheConfig(page_size=4, num_pages=num_pages,
                             kv_cache_dtype=kv,
                             enable_prefix_caching=prefix))
    return gt.LLM(config=cfg, model_cfg=gt.ModelConfig(**MODEL),
                  params=convert.from_jax_params(np_params), device="cpu")


def _workload(seed=0, n=4, max_tokens=16):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 500, size=int(k)).tolist()
               for k in rng.integers(12, 28, size=n)]
    return prompts, max_tokens


def _gen(llm, prompts, max_tokens, SP=gt.SamplingParams):
    outs = llm.generate(prompt_token_ids=[list(p) for p in prompts],
                        sampling_params=[SP(temperature=0.0,
                                            max_tokens=max_tokens,
                                            ignore_eos=True)
                                         for _ in prompts])
    return [o.output_token_ids for o in outs]


def _jax_int8_llm(params, num_pages=64):
    cfg = JEC(dtype="float32", attention_impl="xla", max_model_len=128,
              max_num_seqs=8,
              scheduler=JSC(max_prefill_tokens=32, max_decode_seqs=8),
              cache=JCC(page_size=4, num_pages=num_pages,
                        kv_cache_dtype="int8"))
    return JLLM(config=cfg, model_cfg=JMC(**MODEL), params=params)


def test_int8_engine_first_step_logits_match_jax():
    """Both engines schedule the same first batch (chunked prefill of fresh
    prompts into an int8 cache); its logits agree to 1e-4 of the largest."""
    params = _jax_params()
    prompts, _ = _workload(n=5)
    port = _port_llm(jax.tree.map(np.asarray, params))
    jllm = _jax_int8_llm(params)
    batches = []
    for llm, SP in ((port, gt.SamplingParams), (jllm, JSP)):
        for p in prompts:
            llm.add_seq(llm._allocate_seq(list(p), SP(max_tokens=4)))
        batches.append(llm.scheduler.schedule_once())
    tbatch, jbatch = batches
    assert ([(it.seq.seq_id, it.num_new_tokens) for it in tbatch.items]
            == [(it.seq.seq_id, it.num_new_tokens) for it in jbatch.items])
    dev, max_q = port.runner.prepare(tbatch)
    got = port.runner.forward_logits(dev, max_q)[:tbatch.num_seqs]
    r = jllm.runner
    jsb, jq, _ = r.builder.build(jbatch, jax.random.key(0), device=False)
    hidden, residual, _ = jdense.forward(
        r.params, r.kv, jsb, r.model_cfg, cos_sin=r.cos_sin,
        attn_impl="xla", max_q_len=jq)
    want = np.asarray(jdense.compute_logits(r.params, hidden, residual, jsb,
                                            r.model_cfg))[:jbatch.num_seqs]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * scale)


def test_int8_engine_greedy_streams_equal_jax():
    params = _jax_params()
    np_params = jax.tree.map(np.asarray, params)
    prompts, max_tokens = _workload(n=5)
    port = _port_llm(np_params)
    got = _gen(port, prompts, max_tokens)
    want = _gen(_jax_int8_llm(params), prompts, max_tokens, JSP)
    assert got == want
    assert port.runner.kv.k.dtype == torch.int8
    assert port.step_counts["mixed"] > 0 and port.step_counts["decode"] > 0
    mm = port.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total
    # full precision gives other streams on this model: int8 is in use
    assert _gen(_port_llm(np_params, kv="auto"), prompts, max_tokens) != got


@pytest.mark.parametrize("prefix", [False, True])
def test_int8_recycled_pages_quantize_like_fresh(prefix):
    """After churn has recycled most of the pool, the same requests give
    the same streams as on a fresh engine: each minted page's scale is
    reset, so quantization never depends on page reuse. With prefix
    caching, re-minting a refcount-0 cached page must queue the reset
    too."""
    np_params = jax.tree.map(np.asarray, _jax_params())
    churn, _ = _workload(seed=9, n=4)
    prompts, _ = _workload(seed=3, n=2)
    llm = _port_llm(np_params, num_pages=48, prefix=prefix)
    _gen(llm, churn, 12)                  # fill and free most of the pool
    got = _gen(llm, prompts, 12)
    assert got == _gen(_port_llm(np_params, num_pages=48, prefix=prefix),
                       prompts, 12)
    assert not llm.memory_manager.scale_resets   # drained every step


def test_int8_gets_at_least_1_8x_the_pages_of_bf16():
    def runner(kv):
        cfg = gt.EngineConfig(dtype="bfloat16", load_format="dummy",
                              max_model_len=128,
                              cache=gt.CacheConfig(page_size=16,
                                                   num_pages=8,
                                                   kv_cache_dtype=kv))
        return ModelRunner(cfg, gt.ModelConfig(**MODEL), "cpu")

    bf16, q8 = runner("auto"), runner("int8")
    assert q8.kv.k.dtype == torch.int8
    assert q8.kv.k_scale.shape == (2, 8, MODEL["num_kv_heads"])
    budget = 1 << 30
    pages_bf16 = budget // bf16.kv_bytes_per_page()
    pages_q8 = budget // q8.kv_bytes_per_page()
    assert pages_q8 >= 1.8 * pages_bf16, (pages_bf16, pages_q8)


def test_scale_resets_ride_the_one_upload():
    llm = _port_llm(jax.tree.map(np.asarray, _jax_params()))
    llm.add_seq(llm._allocate_seq(list(range(1, 30)),
                                  gt.SamplingParams(max_tokens=2)))
    batch = llm.scheduler.schedule_once()
    minted = list(llm.memory_manager.scale_resets)
    assert minted == batch.items[0].seq.page_table
    llm.runner.kv.k_scale.fill_(1.0)
    dev, max_q = llm.runner.prepare(batch)
    assert dev.scale_resets.tolist() == minted
    assert not llm.memory_manager.scale_resets
    llm.runner.forward_logits(dev, max_q)
    ks = llm.runner.kv.k_scale
    # untouched pages keep theirs (page 0 takes the padding rows)
    others = [p for p in range(1, ks.shape[1]) if p not in minted]
    assert (ks[:, others] == 1.0).all()
    assert (ks[:, minted] > 0).all() and (ks[:, minted] < 1.0).all()
