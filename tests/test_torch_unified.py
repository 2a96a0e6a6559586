"""The unified step of the PyTorch port against the JAX package's.

- The plain version of the unified kernel (K1u, AMLA softmax) against the
  Pallas kernel with ``unified=True`` in interpret mode, over a
  full-precision and an int8 cache, on decode-only, mixed, prefill-first
  and padded-tail batches, at 2e-3 (the tolerance of
  tests/test_unified_step.py: AMLA changes only the normalizer split). All
  cases share one geometry, so the Pallas kernel compiles once per cache
  type.
- The decode-prefix derivation and the batch builder's one signature
  family, on the JAX tests' cases.
- The unified sync engine: greedy streams identical to the port's flag-off
  engine and to the JAX package's unified sync engine, on the same
  carried float32 weights.
The CUDA kernel is held against the plain version on the card in
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
from gllm_tpu.models.config import ModelConfig as JMC
from gllm_tpu.ops.pallas.ragged_attention import (_decode_prefix_len,
                                                  ragged_paged_attention)
from gllm_tpu.runner.prepare import BatchBuilder as JBuilder
from gllm_tpu.sampling_params import SamplingParams as JSP
from gllm_tpu.scheduler import (ScheduledBatch as JBatch,
                                ScheduledSeq as JItem)
from gllm_tpu.sequence import Sequence as JSeq

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert
from gllm_tpu_torch.ops.cuda import ragged_attention as trag
from gllm_tpu_torch.runner.prepare import BatchBuilder
from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq
from gllm_tpu_torch.sequence import Sequence

from test_torch_cuda import UNIFIED_CASES, unified_case
from test_torch_engine import MODEL, _jax_params


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", list(UNIFIED_CASES))
def test_unified_plain_matches_pallas_interpret(case, int8):
    rng = np.random.default_rng(21)
    arrays = unified_case(rng, UNIFIED_CASES[case], int8)
    q, kc, vc, ks, vs, cu, kvl, pt = arrays
    want = ragged_paged_attention(
        *map(jnp.asarray, (q, kc, vc, cu, kvl, pt)), scale=0.2, q_block=4,
        kv_block=8, interpret=True, unified=True, group_size=2,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    got = trag.ragged_paged_attention_plain(
        *map(_t, (q, kc, vc, cu, kvl, pt)), scale=0.2, k_scale=_t(ks),
        v_scale=_t(vs), unified=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    assert torch.isfinite(got).all()


def test_amla_softmax_agrees_with_the_classic_one_at_a_wide_range():
    """A large scale stresses AMLA's power-of-two rescales (flushes, -inf
    first blocks); the result is the same softmax, to 2e-3."""
    rng = np.random.default_rng(11)
    q, kc, vc, _, _, cu, kvl, pt = unified_case(rng, UNIFIED_CASES["mixed"],
                                                False)
    args = [_t(a) for a in (q, kc, vc, cu, kvl, pt)]
    amla = trag.ragged_paged_attention_plain(*args, scale=1.7, unified=True)
    classic = trag.ragged_paged_attention_plain(*args, scale=1.7)
    np.testing.assert_allclose(amla.numpy(), classic.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("cu,S", [
    ([0, 1, 2, 3, 8, 9, 9, 9], 7),     # three decode rows, then a chunk
    ([0, 1, 2, 3, 4, 4, 4], 6),        # pure decode and padding
    ([0, 5, 6, 7], 3),                 # prefill first
])
def test_decode_prefix_len_matches_jax(cu, S):
    want = int(_decode_prefix_len(jnp.asarray(cu, jnp.int32), S))
    assert trag.decode_prefix_len(torch.tensor(cu, dtype=torch.int32)) \
        == want


def _builders(unified):
    sched = dict(max_prefill_tokens=128, max_decode_seqs=16)
    jb = JBuilder(JEC(max_num_seqs=32, unified_step=unified,
                      scheduler=JSC(**sched),
                      cache=JCC(page_size=4, num_pages=64)), 4,
                  vocab_size=128)
    tb = BatchBuilder(gt.EngineConfig(max_num_seqs=32, unified_step=unified,
                                      scheduler=gt.SchedulerConfig(**sched),
                                      cache=gt.CacheConfig(page_size=4,
                                                           num_pages=64)), 4)
    return jb, tb


def _batches(rows):
    """rows: (q_len, computed_before) → the same batch in both packages."""
    out = []
    for seq_cls, item_cls, batch_cls, sp in (
            (JSeq, JItem, JBatch, JSP),
            (Sequence, ScheduledSeq, ScheduledBatch, gt.SamplingParams)):
        items = []
        for i, (n, before) in enumerate(rows):
            seq = seq_cls(i, [1] * (before + n + 1), sp())
            seq.page_table = [1] * (-(-(before + n) // 4))
            seq.num_computed_tokens = before
            items.append(item_cls(seq, n, before))
        out.append(batch_cls(items))
    return out


@pytest.mark.parametrize("unified", [True, False])
@pytest.mark.parametrize("rows", [[(1, 6)] * 6, [(1, 6)] * 6 + [(20, 0)],
                                  [(20, 0), (1, 6)], [(3, 0)] * 9])
def test_signature_equals_jax_shape_signature(unified, rows):
    jb, tb = _builders(unified)
    jbatch, tbatch = _batches(rows)
    assert tb.shape_signature(tbatch) == tuple(jb.shape_signature(jbatch))
    if unified:
        t, _, q, _ = tb.shape_signature(tbatch)
        assert q == t


def _engine_workload():
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(2, 500, size=int(m))]
               for m in rng.integers(3, 14, size=5)]
    max_tokens = [int(m) for m in rng.integers(4, 16, size=5)]
    return prompts, max_tokens


def _port(np_params, unified):
    cfg = gt.EngineConfig(
        dtype="float32", max_model_len=64, max_num_seqs=8,
        unified_step=unified,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=32,
                                     max_decode_seqs=8),
        cache=gt.CacheConfig(page_size=4, num_pages=256))
    return gt.LLM(config=cfg, model_cfg=gt.ModelConfig(**MODEL),
                  params=convert.from_jax_params(np_params), device="cpu")


def test_unified_sync_engine_streams_equal_legacy_and_jax():
    params = _jax_params()
    np_params = jax.tree.map(np.asarray, params)
    prompts, max_tokens = _engine_workload()
    sps = [gt.SamplingParams(temperature=0.0, max_tokens=m, ignore_eos=True)
           for m in max_tokens]

    def run(llm, sp):
        outs = llm.generate(prompt_token_ids=[list(p) for p in prompts],
                            sampling_params=sp)
        mm = llm.memory_manager
        assert mm.num_free_pages == mm.allocator.num_total
        return [(o.output_token_ids, o.finish_reason) for o in outs]

    before = dict(trag.ragged_paged_attention.launches)
    plain0 = trag.ragged_paged_attention_plain.calls
    unified = _port(np_params, True)
    got = run(unified, sps)
    legacy = run(_port(np_params, False), sps)
    jcfg = JEC(dtype="float32", max_model_len=64, max_num_seqs=8,
               unified_step=True,
               scheduler=JSC(max_prefill_tokens=32, max_decode_seqs=8),
               cache=JCC(page_size=4, num_pages=256))
    jax_unified = run(JLLM(config=jcfg, model_cfg=JMC(**MODEL),
                           params=params),
                      [JSP(temperature=0.0, max_tokens=m, ignore_eos=True)
                       for m in max_tokens])
    assert got == legacy == jax_unified
    assert [len(t) for t, _ in got] == max_tokens
    # on the CPU the wrapper took its plain version, for every step
    assert trag.ragged_paged_attention.launches == before
    assert trag.ragged_paged_attention_plain.calls > plain0
    assert unified.step_counts["mixed"] > 0
    assert unified.step_counts["decode"] > 0
