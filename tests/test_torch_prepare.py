"""Scheduler, memory manager and batch builder of the PyTorch port against
the JAX package's: the same requests scheduled in both give the same
batches, step after step, and equal StepBatch arrays (buckets, padding,
page tables, slots), through chunked prefill, decode, finishes, a
preemption and prefix-cache hits."""

import numpy as np
import pytest
import torch

import jax

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.memory_manager import make_memory_manager as j_make_mm
from gllm_tpu.runner.prepare import BatchBuilder as JBuilder
from gllm_tpu.sampling_params import SamplingParams as JSP
from gllm_tpu.scheduler import Scheduler as JScheduler
from gllm_tpu.sequence import Sequence as JSeq

from gllm_tpu_torch.config import (CacheConfig, EngineConfig,
                                   SchedulerConfig)
from gllm_tpu_torch.memory_manager import make_memory_manager
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging
from gllm_tpu_torch.sampling_params import SamplingParams
from gllm_tpu_torch.scheduler import Scheduler
from gllm_tpu_torch.sequence import Sequence


def _engines(num_pages, prefix, max_prefill=24, page=4,
             method="chunked_prefill"):
    sched = dict(max_prefill_tokens=max_prefill, max_decode_seqs=8,
                 schedule_method=method, min_prefill_tokens=8)
    jc = JEC(max_model_len=128, scheduler=JSC(**sched),
             cache=JCC(page_size=page, num_pages=num_pages,
                       enable_prefix_caching=prefix))
    tc = EngineConfig(max_model_len=128, scheduler=SchedulerConfig(**sched),
                      cache=CacheConfig(page_size=page, num_pages=num_pages,
                                        enable_prefix_caching=prefix))
    jmm = j_make_mm(num_pages, page, prefix)
    tmm = make_memory_manager(num_pages, page, prefix)
    return ((JScheduler(jc, jmm), JBuilder(jc, page), jmm),
            (Scheduler(tc, tmm), BatchBuilder(tc, page), tmm))


def _flat(sb):
    return {
        "token_ids": sb.token_ids, "positions": sb.positions,
        "slot_mapping": sb.slot_mapping,
        "logits_indices": sb.logits_indices,
        "cu_q_lens": sb.attn.cu_q_lens, "kv_lens": sb.attn.kv_lens,
        "page_table": sb.attn.page_table,
        "temperature": sb.sampling.temperature, "top_p": sb.sampling.top_p,
        "top_k": sb.sampling.top_k, "min_p": sb.sampling.min_p,
    }


@pytest.mark.parametrize("num_pages,prefix", [(64, False), (18, False),
                                              (64, True)])
def test_same_requests_build_equal_step_batches(num_pages, prefix):
    _same_batches(num_pages, prefix, "chunked_prefill")


@pytest.mark.parametrize("num_pages,method", [(18, "token_throttling"),
                                              (64, "split_pd")])
def test_other_policies_build_equal_step_batches(num_pages, method):
    _same_batches(num_pages, False, method)


def _same_batches(num_pages, prefix, method):
    (js, jb, jmm), (ts, tb, tmm) = _engines(num_pages, prefix, method=method)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 100, 12).tolist()
    prompts = [shared + rng.integers(1, 100, n).tolist()
               for n in (3, 17, 30, 1, 9)]
    max_tokens = [6, 3, 8, 12, 5]
    temps = [0.0, 0.7, 0.0, 1.0, 0.0]

    def add(i):
        js.add_seq(JSeq(i, prompts[i], JSP(temperature=temps[i], top_k=5,
                                           max_tokens=max_tokens[i],
                                           ignore_eos=True)))
        ts.add_seq(Sequence(i, prompts[i],
                            SamplingParams(temperature=temps[i], top_k=5,
                                           max_tokens=max_tokens[i],
                                           ignore_eos=True)))

    for i in range(3):
        add(i)
    key = jax.random.key(0)
    steps = 0
    while js.has_unfinished or ts.has_unfinished:
        if steps == 3:
            add(3)
            add(4)
        jbatch, tbatch = js.schedule_once(), ts.schedule_once()
        assert (jbatch is None) == (tbatch is None)
        assert ([(it.seq.seq_id, it.num_new_tokens, it.computed_before)
                 for it in jbatch.items]
                == [(it.seq.seq_id, it.num_new_tokens, it.computed_before)
                    for it in tbatch.items])
        jsb, jq, _ = jb.build(jbatch, key, device=False)
        tsb, tq = tb.build(tbatch)
        assert jq == tq
        want = _flat(jsb)
        for name, got in _flat(tsb).items():
            np.testing.assert_array_equal(got, np.asarray(want[name]),
                                          err_msg=name)
        # the one-copy staging carries every array intact
        dev = _flat(HostStaging("cpu").upload(tsb))
        for name, got in dev.items():
            np.testing.assert_array_equal(got.numpy(), _flat(tsb)[name],
                                          err_msg=name)
        toks = [int(t) for t in rng.integers(1, 100, jbatch.num_seqs)]
        js.process_output(jbatch, toks, None)
        ts.process_output(tbatch, toks, None)
        steps += 1
    assert steps > 10
    assert tmm.num_free_pages == tmm.allocator.num_total
    assert js.num_preemptions == ts.num_preemptions
    if num_pages == 18:
        assert ts.num_preemptions > 0
    if prefix:
        assert tmm.hit_tokens == jmm.hit_tokens > 0


def test_staging_keeps_float_arrays_bitwise():
    (_, _, _), (ts, tb, _) = _engines(32, False)
    ts.add_seq(Sequence(0, [5, 6, 7], SamplingParams(temperature=0.3,
                                                     top_p=0.7, min_p=0.1)))
    sb, _ = tb.build(ts.schedule_once())
    dev = HostStaging("cpu").upload(sb)
    assert dev.sampling.temperature.dtype == torch.float32
    assert dev.sampling.top_p[0].item() == np.float32(0.7)
    assert dev.sampling.min_p[0].item() == np.float32(0.1)
    assert dev.attn.page_table.shape == sb.attn.page_table.shape
