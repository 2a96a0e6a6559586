"""Paged attention of the PyTorch port (gllm_tpu_torch/ops/cuda/*).

The plain versions against the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs (tolerance 2e-4, the JAX kernel tests'
own), over full-precision and int8 caches, and the dispatch rule. The
unified mode's plain version is held to the Pallas kernel in
tests/test_torch_unified.py. The CUDA kernels are held against the plain
versions on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gllm_tpu.ops.pallas.decode_attention import paged_decode_attention
from gllm_tpu.ops.pallas.ragged_attention import ragged_paged_attention

from gllm_tpu_torch.ops import attention as tattn
from gllm_tpu_torch.ops.cuda import decode_attention as tdec
from gllm_tpu_torch.ops.cuda import ragged_attention as trag

from test_torch_cuda import (DECODE_CASES, RAGGED_CASES, decode_case,
                             int8_cache, ragged_case)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(7)
    case = dict(case)
    q, kc, vc, cu, kvl, pt = ragged_case(
        rng, case["seqs"], case["Hq"], case["Hkv"], case["D"],
        case["page"], case["pages"], case.get("pad_seqs", 0),
        case.get("pad_tokens", 0))
    scale = case["D"] ** -0.5
    want = ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cu),
        jnp.asarray(kvl), jnp.asarray(pt), scale=scale, q_block=8,
        kv_block=16, interpret=True)
    got = trag.ragged_paged_attention_plain(*_t(q, kc, vc, cu, kvl, pt),
                                            scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(42)
    q, kc, vc, kvl, pt = decode_case(rng, case["kv_lens"], case["Hq"],
                                     case["Hkv"], case["D"], case["page"],
                                     case["pages"])
    scale = case["D"] ** -0.5
    want = paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kvl),
        jnp.asarray(pt), scale=scale, kv_block=32, interpret=True)
    got = tdec.paged_decode_attention_plain(*_t(q, kc, vc, kvl, pt),
                                            scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", [RAGGED_CASES[2], RAGGED_CASES[5]])
def test_ragged_int8_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(8)
    q, kc, vc, cu, kvl, pt = ragged_case(
        rng, case["seqs"], case["Hq"], case["Hkv"], case["D"],
        case["page"], case["pages"], case.get("pad_seqs", 0),
        case.get("pad_tokens", 0))
    kc, vc, ks, vs = int8_cache(rng, kc, vc)
    scale = case["D"] ** -0.5
    want = ragged_paged_attention(
        *map(jnp.asarray, (q, kc, vc, cu, kvl, pt)), scale=scale,
        q_block=8, kv_block=16, interpret=True, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    got = trag.ragged_paged_attention_plain(
        *_t(q, kc, vc, cu, kvl, pt), scale=scale, k_scale=_t(ks)[0],
        v_scale=_t(vs)[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", [DECODE_CASES[1], DECODE_CASES[2]])
def test_decode_int8_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(9)
    q, kc, vc, kvl, pt = decode_case(rng, case["kv_lens"], case["Hq"],
                                     case["Hkv"], case["D"], case["page"],
                                     case["pages"])
    kc, vc, ks, vs = int8_cache(rng, kc, vc)
    scale = case["D"] ** -0.5
    want = paged_decode_attention(
        *map(jnp.asarray, (q, kc, vc, kvl, pt)), scale=scale, kv_block=32,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = tdec.paged_decode_attention_plain(
        *_t(q, kc, vc, kvl, pt), scale=scale, k_scale=_t(ks)[0],
        v_scale=_t(vs)[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_page_offset_addresses_a_layer_of_the_stacked_cache():
    """page_offset = li * P reads layer li of a flat [L*P, ...] cache, as the
    model passes it; the result equals a call on that layer alone."""
    rng = np.random.default_rng(1)
    P = 12
    q, kc, vc, cu, kvl, pt = ragged_case(rng, [(5, 14), (1, 7)], 4, 2, 16,
                                         4, P)
    other = rng.standard_normal(kc.shape).astype(np.float32)
    k_all = np.concatenate([other, kc])          # layer 1 = the case
    v_all = np.concatenate([other, vc])
    want = trag.ragged_paged_attention_plain(*_t(q, kc, vc, cu, kvl, pt),
                                             scale=0.25)
    got = trag.ragged_paged_attention_plain(
        *_t(q, k_all, v_all, cu, kvl, pt), scale=0.25, page_offset=P)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    dq = q[cu[1:3] - 1]
    want_d = tdec.paged_decode_attention_plain(
        *_t(dq, kc, vc, kvl, pt), scale=0.25)
    got_d = tdec.paged_decode_attention_plain(
        *_t(dq, k_all, v_all, kvl, pt), scale=0.25, page_offset=P)
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())


def test_dispatch_routes_decode_and_ragged(monkeypatch):
    calls = []
    monkeypatch.setattr(tattn, "paged_decode_attention",
                        lambda *a, **k: calls.append("decode") or a[0])
    monkeypatch.setattr(tattn, "ragged_paged_attention",
                        lambda *a, **k: calls.append("ragged") or a[0])
    md = tattn.AttentionMetadata(
        cu_q_lens=torch.tensor([0, 1, 2], dtype=torch.int32),
        kv_lens=torch.tensor([3, 5], dtype=torch.int32),
        page_table=torch.ones((2, 2), dtype=torch.int32))
    kc = torch.zeros(4, 4, 1, 8)
    tattn.paged_attention(torch.zeros(2, 2, 8), kc, kc, md, scale=1.0,
                          max_q_len=1)
    tattn.paged_attention(torch.zeros(16, 2, 8), kc, kc, md, scale=1.0,
                          max_q_len=16)
    assert calls == ["decode", "ragged"]
    with pytest.raises(ValueError, match="T == S"):
        tattn.paged_attention(torch.zeros(3, 2, 8), kc, kc, md, scale=1.0,
                              max_q_len=1)


def test_dispatch_unified_takes_every_batch(monkeypatch):
    calls = []
    monkeypatch.setattr(tattn, "paged_decode_attention",
                        lambda *a, **k: calls.append("decode") or a[0])
    monkeypatch.setattr(tattn, "ragged_paged_attention",
                        lambda *a, **k: calls.append(k) or a[0])
    md = tattn.AttentionMetadata(
        cu_q_lens=torch.tensor([0, 1, 2], dtype=torch.int32),
        kv_lens=torch.tensor([3, 5], dtype=torch.int32),
        page_table=torch.ones((2, 2), dtype=torch.int32))
    kc = torch.zeros(4, 4, 1, 8, dtype=torch.int8)
    ks = torch.ones(4, 1)
    for max_q in (1, 2):
        tattn.paged_attention(torch.zeros(2, 2, 8), kc, kc, md, scale=1.0,
                              max_q_len=max_q, impl="unified", k_scale=ks,
                              v_scale=ks, page_offset=4)
    assert [c["unified"] for c in calls] == [True, True]
    assert all(c["k_scale"] is ks and c["page_offset"] == 4 for c in calls)
    with pytest.raises(ValueError, match="impl"):
        tattn.paged_attention(torch.zeros(2, 2, 8), kc, kc, md, scale=1.0,
                              max_q_len=1, impl="pallas")


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(2)
    q, kc, vc, cu, kvl, pt = ragged_case(rng, [(3, 9)], 4, 2, 16, 4, 8)
    before = (trag.ragged_paged_attention_plain.calls,
              dict(trag.ragged_paged_attention.launches))
    trag.ragged_paged_attention(*_t(q, kc, vc, cu, kvl, pt), scale=0.25)
    assert trag.ragged_paged_attention_plain.calls == before[0] + 1
    assert trag.ragged_paged_attention.launches == before[1]


@pytest.mark.parametrize("S,Hkv,max_keys,want", [
    (32, 8, 2048, 256),    # main-path decode batch: the longest splits
    (8, 8, 1024, 64),      # small batch: shorter splits fill 132 SMs
    (1, 8, 4096, 32),      # one row: the shortest split, one tile each
    (256, 8, 64, 256),     # short contexts: one split
])
def test_decode_split_follows_the_grid(S, Hkv, max_keys, want):
    assert tdec.keys_per_split(S, Hkv, max_keys, num_sms=132) == want
