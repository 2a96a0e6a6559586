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


@pytest.mark.parametrize("S,Hkv,max_keys,page,bps,tile,waves,want", [
    # main-path decode batch (D 64, bf16: 3 blocks an SM): 4 splits
    (32, 8, 2048, 16, 3, 64, 3, 512),
    (8, 8, 1024, 16, 3, 64, 3, 64),     # small batch: shorter splits
    (1, 8, 4096, 16, 3, 64, 3, 64),     # one row: the shortest split
    (256, 8, 64, 16, 3, 64, 3, 64),     # short contexts: one split
    # the MLA decode block at DeepSeek-V2-Lite: one block an SM, 32-key
    # tiles, one wave: 4 splits
    (32, 1, 2048, 16, 1, 32, 1, 512),
    # a long context in 4-token pages: at most 255 pages a split
    (512, 8, 65536, 4, 3, 64, 3, 960),
])
def test_decode_split_follows_the_grid(S, Hkv, max_keys, page, bps, tile,
                                       waves, want):
    got = tdec.keys_per_split(S, Hkv, max_keys, page, num_sms=132,
                              blocks_per_sm=bps, tile=tile, waves=waves)
    assert got == want
    assert got % tile == 0 and -(-got // page) + 1 <= tdec.PT_SLOTS


@pytest.mark.parametrize("S,max_keys,num_sms,want", [
    # the profiled window's decode steps (S 8, about 520 keys; the page
    # table's 64-page bucket): one wave would cut two-tile splits
    (8, 544, 132, tdec.MLA_MIN_SPLIT_KEYS),
    (8, 1024, 132, tdec.MLA_MIN_SPLIT_KEYS),
    (8, 544, 114, tdec.MLA_MIN_SPLIT_KEYS),     # a card with fewer SMs
    (1, 2048, 132, tdec.MLA_MIN_SPLIT_KEYS),
    # the smoke's decode batch: 4 splits of 512, as before the minimum
    (32, 2048, 132, 512),
    (32, 2048, 114, 704),       # 3 splits on 114 SMs, as before
    # short contexts: one split
    (32, 64, 132, tdec.MLA_MIN_SPLIT_KEYS),
])
def test_mla_split_keeps_its_minimum(S, max_keys, num_sms, want):
    """The MLA decode block's plan (one block an SM, 32-key tiles, one
    wave) never cuts a split below MLA_MIN_SPLIT_KEYS."""
    assert tdec.MLA_MIN_SPLIT_KEYS % tdec.MLA_KEYS == 0
    got = tdec.keys_per_split(S, 1, max_keys, 16, num_sms=num_sms,
                              blocks_per_sm=1, tile=tdec.MLA_KEYS,
                              waves=tdec.MLA_SPLIT_WAVES,
                              min_keys=tdec.MLA_MIN_SPLIT_KEYS)
    assert got == want
    assert got >= tdec.MLA_MIN_SPLIT_KEYS


@pytest.mark.parametrize("geometry,want", [
    # GQA (D, q bytes, cache bytes, int8): by shared memory, capped by
    # registers
    (("gqa", 32, 2, 2, False), 4),
    (("gqa", 64, 2, 2, False), 3),    # 61952 bytes
    (("gqa", 128, 2, 2, False), 2),   # 113152 bytes
    (("gqa", 256, 2, 2, False), 1),   # 215552 bytes
    (("gqa", 64, 2, 1, True), 4),
    (("gqa", 256, 2, 1, False), 2),   # fp8 at D 256: 114176 bytes
    # MLA (Dl, Dv, q bytes, cache bytes)
    (("mla", 576, 512, 2, 2), 1),     # two groups: 172800 bytes
    (("mla", 576, 512, 2, 1), 2),     # fp8, one group: 97536 bytes
    (("mla", 96, 64, 2, 2), 1),       # two groups: one by registers
    (("mla", 96, 64, 2, 1), 4),
])
def test_decode_blocks_per_sm(geometry, want):
    kind, *args = geometry
    fn = (tdec.decode_blocks_per_sm if kind == "gqa"
          else tdec.mla_decode_blocks_per_sm)
    assert fn(*args) == want


def _model(**kw):
    from gllm_tpu_torch.models.config import ModelConfig
    cfg = dict(architecture="LlamaForCausalLM", vocab_size=64,
               hidden_size=64, num_layers=2, num_heads=8, num_kv_heads=2,
               head_dim=64, intermediate_size=64)
    cfg.update(kw)
    return ModelConfig(**cfg)


@pytest.mark.parametrize("kw,cache,unified,match", [
    (dict(), "auto", False, None),
    # any group up to 16, dividing 64 or not (the ragged blocks take
    # floor(64 / G) tokens a warpgroup)
    (dict(num_heads=28, num_kv_heads=4), "auto", False, None),     # 7
    (dict(num_heads=10, num_kv_heads=2), "auto", False, None),     # 5
    (dict(num_heads=12, num_kv_heads=2), "int8", True, None),      # 6
    (dict(num_heads=32, num_kv_heads=1), "auto", False, "group"),  # 32
    (dict(head_dim=256, num_heads=16, num_kv_heads=2), "fp8", False, None),
    (dict(head_dim=256, num_heads=16, num_kv_heads=2), "int8", False,
     "head_dim"),
    (dict(head_dim=256, num_heads=16, num_kv_heads=2), "auto", True,
     "head_dim"),
    (dict(head_dim=80), "auto", False, "head_dim"),
    (dict(num_heads=16, kv_lora_rank=64, qk_nope_head_dim=32,
          qk_rope_head_dim=32, v_head_dim=32), "auto", True, None),
    (dict(num_heads=32, kv_lora_rank=64, qk_nope_head_dim=32,
          qk_rope_head_dim=32, v_head_dim=32), "auto", False, "32"),
    (dict(layer_types=("linear_attention", "full_attention"),
          linear_num_key_heads=2, linear_num_value_heads=4,
          linear_key_head_dim=64, linear_value_head_dim=128), "auto",
     False, None),
    (dict(layer_types=("linear_attention", "full_attention"),
          linear_num_key_heads=2, linear_num_value_heads=4,
          linear_key_head_dim=48, linear_value_head_dim=128), "auto",
     False, "linear_key_head_dim"),
    (dict(layer_types=("linear_attention", "full_attention"),
          linear_num_key_heads=2, linear_num_value_heads=4,
          linear_key_head_dim=64, linear_value_head_dim=256), "auto",
     False, "linear_value_head_dim"),
])
def test_model_shapes_the_kernels_refuse_raise_by_name(kw, cache, unified,
                                                       match):
    from gllm_tpu_torch.ops.cuda.common import check_model_shapes
    cfg = _model(**kw)
    if match is None:
        check_model_shapes(cfg, cache, unified)
    else:
        with pytest.raises(NotImplementedError, match=match):
            check_model_shapes(cfg, cache, unified)


def test_runner_on_cuda_refuses_kernel_shapes_before_loading():
    """ModelRunner on a CUDA device raises by name before any weight or KV
    page is allocated (so this runs on a host without a card)."""
    from gllm_tpu_torch.config import EngineConfig
    from gllm_tpu_torch.runner.runner import ModelRunner
    with pytest.raises(NotImplementedError, match="group"):
        ModelRunner(EngineConfig(load_format="dummy"),
                    _model(num_heads=32, num_kv_heads=1), "cuda")
