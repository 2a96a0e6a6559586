"""Ops of the PyTorch port against the JAX package's, on the same numpy
inputs at float32 (atol 1e-5): norms, activation, rope, the KV write and
the sampler's mask and greedy path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gllm_tpu.ops import layers as jlayers
from gllm_tpu.ops import kv_cache as jkv
from gllm_tpu.ops import rope as jrope
from gllm_tpu.ops import sampling as jsampling

from gllm_tpu_torch.ops import kv_cache as tkv
from gllm_tpu_torch.ops import layers as tlayers
from gllm_tpu_torch.ops import rope as trope
from gllm_tpu_torch.ops import sampling as tsampling

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=atol)


def test_rms_norm_and_fused_add():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 64)).astype(np.float32)
    r = rng.standard_normal((7, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    tn, tr = tlayers.fused_add_rms_norm(
        torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(w))
    jn, jr = jlayers.fused_add_rms_norm(jnp.asarray(x), jnp.asarray(r),
                                        jnp.asarray(w))
    _close(tn, jn)
    _close(tr, jr)


def test_silu_and_mul():
    x = np.random.default_rng(1).standard_normal((5, 96)).astype(np.float32)
    _close(tlayers.silu_and_mul(torch.from_numpy(x)),
           jlayers.silu_and_mul(jnp.asarray(x)))


LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 64}


@pytest.mark.parametrize("scaling,theta", [(None, 10000.0),
                                           (LLAMA3, 500000.0)])
@pytest.mark.parametrize("interleaved", [False, True])
def test_rope_table_and_apply(scaling, theta, interleaved):
    rot, max_pos = 32, 256
    want_table = jrope.compute_rope_cos_sin(rot, max_pos, theta, scaling)
    table = trope.compute_rope_cos_sin(rot, max_pos, theta, scaling)
    _close(table, want_table)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((9, 4, 40)).astype(np.float32)   # partial rotary
    k = rng.standard_normal((9, 2, 40)).astype(np.float32)
    pos = rng.integers(0, max_pos, 9).astype(np.int32)
    tab = np.array(want_table)
    jfn = jrope.apply_rope_interleaved if interleaved else jrope.apply_rope
    tfn = trope.apply_rope_interleaved if interleaved else trope.apply_rope
    jq, jk = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                 jnp.asarray(tab))
    tq, tk = tfn(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(pos), torch.from_numpy(tab))
    _close(tq, jq)
    _close(tk, jk)


def test_write_kv_in_place():
    rng = np.random.default_rng(3)
    P, page, Hkv, D, T = 6, 4, 2, 8, 7
    k = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    slots = np.array([5, 6, 7, 13, 20, 21, 9], np.int32)
    zero = np.zeros((P, page, Hkv, D), np.float32)
    jk, jv = jkv.write_kv(jnp.asarray(zero), jnp.asarray(zero),
                          jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots))
    tk_c, tv_c = torch.zeros(P, page, Hkv, D), torch.zeros(P, page, Hkv, D)
    tkv.write_kv(tk_c, tv_c, torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(slots))
    np.testing.assert_array_equal(tk_c.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv_c.numpy(), np.asarray(jv))


@pytest.mark.parametrize("top_k,top_p,min_p", [
    ([-1, 5, 1, 40], [1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]),
    ([-1, -1, 10, 3], [0.9, 0.5, 0.3, 1.0], [0.0, 0.0, 0.0, 0.0]),
    ([-1, 20, -1, -1], [1.0, 0.8, 1.0, 0.95], [0.1, 0.0, 0.5, 0.05]),
])
def test_sampling_mask_matches_sort_reference(top_k, top_p, min_p):
    logits = (np.random.default_rng(4).standard_normal((4, 300))
              * 3).astype(np.float32)
    args = [np.asarray(top_k, np.int32), np.asarray(top_p, np.float32),
            np.asarray(min_p, np.float32)]
    want = jsampling._topk_topp_mask_sort(jnp.asarray(logits),
                                          *map(jnp.asarray, args))
    got = tsampling.topk_topp_mask(torch.from_numpy(logits),
                                   *map(torch.from_numpy, args))
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    kept = ~np.isinf(want)
    np.testing.assert_array_equal(got.numpy()[kept], want[kept])


def test_greedy_sample_matches():
    import jax
    logits = np.random.default_rng(5).standard_normal((6, 500)).astype(
        np.float32)
    S = logits.shape[0]
    jmd = jsampling.SamplingMetadata(
        temperature=jnp.zeros(S), top_p=jnp.ones(S),
        top_k=jnp.full(S, -1, jnp.int32), repetition_penalty=jnp.ones(S),
        step_key=jax.random.key(0), min_p=jnp.zeros(S))
    tmd = tsampling.SamplingMetadata(
        temperature=torch.zeros(S), top_p=torch.ones(S),
        top_k=torch.full((S,), -1, dtype=torch.int32), min_p=torch.zeros(S))
    want = np.asarray(jsampling.sample(jnp.asarray(logits), jmd,
                                       all_greedy=True))
    for all_greedy in (True, False):
        got = tsampling.sample(torch.from_numpy(logits), tmd,
                               all_greedy=all_greedy)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_rows_stay_inside_the_nucleus_and_follow_the_seed():
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 200)).astype(np.float32))
    md = tsampling.SamplingMetadata(
        temperature=torch.tensor([0.0, 1.0, 0.7]),
        top_p=torch.tensor([1.0, 1.0, 0.5]),
        top_k=torch.tensor([-1, 3, -1], dtype=torch.int32),
        min_p=torch.zeros(3))
    draws = []
    for seed in (11, 11, 12):
        gen = torch.Generator().manual_seed(seed)
        draws.append(torch.stack([tsampling.sample(logits, md, gen)
                                  for _ in range(50)]))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert (draws[0][:, 0] == logits[0].argmax()).all()
    top3 = set(logits[1].topk(3).indices.tolist())
    assert set(draws[0][:, 1].tolist()) <= top3
    masked = tsampling.topk_topp_mask(logits / 0.7, md.top_k, md.top_p,
                                      md.min_p)
    allowed = set(torch.nonzero(~torch.isinf(masked[2])).flatten().tolist())
    assert set(draws[0][:, 2].tolist()) <= allowed
