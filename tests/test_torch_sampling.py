"""The port's sampling extras against the JAX package's, one function at a
time, on the CPU at float32 (V 1000, S 8, K 4): threefry keys, folds and
random bits bit for bit against ``jax.random``, Gumbel noise within one
ulp of each of its two logs, the seeded-noise rows (verify-row and
stream folds), the logit adjustments (logit_bias, penalties, both over
the verify rows with the draft prefixes' counts) and logprobs within
1e-5, and seeded ``sample`` and ``spec_verify`` equal to JAX's. Then the
DeepSeek and hybrid families' engines against the JAX ``LLM`` (seeded
rows and logprobs; penalties and prompt logprobs): the dense family's
engine cases are in test_torch_sampling_engine.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gllm_tpu.ops import sampling as jsamp
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.ops import sampling as tsamp
from gllm_tpu_torch.ops import threefry as tf
from gllm_tpu_torch.ops.cuda.threefry import seeded_noise

import test_torch_gdn
import test_torch_mla

V, S, K = 1000, 8, 4
LP_TOL = 1e-4
SEEDS = np.array([3, 0, 2**31 - 8, 7, -1, 12345, -1, 99], np.int32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_jax_threefry_is_partitionable():
    # the port reproduces the partitionable random bits (JAX's default
    # since 0.5); the other layout gives other bits for the same key
    assert jax.config.jax_threefry_partitionable is True, (
        "jax_threefry_partitionable is off: the JAX package's seeded "
        "draws no longer follow ops/threefry.py's recipe")


def _key_data(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_key_fold_in_and_bits_match_jax(seed):
    jk = jax.random.key(jnp.uint32(seed))
    tk = tf.key(torch.tensor([seed]))
    assert _key_data(jk) == (int(tk[0][0]), int(tk[1][0]))
    for data in (0, 1, 5, 77, 2**32 - 1):
        jf = jax.random.fold_in(jk, jnp.uint32(data))
        tfk = tf.fold_in(tk, torch.tensor([data]))
        assert _key_data(jf) == (int(tfk[0][0]), int(tfk[1][0]))
        want = np.asarray(jax.random.bits(jf, (V,), jnp.uint32))
        got = tf.random_bits(tfk, V).numpy()[0]
        np.testing.assert_array_equal(got, want.astype(np.int64))
        u = np.asarray(jax.random.uniform(jf, ()))
        assert tf.uniform_from_bits(tf.random_bits(tfk, 1))[0, 0] == float(u)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_gumbel_within_one_ulp_of_each_log():
    """jax.random.gumbel is -log(-log(u)); XLA's CPU log and torch's may
    round one ulp apart. The uniforms are equal bit for bit, each log
    within one ulp of JAX's on the same input, and the noise within the
    two logs' composed one-ulp bound (the inner log's ulp carried through
    1 / y, the outer log's, and the result's rounding)."""
    jk = jax.random.fold_in(jax.random.key(jnp.uint32(3)), jnp.uint32(9))
    bits = torch.from_numpy(np.asarray(
        jax.random.bits(jk, (20000,), jnp.uint32)).astype(np.int64))
    u = tf.uniform_from_bits(bits, tf.TINY)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jnp.maximum(
            jnp.asarray(tf.uniform_from_bits(bits).numpy()) + tf.TINY,
            tf.TINY)))
    y_j = np.asarray(-jnp.log(jnp.asarray(u.numpy())))
    assert _ulps((-torch.log(u)).numpy(), y_j).max() <= 1
    y_j = np.array(y_j)
    g_j = np.asarray(-jnp.log(jnp.asarray(y_j)))
    assert _ulps((-torch.log(torch.from_numpy(y_j))).numpy(), g_j).max() <= 1
    want = np.asarray(jax.random.gumbel(jk, (20000,), jnp.float32))
    got = tf.gumbel_from_bits(bits).numpy()
    bound = (2 * np.spacing(np.abs(want)).astype(np.float64)
             + np.spacing(y_j).astype(np.float64) / y_j)
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def _np_keys(seed, step, *folds):
    k = jax.random.fold_in(jax.random.key(jnp.uint32(seed)),
                           jnp.uint32(step))
    for f in folds:
        k = jax.random.fold_in(k, jnp.uint32(f))
    return k


@pytest.mark.parametrize("group,stream", [(0, -1), (K + 1, 1), (K + 1, 0)])
def test_seeded_noise_rows_match_jax_keys(group, stream):
    """The kernel's plain version: each row of a seed >= 0 gets the bits
    of its key (seed, step, the verify row's position, the stream), the
    rows of seed -1 keep what they held."""
    steps = np.arange(S, dtype=np.int32) * 3 + 1
    rows = S * group if group else S
    out = torch.full((rows, 64), 5, dtype=torch.int32)
    seeded_noise(out, torch.from_numpy(SEEDS), torch.from_numpy(steps),
                 group, stream, tf.BITS)
    for r in range(rows):
        s = r // group if group else r
        if SEEDS[s] < 0:
            assert (out[r] == 5).all()
            continue
        folds = ((r % group,) if group else ()) + (
            (stream,) if stream >= 0 else ())
        want = np.asarray(jax.random.bits(
            _np_keys(int(SEEDS[s]), int(steps[s]), *folds), (64,),
            jnp.uint32)).view(np.int32)
        np.testing.assert_array_equal(out[r].numpy(), want)


def _mds(seed=None, rng=None, penalties=True, bias=True):
    """The same sampling metadata for both packages: mixed temperatures,
    top-k / top-p / min-p, penalties and logit_bias pairs (padding pairs
    bias 0), seeds (-1: unseeded) and output indices."""
    rng = rng or np.random.default_rng(0)
    temp = np.array([0.8, 0, 1.0, 0.7, 0, 1.3, 0.9, 1.0], np.float32)
    top_p = np.array([0.95, 1, 1, 0.9, 1, 1, 0.8, 1], np.float32)
    top_k = np.array([-1, -1, 50, -1, 5, -1, -1, 20], np.int32)
    min_p = np.array([0, 0, 0, 0.02, 0, 0, 0.05, 0], np.float32)
    arrs = dict(temperature=temp, top_p=top_p, top_k=top_k, min_p=min_p)
    if penalties:
        arrs.update(
            repetition_penalty=rng.uniform(0.8, 1.5, S).astype(np.float32),
            presence_penalty=rng.uniform(-2, 2, S).astype(np.float32),
            frequency_penalty=rng.uniform(-2, 2, S).astype(np.float32))
    if bias:
        ids = rng.integers(0, V, (S, 8)).astype(np.int32)
        vals = rng.uniform(-100, 100, (S, 8)).astype(np.float32)
        vals[:, 6:] = 0.0
        arrs.update(bias_ids=ids, bias_vals=vals)
    if seed is not None:
        arrs.update(seed=seed, out_step=(np.arange(S) * 5 + 2
                                         ).astype(np.int32))
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    j.setdefault("repetition_penalty", jnp.ones(S))
    jmd = jsamp.SamplingMetadata(step_key=jax.random.key(0), **j)
    tmd = tsamp.SamplingMetadata(**{k: torch.from_numpy(v)
                                    for k, v in arrs.items()})
    return jmd, tmd


def _penalty_tokens(rng, L=24):
    ids = rng.integers(0, V, (S, L)).astype(np.int32)
    ids[:, :6] = ids[:, :1]                    # repeats: counts above 1
    mask = np.ones((S, L), bool)
    mask[2, 10:] = False
    mask[5, :] = False
    return (jsamp.PenaltyTokens(jnp.asarray(ids), jnp.asarray(mask)),
            tsamp.PenaltyTokens(torch.from_numpy(ids),
                                torch.from_numpy(mask)))


def test_logit_adjustments_and_logprobs_match_jax():
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((S, V))).astype(np.float32)
    jmd, tmd = _mds(rng=rng)
    jpt, tpt = _penalty_tokens(rng)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    for name, want, got in (
            ("bias", jsamp.apply_logit_bias(jl, jmd),
             tsamp.apply_logit_bias(tl, tmd)),
            ("penalties", jsamp.apply_penalties(jl, jpt, jmd),
             tsamp.apply_penalties(tl, tpt, tmd)),
            ("adjust", jsamp.adjust_logits(jl, jpt, jmd),
             tsamp.adjust_logits(tl, tpt, tmd))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=name)
    adjusted = np.array(jsamp.adjust_logits(jl, jpt, jmd))
    chosen = rng.integers(0, V, S).astype(np.int32)
    want = jsamp.compute_logprobs(jnp.asarray(adjusted),
                                  jnp.asarray(chosen), 5)
    got = tsamp.compute_logprobs(torch.from_numpy(adjusted),
                                 torch.from_numpy(chosen), 5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5)


@pytest.mark.parametrize("penalties,bias", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_spec_adjust_logits_matches_jax(penalties, bias):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((S, K + 1, V))).astype(np.float32)
    drafts = rng.integers(0, V, (S, K)).astype(np.int32)
    drafts[:, 2] = drafts[:, 0]                # a repeated draft
    drafts[3, 1:] = -1
    drafts[6, :] = -1
    jmd, tmd = _mds(rng=rng, penalties=penalties, bias=bias)
    jpt, tpt = _penalty_tokens(rng) if penalties else (None, None)
    want = jsamp.spec_adjust_logits(jnp.asarray(logits),
                                    jnp.asarray(drafts), jmd, jpt)
    got = tsamp.spec_adjust_logits(torch.from_numpy(logits),
                                   torch.from_numpy(drafts), tmd, tpt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_seeded_sample_matches_jax():
    """Every row seeded: the port's ids equal JAX's, greedy rows included,
    through the adjustments; with some rows unseeded the seeded ones
    still do (their draws do not depend on the others)."""
    rng = np.random.default_rng(3)
    jpt, tpt = _penalty_tokens(rng)
    for trial in range(4):
        logits = (2 * rng.standard_normal((S, V))).astype(np.float32)
        seeds = (np.abs(SEEDS) + trial).astype(np.int32)
        jmd, tmd = _mds(seed=seeds, rng=rng)
        want = np.asarray(jsamp.sample(jnp.asarray(logits), jmd, jpt))
        got = tsamp.sample(torch.from_numpy(logits), tmd,
                           torch.Generator().manual_seed(trial),
                           token_counts=tpt)
        np.testing.assert_array_equal(got.numpy(), want)
        jmd, tmd = _mds(seed=SEEDS, rng=rng)
        want = np.asarray(jsamp.sample(jnp.asarray(logits), jmd, jpt))
        got = tsamp.sample(torch.from_numpy(logits), tmd,
                           torch.Generator().manual_seed(trial),
                           token_counts=tpt).numpy()
        np.testing.assert_array_equal(got[SEEDS >= 0], want[SEEDS >= 0])


def test_seeded_spec_verify_matches_jax():
    """Seeded rows' acceptance uniforms and resampling noise are JAX's
    (``pos_keys``, ``fold_in(k, 0)`` and ``fold_in(k, 1)``): (tok_mat,
    accept) equal over several draws, greedy and sampled rows mixed."""
    rng = np.random.default_rng(4)
    seeds = np.abs(SEEDS).astype(np.int32)
    accepted = 0
    for trial in range(4):
        logits = (2 * rng.standard_normal((S, K + 1, V))).astype(np.float32)
        drafts = logits[:, :K].argmax(-1).astype(np.int32)
        drafts[1, 2] = (drafts[1, 2] + 1) % V
        drafts[5, 2:] = -1
        drafts[6, :] = -1
        jmd, tmd = _mds(seed=(seeds + trial).astype(np.int32), rng=rng,
                        penalties=False, bias=False)
        jtok, jacc = jsamp.spec_verify(jnp.asarray(logits),
                                       jnp.asarray(drafts), jmd)
        ttok, tacc = tsamp.spec_verify(
            torch.from_numpy(logits), torch.from_numpy(drafts), tmd,
            torch.Generator().manual_seed(trial))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        accepted += int(np.asarray(jacc).sum())
    assert accepted > 0


# ---- the DeepSeek and hybrid families' engines ----------------------------

def _lp_close(got, want):
    """Two logprob lists: the same top ids, values within LP_TOL."""
    assert (got is None) == (want is None)
    if want is None:
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert g[1] == list(w[1])
        assert abs(g[0] - w[0]) <= LP_TOL
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=LP_TOL)


def _outputs(llm, prompts, sps):
    SP = gt.SamplingParams if isinstance(llm, gt.LLM) else JSP
    outs = llm.generate(prompt_token_ids=prompts,
                        sampling_params=[SP(**sp) for sp in sps])
    return [(o.output_token_ids, o.finish_reason, o.logprobs,
             o.prompt_logprobs) for o in outs]


def _prompts(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 250, int(rng.integers(4, 8))).tolist()
            for _ in range(n)]


def test_deepseek_seeded_rows_and_logprobs_match_jax():
    jllm, tllm = test_torch_mla._engines(test_torch_mla.V2, "xla", 96)
    prompts = _prompts(seed=1)
    # every row seeded and with the same top-N, so that each step of the
    # JAX engine takes one compiled program
    sps = [dict(temperature=0.8 if i % 2 else 0.0, seed=3 + i, logprobs=2,
                max_tokens=6, ignore_eos=True) for i in range(4)]
    for g, w in zip(_outputs(tllm, prompts, sps),
                    _outputs(jllm, prompts, sps)):
        assert g[:2] == w[:2]
        _lp_close(g[2], w[2])


def test_hybrid_penalties_and_prompt_logprobs_match_jax():
    jllm, tllm = test_torch_gdn._engines(96)
    prompts = _prompts(seed=2)
    sps = [dict(temperature=0.0, presence_penalty=0.6 * (i % 2),
                frequency_penalty=0.2, repetition_penalty=1.0 + 0.1 * i,
                prompt_logprobs=2, max_tokens=6, ignore_eos=True)
           for i in range(4)]
    for g, w in zip(_outputs(tllm, prompts, sps),
                    _outputs(jllm, prompts, sps)):
        assert g[:2] == w[:2]
        _lp_close(g[3], w[3])
