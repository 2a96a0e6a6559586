"""The fp8 (e4m3) KV cache and the unified step over an MLA latent cache
(K1um) of the PyTorch port against the JAX package, on the CPU at float32.

- The write path: ``write_kv`` and ``write_latent`` into an fp8 cache give
  the bytes the JAX package's ``astype`` gives, from float32 and bfloat16
  rows, including the values past e4m3's range (|x| > 464 is NaN there,
  where torch's own cast saturates); NaN is compared as NaN.
- The plain versions over an fp8 cache (K1, K2, K1u, K1m, K2m) against the
  Pallas kernels in interpret mode on the same bytes, at the tolerances of
  the full-precision comparisons (2e-4; the unified mode 2e-3, as
  tests/test_torch_unified.py): widening e4m3 is exact, so fp8 needs no
  tolerance of its own.
- K1um's plain version (``unified=True, v_cache=None``) against the Pallas
  kernel in interpret mode, over a float32 and an fp8 latent, on a mixed
  batch with a decode prefix, a pure-decode batch and one-token rows after
  a prefill row (2e-4).
- The engines: greedy streams identical to the JAX ``LLM``'s at float32
  for a tiny DeepSeek under ``unified_step`` (JAX: ``attention_impl=
  "pallas"``, which runs the Pallas unified kernel in interpret mode) and
  to the port's legacy stream, and for fp8 caches on the dense model, the
  DeepSeek model and one hybrid period; fp8 pages against bf16's; what
  ``EngineConfig.validate`` takes and refuses.
The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gllm_tpu.config import (CacheConfig as JCC, EngineConfig as JEC,
                             SchedulerConfig as JSC)
from gllm_tpu.engine.llm import LLM as JLLM
from gllm_tpu.models.config import ModelConfig as JMC
from gllm_tpu.models.config import from_hf_config as j_from_hf
from gllm_tpu.ops.kv_cache import write_kv as j_write_kv
from gllm_tpu.ops.pallas import tuning
from gllm_tpu.ops.pallas.decode_attention import paged_decode_attention
from gllm_tpu.ops.pallas.ragged_attention import ragged_paged_attention
from gllm_tpu.sampling_params import SamplingParams as JSP

import gllm_tpu_torch as gt
from gllm_tpu_torch.models import convert
from gllm_tpu_torch.models.registry import get_model_def
from gllm_tpu_torch.ops.cuda import decode_attention as tdec
from gllm_tpu_torch.ops.cuda import ragged_attention as trag
from gllm_tpu_torch.ops.kv_cache import write_kv, write_latent
from gllm_tpu_torch.runner.runner import ModelRunner

from test_torch_cuda import (DECODE_CASES, RAGGED_CASES, UNIFIED_CASES,
                             decode_case, ragged_case, unified_case)
from test_torch_engine import MLA, MODEL, _drive
from test_torch_gdn import HF as HYBRID
from test_torch_mla import MLA_RAGGED_CASES, V2, _pad

FP8 = torch.float8_e4m3fn
# e4m3's edge: 448 is its largest value, (448, 464] rounds to it and the
# JAX package's cast turns anything larger (and inf) into NaN
EDGE = [463.9, 464.0, 464.1, 470.0, 479.9, 480.0, 1e30, np.inf, -480.0,
        -np.inf, 448.0, -448.0, 0.0, -0.0, 2.0 ** -9, 2.0 ** -10, 1e-9]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _fp8(x):
    """float32 ``x`` cast to e4m3 by the JAX package's rule: the jnp array
    and a torch fp8 tensor of the same bytes."""
    j = jnp.asarray(x).astype(jnp.float8_e4m3fn)
    t = torch.from_numpy(np.asarray(j).view(np.uint8).copy()).view(FP8)
    return j, t


def _same_bytes(got, want):
    """fp8 caches byte-equal, NaN compared as NaN (not by its sign bit)."""
    g = got.view(torch.uint8).numpy()
    w = np.asarray(want).view(np.uint8)
    g_nan, w_nan = (g & 0x7F) == 0x7F, (w & 0x7F) == 0x7F
    np.testing.assert_array_equal(g_nan, w_nan)
    np.testing.assert_array_equal(g[~g_nan], w[~w_nan])


# ---- the write path -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("what", ["kv", "latent"])
def test_fp8_write_gives_the_bytes_jax_writes(what, dtype):
    rng = np.random.default_rng(30)
    P, page, H, D = 6, 4, 2, 16
    T = 9
    shape = (T, H, D) if what == "kv" else (T, H * D)
    # a spread of magnitudes inside e4m3's range (subnormals included),
    # and its edge cases in the first row
    rows = (rng.standard_normal(shape) * np.exp2(rng.integers(-12, 7, shape))
            ).astype(np.float32)
    rows.reshape(T, -1)[0, :len(EDGE)] = EDGE
    slots = np.array([5, 6, 7, 8, 13, 22, 23, 0, 1], np.int32)
    # the same input values in both packages: bf16 rows by their bits
    jrows = jnp.asarray(rows).astype(getattr(jnp, dtype))
    trows = torch.from_numpy(np.asarray(jrows).view(
        np.int16 if dtype == "bfloat16" else np.float32).copy()).view(
        getattr(torch, dtype))
    cache_shape = (P, page) + shape[1:]
    jc = jnp.zeros(cache_shape, jnp.float8_e4m3fn)
    tc = torch.zeros(cache_shape, dtype=FP8)
    if what == "kv":
        want, want_v = j_write_kv(jc, jc, jrows, -jrows, jnp.asarray(slots))
        tv = torch.zeros(cache_shape, dtype=FP8)
        write_kv(tc, tv, trows, -trows, torch.from_numpy(slots))
        _same_bytes(tv, want_v)
    else:
        # models/deepseek.py's scatter: flat.at[slots].set(entry.astype)
        flat = jc.reshape(P * page, -1)
        want = flat.at[jnp.asarray(slots)].set(
            jrows.astype(flat.dtype)).reshape(cache_shape)
        write_latent(tc, trows, torch.from_numpy(slots))
    _same_bytes(tc, want)
    # the edge reached NaN (bf16 rounds 464.1 to 464, which stays finite)
    assert np.isnan(np.asarray(want).astype(np.float32)).sum() >= 7


def test_fp8_cast_goes_straight_from_float32():
    """A float32 value next to a bf16 rounding tie: one cast to e4m3 (as
    JAX casts a float32 model's keys) and a cast through bf16 differ."""
    x = torch.tensor([1.0 + 2 ** -4 + 2 ** -9, 1.0 + 2 ** -4 + 2 ** -9])
    cache = torch.zeros((2, 1, 1, 1), dtype=FP8)
    write_kv(cache, torch.zeros_like(cache), x.view(2, 1, 1),
             x.view(2, 1, 1), torch.tensor([0, 1], dtype=torch.int32))
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.float8_e4m3fn))
    _same_bytes(cache.view(2), want)
    assert cache.float()[0].item() != x.bfloat16().to(FP8).float()[0].item()


# ---- plain versions over an fp8 cache against the Pallas kernels ----------

# one GQA case each for K1 (padded rows and tokens) and K2 (a one-key
# row): every distinct geometry costs a Pallas compile
FP8_CASES = ([("K1", 5), ("K2", 1)]
             + [("K1u", name) for name in UNIFIED_CASES]
             + [("K1m", name) for name in sorted(MLA_RAGGED_CASES)]
             + [("K2m", 0)])


@pytest.mark.parametrize("mode,case", FP8_CASES)
def test_fp8_plain_matches_pallas_interpret(mode, case):
    rng = np.random.default_rng(31)
    tol = dict(rtol=2e-4, atol=2e-4)
    if mode in ("K1", "K2"):
        c = (RAGGED_CASES if mode == "K1" else DECODE_CASES)[case]
        if mode == "K1":
            q, kc, vc, cu, kvl, pt = ragged_case(
                rng, c["seqs"], c["Hq"], c["Hkv"], c["D"], c["page"],
                c["pages"], c.get("pad_seqs", 0), c.get("pad_tokens", 0))
            index = (cu, kvl, pt)
        else:
            q, kc, vc, kvl, pt = decode_case(rng, c["kv_lens"], c["Hq"],
                                             c["Hkv"], c["D"], c["page"],
                                             c["pages"])
            index = (kvl, pt)
        (jk, tk), (jv, tv) = _fp8(kc), _fp8(vc)
        scale = c["D"] ** -0.5
        args = (jnp.asarray(q), jk, jv, *map(jnp.asarray, index))
        if mode == "K1":
            want = ragged_paged_attention(*args, scale=scale, q_block=8,
                                          kv_block=16, interpret=True)
            got = trag.ragged_paged_attention_plain(
                _t(q)[0], tk, tv, *_t(*index), scale=scale)
        else:
            want = paged_decode_attention(*args, scale=scale, kv_block=32,
                                          interpret=True)
            got = tdec.paged_decode_attention_plain(
                _t(q)[0], tk, tv, *_t(*index), scale=scale)
    elif mode == "K1u":
        q, kc, vc, _, _, cu, kvl, pt = unified_case(
            rng, UNIFIED_CASES[case], False)
        (jk, tk), (jv, tv) = _fp8(kc), _fp8(vc)
        want = ragged_paged_attention(
            jnp.asarray(q), jk, jv, *map(jnp.asarray, (cu, kvl, pt)),
            scale=0.2, q_block=4, kv_block=4, interpret=True, unified=True,
            group_size=1)
        got = trag.ragged_paged_attention_plain(
            _t(q)[0], tk, tv, *_t(cu, kvl, pt), scale=0.2, unified=True)
        tol = dict(rtol=2e-3, atol=2e-3)
    else:
        if mode == "K1m":
            q, lat, _, cu, kvl, pt = ragged_case(
                rng, **dict(MLA_RAGGED_CASES[case], Hq=16, Hkv=1, D=40,
                            page=4, num_pages=24))
        else:
            q, lat, _, kvl, pt = decode_case(rng, [8, 1, 13, 0, 16], 16, 1,
                                             40, 4, 24)
        jl, tl = _fp8(_pad(lat))
        tl = tl[..., :40].contiguous()
        scale = 24 ** -0.5
        if mode == "K1m":
            want = ragged_paged_attention(
                jnp.asarray(_pad(q)), jl, None,
                *map(jnp.asarray, (cu, kvl, pt)), scale=scale, q_block=8,
                kv_block=16, interpret=True, v_dim=32)
            got = trag.ragged_paged_attention_plain(
                _t(q)[0], tl, None, *_t(cu, kvl, pt), scale=scale, v_dim=32)
        else:
            want = paged_decode_attention(
                jnp.asarray(_pad(q)), jl, None, *map(jnp.asarray, (kvl, pt)),
                scale=scale, kv_block=32, interpret=True, v_dim=32)
            got = tdec.paged_decode_attention_plain(
                _t(q)[0], tl, None, *_t(kvl, pt), scale=scale, v_dim=32)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---- K1um: the unified step over a latent cache ---------------------------

@pytest.mark.parametrize("cache", ["fp", "fp8"])
@pytest.mark.parametrize("batch", ["mixed", "decode", "prefill_first"])
def test_unified_mla_plain_matches_pallas_interpret(batch, cache):
    """UNIFIED_CASES' geometry (T 24, S 8, 8 pages a row) over a latent of
    16 heads: a decode prefix before chunks ("mixed"), one-token rows only
    ("decode"), and one-token rows after a prefill row ("prefill_first")."""
    rng = np.random.default_rng(32)
    q, lat, _, _, _, cu, kvl, pt = unified_case(
        rng, UNIFIED_CASES[batch], False, Hq=16, Hkv=1, D=40, page=4,
        num_pages=64)
    jl, tl = jnp.asarray(_pad(lat)), _t(lat)[0]
    if cache == "fp8":
        jl, tl = _fp8(_pad(lat))
        tl = tl[..., :40].contiguous()
    want = ragged_paged_attention(
        jnp.asarray(_pad(q)), jl, None, *map(jnp.asarray, (cu, kvl, pt)),
        scale=0.2, q_block=4, kv_block=4, interpret=True, unified=True,
        group_size=1, v_dim=32)
    got = trag.ragged_paged_attention_plain(
        _t(q)[0], tl, None, *_t(cu, kvl, pt), scale=0.2, unified=True,
        v_dim=32)
    assert got.shape == (q.shape[0], 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# ---- the engines ----------------------------------------------------------

def _model(family, **hf_kw):
    """The port's and the JAX package's config of a tiny model of
    ``family`` (``hf_kw`` overrides HF keys)."""
    if family == "dense":
        return gt.ModelConfig(**MODEL), JMC(**MODEL)
    hf = dict(V2 if family == "deepseek" else HYBRID, vocab_size=512,
              **hf_kw)
    return gt.from_hf_config(hf), j_from_hf(hf)


def _engines(family, impl="xla", hf=None, **kw):
    """The JAX engine and a maker of the port's engines (keywords override
    ``EngineConfig``'s) on the same float32 weights, the port's dummy
    init from a seed. ``kw`` holds ``kv_cache_dtype`` and ``unified_step``.
    A 4-token prefill budget over at most 4 decode rows gives every step
    the JAX package's smallest token bucket, so JAX compiles one step."""
    tmc, jmc = _model(family, **(hf or {}))
    params = convert.to_jax_params(get_model_def(tmc).init_params(
        tmc, 3, torch.float32, "cpu"), tmc)
    kv = kw.pop("kv_cache_dtype", "auto")
    common = dict(dtype="float32", max_model_len=32, max_num_seqs=4, **kw)
    sched = dict(max_prefill_tokens=4, max_decode_seqs=4)
    jllm = JLLM(config=JEC(attention_impl=impl, scheduler=JSC(**sched),
                           cache=JCC(page_size=4, num_pages=32,
                                     kv_cache_dtype=kv), **common),
                model_cfg=jmc, params=jax.tree.map(jnp.asarray, params))

    def port(**over):
        return gt.LLM(config=gt.EngineConfig(
            scheduler=gt.SchedulerConfig(**sched),
            cache=gt.CacheConfig(page_size=4, num_pages=32,
                                 kv_cache_dtype=kv),
            **dict(common, **over)),
            model_cfg=tmc, params=convert.from_jax_params(params),
            device="cpu")
    return jllm, port


def _workload():
    """Two requests: a 9-token prompt in three chunks beside a 3-token one,
    then decode rows."""
    rng = np.random.default_rng(46)
    return ([rng.integers(1, 512, n).tolist() for n in (9, 3)], [5, 4],
            [True, True])


def test_deepseek_unified_greedy_identical_to_jax_and_legacy(monkeypatch,
                                                             tmp_path):
    """A 2-layer DeepSeek (one dense, one MoE layer) under the unified
    step: the JAX engine runs its Pallas unified kernel (interpret mode,
    with one-page blocks through the package's tuning-table override: its
    TPU blocks take minutes to compile for the CPU), the port its plain
    K1um; both streams equal the port's legacy one."""
    table = tmp_path / "tune.json"
    table.write_text(json.dumps({"default": {"unified": {
        "q_block": 4, "kv_block": 4, "group": 1}}}))
    monkeypatch.setenv("GLLM_TPU_TUNE_TABLE", str(table))
    tuning._table.cache_clear()
    try:
        jllm, port = _engines("deepseek", impl="pallas", unified_step=True,
                              hf=dict(num_hidden_layers=2))
        assert jllm.runner.fwd_attn_impl == "unified"
        prompts, max_tokens, ignore = _workload()
        want = _drive(jllm, JSP, prompts, max_tokens, ignore)
    finally:
        monkeypatch.delenv("GLLM_TPU_TUNE_TABLE")
        tuning._table.cache_clear()
        jax.clear_caches()      # no later trace reuses the small blocks
    before = dict(trag.ragged_paged_attention.launches)
    plain0 = trag.ragged_paged_attention_plain.calls
    unified = port()
    got = _drive(unified, gt.SamplingParams, prompts, max_tokens, ignore)
    legacy = _drive(port(unified_step=False), gt.SamplingParams, prompts,
                    max_tokens, ignore)
    assert got == want == legacy
    assert unified.runner.attn_impl == "unified"
    assert unified.step_counts["mixed"] and unified.step_counts["decode"]
    # on the CPU the wrapper took its plain version, on every step
    assert trag.ragged_paged_attention.launches == before
    assert trag.ragged_paged_attention_plain.calls > plain0
    mm = unified.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total


@pytest.mark.parametrize("family", ["dense", "deepseek", "hybrid"])
def test_fp8_engine_greedy_identical_to_jax(family):
    # DeepSeek: one dense and one MoE layer (each JAX layer group compiles)
    hf = dict(num_hidden_layers=2) if family == "deepseek" else None
    jllm, port = _engines(family, hf=hf, kv_cache_dtype="fp8")
    prompts, max_tokens, ignore = _workload()
    tllm = port()
    got = _drive(tllm, gt.SamplingParams, prompts, max_tokens, ignore)
    want = _drive(jllm, JSP, prompts, max_tokens, ignore)
    assert got == want
    assert tllm.runner.kv[0].dtype == FP8 and not tllm.runner.kv_quant
    assert tllm.step_counts["mixed"] and tllm.step_counts["decode"]
    mm = tllm.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total


@pytest.mark.parametrize("family", ["dense", "deepseek", "hybrid"])
def test_fp8_gets_at_least_1_99x_the_pages_of_bf16(family):
    tmc = _model(family)[0]

    def runner(kv):
        cfg = gt.EngineConfig(dtype="bfloat16", load_format="dummy",
                              max_model_len=128, max_num_seqs=4,
                              cache=gt.CacheConfig(page_size=16,
                                                   num_pages=8,
                                                   kv_cache_dtype=kv))
        return ModelRunner(cfg, tmc, "cpu")

    bf16, fp8 = runner("auto"), runner("fp8")
    assert fp8.kv[0].dtype == FP8 and not fp8.kv_quant
    if family == "dense":
        assert fp8.kv.k_scale is None           # no scale rows
    budget = 1 << 30
    ratio = ((budget // fp8.kv_bytes_per_page())
             / (budget // bf16.kv_bytes_per_page()))
    assert ratio >= 1.99, ratio
    assert 2 * fp8.kv_bytes_per_page() == bf16.kv_bytes_per_page()


def test_validate_takes_fp8_and_the_mla_unified_step():
    mla = gt.ModelConfig(**dict(MODEL, **MLA))
    hybrid = gt.from_hf_config(HYBRID)
    for dtype in ("bfloat16", "float16", "float32"):
        for model in (None, gt.ModelConfig(**MODEL), mla, hybrid):
            gt.EngineConfig(dtype=dtype, cache=gt.CacheConfig(
                kv_cache_dtype="fp8")).validate(model)
        for kv in ("auto", "fp8"):
            gt.EngineConfig(dtype=dtype, unified_step=True,
                            cache=gt.CacheConfig(kv_cache_dtype=kv)
                            ).validate(mla)
            # a hybrid model takes the flag and leaves it inert, as the JAX
            # engine does (tests/test_torch_unified_overlap.py)
            gt.EngineConfig(dtype=dtype, unified_step=True,
                            cache=gt.CacheConfig(kv_cache_dtype=kv)
                            ).validate(hybrid)
    refused = [
        (mla, dict(cache=gt.CacheConfig(kv_cache_dtype="int8")),
         "'int8' with an MLA"),
        (hybrid, dict(cache=gt.CacheConfig(kv_cache_dtype="int8")),
         "'int8' with a hybrid"),
        (hybrid, dict(cache=gt.CacheConfig(enable_prefix_caching=True)),
         "prefix_caching with a hybrid")]
    for model, kw, name in refused:
        with pytest.raises(NotImplementedError, match=name):
            gt.EngineConfig(**kw).validate(model)
