"""The port's CUDA kernels against their plain PyTorch versions, on the card:
ragged (K1, and K1q over an int8 cache), decode (K2, K2q), unified (K1u
over either cache), the MLA modes over a latent cache (K1m, K2m), K1 and
K2 at head_dim 256 and the gated-delta-rule chunk scan (K3), then the
engines (Llama-shaped, DeepSeek-shaped and hybrid) on the card against the
CPU; then the fp8 cache in every attention kernel, the unified step over
a latent cache (K1um), the fp8 write against the CPU's bytes, and the
engines over an fp8 cache or under the unified MLA step; the decode steps
as CUDA graphs, overlap scheduling and the pipelined loop over them,
blocks of decode steps (multi-step decode, on-device finish), persistent
slots, and the unified step under overlap (mixed re-forms, K1u and K1um's
decode class with hole rows).

Every test here is marked ``cuda`` and skips without a CUDA device; run
them on the card with

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which the card's
machine does not have). This module imports no jax; the case builders
here are shared with the CPU tests of tests/test_torch_attention.py.
"""

import numpy as np
import pytest
import torch

from gllm_tpu_torch.ops.cuda import decode_attention as tdec
from gllm_tpu_torch.ops.cuda import gdn_scan as tscan
from gllm_tpu_torch.ops.cuda import ragged_attention as trag
from gllm_tpu_torch.ops.cuda.common import GDN_DIMS, WIDE_HEAD_DIMS


def ragged_case(rng, seqs, Hq, Hkv, D, page, num_pages, pad_seqs=0,
                pad_tokens=0, first_page=1):
    """seqs: list of (q_len, kv_len), kv_len >= q_len. Padded seq rows
    repeat the last cu value with kv_len 0; padded tokens sit past
    cu[S]."""
    S = len(seqs) + pad_seqs
    T = sum(q for q, _ in seqs) + pad_tokens
    kc = rng.standard_normal((num_pages, page, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((num_pages, page, Hkv, D)).astype(np.float32)
    max_pages = max(-(-kv // page) for _, kv in seqs)
    pt = np.zeros((S, max_pages), np.int32)
    cu = np.zeros(S + 1, np.int32)
    kv_lens = np.zeros(S, np.int32)
    nxt, off = first_page, 0
    for i, (q_len, kv_len) in enumerate(seqs):
        n = -(-kv_len // page)
        pt[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
        kv_lens[i] = kv_len
        off += q_len
        cu[i + 1] = off
    cu[len(seqs) + 1:] = off
    assert nxt <= num_pages
    q = rng.standard_normal((T, Hq, D)).astype(np.float32)
    return q, kc, vc, cu, kv_lens, pt


def decode_case(rng, kv_lens, Hq, Hkv, D, page, num_pages):
    seqs = [(1, kv) for kv in kv_lens if kv]
    q, kc, vc, _, _, pt_live = ragged_case(rng, seqs, Hq, Hkv, D, page,
                                           num_pages)
    S = len(kv_lens)
    q = rng.standard_normal((S, Hq, D)).astype(np.float32)
    pt = np.zeros((S, pt_live.shape[1]), np.int32)
    pt[[i for i, kv in enumerate(kv_lens) if kv]] = pt_live
    return q, kc, vc, np.asarray(kv_lens, np.int32), pt


def int8_cache(rng, kc, vc):
    """int8 caches of kc's shape and per-page, per-kv-head scales, drawn as
    tests/test_unified_step.py draws them."""
    P, _, Hkv, _ = kc.shape
    k8, v8 = (rng.integers(-127, 128, kc.shape).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.02, (P, Hkv)).astype(np.float32)
              for _ in range(2))
    return k8, v8, ks, vs


# One geometry for every unified case (T 24 tokens, S 8 rows, 8 pages per
# row), so the Pallas kernel the CPU tests hold the plain version to
# compiles once per cache type.
UNIFIED_CASES = {
    "decode": dict(seqs=[(1, k) for k in (3, 9, 1, 14, 6, 2, 30, 8)],
                   pad_seqs=0, pad_tokens=16),
    "mixed": dict(seqs=[(1, k) for k in (3, 9, 14, 6, 30)]
                  + [(5, 9), (7, 7)], pad_seqs=1, pad_tokens=7),
    "prefill_first": dict(seqs=[(6, 6), (1, 9), (1, 5), (9, 29), (1, 3),
                                (1, 12)], pad_seqs=2, pad_tokens=5),
    "padded_tail": dict(seqs=[(1, 5), (1, 9), (1, 13), (6, 32)],
                        pad_seqs=4, pad_tokens=15),
}


def unified_case(rng, case, int8, Hq=8, Hkv=2, D=32, page=4, num_pages=64):
    """(q, k_cache, v_cache, k_scale, v_scale, cu, kv_lens, page_table);
    the scales are None for a full-precision cache."""
    q, kc, vc, cu, kvl, pt = ragged_case(
        rng, case["seqs"], Hq, Hkv, D, page, num_pages,
        case.get("pad_seqs", 0), case.get("pad_tokens", 0))
    ks = vs = None
    if int8:
        kc, vc, ks, vs = int8_cache(rng, kc, vc)
    return q, kc, vc, ks, vs, cu, kvl, pt


RAGGED_CASES = [
    # the GQA cases of tests/test_pallas_ragged_attention.py
    dict(seqs=[(12, 12)], Hq=4, Hkv=2, D=64, page=4, pages=8),
    dict(seqs=[(8, 29)], Hq=4, Hkv=2, D=64, page=4, pages=12),
    dict(seqs=[(1, 17), (9, 9), (1, 5), (13, 20)], Hq=8, Hkv=2, D=64,
         page=8, pages=16),
    dict(seqs=[(1, 3)] * 7 + [(21, 21)], Hq=4, Hkv=4, D=32, page=4,
         pages=24),
    dict(seqs=[(6, 6), (1, 9)], pad_seqs=3, Hq=4, Hkv=1, D=64, page=4,
         pages=8),
    # padded seq rows and padding tokens past cu[S], as the runner pads
    dict(seqs=[(5, 14), (1, 7), (3, 3)], pad_seqs=2, pad_tokens=5, Hq=4,
         Hkv=2, D=16, page=4, pages=12),
]

DECODE_CASES = [
    # the cases of tests/test_pallas_decode_attention.py
    dict(kv_lens=[7], Hq=4, Hkv=2, D=64, page=4, pages=8),
    dict(kv_lens=[5, 16, 1, 33], Hq=8, Hkv=2, D=64, page=8, pages=16),
    dict(kv_lens=[100, 3], Hq=4, Hkv=4, D=128, page=16, pages=16),
    dict(kv_lens=[9, 0, 12, 0], Hq=4, Hkv=1, D=64, page=4, pages=12),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


MAIN_PATH_RAGGED = dict(
    seqs=[(1, 300 + 37 * i) for i in range(24)]
    + [(512, 1536), (300, 700), (1024, 1024)],
    pad_seqs=5, pad_tokens=29, Hq=32, Hkv=8, D=64, page=16, pages=1400)

# 16-bit inputs: both sides read the same values and accumulate in f32; the
# kernel's output is rounded once (bf16: relative 2^-8) and the ragged
# kernel rounds its softmax probabilities to the input type for the tensor
# cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}


# ---- the wgmma ragged block (csrc/ragged_wgmma.cuh): cases added to the
# ragged and unified tests below. Each runs through _block_check: a layer
# of NaN before the cache (read with page_offset = its pages; int8: NaN
# scales), NaN in the read layer's dummy page 0, and, with "drop", a plain
# version that leaves out the last key of every one-token row, which the
# tolerance must reject.
BLOCK_CASES = [
    # GQA groups that do not divide 64: 5, 6, 7 at D 128 (partly filled
    # 64-row tiles); G 7 with a decode prefix, a mid-context chunk whose
    # 1000 keys wrap the ring four times and a ragged one-token row
    dict(seqs=[(130, 400), (1, 77), (65, 65), (9, 300)], Hq=10, Hkv=2,
         D=128, page=16, pages=60),
    dict(seqs=[(63, 200), (1, 9), (64, 64)], pad_seqs=1, Hq=12, Hkv=2,
         D=128, page=8, pages=50),
    dict(seqs=[(1, 40)] * 3 + [(130, 1000), (1, 5), (9, 33)], pad_seqs=2,
         pad_tokens=50, Hq=14, Hkv=2, D=128, page=16, pages=80, drop=True),
    # token counts 1, 9, 63, 64, 65 and 130 in the ragged class, pages of 32
    dict(seqs=[(9, 40), (1, 30), (63, 63), (64, 200), (65, 300), (130, 130),
               (1, 3)], Hq=8, Hkv=2, D=64, page=32, pages=40, drop=True),
    # head dim 32 (padded to 64 in the block), pages of 4
    dict(seqs=[(20, 50), (1, 6), (70, 90)], pad_tokens=5, Hq=4, Hkv=1, D=32,
         page=4, pages=40),
    # very unequal sequences (the longest-first order), G 1, pages of 8
    dict(seqs=[(700, 2000), (3, 3), (1, 900), (200, 1200), (2, 40)],
         pad_seqs=3, pad_tokens=21, Hq=8, Hkv=8, D=64, page=8, pages=530),
    # D 128 at G 4: a long decode prefix row, a mid-context chunk
    dict(seqs=[(1, 1500), (40, 1000), (1, 2)], Hq=16, Hkv=4, D=128,
         page=16, pages=170, drop=True),
]
# head dim 256 (a full-precision or an fp8 cache; two ring stages: the
# 1000 keys wrap it eight times)
BLOCK_CASES_D256 = [
    dict(seqs=[(40, 1000), (1, 7), (65, 65)], Hq=16, Hkv=2, D=256, page=16,
         pages=75, drop=True),
]
for _c in BLOCK_CASES + BLOCK_CASES_D256:
    _c["block"] = True


def _block_check(device, case, dtype, cache, unified=False):
    """A ragged-block case on the card over a full-precision ("fp"),
    "int8" or "fp8" cache: the kernel against the plain version."""
    rng = np.random.default_rng(40)
    q, kc, vc, cu, kvl, pt = ragged_case(
        rng, case["seqs"], case["Hq"], case["Hkv"], case["D"],
        case["page"], case["pages"], case.get("pad_seqs", 0),
        case.get("pad_tokens", 0))
    ks = vs = None
    if cache == "int8":
        kc, vc, ks, vs = int8_cache(rng, kc, vc)
    P = kc.shape[0]

    def on_card(c):
        t = torch.from_numpy(c).to(device)
        return {"fp": lambda: t.to(dtype), "int8": lambda: t,
                "fp8": lambda: t.to(FP8)}[cache]()

    clean = [on_card(c) for c in (kc, vc)]
    # the kernel's caches: [a skipped layer | the read layer], NaN in the
    # skipped layer and in page 0 of the read one (int8: in their scales)
    kern = []
    for c in clean:
        both = torch.cat([c, c])
        bad = (both.view(torch.uint8) if cache == "fp8" else both)
        if cache == "fp":
            bad[:P] = float("nan")
            bad[P] = float("nan")
        elif cache == "fp8":
            bad[:P] = 0x7F
            bad[P] = 0x7F
        kern.append(both)
    scales = clean_scales = {}
    if cache == "int8":
        ks, vs = (torch.from_numpy(a).to(device) for a in (ks, vs))
        ks[0] = 0.0
        vs[0] = 0.0
        nan = torch.full_like(ks, float("nan"))
        scales = dict(k_scale=torch.cat([nan, ks]),
                      v_scale=torch.cat([nan, vs]))
        scales["k_scale"][P] = float("nan")
        scales["v_scale"][P] = float("nan")
        clean_scales = dict(k_scale=ks, v_scale=vs)
    q = torch.from_numpy(q).to(device, dtype)
    cu, kvl, pt = (torch.from_numpy(a).to(device) for a in (cu, kvl, pt))
    scale = case["D"] ** -0.5
    out = trag.ragged_paged_attention(q, *kern, cu, kvl, pt, scale=scale,
                                      page_offset=P, unified=unified,
                                      **scales)
    if cache == "fp":
        clean = [torch.nan_to_num(c) for c in clean]
    want = trag.ragged_paged_attention_plain(q, *clean, cu, kvl, pt,
                                             scale=scale, unified=unified,
                                             **clean_scales)
    _check(out, want, dtype)
    if case.get("drop"):
        drop = _one_token_rows(case["seqs"], case.get("pad_seqs", 0), device)
        dropped = trag.ragged_paged_attention_plain(
            q, *clean, cu, kvl - drop, pt, scale=scale, unified=unified,
            **clean_scales)
        assert not torch.allclose(out.float(), dropped.float(),
                                  rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", RAGGED_CASES + [
    dict(seqs=[(40, 40), (1, 70), (17, 90)], Hq=8, Hkv=8, D=64, page=16,
         pages=16),
    dict(seqs=[(9, 33), (1, 5)], pad_tokens=7, Hq=16, Hkv=2, D=128,
         page=8, pages=12),
    MAIN_PATH_RAGGED] + BLOCK_CASES)
def test_ragged_kernel_matches_plain(cuda_device, case, dtype):
    if case.get("block"):
        return _block_check(cuda_device, case, dtype, "fp")
    rng = np.random.default_rng(3)
    q, kc, vc, cu, kvl, pt = ragged_case(
        rng, case["seqs"], case["Hq"], case["Hkv"], case["D"],
        case["page"], case["pages"], case.get("pad_seqs", 0),
        case.get("pad_tokens", 0))
    if case["D"] not in WIDE_HEAD_DIMS:
        pytest.skip(f"kernel head dims are {WIDE_HEAD_DIMS}")
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kc, vc, cu, kvl, pt)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    scale = case["D"] ** -0.5
    # garbage in the unread dummy page must not reach the output
    args[1][0] = float("nan")
    args[2][0] = float("nan")
    out = trag.ragged_paged_attention(*args, scale=scale)
    want = trag.ragged_paged_attention_plain(
        args[0], torch.nan_to_num(args[1]), torch.nan_to_num(args[2]),
        *args[3:], scale=scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", DECODE_CASES + [
    dict(kv_lens=[int(x) for x in
                  np.random.default_rng(0).integers(256, 2048, 32)],
         Hq=32, Hkv=8, D=64, page=16, pages=4200),
    dict(kv_lens=[31, 64, 0, 65], Hq=16, Hkv=2, D=32, page=16, pages=16),
    # many key splits, a split boundary hit exactly, and padded rows
    dict(kv_lens=[3000, 0, 257, 1, 256], Hq=8, Hkv=2, D=128, page=16,
         pages=240)])
def test_decode_kernel_matches_plain(cuda_device, case, dtype):
    rng = np.random.default_rng(4)
    q, kc, vc, kvl, pt = decode_case(rng, case["kv_lens"], case["Hq"],
                                     case["Hkv"], case["D"], case["page"],
                                     case["pages"])
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kc, vc, kvl, pt)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    args[1][0] = float("nan")
    args[2][0] = float("nan")
    scale = case["D"] ** -0.5
    out = tdec.paged_decode_attention(*args, scale=scale, page_offset=0)
    want = tdec.paged_decode_attention_plain(
        args[0], torch.nan_to_num(args[1]), torch.nan_to_num(args[2]),
        *args[3:], scale=scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _on_card(device, dtype, q, kc, vc, ks, vs, *index):
    """The case on the card: q (and a full-precision cache) in ``dtype``;
    the dummy page 0, which no kernel may read, gets NaN payload or NaN
    scales. Returns (kernel args, plain args with the NaNs zeroed)."""
    q = torch.from_numpy(q).to(device, dtype)
    index = [torch.from_numpy(a).to(device) for a in index]
    if ks is None:
        kc, vc = (torch.from_numpy(a).to(device, dtype) for a in (kc, vc))
        kc[0] = float("nan")
        vc[0] = float("nan")
        scales = dict()
        clean = dict(k_cache=torch.nan_to_num(kc),
                     v_cache=torch.nan_to_num(vc))
    else:
        kc, vc, ks, vs = (torch.from_numpy(a).to(device)
                          for a in (kc, vc, ks, vs))
        ks[0] = float("nan")
        vs[0] = float("nan")
        scales = dict(k_scale=ks, v_scale=vs)
        clean = dict(k_cache=kc, v_cache=vc, k_scale=torch.nan_to_num(ks),
                     v_scale=torch.nan_to_num(vs))
    kernel = dict(dict(k_cache=kc, v_cache=vc), **scales)
    return q, index, kernel, clean


def _check(out, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [RAGGED_CASES[2], RAGGED_CASES[3],
                                  dict(seqs=[(9, 33), (1, 5)], pad_tokens=7,
                                       Hq=16, Hkv=2, D=128, page=8,
                                       pages=12),
                                  MAIN_PATH_RAGGED] + BLOCK_CASES)
def test_ragged_int8_kernel_matches_plain(cuda_device, case, dtype):
    if case.get("block"):
        return _block_check(cuda_device, case, dtype, "int8")
    rng = np.random.default_rng(13)
    q, kc, vc, ks, vs, cu, kvl, pt = unified_case(
        rng, case, True, case["Hq"], case["Hkv"], case["D"], case["page"],
        case["pages"])
    q, idx, kern, clean = _on_card(cuda_device, dtype, q, kc, vc, ks, vs,
                                   cu, kvl, pt)
    scale = case["D"] ** -0.5
    out = trag.ragged_paged_attention(q, cu_q_lens=idx[0], kv_lens=idx[1],
                                      page_table=idx[2], scale=scale, **kern)
    want = trag.ragged_paged_attention_plain(
        q, cu_q_lens=idx[0], kv_lens=idx[1], page_table=idx[2], scale=scale,
        **clean)
    _check(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    DECODE_CASES[1], DECODE_CASES[2],
    dict(kv_lens=[int(x) for x in
                  np.random.default_rng(0).integers(256, 2048, 32)],
         Hq=32, Hkv=8, D=64, page=16, pages=4200),
    dict(kv_lens=[3000, 0, 257, 1, 256], Hq=8, Hkv=2, D=32, page=16,
         pages=240)])
def test_decode_int8_kernel_matches_plain(cuda_device, case, dtype):
    rng = np.random.default_rng(14)
    q, kc, vc, kvl, pt = decode_case(rng, case["kv_lens"], case["Hq"],
                                     case["Hkv"], case["D"], case["page"],
                                     case["pages"])
    kc, vc, ks, vs = int8_cache(rng, kc, vc)
    q, idx, kern, clean = _on_card(cuda_device, dtype, q, kc, vc, ks, vs,
                                   kvl, pt)
    scale = case["D"] ** -0.5
    out = tdec.paged_decode_attention(q, kv_lens=idx[0], page_table=idx[1],
                                      scale=scale, **kern)
    want = tdec.paged_decode_attention_plain(
        q, kv_lens=idx[0], page_table=idx[1], scale=scale, **clean)
    _check(out, want, dtype)


UNIFIED_CARD_CASES = [
    dict(UNIFIED_CASES[n], Hq=8, Hkv=2, D=32, page=4, pages=64)
    for n in UNIFIED_CASES] + [
    # group 1, many-split contexts, rows after the decode prefix, padding
    dict(seqs=[(1, 3000), (1, 257), (1, 1), (40, 40), (1, 70)], pad_seqs=2,
         pad_tokens=9, Hq=8, Hkv=8, D=64, page=16, pages=240),
    dict(seqs=[(9, 33), (1, 5), (1, 600)], pad_tokens=7, Hq=16, Hkv=2,
         D=128, page=8, pages=100),
    # the main path's shapes: a pure-decode batch and the mixed batch
    dict(seqs=[(1, int(x)) for x in
               np.random.default_rng(0).integers(256, 2048, 32)],
         Hq=32, Hkv=8, D=64, page=16, pages=4200),
    MAIN_PATH_RAGGED]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", UNIFIED_CARD_CASES + BLOCK_CASES)
def test_unified_kernel_matches_plain(cuda_device, case, dtype, int8):
    if case.get("block"):
        return _block_check(cuda_device, case, dtype,
                            "int8" if int8 else "fp", unified=True)
    rng = np.random.default_rng(15)
    arrays = unified_case(rng, case, int8, case["Hq"], case["Hkv"],
                          case["D"], case["page"], case["pages"])
    q, idx, kern, clean = _on_card(cuda_device, dtype, *arrays)
    scale = case["D"] ** -0.5
    md = dict(cu_q_lens=idx[0], kv_lens=idx[1], page_table=idx[2])
    out = trag.ragged_paged_attention(q, **md, scale=scale, unified=True,
                                      **kern)
    want = trag.ragged_paged_attention_plain(q, **md, scale=scale,
                                             unified=True, **clean)
    _check(out, want, dtype)


@pytest.mark.cuda
def test_new_wrapper_arguments_count_and_refuse(cuda_device):
    rng = np.random.default_rng(16)
    case = UNIFIED_CASES["mixed"]
    q, kc, vc, ks, vs, cu, kvl, pt = (
        None if a is None else torch.from_numpy(a).to(cuda_device)
        for a in unified_case(rng, case, True))
    md = (cu, kvl, pt)
    counts = trag.ragged_paged_attention.launches
    before = dict(counts)
    trag.ragged_paged_attention(q, kc, vc, *md, scale=0.2, k_scale=ks,
                                v_scale=vs)
    trag.ragged_paged_attention(q, kc, vc, *md, scale=0.2, k_scale=ks,
                                v_scale=vs, unified=True)
    trag.ragged_paged_attention(q, kc.float(), vc.float(), *md, scale=0.2,
                                unified=True)
    assert {k: counts[k] - before[k] for k in counts
            if counts[k] != before[k]} == {
        "ragged_paged_attention_int8": 1,
        "ragged_paged_attention_unified": 1,
        "ragged_paged_attention_unified_int8": 1}
    d0 = dict(tdec.paged_decode_attention.launches)
    dq = q[:5].contiguous()
    tdec.paged_decode_attention(dq, kc, vc, kvl[:5].contiguous(),
                                pt[:5].contiguous(), scale=0.2, k_scale=ks,
                                v_scale=vs)
    assert tdec.paged_decode_attention.launches[
        "paged_decode_attention_int8"] == d0["paged_decode_attention_int8"] + 1
    with pytest.raises(ValueError, match="both"):
        trag.ragged_paged_attention(q, kc, vc, *md, scale=0.2, k_scale=ks)
    with pytest.raises(ValueError, match="dtype"):       # int8, no scales
        trag.ragged_paged_attention(q, kc, vc, *md, scale=0.2)
    with pytest.raises(ValueError, match="float32"):
        tdec.paged_decode_attention(dq, kc, vc, kvl[:5].contiguous(),
                                    pt[:5].contiguous(), scale=0.2,
                                    k_scale=ks.half(), v_scale=vs.half())
    with pytest.raises(ValueError, match=r"\[P, Hkv\]"):
        trag.ragged_paged_attention(q, kc, vc, *md, scale=0.2,
                                    k_scale=ks[1:], v_scale=vs[1:],
                                    unified=True)
    # the unified kernel's decode blocks take at most 16 query heads per
    # kv head
    q32 = torch.zeros((q.shape[0], 32, q.shape[2]), device=cuda_device)
    k1 = kc[:, :, :1].contiguous()
    with pytest.raises(ValueError, match="at most 16"):
        trag.ragged_paged_attention(q32, k1.float(), k1.float(), *md,
                                    scale=0.2, unified=True)
    assert {k: counts[k] - before[k] for k in counts}[
        "ragged_paged_attention_unified"] == 1


@pytest.mark.cuda
def test_kernel_page_offset_and_launch_count(cuda_device):
    rng = np.random.default_rng(5)
    P = 12
    q, kc, vc, cu, kvl, pt = ragged_case(rng, [(5, 14), (1, 7)], 8, 2, 64,
                                         4, P)
    k_all = np.concatenate([np.zeros_like(kc), kc])
    v_all = np.concatenate([np.zeros_like(vc), vc])
    dev = [torch.from_numpy(a).to(cuda_device)
           for a in (q, k_all, v_all, cu, kvl, pt)]
    n0 = trag.ragged_paged_attention.launches["ragged_paged_attention"]
    got = trag.ragged_paged_attention(*dev, scale=0.125, page_offset=P)
    assert (trag.ragged_paged_attention.launches["ragged_paged_attention"]
            == n0 + 1)
    want = trag.ragged_paged_attention_plain(
        *[torch.from_numpy(a) for a in (q, kc, vc, cu, kvl, pt)],
        scale=0.125)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

    q, kc, vc, kvl, pt = decode_case(rng, [700, 0, 9], 8, 2, 64, 4, 200)
    k_all = np.concatenate([np.zeros_like(kc), kc])
    v_all = np.concatenate([np.zeros_like(vc), vc])
    n0 = tdec.paged_decode_attention.launches["paged_decode_attention"]
    got = tdec.paged_decode_attention(
        *[torch.from_numpy(a).to(cuda_device)
          for a in (q, k_all, v_all, kvl, pt)], scale=0.125, page_offset=200)
    assert (tdec.paged_decode_attention.launches["paged_decode_attention"]
            == n0 + 1)
    want = tdec.paged_decode_attention_plain(
        *[torch.from_numpy(a) for a in (q, kc, vc, kvl, pt)], scale=0.125)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.default_rng(6)
    q, kc, vc, cu, kvl, pt = ragged_case(rng, [(3, 9)], 4, 2, 48, 4, 8)
    dev = [torch.from_numpy(a).to(cuda_device)
           for a in (q, kc, vc, cu, kvl, pt)]
    with pytest.raises(ValueError, match="head_dim"):
        trag.ragged_paged_attention(*dev, scale=0.1)
    q, kc, vc, cu, kvl, pt = ragged_case(rng, [(3, 9)], 4, 2, 64, 4, 8)
    dev = [torch.from_numpy(a).to(cuda_device)
           for a in (q, kc, vc, cu, kvl, pt)]
    with pytest.raises(ValueError, match="int32"):
        trag.ragged_paged_attention(*dev[:4], dev[4].long(), dev[5],
                                    scale=0.1)
    with pytest.raises(ValueError, match="dtype"):
        trag.ragged_paged_attention(dev[0].bfloat16(), *dev[1:], scale=0.1)


def _tiny_engine(device, params=None, dtype="float32",
                 kv_cache_dtype="auto", **cfg):
    import gllm_tpu_torch as gt
    mc = gt.ModelConfig(architecture="LlamaForCausalLM", vocab_size=1000,
                        hidden_size=256, num_layers=2, num_heads=8,
                        num_kv_heads=2, head_dim=32, intermediate_size=512,
                        max_position=512, rope_theta=500000.0)
    ec = gt.EngineConfig(
        dtype=dtype, load_format="dummy", max_model_len=512,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=48),
        cache=gt.CacheConfig(page_size=16, num_pages=64,
                             kv_cache_dtype=kv_cache_dtype), **cfg)
    return gt.LLM(model_cfg=mc, config=ec, params=params, device=device)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_greedy(cuda_device):
    """The same float32 weights through the card (CUDA kernels) and the CPU
    (plain versions): chunked prefill, mixed and decode steps give the same
    greedy tokens."""
    import gllm_tpu_torch as gt
    from gllm_tpu_torch.ops.cuda import decode_attention as dec
    card = _tiny_engine(cuda_device)
    cpu_params = {"layers": {k: v.cpu() for k, v in
                             card.runner.params["layers"].items()},
                  **{k: v.cpu() for k, v in card.runner.params.items()
                     if k != "layers"}}
    cpu = _tiny_engine("cpu", params=cpu_params)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 1000, n).tolist() for n in (7, 60, 23, 100)]
    sp = gt.SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    r0 = trag.ragged_paged_attention.launches["ragged_paged_attention"]
    d0 = dec.paged_decode_attention.launches["paged_decode_attention"]
    got = [o.output_token_ids for o in card.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    want = [o.output_token_ids for o in cpu.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    assert got == want
    assert trag.ragged_paged_attention.launches["ragged_paged_attention"] > r0
    assert dec.paged_decode_attention.launches["paged_decode_attention"] > d0
    mm = card.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,kernels", [
    (dict(cache_dtype="int8"), ("ragged_paged_attention_int8",
                                "paged_decode_attention_int8")),
    (dict(unified_step=True), ("ragged_paged_attention_unified",)),
    (dict(unified_step=True, cache_dtype="int8"),
     ("ragged_paged_attention_unified_int8",)),
    (dict(cache_dtype="fp8"), ("ragged_paged_attention_fp8",
                               "paged_decode_attention_fp8")),
    (dict(unified_step=True, cache_dtype="fp8"),
     ("ragged_paged_attention_unified_fp8",))])
def test_int8_and_unified_engines_on_card_match_cpu_greedy(cuda_device, cfg,
                                                          kernels):
    """The same float32 weights through the card and the CPU with an int8
    cache, the unified step, or both: the same greedy tokens, and only
    the configuration's kernels launched."""
    import gllm_tpu_torch as gt
    cfg = dict(cfg)
    cache_dtype = cfg.pop("cache_dtype", "auto")

    def engine(device, params=None):
        mc = gt.ModelConfig(architecture="LlamaForCausalLM", vocab_size=1000,
                            hidden_size=256, num_layers=2, num_heads=8,
                            num_kv_heads=2, head_dim=32,
                            intermediate_size=512, max_position=512,
                            rope_theta=500000.0)
        ec = gt.EngineConfig(
            dtype="float32", load_format="dummy", max_model_len=512,
            scheduler=gt.SchedulerConfig(max_prefill_tokens=48),
            cache=gt.CacheConfig(page_size=16, num_pages=64,
                                 kv_cache_dtype=cache_dtype), **cfg)
        return gt.LLM(model_cfg=mc, config=ec, params=params, device=device)

    card = engine(cuda_device)
    cpu = engine("cpu", params={
        "layers": {k: v.cpu() for k, v in
                   card.runner.params["layers"].items()},
        **{k: v.cpu() for k, v in card.runner.params.items()
           if k != "layers"}})
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 1000, n).tolist() for n in (7, 60, 23, 100)]
    sp = gt.SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    launches = {**trag.ragged_paged_attention.launches,
                **tdec.paged_decode_attention.launches}
    got = [o.output_token_ids for o in card.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    want = [o.output_token_ids for o in cpu.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    assert got == want
    ran = {k for k, n in {**trag.ragged_paged_attention.launches,
                          **tdec.paged_decode_attention.launches}.items()
           if n > launches[k]}
    assert ran == set(kernels)
    mm = card.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total


@pytest.mark.cuda
def test_sampled_generation_on_card(cuda_device):
    import gllm_tpu_torch as gt
    prompts = [[1, 2, 3, 4, 5], list(range(10, 40))]
    runs = []
    for _ in range(2):
        llm = _tiny_engine(cuda_device, seed=7)
        runs.append([o.output_token_ids for o in llm.generate(
            prompt_token_ids=prompts,
            sampling_params=gt.SamplingParams(temperature=0.9, top_k=50,
                                              top_p=0.9, min_p=0.01,
                                              max_tokens=10,
                                              ignore_eos=True))])
    assert runs[0] == runs[1]                 # the seeded generator
    assert all(len(t) == 10 and all(0 <= x < 1000 for x in t)
               for t in runs[0])


# MLA over a latent cache [P, page, 1, Dl], values = its leading Dv lanes:
# the small test geometry (96, 64) and DeepSeek-V2-Lite's (576, 512)
MLA_RAGGED_CARD_CASES = [
    dict(seqs=[(6, 6), (1, 9), (1, 5), (9, 29), (1, 3)], pad_seqs=2,
         pad_tokens=5, Dl=96, Dv=64, page=4, pages=24),
    dict(seqs=[(1, 300), (40, 40), (1, 70), (17, 90), (5, 5), (1, 1)],
         pad_tokens=9, Dl=96, Dv=64, page=16, pages=40),
    dict(seqs=[(1, 300 + 37 * i) for i in range(8)]
         + [(200, 700), (130, 130)], pad_seqs=2, pad_tokens=11, Dl=576,
         Dv=512, page=16, pages=300),
]
MLA_DECODE_CARD_CASES = [
    dict(kv_lens=[8, 1, 13, 0, 16], Dl=96, Dv=64, page=4, pages=24),
    dict(kv_lens=[3000, 0, 257, 1, 256], Dl=96, Dv=64, page=16, pages=240),
    dict(kv_lens=[int(x) for x in
                  np.random.default_rng(0).integers(256, 2048, 32)],
         Dl=576, Dv=512, page=16, pages=4200),
]


def _mla_check(out, want, dropped, dtype):
    """The kernel against its plain version, and the tolerance against the
    plain version with the last key of every one-token row dropped."""
    _check(out, want, dtype)
    assert not torch.allclose(dropped.float(), want.float(), rtol=TOL[dtype],
                              atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MLA_RAGGED_CARD_CASES)
def test_mla_ragged_kernel_matches_plain(cuda_device, case, dtype):
    rng = np.random.default_rng(17)
    q, lat, _, cu, kvl, pt = ragged_case(
        rng, case["seqs"], 16, 1, case["Dl"], case["page"], case["pages"],
        case.get("pad_seqs", 0), case.get("pad_tokens", 0))
    q, idx, kern, clean = _on_card(cuda_device, dtype, q, lat, lat, None,
                                   None, cu, kvl, pt)
    kw = dict(cu_q_lens=idx[0], page_table=idx[2],
              scale=2.0 * case["Dl"] ** -0.5, v_dim=case["Dv"])
    out = trag.ragged_paged_attention(q, kern["k_cache"], None,
                                      kv_lens=idx[1], **kw)
    want = trag.ragged_paged_attention_plain(q, clean["k_cache"], None,
                                             kv_lens=idx[1], **kw)
    one_tok = torch.tensor([int(ql == 1) for ql, _ in case["seqs"]]
                           + [0] * case.get("pad_seqs", 0),
                           dtype=torch.int32, device=cuda_device)
    dropped = trag.ragged_paged_attention_plain(
        q, clean["k_cache"], None, kv_lens=idx[1] - one_tok, **kw)
    assert out.shape == (q.shape[0], 16, case["Dv"])
    _mla_check(out, want, dropped, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MLA_DECODE_CARD_CASES)
def test_mla_decode_kernel_matches_plain(cuda_device, case, dtype):
    rng = np.random.default_rng(18)
    q, lat, _, kvl, pt = decode_case(rng, case["kv_lens"], 16, 1, case["Dl"],
                                     case["page"], case["pages"])
    q, idx, kern, clean = _on_card(cuda_device, dtype, q, lat, lat, None,
                                   None, kvl, pt)
    kw = dict(page_table=idx[1], scale=2.0 * case["Dl"] ** -0.5,
              v_dim=case["Dv"])
    out = tdec.paged_decode_attention(q, kern["k_cache"], None,
                                      kv_lens=idx[0], **kw)
    want = tdec.paged_decode_attention_plain(q, clean["k_cache"], None,
                                             kv_lens=idx[0], **kw)
    dropped = tdec.paged_decode_attention_plain(
        q, clean["k_cache"], None, kv_lens=idx[0] - (idx[0] > 0).int(),
        **kw)
    _mla_check(out, want, dropped, dtype)


@pytest.mark.cuda
def test_mla_wrappers_count_offset_and_refuse(cuda_device):
    rng = np.random.default_rng(19)
    P = 24
    q, lat, _, cu, kvl, pt = ragged_case(rng, [(5, 14), (1, 7)], 16, 1, 96,
                                         4, P)
    stack = np.concatenate([np.zeros_like(lat), lat])   # layer 1 = the case
    q, stack, cu, kvl, pt = (torch.from_numpy(a).to(cuda_device)
                             for a in (q, stack, cu, kvl, pt))
    r0 = dict(trag.ragged_paged_attention.launches)
    d0 = dict(tdec.paged_decode_attention.launches)
    got = trag.ragged_paged_attention(q, stack, None, cu, kvl, pt, scale=0.2,
                                      page_offset=P, v_dim=64)
    want = trag.ragged_paged_attention_plain(q, stack[P:], None, cu, kvl, pt,
                                             scale=0.2, v_dim=64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    dq = q[cu[1:] - 1].contiguous()
    got = tdec.paged_decode_attention(dq, stack, None, kvl, pt, scale=0.2,
                                      page_offset=P, v_dim=64)
    want = tdec.paged_decode_attention_plain(dq, stack[P:], None, kvl, pt,
                                             scale=0.2, v_dim=64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert {k: n - r0[k] for k, n in
            trag.ragged_paged_attention.launches.items() if n != r0[k]} == {
        "ragged_paged_attention_mla": 1}
    assert {k: n - d0[k] for k, n in
            tdec.paged_decode_attention.launches.items() if n != d0[k]} == {
        "paged_decode_attention_mla": 1}
    with pytest.raises(NotImplementedError, match="32"):   # 32 query heads
        trag.ragged_paged_attention(torch.cat([q, q], 1), stack, None, cu,
                                    kvl, pt, scale=0.2, v_dim=64)
    with pytest.raises(NotImplementedError, match="v_dim"):
        tdec.paged_decode_attention(dq, stack, None, kvl, pt, scale=0.2,
                                    v_dim=32)
    # the unified step's MLA kernel (K1um) at the same offset
    got = trag.ragged_paged_attention(q, stack, None, cu, kvl, pt, scale=0.2,
                                      page_offset=P, v_dim=64, unified=True)
    want = trag.ragged_paged_attention_plain(q, stack[P:], None, cu, kvl, pt,
                                             scale=0.2, v_dim=64,
                                             unified=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert trag.ragged_paged_attention.launches[
        "ragged_paged_attention_unified_mla"] == r0[
        "ragged_paged_attention_unified_mla"] + 1
    with pytest.raises(NotImplementedError, match="int8"):
        trag.ragged_paged_attention(q, stack, None, cu, kvl, pt, scale=0.2,
                                    v_dim=64, unified=True,
                                    k_scale=kvl.float(), v_scale=kvl.float())
    with pytest.raises(ValueError, match="dtype"):
        trag.ragged_paged_attention(q.bfloat16(), stack, None, cu, kvl, pt,
                                    scale=0.2, v_dim=64)


def _deepseek_engine(device, params=None, kv_cache_dtype="auto",
                     dtype="float32", **cfg):
    """A 2-layer DeepSeek-V2-shaped model (one dense layer, one MoE layer)
    at the MLA kernels' small geometry: 16 heads, latent 64 + 32; ``cfg``
    adds EngineConfig keywords."""
    import gllm_tpu_torch as gt
    mc = gt.from_hf_config(dict(
        architectures=["DeepseekV2ForCausalLM"], vocab_size=1000,
        hidden_size=256, num_hidden_layers=2, num_attention_heads=16,
        num_key_value_heads=16, intermediate_size=512,
        max_position_embeddings=512, kv_lora_rank=64, qk_nope_head_dim=32,
        qk_rope_head_dim=32, v_head_dim=32, n_routed_experts=8,
        num_experts_per_tok=2, moe_intermediate_size=128,
        first_k_dense_replace=1, n_shared_experts=1, q_lora_rank=None,
        topk_method="greedy", scoring_func="softmax", norm_topk_prob=False))
    ec = gt.EngineConfig(
        dtype=dtype, load_format="dummy", max_model_len=512,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=48),
        cache=gt.CacheConfig(page_size=16, num_pages=64,
                             kv_cache_dtype=kv_cache_dtype), **cfg)
    return gt.LLM(model_cfg=mc, config=ec, params=params, device=device)


@pytest.mark.cuda
def test_deepseek_engine_on_card_matches_cpu_greedy(cuda_device):
    """The same float32 DeepSeek weights through the card (K1m, K2m, the
    grouped expert product) and the CPU: the same greedy tokens, and only
    the MLA kernels launched."""
    import gllm_tpu_torch as gt
    card = _deepseek_engine(cuda_device)
    cpu = _deepseek_engine("cpu", params={
        g: ({k: v.cpu() for k, v in x.items()} if isinstance(x, dict)
            else x.cpu()) for g, x in card.runner.params.items()})
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 1000, n).tolist() for n in (7, 60, 23, 100)]
    sp = gt.SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    launches = {**trag.ragged_paged_attention.launches,
                **tdec.paged_decode_attention.launches}
    got = [o.output_token_ids for o in card.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    want = [o.output_token_ids for o in cpu.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    assert got == want
    ran = {k for k, n in {**trag.ragged_paged_attention.launches,
                          **tdec.paged_decode_attention.launches}.items()
           if n > launches[k]}
    assert ran == {"ragged_paged_attention_mla", "paged_decode_attention_mla"}
    mm = card.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total


@pytest.mark.cuda
def test_moe_block_issues_no_host_sync(cuda_device):
    """The routed experts' grouped product keeps its group offsets on the
    device: a bf16 MoE layer runs under sync-debug mode "error" (a host
    sync raises), and matches a loop over the experts."""
    from gllm_tpu_torch.models import deepseek
    card = _deepseek_engine(cuda_device)
    cfg = card.model_cfg
    lp = {k: v[0].bfloat16() for k, v in
          card.runner.params["moe_layers"].items()}
    x = torch.randn((37, cfg.hidden_size), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0)
                    ).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = deepseek._moe_block(lp, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    weights, ids = deepseek.deepseek_route(x.float() @ lp["router"].float(),
                                           None, cfg)
    want = torch.zeros_like(got, dtype=torch.float32)
    for t in range(x.shape[0]):
        for w, e in zip(weights[t].tolist(), ids[t].tolist()):
            h = x[t] @ lp["w_gate_up"][e]
            g, u = h.float().chunk(2)
            want[t] += w * ((torch.nn.functional.silu(g) * u).bfloat16()
                            @ lp["w_down"][e]).float()
    want += deepseek.dense._mlp({"gate_up_proj": lp["shared_gate_up_proj"],
                                 "down_proj": lp["shared_down_proj"]},
                                x).float()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)


# ---- head_dim 256 (Qwen3-Next's gated full attention: Hq 16 over Hkv 2) ---

D256_RAGGED_CASES = [
    dict(seqs=[(40, 40), (1, 70), (17, 90), (1, 3)], pad_seqs=2,
         pad_tokens=9, Hq=16, Hkv=2, D=256, page=16, pages=24),
    dict(seqs=[(1, 300 + 37 * i) for i in range(6)] + [(130, 200)],
         Hq=16, Hkv=2, D=256, page=16, pages=200),
]
D256_DECODE_CASES = [
    dict(kv_lens=[31, 64, 0, 65, 700], Hq=16, Hkv=2, D=256, page=16,
         pages=60),
    dict(kv_lens=[3000, 1, 257], Hq=16, Hkv=2, D=256, page=16, pages=210),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", D256_RAGGED_CASES + BLOCK_CASES_D256)
def test_ragged_kernel_d256_matches_plain(cuda_device, case, dtype):
    test_ragged_kernel_matches_plain(cuda_device, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", D256_DECODE_CASES)
def test_decode_kernel_d256_matches_plain(cuda_device, case, dtype):
    test_decode_kernel_matches_plain(cuda_device, case, dtype)


@pytest.mark.cuda
def test_d256_wrappers_count_and_refuse(cuda_device):
    """Head dim 256 launches the full-precision K1 and K2 and is counted as
    them; an int8 cache or the unified kernel at 256 raises."""
    rng = np.random.default_rng(30)
    q, kc, vc, cu, kvl, pt = (torch.from_numpy(a).to(cuda_device)
                              for a in ragged_case(rng, [(3, 9), (1, 5)],
                                                   16, 2, 256, 4, 8))
    r0 = dict(trag.ragged_paged_attention.launches)
    trag.ragged_paged_attention(q, kc, vc, cu, kvl, pt, scale=0.1)
    assert {k: n - r0[k] for k, n in
            trag.ragged_paged_attention.launches.items() if n != r0[k]} == {
        "ragged_paged_attention": 1}
    d0 = tdec.paged_decode_attention.launches["paged_decode_attention"]
    tdec.paged_decode_attention(q[:2].contiguous(), kc, vc, kvl, pt,
                                scale=0.1)
    assert (tdec.paged_decode_attention.launches["paged_decode_attention"]
            == d0 + 1)
    with pytest.raises(ValueError, match="head_dim 256"):
        trag.ragged_paged_attention(q, kc, vc, cu, kvl, pt, scale=0.1,
                                    unified=True)
    k8 = torch.zeros(kc.shape, dtype=torch.int8, device=cuda_device)
    sc = torch.ones(kc.shape[::2], device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 256"):
        trag.ragged_paged_attention(q, k8, k8, cu, kvl, pt, scale=0.1,
                                    k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="head_dim 256"):
        tdec.paged_decode_attention(q[:2].contiguous(), k8, k8, kvl, pt,
                                    scale=0.1, k_scale=sc, v_scale=sc)


# ---- K3: the gated-delta-rule chunk scan ---------------------------------

def scan_case(rng, B, N, C, Dk, Dv):
    """Operands shaped as chunk_gated_delta_rule builds them: l2-normed q
    (scaled) and k rows, a decaying cumulative g, lower-triangular local
    scores, and a non-zero initial state."""
    def rows(d, scale=1.0):
        x = rng.standard_normal((B, N, C, d))
        return (scale * x / np.linalg.norm(x, axis=-1, keepdims=True)
                ).astype(np.float32)
    qc, kc, kcd = rows(Dk, Dk ** -0.5), rows(Dk), rows(Dk, 0.5)
    v2 = rng.standard_normal((B, N, C, Dv)).astype(np.float32)
    attn = np.tril(0.3 * rng.standard_normal((B, N, C, C))).astype(
        np.float32)
    gcum = np.cumsum(-rng.uniform(0.0, 0.05, (B, N, C, 1)), axis=2).astype(
        np.float32)
    init = rng.standard_normal((B, Dk, Dv)).astype(np.float32)
    return qc, kc, v2, kcd, attn, gcum, init


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 5, 17])
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("dk,dv", [(dk, dv) for dk in GDN_DIMS
                                   for dv in GDN_DIMS])
def test_gdn_scan_kernel_matches_plain(cuda_device, dk, dv, C, N):
    """K3 at every (Dk, Dv) and chunk size it is built for, over one to 17
    chunks, on 7 (sequence, head) rows (one block each: far from a wave)
    from a nonzero state; one launch a call."""
    rng = np.random.default_rng(31)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in scan_case(rng, 7, N, C, dk, dv)]
    n0 = tscan.gdn_chunk_scan.launches["gdn_chunk_scan"]
    out, final = tscan.gdn_chunk_scan(*args)
    assert tscan.gdn_chunk_scan.launches["gdn_chunk_scan"] == n0 + 1
    want_o, want_s = tscan.gdn_chunk_scan_plain(*args)
    torch.cuda.synchronize()
    # float32 on both sides, sums in another order
    torch.testing.assert_close(out, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(final, want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_gdn_scan_wrapper_refuses(cuda_device):
    rng = np.random.default_rng(32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in scan_case(rng, 2, 2, 16, 48, 32)]
    with pytest.raises(ValueError, match="Dk=48"):
        tscan.gdn_chunk_scan(*args)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in scan_case(rng, 2, 2, 8, 32, 32)]
    with pytest.raises(ValueError, match="chunk 8"):
        tscan.gdn_chunk_scan(*args)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in scan_case(rng, 2, 2, 16, 32, 32)]
    with pytest.raises(ValueError, match="float32"):
        tscan.gdn_chunk_scan(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="gcum"):
        tscan.gdn_chunk_scan(*args[:5], args[5][..., 0], args[6])


# ---- the hybrid family ----------------------------------------------------

def _hybrid_engine(device, params=None, kv_cache_dtype="auto",
                   dtype="float32", **cfg):
    """One period of Qwen3-Next's layers (three GDN, one gated full
    attention) at small widths K3 and K1/K2 take: GDN Dk = Dv = 32, head
    dim 64, two routed experts and a shared one."""
    import gllm_tpu_torch as gt
    lin, full = "linear_attention", "full_attention"
    mc = gt.from_hf_config(dict(
        architectures=["Qwen3NextForCausalLM"], vocab_size=1000,
        hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
        num_key_value_heads=2, head_dim=64, partial_rotary_factor=0.25,
        intermediate_size=512, max_position_embeddings=512,
        layer_types=[lin, lin, lin, full], linear_num_key_heads=2,
        linear_num_value_heads=4, linear_key_head_dim=32,
        linear_value_head_dim=32, num_experts=2, num_experts_per_tok=1,
        moe_intermediate_size=128, shared_expert_intermediate_size=128,
        norm_topk_prob=True))
    ec = gt.EngineConfig(
        dtype=dtype, load_format="dummy", max_model_len=512,
        max_num_seqs=8, scheduler=gt.SchedulerConfig(max_prefill_tokens=48),
        cache=gt.CacheConfig(page_size=16, num_pages=64,
                             kv_cache_dtype=kv_cache_dtype), **cfg)
    return gt.LLM(model_cfg=mc, config=ec, params=params, device=device)


def _to_cpu(params):
    return {g: ({k: v.cpu() for k, v in x.items()} if isinstance(x, dict)
                else x.cpu()) for g, x in params.items()}


@pytest.mark.cuda
def test_hybrid_engine_on_card_matches_cpu_greedy(cuda_device):
    """The same float32 hybrid weights through the card (K3, K1, K2, the
    grouped expert product) and the CPU: the same greedy tokens, K3 on
    every GDN layer of every mixed step, and every slot freed."""
    import gllm_tpu_torch as gt
    card = _hybrid_engine(cuda_device)
    cpu = _hybrid_engine("cpu", params=_to_cpu(card.runner.params))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 1000, n).tolist() for n in (7, 60, 23, 100)]
    sp = gt.SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    launches = {**trag.ragged_paged_attention.launches,
                **tdec.paged_decode_attention.launches,
                **tscan.gdn_chunk_scan.launches}
    got = [o.output_token_ids for o in card.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    want = [o.output_token_ids for o in cpu.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    assert got == want
    ran = {k: n - launches[k] for k, n in
           {**trag.ragged_paged_attention.launches,
            **tdec.paged_decode_attention.launches,
            **tscan.gdn_chunk_scan.launches}.items() if n > launches[k]}
    steps = card.step_counts
    assert ran == {"ragged_paged_attention": steps["mixed"],
                   "paged_decode_attention": steps["decode"],
                   "gdn_chunk_scan": 3 * steps["mixed"]}
    mm = card.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total
    assert mm.ssm_alloc.num_free == mm.ssm_alloc.num_total


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "mixed"])
def test_hybrid_layers_make_no_host_sync(cuda_device, kind):
    """A bf16 GDN layer (decode: the recurrent step; mixed: the padded
    layout, the chunked rule and K3) and the sparse block run under
    sync-debug mode "error": a host sync raises."""
    from gllm_tpu_torch.batching import StepBatch
    from gllm_tpu_torch.models import hybrid, moe
    from gllm_tpu_torch.ops.attention import AttentionMetadata
    card = _hybrid_engine(cuda_device)
    cfg = card.model_cfg
    params = card.runner.params
    glp = {k: v[0] if k in ("dt_bias", "a_log") else v[0].bfloat16()
           for k, v in params["gdn_layers"].items()}
    mlp = {k: v[0].bfloat16() for k, v in params["mlp_layers"].items()}
    lens = [1, 1, 1] if kind == "decode" else [1, 37, 5]
    T = sum(lens)
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32,
                      device=cuda_device)
    batch = StepBatch(
        token_ids=None, positions=None, slot_mapping=None,
        logits_indices=None,
        attn=AttentionMetadata(cu_q_lens=cu, kv_lens=cu[1:].clone(),
                               page_table=None),
        sampling=None,
        ssm_slots=torch.tensor([1, 2, 3], dtype=torch.int32,
                               device=cuda_device),
        num_seqs=3, max_seq_q=max(lens))
    conv = card.runner.kv.conv[0]
    rec = card.runner.kv.rec[0]
    x = torch.randn((T, cfg.hidden_size), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0)
                    ).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = hybrid._gdn_layer(glp, x, batch, conv, rec, cfg,
                                max_q_len=max(lens))
        out = moe.moe_mlp(mlp, out, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (T, cfg.hidden_size)
    assert torch.isfinite(out.float()).all()


# ---- the fp8 (e4m3) cache in every attention kernel, and K1um -------------

FP8 = torch.float8_e4m3fn


def _fp8_on_card(device, dtype, q, kc, vc, *index):
    """q in ``dtype`` and fp8 caches of kc, vc on the card: the kernels'
    caches hold NaN bytes in the dummy page 0, which no kernel may read;
    the plain version's hold zeros there. Returns (q, index, kernel
    caches, plain caches)."""
    q = torch.from_numpy(q).to(device, dtype)
    index = [torch.from_numpy(a).to(device) for a in index]
    kern, clean = [], []
    for c in (kc, vc):
        c = torch.from_numpy(c).to(device).to(FP8)
        dirty = c.clone()
        dirty.view(torch.uint8)[0] = 0x7F
        c.view(torch.uint8)[0] = 0
        kern.append(dirty)
        clean.append(c)
    return q, index, kern, clean


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [RAGGED_CASES[2], RAGGED_CASES[3],
                                  MAIN_PATH_RAGGED, D256_RAGGED_CASES[0]]
                         + BLOCK_CASES + BLOCK_CASES_D256)
def test_ragged_fp8_kernel_matches_plain(cuda_device, case, dtype):
    if case.get("block"):
        return _block_check(cuda_device, case, dtype, "fp8")
    rng = np.random.default_rng(33)
    q, kc, vc, cu, kvl, pt = ragged_case(
        rng, case["seqs"], case["Hq"], case["Hkv"], case["D"],
        case["page"], case["pages"], case.get("pad_seqs", 0),
        case.get("pad_tokens", 0))
    q, idx, kern, clean = _fp8_on_card(cuda_device, dtype, q, kc, vc, cu,
                                       kvl, pt)
    n0 = trag.ragged_paged_attention.launches["ragged_paged_attention_fp8"]
    out = trag.ragged_paged_attention(q, *kern, *idx,
                                      scale=case["D"] ** -0.5)
    want = trag.ragged_paged_attention_plain(q, *clean, *idx,
                                             scale=case["D"] ** -0.5)
    _check(out, want, dtype)
    assert trag.ragged_paged_attention.launches[
        "ragged_paged_attention_fp8"] == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    DECODE_CASES[1], DECODE_CASES[2], D256_DECODE_CASES[1],
    dict(kv_lens=[int(x) for x in
                  np.random.default_rng(0).integers(256, 2048, 32)],
         Hq=32, Hkv=8, D=64, page=16, pages=4200)])
def test_decode_fp8_kernel_matches_plain(cuda_device, case, dtype):
    rng = np.random.default_rng(34)
    q, kc, vc, kvl, pt = decode_case(rng, case["kv_lens"], case["Hq"],
                                     case["Hkv"], case["D"], case["page"],
                                     case["pages"])
    q, idx, kern, clean = _fp8_on_card(cuda_device, dtype, q, kc, vc, kvl,
                                       pt)
    n0 = tdec.paged_decode_attention.launches["paged_decode_attention_fp8"]
    out = tdec.paged_decode_attention(q, *kern, *idx,
                                      scale=case["D"] ** -0.5)
    want = tdec.paged_decode_attention_plain(q, *clean, *idx,
                                             scale=case["D"] ** -0.5)
    _check(out, want, dtype)
    assert tdec.paged_decode_attention.launches[
        "paged_decode_attention_fp8"] == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", UNIFIED_CARD_CASES + BLOCK_CASES)
def test_unified_fp8_kernel_matches_plain(cuda_device, case, dtype):
    if case.get("block"):
        return _block_check(cuda_device, case, dtype, "fp8", unified=True)
    rng = np.random.default_rng(35)
    q, kc, vc, _, _, cu, kvl, pt = unified_case(
        rng, case, False, case["Hq"], case["Hkv"], case["D"], case["page"],
        case["pages"])
    q, idx, kern, clean = _fp8_on_card(cuda_device, dtype, q, kc, vc, cu,
                                       kvl, pt)
    scale = case["D"] ** -0.5
    out = trag.ragged_paged_attention(q, *kern, *idx, scale=scale,
                                      unified=True)
    want = trag.ragged_paged_attention_plain(q, *clean, *idx, scale=scale,
                                             unified=True)
    _check(out, want, dtype)


def _one_token_rows(seqs, pad_seqs, device):
    """1 for each one-token row of a batch (0 for padding rows): subtracted
    from kv_lens, it drops the last key of every such row."""
    return torch.tensor([int(ql == 1) for ql, _ in seqs] + [0] * pad_seqs,
                        dtype=torch.int32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("latent", ["fp", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MLA_RAGGED_CARD_CASES)
def test_mla_ragged_kernels_over_fp8_and_unified(cuda_device, case, dtype,
                                                 latent):
    """K1m over an fp8 latent, and K1um (the unified step's MLA kernel)
    over either latent, on the ragged MLA cases (decode rows in front,
    one-token rows after chunks, padding)."""
    rng = np.random.default_rng(36)
    q, lat, _, cu, kvl, pt = ragged_case(
        rng, case["seqs"], 16, 1, case["Dl"], case["page"], case["pages"],
        case.get("pad_seqs", 0), case.get("pad_tokens", 0))
    if latent == "fp8":
        q, idx, (lat_k, _), (lat_c, _) = _fp8_on_card(
            cuda_device, dtype, q, lat, lat, cu, kvl, pt)
    else:
        q, idx, kern, clean = _on_card(cuda_device, dtype, q, lat, lat, None,
                                       None, cu, kvl, pt)
        lat_k, lat_c = kern["k_cache"], clean["k_cache"]
    kw = dict(cu_q_lens=idx[0], page_table=idx[2],
              scale=2.0 * case["Dl"] ** -0.5, v_dim=case["Dv"])
    drop = idx[1] - _one_token_rows(case["seqs"], case.get("pad_seqs", 0),
                                    cuda_device)
    for unified in ((False, True) if latent == "fp8" else (True,)):
        name = trag.kernel_name(unified, True, lat_k)
        n0 = trag.ragged_paged_attention.launches[name]
        out = trag.ragged_paged_attention(q, lat_k, None, kv_lens=idx[1],
                                          unified=unified, **kw)
        want = trag.ragged_paged_attention_plain(
            q, lat_c, None, kv_lens=idx[1], unified=unified, **kw)
        dropped = trag.ragged_paged_attention_plain(
            q, lat_c, None, kv_lens=drop, unified=unified, **kw)
        assert out.shape == (q.shape[0], 16, case["Dv"])
        _mla_check(out, want, dropped, dtype)
        assert trag.ragged_paged_attention.launches[name] == n0 + 1


# the unified MLA cases: UNIFIED_CASES at the small latent geometry, and
# the main path's pure-decode batch at DeepSeek-V2-Lite's
MLA_UNIFIED_CARD_CASES = [
    dict(UNIFIED_CASES[n], Dl=96, Dv=64, page=4, pages=64)
    for n in UNIFIED_CASES] + [
    dict(seqs=[(1, int(x)) for x in
               np.random.default_rng(0).integers(256, 2048, 32)],
         Dl=576, Dv=512, page=16, pages=4200)]


@pytest.mark.cuda
@pytest.mark.parametrize("latent", ["fp", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MLA_UNIFIED_CARD_CASES)
def test_mla_unified_kernel_matches_plain(cuda_device, case, dtype, latent):
    rng = np.random.default_rng(37)
    q, lat, _, cu, kvl, pt = ragged_case(
        rng, case["seqs"], 16, 1, case["Dl"], case["page"], case["pages"],
        case.get("pad_seqs", 0), case.get("pad_tokens", 0))
    if latent == "fp8":
        q, idx, (lat_k, _), (lat_c, _) = _fp8_on_card(
            cuda_device, dtype, q, lat, lat, cu, kvl, pt)
    else:
        q, idx, kern, clean = _on_card(cuda_device, dtype, q, lat, lat, None,
                                       None, cu, kvl, pt)
        lat_k, lat_c = kern["k_cache"], clean["k_cache"]
    kw = dict(cu_q_lens=idx[0], page_table=idx[2], unified=True,
              scale=2.0 * case["Dl"] ** -0.5, v_dim=case["Dv"])
    drop = idx[1] - _one_token_rows(case["seqs"], case.get("pad_seqs", 0),
                                    cuda_device)
    out = trag.ragged_paged_attention(q, lat_k, None, kv_lens=idx[1], **kw)
    want = trag.ragged_paged_attention_plain(q, lat_c, None, kv_lens=idx[1],
                                             **kw)
    dropped = trag.ragged_paged_attention_plain(q, lat_c, None,
                                                kv_lens=drop, **kw)
    _mla_check(out, want, dropped, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MLA_DECODE_CARD_CASES)
def test_mla_decode_fp8_kernel_matches_plain(cuda_device, case, dtype):
    rng = np.random.default_rng(38)
    q, lat, _, kvl, pt = decode_case(rng, case["kv_lens"], 16, 1, case["Dl"],
                                     case["page"], case["pages"])
    q, idx, (lat_k, _), (lat_c, _) = _fp8_on_card(cuda_device, dtype, q, lat,
                                                  lat, kvl, pt)
    kw = dict(page_table=idx[1], scale=2.0 * case["Dl"] ** -0.5,
              v_dim=case["Dv"])
    n0 = tdec.paged_decode_attention.launches["paged_decode_attention_mla_fp8"]
    out = tdec.paged_decode_attention(q, lat_k, None, kv_lens=idx[0], **kw)
    want = tdec.paged_decode_attention_plain(q, lat_c, None, kv_lens=idx[0],
                                             **kw)
    dropped = tdec.paged_decode_attention_plain(
        q, lat_c, None, kv_lens=idx[0] - (idx[0] > 0).int(), **kw)
    _mla_check(out, want, dropped, dtype)
    assert tdec.paged_decode_attention.launches[
        "paged_decode_attention_mla_fp8"] == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_fp8_write_on_card_gives_the_cpu_bytes(cuda_device, dtype):
    """The write path's cast on the card against the CPU's (which the CPU
    tests hold to the JAX package's bytes), over e4m3's edge: NaN past
    464, 448 at and below it, subnormals; NaN compared as NaN."""
    from gllm_tpu_torch.ops.kv_cache import write_kv, write_latent
    rng = np.random.default_rng(39)
    edge = [463.9, 464.0, 464.1, 470.0, 479.9, 480.0, 1e30, np.inf,
            -480.0, -np.inf, 448.0, -448.0, 0.0, -0.0, 2.0 ** -9,
            2.0 ** -10, 1e-9]
    rows = (rng.standard_normal((9, 2, 16))
            * np.exp2(rng.integers(-12, 7, (9, 2, 16)))).astype(np.float32)
    rows.reshape(9, -1)[0, :len(edge)] = edge
    slots = torch.tensor([5, 6, 7, 8, 13, 22, 23, 0, 1], dtype=torch.int32)
    out = []
    for device in ("cpu", cuda_device):
        x = torch.from_numpy(rows).to(device, dtype)
        k = torch.zeros((6, 4, 2, 16), dtype=FP8, device=device)
        v = torch.zeros_like(k)
        lat = torch.zeros((6, 4, 32), dtype=FP8, device=device)
        write_kv(k, v, x, -x, slots.to(device))
        write_latent(lat, x.reshape(9, 32), slots.to(device))
        out.append([t.view(torch.uint8).cpu().numpy() for t in (k, v, lat)])
    for cpu, card in zip(*out):
        nan_cpu, nan_card = (cpu & 0x7F) == 0x7F, (card & 0x7F) == 0x7F
        np.testing.assert_array_equal(nan_card, nan_cpu)
        np.testing.assert_array_equal(card[~nan_card], cpu[~nan_cpu])
        assert nan_cpu.any()


@pytest.mark.cuda
@pytest.mark.parametrize("family,cfg,kernels", [
    ("deepseek", dict(unified_step=True),
     {"ragged_paged_attention_unified_mla"}),
    ("deepseek", dict(kv_cache_dtype="fp8"),
     {"ragged_paged_attention_mla_fp8", "paged_decode_attention_mla_fp8"}),
    ("deepseek", dict(unified_step=True, kv_cache_dtype="fp8"),
     {"ragged_paged_attention_unified_mla_fp8"}),
    ("hybrid", dict(kv_cache_dtype="fp8"),
     {"ragged_paged_attention_fp8", "paged_decode_attention_fp8",
      "gdn_chunk_scan"})])
def test_fp8_and_unified_mla_engines_on_card_match_cpu_greedy(
        cuda_device, family, cfg, kernels):
    """The same float32 DeepSeek or hybrid weights through the card and the
    CPU under the unified step, over an fp8 cache, or both: the same
    greedy tokens, and only the configuration's kernels launched."""
    import gllm_tpu_torch as gt
    make = _deepseek_engine if family == "deepseek" else _hybrid_engine
    card = make(cuda_device, **cfg)
    cpu = make("cpu", params=_to_cpu(card.runner.params), **cfg)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 1000, n).tolist() for n in (7, 60, 23, 100)]
    sp = gt.SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    counters = (trag.ragged_paged_attention.launches,
                tdec.paged_decode_attention.launches,
                tscan.gdn_chunk_scan.launches)
    before = {k: n for c in counters for k, n in c.items()}
    got = [o.output_token_ids for o in card.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    want = [o.output_token_ids for o in cpu.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    assert got == want
    assert {k for c in counters for k, n in c.items()
            if n > before[k]} == kernels
    mm = card.memory_manager
    assert mm.num_free_pages == mm.allocator.num_total


@pytest.mark.cuda
def test_deepseek_unified_layer_makes_no_host_sync(cuda_device):
    """A bf16 MLA layer under the unified step (the latent write and K1um
    on a mixed batch: decode rows, then a chunk) runs under sync-debug
    mode "error": a host sync raises."""
    from gllm_tpu_torch.batching import StepBatch
    from gllm_tpu_torch.models import deepseek
    from gllm_tpu_torch.ops.attention import AttentionMetadata
    from gllm_tpu_torch.ops.rope import yarn_softmax_scale_mult
    card = _deepseek_engine(cuda_device, unified_step=True)
    cfg = card.model_cfg
    lp = {k: v[0].bfloat16() for k, v in
          card.runner.params["dense_layers"].items()}
    latent = card.runner.kv.latent.bfloat16()
    L, P, page, width = latent.shape
    flat = latent.view(L * P, page, width)
    lens, before = [1, 1, 37], [20, 5, 0]
    T = sum(lens)
    kvl = [b + n for b, n in zip(before, lens)]
    pages = [list(range(1 + 4 * i, 1 + 4 * i + -(-k // page)))
             for i, k in enumerate(kvl)]
    pt = torch.zeros((3, max(map(len, pages))), dtype=torch.int32)
    for i, p in enumerate(pages):
        pt[i, :len(p)] = torch.tensor(p)
    pos = torch.cat([torch.arange(b, b + n) for b, n in zip(before, lens)])
    slots = torch.tensor([pages[i][int(x) // page] * page + int(x) % page
                          for i, (b, n) in enumerate(zip(before, lens))
                          for x in range(b, b + n)])
    dev = dict(device=cuda_device, dtype=torch.int32)
    batch = StepBatch(
        token_ids=None, positions=pos.to(**dev),
        slot_mapping=slots.to(**dev), logits_indices=None,
        attn=AttentionMetadata(
            cu_q_lens=torch.tensor(np.cumsum([0] + lens), **dev),
            kv_lens=torch.tensor(kvl, **dev), page_table=pt.to(cuda_device)),
        sampling=None)
    x = torch.randn((T, cfg.hidden_size), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0)
                    ).bfloat16()
    scale = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
             * yarn_softmax_scale_mult(cfg.rope_scaling))
    kw = dict(scale=scale, max_q_len=max(lens), li=0)
    deepseek._mla_attention(lp, x, batch, flat, cfg, card.runner.cos_sin,
                            impl="unified", **kw)     # builds, warms up
    n0 = trag.ragged_paged_attention.launches[
        "ragged_paged_attention_unified_mla"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = deepseek._mla_attention(lp, x, batch, flat, cfg,
                                      card.runner.cos_sin, impl="unified",
                                      **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert trag.ragged_paged_attention.launches[
        "ragged_paged_attention_unified_mla"] == n0 + 1
    assert out.shape == (T, cfg.hidden_size)
    assert torch.isfinite(out.float()).all()


# ---- the split-KV decode blocks (GQA: K2, K1u's decode class; MLA: K2m,
# K1um's decode class) over every cache, group and head dim they take,
# with kv_lens on both sides of the split boundaries, at a page offset

# name → (q dtype, cache): a cache in q's dtype, int8 (with scales) or fp8
DECODE_KINDS = {"bf16": (torch.bfloat16, "native"),
                "fp16": (torch.float16, "native"),
                "int8": (torch.bfloat16, "int8"),
                "fp8": (torch.bfloat16, "fp8"),
                "fp8_fp16q": (torch.float16, "fp8"),
                "f32": (torch.float32, "native")}


def _offset_caches(device, qdtype, cache, rng, *arrays):
    """The case's caches (K and V, or one MLA latent) as layer 1 of a
    two-layer stack read at page_offset P: layer 0 and the case's dummy
    page hold NaN (NaN bytes, or NaN scales for int8), which no kernel may
    read. Returns (the kernel's keywords, the plain version's keywords over
    layer 1 with the NaNs zeroed)."""
    P = arrays[0].shape[0]
    names = ("k_cache", "v_cache")[:len(arrays)]
    kern, clean = dict(page_offset=P), {}
    if cache == "int8":
        k8, v8, ks, vs = int8_cache(rng, *arrays)
        for name, c, s in (("k", k8, ks), ("v", v8, vs)):
            t = torch.from_numpy(np.concatenate([c, c])).to(device)
            sc = torch.from_numpy(np.concatenate([s, s])).to(device)
            sc[:P + 1] = float("nan")
            kern[name + "_cache"], kern[name + "_scale"] = t, sc
            clean[name + "_cache"] = t[P:]
            clean[name + "_scale"] = torch.nan_to_num(sc[P:])
        return kern, clean
    dtype = FP8 if cache == "fp8" else qdtype
    for name, a in zip(names, arrays):
        t = torch.from_numpy(np.concatenate([a, a])).to(device).to(dtype)
        c = t[P:].clone()
        if cache == "fp8":
            t.view(torch.uint8)[:P + 1] = 0x7F
            c.view(torch.uint8)[0] = 0
        else:
            t[:P + 1] = float("nan")
            c[0] = 0
        kern[name], clean[name] = t, c
    return kern, clean


def _plan(device, qdtype, cache, S, Hq, Hkv, D, page, max_pages, v_dim=None):
    """(keys per split, splits) the wrapper picks for these shapes."""
    dtype = {"native": qdtype, "int8": torch.int8, "fp8": FP8}[cache]
    chunk, n, _ = tdec.split_plan(
        torch.empty((S, Hq, D), dtype=qdtype, device=device),
        torch.empty((1, page, Hkv, D), dtype=dtype, device=device),
        torch.empty((S, max_pages), dtype=torch.int32, device=device),
        v_dim)
    return chunk, n


def _split_lens(chunk, max_keys):
    """kv_lens around every boundary the tests care about: empty, one key,
    one tile of 256 (+-1), one split (+-1), three splits, and nearly the
    padded table."""
    return [0, 1, 255, 256, 257, chunk - 1, chunk, chunk + 1, 3 * chunk,
            max_keys - 3]


def _counters_zero(device):
    torch.cuda.synchronize()
    counters = tdec.decode_scratch(device, 0)[:tdec.COUNTER_SLOTS]
    assert not counters.view(torch.int32).any(), "split counters left set"


DECODE_BLOCK_CASES = [
    (kind, G, D, splits) for kind in DECODE_KINDS
    for G in (1, 4, 5, 7, 8, 16) for D in (32, 64, 128, 256)
    for splits in ("one", "many")
    if not (D == 256 and DECODE_KINDS[kind][1] == "int8")]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,G,D,splits", DECODE_BLOCK_CASES)
def test_decode_block_matches_plain(cuda_device, kind, G, D, splits):
    qdtype, cache = DECODE_KINDS[kind]
    Hkv, page = 2, 16
    Hq = G * Hkv
    if splits == "one":      # one tile (32 keys at f32): one split
        tile = 32 if qdtype == torch.float32 else 64
        lens = [0, 1, 17, tile - 1, tile]
        chunk, n = _plan(cuda_device, qdtype, cache, len(lens), Hq, Hkv, D,
                         page, tile // page)
        assert n == 1
    else:                    # a 4096-key table over 10 rows
        chunk, n = _plan(cuda_device, qdtype, cache, 10, Hq, Hkv, D, page,
                         256)
        lens = _split_lens(chunk, 4096)
        assert n > 1
    rng = np.random.default_rng(30)
    num_pages = 1 + sum(-(-k // page) for k in lens)
    q, kc, vc, kvl, pt = decode_case(rng, lens, Hq, Hkv, D, page, num_pages)
    kern, clean = _offset_caches(cuda_device, qdtype, cache, rng, kc, vc)
    q = torch.from_numpy(q).to(cuda_device, qdtype)
    kvl, pt = (torch.from_numpy(a).to(cuda_device) for a in (kvl, pt))
    scale = D ** -0.5
    before = dict(tdec.paged_decode_attention.launches)
    out = tdec.paged_decode_attention(q, kv_lens=kvl, page_table=pt,
                                      scale=scale, **kern)
    want = tdec.paged_decode_attention_plain(q, kv_lens=kvl, page_table=pt,
                                             scale=scale, **clean)
    _check(out, want, qdtype)
    assert (out[0] == 0).all()                        # kv_len 0
    _counters_zero(cuda_device)
    suffix = {"native": "", "int8": "_int8", "fp8": "_fp8"}[cache]
    assert {k: v - before[k] for k, v in
            tdec.paged_decode_attention.launches.items()
            if v != before[k]} == {"paged_decode_attention" + suffix: 1}


UNIFIED_BLOCK_CASES = [(kind, G, D) for kind in DECODE_KINDS
                       for G in (1, 4, 8, 16) for D in (32, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,G,D", UNIFIED_BLOCK_CASES)
def test_unified_decode_class_matches_plain(cuda_device, kind, G, D):
    """K1u: a decode prefix of one-token rows on both sides of the split
    boundaries, then a chunk, a one-token row after it (ragged class) and
    padding."""
    qdtype, cache = DECODE_KINDS[kind]
    Hkv, page = 2, 16
    Hq = G * Hkv
    tail = [(9, 40), (17, 300), (1, 50)]
    S = 10 + len(tail) + 2
    chunk, n = _plan(cuda_device, qdtype, cache, S, Hq, Hkv, D, page, 256)
    assert n > 1
    seqs = [(1, k) for k in _split_lens(chunk, 4096)[1:]] + [(1, 2)] + tail
    rng = np.random.default_rng(31)
    num_pages = 1 + sum(-(-k // page) for _, k in seqs)
    q, kc, vc, cu, kvl, pt = ragged_case(rng, seqs, Hq, Hkv, D, page,
                                         num_pages, pad_seqs=2, pad_tokens=5)
    assert pt.shape == (S, 256)
    kern, clean = _offset_caches(cuda_device, qdtype, cache, rng, kc, vc)
    q = torch.from_numpy(q).to(cuda_device, qdtype)
    md = {k: torch.from_numpy(a).to(cuda_device) for k, a in
          (("cu_q_lens", cu), ("kv_lens", kvl), ("page_table", pt))}
    scale = D ** -0.5
    out = trag.ragged_paged_attention(q, **md, scale=scale, unified=True,
                                      **kern)
    want = trag.ragged_paged_attention_plain(q, **md, scale=scale,
                                             unified=True, **clean)
    _check(out, want, qdtype)
    _counters_zero(cuda_device)


MLA_KINDS = {k: DECODE_KINDS[k]
             for k in ("bf16", "fp16", "fp8", "fp8_fp16q", "f32")}
MLA_BLOCK_CASES = [(geo, kind, splits, unified)
                   for geo in ((96, 64), (576, 512)) for kind in MLA_KINDS
                   for splits in ("one", "many") for unified in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("geo,kind,splits,unified", MLA_BLOCK_CASES)
def test_mla_decode_block_matches_plain(cuda_device, geo, kind, splits,
                                        unified):
    """K2m (legacy) and K1um's decode class (unified: the one-token rows
    lead a batch with a chunk behind them) at both latent geometries."""
    Dl, Dv = geo
    qdtype, cache = MLA_KINDS[kind]
    page = 16
    # behind a unified batch's decode prefix: a chunk and a one-token row
    tail = ([(9, 20), (1, 30)] if splits == "one" else [(9, 40), (1, 50)]
            ) if unified else []
    if splits == "one":      # a 32-key table: one tile, one split
        lens, max_pages = [0, 1, 17, 31, 32], 2
    else:
        max_pages = 256
    S = (5 if splits == "one" else 10) + len(tail)
    chunk, n = _plan(cuda_device, qdtype, cache, S, 16, 1, Dl, page,
                     max_pages, Dv)
    assert (n == 1) == (splits == "one")
    if splits == "many":
        lens = _split_lens(chunk, 4096)
    rng = np.random.default_rng(32)
    kw = dict(scale=2.0 * Dl ** -0.5, v_dim=Dv)
    if unified:
        seqs = [(1, k) for k in lens if k] + [(1, 2)] + tail
        num_pages = 1 + sum(-(-k // page) for _, k in seqs)
        q, lat, _, cu, kvl, pt = ragged_case(rng, seqs, 16, 1, Dl, page,
                                             num_pages)
        md = dict(cu_q_lens=cu, kv_lens=kvl, page_table=pt)
        kw["unified"] = True
        kernel, plain = (trag.ragged_paged_attention,
                         trag.ragged_paged_attention_plain)
    else:
        num_pages = 1 + sum(-(-k // page) for k in lens)
        q, lat, _, kvl, pt = decode_case(rng, lens, 16, 1, Dl, page,
                                         num_pages)
        md = dict(kv_lens=kvl, page_table=pt)
        kernel, plain = (tdec.paged_decode_attention,
                         tdec.paged_decode_attention_plain)
    assert pt.shape[1] == max_pages
    kern, clean = _offset_caches(cuda_device, qdtype, cache, rng, lat)
    q = torch.from_numpy(q).to(cuda_device, qdtype)
    md = {k: torch.from_numpy(a).to(cuda_device) for k, a in md.items()}
    out = kernel(q, kern.pop("k_cache"), None, **md, **kern, **kw)
    want = plain(q, clean["k_cache"], None, **md, **kw)
    assert out.shape == (q.shape[0], 16, Dv)
    _check(out, want, qdtype)
    _counters_zero(cuda_device)


# ---- the MLA ragged block (wgmma; K1m, K1um's ragged class) at a page
# offset

# a one-token row first (the decode prefix under the unified step), chunks
# of 3, 5, 9 and 130 tokens (none a multiple of the block's 4 tokens; two
# start mid-context), and a one-token row after them (a ragged-class row
# under the unified step)
MLA_RAGGED_BLOCK_SEQS = [(1, 40), (3, 3), (5, 77), (9, 9), (130, 300),
                         (1, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("unified", [False, True])
@pytest.mark.parametrize("latent", ["native", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("geo", [(96, 64), (576, 512)])
def test_mla_ragged_block_matches_plain(cuda_device, geo, dtype, latent,
                                        unified):
    """The MLA ragged block (K1m, K1um) at both latent geometries over a
    16-bit and an fp8 latent read at a page offset (NaN in the skipped
    layer and the dummy page), with padded sequences and tokens; the
    tolerance rejects the plain version with a dropped key."""
    Dl, Dv = geo
    page, pad_seqs = 16, 2
    seqs = MLA_RAGGED_BLOCK_SEQS
    rng = np.random.default_rng(43)
    q, lat, _, cu, kvl, pt = ragged_case(
        rng, seqs, 16, 1, Dl, page, 1 + sum(-(-k // page) for _, k in seqs),
        pad_seqs=pad_seqs, pad_tokens=13)
    kern, clean = _offset_caches(cuda_device, dtype, latent, rng, lat)
    q = torch.from_numpy(q).to(cuda_device, dtype)
    md = {k: torch.from_numpy(a).to(cuda_device) for k, a in
          dict(cu_q_lens=cu, kv_lens=kvl, page_table=pt).items()}
    kw = dict(scale=2.0 * Dl ** -0.5, v_dim=Dv, unified=unified)
    name = trag.kernel_name(unified, True, kern["k_cache"])
    n0 = trag.ragged_paged_attention.launches[name]
    out = trag.ragged_paged_attention(q, kern.pop("k_cache"), None, **md,
                                      **kern, **kw)
    assert trag.ragged_paged_attention.launches[name] == n0 + 1
    want = trag.ragged_paged_attention_plain(q, clean["k_cache"], None, **md,
                                             **kw)
    md["kv_lens"] = md["kv_lens"] - _one_token_rows(seqs, pad_seqs,
                                                    cuda_device)
    dropped = trag.ragged_paged_attention_plain(q, clean["k_cache"], None,
                                                **md, **kw)
    assert out.shape == (q.shape[0], 16, Dv)
    _mla_check(out, want, dropped, dtype)


# ---- K1u / K1um told the batch is pure decode (decode_only) --------------

DECODE_ONLY_CASES = ([("gqa", kind) for kind in DECODE_KINDS]
                     + [("mla", kind) for kind in MLA_KINDS])


@pytest.mark.cuda
@pytest.mark.parametrize("family,kind", DECODE_ONLY_CASES)
def test_unified_decode_only_matches_plain(cuda_device, family, kind):
    """A pure-decode batch (one-token rows on both sides of the split
    boundaries, then three padding sequences: T == S) through K1u (GQA, G
    4, D 64) or K1um (latent 96 + 64) with ``decode_only``: the decode
    blocks alone, the padding rows zero, and the same output as without
    the hint (which also launches the ragged class) and as the plain
    version."""
    qdtype, cache = (DECODE_KINDS if family == "gqa" else MLA_KINDS)[kind]
    page = 16
    if family == "gqa":
        Hq, Hkv, D, Dv = 8, 2, 64, None
    else:
        Hq, Hkv, D, Dv = 16, 1, 96, 64
    S = 12                      # nine one-token rows, three padding
    chunk, n = _plan(cuda_device, qdtype, cache, S, Hq, Hkv, D, page, 256,
                     Dv)
    assert n > 1
    seqs = [(1, k) for k in _split_lens(chunk, 4096)[1:]]
    assert len(seqs) + 3 == S
    rng = np.random.default_rng(33)
    num_pages = 1 + sum(-(-k // page) for _, k in seqs)
    q, kc, vc, cu, kvl, pt = ragged_case(rng, seqs, Hq, Hkv, D, page,
                                         num_pages, pad_seqs=3, pad_tokens=3)
    assert q.shape[0] == S
    caches = (kc, vc) if family == "gqa" else (kc,)
    kern, clean = _offset_caches(cuda_device, qdtype, cache, rng, *caches)
    if family == "mla":
        kern["v_cache"], clean["v_cache"] = None, None
    q = torch.from_numpy(q).to(cuda_device, qdtype)
    md = {k: torch.from_numpy(a).to(cuda_device) for k, a in
          (("cu_q_lens", cu), ("kv_lens", kvl), ("page_table", pt))}
    kw = dict(scale=D ** -0.5, unified=True, v_dim=Dv)
    name = trag.kernel_name(True, family == "mla", kern["k_cache"])
    n0 = trag.ragged_paged_attention.launches[name]
    out = trag.ragged_paged_attention(q, **md, **kern, **kw,
                                      decode_only=True)
    hinted = out.clone()
    both = trag.ragged_paged_attention(q, **md, **kern, **kw)
    assert trag.ragged_paged_attention.launches[name] == n0 + 2
    want = trag.ragged_paged_attention_plain(q, **md, **clean, **kw)
    torch.cuda.synchronize()
    assert torch.equal(hinted, both)
    assert not hinted[len(seqs):].float().any()
    _check(hinted, want, qdtype)
    _counters_zero(cuda_device)
    with pytest.raises(ValueError, match="decode_only"):
        trag.ragged_paged_attention(q[:-1], **md, **kern, **kw,
                                    decode_only=True)


# ---- the compiled decode step (runner/graphs.py) --------------------------

GRAPH_CASES = [
    ("dense", {}), ("dense", dict(kv_cache_dtype="int8")),
    ("dense", dict(kv_cache_dtype="fp8")), ("dense", dict(unified_step=True)),
    ("dense", dict(unified_step=True, kv_cache_dtype="int8")),
    ("deepseek", {}), ("deepseek", dict(unified_step=True)),
    ("deepseek", dict(kv_cache_dtype="fp8")),
    ("deepseek", dict(unified_step=True, kv_cache_dtype="fp8")),
    ("hybrid", {})]
GRAPH_MAKERS = {"dense": _tiny_engine, "deepseek": _deepseek_engine,
                "hybrid": _hybrid_engine}


def _all_counts():
    from gllm_tpu_torch.runner import graphs
    return {(fn.__name__, k): n
            for (fn, k), n in graphs.launch_counts().items()}


def _serve(llm, temperature):
    """Nine requests of short prompts and longer outputs (so the decode
    steps' sequence bucket is 16, then 8): their token streams, and the
    launch counts they took."""
    import gllm_tpu_torch as gt
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 1000, int(n)).tolist()
               for n in rng.integers(3, 20, 9)]
    sp = [gt.SamplingParams(temperature=temperature, top_p=0.9, top_k=50,
                            max_tokens=int(m), ignore_eos=True)
          for m in rng.integers(8, 24, 9)]
    before = _all_counts()
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=sp)
    counts = {k: n - before[k] for k, n in _all_counts().items()
              if n != before[k]}
    return [o.output_token_ids for o in outs], counts


@pytest.mark.cuda
@pytest.mark.parametrize("family,cfg", GRAPH_CASES,
                         ids=[f + "".join(f"-{v}" for v in c.values())
                              for f, c in GRAPH_CASES])
def test_graph_steps_match_eager_on_card(cuda_device, family, cfg):
    """One bf16 model, one engine per mode on the same weights: every
    pure-decode step replays a captured graph, and so does every mixed
    step but a hybrid model's (counted eager), and the greedy and sampled
    streams (same seed) equal the per-step path's, with the same launch
    counts (each replay adds its capture's) and the split counters back
    at zero."""
    make = GRAPH_MAKERS[family]
    eager = make(cuda_device, dtype="bfloat16", enforce_eager=True, **cfg)
    graph = make(cuda_device, params=eager.runner.params, dtype="bfloat16",
                 enforce_eager=False, **cfg)
    assert eager.runner.graphs is None and graph.runner.graphs.cuda
    for temperature in (0.0, 0.8):
        want, want_counts = _serve(eager, temperature)
        got, got_counts = _serve(graph, temperature)
        assert got == want, f"temperature {temperature}"
        assert got_counts == want_counts
        assert not any(k[1] is None for k in got_counts)   # no plain call
        _counters_zero(cuda_device)
    assert graph.step_counts == eager.step_counts
    runner = graph.runner
    keys = runner.graphs.keys
    assert runner.num_shape_signatures == len(keys) > 0
    decode = {k for k in keys if k[0] != "mixed"}
    # the hybrid engine runs at most 8 sequences
    assert {k[1] for k in decode} == ({8} if family == "hybrid"
                                      else {8, 16})
    assert {k[4] for k in decode} == {True, False}
    mixed = graph.step_counts["mixed"]
    assert runner.graphs.by_kind["mixed"]["replays"] == (
        0 if family == "hybrid" else mixed)
    assert runner.eager_mixed["hybrid"] == (
        mixed if family == "hybrid" else 0)
    assert runner.staging.allocations == 1
    assert runner.graphs.pool_bytes() > 0


@pytest.mark.cuda
def test_graph_warmup_on_card_leaves_counts_and_streams(cuda_device):
    """``warmup`` captures JAX's combos (greedy and sampled) on the card and
    leaves the launch counters and step counts as they were; the streams
    that follow equal an eager engine's."""
    from gllm_tpu_torch.runner import graphs
    eager = _tiny_engine(cuda_device, dtype="bfloat16", enforce_eager=True)
    graph = _tiny_engine(cuda_device, params=eager.runner.params,
                         dtype="bfloat16")
    counts, steps = _all_counts(), dict(graph.step_counts)
    graph.runner.warmup()
    assert _all_counts() == counts and graph.step_counts == steps
    c = graph.config
    maxd = min(c.scheduler.max_decode_seqs, graph.runner.builder.max_seqs)
    combos = graphs.warmup_combos(maxd, c.max_pages_per_seq,
                                  graph.runner.num_pages)
    # the decode combos and the mixed pass, greedy and sampled
    assert graph.runner.num_shape_signatures == 2 * (
        len(combos) + len(graphs.pow2_range(8, maxd)))
    assert _serve(graph, 0.0) == _serve(eager, 0.0)
    _counters_zero(cuda_device)


# the cache modes of both families whose mixed and verify steps replay
# graphs: the legacy kernels over a bf16, int8 and fp8 cache, the unified
# kernel; MLA over a bf16 and an fp8 latent, and unified
MIXED_CASES = [
    ("dense", {}), ("dense", dict(kv_cache_dtype="int8")),
    ("dense", dict(kv_cache_dtype="fp8")), ("dense", dict(unified_step=True)),
    ("deepseek", {}), ("deepseek", dict(kv_cache_dtype="fp8")),
    ("deepseek", dict(unified_step=True))]


def _strict_steps(runner):
    """Dispatch the runner's single steps under sync-debug mode "error":
    a host sync in a step's staging, splice, prologue or replay raises."""
    step_async = runner.step_async

    def strict(batch, prev=None, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step_async(batch, prev, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    runner.step_async = strict


@pytest.mark.cuda
@pytest.mark.parametrize("family,cfg", MIXED_CASES,
                         ids=[f + "".join(f"-{v}" for v in c.values())
                              for f, c in MIXED_CASES])
def test_mixed_and_verify_replays_equal_the_eager_step(cuda_device, family,
                                                       cfg):
    """bf16, the same weights, host-driven speculation: the prefill steps,
    the mixed steps (chunks beside drafted decode rows) and the verify
    steps replay their graphs and give the tokens of the same batches run
    eagerly (an ``enforce_eager`` engine on the same traffic); once the
    keys exist (a first run), the second run's dispatches raise nothing
    under sync-debug mode "error" (no host sync inside a body) and
    capture nothing."""
    make = GRAPH_MAKERS[family]
    flags = dict(spec_decode="ngram", **cfg)
    eager = make(cuda_device, dtype="bfloat16", enforce_eager=True, **flags)
    graph = make(cuda_device, params=eager.runner.params, dtype="bfloat16",
                 **flags)
    want = _spec_serve(eager)
    assert _spec_serve(graph) == want          # the keys captured here
    runner = graph.runner
    keys = set(runner.graphs.keys)
    by_kind = runner.graphs.by_kind
    replays = {k: v["replays"] for k, v in by_kind.items()}
    steps, verify0 = dict(graph.step_counts), graph.verify_steps
    _strict_steps(runner)
    assert _spec_serve(graph) == want
    assert set(runner.graphs.keys) == keys
    mixed = graph.step_counts["mixed"] - steps["mixed"]
    verify = graph.verify_steps - verify0
    assert 0 < verify < mixed
    assert by_kind["verify"]["replays"] - replays["verify"] == verify
    assert by_kind["mixed"]["replays"] - replays["mixed"] == mixed - verify
    assert sum(runner.eager_mixed.values()) == 0
    _drained(graph)
    _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    {}, dict(pipelined_loop=True, unified_step=True, ondevice_finish=True,
             decode_slot_batching=True)], ids=["sync", "absorb"])
def test_mixed_keys_pool_within_the_reckoning(cuda_device, flags):
    """Llama-3.2-1B's widths at two layers, a 2048-token prefill budget:
    the mixed steps of ``warmup``'s mixed pass at the small sequence
    buckets (a full chunk beside decode rows at the token bucket, greedy
    and sampled), captured first, grow the graphs' pool by no more than
    ``mixed_pool_bytes`` reckons; after the whole warmup all the pools
    stay within the headroom's graph part."""
    import gllm_tpu_torch as gt
    from gllm_tpu_torch.runner.runner import ACTIVATION_HEADROOM
    mc = gt.ModelConfig(architecture="LlamaForCausalLM", vocab_size=128256,
                        hidden_size=2048, num_layers=2, num_heads=32,
                        num_kv_heads=8, head_dim=64, intermediate_size=8192,
                        max_position=4096, tie_word_embeddings=True)
    llm = gt.LLM(model_cfg=mc, device=cuda_device, config=gt.EngineConfig(
        dtype="bfloat16", load_format="dummy", max_model_len=4096,
        cache=gt.CacheConfig(num_pages=2048), **flags))
    runner = llm.runner
    g = runner.graphs
    runner._warming = True                 # throwaway rows, as warmup's
    for nseq in (8, 16):
        for temp in (0.0, 1.0):
            runner._warm_mixed(nseq, runner.builder.max_pages_per_seq, temp)
    runner._warming = False
    mixed = g.by_kind["mixed"]
    assert mixed["captured"] == 4
    assert 0 < mixed["pool_bytes"] <= runner.mixed_pool_bytes(), mixed
    runner.warmup()
    assert (g.pool_bytes()
            <= runner.activation_headroom() - ACTIVATION_HEADROOM)


@pytest.mark.cuda
def test_decode_scratch_cannot_grow_under_a_graph(cuda_device):
    """Once a runner has captured, the split-KV scratch holds its address:
    growing it raises; with the runner gone it grows again."""
    import gc
    graph = _tiny_engine(cuda_device, dtype="bfloat16")
    _serve(graph, 0.0)
    buf = graph.runner.graphs.scratch
    assert buf is not None
    size = buf.numel()
    assert tdec.decode_scratch(cuda_device, 0).data_ptr() == buf.data_ptr()
    with pytest.raises(RuntimeError, match="captured CUDA graph"):
        tdec.decode_scratch(cuda_device, 2 * size)
    del graph, buf
    gc.collect()
    assert tdec.decode_scratch(cuda_device, 2 * size).numel() >= 2 * size


# ---- overlap scheduling and the pipelined loop -----------------------------

OVERLAP_FLAGS = {"overlap": dict(overlap_scheduling=True),
                 "pipelined": dict(pipelined_loop=True)}


def _greedy_workload():
    """Twelve short prompts and their greedy, staggered-length requests."""
    import gllm_tpu_torch as gt
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 1000, int(n)).tolist()
               for n in rng.integers(3, 30, 12)]
    return prompts, [gt.SamplingParams(temperature=0.0, max_tokens=int(m),
                                       ignore_eos=True)
                     for m in rng.integers(6, 30, 12)]


def _serve_greedy(llm, arrive_after=2):
    """``_greedy_workload``'s requests, nine of them arriving after
    ``arrive_after`` steps (so that chains yield, break on finishes and
    re-form): their greedy streams."""
    prompts, sps = _greedy_workload()
    seqs = [llm._allocate_seq(p, sp) for p, sp in zip(prompts, sps)]
    for s in seqs[:3]:
        llm.add_seq(s)
    steps = 0
    while llm.has_unfinished or steps <= arrive_after:
        if steps == arrive_after:
            for s in seqs[3:]:
                llm.add_seq(s)
        llm.step()
        steps += 1
    return [s.output_token_ids for s in seqs]


def _drained(llm):
    mm = llm.memory_manager
    assert not llm._in_flight
    assert mm.num_free_pages == mm.allocator.num_total
    if mm.use_ssm:
        assert mm.ssm_alloc.num_free == mm.ssm_alloc.num_total


def _ran_ahead(llm):
    """Decode entries dispatched while another was in flight."""
    return sum(n for (kind, depth), n in llm.dispatches.items()
               if kind == "decode" and depth >= 2)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("flags", list(OVERLAP_FLAGS))
@pytest.mark.parametrize("family", ["dense", "deepseek", "hybrid"])
def test_overlap_streams_equal_the_sync_loop_on_card(cuda_device, family,
                                                     flags, warm):
    """bf16 engines on the same weights: greedy streams under overlap
    scheduling and the pipelined loop equal the sync loop's, decode steps
    ran ahead over the graphs, and pages and slots all come back. Cold:
    no ``warmup()``, so graphs are captured while entries are in flight.
    The hybrid model chains and never re-forms."""
    make = GRAPH_MAKERS[family]
    sync = make(cuda_device, dtype="bfloat16")
    llm = make(cuda_device, params=sync.runner.params, dtype="bfloat16",
               **OVERLAP_FLAGS[flags])
    if warm:
        llm.runner.warmup()
    by_kind = llm.runner.graphs.by_kind
    replays = {k: v["replays"] for k, v in by_kind.items()}
    steps = dict(llm.step_counts)
    reforms = []
    reform = llm.scheduler.schedule_reform
    llm.scheduler.schedule_reform = lambda b, **kw: (
        reforms.append(b), reform(b, **kw))[1]
    assert _serve_greedy(llm) == _serve_greedy(sync)
    _drained(llm)
    _counters_zero(cuda_device)
    assert _ran_ahead(llm) > 0
    assert (by_kind["decode"]["replays"] - replays["decode"]
            == llm.step_counts["decode"] - steps["decode"] > 0)
    # a hybrid model's mixed steps run eagerly
    assert (by_kind["mixed"]["replays"] - replays["mixed"]
            == (0 if family == "hybrid"
                else llm.step_counts["mixed"] - steps["mixed"]))
    if family == "hybrid":
        assert not reforms
    elif flags == "pipelined":
        assert reforms


@pytest.mark.cuda
def test_host_staging_ring_under_a_held_stream(cuda_device):
    """Each upload is queued behind a sleep on the stream, so the host
    fills the next steps' pinned buffers while earlier copies still wait:
    the greedy streams stay the sync loop's (one pinned buffer shared by
    the steps in flight would upload a later step's batch)."""
    sync = _tiny_engine(cuda_device, dtype="bfloat16")
    llm = _tiny_engine(cuda_device, params=sync.runner.params,
                       dtype="bfloat16", pipelined_loop=True)
    staging = llm.runner.staging
    upload = staging.upload

    def held(sb):
        torch.cuda._sleep(2_000_000)         # about a millisecond
        return upload(sb)
    staging.upload = held
    assert _serve_greedy(llm) == _serve_greedy(sync)
    assert _ran_ahead(llm) > 0
    _drained(llm)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "deepseek", "hybrid"])
def test_chained_dispatch_makes_no_host_sync(cuda_device, family):
    """Once every graph of the workload is captured (a first run), the
    pipelined loop's chained dispatches (chained steps and re-forms)
    raise nothing under ``set_sync_debug_mode("error")``."""
    llm = GRAPH_MAKERS[family](cuda_device, dtype="bfloat16",
                               pipelined_loop=True)
    _serve_greedy(llm)
    runner = llm.runner
    chained, calls = runner.step_async_chained, []

    def strict(batch, prev):
        calls.append(batch)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return chained(batch, prev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    runner.step_async_chained = strict
    _serve_greedy(llm)
    assert calls
    _drained(llm)


@pytest.mark.cuda
def test_overlap_sampled_streams_reproducible_on_card(cuda_device):
    """Sampled rows (temperature 0.8, top-p 0.9, top-k 50) under the
    pipelined loop: two engines of one seed give the same streams."""
    first = _tiny_engine(cuda_device, dtype="bfloat16", pipelined_loop=True)
    second = _tiny_engine(cuda_device, params=first.runner.params,
                          dtype="bfloat16", pipelined_loop=True)
    assert _serve(first, 0.8)[0] == _serve(second, 0.8)[0]
    _drained(first)


# ---- multi-step decode and on-device finish (blocks) -----------------------

BLOCK_FLAGS = {"multi": dict(overlap_scheduling=True, multi_step_decode=8),
               "odf": dict(pipelined_loop=True, ondevice_finish=True)}


def _decode_launches(llm, counts):
    """The decode kernel's launches in ``counts`` (``_all_counts`` deltas)
    for ``llm``'s family."""
    name = ("paged_decode_attention_mla" if llm.model_cfg.use_mla
            else "paged_decode_attention")
    return sum(n for (fn, k), n in counts.items() if k == name)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("flags", list(BLOCK_FLAGS))
@pytest.mark.parametrize("family", ["dense", "deepseek"])
def test_block_streams_equal_the_sync_loop_on_card(cuda_device, family,
                                                   flags, warm):
    """bf16 engines on the same weights: with blocks (up to 8 links, or
    16 under on-device finish), the greedy streams equal the sync loop's,
    each dispatch is one replay, the decode kernels launched once a layer
    for every single step and every executed sub-step, the split counters
    are back at zero and pages all come back. Cold: no ``warmup()``."""
    make = GRAPH_MAKERS[family]
    sync = make(cuda_device, dtype="bfloat16")
    llm = make(cuda_device, params=sync.runner.params, dtype="bfloat16",
               **BLOCK_FLAGS[flags])
    if warm:
        llm.runner.warmup()
    runner = llm.runner
    want = _serve_greedy(sync)
    by_kind = runner.graphs.by_kind
    replays = {k: v["replays"] for k, v in by_kind.items()}
    steps = dict(llm.step_counts)
    blocks = dict(runner.block_counts)
    before = _all_counts()
    assert _serve_greedy(llm) == want
    counts = {k: n - before[k] for k, n in _all_counts().items()}
    _drained(llm)
    _counters_zero(cuda_device)
    decode = llm.step_counts["decode"] - steps["decode"]
    nblocks = runner.block_counts["block"] - blocks["block"]
    substeps = runner.block_counts["substeps"] - blocks["substeps"]
    assert nblocks > 0 and sum(llm.blocks.values()) > 0
    assert (by_kind["decode"]["replays"] - replays["decode"]
            + by_kind["block"]["replays"] - replays["block"]
            == decode + nblocks)
    assert (_decode_launches(llm, counts)
            == (decode + substeps) * llm.model_cfg.num_attn_layers)
    assert not any(k[1] is None and n for k, n in counts.items())


def _organic_stops(llm, prompts):
    """Per prompt, its greedy token at output 11 of 24: a stop token that
    finishes it inside a block."""
    import gllm_tpu_torch as gt
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=[
        gt.SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
        for _ in prompts])
    return [o.output_token_ids[11] for o in outs]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "deepseek"])
def test_block_early_exit_skips_substeps_on_card(cuda_device, family):
    """Stop tokens from the greedy stream finish every row of a block
    before its end: the block's conditional nodes skip the rest, the
    executed sub-steps (``k_exec``) fall below K, the decode kernel's
    launches count only the sub-steps that ran, and the streams equal the
    sync loop's (float32)."""
    import gllm_tpu_torch as gt
    make = GRAPH_MAKERS[family]
    sync = make(cuda_device)
    llm = make(cuda_device, params=sync.runner.params,
               **BLOCK_FLAGS["odf"])
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 1000, int(n)).tolist()
               for n in rng.integers(3, 30, 4)]
    stops = _organic_stops(sync, prompts)

    def sps():
        return [gt.SamplingParams(temperature=0.0, max_tokens=24,
                                  stop_token_ids=[t]) for t in stops]
    want = [o.output_token_ids for o in sync.generate(
        prompt_token_ids=prompts, sampling_params=sps())]
    k_run = []
    stats = llm._block_stats
    llm._block_stats = lambda chain, finish: (
        k_run.append((len(chain), int(finish[:chain[0].num_seqs].max()))),
        stats(chain, finish))[1]
    steps, blocks = dict(llm.step_counts), dict(llm.runner.block_counts)
    before = _all_counts()
    got = [o.output_token_ids for o in llm.generate(
        prompt_token_ids=prompts, sampling_params=sps())]
    counts = {k: n - before[k] for k, n in _all_counts().items()}
    assert got == want
    assert any(len(t) < 24 for t in got)
    assert any(e < k for k, e in k_run), k_run
    substeps = llm.runner.block_counts["substeps"] - blocks["substeps"]
    assert substeps == sum(e for _, e in k_run) == llm.block_substeps
    assert (_decode_launches(llm, counts)
            == (llm.step_counts["decode"] - steps["decode"] + substeps)
            * llm.model_cfg.num_attn_layers)
    assert llm.ondevice_finishes["stop"] > 0
    _drained(llm)
    _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "deepseek"])
def test_block_dispatch_makes_no_host_sync(cuda_device, family):
    """Once the workload's graphs are captured (a first run), a block's
    dispatch under on-device finish raises nothing under
    ``set_sync_debug_mode("error")``: the early-exit flags and the finish
    steps stay on the card."""
    llm = GRAPH_MAKERS[family](cuda_device, dtype="bfloat16",
                               **BLOCK_FLAGS["odf"])
    _serve_greedy(llm)
    runner = llm.runner
    multi, calls = runner.step_multi, []

    def strict(chain, prev=None):
        calls.append(chain)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return multi(chain, prev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    runner.step_multi = strict
    _serve_greedy(llm)
    assert calls
    _drained(llm)


@pytest.mark.cuda
def test_sampled_blocks_reproducible_on_card(cuda_device):
    """Sampled rows (temperature 0.8, top-p 0.9, top-k 50) in blocks: two
    engines of one seed give the same streams."""
    first = _tiny_engine(cuda_device, dtype="bfloat16", **BLOCK_FLAGS["odf"])
    second = _tiny_engine(cuda_device, params=first.runner.params,
                          dtype="bfloat16", **BLOCK_FLAGS["odf"])
    assert _serve(first, 0.8)[0] == _serve(second, 0.8)[0]
    assert sum(first.blocks.values()) > 0
    _drained(first)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [False, True], ids=["single", "blocks"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_one_byte_caches_three_deep_on_card(cuda_device, kv, blocks):
    """int8 and fp8 caches under the pipelined loop three deep, blocks off
    and on (float32): the engine's streams are those of its own batches
    run one at a time through a sync engine (a block's links at the
    block's signature; chip_smoke's ``replay_in_sync``). Against the sync
    loop's own streams they may part: a row's float32 result depends on
    its batch (the split-KV plan follows S and the page bucket), and an
    int8 cache rounds such a difference to a whole quantization step.
    Blocks' dead rows write to the dummy page 0, whose int8 scale drifts;
    nothing reads it."""
    import chip_smoke
    sync = _tiny_engine(cuda_device, kv_cache_dtype=kv)
    flags = dict(pipelined_loop=True, overlap_depth=3)
    if blocks:
        flags["ondevice_finish"] = True
    llm = _tiny_engine(cuda_device, params=sync.runner.params,
                       kv_cache_dtype=kv, **flags)
    schedule = chip_smoke.record_schedule(llm)
    got = _serve_greedy(llm)
    prompts, sps = _greedy_workload()
    chip_smoke.replay_in_sync("card test", kv, sync, schedule, prompts, sps,
                              got)
    assert (sum(llm.blocks.values()) > 0) == blocks
    assert max(d for _, d in llm.dispatches) == 3
    _drained(llm)
    _counters_zero(cuda_device)


@pytest.mark.cuda
def test_second_engine_gets_the_first_engines_pages(cuda_device):
    """Build, serve (graphs, blocks) and free an engine, then the same
    engine again in the same process: the second sizes its KV pool from
    the same free memory, within 64 MiB's worth of pages."""
    import gc
    import gllm_tpu_torch as gt
    pages = []
    for _ in range(2):
        mc = gt.ModelConfig(architecture="LlamaForCausalLM",
                            vocab_size=1000, hidden_size=256, num_layers=2,
                            num_heads=8, num_kv_heads=2, head_dim=32,
                            intermediate_size=512, max_position=512)
        llm = gt.LLM(model_cfg=mc, device=cuda_device, config=gt.EngineConfig(
            dtype="bfloat16", load_format="dummy", max_model_len=512,
            scheduler=gt.SchedulerConfig(max_prefill_tokens=48),
            cache=gt.CacheConfig(page_size=16, memory_util=0.5),
            **BLOCK_FLAGS["odf"]))
        llm.runner.warmup(decode_buckets=(8, 16))
        _serve_greedy(llm)
        pages.append((llm.runner.num_pages, llm.runner.kv_bytes_per_page()))
        del llm
        gc.collect()
        torch.cuda.empty_cache()
    (first, per_page), (second, _) = pages
    assert second >= first - (64 << 20) // per_page, pages


# ---- dummy weights and memory across engines ---------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("per_matrix", [True, False])
def test_dummy_draws_equal_per_unit_draws_on_card(cuda_device, per_matrix):
    """``DummyDraws`` (one float32 scratch for every draw) gives the values
    of a float32 draw per unit from the same generator, scaled and cast."""
    from gllm_tpu_torch.models.dummy import DummyDraws
    draws = DummyDraws(7, torch.bfloat16, cuda_device)
    shapes = [((3, 64, 96), 0.5), ((1000, 33), 2.0), ((2, 5, 8, 16), 1.0)]
    got = [draws.normal(shape, scale, per_matrix) for shape, scale in shapes]
    draws.draw()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    for (shape, scale), out in zip(shapes, got):
        units = ([shape[-2:]] * (int(np.prod(shape)) // (shape[-2]
                                                          * shape[-1]))
                 if per_matrix else [shape])
        want = torch.cat([torch.randn(u, generator=gen, device=cuda_device,
                                      dtype=torch.float32).mul_(scale)
                          .to(torch.bfloat16).flatten() for u in units])
        assert torch.equal(out.flatten(), want)


@pytest.mark.cuda
def test_hybrid_engine_gets_its_pages_back_after_a_deepseek_multi_engine(
        cuda_device):
    """A hybrid engine sized from free memory, freed; then a DeepSeek engine
    with blocks under on-device finish and persistent slots built, warmed,
    serving a stop-token workload (finishes inside blocks) and freed; then
    the hybrid engine again: it sizes its KV pool from the same memory,
    within 0.05 GiB's worth of pages (nothing the multi engine made stays
    held)."""
    import gc
    import gllm_tpu_torch as gt

    def hybrid_pages():
        llm = _hybrid_engine(cuda_device, dtype="bfloat16")
        llm.config.cache.num_pages = None
        runner = llm.runner
        pages = runner.determine_num_pages(), runner.kv_bytes_per_page()
        del llm, runner
        gc.collect()
        torch.cuda.empty_cache()
        return pages
    first, per_page = hybrid_pages()
    ds = _deepseek_engine(cuda_device, dtype="bfloat16",
                          **SLOT_LOOPS["deepseek"], **SLOT_FLAGS)
    ds.runner.warmup(decode_buckets=(8, 16))
    prompts, sps = _greedy_workload()
    stops = _organic_stops(ds, prompts)
    ds.generate(prompt_token_ids=prompts, sampling_params=[
        gt.SamplingParams(temperature=0.0, max_tokens=24,
                          stop_token_ids=[t]) for t in stops])
    assert sum(ds.blocks.values()) > 0 and ds.ondevice_finishes["stop"] > 0
    _drained(ds)
    del ds
    gc.collect()
    torch.cuda.empty_cache()
    second, _ = hybrid_pages()
    assert second >= first - (1 << 30) * 0.05 // per_page, (first, second)


# ---- persistent slots (holes, joins at chain boundaries) --------------------

SLOT_FLAGS = dict(decode_slot_batching=True, chain_under_prefill=8)
# the multi twin's loop for the dense and MLA models, the overlap twin's
# for the hybrid model (which never fuses)
SLOT_LOOPS = {"dense": dict(pipelined_loop=True, ondevice_finish=True),
              "deepseek": dict(pipelined_loop=True, ondevice_finish=True),
              "hybrid": dict(pipelined_loop=True)}
# three deep with blocks of up to 8: a late arrival joins a hole
JOIN_FLAGS = dict(overlap_scheduling=True, multi_step_decode=8,
                  overlap_depth=3, **SLOT_FLAGS)


def _serve_late_join(llm):
    """Four requests, one finishing after three tokens (a hole), and a late
    one added once it has finished, which joins the hole
    (tests/test_slot_batching.py:118): their greedy streams."""
    import gllm_tpu_torch as gt
    rng = np.random.default_rng(7)
    seqs = [llm._allocate_seq(rng.integers(1, 1000, n).tolist(),
                              gt.SamplingParams(temperature=0.0,
                                                max_tokens=m,
                                                ignore_eos=True))
            for n, m in zip((8, 9, 10, 5, 6), (40, 40, 40, 3, 10))]
    for s in seqs[:4]:
        llm.add_seq(s)
    added = False
    while llm.has_unfinished or not added:
        llm.step()
        if not added and seqs[3].finish_reason is not None:
            llm.add_seq(seqs[4])
            added = True
    return [s.output_token_ids for s in seqs]


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("family", ["dense", "deepseek", "hybrid"])
def test_slot_streams_equal_their_batches_replayed_on_card(cuda_device,
                                                           family, warm):
    """bf16 engines on the same weights under persistent slots: the slot
    engine's greedy streams are those of its own batches (hole rows dead
    in their places) run one at a time through the sync engine
    (chip_smoke's ``replay_in_sync``); finished rows rode on as holes, no
    finish broke a chain, and pages and slots all come back. Cold: no
    ``warmup()``."""
    import chip_smoke
    make = GRAPH_MAKERS[family]
    sync = make(cuda_device, dtype="bfloat16")
    llm = make(cuda_device, params=sync.runner.params, dtype="bfloat16",
               **SLOT_LOOPS[family], **SLOT_FLAGS)
    if warm:
        llm.runner.warmup()
    schedule = chip_smoke.record_schedule(llm)
    got = _serve_greedy(llm)
    prompts, sps = _greedy_workload()
    chip_smoke.replay_in_sync("card test", "slot", sync, schedule, prompts,
                              sps, got)
    assert llm.hole_substeps > 0 and llm.chain_breaks["finish"] == 0
    assert bool(llm.blocks) == (family != "hybrid")
    assert llm.scheduler._hole_seq.num_in_flight == 0
    _drained(llm)
    _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "deepseek", "hybrid"])
def test_slot_dispatch_with_joins_makes_no_host_sync(cuda_device, family):
    """Once the workload's graphs are captured (a first run), the chained
    dispatches of a slot engine, those with a join among them (the joined
    row's token spliced from the host, the others' from the device),
    raise nothing under ``set_sync_debug_mode("error")``; the streams are
    the sync loop's."""
    make = GRAPH_MAKERS[family]
    sync = make(cuda_device, dtype="bfloat16")
    llm = make(cuda_device, params=sync.runner.params, dtype="bfloat16",
               **JOIN_FLAGS)
    want = _serve_late_join(sync)
    assert _serve_late_join(llm) == want
    runner, calls = llm.runner, []

    def strict(fn):
        def run(batch, prev=None, **kw):
            calls.append(batch[0] if isinstance(batch, list) else batch)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(batch, prev, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run
    runner.step_async_chained = strict(runner.step_async_chained)
    runner.step_multi = strict(runner.step_multi)
    assert _serve_late_join(llm) == want
    assert any(b.host_rows for b in calls), "no sequence joined a hole"
    _drained(llm)


# K2 at D 64 and 256 and K2m over each cache they take (no int8 at D 256
# or over a latent)
HOLE_CASES = [(family, kind) for family in ("gqa", "gqa_d256", "mla")
              for kind in DECODE_KINDS
              if family == "gqa" or DECODE_KINDS[kind][1] != "int8"]


@pytest.mark.cuda
@pytest.mark.parametrize("family,kind", HOLE_CASES)
def test_decode_kernels_take_hole_rows(cuda_device, family, kind):
    """K2 (D 64 and 256) and K2m against their plain versions on a batch
    whose rows include hole rows of a persistent-slot chain (context one
    token in the dummy page 0, which holds finite data as serving leaves
    it; the page-table row all zeros) beside long contexts that split,
    an empty padding row and a one-page row."""
    qdtype, cache = DECODE_KINDS[kind]
    page = 16
    Hq, Hkv, D, v_dim = {"gqa": (8, 2, 64, None),
                         "gqa_d256": (8, 2, 256, None),
                         "mla": (16, 1, 576, 512)}[family]
    lens = [1, 3000, 1, 17, 0, 1, 900, 1]
    holes = [0, 2, 5, 7]
    rng = np.random.default_rng(33)
    num_pages = 1 + sum(-(-k // page) for k in lens)
    q, kc, vc, kvl, pt = decode_case(rng, lens, Hq, Hkv, D, page, num_pages)
    pt[holes] = 0
    chunk, n = _plan(cuda_device, qdtype, cache, len(lens), Hq, Hkv, D, page,
                     pt.shape[1], v_dim)
    assert n > 1
    q = torch.from_numpy(q).to(cuda_device, qdtype)
    kvl, pt = (torch.from_numpy(a).to(cuda_device) for a in (kvl, pt))
    kw = dict(scale=D ** -0.5)
    if cache == "int8":
        k8, v8, ks, vs = int8_cache(rng, kc, vc)
        caches = [torch.from_numpy(a).to(cuda_device) for a in (k8, v8)]
        kw.update(k_scale=torch.from_numpy(ks).to(cuda_device),
                  v_scale=torch.from_numpy(vs).to(cuda_device))
    else:
        dtype = FP8 if cache == "fp8" else qdtype
        caches = [torch.from_numpy(a).to(cuda_device).to(dtype)
                  for a in (kc, vc)]
    if v_dim:
        caches[1] = None
        kw["v_dim"] = v_dim
    out = tdec.paged_decode_attention(q, *caches, kvl, pt, **kw)
    want = tdec.paged_decode_attention_plain(q, *caches, kvl, pt, **kw)
    _check(out, want, qdtype)
    assert (out[4] == 0).all()                       # the padding row
    _counters_zero(cuda_device)


# ---- the unified step under overlap (mixed re-forms absorb prefill) --------

# the slot loop of the dense and MLA models with the unified step (which
# retires chain_under_prefill)
ABSORB_FLAGS = dict(SLOT_LOOPS["dense"], decode_slot_batching=True,
                    unified_step=True)


def _prefill_row(batch) -> bool:
    return any(it.num_new_tokens > 1 or it.computed_before < it.seq.prompt_len
               for it in batch.items)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("family", ["dense", "deepseek"])
def test_absorb_streams_equal_their_batches_replayed_on_card(cuda_device,
                                                             family, warm):
    """bf16 engines on the same weights under the unified step: the absorb
    engine (overlap, blocks, slots) dispatches mixed re-forms (K1u / K1um's
    mixed class, its decode prefix spliced on the device) and its greedy
    streams are those of its own batches run one at a time through the
    unified sync engine (chip_smoke's ``replay_in_sync``); no ``waiting``
    break, and pages and split counters all come back. Cold: no
    ``warmup()``."""
    import chip_smoke
    make = GRAPH_MAKERS[family]
    sync = make(cuda_device, dtype="bfloat16", unified_step=True)
    llm = make(cuda_device, params=sync.runner.params, dtype="bfloat16",
               **ABSORB_FLAGS)
    if warm:
        llm.runner.warmup()
    schedule = chip_smoke.record_schedule(llm)
    got = _serve_greedy(llm)
    prompts, sps = _greedy_workload()
    chip_smoke.replay_in_sync("card test", "absorb", sync, schedule, prompts,
                              sps, got)
    assert llm.absorbs > 0 and llm.chain_breaks["waiting"] == 0
    assert llm.blocks and llm.runner.attn_impl == "unified"
    assert llm.scheduler._hole_seq.num_in_flight == 0
    _drained(llm)
    _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "deepseek"])
def test_mixed_reform_off_a_block_makes_no_host_sync(cuda_device, family):
    """Once the workload's graphs are captured (a first run), the absorb
    engine's chained dispatches, among them a mixed re-form chained off a
    block (its promised rows spliced from the block's last sub-step, its
    prefill chunks eager at the unified token bucket), raise nothing under
    ``set_sync_debug_mode("error")``; the streams are the first run's."""
    llm = GRAPH_MAKERS[family](cuda_device, dtype="bfloat16", **ABSORB_FLAGS)
    want = _serve_greedy(llm)
    runner, calls = llm.runner, []

    def strict(fn):
        def run(batch, prev=None, **kw):
            first = batch[0] if isinstance(batch, list) else batch
            calls.append((first, prev))
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(batch, prev, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run
    runner.step_async_chained = strict(runner.step_async_chained)
    runner.step_multi = strict(runner.step_multi)
    assert _serve_greedy(llm) == want
    assert any(_prefill_row(b) and b.src_rows is not None and prev is not None
               and prev.block is not None for b, prev in calls), \
        "no mixed re-form chained off a block"
    _drained(llm)


# K1u over each cache it takes, K1um over each latent
UNIFIED_HOLE_CASES = ([("gqa", kind) for kind in DECODE_KINDS]
                      + [("mla", kind) for kind in MLA_KINDS])


@pytest.mark.cuda
@pytest.mark.parametrize("family,kind", UNIFIED_HOLE_CASES)
def test_unified_decode_only_takes_hole_rows(cuda_device, family, kind):
    """K1u (G 4, D 64) and K1um (latent 576, values 512) with
    ``decode_only``, as a block's sub-steps call them, against their plain
    versions on a batch whose rows include hole rows of a persistent-slot
    chain (context one token in the dummy page 0, which holds finite data
    as serving leaves it; the page-table row all zeros) beside long
    contexts that split and a one-page row, then two padding rows (q_len
    0, zero output)."""
    qdtype, cache = (DECODE_KINDS if family == "gqa" else MLA_KINDS)[kind]
    page = 16
    Hq, Hkv, D, v_dim = {"gqa": (8, 2, 64, None),
                         "mla": (16, 1, 576, 512)}[family]
    lens = [1, 3000, 1, 17, 1, 900, 1]
    holes = [0, 2, 4, 6]
    rng = np.random.default_rng(33)
    num_pages = 1 + sum(-(-k // page) for k in lens)
    q, kc, vc, cu, kvl, pt = ragged_case(rng, [(1, k) for k in lens], Hq,
                                         Hkv, D, page, num_pages, pad_seqs=2,
                                         pad_tokens=2)
    pt[holes] = 0
    S = len(lens) + 2
    assert q.shape[0] == S
    chunk, n = _plan(cuda_device, qdtype, cache, S, Hq, Hkv, D, page,
                     pt.shape[1], v_dim)
    assert n > 1
    q = torch.from_numpy(q).to(cuda_device, qdtype)
    cu, kvl, pt = (torch.from_numpy(a).to(cuda_device) for a in (cu, kvl, pt))
    kw = dict(scale=D ** -0.5, unified=True, v_dim=v_dim)
    if cache == "int8":
        k8, v8, ks, vs = int8_cache(rng, kc, vc)
        caches = [torch.from_numpy(a).to(cuda_device) for a in (k8, v8)]
        kw.update(k_scale=torch.from_numpy(ks).to(cuda_device),
                  v_scale=torch.from_numpy(vs).to(cuda_device))
    else:
        dtype = FP8 if cache == "fp8" else qdtype
        caches = [torch.from_numpy(a).to(cuda_device).to(dtype)
                  for a in (kc, vc)]
    if v_dim:
        caches[1] = None
    out = trag.ragged_paged_attention(q, *caches, cu, kvl, pt, **kw,
                                      decode_only=True)
    want = trag.ragged_paged_attention_plain(q, *caches, cu, kvl, pt, **kw)
    _check(out, want, qdtype)
    assert not out[len(lens):].float().any()         # the padding rows
    _counters_zero(cuda_device)


@pytest.mark.cuda
def test_capture_error_raises_with_no_eager_rerun(cuda_device):
    """A step body that syncs with the host (``.item()``) runs in the
    side-stream warm-up but fails under capture: the error reaches the
    caller, no graph is kept, and the step is not run eagerly instead.
    (Last in the file: a failed capture may leave the stream's allocator
    state behind.)"""
    import gllm_tpu_torch as gt
    llm = _tiny_engine(cuda_device, dtype="bfloat16")
    runner = llm.runner
    forward, calls = runner._hidden, []

    def syncing(batch, max_q):
        out = forward(batch, max_q)
        calls.append(max_q)
        out[0].sum().item()
        return out
    runner._hidden = syncing
    sp = gt.SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
    with pytest.raises(RuntimeError):
        llm.generate(prompt_token_ids=[[1, 2, 3]], sampling_params=sp)
    # the first step is a prefill chunk: its mixed body's warm-up and its
    # capture, at the key's max_q_len, and no third, eager run
    assert len(calls) == 2 and calls[0] == calls[1] > 1
    assert runner.num_shape_signatures == 0


@pytest.mark.cuda
def test_capture_never_collects_a_freed_engine(cuda_device, monkeypatch):
    """An engine dropped in a reference cycle is freed by the cyclic
    collector, whenever it runs; inside another engine's capture, the
    destruction of its graphs would invalidate the capture (global
    capture mode). The collector is off while a graph captures: here a
    collection is forced at every capture's start wherever the collector
    is on, and the second engine still captures and serves."""
    import gc
    old = _tiny_engine(cuda_device, dtype="bfloat16")
    _serve_greedy(old)
    assert len(old.runner.graphs)
    enter = torch.cuda.graphs.graph.__enter__

    def enter_and_collect(self):
        out = enter(self)
        if gc.isenabled():
            gc.collect()
        return out
    monkeypatch.setattr(torch.cuda.graphs.graph, "__enter__",
                        enter_and_collect)
    # threshold 0: no collection but the forced ones (the collector stays
    # on), so the old engine lives until the new one's first capture
    thresholds = gc.get_threshold()
    gc.set_threshold(0)
    try:
        old.cycle = old
        del old
        new = _tiny_engine(cuda_device, dtype="bfloat16")
        got = _serve_greedy(new)
    finally:
        gc.set_threshold(*thresholds)
    assert all(got) and len(new.runner.graphs)
    _drained(new)


# ---- the serving front end ---------------------------------------------------

class _IdTokenizer:
    """Each token decodes to ``<id>``: a stream's text gives its ids back."""

    def decode(self, ids, skip_special_tokens=False):
        return "".join(f"<{int(i)}>" for i in ids)


def _http_stream(port, prompt, max_tokens):
    """One streamed greedy completion over HTTP: its token ids, read back
    from the chunks' texts, and its finish reason."""
    import http.client
    import json
    import re
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/completions", body=json.dumps({
        "prompt": prompt, "max_tokens": max_tokens, "temperature": 0.0,
        "ignore_eos": True, "stream": True}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    events = [e[6:] for e in resp.read().decode().split("\n\n")
              if e.startswith("data: ")]
    conn.close()
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
    text = "".join(c["text"] for c in chunks)
    return ([int(t) for t in re.findall(r"<(\d+)>", text)],
            chunks[-1]["finish_reason"], len(chunks))


@pytest.mark.cuda
def test_http_streams_equal_offline_generate_on_card(cuda_device):
    """An in-process server (``serve``) over a 2-layer float32 model under
    the smoke server's flags (the unified step under overlap, persistent
    slots, blocks under on-device finish): twelve greedy streams over HTTP,
    at once and staggered, equal a second engine's offline ``generate`` on
    the same weights and flags (at float32 the port's batching does not
    move greedy tokens); K1u served them, and every page comes back."""
    import threading
    import time
    from gllm_tpu_torch.entrypoints.api_server import serve
    from gllm_tpu_torch.runner import graphs
    served = _tiny_engine(cuda_device, **ABSORB_FLAGS)
    served.tokenizer = _IdTokenizer()
    offline = _tiny_engine(cuda_device, params=served.runner.params,
                           **ABSORB_FLAGS)
    prompts, sps = _greedy_workload()
    want = [o.output_token_ids for o in offline.generate(
        prompt_token_ids=prompts, sampling_params=sps)]
    httpd = serve(served, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    before = graphs.launch_counts()
    try:
        for stagger in (0.0, 0.05):
            got = [None] * len(prompts)

            def run(i):
                time.sleep(i * stagger)
                got[i] = _http_stream(port, prompts[i], sps[i].max_tokens)
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            for i, ((ids, fin, n), w) in enumerate(zip(got, want)):
                assert (fin, n) == ("length", len(w)), (i, fin, n)
                if ids != w:
                    j = next(k for k, (a, b) in enumerate(zip(ids, w))
                             if a != b)
                    pytest.fail(f"stagger {stagger}: request {i} parts at "
                                f"token {j}: {ids[j]} over HTTP, {w[j]} "
                                f"offline")
    finally:
        httpd.shutdown()
        httpd.state.engine.shutdown()
        httpd.server_close()
    after = graphs.launch_counts()
    launched = {k for (fn, k), n in after.items()
                if k is not None and n > before.get((fn, k), 0)}
    assert launched == {"ragged_paged_attention_unified"}, launched
    _drained(served)
    _counters_zero(cuda_device)


# ---- prompt-lookup speculative decoding ------------------------------------

SPEC_FUSED = dict(spec_decode="ngram", spec_fused=True)
SPEC_FULL = dict(SPEC_FUSED, pipelined_loop=True, unified_step=True,
                 overlap_depth=4, multi_step_decode=32, ondevice_finish=True,
                 decode_slot_batching=True)


def _spec_workload(n=6, temperature=0.0):
    """Prompts of a repeated random segment (prompt lookup drafts from
    them) and their requests, 20..40 output tokens each."""
    import gllm_tpu_torch as gt
    rng = np.random.default_rng(21)
    prompts = []
    for _ in range(n):
        seg = rng.integers(1, 1000, int(rng.integers(3, 7))).tolist()
        prompts.append(seg * int(rng.integers(3, 6)))
    return prompts, [gt.SamplingParams(temperature=temperature, top_k=20,
                                       max_tokens=int(m), ignore_eos=True)
                     for m in rng.integers(20, 41, n)]


def _spec_serve(llm, temperature=0.0):
    prompts, sps = _spec_workload(temperature=temperature)
    return [o.output_token_ids for o in llm.generate(
        prompt_token_ids=prompts, sampling_params=sps)]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["verify_greedy", "verify_sampled",
                                "ngram_propose", "ring_shift_in"])
def test_spec_ops_on_card_match_cpu(cuda_device, op):
    """``spec_verify`` (greedy; sampled with its draws fixed),
    ``ngram_propose`` and ``ring_shift_in`` on the card give their CPU
    results."""
    from gllm_tpu_torch.ops import sampling as ts
    rng = np.random.default_rng(4)
    if op.startswith("verify"):
        S, K, V = 16, 4, 300
        logits = rng.standard_normal((S, K + 1, V)).astype(np.float32)
        drafts = logits[:, :K].argmax(-1).astype(np.int32)
        drafts[::3, 1] = 7
        drafts[1::4, 2:] = -1
        temp = (np.zeros(S) if op == "verify_greedy"
                else rng.uniform(0.5, 1.5, S) * (np.arange(S) % 2))
        md = [np.asarray(temp, np.float32), np.full(S, 0.9, np.float32),
              np.full(S, 30, np.int32), np.full(S, 0.02, np.float32)]
        u = rng.random((S, K + 1)).astype(np.float32)
        g = -np.log(rng.exponential(size=(S, K + 1, V))).astype(np.float32)
        outs = []
        for dev in ("cpu", cuda_device):
            t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
            outs.append([x.cpu() for x in ts.spec_verify(
                t(logits), t(drafts), ts.SamplingMetadata(*map(t, md)),
                sampled=op == "verify_sampled", draws=(t(u), t(g)))])
    else:
        R = 64
        ring = rng.integers(0, 6, (32, R)).astype(np.int32)
        rlen = rng.integers(0, R + 1, 32).astype(np.int32)
        ring[np.arange(R)[None, :] < (R - rlen)[:, None]] = -1
        toks = rng.integers(0, 6, (32, 5)).astype(np.int32)
        counts = rng.integers(0, 6, 32).astype(np.int32)
        outs = []
        for dev in ("cpu", cuda_device):
            t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
            res = (ts.ngram_propose(t(ring), t(rlen), n=2, k=4)
                   if op == "ngram_propose"
                   else ts.ring_shift_in(t(ring), t(rlen), t(toks),
                                         t(counts)))
            outs.append([x.cpu() for x in (res if isinstance(res, tuple)
                                           else (res,))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("unified", [False, True])
@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_ragged_classes_at_the_verify_geometry(cuda_device, family, unified):
    """K1 / K1u (Llama-3.2-1B's heads) and K1m / K1um (a latent row of 576,
    values its leading 512) on verify rows: 12 rows of 5 query tokens over
    contexts 21..900, two padding rows, bf16, against their plain
    versions; the tolerance rejects every row's context one key short."""
    rng = np.random.default_rng(41)
    seqs = [(5, int(k)) for k in rng.integers(21, 901, 12)]
    if family == "gqa":
        Hq, Hkv, D, Dv = 32, 8, 64, None
    else:
        Hq, Hkv, D, Dv = 16, 1, 576, 512
    num_pages = 1 + sum(-(-k // 16) for _, k in seqs)
    q, kc, vc, cu, kvl, pt = ragged_case(rng, seqs, Hq, Hkv, D, 16,
                                         num_pages, pad_seqs=2)
    dev = cuda_device
    q, kc, vc = (torch.from_numpy(a).to(dev, torch.bfloat16)
                 for a in (q, kc, vc))
    cu, kvl, pt = (torch.from_numpy(a).to(dev) for a in (cu, kvl, pt))
    kw = dict(scale=D ** -0.5, unified=unified)
    if family == "mla":
        vc, kw["v_dim"] = None, Dv
    out = trag.ragged_paged_attention(q, kc, vc, cu, kvl, pt, **kw)
    want = trag.ragged_paged_attention_plain(q, kc, vc, cu, kvl, pt, **kw)
    short = trag.ragged_paged_attention_plain(q, kc, vc, cu, kvl - 1, pt,
                                              **kw)
    tol = 2e-2 if family == "gqa" else 3e-2
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert not torch.allclose(short.float(), want.float(), rtol=tol,
                              atol=tol)
    _counters_zero(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "deepseek"])
def test_spec_blocks_on_card_equal_the_cpu(cuda_device, family):
    """float32, the same weights: the fused spec engine on the card (spec
    blocks captured as CUDA graphs and replayed over other contexts and
    page tables, the verify rows through K1 / K1m) gives the greedy
    streams of the same engine on the CPU, whose blocks run uncaptured
    over the plain versions, and of the plain sync engine on the card;
    each spec block is one replay, drafts were proposed, and pages and
    split counters come back."""
    make = GRAPH_MAKERS[family]
    card = make(cuda_device, **SPEC_FUSED)
    cpu = make("cpu", params=_to_cpu(card.runner.params), **SPEC_FUSED)
    plain = make(cuda_device, params=card.runner.params)
    by_kind = card.runner.graphs.by_kind
    replays = {k: v["replays"] for k, v in by_kind.items()}
    got = _spec_serve(card)
    assert got == _spec_serve(cpu) == _spec_serve(plain)
    nblocks = card.runner.block_counts["block"]
    assert nblocks > 0 and card.scheduler.spec_stats["proposed"] > 0
    assert any(k[0] == "spec" for k in card.runner.graphs.keys)
    assert (by_kind["decode"]["replays"] - replays["decode"]
            + by_kind["spec"]["replays"] - replays["spec"]
            == card.step_counts["decode"] + nblocks)
    _drained(card)
    _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("family", ["dense", "deepseek"])
def test_spec_block_dispatch_makes_no_host_sync(cuda_device, family,
                                                temperature):
    """Under bench.py's full flags, once the workload's graphs exist (a
    first run), a spec block's dispatch raises nothing under
    ``set_sync_debug_mode("error")``: the ring, the drafts, the verify and
    the carried state stay on the card, for greedy and sampled rows."""
    llm = GRAPH_MAKERS[family](cuda_device, dtype="bfloat16", **SPEC_FULL)
    _spec_serve(llm, temperature)
    runner = llm.runner
    spec, calls = runner.step_spec_multi, []

    def strict(chain, prev=None):
        calls.append(chain)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return spec(chain, prev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    runner.step_spec_multi = strict
    _spec_serve(llm, temperature)
    assert calls
    _drained(llm)


@pytest.mark.cuda
def test_sampled_spec_blocks_reproducible_on_card(cuda_device):
    """Sampled rows through spec blocks: two engines of one seed give the
    same streams."""
    first = _tiny_engine(cuda_device, dtype="bfloat16", **SPEC_FULL)
    second = _tiny_engine(cuda_device, params=first.runner.params,
                          dtype="bfloat16", **SPEC_FULL)
    assert _spec_serve(first, 0.8) == _spec_serve(second, 0.8)
    assert sum(first.blocks.values()) > 0


@pytest.mark.cuda
def test_spec_headroom_covers_the_largest_key(cuda_device):
    """An engine under bench.py's full flags sized from the card's memory
    (its activation headroom counts the spec block at its largest key):
    warming every sequence bucket, the largest sampled spec block
    included, raises no out-of-memory, and the graph pools stay within
    the headroom."""
    import gllm_tpu_torch as gt
    mc = gt.ModelConfig(architecture="LlamaForCausalLM", vocab_size=32000,
                        hidden_size=256, num_layers=2, num_heads=8,
                        num_kv_heads=2, head_dim=32, intermediate_size=512,
                        max_position=1024)
    llm = gt.LLM(model_cfg=mc, device=cuda_device, config=gt.EngineConfig(
        dtype="bfloat16", load_format="dummy", max_model_len=1024,
        max_num_seqs=64, scheduler=gt.SchedulerConfig(max_decode_seqs=64),
        **SPEC_FULL))
    llm.runner.warmup()
    keys = [k for k in llm.runner.graphs.keys if k[0] == "spec"]
    assert {k[2] for k in keys} == {8, 16, 32, 64}
    assert llm.runner.graphs.pool_bytes() <= llm.runner.activation_headroom()
    assert _spec_serve(llm)


# ---- sampling completeness: the seeded-Gumbel kernel, seeded rows in the
# graphs, the eager extras step ------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows,V,group,stream", [
    (3, 1000, 0, -1), (33, 4097, 0, -1), (40, 128256, 0, -1),
    (8 * 5, 1000, 5, 1), (8 * 5, 1, 5, 0)])
def test_seeded_gumbel_kernel_matches_plain(cuda_device, rows, V, group,
                                            stream):
    """csrc/threefry.cu against ops/threefry.py's plain version: the bits
    equal, uniforms equal, Gumbel noise within one ulp of each of its two
    logs (chip_smoke.gumbel_ulp_bound), rows of seed -1 left as they
    were; the wrapper refuses what the kernel does not take."""
    import chip_smoke
    from gllm_tpu_torch.ops import threefry as tf
    from gllm_tpu_torch.ops.cuda.threefry import seeded_noise
    rng = np.random.default_rng(rows + V)
    n = rows // group if group else rows
    seed = torch.as_tensor(rng.integers(0, 2**31 - 1, n).astype(np.int32),
                           device=cuda_device)
    seed[::3] = -1
    step = torch.as_tensor(rng.integers(0, 5000, n).astype(np.int32),
                           device=cuda_device)
    outs = {}
    for mode, dtype in ((tf.BITS, torch.int32), (tf.UNIFORM, torch.float32),
                        (tf.GUMBEL, torch.float32)):
        for name, fn in (("kernel", seeded_noise),
                         ("plain", tf.seeded_noise_)):
            out = torch.full((rows, V), 5, dtype=dtype, device=cuda_device)
            outs[name, mode] = fn(out, seed, step, group, stream, mode)
    torch.cuda.synchronize()
    assert torch.equal(outs["kernel", tf.BITS], outs["plain", tf.BITS])
    assert torch.equal(outs["kernel", tf.UNIFORM],
                       outs["plain", tf.UNIFORM])
    idx = torch.arange(rows, device=cuda_device)
    live = seed[idx // group if group else idx] >= 0
    g_k, g_p = outs["kernel", tf.GUMBEL], outs["plain", tf.GUMBEL]
    assert (g_k[~live] == 5).all()
    bits = outs["plain", tf.BITS][live].long() & 0xFFFFFFFF
    err = (g_k[live].double() - g_p[live].double()).abs()
    assert (err <= chip_smoke.gumbel_ulp_bound(bits)).all()
    with pytest.raises(ValueError, match="writes"):
        seeded_noise(torch.zeros((rows, V), dtype=torch.float16,
                                 device=cuda_device), seed, step, group,
                     stream)
    with pytest.raises(ValueError, match="int32"):
        seeded_noise(g_k, seed.long(), step, group, stream)


def _seeded_serve(llm):
    """``_spec_workload``'s prompts as seeded sampled rows (temperature
    0.8, top-k 20), and one greedy row: their streams."""
    import gllm_tpu_torch as gt
    prompts, sps = _spec_workload()
    sps = [gt.SamplingParams(temperature=0.0 if i == 0 else 0.8, top_k=20,
                             seed=11 + i, max_tokens=sp.max_tokens,
                             ignore_eos=True) for i, sp in enumerate(sps)]
    return [o.output_token_ids for o in llm.generate(
        prompt_token_ids=prompts, sampling_params=sps)]


SEEDED_DISPATCH = {
    "step": (dict(pipelined_loop=True), "step_async_chained"),
    "block": (BLOCK_FLAGS["odf"], "step_multi"),
    "spec_block": (SPEC_FULL, "step_spec_multi")}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(SEEDED_DISPATCH))
def test_seeded_rows_ride_graphs_with_no_host_sync(cuda_device, kind):
    """Seeded sampled rows in chained single steps, blocks and spec
    blocks: once the workload's graphs exist (a first run), a dispatch
    raises nothing under ``set_sync_debug_mode("error")`` (the seeds and
    output indices are read on the card), the streams repeat, the
    seeded-Gumbel kernel ran in the replays, and no graph was captured
    in the second run."""
    from gllm_tpu_torch.ops.cuda.threefry import seeded_noise
    flags, method = SEEDED_DISPATCH[kind]
    llm = _tiny_engine(cuda_device, dtype="bfloat16", **flags)
    first = _seeded_serve(llm)
    keys = set(llm.runner.graphs.keys)
    dispatch, calls = getattr(llm.runner, method), []

    def strict(batch, prev=None):
        calls.append(batch)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(batch, prev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    setattr(llm.runner, method, strict)
    launches = seeded_noise.launches["seeded_gumbel"]
    assert _seeded_serve(llm) == first
    assert calls
    assert seeded_noise.launches["seeded_gumbel"] > launches
    assert set(llm.runner.graphs.keys) == keys
    _drained(llm)


def _extras_workload():
    """Requests with every sampling extra: penalties, logit_bias,
    logprobs and prompt logprobs, seeded sampled rows."""
    import gllm_tpu_torch as gt
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, 1000, int(n)).tolist()
               for n in rng.integers(5, 60, 6)]
    kinds = [dict(temperature=0.0, presence_penalty=0.5,
                  frequency_penalty=0.3, repetition_penalty=1.2),
             dict(temperature=0.0, logit_bias={17: 8.0, 33: -100.0}),
             dict(temperature=0.0, logprobs=3, prompt_logprobs=2),
             dict(temperature=0.8, top_p=0.9, seed=5, logprobs=2),
             dict(temperature=0.0),
             dict(temperature=0.7, seed=9, repetition_penalty=1.1)]
    return prompts, [gt.SamplingParams(max_tokens=16, ignore_eos=True, **k)
                     for k in kinds]


@pytest.mark.cuda
def test_eager_extras_step_on_card_matches_cpu(cuda_device):
    """The same float32 weights on the card and on the CPU, the extras
    workload: equal streams, logprobs and prompt logprobs within 1e-4,
    and extras steps counted (replayed on their extras keys since the
    extras steps are captured)."""
    card = _tiny_engine(cuda_device)
    cpu_params = {"layers": {k: v.cpu() for k, v in
                             card.runner.params["layers"].items()},
                  **{k: v.cpu() for k, v in card.runner.params.items()
                     if k != "layers"}}
    cpu = _tiny_engine("cpu", params=cpu_params)
    prompts, sps = _extras_workload()
    got = card.generate(prompt_token_ids=prompts, sampling_params=sps)
    want = cpu.generate(prompt_token_ids=prompts, sampling_params=sps)
    for g, w in zip(got, want):
        assert g.output_token_ids == w.output_token_ids
        for a, b in ((g.logprobs, w.logprobs),
                     (g.prompt_logprobs, w.prompt_logprobs)):
            assert (a is None) == (b is None)
            for x, y in zip(a or [], b or []):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x[1] == y[1]
                    np.testing.assert_allclose([x[0], *x[2]], [y[0], *y[2]],
                                               rtol=0, atol=1e-4)
    assert card.step_counts["extras"] > 0
    _drained(card)


@pytest.mark.cuda
def test_prompt_logprobs_of_a_2048_chunk_fit_the_headroom(cuda_device):
    """A 2048-token prompt chunk with prompt logprobs at Llama-3's
    vocabulary (V 128256): its [T, V] float32 logits (1 GB) are computed
    in row slices, so the step's peak memory beyond the resident pools
    stays within the activation headroom."""
    import gllm_tpu_torch as gt
    mc = gt.ModelConfig(architecture="LlamaForCausalLM", vocab_size=128256,
                        hidden_size=256, num_layers=2, num_heads=8,
                        num_kv_heads=2, head_dim=32, intermediate_size=512,
                        max_position=4096)
    llm = gt.LLM(model_cfg=mc, device=cuda_device, config=gt.EngineConfig(
        dtype="bfloat16", load_format="dummy", max_model_len=4096,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=2048),
        cache=gt.CacheConfig(page_size=16, num_pages=300)))
    prompt = np.random.default_rng(2).integers(1, 128256, 2048).tolist()
    sp = gt.SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True,
                           prompt_logprobs=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    out, = llm.generate(prompt_token_ids=[prompt], sampling_params=sp)
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert peak <= llm.runner.activation_headroom(), peak
    assert len(out.prompt_logprobs) == 2048
    assert out.prompt_logprobs[0] is None
    assert all(e[0] <= 0 for e in out.prompt_logprobs[1:])
    _drained(llm)


# ---- extras steps as CUDA graphs (A 2b) -------------------------------------

def _extras_serve(llm):
    """``_spec_workload``'s prompts (prompt lookup drafts from them) with
    every extra: penalties, logit_bias, logprobs and prompt logprobs on
    greedy and seeded sampled rows (top-p, top-k), one plain greedy row:
    each request's (tokens, logprobs, prompt logprobs)."""
    import gllm_tpu_torch as gt
    prompts, sps = _spec_workload()
    kinds = [dict(temperature=0.0, presence_penalty=0.5,
                  frequency_penalty=0.3, repetition_penalty=1.2, logprobs=2),
             dict(temperature=0.0, logit_bias={17: 8.0, 33: -100.0},
                  logprobs=3, prompt_logprobs=2),
             dict(temperature=0.8, top_p=0.9, seed=5, logprobs=2),
             dict(temperature=0.8, top_k=20, seed=9, repetition_penalty=1.1,
                  prompt_logprobs=1),
             dict(temperature=0.0),
             dict(temperature=0.7, top_p=0.95, seed=3, logprobs=0)]
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=[
        gt.SamplingParams(max_tokens=sp.max_tokens, ignore_eos=True, **k)
        for sp, k in zip(sps, kinds)])
    return [(o.output_token_ids, o.logprobs, o.prompt_logprobs)
            for o in outs]


EXTRAS_KINDS = ("decode_extras", "mixed_extras", "verify_extras")
# MIXED_CASES under host-driven speculation, and the dense bf16 model
# without it (its pure-decode steps)
EXTRAS_CASES = [(f, c, True) for f, c in MIXED_CASES] + [("dense", {}, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("family,cfg,spec", EXTRAS_CASES,
                         ids=[f + "".join(f"-{v}" for v in c.values())
                              + ("" if spec else "-nospec")
                              for f, c, spec in EXTRAS_CASES])
def test_extras_replays_equal_the_eager_step(cuda_device, monkeypatch,
                                             family, cfg, spec):
    """bf16, the same weights, every extra, the mask's fast path on (its
    bound shrunk below the vocabulary, so that its IF nodes run, nested in
    none): the extras decode, mixed and verify steps replay their keys and
    give the tokens, logprobs and prompt logprobs of the same batches run
    eagerly (an ``enforce_eager`` engine on the same traffic) bit for bit;
    once the keys exist (a first run), the second run's dispatches raise
    nothing under sync-debug mode "error" and capture nothing."""
    from gllm_tpu_torch.ops import sampling
    monkeypatch.setattr(sampling, "TOPK_FAST_BOUND", 64)
    make = GRAPH_MAKERS[family]
    flags = dict(cfg, **(dict(spec_decode="ngram") if spec else {}))
    eager = make(cuda_device, dtype="bfloat16", enforce_eager=True, **flags)
    graph = make(cuda_device, params=eager.runner.params, dtype="bfloat16",
                 **flags)
    want = _extras_serve(eager)
    assert _extras_serve(graph) == want          # the keys captured here
    runner = graph.runner
    keys = set(runner.graphs.keys)
    by_kind = runner.graphs.by_kind
    replays = {k: v["replays"] for k, v in by_kind.items()}
    steps = dict(graph.step_counts)
    _strict_steps(runner)
    assert _extras_serve(graph) == want
    assert set(runner.graphs.keys) == keys
    done = {k: by_kind[k]["replays"] - replays[k] for k in by_kind}
    assert done["decode_extras"] == graph.step_counts["extras"] - \
        steps["extras"]
    assert done["mixed_extras"] + done["verify_extras"] + done["mixed"] + \
        done["verify"] == graph.step_counts["mixed"] - steps["mixed"]
    assert done["mixed_extras"] > 0
    assert done["verify_extras"] > 0 if spec else done["decode_extras"] > 0
    assert sum(runner.eager_mixed.values()) == 0
    _drained(graph)
    _counters_zero(cuda_device)


@pytest.mark.cuda
def test_hybrid_extras_decode_steps_replay(cuda_device):
    """The hybrid model with every extra (no speculation: it raises
    there): its pure-decode extras steps replay their keys, its mixed
    steps run eagerly ("hybrid"), and the streams and logprobs equal an
    ``enforce_eager`` engine's bit for bit."""
    import gllm_tpu_torch as gt
    eager = _hybrid_engine(cuda_device, dtype="bfloat16", enforce_eager=True)
    graph = _hybrid_engine(cuda_device, params=eager.runner.params,
                           dtype="bfloat16")
    prompts, sps = _extras_workload()
    sps = [gt.SamplingParams(**dict(
        vars(sp), max_tokens=12)) for sp in sps]
    outs = [[(o.output_token_ids, o.logprobs, o.prompt_logprobs)
             for o in e.generate(prompt_token_ids=prompts,
                                 sampling_params=sps)]
            for e in (eager, graph)]
    assert outs[0] == outs[1]
    by = graph.runner.graphs.by_kind
    assert by["decode_extras"]["replays"] == graph.step_counts["extras"] > 0
    assert graph.runner.eager_mixed["hybrid"] == graph.step_counts["mixed"]
    assert by["mixed_extras"]["replays"] == 0
    _drained(graph)


@pytest.mark.cuda
def test_extras_keys_pool_within_the_reckoning(cuda_device):
    """Llama-3.2-1B's widths at two layers, the default 256 sequences:
    after ``warmup``, the extras keys at the largest sequence bucket (a
    decode step with every adjustment and logprobs, greedy and sampled)
    and a mixed step with prompt logprobs grow the graphs' pools by no
    more than ``extras_pool_bytes`` reckons, and all the pools stay
    within the headroom's graph part."""
    import gllm_tpu_torch as gt
    from gllm_tpu_torch.runner.runner import ACTIVATION_HEADROOM
    mc = gt.ModelConfig(architecture="LlamaForCausalLM", vocab_size=128256,
                        hidden_size=2048, num_layers=2, num_heads=32,
                        num_kv_heads=8, head_dim=64, intermediate_size=8192,
                        max_position=4096, tie_word_embeddings=True)
    llm = gt.LLM(model_cfg=mc, device=cuda_device, config=gt.EngineConfig(
        dtype="bfloat16", load_format="dummy", max_model_len=4096,
        cache=gt.CacheConfig(num_pages=2048)))
    runner = llm.runner
    g = runner.graphs
    runner.warmup()
    before = g.pool_bytes()
    extras = dict(repetition_penalty=1.2, presence_penalty=0.3,
                  logit_bias={5: 1.0}, logprobs=5)
    runner._warming = True                 # throwaway rows, as warmup's
    pages = runner.builder.max_pages_per_seq
    for temp in (0.0, 1.0):
        runner._warm_step(runner.builder.max_seqs, pages, temp, **extras)
    runner._warm_mixed(8, pages, 1.0, prompt_logprobs=2, **extras)
    runner._warming = False
    assert sum(g.by_kind[k]["captured"] for k in EXTRAS_KINDS) == 3
    grown = g.pool_bytes() - before
    assert grown <= runner.extras_pool_bytes(), (grown, before)
    assert (g.pool_bytes()
            <= runner.activation_headroom() - ACTIVATION_HEADROOM)


@pytest.mark.cuda
@pytest.mark.parametrize("nested", [False, True], ids=["top", "in_if_node"])
def test_fast_path_conditional_node_takes_each_branch(cuda_device, nested):
    """The sampled mask at Llama-3's vocabulary (V 128256 against the
    4096 bound) captured once, its branch two IF nodes over the flag
    "every row proved" (nested in a block's IF node, ``in_if_node``):
    replayed over a small nucleus (the bounded top-k branch) and over a
    wide one (top-p 0.999 over near-uniform logits: the full sort), it
    gives the sort form's mask each time; the host's certificate says
    which branch each input needs."""
    from gllm_tpu_torch.ops import sampling
    from gllm_tpu_torch.runner import graphs
    S, V = 8, 128256
    g = graphs.DecodeGraphs(cuda_device, torch.Generator(device=cuda_device),
                            0)
    logits = torch.empty((S, V), device=cuda_device)
    top_k = torch.empty(S, dtype=torch.int32, device=cuda_device)
    top_p = torch.empty(S, device=cuda_device)
    min_p = torch.empty(S, device=cuda_device)
    live = torch.ones((), dtype=torch.bool, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)

    def stage(wide):
        if wide:
            logits.copy_(torch.randn((S, V), generator=gen,
                                     device=cuda_device) * 0.01)
            top_k.fill_(-1)
            top_p.fill_(0.999)
            min_p.fill_(0.0)
        else:
            # five peaks a row (25 down to 21: masses .636, .234, .086,
            # .032, .012) over N(0, 3^2): every top-p and min-p cutoff
            # below falls between peaks, far from the certificate's margin
            x = torch.randn((S, V), generator=gen, device=cuda_device) * 3
            rows = torch.arange(S, device=cuda_device)[:, None]
            idx = (rows * 131 + torch.arange(5, device=cuda_device) * 20011
                   ) % V
            x.scatter_(1, idx, torch.arange(25.0, 20.0, -1.0,
                                            device=cuda_device).expand(S, 5))
            logits.copy_(x)
            top_k.copy_(torch.tensor([-1, 1, 3, 50, -1, 4000, 7, -1]))
            top_p.copy_(torch.tensor([0.9, 1.0, 0.5, 0.8, 0.2, 1.0, 0.95,
                                      0.6]))
            min_p.copy_(torch.tensor([0.0, 0.0, 0.1, 0.0, 0.3, 0.0, 0.0,
                                      0.2]))

    def mask():
        return sampling.topk_topp_mask(logits, top_k, top_p, min_p,
                                       select=g.select)

    def body(generator, graph=None):
        if not nested:
            return mask()
        out = torch.zeros_like(logits)
        if graph is None:
            with g.on_body_stream():
                out.copy_(mask())
        else:
            with g.if_node(live):
                out.copy_(mask())
        return out

    stage(False)
    g.capture((S, V), body, sampled=False)
    for wide in (False, True, False):
        stage(wide)
        taken = []
        sampling.topk_topp_mask(
            logits, top_k, top_p, min_p,
            select=lambda f, a, b: (taken.append(bool(f)), a())[1])
        assert taken == [not wide]
        got = g.run((S, V), body)
        want = sampling.topk_topp_mask_sort(logits, top_k, top_p, min_p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), wide
        if wide:
            assert int(torch.isfinite(want).sum(-1).max()) > 4096


# ---- tracing and step attribution -----------------------------------------

TRACED = {"decode": dict(), "block": BLOCK_FLAGS["odf"], "extras": dict()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(TRACED))
def test_traced_steps_make_no_host_sync(cuda_device, kind):
    """With tracing on, once the workload's graphs are captured (a first
    run), the dispatch side (``_note_kv_read``, ``_note_dispatch``,
    ``last_phases`` inside the runner call) and the collect side
    (``LLM._record_step``: the step event, its phases, device wall, MFU
    and HBM estimates, the spans) of a decode step, a block under
    on-device finish and an extras step raise nothing under
    ``set_sync_debug_mode("error")``; every step event carries ``ph``,
    ``dev_ms`` and ``mfu`` (the card's peak from its name), and every
    request's span tree closes."""
    from gllm_tpu_torch.obs.steptrace import TRACE
    llm = _tiny_engine(cuda_device, dtype="bfloat16", **TRACED[kind])
    assert llm.tracing and llm._peak_flops > 0, torch.cuda.get_device_name()
    if kind == "extras":
        prompts, sps = _extras_workload()

        def serve():
            llm.generate(prompt_token_ids=prompts, sampling_params=sps)
    else:
        def serve():
            _serve_greedy(llm)
    serve()
    runner, calls = llm.runner, []

    def strict(fn):
        def wrapped(*a, **kw):
            calls.append(fn.__name__)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return wrapped
    runner.step_async = strict(runner.step_async)
    runner.step_multi = strict(runner.step_multi)
    llm._record_step = strict(llm._record_step)
    mark = TRACE.mark()
    serve()
    steps = [e for e in TRACE.events(since=mark)
             if e["kind"] in ("prefill", "decode", "fused_block")]
    assert "_record_step" in calls and steps
    assert all({"ph", "dev_ms", "mfu"} <= set(e) for e in steps)
    if kind == "block":
        assert any(e["kind"] == "fused_block" for e in steps)
    if kind == "extras":
        assert llm.step_counts["extras"] > 0
    assert llm.spans.open_count == 0 and llm.spans.spans()
    _drained(llm)
