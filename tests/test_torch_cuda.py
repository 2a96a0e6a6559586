"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
from gllm_tpu_torch.ops.cuda import ragged_attention as trag


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", RAGGED_CASES + [
    dict(seqs=[(40, 40), (1, 70), (17, 90)], Hq=8, Hkv=8, D=64, page=16,
         pages=16),
    dict(seqs=[(9, 33), (1, 5)], pad_tokens=7, Hq=16, Hkv=2, D=128,
         page=8, pages=12),
    MAIN_PATH_RAGGED])
def test_ragged_kernel_matches_plain(cuda_device, case, dtype):
    rng = np.random.default_rng(3)
    q, kc, vc, cu, kvl, pt = ragged_case(
        rng, case["seqs"], case["Hq"], case["Hkv"], case["D"],
        case["page"], case["pages"], case.get("pad_seqs", 0),
        case.get("pad_tokens", 0))
    if case["D"] not in (32, 64, 128):
        pytest.skip("kernel head dims are 32, 64 and 128")
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
    n0 = trag.ragged_paged_attention.launches
    got = trag.ragged_paged_attention(*dev, scale=0.125, page_offset=P)
    assert trag.ragged_paged_attention.launches == n0 + 1
    want = trag.ragged_paged_attention_plain(
        *[torch.from_numpy(a) for a in (q, kc, vc, cu, kvl, pt)],
        scale=0.125)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

    q, kc, vc, kvl, pt = decode_case(rng, [700, 0, 9], 8, 2, 64, 4, 200)
    k_all = np.concatenate([np.zeros_like(kc), kc])
    v_all = np.concatenate([np.zeros_like(vc), vc])
    n0 = tdec.paged_decode_attention.launches
    got = tdec.paged_decode_attention(
        *[torch.from_numpy(a).to(cuda_device)
          for a in (q, k_all, v_all, kvl, pt)], scale=0.125, page_offset=200)
    assert tdec.paged_decode_attention.launches == n0 + 1
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


def _tiny_engine(device, params=None, **cfg):
    import gllm_tpu_torch as gt
    mc = gt.ModelConfig(architecture="LlamaForCausalLM", vocab_size=1000,
                        hidden_size=256, num_layers=2, num_heads=8,
                        num_kv_heads=2, head_dim=32, intermediate_size=512,
                        max_position=512, rope_theta=500000.0)
    ec = gt.EngineConfig(
        dtype="float32", load_format="dummy", max_model_len=512,
        scheduler=gt.SchedulerConfig(max_prefill_tokens=48),
        cache=gt.CacheConfig(page_size=16, num_pages=64), **cfg)
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
    r0, d0 = (trag.ragged_paged_attention.launches,
              dec.paged_decode_attention.launches)
    got = [o.output_token_ids for o in card.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    want = [o.output_token_ids for o in cpu.generate(
        prompt_token_ids=prompts, sampling_params=sp)]
    assert got == want
    assert trag.ragged_paged_attention.launches > r0
    assert dec.paged_decode_attention.launches > d0
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
