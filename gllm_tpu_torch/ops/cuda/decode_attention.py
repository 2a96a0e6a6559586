"""Paged decode attention: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``gllm_tpu/ops/pallas/decode_attention.py::paged_decode_attention``
(full-precision cache, GQA). The kernel (``csrc/decode_attention.cu``) is
bound by bytes: it runs one block per (sequence, kv head, split of the
context), so every K/V row of a sequence's context is read from device
memory once and shared by the G query heads of its group, and a long
context at a small batch still fills the card; a second pass merges the
splits. The TPU kernel's round-robin DMA grouping is a TPU fetch
schedule and does not carry over.

``paged_decode_attention`` launches the kernel for CUDA tensors and takes
the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import functools

import torch

from gllm_tpu_torch.ops.cuda import build
from gllm_tpu_torch.ops.cuda.common import check_inputs
from gllm_tpu_torch.utils import cdiv

MAX_KEYS_PER_SPLIT = 256
MIN_BLOCKS_PER_SM = 4


def keys_per_split(S: int, Hkv: int, max_keys: int, num_sms: int) -> int:
    """The largest of 256, 128, 64 and 32 keys per split whose grid still
    has ``MIN_BLOCKS_PER_SM`` blocks per SM. Splits cover the padded page
    table (``max_keys``), so the choice needs no host sync; splits past a
    row's kv_len exit at once."""
    keys = MAX_KEYS_PER_SPLIT
    while (keys > 32
           and S * Hkv * cdiv(max_keys, keys) < MIN_BLOCKS_PER_SM * num_sms):
        keys //= 2
    return keys


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def paged_decode_attention_plain(q, k_cache, v_cache, kv_lens, page_table,
                                 *, scale: float, page_offset: int = 0):
    """One query row per sequence over its paged context, in float32.

    q [S, Hq, D]; k_cache/v_cache [P, page, Hkv, D]; kv_lens [S];
    page_table [S, max_pages] (ids are offset by ``page_offset``).
    Rows with kv_len 0 give zeros. Returns [S, Hq, D] in q's dtype."""
    paged_decode_attention_plain.calls += 1
    S, Hq, D = q.shape
    _, page, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    max_kv = page_table.shape[1] * page
    pages = page_table.long() + page_offset
    k = k_cache[pages].reshape(S, max_kv, Hkv, D).float()
    v = v_cache[pages].reshape(S, max_kv, Hkv, D).float()
    qg = q.reshape(S, Hkv, G, D).float()
    scores = torch.einsum("shgd,skhd->shgk", qg, k) * scale
    visible = (torch.arange(max_kv, device=q.device)[None, :]
               < kv_lens.long()[:, None])                      # [S, K]
    mask = visible[:, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).masked_fill(~mask, 0.0)
    out = torch.einsum("shgk,skhd->shgd", probs, v)
    return out.reshape(S, Hq, D).to(q.dtype)


paged_decode_attention_plain.calls = 0


def paged_decode_attention(q, k_cache, v_cache, kv_lens, page_table, *,
                           scale: float, page_offset: int = 0):
    """Same contract as :func:`paged_decode_attention_plain`."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, kv_lens, page_table, scale=scale,
            page_offset=page_offset)
    S, Hq, D = q.shape
    check_inputs("paged_decode_attention", q, k_cache, v_cache,
                 (kv_lens, page_table), max_group=16)
    if kv_lens.shape != (S,) or page_table.shape[0] != S:
        raise ValueError("paged_decode_attention: kv_lens [S] and "
                         "page_table [S, max_pages] must match q [S, Hq, D]")
    out = torch.empty_like(q)
    if S == 0:
        return out
    _, page, Hkv, _ = k_cache.shape
    max_pages = page_table.shape[1]
    chunk = keys_per_split(S, Hkv, max_pages * page, _num_sms(q.device))
    num_splits = max(1, cdiv(max_pages * page, chunk))
    part = (torch.empty(S * Hq * num_splits * (D + 2), dtype=torch.float32,
                        device=q.device) if num_splits > 1 else None)
    rc = build.kernel("decode_attention")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_lens.data_ptr(), page_table.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), S, max_pages, Hq, Hkv, D,
        page, page_offset, chunk, num_splits, scale,
        build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
