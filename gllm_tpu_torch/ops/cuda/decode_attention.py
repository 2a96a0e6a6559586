"""Paged decode attention: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``gllm_tpu/ops/pallas/decode_attention.py::paged_decode_attention``
(GQA) over a full-precision cache (K2) or an int8 cache with per-page,
per-kv-head float32 scales (K2q), and, with ``v_cache=None``, over an MLA
latent cache whose values are the keys' leading ``v_dim`` lanes (K2m,
``csrc/mla_decode_attention.cu``: tensor cores, one latent tile read once
for both products; see ``csrc/mla_attention.cuh``). The GQA kernel
(``csrc/decode_attention.cu``)
is bound by bytes: it runs one block per (sequence, kv head, split of the
context), so every K/V row of a sequence's context is read from device
memory once and shared by the G query heads of its group, and a long
context at a small batch still fills the card; a second pass merges the
splits. Head dims 32, 64 and 128, and 256 over a full-precision or an fp8
cache (Qwen3-Next's gated attention). An int8 tile is dequantized as it is
loaded, so the cache moves half the bytes; an fp8 (e4m3) cache or latent
likewise, widened exactly (no scales). The TPU kernel's round-robin DMA
grouping is a TPU fetch schedule and does not carry over.

``paged_decode_attention`` launches the kernel for CUDA tensors and takes
the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import functools

import torch

from gllm_tpu_torch.ops.cuda import build
from gllm_tpu_torch.ops.cuda.common import (cache_code, cache_suffix,
                                            check_inputs,
                                            check_latent_inputs, data_ptr,
                                            gather_pages)
from gllm_tpu_torch.utils import cdiv

MAX_KEYS_PER_SPLIT = 256
MIN_BLOCKS_PER_SM = 4
# the MLA decode blocks are 4 warps with 95 KB of shared memory, two per SM
MLA_BLOCKS_PER_SM = 2
MAX_GROUP = 16          # query heads per kv head (a warp each in a block)


def keys_per_split(S: int, Hkv: int, max_keys: int, num_sms: int,
                   blocks_per_sm: int = MIN_BLOCKS_PER_SM) -> int:
    """The largest of 256, 128, 64 and 32 keys per split whose grid still
    has ``blocks_per_sm`` blocks per SM. Splits cover the padded page
    table (``max_keys``), so the choice needs no host sync; splits past a
    row's kv_len exit at once."""
    keys = MAX_KEYS_PER_SPLIT
    while (keys > 32
           and S * Hkv * cdiv(max_keys, keys) < blocks_per_sm * num_sms):
        keys //= 2
    return keys


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(q, k_cache, page_table, v_dim=None,
               blocks_per_sm=MIN_BLOCKS_PER_SM):
    """(keys per split, number of splits, float32 scratch of the splits'
    partial sums or None) for the decode kernel's grid over
    ``page_table``'s rows, with no host sync. ``v_dim``: the output width
    where it differs from q's (MLA)."""
    S, Hq = page_table.shape[0], q.shape[1]
    D = v_dim or q.shape[2]
    _, page, Hkv, _ = k_cache.shape
    max_keys = page_table.shape[1] * page
    chunk = keys_per_split(S, Hkv, max_keys, _num_sms(q.device),
                           blocks_per_sm)
    num_splits = max(1, cdiv(max_keys, chunk))
    part = (torch.empty(S * Hq * num_splits * (D + 2), dtype=torch.float32,
                        device=q.device) if num_splits > 1 else None)
    return chunk, num_splits, part


def paged_decode_attention_plain(q, k_cache, v_cache, kv_lens, page_table,
                                 *, scale: float, page_offset: int = 0,
                                 k_scale=None, v_scale=None, v_dim=None):
    """One query row per sequence over its paged context, in float32.

    q [S, Hq, D]; k_cache/v_cache [P, page, Hkv, D]; kv_lens [S];
    page_table [S, max_pages] (ids are offset by ``page_offset``). An int8
    cache comes with ``k_scale``/``v_scale`` [P, Hkv] float32 and is
    dequantized on the gathered pages (``_xla_paged_attention``'s rule);
    an fp8 cache is widened.
    ``v_cache`` None: a shared latent cache (MLA), whose values are the
    keys' leading ``v_dim`` lanes. Rows with kv_len 0 give zeros. Returns
    [S, Hq, Dv] in q's dtype (Dv = D, or ``v_dim``)."""
    paged_decode_attention_plain.calls += 1
    S, Hq, D = q.shape
    _, page, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    max_kv = page_table.shape[1] * page
    pages = page_table.long() + page_offset
    k = gather_pages(k_cache, k_scale, pages).reshape(S, max_kv, Hkv, D)
    v = (k[..., :v_dim] if v_cache is None else
         gather_pages(v_cache, v_scale, pages).reshape(S, max_kv, Hkv, D))
    qg = q.reshape(S, Hkv, G, D).float()
    scores = torch.einsum("shgd,skhd->shgk", qg, k) * scale
    visible = (torch.arange(max_kv, device=q.device)[None, :]
               < kv_lens.long()[:, None])                      # [S, K]
    mask = visible[:, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).masked_fill(~mask, 0.0)
    out = torch.einsum("shgk,skhd->shgd", probs, v)
    return out.reshape(S, Hq, v.shape[-1]).to(q.dtype)


paged_decode_attention_plain.calls = 0


def paged_decode_attention(q, k_cache, v_cache, kv_lens, page_table, *,
                           scale: float, page_offset: int = 0,
                           k_scale=None, v_scale=None, v_dim=None):
    """Same contract as :func:`paged_decode_attention_plain`."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, kv_lens, page_table, scale=scale,
            page_offset=page_offset, k_scale=k_scale, v_scale=v_scale,
            v_dim=v_dim)
    if v_cache is None:
        return _mla_decode(q, k_cache, kv_lens, page_table, scale=scale,
                           page_offset=page_offset, v_dim=v_dim,
                           k_scale=k_scale)
    S, Hq, D = q.shape
    check_inputs("paged_decode_attention", q, k_cache, v_cache,
                 (kv_lens, page_table), max_group=MAX_GROUP, k_scale=k_scale,
                 v_scale=v_scale, wide=True)
    if kv_lens.shape != (S,) or page_table.shape[0] != S:
        raise ValueError("paged_decode_attention: kv_lens [S] and "
                         "page_table [S, max_pages] must match q [S, Hq, D]")
    out = torch.empty_like(q)
    if S == 0:
        return out
    chunk, num_splits, part = split_plan(q, k_cache, page_table)
    rc = build.kernel("decode_attention")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        data_ptr(k_scale), data_ptr(v_scale), kv_lens.data_ptr(),
        page_table.data_ptr(), out.data_ptr(), data_ptr(part), S,
        page_table.shape[1], Hq, k_cache.shape[2], D, k_cache.shape[1],
        page_offset, chunk, num_splits, scale, build.DTYPE_CODES[q.dtype],
        cache_code(k_cache), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches[
        "paged_decode_attention" + cache_suffix(k_cache)] += 1
    return out


def _mla_decode(q, latent, kv_lens, page_table, *, scale, page_offset,
                v_dim, k_scale):
    """K2m: the MLA decode kernel over a latent cache [P, page, 1, Dl]."""
    if k_scale is not None:
        raise NotImplementedError("paged_decode_attention: an int8 MLA "
                                  "latent cache is not supported")
    check_latent_inputs("paged_decode_attention", q, latent, v_dim,
                        (kv_lens, page_table))
    S, Hq, Dl = q.shape
    if kv_lens.shape != (S,) or page_table.shape[0] != S:
        raise ValueError("paged_decode_attention: kv_lens [S] and "
                         "page_table [S, max_pages] must match q [S, Hq, D]")
    out = torch.empty((S, Hq, v_dim), dtype=q.dtype, device=q.device)
    if S == 0:
        return out
    chunk, num_splits, part = split_plan(q, latent, page_table, v_dim,
                                         MLA_BLOCKS_PER_SM)
    rc = build.kernel("mla_decode_attention")(
        q.data_ptr(), latent.data_ptr(), kv_lens.data_ptr(),
        page_table.data_ptr(), out.data_ptr(), data_ptr(part), S,
        page_table.shape[1], Dl, v_dim, latent.shape[1], page_offset, chunk,
        num_splits, scale, build.DTYPE_CODES[q.dtype], cache_code(latent),
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches[
        "paged_decode_attention_mla" + cache_suffix(latent)] += 1
    return out


# launches by kernel: K2 over a full-precision, int8 (K2q) or fp8 cache,
# and K2m over a latent cache in q's dtype or in fp8
paged_decode_attention.launches = dict.fromkeys(
    ["paged_decode_attention" + c for c in ("", "_int8", "_fp8")]
    + ["paged_decode_attention_mla" + c for c in ("", "_fp8")], 0)
