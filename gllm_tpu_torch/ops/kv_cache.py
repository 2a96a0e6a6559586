"""Paged KV cache write path (counterpart of ``gllm_tpu/ops/kv_cache.py:25``).

Layout: [num_pages, page_size, num_kv_heads, head_dim] per K/V; flat slot =
page_id * page_size + offset. Slots of page 0 (the dummy page) absorb the
writes of padded tokens.
"""

from __future__ import annotations

import torch


def write_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
             k: torch.Tensor, v: torch.Tensor,
             slot_mapping: torch.Tensor) -> None:
    """Scatter this step's K/V rows into the paged cache IN PLACE.

    The JAX version returns new arrays and relies on buffer donation to
    make the scatter in-place; here the cache tensors are updated directly.

    k_cache/v_cache: [num_pages, page_size, Hkv, D] (contiguous)
    k/v:             [T, Hkv, D]
    slot_mapping:    [T] int flat slots (padding → dummy-page slots)

    Padding tokens all map to dummy-page slots, so the index can hold
    duplicates; on CUDA ``index_copy_`` then keeps an arbitrary one of the
    duplicate rows. Only the dummy page is affected, and no sequence reads
    it.
    """
    num_pages, page_size, hkv, d = k_cache.shape
    idx = slot_mapping.long()
    k_cache.view(num_pages * page_size, hkv, d).index_copy_(
        0, idx, k.to(k_cache.dtype))
    v_cache.view(num_pages * page_size, hkv, d).index_copy_(
        0, idx, v.to(v_cache.dtype))
