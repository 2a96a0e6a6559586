"""Paged KV cache write path (counterpart of ``gllm_tpu/ops/kv_cache.py``:
``write_kv:25``, ``_quant_write_one:49``, ``write_kv_quant:90``, and the
latent scatter of ``gllm_tpu/models/deepseek.py:346-356``).

Layout: [num_pages, page_size, num_kv_heads, head_dim] per K/V, or one
[num_pages, page_size, width] latent cache (MLA); flat slot = page_id *
page_size + offset. Slots of page 0 (the dummy page) absorb the writes of
padded tokens. A full-precision or fp8 cache is written with one cast
(``to_cache``), as the JAX package's ``astype``.
"""

from __future__ import annotations

import torch

# int8 KV quantization grid: symmetric, scale = absmax / QMAX, dequant
# x' = q * scale. -128 is never produced (clip to ±127), so the grid is
# symmetric and the rescale-on-grow pass cannot overflow.
QMAX = 127.0

FP8 = torch.float8_e4m3fn
# e4m3's largest finite value is 448; |x| above 464 (the midpoint to the
# next step, 480, which e4m3 lacks) is NaN under the JAX package's
# ``astype`` (ml_dtypes), while torch's cast saturates to ±448
FP8_NAN_ABOVE = 464.0


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a cache's dtype as the JAX package casts it. For fp8
    the result is the bytes as ``torch.uint8`` (``index_copy_`` takes no
    fp8 on the CPU): straight from x's own dtype (a float32 model's keys
    round once), with |x| > 464 made NaN before the cast (its sign bit may
    differ from JAX's NaN; every reader widens it to NaN). No host sync."""
    if dtype != FP8:
        return x.to(dtype)
    x = x.masked_fill(x.abs() > FP8_NAN_ABOVE, float("nan"))
    return x.to(FP8).view(torch.uint8)


def _scatter(flat: torch.Tensor, idx: torch.Tensor,
             rows: torch.Tensor) -> None:
    """``flat.index_copy_(0, idx, rows)`` with ``rows`` cast by
    ``to_cache``; an fp8 cache is written through its bytes."""
    rows = to_cache(rows, flat.dtype)
    if flat.dtype == FP8:
        flat = flat.view(torch.uint8)
    flat.index_copy_(0, idx, rows)


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
    _scatter(k_cache.view(num_pages * page_size, hkv, d), idx, k)
    _scatter(v_cache.view(num_pages * page_size, hkv, d), idx, v)


def _quant_write_one(cache, scale, rows, slots, pages) -> None:
    """Quantized scatter of one stream (K or V), in place.

    cache [P, page, H, D] int8; scale [P, H] float32 (a stored q
    dequantizes to q * scale); rows [T, H, D] float32.

    The per-page, per-head scale is a RUNNING absmax: it only grows. When a
    write grows a page's scale, the rows already stored in that page were
    quantized against the smaller scale, so the touched pages are
    re-quantized (gather, scale by old/new, round, scatter) before the new
    rows land. The JAX version skips that pass with a ``lax.cond`` when no
    scale grew; deciding that here would cost a host sync per layer, so the
    touched pages are always re-quantized: a ratio of 1 re-rounds each
    stored integer to itself, so the result is the same. Duplicate page ids
    gather and scatter identical values. A never-written (or freshly
    reset) page has scale 0 and rescales by ratio 0 on its first write,
    which zero-fills its stale slots.
    """
    num_pages, ps, h, d = cache.shape
    amax = rows.abs().amax(dim=-1) / QMAX                     # [T, H]
    old = scale[pages]                                        # [T, H]
    scale.scatter_reduce_(0, pages[:, None].expand(-1, h), amax, "amax")
    new = scale[pages]                                        # [T, H]
    ratio = torch.where(new > 0.0, old / torch.clamp(new, min=1e-30),
                        torch.zeros_like(new))
    blk = cache[pages].float()                                # [T, ps, H, D]
    cache[pages] = torch.round(blk * ratio[:, None, :, None]).to(cache.dtype)
    q = torch.round(rows / torch.clamp(new, min=1e-30)[:, :, None])
    q = torch.clamp(q, -QMAX, QMAX).to(cache.dtype)
    cache.view(num_pages * ps, h, d).index_copy_(0, slots, q)


def write_kv_quant(k_cache, v_cache, k_scale, v_scale, k: torch.Tensor,
                   v: torch.Tensor, slot_mapping: torch.Tensor) -> None:
    """Quantizing scatter into an int8 paged cache (kv_cache_dtype="int8"),
    IN PLACE, with no host sync.

    k_cache/v_cache: [num_pages, page_size, Hkv, D] int8 (contiguous)
    k_scale/v_scale: [num_pages, Hkv] float32 running per-page scales
    k/v:             [T, Hkv, D] this step's rows (any float dtype)
    slot_mapping:    [T] int flat slots (padding → dummy-page slots)

    Attention dequantizes on its read path (in the kernels, or on the
    gathered pages in the plain versions); a full-precision cache never
    exists in device memory.
    """
    slots = slot_mapping.long()
    pages = torch.div(slots, k_cache.shape[1], rounding_mode="floor")
    _quant_write_one(k_cache, k_scale, k.float(), slots, pages)
    _quant_write_one(v_cache, v_scale, v.float(), slots, pages)


def write_latent(latent: torch.Tensor, rows: torch.Tensor,
                 slot_mapping: torch.Tensor) -> None:
    """Scatter this step's MLA latent rows ``[c_kv | k_pe]`` into the paged
    latent cache IN PLACE.

    latent:       [num_pages, page_size, width] (contiguous; the model
                  passes the flat [L*P, page, width] view of every layer)
    rows:         [T, width]
    slot_mapping: [T] int flat slots, the layer's offset included (padding
                  → dummy-page slots, where duplicates keep an arbitrary
                  row, as in ``write_kv``)
    """
    num_pages, page_size, width = latent.shape
    _scatter(latent.view(num_pages * page_size, width), slot_mapping.long(),
             rows)
