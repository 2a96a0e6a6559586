"""Argument checks and page gathers shared by the attention kernel
wrappers and their plain versions."""

from __future__ import annotations

import torch

from gllm_tpu_torch.ops.cuda.build import (CACHE_FP8, CACHE_INT8,
                                            CACHE_NATIVE, DTYPE_CODES)

FP8 = torch.float8_e4m3fn
HEAD_DIMS = (32, 64, 128)
# head dims of the non-unified K1 and K2 over a full-precision or an fp8
# cache only (Qwen3-Next's gated full-attention layers; csrc/paged_kv.cuh
# dispatch_dim)
WIDE_HEAD_DIMS = HEAD_DIMS + (256,)
# MLA kernels (csrc/mla_attention.cuh): 16 query heads over one latent
# stream, and the (latent row width, v_dim) geometries they are built for:
# DeepSeek V2/V3's (576, 512) and (96, 64) for small test models
MLA_HEADS = 16
MLA_GEOMETRIES = ((576, 512), (96, 64))
# GQA groups: the decode blocks (K2, and the decode class of K1 and K1u)
# take the group's query heads as the (padded) 16 rows of one MMA; the
# ragged blocks take floor(64 / G) tokens of G heads a warpgroup, any G
MAX_GROUP = 16
# K3's head dims (csrc/gdn_scan.cu)
GDN_DIMS = (32, 64, 128)


def cache_code(cache) -> int:
    """The kernels' cache code: ``cache`` holds q's dtype, int8 or fp8."""
    if cache.dtype == torch.int8:
        return CACHE_INT8
    return CACHE_FP8 if cache.dtype == FP8 else CACHE_NATIVE


def cache_suffix(cache) -> str:
    """The launch counters' suffix of a cache: "", "_int8" or "_fp8"."""
    return {CACHE_NATIVE: "", CACHE_INT8: "_int8",
            CACHE_FP8: "_fp8"}[cache_code(cache)]


def gather_pages(cache, scale, pages):
    """Pages of a paged cache as float32, [..., page, Hkv, D] for ``pages``
    [...]; an int8 cache is dequantized with its per-page, per-kv-head
    ``scale`` [P, Hkv] (``block_kv``'s rule: x * scale[page, h]), an fp8
    cache widened (exact)."""
    x = cache[pages].float()
    if scale is not None:
        x = x * scale[pages][..., None, :, None]
    return x


def check_mla_geometry(num_heads: int, latent_dim: int, v_dim: int) -> None:
    """Raise NotImplementedError, naming the value, on an MLA geometry the
    CUDA kernels are not built for."""
    if num_heads != MLA_HEADS:
        raise NotImplementedError(
            f"MLA kernels take {MLA_HEADS} query heads per latent stream, "
            f"got {num_heads}")
    if (latent_dim, v_dim) not in MLA_GEOMETRIES:
        raise NotImplementedError(
            f"MLA kernels take (latent width, v_dim) in {MLA_GEOMETRIES}, "
            f"got ({latent_dim}, {v_dim})")


def check_model_shapes(model_cfg, kv_cache_dtype: str = "auto",
                       unified: bool = False) -> None:
    """Raise NotImplementedError, naming the value, on a model whose
    attention or GDN shapes the CUDA kernels of its step refuse: the MLA
    geometry; a GQA group K1 and K2 (or K1u) do not both take; a head_dim
    outside the dims built for the cache and the step (256 only without
    the unified step and over a full-precision or fp8 cache); GDN head
    dims outside ``GDN_DIMS``. The runner calls it on a CUDA device before
    any weight is loaded or the KV pool is sized."""
    cfg = model_cfg
    if cfg.use_mla:
        check_mla_geometry(cfg.num_heads, cfg.mla_cache_width,
                           cfg.kv_lora_rank)
    elif cfg.num_attn_layers:
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        if hkv <= 0 or hq % hkv:
            raise NotImplementedError(
                f"attention kernels need num_heads a multiple of "
                f"num_kv_heads, got {hq} and {hkv}")
        group = hq // hkv
        if group > MAX_GROUP:
            raise NotImplementedError(
                f"attention kernels take a GQA group (num_heads / "
                f"num_kv_heads) of at most {MAX_GROUP}, got {group}")
        wide = not unified and kv_cache_dtype != "int8"
        dims = WIDE_HEAD_DIMS if wide else HEAD_DIMS
        if cfg.head_dim not in dims:
            raise NotImplementedError(
                f"attention kernels take head_dim in {dims} "
                f"(kv_cache_dtype={kv_cache_dtype!r}, unified_step="
                f"{unified}), got {cfg.head_dim}")
    if cfg.num_linear_layers:
        for name in ("linear_key_head_dim", "linear_value_head_dim"):
            d = getattr(cfg, name)
            if d not in GDN_DIMS:
                raise NotImplementedError(
                    f"the GDN chunk scan takes {name} in {GDN_DIMS}, got "
                    f"{d}")


def check_latent_inputs(what: str, q, latent, v_dim, index_tensors) -> None:
    """Raise on anything the MLA kernels do not take: q [T, 16, Dl] and a
    latent cache [P, page, 1, Dl] in q's dtype or in fp8, a supported
    (Dl, v_dim), int32 metadata, contiguous and 16-byte aligned on one CUDA
    device."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA or CPU tensors, got "
                         f"{q.device}")
    if any(t.device != q.device for t in (latent,) + tuple(index_tensors)):
        raise ValueError(f"{what}: all tensors must be on {q.device}")
    if q.dtype not in DTYPE_CODES or latent.dtype not in (q.dtype, FP8):
        raise ValueError(f"{what}: q must be one of {list(DTYPE_CODES)} and "
                         f"the latent cache in its dtype or in {FP8}, got "
                         f"{q.dtype}/{latent.dtype}")
    if any(t.dtype != torch.int32 for t in index_tensors):
        raise ValueError(f"{what}: metadata tensors must be int32")
    if (q.dim() != 3 or latent.dim() != 4 or latent.shape[2] != 1
            or latent.shape[3] != q.shape[2]):
        raise ValueError(f"{what}: expected q [T, Hq, Dl] and a latent cache "
                         "[P, page, 1, Dl]")
    check_mla_geometry(q.shape[1], q.shape[2], v_dim)
    if not all(t.is_contiguous() for t in (q, latent) + tuple(index_tensors)):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, latent)):
        raise ValueError(f"{what}: q and the cache must be 16-byte aligned")


def check_inputs(what: str, q, k_cache, v_cache, index_tensors,
                 max_group: int, k_scale=None, v_scale=None,
                 wide: bool = False) -> None:
    """Raise on anything the kernel does not take: device, dtype, shape,
    contiguity, alignment. An int8 cache needs both scales, float32
    [P, Hkv]; a full-precision cache (q's dtype) and an fp8 cache take
    none. ``wide``: the kernel also takes head dim 256 (not over an int8
    cache)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA or CPU tensors, got "
                         f"{q.device}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: give both k_scale and v_scale or "
                         "neither")
    scales = () if k_scale is None else (k_scale, v_scale)
    tensors = (q, k_cache, v_cache) + scales + tuple(index_tensors)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: all tensors must be on {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {q.dtype}")
    allowed = (torch.int8,) if scales else (q.dtype, FP8)
    if k_cache.dtype not in allowed or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"{what}: the caches' dtype must be one of "
                         f"{allowed} (q {q.dtype}, "
                         f"{'with' if scales else 'without'} scales), got "
                         f"{k_cache.dtype}/{v_cache.dtype}")
    if any(t.dtype != torch.int32 for t in index_tensors):
        raise ValueError(f"{what}: metadata tensors must be int32")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: expected q [T, Hq, D] and k/v caches "
                         "[P, page, Hkv, D] of one shape")
    _, hq, d = q.shape
    hkv = k_cache.shape[2]
    if any(s.dtype != torch.float32
           or s.shape != (k_cache.shape[0], hkv) for s in scales):
        raise ValueError(f"{what}: k_scale and v_scale must be float32 "
                         f"[P, Hkv] = {[k_cache.shape[0], hkv]}")
    dims = WIDE_HEAD_DIMS if wide and not scales else HEAD_DIMS
    if k_cache.shape[3] != d or d not in dims:
        raise ValueError(f"{what}: head_dim {d} (cache "
                         f"{k_cache.shape[3]}) not in {dims}")
    if hq % hkv or hq // hkv > max_group:
        raise ValueError(f"{what}: Hq={hq} must be a multiple of Hkv={hkv} "
                         f"with at most {max_group} query heads per group")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"{what}: q and the caches must be 16-byte aligned")


def data_ptr(t):
    """The tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()
