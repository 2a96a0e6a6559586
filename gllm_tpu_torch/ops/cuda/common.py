"""Argument checks shared by the attention kernel wrappers."""

from __future__ import annotations

import torch

from gllm_tpu_torch.ops.cuda.build import DTYPE_CODES

HEAD_DIMS = (32, 64, 128)


def check_inputs(what: str, q, k_cache, v_cache, index_tensors,
                 max_group: int) -> None:
    """Raise on anything the kernel does not take: device, dtype, shape,
    contiguity, alignment."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA or CPU tensors, got "
                         f"{q.device}")
    tensors = (q, k_cache, v_cache) + tuple(index_tensors)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: all tensors must be on {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"{what}: q, k_cache and v_cache must share a "
                         f"dtype, got {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}")
    if any(t.dtype != torch.int32 for t in index_tensors):
        raise ValueError(f"{what}: metadata tensors must be int32")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: expected q [T, Hq, D] and k/v caches "
                         "[P, page, Hkv, D] of one shape")
    _, hq, d = q.shape
    hkv = k_cache.shape[2]
    if k_cache.shape[3] != d or d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} (cache "
                         f"{k_cache.shape[3]}) not in {HEAD_DIMS}")
    if hq % hkv or hq // hkv > max_group:
        raise ValueError(f"{what}: Hq={hq} must be a multiple of Hkv={hkv} "
                         f"with at most {max_group} query heads per group")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"{what}: q and the caches must be 16-byte aligned")
