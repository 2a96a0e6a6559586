"""Paged attention dispatch (counterpart of ``gllm_tpu/ops/attention.py``:
``paged_attention:79``, ``_paged_attention:174``, the ``v_cache=None``
routing of ``:190-201``).

One call serves a step's whole batch against the paged KV cache. With
``impl="legacy"`` (the engine without ``unified_step``):

- pure-decode batches (``max_q_len == 1``; one token per sequence, T == S)
  go to the decode kernel (``ops/cuda/decode_attention.py``);
- mixed or prefill batches go to the ragged kernel
  (``ops/cuda/ragged_attention.py``).

With ``impl="unified"`` (``EngineConfig.unified_step``) every batch goes to
the ragged wrapper's unified kernel: decode rows are one-token rows of the
ragged batch, and ``max_q_len == 1`` (a pure-decode step) tells the kernel
that no other row exists, so it launches its decode blocks alone.

``k_scale``/``v_scale`` ([P, Hkv] float32) mark an int8 cache; every
kernel dequantizes on its read path. An fp8 (``float8_e4m3fn``) cache takes
no scales; every kernel widens it as it reads. ``v_cache=None`` marks an
MLA latent cache [P, page, 1, Dl], whose values are the keys' leading
``v_dim`` lanes: the legacy pair's MLA kernels (K1m, K2m) serve it, and
the unified step's MLA kernel (K1um) under ``impl="unified"``. Each
wrapper launches its CUDA kernel for CUDA tensors and takes its plain
PyTorch version only for tensors on the CPU. The JAX package's lane-packed
KV layout exists only for the TPU's 128-lane tiles; this port stores the
native [P, page, Hkv, D] cache.

Metadata layout (built by the runner, padded to bucketed sizes):
- cu_q_lens: [S+1] int32 — cumulative query lengths (padded seqs repeat
  the last value → q_len 0)
- kv_lens:   [S] int32 — per-seq context AFTER this step's tokens
- page_table:[S, max_pages] int32 — padded entries point at the dummy page
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gllm_tpu_torch.ops.cuda.decode_attention import paged_decode_attention
from gllm_tpu_torch.ops.cuda.ragged_attention import ragged_paged_attention


class AttentionMetadata(NamedTuple):
    cu_q_lens: torch.Tensor    # [S+1] int32
    kv_lens: torch.Tensor      # [S] int32
    page_table: torch.Tensor   # [S, max_pages] int32


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache, md: AttentionMetadata, *,
                    scale: float, max_q_len: int, page_offset: int = 0,
                    impl: str = "legacy", k_scale=None,
                    v_scale=None, v_dim=None) -> torch.Tensor:
    """q [T, Hq, D] against caches [P, page, Hkv, D] (page ids in
    ``md.page_table`` are offset by ``page_offset``) → [T, Hq, D]; with
    ``v_cache`` None → [T, Hq, v_dim]."""
    scales = dict(k_scale=k_scale, v_scale=v_scale)
    if v_cache is None:
        if v_dim is None:
            raise ValueError("v_dim required when v_cache is None")
        if k_scale is not None:
            raise NotImplementedError("an int8 MLA latent cache is not "
                                      "supported")
        scales = dict(v_dim=v_dim)
    if impl == "unified":
        return ragged_paged_attention(q, k_cache, v_cache, md.cu_q_lens,
                                      md.kv_lens, md.page_table, scale=scale,
                                      page_offset=page_offset, unified=True,
                                      decode_only=max_q_len == 1, **scales)
    if impl != "legacy":
        raise ValueError(f"unknown attention impl {impl!r}")
    if max_q_len == 1:
        if q.shape[0] != md.kv_lens.shape[0]:
            raise ValueError(
                f"decode path requires T == S, got T={q.shape[0]} "
                f"S={md.kv_lens.shape[0]}")
        return paged_decode_attention(q, k_cache, v_cache, md.kv_lens,
                                      md.page_table, scale=scale,
                                      page_offset=page_offset, **scales)
    return ragged_paged_attention(q, k_cache, v_cache, md.cu_q_lens,
                                  md.kv_lens, md.page_table, scale=scale,
                                  page_offset=page_offset, **scales)
