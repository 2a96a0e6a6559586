"""Paged attention dispatch (counterpart of ``gllm_tpu/ops/attention.py``:
``paged_attention:79``, ``_paged_attention:174``).

One call serves a step's whole batch against the paged KV cache:

- pure-decode batches (``max_q_len == 1``; one token per sequence, T == S)
  go to the decode kernel (``ops/cuda/decode_attention.py``);
- mixed or prefill batches go to the ragged kernel
  (``ops/cuda/ragged_attention.py``).

Each wrapper launches its CUDA kernel for CUDA tensors and takes its plain
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
                    v_cache: torch.Tensor, md: AttentionMetadata, *,
                    scale: float, max_q_len: int,
                    page_offset: int = 0) -> torch.Tensor:
    """q [T, Hq, D] against caches [P, page, Hkv, D] (page ids in
    ``md.page_table`` are offset by ``page_offset``) → [T, Hq, D]."""
    if max_q_len == 1:
        if q.shape[0] != md.kv_lens.shape[0]:
            raise ValueError(
                f"decode path requires T == S, got T={q.shape[0]} "
                f"S={md.kv_lens.shape[0]}")
        return paged_decode_attention(q, k_cache, v_cache, md.kv_lens,
                                      md.page_table, scale=scale,
                                      page_offset=page_offset)
    return ragged_paged_attention(q, k_cache, v_cache, md.cu_q_lens,
                                  md.kv_lens, md.page_table, scale=scale,
                                  page_offset=page_offset)
