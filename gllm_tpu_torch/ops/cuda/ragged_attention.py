"""Ragged paged attention: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``gllm_tpu/ops/pallas/ragged_attention.py::ragged_paged_attention``
in its non-unified, full-precision-cache GQA mode. A flat packed batch of
query tokens (decode rows and prefill chunks) attends causally over each
sequence's paged KV: token t of sequence s sits at position
``kv_len - q_len + t``. The kernel (``csrc/ragged_attention.cu``) is bound by
operations on the prefill chunks; it runs a fixed grid of
``(cdiv(T, BQ) + S, Hkv)`` blocks that find their own (sequence, q tile)
from ``cu_q_lens``, so this wrapper issues no host sync, and each block
reuses every K/V tile it loads for its 64 query rows. bf16 and fp16 run on
the tensor cores (``mma.sync``) with double-buffered ``cp.async`` tile
loads; float32 runs on plain FMA.

``ragged_paged_attention`` launches the kernel for CUDA tensors and takes
the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from gllm_tpu_torch.ops.cuda import build
from gllm_tpu_torch.ops.cuda.common import check_inputs
from gllm_tpu_torch.utils import cdiv

ROWS_PER_BLOCK = 64     # query rows (tokens × group heads) per kernel block


def ragged_paged_attention_plain(q, k_cache, v_cache, cu_q_lens, kv_lens,
                                 page_table, *, scale: float,
                                 page_offset: int = 0):
    """Gather-based reference, computed in float32 sequence by sequence
    (the semantics of ``gllm_tpu/ops/attention.py::_xla_paged_attention``).

    q [T, Hq, D]; k_cache/v_cache [P, page, Hkv, D]; cu_q_lens [S+1];
    kv_lens [S]; page_table [S, max_pages] (ids offset by ``page_offset``).
    Tokens of no sequence (padding past cu_q_lens[S]) give zeros. Returns
    [T, Hq, D] in q's dtype."""
    ragged_paged_attention_plain.calls += 1
    T, Hq, D = q.shape
    _, page, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    out = torch.zeros_like(q)
    cu = cu_q_lens.tolist()
    kvl = kv_lens.tolist()
    for s in range(len(kvl)):
        q0, q_len, kv_len = cu[s], cu[s + 1] - cu[s], kvl[s]
        if q_len == 0 or kv_len == 0:
            continue
        pages = page_table[s, :cdiv(kv_len, page)].long() + page_offset
        k = k_cache[pages].reshape(-1, Hkv, D)[:kv_len].float()
        v = v_cache[pages].reshape(-1, Hkv, D)[:kv_len].float()
        qs = q[q0:q0 + q_len].reshape(q_len, Hkv, G, D).float()
        scores = torch.einsum("qhgd,khd->hgqk", qs, k) * scale
        q_pos = (kv_len - q_len
                 + torch.arange(q_len, device=q.device))[:, None]
        visible = torch.arange(kv_len, device=q.device)[None, :] <= q_pos
        scores = scores.masked_fill(~visible, float("-inf"))
        probs = torch.softmax(scores, dim=-1).masked_fill(~visible, 0.0)
        o = torch.einsum("hgqk,khd->qhgd", probs, v)
        out[q0:q0 + q_len] = o.reshape(q_len, Hq, D).to(q.dtype)
    return out


ragged_paged_attention_plain.calls = 0


def ragged_paged_attention(q, k_cache, v_cache, cu_q_lens, kv_lens,
                           page_table, *, scale: float, page_offset: int = 0):
    """Same contract as :func:`ragged_paged_attention_plain`."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_cache, v_cache, cu_q_lens, kv_lens, page_table,
            scale=scale, page_offset=page_offset)
    T, Hq, D = q.shape
    check_inputs("ragged_paged_attention", q, k_cache, v_cache,
                 (cu_q_lens, kv_lens, page_table),
                 max_group=ROWS_PER_BLOCK)
    S = kv_lens.shape[0]
    Hkv = k_cache.shape[2]
    if ROWS_PER_BLOCK % (Hq // Hkv):
        raise ValueError("ragged_paged_attention: the query group size "
                         f"{Hq // Hkv} must divide {ROWS_PER_BLOCK}")
    if cu_q_lens.shape != (S + 1,) or page_table.shape[0] != S:
        raise ValueError("ragged_paged_attention: cu_q_lens [S+1], kv_lens "
                         "[S] and page_table [S, max_pages] must agree")
    out = torch.empty_like(q)
    if T == 0 or S == 0:
        return out.zero_()
    rc = build.kernel("ragged_attention")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cu_q_lens.data_ptr(), kv_lens.data_ptr(), page_table.data_ptr(),
        out.data_ptr(), T, S, page_table.shape[1], Hq, Hkv, D,
        k_cache.shape[1], page_offset, scale, build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
