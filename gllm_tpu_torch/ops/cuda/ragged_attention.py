"""Ragged paged attention: CUDA kernel wrappers and their plain PyTorch
version.

Replaces ``gllm_tpu/ops/pallas/ragged_attention.py::ragged_paged_attention``
in its GQA modes. A flat packed batch of query tokens (decode rows and
prefill chunks) attends causally over each sequence's paged KV: token t of
sequence s sits at position ``kv_len - q_len + t``.

- GQA, non-unified (K1; K1q over an int8 cache with ``k_scale``/``v_scale``)
  and unified (K1u, ``unified=True``): one C entry,
  ``csrc/ragged_attention.cu``, serves both; they differ only in their plain
  versions. The batch's decode prefix (the longest run of one-token
  sequences at its head, found on the device from ``cu_q_lens``) runs the
  split-KV decode blocks (``csrc/decode_attention.cuh``); every other
  sequence runs the ragged blocks, which find their own (sequence, tile)
  from ``cu_q_lens``, each sequence's last tile first, so this wrapper
  issues no host sync. bf16 and fp16 run a warp-specialised ``wgmma``
  block (``csrc/ragged_wgmma.cuh``: two consumer warpgroups of 64 query
  rows, floor(64 / G) tokens times the G heads of a kv head, and a
  producer warpgroup filling a ring of K/V stages), bound by operations on
  the prefill chunks; float32 runs plain FMA. Any GQA group up to
  ``MAX_GROUP``. Head dims 32, 64 and 128, and 256 over a full-precision
  or an fp8 cache for K1 (Qwen3-Next's gated attention). An int8 tile is
  widened to bf16/fp16 exactly; the key scales multiply the scores and
  the value scales are folded into the probabilities. The plain version of
  K1u reproduces the TPU kernel's AMLA softmax (``_online_update``:
  log2-domain scores, a running max rounded up with ``ceil``, ``exp2``,
  power-of-two rescales that flush to 0 below the normal range); the CUDA
  blocks rescale the classic way, which keeps each row's largest
  probability exactly 1 when it is rounded for the tensor cores (see
  ``csrc/ragged_attention.cu``).
- MLA (K1m, non-unified, ``v_cache=None``): ``csrc/mla_ragged_attention.cu``
  over a shared latent cache [P, page, 1, Dl] whose values are the keys'
  leading ``v_dim`` lanes; ``wgmma`` over 4 tokens x 16 heads a block,
  each latent tile read once for both products (see
  ``csrc/mla_attention.cuh``).
- Unified MLA (K1um, ``unified=True, v_cache=None``):
  ``csrc/mla_unified_attention.cu``, K2m's split-KV decode blocks for the
  decode prefix and K1m's ragged blocks for every other sequence, found
  on the device as K1u finds them; classic rescaling, as K1u.
- K1u and K1um take ``decode_only`` from a caller that knows the step is
  pure decode (the runner's ``max_q_len == 1``): their ragged class, which
  would find no work, is then not launched.
- Every mode but int8 also reads an fp8 (e4m3) cache or latent, widened
  exactly on the card (``csrc/paged_kv.cuh``); the plain version widens
  the gathered pages.

``ragged_paged_attention`` launches a kernel for CUDA tensors and takes the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from gllm_tpu_torch.ops.cuda import build
from gllm_tpu_torch.ops.cuda.common import (MAX_GROUP, cache_code,
                                            cache_suffix,
                                            check_inputs,
                                            check_latent_inputs, data_ptr,
                                            gather_pages)
from gllm_tpu_torch.ops.cuda.decode_attention import split_plan
from gllm_tpu_torch.utils import cdiv

LOG2E = 1.4426950408889634
AMLA_BLOCK = 64         # keys per online-softmax update of the plain AMLA


def decode_prefix_len(cu_q_lens) -> int:
    """Length of the batch's decode prefix: the longest run of sequences
    0, 1, ... with exactly one query token each (``cu[s + 1] == s + 1``),
    which is also the token where the other rows begin
    (``_decode_prefix_len``). The kernels find it on the device; this
    host version serves the plain path."""
    S = cu_q_lens.shape[0] - 1
    one_tok = (cu_q_lens[1:].long()
               == torch.arange(1, S + 1, device=cu_q_lens.device))
    bad = (~one_tok).nonzero()
    return int(bad[0, 0]) if bad.numel() else S


def _rescale_add(x, dm):
    """``x * 2^dm`` for integer ``dm <= 0`` as an add on the float32
    exponent field (``_rescale_add``): ``dm == 0`` keeps x, a result below
    the normal range flushes to 0."""
    xb = x.contiguous().view(torch.int32)
    ex = (xb & 0x7F800000) >> 23
    y = (xb + (dm << 23)).view(torch.float32)
    return torch.where(dm >= 0, x,
                       torch.where(ex + dm > 0, y, torch.zeros_like(x)))


def _attend(qs, k, v, visible, scale, amla):
    """Masked softmax attention in float32. qs [B, q, Hkv, G, D];
    k/v [B, K, Hkv, D]; visible [B, q, K] → [B, q, Hkv, G, D]; rows with no
    visible key give zeros. ``amla``: the online softmax of unified mode
    over blocks of ``AMLA_BLOCK`` keys, in the log2 domain."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, k)
    mask = visible[:, None, None]                        # [B, 1, 1, q, K]
    if not amla:
        s = (s * scale).masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    s = (s * (scale * LOG2E)).masked_fill(~mask, float("-inf"))
    lead = s.shape[:-1] + (1,)
    m = torch.full(lead, float("-inf"), device=s.device)
    l = torch.zeros(lead, device=s.device)
    acc = torch.zeros(lead[:-1] + (v.shape[-1],), device=s.device)
    for k0 in range(0, s.shape[-1], AMLA_BLOCK):
        sb = s[..., k0:k0 + AMLA_BLOCK]
        m_new = torch.maximum(m, torch.ceil(sb.amax(-1, keepdim=True)))
        safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp2(sb - safe)
        dm = torch.clamp(m - safe, min=-160.0).to(torch.int32)
        l = _rescale_add(l, dm) + p.sum(-1, keepdim=True)
        acc = _rescale_add(acc, dm) + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, v[:, k0:k0 + AMLA_BLOCK])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4)


def ragged_paged_attention_plain(q, k_cache, v_cache, cu_q_lens, kv_lens,
                                 page_table, *, scale: float,
                                 page_offset: int = 0, k_scale=None,
                                 v_scale=None, unified: bool = False,
                                 v_dim=None):
    """Gather-based reference in float32 (the semantics of
    ``gllm_tpu/ops/attention.py::_xla_paged_attention``).

    q [T, Hq, D]; k_cache/v_cache [P, page, Hkv, D]; cu_q_lens [S+1];
    kv_lens [S]; page_table [S, max_pages] (ids offset by ``page_offset``).
    An int8 cache comes with ``k_scale``/``v_scale`` [P, Hkv] float32 and
    is dequantized on the gathered pages; an fp8 cache is widened.
    ``unified``: AMLA's softmax, with the decode prefix's rows batched as
    the kernel's decode blocks are.
    ``v_cache`` None: a shared latent cache (MLA), whose values are the
    keys' leading ``v_dim`` lanes. Tokens of no sequence (padding past
    cu_q_lens[S]) give zeros. Returns [T, Hq, Dv] in q's dtype (Dv = D, or
    ``v_dim``)."""
    ragged_paged_attention_plain.calls += 1
    T, Hq, D = q.shape
    _, page, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    Dv = D if v_cache is not None else v_dim

    def values(k, pages, n):
        if v_cache is None:
            return k[..., :v_dim]
        return gather_pages(v_cache, v_scale, pages).reshape(
            n, -1, Hkv, D)

    out = torch.zeros((T, Hq, Dv), dtype=q.dtype, device=q.device)
    cu = cu_q_lens.tolist()
    kvl = kv_lens.tolist()
    first = 0
    if unified:
        nd = decode_prefix_len(cu_q_lens)
        if nd:
            max_kv = max(kvl[:nd])
            pages = (page_table[:nd, :cdiv(max_kv, page)].long()
                     + page_offset)
            k = gather_pages(k_cache, k_scale, pages).reshape(nd, -1, Hkv, D)
            v = values(k, pages, nd)[:, :max_kv]
            k = k[:, :max_kv]
            visible = (torch.arange(max_kv, device=q.device)[None, None, :]
                       < kv_lens[:nd].long()[:, None, None])
            o = _attend(q[:nd].reshape(nd, 1, Hkv, G, D).float(), k, v,
                        visible, scale, amla=True)
            out[:nd] = o.reshape(nd, Hq, Dv).to(q.dtype)
        first = nd
    for s in range(first, len(kvl)):
        q0, q_len, kv_len = cu[s], cu[s + 1] - cu[s], kvl[s]
        if q_len == 0 or kv_len == 0:
            continue
        pages = page_table[s, :cdiv(kv_len, page)].long() + page_offset
        k = gather_pages(k_cache, k_scale, pages).reshape(1, -1, Hkv, D)
        v = values(k, pages, 1)
        qs = q[q0:q0 + q_len].reshape(1, q_len, Hkv, G, D).float()
        q_pos = (kv_len - q_len
                 + torch.arange(q_len, device=q.device))[:, None]
        visible = torch.arange(kv_len, device=q.device)[None, :] <= q_pos
        o = _attend(qs, k[:, :kv_len], v[:, :kv_len], visible[None],
                    scale, amla=unified)
        out[q0:q0 + q_len] = o.reshape(q_len, Hq, Dv).to(q.dtype)
    return out


ragged_paged_attention_plain.calls = 0


def ragged_paged_attention(q, k_cache, v_cache, cu_q_lens, kv_lens,
                           page_table, *, scale: float, page_offset: int = 0,
                           k_scale=None, v_scale=None,
                           unified: bool = False, v_dim=None,
                           decode_only: bool = False):
    """Same contract as :func:`ragged_paged_attention_plain`.
    ``decode_only`` (``unified`` only): the caller knows every sequence has
    one query token (a pure-decode step, T == S), so the kernel launches
    its decode blocks alone; the plain version needs no such hint."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_cache, v_cache, cu_q_lens, kv_lens, page_table,
            scale=scale, page_offset=page_offset, k_scale=k_scale,
            v_scale=v_scale, unified=unified, v_dim=v_dim)
    if v_cache is None:
        if k_scale is not None:
            raise NotImplementedError(
                "ragged_paged_attention: an int8 MLA latent cache is not "
                "supported")
        return _mla_ragged(q, k_cache, cu_q_lens, kv_lens, page_table,
                           scale=scale, page_offset=page_offset, v_dim=v_dim,
                           unified=unified, decode_only=decode_only)
    T, Hq, D = q.shape
    check_inputs("ragged_paged_attention", q, k_cache, v_cache,
                 (cu_q_lens, kv_lens, page_table),
                 max_group=MAX_GROUP, k_scale=k_scale, v_scale=v_scale,
                 wide=not unified)
    S = kv_lens.shape[0]
    Hkv = k_cache.shape[2]
    if cu_q_lens.shape != (S + 1,) or page_table.shape[0] != S:
        raise ValueError("ragged_paged_attention: cu_q_lens [S+1], kv_lens "
                         "[S] and page_table [S, max_pages] must agree")
    _check_decode_only(decode_only, unified, T, S)
    out = torch.empty_like(q)
    if T == 0 or S == 0:
        return out.zero_()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            data_ptr(k_scale), data_ptr(v_scale), cu_q_lens.data_ptr(),
            kv_lens.data_ptr(), page_table.data_ptr(), out.data_ptr())
    dims = (S, page_table.shape[1], Hq, Hkv, D, k_cache.shape[1],
            page_offset)
    codes = (build.DTYPE_CODES[q.dtype], cache_code(k_cache), stream)
    chunk, num_splits, part = split_plan(q, k_cache, page_table)
    rc = build.kernel("ragged_attention")(
        *ptrs, data_ptr(part), T, *dims, chunk, num_splits, scale,
        *codes[:2], int(decode_only), codes[2])
    build.check(rc, "ragged_paged_attention")
    ragged_paged_attention.launches[
        kernel_name(unified, False, k_cache)] += 1
    return out


def _check_decode_only(decode_only, unified, T, S):
    if decode_only and (not unified or T != S):
        raise ValueError("ragged_paged_attention: decode_only takes the "
                         f"unified kernel and T == S (got unified={unified}"
                         f", T={T}, S={S})")


def _mla_ragged(q, latent, cu_q_lens, kv_lens, page_table, *, scale,
                page_offset, v_dim, unified, decode_only):
    """K1m, or K1um when ``unified``: the MLA kernels over a latent cache
    [P, page, 1, Dl]."""
    check_latent_inputs("ragged_paged_attention", q, latent, v_dim,
                        (cu_q_lens, kv_lens, page_table))
    T, Hq, Dl = q.shape
    S = kv_lens.shape[0]
    if cu_q_lens.shape != (S + 1,) or page_table.shape[0] != S:
        raise ValueError("ragged_paged_attention: cu_q_lens [S+1], kv_lens "
                         "[S] and page_table [S, max_pages] must agree")
    _check_decode_only(decode_only, unified, T, S)
    out = torch.empty((T, Hq, v_dim), dtype=q.dtype, device=q.device)
    if T == 0 or S == 0:
        return out.zero_()
    ptrs = (q.data_ptr(), latent.data_ptr(), cu_q_lens.data_ptr(),
            kv_lens.data_ptr(), page_table.data_ptr(), out.data_ptr())
    dims = (page_table.shape[1], Dl, v_dim, latent.shape[1], page_offset)
    codes = (build.DTYPE_CODES[q.dtype], cache_code(latent),
             torch.cuda.current_stream().cuda_stream)
    if unified:
        chunk, num_splits, part = split_plan(q, latent, page_table, v_dim)
        rc = build.kernel("mla_unified_attention")(
            *ptrs, data_ptr(part), T, S, *dims, chunk, num_splits, scale,
            *codes[:2], int(decode_only), codes[2])
    else:
        rc = build.kernel("mla_ragged_attention")(*ptrs, T, S, *dims, scale,
                                                  *codes)
    build.check(rc, "ragged_paged_attention")
    ragged_paged_attention.launches[kernel_name(unified, True, latent)] += 1
    return out


def kernel_name(unified: bool, mla: bool, cache) -> str:
    """The launch counter of a mode: K1 (``ragged_paged_attention``), K1u
    (``_unified``), K1m (``_mla``), K1um (``_unified_mla``), each over a
    full-precision cache or, with the suffix ``_int8`` (not MLA) or
    ``_fp8``, a one-byte one."""
    return ("ragged_paged_attention" + "_unified" * unified + "_mla" * mla
            + cache_suffix(cache))


ragged_paged_attention.launches = {
    "ragged_paged_attention" + u + m + c: 0
    for u in ("", "_unified") for m in ("", "_mla")
    for c in ("", "_int8", "_fp8") if not (m and c == "_int8")}
