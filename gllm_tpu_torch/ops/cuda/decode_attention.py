"""Paged decode attention: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``gllm_tpu/ops/pallas/decode_attention.py::paged_decode_attention``
(GQA) over a full-precision cache (K2) or an int8 cache with per-page,
per-kv-head float32 scales (K2q), and, with ``v_cache=None``, over an MLA
latent cache whose values are the keys' leading ``v_dim`` lanes (K2m,
``csrc/mla_decode_attention.cu``: tensor cores, one latent tile read once
for both products; see ``csrc/mla_attention.cuh``). The GQA kernel
(``csrc/decode_attention.cu``) is bound by bytes: it runs one block per
(sequence, kv head, split of the context), so every K/V row of a
sequence's context is read from device memory once and shared by the G
query heads of its group, and a long context at a small batch still fills
the card. For bf16 / fp16 q the G heads are the rows of tensor-core
products, K/V tiles stream through a three-stage ``cp.async`` ring in
their storage type, and the last split of a row merges the row's splits
(no second launch); float32 q runs an FMA block and a merge pass. Head
dims 32, 64 and 128, and 256 over a full-precision or an fp8 cache
(Qwen3-Next's gated attention). An int8 or fp8 (e4m3) cache or latent is
widened exactly in registers, so it moves half the bytes. The TPU
kernel's round-robin DMA grouping is a TPU fetch schedule and does not
carry over.

``paged_decode_attention`` launches the kernel for CUDA tensors and takes
the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import functools
import gc
import weakref

import torch

from gllm_tpu_torch.ops.cuda import build
from gllm_tpu_torch.ops.cuda.common import (MAX_GROUP, cache_code,
                                            cache_suffix,
                                            check_inputs,
                                            check_latent_inputs, data_ptr,
                                            gather_pages)
from gllm_tpu_torch.utils import cdiv

# The split-KV decode blocks (csrc/decode_attention.cuh, GQA, and the
# decode mode of csrc/mla_attention.cuh): keys per tile, cp.async stages,
# prefetched page ids per split, and the split counters at the head of the
# scratch buffer.
DECODE_KEYS = 64
DECODE_STAGES = 3
MLA_KEYS = 32
PT_SLOTS = 256
COUNTER_SLOTS = 1 << 16
# float32 q runs FMA blocks of 32-key tiles (the card's reference runs)
FMA_KEYS = 32
FMA_BLOCKS_PER_SM = 4
MLA_FMA_BLOCKS_PER_SM = 2
# a split walks at most this many keys. The grid is sized for this many
# waves of resident blocks: three for the GQA blocks (contexts of uneven
# length still balance), one for the MLA block, whose tile costs more to
# start and whose partials are 16 x 512 floats a split (measured on the
# H100 at the serving path's decode shapes; PERF.md)
MAX_KEYS_PER_SPLIT = 4096
SPLIT_WAVES = 3
MLA_SPLIT_WAVES = 1
# an MLA split walks at least this many keys: at a small batch one wave
# would cut short contexts into one- or two-tile splits, each paying its
# Q load, ring start-up and 16 x 512 floats of partials (chosen with
# tools/decode_split_sweep.py on the H100; PERF.md)
MLA_MIN_SPLIT_KEYS = 128
# H100: 228 KB of shared memory an SM, 1 KB of it reserved per block
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024


def _resident(smem_bytes: int, by_regs: int) -> int:
    return min(SM_SHARED_BYTES // (smem_bytes + BLOCK_RESERVED_BYTES),
               by_regs)


def decode_blocks_per_sm(D: int, q_bytes: int, cache_bytes: int,
                         int8: bool = False) -> int:
    """Resident GQA tensor-core decode blocks per SM (DecodeMmaSmem): by
    shared memory (three stages of a K and a V tile of 64 keys, int8's
    scale rows, Q's 16 rows, the page ids; or the warps' merge states if
    larger), capped by registers (__launch_bounds__: 4 up to D 64, 3 at
    D 128, 2 at D 256)."""
    ldk = D + 16
    ldv = D + 16 if cache_bytes == 1 else D + 8
    stage = (DECODE_KEYS * (ldk + ldv) * cache_bytes
             + (2 * DECODE_KEYS * 4 if int8 else 0))
    loop = DECODE_STAGES * stage + 16 * (D + 16) * q_bytes + PT_SLOTS * 4
    merge = 4 * 16 * (D + 4 + 2) * 4
    return _resident(max(loop, merge), 4 if D <= 64 else 3 if D <= 128
                     else 2)


def mla_decode_blocks_per_sm(Dl: int, Dv: int, q_bytes: int,
                             cache_bytes: int) -> int:
    """Resident MLA decode blocks per SM (MlaDecodeSmem): by shared memory
    (four stages of 32 latent rows, Q's 16 rows, each group's P and row
    statistics, the page ids), capped by registers (a block of two
    four-warp groups over a 16-bit latent: one; of one group over fp8: 2
    at v_dim 512, else 4)."""
    narrow = cache_bytes == 1
    groups = 1 if narrow else 2
    ld = Dl + 16 if narrow else Dl + 8
    nbytes = (4 * MLA_KEYS * ld * cache_bytes + 16 * ld * q_bytes
              + groups * (16 * (MLA_KEYS + 8) * q_bytes + 2 * 4 * 16 * 4)
              + PT_SLOTS * 4)
    return _resident(nbytes, 1 if groups > 1 else 2 if Dv >= 512 else 4)


def keys_per_split(S: int, Hkv: int, max_keys: int, page: int,
                   num_sms: int, blocks_per_sm: int, tile: int,
                   waves: int = SPLIT_WAVES, min_keys: int = 0) -> int:
    """Keys per split: the (sequence, kv head) rows are split as few times
    as still gives ``waves`` waves of resident blocks over ``max_keys``
    (the padded page table, so the choice needs no host sync), rounded up
    to whole tiles, at least ``min_keys``, at most MAX_KEYS_PER_SPLIT and
    at most 255 pages (the page ids a block prefetches). Splits past a
    row's kv_len exit at once."""
    cap = max(tile, min(MAX_KEYS_PER_SPLIT, (PT_SLOTS - 1) * page)
              // tile * tile)
    splits = max(1, waves * num_sms * blocks_per_sm // (S * Hkv))
    keys = cdiv(cdiv(max(max_keys, 1), splits), tile) * tile
    return max(tile, min(max(keys, cdiv(min_keys, tile) * tile), cap))


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_scratch = {}
# per device, the holders of captured CUDA graphs that read its scratch
# (runner/graphs.py): while one lives, the buffer keeps its address
_scratch_pins = {}


def decode_scratch(device: torch.device, floats: int) -> torch.Tensor:
    """The split-KV decode blocks' scratch on ``device``: COUNTER_SLOTS
    int32 split counters, zero (the kernels set each back to zero), then
    at least ``floats`` float32 partials. One buffer per device, shared by
    every call on the device's (one) stream, grown by reallocation only
    while no captured CUDA graph reads it: a graph keeps the address it
    captured, so growth then raises (size it first with
    :func:`pin_decode_scratch`)."""
    device = _indexed(device)
    need = COUNTER_SLOTS + floats
    buf = _scratch.get(device)
    if buf is None or buf.numel() < need:
        if _scratch_pins.get(device):
            gc.collect()        # holders that died in a reference cycle
        if _scratch_pins.get(device):
            raise RuntimeError(
                f"decode_scratch: {need} slots needed but {buf.numel()} "
                "are held at their address by a captured CUDA graph; size "
                "the scratch for every shape before the first capture "
                "(pin_decode_scratch)")
        buf = torch.zeros(need, dtype=torch.float32, device=device)
        _scratch[device] = buf
    return buf


def pin_decode_scratch(device: torch.device, floats: int,
                       holder) -> torch.Tensor:
    """Size the scratch for ``floats`` partials and hold it at its address
    while ``holder`` (weakly referenced) lives; returns the buffer, which
    the holder keeps so that its captured graphs never read freed
    memory."""
    buf = decode_scratch(device, floats)
    _scratch_pins.setdefault(_indexed(device), weakref.WeakSet()).add(holder)
    return buf


def release_decode_scratch(device: torch.device) -> None:
    """Drop ``device``'s scratch once no captured graph holds it (the last
    runner with graphs on the device freed): the next call sizes a new
    one. With no holder left on any device, also drop the cuBLAS
    workspaces that the graphs' capture streams made, which the process
    would otherwise keep until it ends."""
    device = _indexed(device)
    if _scratch_pins.get(device):
        return
    _scratch.pop(device, None)
    if not any(_scratch_pins.values()):
        torch._C._cuda_clearCublasWorkspaces()


def _indexed(device) -> torch.device:
    """``device`` with its index ("cuda" → "cuda:0"): one key per card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def split_geometry(S: int, max_pages: int, Hq: int, Hkv: int, D: int,
                   page: int, q_dtype: torch.dtype, cache_dtype: torch.dtype,
                   device: torch.device, v_dim=None):
    """(keys per split, number of splits, scratch floats) of the decode
    kernel's grid over S rows of ``max_pages`` pages: the plan of
    :func:`split_plan`, from shapes and dtypes alone."""
    Dv = v_dim or D
    q_bytes, cache_bytes = q_dtype.itemsize, cache_dtype.itemsize
    if q_dtype == torch.float32:
        tile = FMA_KEYS
        bps = MLA_FMA_BLOCKS_PER_SM if v_dim else FMA_BLOCKS_PER_SM
    elif v_dim:
        tile = MLA_KEYS
        bps = mla_decode_blocks_per_sm(D, Dv, q_bytes, cache_bytes)
    else:
        tile = DECODE_KEYS
        bps = decode_blocks_per_sm(D, q_bytes, cache_bytes,
                                   cache_dtype == torch.int8)
    max_keys = max_pages * page
    chunk = keys_per_split(S, Hkv, max_keys, page, _num_sms(device), bps,
                           tile, MLA_SPLIT_WAVES if v_dim else SPLIT_WAVES,
                           MLA_MIN_SPLIT_KEYS if v_dim else 0)
    num_splits = max(1, cdiv(max_keys, chunk))
    floats = S * Hq * num_splits * (Dv + 2) if num_splits > 1 else 0
    return chunk, num_splits, floats


def split_plan(q, k_cache, page_table, v_dim=None):
    """(keys per split, number of splits, the scratch or None) for the
    decode kernel's grid over ``page_table``'s rows, with no host sync.
    ``v_dim``: an MLA latent cache's value width (the output's)."""
    _, page, Hkv, D = k_cache.shape
    chunk, num_splits, floats = split_geometry(
        page_table.shape[0], page_table.shape[1], q.shape[1], Hkv, D, page,
        q.dtype, k_cache.dtype, q.device, v_dim)
    part = decode_scratch(q.device, floats) if num_splits > 1 else None
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
    chunk, num_splits, part = split_plan(q, latent, page_table, v_dim)
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
