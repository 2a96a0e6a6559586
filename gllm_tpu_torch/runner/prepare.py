"""Host-side batch building: ScheduledBatch → StepBatch (counterpart of
``gllm_tpu/runner/prepare.py``: ``BatchBuilder.shape_signature:70``,
``build:282``).

The builder fills flat numpy arrays — token / position / slot buffers,
query-start offsets, per-seq kv lens and page tables — padded to the same
power-of-two buckets as the JAX package (vectorised fill, no per-token
Python loop). ``HostStaging`` then packs the whole step into ONE pinned host
buffer and ships it with ONE ``non_blocking`` host-to-device copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gllm_tpu_torch.batching import StepBatch
from gllm_tpu_torch.config import EngineConfig
from gllm_tpu_torch.ops.attention import AttentionMetadata
from gllm_tpu_torch.ops.sampling import SamplingMetadata
from gllm_tpu_torch.scheduler import ScheduledBatch
from gllm_tpu_torch.utils import bucket_size, cdiv


class BatchBuilder:
    def __init__(self, config: EngineConfig, page_size: int):
        self.config = config
        self.page_size = page_size
        sc = config.scheduler
        # upper bounds of the shape buckets
        self.max_tokens = sc.max_prefill_tokens + sc.max_decode_seqs
        self.max_seqs = min(config.max_num_seqs,
                            sc.max_decode_seqs + sc.max_prefill_tokens)
        self.max_pages_per_seq = config.max_pages_per_seq

    def shape_signature(self, batch: ScheduledBatch
                        ) -> Tuple[int, int, int, int]:
        """(T_bucket, S_bucket, max_q_len, pages_bucket). The page bucket
        follows the live maximum context of the batch, not max_model_len."""
        s = bucket_size(batch.num_seqs, 8, self.max_seqs)
        max_q = max(it.num_new_tokens for it in batch.items)
        if max_q == 1:
            t, q = s, 1          # pure decode: one token per seq (T == S)
        else:
            t = bucket_size(batch.total_tokens, 16, self.max_tokens)
            q = t
        max_pages = max(
            max(cdiv(it.computed_before + it.num_new_tokens, self.page_size),
                len(it.seq.page_table))
            for it in batch.items)
        p = bucket_size(max_pages, 4, self.max_pages_per_seq)
        return t, s, q, p

    def build(self, batch: ScheduledBatch) -> Tuple[StepBatch, int]:
        """Returns (StepBatch of host numpy arrays, max_q_len)."""
        t_pad, s_pad, max_q, p_pad = self.shape_signature(batch)
        page = self.page_size

        tokens = np.zeros(t_pad, np.int32)
        positions = np.zeros(t_pad, np.int32)
        slots = np.zeros(t_pad, np.int32)          # padding → dummy page slot
        cu = np.zeros(s_pad + 1, np.int32)
        kv_lens = np.zeros(s_pad, np.int32)
        page_table = np.zeros((s_pad, p_pad), np.int32)
        logits_idx = np.zeros(s_pad, np.int32)
        temperature = np.zeros(s_pad, np.float32)
        top_p = np.ones(s_pad, np.float32)
        top_k = np.full(s_pad, -1, np.int32)
        min_p = np.zeros(s_pad, np.float32)

        items = batch.items
        K = len(items)
        ns = np.fromiter((it.num_new_tokens for it in items), np.int64,
                         count=K)
        befores = np.fromiter((it.computed_before for it in items),
                              np.int64, count=K)
        ends = np.cumsum(ns)
        offs = ends - ns
        total = int(ends[-1]) if K else 0
        cu[1:K + 1] = ends
        cu[K + 1:] = total
        kv_lens[:K] = befores + ns
        logits_idx[:K] = ends - 1

        rows = np.repeat(np.arange(K), ns)            # item idx per token
        pos = (np.arange(total) - np.repeat(offs, ns)
               + np.repeat(befores, ns))              # absolute positions
        positions[:total] = pos

        # ragged page-table rows → one flat scatter; the np form of each
        # row is cached on the Sequence (rows only change on page alloc)
        def _pt_arr(seq):
            pt = seq.page_table
            c = seq._pt_np
            if c is None or len(c) != len(pt):
                c = np.asarray(pt, np.int32)
                seq._pt_np = c
            return c

        pt_lens = np.fromiter((len(it.seq.page_table) for it in items),
                              np.int64, count=K)
        if K:
            flat_pt = np.concatenate([_pt_arr(it.seq) for it in items])
            pt_rows = np.repeat(np.arange(K), pt_lens)
            pt_cols = (np.arange(int(pt_lens.sum()))
                       - np.repeat(np.cumsum(pt_lens) - pt_lens, pt_lens))
            page_table[pt_rows, pt_cols] = flat_pt
        slots[:total] = page_table[rows, pos // page] * page + pos % page

        tokens[:total] = np.fromiter(
            (t for it in items
             for t in it.seq.token_ids[it.computed_before:
                                       it.computed_before
                                       + it.num_new_tokens]),
            np.int32, count=total)

        sps = [it.seq.sampling_params for it in items]
        temperature[:K] = [sp.temperature for sp in sps]
        top_p[:K] = [sp.top_p for sp in sps]
        top_k[:K] = [sp.top_k for sp in sps]
        min_p[:K] = [sp.min_p for sp in sps]

        step_batch = StepBatch(
            token_ids=tokens, positions=positions, slot_mapping=slots,
            logits_indices=logits_idx,
            attn=AttentionMetadata(cu_q_lens=cu, kv_lens=kv_lens,
                                   page_table=page_table),
            sampling=SamplingMetadata(temperature=temperature, top_p=top_p,
                                      top_k=top_k, min_p=min_p))
        return step_batch, max_q


class HostStaging:
    """Ships a host StepBatch to the device as one pinned buffer and one
    ``non_blocking`` copy.

    Every array is laid end to end in a single int32 buffer (float32
    arrays by bit pattern); the device copy is split back into views. The
    pinned buffer is reused across steps: the synchronous engine loop
    fetches each step's sampled tokens (a stream sync) before it builds
    the next step, so the previous copy out of the buffer has finished."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._host = torch.empty(0, dtype=torch.int32)

    def upload(self, sb: StepBatch) -> StepBatch:
        parts = [sb.token_ids, sb.positions, sb.slot_mapping,
                 sb.logits_indices, sb.attn.cu_q_lens, sb.attn.kv_lens,
                 sb.attn.page_table.reshape(-1), sb.sampling.top_k,
                 sb.sampling.temperature.view(np.int32),
                 sb.sampling.top_p.view(np.int32),
                 sb.sampling.min_p.view(np.int32)]
        sizes = [p.size for p in parts]
        n = sum(sizes)
        if self._host.numel() < n:
            self._host = torch.empty(max(n, 2 * self._host.numel()),
                                     dtype=torch.int32,
                                     pin_memory=self._pin)
        host_np = self._host.numpy()
        np.concatenate(parts, out=host_np[:n])
        if self.device.type == "cpu":
            dev = self._host[:n].clone()
        else:
            dev = self._host[:n].to(self.device, non_blocking=True)
        views = list(torch.split(dev, sizes))
        (tok, pos, slots, lidx, cu, kvl, pt, top_k, temp, top_p,
         min_p) = views
        f32 = torch.float32
        return StepBatch(
            token_ids=tok, positions=pos, slot_mapping=slots,
            logits_indices=lidx,
            attn=AttentionMetadata(
                cu_q_lens=cu, kv_lens=kvl,
                page_table=pt.view(sb.attn.page_table.shape)),
            sampling=SamplingMetadata(
                temperature=temp.view(f32), top_p=top_p.view(f32),
                top_k=top_k, min_p=min_p.view(f32)))
