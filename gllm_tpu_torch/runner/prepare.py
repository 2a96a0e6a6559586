"""Host-side batch building: ScheduledBatch → StepBatch (counterpart of
``gllm_tpu/runner/prepare.py``: ``BatchBuilder.shape_signature:70``,
``stop_sets:186``, ``batch_extras:254``, ``build:282``).

The builder fills flat numpy arrays — token / position / slot buffers,
query-start offsets, per-seq kv lens and page tables — padded to the same
power-of-two buckets as the JAX package (vectorised fill, no per-token
Python loop). ``HostStaging`` then packs the whole step into ONE pinned host
buffer (one of a ring, so that steps can be in flight together) and ships
it with ONE ``non_blocking`` host-to-device copy, into one device buffer
that the runner sizes once for its largest step: the views of a shape
signature sit at the same addresses every step, so a CUDA graph captured
on them reads each later step's data (``runner/graphs.py``). Each row's
seed and output index ride every step in that fixed part. A step's
extras (the penalties' values and token ids, the logit_bias pairs, the
prompt-logprob targets) take widths no batch changes, so their offsets
follow the step's key too: JAX buckets the penalty id lists and the bias
pairs by the batch's longest (``penalty_len_bucket:240``,
``bias_len_bucket:247``), which would add keys as sequences grow; here
the ids take ``max_model_len`` a row (nothing is cut, so the counts equal
JAX's) and the pairs ``BIAS_PAIRS``, JAX's bucket of the 300 a request
may send.
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
from gllm_tpu_torch.sequence import HOLE_SEQ_ID
from gllm_tpu_torch.utils import bucket_size, cdiv, next_pow2

# the widest per-row stop set (EOS and stop_token_ids) a block under
# on-device finish takes: the staging buffer reserves [S, MAX_STOP_IDS]
MAX_STOP_IDS = 64
# a fused spec block's seed state a row: the right-aligned token ring, then
# its valid length, the last token, the position, the token budget, the
# draft length, the output index (a seeded row's draws), how the runner
# completes the row on the card (0: the host's seed is whole; SEED_CARRY,
# SEED_SPLICE) and the block's sub-step limit
SPEC_SEED_COLS = 8
SEED_CARRY, SEED_SPLICE = 1, 2
# logit_bias pairs a row: JAX's ``bias_len_bucket`` of the 300 pairs that
# ``SamplingParams.validate`` allows a request
BIAS_PAIRS = 512


class BatchBuilder:
    def __init__(self, config: EngineConfig, page_size: int,
                 use_ssm: bool = False, vocab_size: int = 0):
        self.config = config
        self.page_size = page_size
        # penalty and logit_bias ids at or past it are dropped (they never
        # appear in the logits)
        self.vocab_size = vocab_size
        # the penalties' token ids a row: every token a sequence can hold
        self.penalty_len = config.max_model_len
        sc = config.scheduler
        # upper bounds of the shape buckets; speculative decoding adds up
        # to spec_k draft rows a decode row
        self.spec_k = config.spec_k if config.spec_decode else 0
        self.max_tokens = (sc.max_prefill_tokens
                           + sc.max_decode_seqs * (1 + self.spec_k))
        self.max_seqs = min(config.max_num_seqs,
                            sc.max_decode_seqs + sc.max_prefill_tokens)
        self.max_pages_per_seq = config.max_pages_per_seq
        # where blocks form (overlap scheduling, multi_step_decode > 1, not
        # a hybrid model), every signature takes the one largest page
        # bucket, so that warmup's sequence buckets cover every decode step,
        # block and unified mixed step that serving meets (ROADMAP C 7)
        self.pin_pages = (config.overlap_scheduling
                          and config.multi_step_decode > 1 and not use_ssm)
        # a fused spec block's page table is wider by the pages spec_k draft
        # rows can reach past a row's allocated frontier: a verify row's
        # context ends spec_k tokens after its committed position
        self.spec_pages = (cdiv(config.spec_k, page_size)
                           if config.spec_fused else 0)
        # unified step: one signature family, max_q_len rides the token
        # bucket (no separate q == 1 population); inert for a hybrid model,
        # as in the JAX package (prepare.py:60-65)
        self.unified = config.unified_step and not use_ssm
        # hybrid models: each row's SSM slot (prepare.py:332-333,424-426)
        self.use_ssm = use_ssm

    def shape_signature(self, batch: ScheduledBatch
                        ) -> Tuple[int, int, int, int]:
        """(T_bucket, S_bucket, max_q_len, pages_bucket). The page bucket
        follows the live maximum context of the batch, not max_model_len.
        Under the unified step a pure-decode batch is the t == s point of
        the q == t family and every other batch pads its tokens to the
        one schedulable maximum, as the JAX package does."""
        s = bucket_size(batch.num_seqs, 8, self.max_seqs)
        rows = [it.num_new_tokens + len(it.draft_tokens)
                for it in batch.items]
        max_q = max(rows)
        if self.unified:
            t = s if max_q == 1 else self.max_tokens
            q = t
        elif max_q == 1:
            t, q = s, 1          # pure decode: one token per seq (T == S)
        else:
            t = bucket_size(sum(rows), 16, self.max_tokens)
            q = t
        # a table may be longer than this step needs (an earlier step's
        # rejected drafts, a spec block's worst case)
        max_pages = max(
            max(cdiv(it.computed_before + it.num_new_tokens
                     + len(it.draft_tokens), self.page_size),
                len(it.seq.page_table))
            for it in batch.items)
        p = bucket_size(max_pages, 4, self.max_pages_per_seq)
        if self.pin_pages:
            p = self.max_pages_per_seq
        return t, s, q, p

    def padding(self, t_pad: int, s_pad: int, p_pad: int,
                verify_width: int = 0, adjust: bool = False,
                plp: bool = False) -> StepBatch:
        """A StepBatch of host arrays at (T, S, pages) holding padding rows
        only: token 0 at position 0 into the dummy page's slot 0, empty
        sequences (q_len 0, kv_len 0) whose pages are the dummy page, the
        greedy sampling defaults (no seed) and, for a hybrid model, the
        dummy SSM slot 0; with ``verify_width`` K1 also a verify step's
        rows (row 0) and drafts (none, -1) [S, K1] and [S, K1 - 1]; with
        ``adjust`` the neutral penalties (1, 0, 0; no token id, -1 [S,
        penalty_len]) and logit_bias pairs (id 0, bias 0 [S,
        BIAS_PAIRS]); with ``plp`` the prompt-logprob targets (0 [T]).
        ``build`` fills the real rows over it; the runner's graph capture
        runs it as is (it writes nothing a sequence reads)."""
        z = lambda n: np.zeros(n, np.int32)
        fields, sampling = {}, {}
        if verify_width:
            fields = dict(
                spec_rows=np.zeros((s_pad, verify_width), np.int32),
                spec_drafts=np.full((s_pad, verify_width - 1), -1,
                                    np.int32))
        if adjust:
            sampling = dict(
                repetition_penalty=np.ones(s_pad, np.float32),
                presence_penalty=np.zeros(s_pad, np.float32),
                frequency_penalty=np.zeros(s_pad, np.float32),
                bias_ids=np.zeros((s_pad, BIAS_PAIRS), np.int32),
                bias_vals=np.zeros((s_pad, BIAS_PAIRS), np.float32))
            fields["penalty_ids"] = np.full((s_pad, self.penalty_len), -1,
                                            np.int32)
        if plp:
            fields["plp_targets"] = z(t_pad)
        return StepBatch(
            token_ids=z(t_pad), positions=z(t_pad), slot_mapping=z(t_pad),
            logits_indices=z(s_pad),
            attn=AttentionMetadata(
                cu_q_lens=z(s_pad + 1), kv_lens=z(s_pad),
                page_table=np.zeros((s_pad, p_pad), np.int32)),
            sampling=SamplingMetadata(
                temperature=np.zeros(s_pad, np.float32),
                top_p=np.ones(s_pad, np.float32),
                top_k=np.full(s_pad, -1, np.int32),
                min_p=np.zeros(s_pad, np.float32),
                seed=np.full(s_pad, -1, np.int32), out_step=z(s_pad),
                **sampling),
            ssm_slots=z(s_pad) if self.use_ssm else None, **fields)

    @staticmethod
    def batch_extras(batch: ScheduledBatch) -> frozenset:
        """The extras ``batch`` carries, which its step's key names (its
        logits adjusted, logprobs computed): "penalties", "bias", "lp"
        (output logprobs), "plp" (the prompt logprobs of a prompt chunk).
        Seeds ride every step."""
        extras = set()
        for it in batch.items:
            sp = it.seq.sampling_params
            if sp.uses_penalty:
                extras.add("penalties")
            if sp.logit_bias:
                extras.add("bias")
            if sp.logprobs is not None:
                extras.add("lp")
            if (sp.prompt_logprobs is not None
                    and it.computed_before < it.seq.prompt_len):
                extras.add("plp")
        return frozenset(extras)

    def stop_sets(self, items, s_bucket: int, eos_token_ids,
                  absolute: bool = False):
        """On-device finish inputs of a block: ([S, E] per-row EOS and
        stop-token ids padded with -1, [S] arming sub-step), or
        (None, None) when no row has a stop id. ``items`` are the first
        link's: the token sampled by sub-step k is output number
        ``computed_before + k + 2 - prompt_len``, so ``min_tokens`` arms
        the check from sub-step ``min_tokens + prompt_len -
        computed_before - 2``. E is a power of two, at least 8 and at
        most ``MAX_STOP_IDS``; a wider set raises. A hole row (persistent
        slots) is dead for the whole block and gives no id, so that a
        finish never widens E mid-run. ``absolute`` (a fused spec block,
        whose carried frontier makes sub-step numbers meaningless across
        blocks): the arming threshold is the absolute feed position
        ``min_tokens + prompt_len - 2`` (a row without ``min_tokens``:
        always armed), JAX's ``stop_sets(absolute=True)``."""
        sets = [[] if it.seq.seq_id == HOLE_SEQ_ID
                else it.seq.device_stop_ids(eos_token_ids) for it in items]
        if not any(sets):
            return None, None
        widest = max(len(ids) for ids in sets)
        if widest > MAX_STOP_IDS:
            raise ValueError(
                f"a stop set of {widest} token ids (EOS and stop_token_ids)"
                f" exceeds the {MAX_STOP_IDS} a block takes")
        E = max(8, next_pow2(widest))
        stop_ids = np.full((s_bucket, E), -1, np.int32)
        stop_from = np.full(s_bucket, -(1 << 30) if absolute else 0,
                            np.int32)
        for i, (it, ids) in enumerate(zip(items, sets)):
            stop_ids[i, :len(ids)] = ids
            mt = it.seq.sampling_params.min_tokens
            if absolute:
                stop_from[i] = (mt + it.seq.prompt_len - 2 if mt
                                else -(1 << 30))
            elif mt:
                stop_from[i] = max(0, mt + it.seq.prompt_len
                                   - it.computed_before - 2)
        return stop_ids, stop_from

    def build(self, batch: ScheduledBatch,
              force_signature=None) -> Tuple[StepBatch, int]:
        """Returns (StepBatch of host numpy arrays, max_q_len), at
        ``force_signature`` (T, S, max_q_len, pages) when given: a block
        is built from its first link at its last link's signature, whose
        page bucket covers the pages of every link. A hole row (persistent slots) is
        built from its sentinel like any row: token 0 at position 0, its
        KV into the dummy page 0."""
        t_pad, s_pad, max_q, p_pad = (force_signature
                                      or self.shape_signature(batch))
        page = self.page_size
        items = batch.items
        sps = [it.seq.sampling_params for it in items]
        # the extras at their fixed widths (``padding``): the adjustments
        # when a row has a penalty or a logit_bias, the targets when a
        # prompt chunk asks for its logprobs
        want_plp = any(sp.prompt_logprobs is not None
                       and it.computed_before < it.seq.prompt_len
                       for it, sp in zip(items, sps))
        pad = self.padding(t_pad, s_pad, p_pad,
                           adjust=any(sp.uses_penalty or sp.logit_bias
                                      for sp in sps), plp=want_plp)
        tokens, positions, slots = (pad.token_ids, pad.positions,
                                    pad.slot_mapping)
        cu, kv_lens, page_table = pad.attn
        logits_idx = pad.logits_indices
        temperature, top_p, top_k, min_p = pad.sampling[:4]
        seeds, out_steps = pad.sampling.seed, pad.sampling.out_step

        K = len(items)
        # drafts add verify rows after each item's committed chunk, which
        # everything downstream treats as ordinary chunk rows
        ns = np.fromiter((it.num_new_tokens + len(it.draft_tokens)
                          for it in items), np.int64, count=K)
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

        # a chained row's input token is on the device only (the runner
        # splices it in): 0 here
        def _tok_vals(it):
            b, n = it.computed_before, it.num_new_tokens
            v = it.seq.token_ids[b:b + n]
            if len(v) != n:
                v = list(v) + [0] * (n - len(v))
            return list(v) + list(it.draft_tokens) if it.draft_tokens else v

        tokens[:total] = np.fromiter(
            (t for it in items for t in _tok_vals(it)), np.int32,
            count=total)

        temperature[:K] = [sp.temperature for sp in sps]
        top_p[:K] = [sp.top_p for sp in sps]
        top_k[:K] = [sp.top_k for sp in sps]
        min_p[:K] = [sp.min_p for sp in sps]
        plp_targets = pad.plp_targets
        for i, (it, sp) in enumerate(zip(items, sps)):
            if sp.seed is not None:
                seeds[i] = sp.seed
                # the index of the output token this step samples
                out_steps[i] = int(befores[i] + ns[i]) - it.seq.prompt_len
            if plp_targets is not None and sp.prompt_logprobs is not None:
                # the row at position p scores prompt token p + 1
                b, o = int(befores[i]), int(offs[i])
                nxt = it.seq.token_ids[b + 1:min(b + int(ns[i]) + 1,
                                                 it.seq.prompt_len)]
                plp_targets[o:o + len(nxt)] = nxt
        if pad.penalty_ids is not None:
            self._adjustments(pad, items)

        if self.use_ssm:
            # a hole row owns no slot: the dummy slot 0
            pad.ssm_slots[:K] = [it.seq.ssm_slot or 0 for it in items]
        if batch.has_drafts:
            # a drafted row's verify rows: its committed row, then its
            # draft rows (row r scores the token after r's position); a
            # row without drafts points at row 0 with -1 drafts, which
            # never accept
            kmax = self.spec_k
            spec_rows = np.zeros((s_pad, kmax + 1), np.int32)
            spec_drafts = np.full((s_pad, kmax), -1, np.int32)
            for i, it in enumerate(items):
                d = len(it.draft_tokens)
                if d:
                    base = int(offs[i]) + it.num_new_tokens - 1
                    spec_rows[i, :d + 1] = base + np.arange(d + 1)
                    spec_drafts[i, :d] = it.draft_tokens
            pad = pad._replace(spec_rows=spec_rows, spec_drafts=spec_drafts)
        return pad._replace(num_seqs=K,
                            max_seq_q=int(ns.max()) if K else 0), max_q

    def _adjustments(self, pad: StepBatch, items) -> None:
        """Fill the rows that use a penalty or a logit_bias over
        ``padding``'s neutral arrays: a penalized row's token ids (below
        the vocabulary; every one fits ``penalty_len``) and its three
        values, a biased row's pairs (ids past the vocabulary dropped;
        padding pairs add 0)."""
        md = pad.sampling
        vocab = self.vocab_size or 1 << 30
        for i, it in enumerate(items):
            sp = it.seq.sampling_params
            if sp.uses_penalty:
                row = np.asarray(it.seq.token_ids, np.int64)
                row = row[row < vocab][:self.penalty_len]
                pad.penalty_ids[i, :len(row)] = row
                md.repetition_penalty[i] = sp.repetition_penalty
                md.presence_penalty[i] = sp.presence_penalty
                md.frequency_penalty[i] = sp.frequency_penalty
            if sp.logit_bias:
                pairs = [(t, b) for t, b in sp.logit_bias.items()
                         if t < vocab][:BIAS_PAIRS]
                for j, (t, b) in enumerate(pairs):
                    md.bias_ids[i, j] = t
                    md.bias_vals[i, j] = b

    def upload_size(self, t_pad: int, s_pad: int, p_pad: int) -> int:
        """int32 slots of a step's fixed part at (T, S, pages)
        (``HostStaging``'s layout, the variable lists excluded)."""
        return (3 * t_pad + s_pad * (9 + p_pad) + 1
                + (s_pad if self.use_ssm else 0))

    def extras_size(self, t_pad: int, s_pad: int) -> int:
        """int32 slots of a step's extras at (T, S): the three penalties,
        the penalty ids and the logit_bias pairs a row, the prompt-logprob
        targets a token."""
        return s_pad * (3 + self.penalty_len + 2 * BIAS_PAIRS) + t_pad

    def spec_size(self, s_pad: int, ring: int) -> int:
        """int32 slots of a step's speculation arrays at S rows: a
        host-driven verify step's rows and drafts, or a fused spec block's
        seed state (ring, then ``SPEC_SEED_COLS`` columns)."""
        return s_pad * max(2 * self.spec_k + 1, ring + SPEC_SEED_COLS)


class HostStaging:
    """Ships a host StepBatch to the device as one pinned buffer and one
    ``non_blocking`` copy, into one device buffer.

    Every array is laid end to end in a single int32 buffer (float32
    arrays by bit pattern): first the fixed part, whose offsets depend on
    the step's (T, S, pages) only, then a block's ``active_until`` [S]
    and, under on-device finish, its stop sets [S, E] and arming sub-steps
    [S] (offsets fixed by (T, S, pages, E)), a verify step's rows [S, K1]
    and drafts [S, K1 - 1] or a spec block's seed state (offsets fixed by
    the key's K1), a step's extras (the three penalties [S], the penalty
    ids [S, penalty_len], the logit_bias ids and values [S, BIAS_PAIRS],
    the prompt-logprob targets [T]; offsets fixed by the key's extras
    flags), then the lists whose length varies from step to step (the
    int8 cache's scale-reset page ids, a hybrid model's slots to zero,
    each deduplicated; a re-formed batch's splice map), which only the
    eager prologue and the splice read. The device copy is split back
    into views. With ``capacity`` the device buffer is allocated once, at
    that size, and a step that needs more raises: a CUDA graph captured on
    the views of a signature then reads every later step of it. Without,
    it grows as needed (``allocations`` counts the device buffers made).

    The one device buffer is reused by every step: its copies and readers
    are ordered on the stream. The pinned host side is a ring of
    ``slots`` buffers: under overlap scheduling the host fills a step's
    buffer while earlier steps' copies may still wait on the stream behind
    a replay, so a buffer is filled again only once an event recorded
    after its last copy has completed (``slots`` of at least
    ``overlap_depth + 1`` keep that wait empty)."""

    def __init__(self, device: torch.device, capacity: int = 0,
                 slots: int = 1):
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._ring = [torch.empty(0, dtype=torch.int32)
                      for _ in range(slots)]
        # per slot, an event after its last copy (a CPU copy is done
        # when it returns)
        self._events = ([torch.cuda.Event() for _ in range(slots)]
                        if self._pin else [None] * slots)
        self._next = 0
        self._dev = None
        self.allocations = 0
        self.fixed = capacity > 0
        if capacity:
            self._allocate(capacity)

    def _allocate(self, n: int) -> None:
        self._dev = torch.empty(n, dtype=torch.int32, device=self.device)
        self.allocations += 1

    def upload(self, sb: StepBatch) -> StepBatch:
        resets = list(dict.fromkeys(sb.scale_resets or []))
        zero = list(dict.fromkeys(sb.ssm_zero or []))
        md = sb.sampling
        parts = [sb.token_ids, sb.positions, sb.slot_mapping,
                 sb.logits_indices, sb.attn.cu_q_lens, sb.attn.kv_lens,
                 sb.attn.page_table.reshape(-1), md.top_k,
                 md.temperature.view(np.int32), md.top_p.view(np.int32),
                 md.min_p.view(np.int32), md.seed, md.out_step,
                 np.asarray(sb.ssm_slots if sb.ssm_slots is not None
                            else [], np.int32),
                 _ints(sb.active_until), _ints(md.stop_ids),
                 _ints(md.stop_from), _ints(sb.spec_rows),
                 _ints(sb.spec_drafts), _ints(sb.spec_seed),
                 _ints(md.repetition_penalty, True),
                 _ints(md.presence_penalty, True),
                 _ints(md.frequency_penalty, True), _ints(sb.penalty_ids),
                 _ints(md.bias_ids), _ints(md.bias_vals, True),
                 _ints(sb.plp_targets),
                 np.asarray(resets, np.int32), np.asarray(zero, np.int32),
                 np.asarray(sb.splice or [], np.int32)]
        sizes = [p.size for p in parts]
        n = sum(sizes)
        if self._dev is None or self._dev.numel() < n:
            if self.fixed:
                raise RuntimeError(
                    f"HostStaging: a step of {n} int32 slots outgrew the "
                    f"device buffer of {self._dev.numel()}")
            self._allocate(max(n, 2 * (0 if self._dev is None
                                       else self._dev.numel())))
        i = self._next
        self._next = (i + 1) % len(self._ring)
        if self._events[i] is not None:
            self._events[i].synchronize()
        host = self._ring[i]
        if host.numel() < n:
            host = self._ring[i] = torch.empty(
                max(n, 2 * host.numel()), dtype=torch.int32,
                pin_memory=self._pin)
        np.concatenate(parts, out=host.numpy()[:n])
        dev = self._dev[:n]
        dev.copy_(host[:n], non_blocking=self._pin)
        if self._events[i] is not None:
            self._events[i].record()
        (tok, pos, slots, lidx, cu, kvl, pt, top_k, temp, top_p, min_p,
         seed, out_step, ssm_slots, active_until, stop_ids, stop_from,
         spec_rows, spec_drafts, spec_seed, rep, pres, freq, pen_ids,
         bias_ids, bias_vals, plp, resets, ssm_zero, splice) = \
            torch.split(dev, sizes)
        f32 = torch.float32

        def shaped(v, a, floats=False):
            if a is None:
                return None
            return (v.view(f32) if floats else v).view(a.shape)
        return StepBatch(
            token_ids=tok, positions=pos, slot_mapping=slots,
            logits_indices=lidx,
            attn=AttentionMetadata(
                cu_q_lens=cu, kv_lens=kvl,
                page_table=pt.view(sb.attn.page_table.shape)),
            sampling=SamplingMetadata(
                temperature=temp.view(f32), top_p=top_p.view(f32),
                top_k=top_k, min_p=min_p.view(f32), seed=seed,
                out_step=out_step,
                repetition_penalty=shaped(rep, md.repetition_penalty, True),
                presence_penalty=shaped(pres, md.presence_penalty, True),
                frequency_penalty=shaped(freq, md.frequency_penalty, True),
                bias_ids=shaped(bias_ids, md.bias_ids),
                bias_vals=shaped(bias_vals, md.bias_vals, True),
                stop_ids=shaped(stop_ids, md.stop_ids),
                stop_from=shaped(stop_from, md.stop_from)),
            scale_resets=resets if resets.numel() else None,
            ssm_slots=ssm_slots if sb.ssm_slots is not None else None,
            active_until=shaped(active_until, sb.active_until),
            ssm_zero=ssm_zero if ssm_zero.numel() else None,
            splice=splice.view(2, -1) if splice.numel() else None,
            spec_rows=shaped(spec_rows, sb.spec_rows),
            spec_drafts=shaped(spec_drafts, sb.spec_drafts),
            spec_seed=shaped(spec_seed, sb.spec_seed),
            penalty_ids=shaped(pen_ids, sb.penalty_ids),
            plp_targets=shaped(plp, sb.plp_targets),
            num_seqs=sb.num_seqs, max_seq_q=sb.max_seq_q)


def _ints(x, floats: bool = False) -> np.ndarray:
    """An optional host array as int32, flat (empty for None); a float32
    one (``floats``) by bit pattern."""
    if x is None:
        return np.zeros(0, np.int32)
    if floats:
        return np.ascontiguousarray(x, np.float32).view(np.int32).reshape(-1)
    return np.asarray(x, np.int32).reshape(-1)
