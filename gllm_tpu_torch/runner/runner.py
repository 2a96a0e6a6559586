"""ModelRunner: owns the parameters, the KV cache and the step (counterpart
of ``gllm_tpu/runner/runner.py``: ``ModelRunner.__init__:273``,
``reset_page_scales:136``, ``_kv_bytes_per_page:570``,
``determine_num_pages:614``, ``_build_step_fn:650``,
``_apply_scale_resets:923``, ``step_multi:1291``, ``step:1845``; the
hybrid slot pool ``:414-433``, ``_ssm_pool_bytes:603``).

A step: build the batch on the host, copy it over in one transfer into
the runner's one device buffer, run forward → logits → sample, and copy
the sampled tokens out. ``step_async`` dispatches it and returns a handle;
``collect`` waits for its tokens (the only wait); ``step`` is the two in
a row. ``step_async_chained`` dispatches a step whose input tokens are an
earlier handle's sampled tokens, spliced in on the device (overlap
scheduling, ``gllm_tpu/runner/runner.py:1114-1289``). ``step_multi``
dispatches a block: K chained pure-decode steps as one device program
(one CUDA graph), whose rows that die inside it freeze, and which stops
early under on-device finish once every row has finished. With
``EngineConfig.enforce_eager`` off (the default, as in the JAX package),
a pure-decode step on CUDA replays the CUDA graph of its shape signature,
captured at first sight or by ``warmup`` (``runner/graphs.py``, where JAX
compiles one program per signature); every other step runs op by op. On
the CPU the same static-buffer body runs uncaptured.
The model family (dense, DeepSeek's MLA + MoE, or the hybrid GDN family)
comes from ``models/registry.py``. A hybrid model keeps its GDN state in
slot pools of ``1 + max_num_seqs`` slots (slot 0: the padding dummy);
the slots freed since the last step ride the step's one upload and are
zeroed (``index_fill_``) before its forward.
The KV cache is updated in place where JAX donated its buffers. An int8
cache first zeroes the scales of the pages minted for the step (their ids
ride the step's one upload), so a recycled page quantizes like a fresh one.
Both of these run eagerly before a replay: their lists change length from
step to step.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gllm_tpu_torch.config import EngineConfig
from gllm_tpu_torch.models import hybrid
from gllm_tpu_torch.models.config import ModelConfig
from gllm_tpu_torch.models.registry import get_model_def
from gllm_tpu_torch.ops.cuda.common import check_model_shapes
from gllm_tpu_torch.ops.cuda.decode_attention import split_geometry
from gllm_tpu_torch.ops.sampling import sample, stop_token_hit
from gllm_tpu_torch.runner import graphs
from gllm_tpu_torch.runner.prepare import (MAX_STOP_IDS, BatchBuilder,
                                           HostStaging)
from gllm_tpu_torch.sampling_params import SamplingParams
from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq
from gllm_tpu_torch.sequence import Sequence
from gllm_tpu_torch.utils import cdiv

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}

# Device memory kept free for a step's activations at the largest batch
# shape (the JAX runner keeps the same 512 MB).
ACTIVATION_HEADROOM = 512 * 1024 * 1024
# The decode graphs' shared pool stays resident beside the eager steps'
# activations. Its size is set by the largest sampled body: about 15
# float32 [S, vocab] tensors (logits, their sort values and int64 indices,
# probabilities, cumulative sums, masks, noise), measured after warmup on
# the H100 (PERF.md) and reckoned here as 16; a hybrid model's pool also
# holds about two recurrent GDN states per row
GRAPH_POOL_LOGIT_COPIES = 16
GRAPH_POOL_STATES_PER_ROW = 2


def reclaim_driver_memory(device: torch.device) -> None:
    """Have the CUDA driver hand back the memory it keeps, outside the
    caching allocator, for the CUDA graphs of engines freed earlier in the
    process. It gives that memory back only to an allocation that needs
    it, so this asks for the card's whole memory once; the request is
    refused. On the H100 the driver kept 1.4 GiB after four
    DeepSeek-V2-Lite engines with graphs were freed, which the next
    engine's KV pool could not be sized from
    (``tools/engine_memory_cycle.py``; PERF.md, C 1)."""
    total = torch.cuda.mem_get_info(device)[1]
    try:
        torch.empty(total, dtype=torch.uint8, device=device)
    except torch.OutOfMemoryError:
        pass


class StepHandle(NamedTuple):
    """A dispatched step's sampled tokens: ``tokens``, the handle's own
    copy on the device (what a chained step splices from; never a graph's
    output, which the key's next replay overwrites), ``host``, their
    copy on the way to the host (pinned on CUDA), and ``event``, recorded
    after that copy (None on the CPU). A block's (``block``: its graph
    key) are [K + 1, n]: the tokens of each sub-step, then each row's
    finish step (the sub-steps in which it was alive)."""
    tokens: torch.Tensor
    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    block: Optional[tuple] = None

    @property
    def last(self) -> torch.Tensor:
        """The tokens a step chained off this one takes as input: a
        block's last sub-step's."""
        return self.tokens[-2] if self.block is not None else self.tokens


class ModelRunner:
    def __init__(self, config: EngineConfig, model_cfg: ModelConfig,
                 device: torch.device, params=None):
        config.validate(model_cfg)
        self.config = config
        self.model_cfg = model_cfg
        self.model = get_model_def(model_cfg)
        self.device = torch.device(device)
        # the unified step as resolved: inert on a hybrid model, as in the
        # JAX runner (``runner.py:297-303``)
        self.unified = config.unified_step and not model_cfg.use_hybrid
        if self.device.type == "cuda":
            check_model_shapes(model_cfg, config.cache.kv_cache_dtype,
                               self.unified)
        self.dtype = DTYPES[config.dtype]
        kd = config.cache.kv_cache_dtype
        self.kv_dtype = self.dtype if kd == "auto" else DTYPES[kd]
        self.kv_quant = self.kv_dtype == torch.int8
        # attention kernels (ops/attention.py): the unified kernel for every
        # step, or the legacy decode / ragged pair
        self.attn_impl = "unified" if self.unified else "legacy"
        # the engine's memory manager, whose minted pages an int8 cache
        # resets (set by the engine)
        self.memory_manager = None
        if params is not None:
            self.params = params
        elif config.load_format == "dummy" or not config.model:
            self.params = self.model.init_params(model_cfg, config.seed,
                                                 self.dtype, self.device)
        else:
            raise NotImplementedError(
                "gllm_tpu_torch loads no checkpoint weights yet (ROADMAP "
                "A 7): use load_format='dummy' or pass params")
        self.cos_sin = self.model.make_rope_table(model_cfg, self.device)
        self.hybrid = self.model.family == "hybrid"
        # hybrid: one GDN state slot per running sequence, and slot 0
        self.ssm_working_slots = config.max_num_seqs if self.hybrid else 0
        self.builder = BatchBuilder(config, config.cache.page_size,
                                    use_ssm=self.hybrid)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        # steps by batch: "decode" when every row has one new token, else
        # "mixed" (a prefill chunk or a mix). The legacy kernels split the
        # same way; the unified kernel serves both.
        self.step_counts = {"mixed": 0, "decode": 0}
        # blocks dispatched (each one graph replay) and the sub-steps they
        # executed (counted when a block is collected)
        self.block_counts = {"block": 0, "substeps": 0}
        # the engine's EOS ids, which a block under on-device finish
        # detects (set by the engine)
        self.eos_token_ids = frozenset()
        # the device memory the KV pool was sized from (None when the
        # config gives the page count)
        self.sizing = None
        self.num_pages = (config.cache.num_pages
                          or self.determine_num_pages())
        slots = ({"num_slots": 1 + self.ssm_working_slots} if self.hybrid
                 else {})
        self.kv = self.model.init_kv_cache(model_cfg, self.num_pages,
                                           config.cache.page_size,
                                           self.kv_dtype, self.device,
                                           **slots)
        logger.info("KV cache: %d pages × %d tokens (%s) on %s",
                    self.num_pages, config.cache.page_size, self.kv_dtype,
                    self.device)
        # one device buffer for every step: the largest step's fixed part,
        # a block's active_until and widest stop sets, then room for every
        # page's scale reset, every slot's zeroing and a re-form's splice
        # map; a pinned host buffer for each step that can be in flight,
        # and one more
        b = self.builder
        self.staging = HostStaging(self.device, capacity=(
            b.upload_size(b.max_tokens, b.max_seqs, b.max_pages_per_seq)
            + b.max_seqs * (2 + MAX_STOP_IDS)
            + (self.num_pages if self.kv_quant else 0)
            + (1 + self.ssm_working_slots if self.hybrid else 0)
            + 2 * b.max_seqs), slots=(
                config.overlap_depth + 1 if config.overlap_scheduling
                else 1))
        # the compiled decode steps, by signature (None: every step eager)
        self.graphs = (None if config.enforce_eager else graphs.DecodeGraphs(
            self.device, self.generator, self._scratch_floats()))
        # warmup's steps leave the memory manager's queues alone
        self._warming = False

    def kv_bytes_per_page(self) -> int:
        """Device bytes of one page across the layers: K and V (and an int8
        page's scale rows), or one MLA latent row per token and layer, at
        the cache dtype's element size (one byte for int8 and fp8)."""
        return self.model.kv_bytes_per_page(
            self.model_cfg, self.config.cache.page_size, self.kv_dtype)

    def activation_headroom(self) -> int:
        """Device bytes kept free for a step's activations: 512 MB, for a
        hybrid model also the GDN layer's largest transient at the largest
        batch shape the config can schedule, and, unless ``enforce_eager``,
        the decode graphs' pool at the largest sequence bucket (twice when
        blocks stop early: their conditional bodies have a pool of their
        own)."""
        rows = self.builder.max_seqs
        headroom = ACTIVATION_HEADROOM
        if self.hybrid:
            cells = hybrid.max_gdn_cells(
                rows, min(self.config.scheduler.max_prefill_tokens,
                          self.config.max_model_len))
            headroom += hybrid.gdn_transient_bytes(self.model_cfg, cells,
                                                   rows)
        if not self.config.enforce_eager:
            # the graphs' pool and, when blocks stop early, the pool of
            # their conditional bodies, which holds a sub-step's transient
            # of its own
            pools = 2 if (self.block_len > 1
                          and self.config.ondevice_finish) else 1
            headroom += (pools * GRAPH_POOL_LOGIT_COPIES * rows
                         * self.model_cfg.vocab_size * 4)
            if self.hybrid:
                headroom += (GRAPH_POOL_STATES_PER_ROW * rows
                             * hybrid.ssm_pool_bytes(self.model_cfg, 1)
                             // self.model_cfg.num_linear_layers)
        return headroom

    def determine_num_pages(self) -> int:
        """Size the KV pool from the device's free memory after the weights
        are resident: ``memory_util`` of the card's total, less what is in
        use, the activation headroom and, for a hybrid model, the GDN slot
        pools."""
        if self.device.type != "cuda":
            return 2048               # CPU: modest default
        # blocks the caching allocator holds unused count as free, and so
        # does the memory the CUDA driver keeps for the graphs of engines
        # freed earlier in the process
        torch.cuda.empty_cache()
        reclaim_driver_memory(self.device)
        free, total = torch.cuda.mem_get_info(self.device)
        # what the pool is sized from: the allocator's reserved bytes
        # beyond its allocated ones are free space stranded in segments
        # that still hold a tensor, which the KV pool cannot take
        self.sizing = dict(
            free=free, total=total,
            reserved=torch.cuda.memory_reserved(self.device),
            allocated=torch.cuda.memory_allocated(self.device))
        budget = (total * self.config.cache.memory_util - (total - free)
                  - self.activation_headroom())
        if self.hybrid:
            budget -= hybrid.ssm_pool_bytes(self.model_cfg,
                                            1 + self.ssm_working_slots)
        num = int(budget // self.kv_bytes_per_page())
        min_pages = cdiv(self.config.max_model_len,
                         self.config.cache.page_size) + 2
        if num < min_pages:
            raise RuntimeError(
                f"not enough device memory for KV cache: {num} pages "
                f"(need >= {min_pages})")
        return num

    def _scratch_floats(self) -> int:
        """The split-KV decode scratch's partials at the largest plan over
        every (sequence bucket, page bucket) a step can take (0 on the CPU):
        sized before the first capture, it never grows under a graph."""
        if self.device.type != "cuda" or not self.model_cfg.num_attn_layers:
            return 0
        cfg, b = self.model_cfg, self.builder
        if cfg.use_mla:
            hkv, d, v_dim = 1, cfg.mla_cache_width, cfg.kv_lora_rank
        else:
            hkv, d, v_dim = cfg.num_kv_heads, cfg.head_dim, None
        return max(split_geometry(s, p, cfg.num_heads, hkv, d,
                                  self.config.cache.page_size, self.dtype,
                                  self.kv_dtype, self.device, v_dim)[2]
                   for s in graphs.pow2_range(8, b.max_seqs)
                   for p in graphs.pow2_range(4, b.max_pages_per_seq))

    def _host_batch(self, sched_batch: ScheduledBatch,
                    force_signature=None):
        """(host StepBatch, max_q_len, signature's max_q_len): built on the
        host (at ``force_signature`` when given) with the int8 cache's
        pending scale resets, the hybrid model's slots to zero and the
        splice map of a re-formed batch (mixed under the unified step) or
        of a chain with joins. A pure-decode batch gets max_q_len 1
        in both loops: under the unified step it tells the kernel the
        batch has no other rows (its signature keeps JAX's q == t)."""
        host_batch, sig_q = self.builder.build(sched_batch, force_signature)
        if sched_batch.src_rows is not None:
            # a re-formed batch: each promised row's one token sits at the
            # item's flat offset, which every multi-token chunk before it
            # (a mixed re-form) shifts (JAX's ``_splice_mapped_tokens``)
            offs = np.cumsum([0] + [it.num_new_tokens
                                    for it in sched_batch.items])
            dst = [int(o) for o, r in zip(offs, sched_batch.src_rows)
                   if r >= 0]
            src = [r for r in sched_batch.src_rows if r >= 0]
            host_batch = host_batch._replace(splice=dst + src)
        elif sched_batch.host_rows:
            # a chain with joins (persistent slots): the rows that did not
            # join take the previous entry's token of the same row; the
            # joined rows keep the host's (JAX's ``host_row_mask``)
            joined = set(sched_batch.host_rows)
            rows = [j for j in range(sched_batch.num_seqs)
                    if j not in joined]
            host_batch = host_batch._replace(splice=rows + rows)
        mm = None if self._warming else self.memory_manager
        if self.kv_quant and mm is not None:
            host_batch = host_batch._replace(
                scale_resets=mm.drain_scale_resets())
        if self.hybrid and mm is not None:
            host_batch = host_batch._replace(ssm_zero=mm.drain_ssm_zero())
        max_q = 1 if host_batch.max_seq_q == 1 else sig_q
        return host_batch, max_q, sig_q

    def prepare(self, sched_batch: ScheduledBatch):
        """(device StepBatch, max_q_len) for a scheduled batch: built on the
        host, with the int8 cache's pending scale resets, in one upload."""
        host_batch, max_q, _ = self._host_batch(sched_batch)
        return self.staging.upload(host_batch), max_q

    @torch.inference_mode()
    def forward_logits(self, batch, max_q: int) -> torch.Tensor:
        """forward + compute_logits for a device StepBatch → [S, V] f32,
        after the step's scale resets and slot zeroing."""
        self._prologue(batch)
        return self._forward(batch, max_q)

    def _prologue(self, batch) -> None:
        """The step's eager part: zero the int8 scales of minted pages and
        the GDN state of freed slots."""
        if batch.scale_resets is not None:
            # zero the minted pages' scales in every layer: a zero scale
            # makes the first write zero-fill the stale payload and start
            # a new running absmax
            pages = batch.scale_resets.long()
            self.kv.k_scale.index_fill_(1, pages, 0.0)
            self.kv.v_scale.index_fill_(1, pages, 0.0)
        if batch.ssm_zero is not None:
            # freed GDN slots start their next tenant from a zero state
            slots = batch.ssm_zero.long()
            self.kv.conv.index_fill_(1, slots, 0.0)
            self.kv.rec.index_fill_(1, slots, 0.0)

    def _forward(self, batch, max_q: int) -> torch.Tensor:
        hidden, residual = self.model.forward(self.params, self.kv, batch,
                                              self.model_cfg,
                                              cos_sin=self.cos_sin,
                                              max_q_len=max_q,
                                              impl=self.attn_impl)
        return self.model.compute_logits(self.params, hidden, residual,
                                         batch, self.model_cfg)

    def step(self, sched_batch: ScheduledBatch,
             force_signature=None) -> np.ndarray:
        """Run one step (at ``force_signature``, a block's, when given);
        returns the sampled token of each batch item."""
        return self.collect(self.step_async(
            sched_batch, force_signature=force_signature))

    def step_async_chained(self, sched_batch: ScheduledBatch,
                           prev: StepHandle) -> StepHandle:
        """Dispatch a step whose input tokens are ``prev``'s sampled tokens
        on the device: row i's for a chained step (but the ``host_rows``
        that joined it, whose token is the host's), row ``src_rows[i]``'s
        for a re-formed batch (-1: the host's tokens). Under the unified
        step a re-formed batch may be mixed (prefill chunks after the
        promised decode rows): it runs eagerly at the unified signature's
        one token bucket, as every mixed step does."""
        if sched_batch.src_rows is None:
            assert len(prev.last) == sched_batch.num_seqs
        return self.step_async(sched_batch, prev)

    @torch.inference_mode()
    def step_async(self, sched_batch: ScheduledBatch,
                   prev: Optional[StepHandle] = None,
                   force_signature=None) -> StepHandle:
        """Dispatch one step: the host builds and stages it, enqueues the
        copy in, the forward and sampling (one graph replay for a
        pure-decode step) and the copy of the tokens out, and returns
        without waiting for the device. A new decode signature is captured
        first, which waits for the device once. With ``prev``, the input
        tokens are spliced from ``prev``'s (``step_async_chained``)."""
        host_batch, max_q, sig_q = self._host_batch(sched_batch,
                                                    force_signature)
        decode = host_batch.max_seq_q == 1
        self.step_counts["decode" if decode else "mixed"] += 1
        all_greedy = all(it.seq.sampling_params.temperature == 0.0
                         for it in sched_batch.items)
        graphed = decode and self.graphs is not None
        if graphed:
            t = host_batch.token_ids.size
            s, p = host_batch.attn.page_table.shape
            key = (t, s, sig_q, p, all_greedy)

            def body(generator, graph=None):
                logits = self._forward(batch, 1)
                return sample(logits, batch.sampling, generator,
                              all_greedy=all_greedy)

            if self.graphs.cuda and key not in self.graphs:
                # captured over padding rows staged at the same views
                batch = self.staging.upload(self.builder.padding(t, s, p))
                self._capture(key, body, sampled=not all_greedy)
        batch = self.staging.upload(host_batch)
        if prev is not None:
            self._splice(batch, sched_batch, prev)
        self._prologue(batch)
        if graphed:
            tokens = self.graphs.run(key, body)
        else:
            tokens = sample(self._forward(batch, max_q), batch.sampling,
                            self.generator, all_greedy=all_greedy)
        return self._handle(tokens[:sched_batch.num_seqs])

    @staticmethod
    def _splice(batch, sched_batch: ScheduledBatch,
                prev: StepHandle) -> None:
        """Write ``prev``'s sampled tokens into the staged token view,
        after its upload and before the step reads it: one copy for a
        chained step (row to row), a gather and a scatter over the staged
        splice map for a re-formed batch or a chain with joins, whose
        joined rows keep the host's tokens (JAX's ``_splice_chain_tokens``
        and ``_splice_mapped_tokens``). No splice map there: every row's
        token is the host's."""
        if batch.splice is not None:
            dst, src = batch.splice
            batch.token_ids[dst] = prev.last[src]
        elif sched_batch.src_rows is None and not sched_batch.host_rows:
            batch.token_ids[:sched_batch.num_seqs].copy_(prev.last)

    @torch.inference_mode()
    def step_multi(self, chain, prev: Optional[StepHandle] = None
                   ) -> StepHandle:
        """Dispatch a block: the K links of ``chain``
        (``Scheduler.schedule_chain``, the same rows in each) as one
        device program, one CUDA graph replay on the card, keyed (T, S,
        max_q_len, pages, K, all_greedy, ondevice_finish, E). The first
        link is built and uploaded at the last link's signature, with
        each row's ``active_until`` (the sub-steps it is alive in) and,
        under on-device finish, its stop set ([S, E]) and arming sub-step;
        ``prev`` splices its input tokens as for a chained step. The
        handle carries the [K, n] tokens and each row's finish step by
        one copy to the host. The int8 cache's scale resets of the pages
        minted for every link run once, before the replay."""
        K = len(chain)
        first = chain[0]
        assert all(it.num_new_tokens == 1 for it in first.items)
        assert self.graphs is not None, "blocks form only with graphs on"
        sig = self.builder.shape_signature(chain[-1])
        host_batch, _, sig_q = self._host_batch(first, sig)
        t, s, _, p = sig
        n = first.num_seqs
        au = np.zeros(s, np.int32)
        au[:n] = (first.active_until if first.active_until is not None
                  else K)
        odf = self.config.ondevice_finish
        stop_ids = stop_from = None
        if odf:
            stop_ids, stop_from = self.builder.stop_sets(
                first.items, s, self.eos_token_ids)
        e = 0 if stop_ids is None else stop_ids.shape[1]
        host_batch = host_batch._replace(
            active_until=au, sampling=host_batch.sampling._replace(
                stop_ids=stop_ids, stop_from=stop_from))
        self.block_counts["block"] += 1
        all_greedy = all(it.seq.sampling_params.temperature == 0.0
                         for it in first.items)
        key = ("block", t, s, sig_q, p, K, all_greedy, odf, e)

        def body(generator, graph=None):
            return self._block_body(batch, K, all_greedy, odf, generator,
                                    graph)

        if self.graphs.cuda and key not in self.graphs:
            pad = self.builder.padding(t, s, p)
            batch = self.staging.upload(pad._replace(
                active_until=np.zeros(s, np.int32),
                sampling=pad.sampling._replace(
                    stop_ids=(np.full((s, e), -1, np.int32) if e
                              else None),
                    stop_from=np.zeros(s, np.int32) if e else None)))
            self._capture(key, body, sampled=not all_greedy, substeps=K)
        batch = self.staging.upload(host_batch)
        if prev is not None:
            self._splice(batch, first, prev)
        self._prologue(batch)
        out = self.graphs.run(key, body)
        return self._handle(out[:, :n], block=key)

    def _capture(self, key, body, **kw) -> None:
        """Capture ``key``'s graph. One first met while serving (outside
        ``warmup``) is logged with its capture time: every stream waits
        for it."""
        t0 = time.monotonic()
        self.graphs.capture(key, body, **kw)
        if not self._warming:
            logger.info("graph %s captured while serving in %.3f s", key,
                        time.monotonic() - t0)

    def _block_body(self, batch, K: int, all_greedy: bool, odf: bool,
                    generator, graph) -> torch.Tensor:
        """K sub-steps over the staged views → [K + 1, S]: each sub-step's
        tokens, then each row's finish step (JAX's ``step_multi`` body,
        ``runner.py:1381-1481``). Sub-step k advances each row by
        min(k, alive_n) from its staged position and context; a dead row
        (k >= alive_n) writes its KV to the dummy page 0. Under on-device
        finish a live row whose token is in its armed stop set gets
        alive_n = k + 1, and sub-steps 1.. run only while some row is
        alive: each inside a CUDA-graph conditional (IF) node on that flag
        when ``graph`` is being captured (``DecodeGraphs.if_node``), the
        flag read on the host on the CPU (on the card uncaptured, the
        warm-up run, every sub-step runs, on the IF bodies' stream).
        Alive counts only fall, so once the flag is false it stays false.
        Buffers that outlive a sub-step are made before the first one and
        written in place."""
        page = self.config.cache.page_size
        out = torch.zeros((K + 1,) + tuple(batch.token_ids.shape),
                          dtype=torch.int32, device=batch.token_ids.device)
        alive_n = out[K]
        alive_n.copy_(batch.active_until)
        tokens = batch.token_ids
        cuda = self.device.type == "cuda"
        flags = []
        for k in range(K):
            region = contextlib.nullcontext()
            if odf and k > 0:
                if not cuda:
                    if not bool((alive_n > k).any()):
                        break
                elif graph is not None:
                    flags.append((alive_n > k).any())
                    region = self.graphs.if_node(flags[-1])
                else:
                    region = self.graphs.on_body_stream()
            with region:
                tokens = self._sub_step(batch, tokens, alive_n, out, k,
                                        all_greedy, odf, generator, page)
        return out

    def _sub_step(self, batch, tokens, alive_n, out, k: int,
                  all_greedy: bool, odf: bool, generator,
                  page: int) -> torch.Tensor:
        """Sub-step k of a block (``_block_body``): its tokens land in
        ``out[k]``, which it returns as the next sub-step's input."""
        pos0, kv0 = batch.positions, batch.attn.kv_lens
        table = batch.attn.page_table
        adv = torch.clamp(alive_n, max=k)
        pos = pos0 + adv
        page_idx = torch.gather(table, 1, (pos // page)[:, None]
                                .long())[:, 0]
        slots = torch.where(alive_n > k, page_idx * page + pos % page,
                            0)
        sub = batch._replace(
            token_ids=tokens, positions=pos, slot_mapping=slots,
            attn=batch.attn._replace(kv_lens=kv0 + adv))
        toks = sample(self._forward(sub, 1), sub.sampling, generator,
                      all_greedy=all_greedy)
        if odf:
            hit = stop_token_hit(toks, sub.sampling, k) & (alive_n > k)
            alive_n.masked_fill_(hit, k + 1)
        out[k].copy_(toks)
        return out[k]

    def _handle(self, tokens: torch.Tensor, block=None) -> StepHandle:
        """Start the copy of a step's tokens to the host."""
        if self.device.type != "cuda":
            return StepHandle(tokens, tokens, None, block)
        host = torch.empty(tokens.shape, dtype=tokens.dtype,
                           pin_memory=True)
        host.copy_(tokens, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return StepHandle(tokens, host, event, block)

    def collect(self, handle: StepHandle) -> np.ndarray:
        """The sampled token of each batch item: waits for the copy out. A
        block's [K + 1, n] (each sub-step's tokens, then each row's finish
        step): its executed sub-steps (the latest finish step) are
        counted here, and on the card the kernels they launched."""
        if handle.event is not None:
            handle.event.synchronize()
        host = handle.host.numpy()
        if handle.block is not None:
            k_exec = int(host[-1].max()) if host.shape[1] else 0
            self.block_counts["substeps"] += k_exec
            self.graphs.add_substeps(handle.block, k_exec)
        return host

    @property
    def num_shape_signatures(self) -> int:
        """Distinct decode signatures captured so far (on the CPU: met),
        ``warmup``'s included."""
        return len(self.graphs) if self.graphs is not None else 0

    @property
    def block_len(self) -> int:
        """The longest block this runner dispatches: the largest power of
        two up to the chain length under overlap scheduling (1: no block;
        a hybrid model never fuses)."""
        multi = (self.config.multi_step_decode
                 if self.config.overlap_scheduling and not self.hybrid
                 else 1)
        return 1 << (multi.bit_length() - 1)

    def warmup(self, decode_buckets=None, page_buckets=None,
               block_buckets=None) -> None:
        """Capture the hot decode signatures before serving (JAX's
        ``warmup``, ``runner.py:1849-1947``, which stands for the
        reference's CUDA-graph capture loop): every sequence bucket at the
        largest page bucket and the largest sequence bucket at every page
        bucket, each for greedy and for sampled rows, by running a decode
        step of throwaway sequences. Their pages are all the dummy page 0
        and their GDN slot the dummy slot 0, so no page or slot a sequence
        holds (nor a prefix-cached page) is written; the step counts, the
        launch counters, the generator and the memory manager's queues
        come out as they were. Mixed steps run eagerly and need no
        warmup. Where blocks form, it also captures the longest block
        (``block_len``) for greedy rows at each of ``block_buckets``
        (sequence buckets, by default the decode ones) at the largest
        page bucket, with the stop-set width the engine's EOS ids give
        under on-device finish; other blocks are captured at first
        sight. With ``enforce_eager`` there is nothing to capture."""
        if self.graphs is None:
            return
        page = self.config.cache.page_size
        combos = graphs.warmup_combos(
            min(self.config.scheduler.max_decode_seqs, self.builder.max_seqs),
            self.config.max_pages_per_seq, self.num_pages, decode_buckets,
            page_buckets)
        steps, counts = dict(self.step_counts), graphs.launch_counts()
        blocks = dict(self.block_counts)
        rng = self.generator.get_state()
        t0 = time.monotonic()
        self._warming = True
        try:
            for nseq, npages in combos:
                ctx = npages * page - 1       # context filling npages pages
                for temp in (0.0, 1.0):
                    items = []
                    for i in range(nseq):
                        seq = Sequence(i, [1] * (ctx + 1),
                                       SamplingParams(temperature=temp,
                                                      max_tokens=4))
                        seq.page_table = [0] * npages
                        seq.num_computed_tokens = ctx
                        items.append(ScheduledSeq(seq, 1, ctx))
                    self.step(ScheduledBatch(items))
            K = self.block_len
            if K > 1:
                npages = combos[0][1]
                for nseq in (block_buckets or sorted({
                        s for s, p in combos if p == npages})):
                    self._warm_block(nseq, npages, K)
        finally:
            self._warming = False
            self.step_counts.update(steps)
            self.block_counts.update(blocks)
            graphs.set_launch_counts(counts)
            self.generator.set_state(rng)
        logger.info("warmup: %d decode combos, %d signatures, %.2f s",
                    len(combos), self.num_shape_signatures,
                    time.monotonic() - t0)

    def _warm_block(self, nseq: int, npages: int, K: int) -> None:
        """One greedy block of K links over ``nseq`` throwaway sequences
        whose ``npages`` pages are all the dummy page 0; they carry the
        engine's EOS ids under on-device finish, so the block has the
        stop-set width real traffic gives."""
        page = self.config.cache.page_size
        ctx = max(0, npages * page - K)
        seqs = []
        for i in range(nseq):
            seq = Sequence(i, [1] * (ctx + 1), SamplingParams(
                temperature=0.0, max_tokens=K + 1,
                ignore_eos=not self.eos_token_ids))
            seq.page_table = [0] * npages
            seq.num_computed_tokens = ctx
            seqs.append(seq)
        self.collect(self.step_multi([
            ScheduledBatch([ScheduledSeq(seq, 1, ctx + j) for seq in seqs])
            for j in range(K)]))
