"""ModelRunner: owns the parameters, the KV cache and the step (counterpart
of ``gllm_tpu/runner/runner.py``: ``ModelRunner.__init__:273``,
``reset_page_scales:136``, ``_kv_bytes_per_page:570``,
``determine_num_pages:614``, ``_build_step_fn:650``,
``_apply_scale_resets:923``, ``step:1845``; the hybrid slot pool
``:414-433``, ``_ssm_pool_bytes:603``).

A step: build the batch on the host, copy it over in one transfer into
the runner's one device buffer, run forward → logits → sample, and copy
the sampled tokens out. ``step_async`` dispatches it and returns a handle;
``collect`` waits for its tokens (the only wait); ``step`` is the two in
a row. ``step_async_chained`` dispatches a step whose input tokens are an
earlier handle's sampled tokens, spliced in on the device (overlap
scheduling, ``gllm_tpu/runner/runner.py:1114-1289``). With
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
from gllm_tpu_torch.ops.sampling import sample
from gllm_tpu_torch.runner import graphs
from gllm_tpu_torch.runner.prepare import BatchBuilder, HostStaging
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


class StepHandle(NamedTuple):
    """A dispatched step's sampled tokens: ``tokens``, the handle's own
    copy on the device (what a chained step splices from; never a graph's
    output, which the key's next replay overwrites), ``host``, their
    copy on the way to the host (pinned on CUDA), and ``event``, recorded
    after that copy (None on the CPU)."""
    tokens: torch.Tensor
    host: torch.Tensor
    event: Optional[torch.cuda.Event]


class ModelRunner:
    def __init__(self, config: EngineConfig, model_cfg: ModelConfig,
                 device: torch.device, params=None):
        config.validate(model_cfg)
        self.config = config
        self.model_cfg = model_cfg
        self.model = get_model_def(model_cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_model_shapes(model_cfg, config.cache.kv_cache_dtype,
                               config.unified_step)
        self.dtype = DTYPES[config.dtype]
        kd = config.cache.kv_cache_dtype
        self.kv_dtype = self.dtype if kd == "auto" else DTYPES[kd]
        self.kv_quant = self.kv_dtype == torch.int8
        # attention kernels (ops/attention.py): the unified kernel for every
        # step, or the legacy decode / ragged pair
        self.attn_impl = "unified" if config.unified_step else "legacy"
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
                "gllm_tpu_torch loads no checkpoint yet: use "
                "load_format='dummy' or pass params")
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
        # then room for every page's scale reset, every slot's zeroing and
        # a re-form's splice map; a pinned host buffer for each step that
        # can be in flight, and one more
        b = self.builder
        self.staging = HostStaging(self.device, capacity=(
            b.upload_size(b.max_tokens, b.max_seqs, b.max_pages_per_seq)
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
        the decode graphs' pool at the largest sequence bucket."""
        rows = self.builder.max_seqs
        headroom = ACTIVATION_HEADROOM
        if self.hybrid:
            cells = hybrid.max_gdn_cells(
                rows, min(self.config.scheduler.max_prefill_tokens,
                          self.config.max_model_len))
            headroom += hybrid.gdn_transient_bytes(self.model_cfg, cells,
                                                   rows)
        if not self.config.enforce_eager:
            headroom += (GRAPH_POOL_LOGIT_COPIES * rows
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
        # blocks the caching allocator holds unused (the weight init's
        # temporaries) count as free
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(self.device)
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

    def _host_batch(self, sched_batch: ScheduledBatch):
        """(host StepBatch, max_q_len, signature's max_q_len): built on the
        host with the int8 cache's pending scale resets and the hybrid
        model's slots to zero. A pure-decode batch gets max_q_len 1 in
        both loops: under the unified step it tells the kernel the batch
        has no other rows (its signature keeps JAX's q == t)."""
        host_batch, sig_q = self.builder.build(sched_batch)
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

    def step(self, sched_batch: ScheduledBatch) -> np.ndarray:
        """Run one step; returns the sampled token of each batch item."""
        return self.collect(self.step_async(sched_batch))

    def step_async_chained(self, sched_batch: ScheduledBatch,
                           prev: StepHandle) -> StepHandle:
        """Dispatch a pure-decode step whose input tokens are ``prev``'s
        sampled tokens on the device: row i's for a chained step, row
        ``src_rows[i]``'s for a re-formed batch (-1: the host's token)."""
        if sched_batch.src_rows is None:
            assert len(prev.tokens) == sched_batch.num_seqs
        return self.step_async(sched_batch, prev)

    @torch.inference_mode()
    def step_async(self, sched_batch: ScheduledBatch,
                   prev: Optional[StepHandle] = None) -> StepHandle:
        """Dispatch one step: the host builds and stages it, enqueues the
        copy in, the forward and sampling (one graph replay for a
        pure-decode step) and the copy of the tokens out, and returns
        without waiting for the device. A new decode signature is captured
        first, which waits for the device once. With ``prev``, the input
        tokens are spliced from ``prev``'s (``step_async_chained``)."""
        host_batch, max_q, sig_q = self._host_batch(sched_batch)
        if sched_batch.src_rows is not None:
            # a re-formed batch is pure decode: item j is token row j
            dst = [j for j, r in enumerate(sched_batch.src_rows) if r >= 0]
            src = [r for r in sched_batch.src_rows if r >= 0]
            host_batch = host_batch._replace(splice=dst + src)
        decode = host_batch.max_seq_q == 1
        self.step_counts["decode" if decode else "mixed"] += 1
        all_greedy = all(it.seq.sampling_params.temperature == 0.0
                         for it in sched_batch.items)
        graphed = decode and self.graphs is not None
        if graphed:
            t = host_batch.token_ids.size
            s, p = host_batch.attn.page_table.shape
            key = (t, s, sig_q, p, all_greedy)

            def body(generator):
                logits = self._forward(batch, 1)
                return sample(logits, batch.sampling, generator,
                              all_greedy=all_greedy)

            if self.graphs.cuda and key not in self.graphs:
                # captured over padding rows staged at the same views
                batch = self.staging.upload(self.builder.padding(t, s, p))
                self.graphs.capture(key, body, sampled=not all_greedy)
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
        splice map for a re-formed batch (JAX's ``_splice_chain_tokens``
        and ``_splice_mapped_tokens``)."""
        if sched_batch.src_rows is None:
            batch.token_ids[:sched_batch.num_seqs].copy_(prev.tokens)
        elif batch.splice is not None:
            dst, src = batch.splice
            batch.token_ids[dst] = prev.tokens[src]

    def _handle(self, tokens: torch.Tensor) -> StepHandle:
        """Start the copy of a step's tokens to the host."""
        if self.device.type != "cuda":
            return StepHandle(tokens, tokens, None)
        host = torch.empty(tokens.shape, dtype=tokens.dtype,
                           pin_memory=True)
        host.copy_(tokens, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return StepHandle(tokens, host, event)

    @staticmethod
    def collect(handle: StepHandle) -> np.ndarray:
        """The sampled token of each batch item: waits for the copy out."""
        if handle.event is not None:
            handle.event.synchronize()
        return handle.host.numpy()

    @property
    def num_shape_signatures(self) -> int:
        """Distinct decode signatures captured so far (on the CPU: met),
        ``warmup``'s included."""
        return len(self.graphs) if self.graphs is not None else 0

    def warmup(self, decode_buckets=None, page_buckets=None) -> None:
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
        warmup. With ``enforce_eager`` there is nothing to capture."""
        if self.graphs is None:
            return
        page = self.config.cache.page_size
        combos = graphs.warmup_combos(
            min(self.config.scheduler.max_decode_seqs, self.builder.max_seqs),
            self.config.max_pages_per_seq, self.num_pages, decode_buckets,
            page_buckets)
        steps, counts = dict(self.step_counts), graphs.launch_counts()
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
        finally:
            self._warming = False
            self.step_counts.update(steps)
            graphs.set_launch_counts(counts)
            self.generator.set_state(rng)
        logger.info("warmup: %d decode combos, %d signatures, %.2f s",
                    len(combos), self.num_shape_signatures,
                    time.monotonic() - t0)
