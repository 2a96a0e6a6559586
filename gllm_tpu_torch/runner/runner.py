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
(one CUDA graph, captured at the longest block and replayed by every
shorter one), whose rows that die inside it freeze, and which stops
early once every row has finished. Speculative decoding: a step with
prompt-lookup drafts verifies them in its own forward (``spec_aux``: the
verify rows' logits only, then ``spec_verify``); ``step_spec_multi``
dispatches a fused spec block, K draft+verify sub-steps over an on-device
token ring as one CUDA graph, whose state passes from block to block in
the handle. With ``EngineConfig.enforce_eager`` off (the default, as in
the JAX package), every step on CUDA replays the CUDA graph of its key,
captured at first sight or by ``warmup`` (``runner/graphs.py``, where JAX
compiles one program per signature): a pure-decode step, a mixed step (a
prefill chunk, chunks with decode rows, an absorb) and a host-driven
verify step alike, with or without extras. What stays op by op: a hybrid
model's mixed step (A 9), and every step under ``enforce_eager``. On the
CPU the same static-buffer body runs uncaptured.
The model family (dense, DeepSeek's MLA + MoE, or the hybrid GDN family)
comes from ``models/registry.py``. A hybrid model keeps its GDN state in
slot pools of ``1 + max_num_seqs`` slots (slot 0: the padding dummy);
the slots freed since the last step ride the step's one upload and are
zeroed (``index_fill_``) before its forward.
The KV cache is updated in place where JAX donated its buffers. An int8
cache first zeroes the scales of the pages minted for the step (their ids
ride the step's one upload), so a recycled page quantizes like a fresh one.
Both of these run eagerly before a replay, as does a re-formed batch's
token splice: their lists change length from step to step.
A step whose batch carries penalties, logit_bias, logprobs or prompt
logprobs (``BatchBuilder.batch_extras``; counted as an "extras" step when
it is pure decode) takes its kind's extras key, JAX's static flags
(``_lp_flags``, ``runner.py:972-986``) folded so that no key follows a
sequence's length, a bias count or a top-N: "adjust" (penalties or
logit_bias: the logits adjusted, JAX's ``adjust_logits``; a verify
step's by ``spec_adjust_logits``, JAX's ``spec_aux``), "lp" (some row
asks for logprobs: those of the sampled tokens, ``lp``, and of a verify
step's tokens, ``spec_lp``, always at the widest top-N a request may ask,
``LP_TOP``, which the host cuts to each row's) and "plp" (a prompt chunk
asks for its prompt logprobs, over row slices). The extras ride the one
upload at widths no batch changes (``HostStaging``), and the logprobs
are the graph's outputs beside the tokens, on their way to the host with
them (``ModelRunner.aux``). Seeded rows ride every graph: each sampled
body launches the seeded-Gumbel kernel over its rows, a block advances
each row's output index a sub-step, and a spec block carries it in its
state. Every sampled body's mask takes JAX's bounded top-k fast path,
whose branch is a conditional node of the graph (``DecodeGraphs.select``).
Each dispatch leaves its host walls (build, dispatch), its KV read
estimate and, for an eager step, why it ran op by op in ``last_phases``
for the engine's step event, counts its sampler variant and records a "compile"
step-trace event the first time its signature is met (JAX's
``_note_kv_read`` and ``_note_dispatch``, ``runner.py:936-969``), all on
the host.
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
from gllm_tpu_torch.obs import metrics as obs
from gllm_tpu_torch.obs.steptrace import TRACE
from gllm_tpu_torch.ops.cuda.common import check_model_shapes
from gllm_tpu_torch.ops.cuda.decode_attention import split_geometry
from gllm_tpu_torch.ops.sampling import (TOPK_FAST_BOUND, PenaltyTokens,
                                         adjust_logits, compute_logprobs,
                                         counts_from_tokens, ngram_propose,
                                         ring_shift_in, sample,
                                         spec_adjust_logits, spec_verify,
                                         stop_token_hit)
from gllm_tpu_torch.runner import graphs
from gllm_tpu_torch.runner.prepare import (MAX_STOP_IDS, SEED_CARRY,
                                           SEED_SPLICE, SPEC_SEED_COLS,
                                           BatchBuilder, HostStaging)
from gllm_tpu_torch.sampling_params import SamplingParams
from gllm_tpu_torch.scheduler import ScheduledBatch, ScheduledSeq
from gllm_tpu_torch.sequence import HOLE_SEQ_ID, Sequence, SequenceStatus
from gllm_tpu_torch.utils import cdiv

logger = logging.getLogger(__name__)

# Dispatch-side metrics (the JAX runner's ``runner.py:44-66``, same names,
# labels and help; a new signature is a CUDA graph capture here): host
# counters on values the dispatch already has; nothing here is read from
# the device or enters a graph key
_M_SAMPLER = obs.counter(
    "gllm_sampler_program_total",
    "step dispatches by compiled sampler variant (greedy compiles the "
    "sampled branch away; see ops/sampling.sample)", ("program",))
_M_NEW_SHAPE = obs.counter(
    "gllm_jit_new_shape_signatures_total",
    "first dispatch of a (shape-bucket, static-flag) signature this "
    "process — an XLA compile unless the persistent cache held it")
# an info gauge naming the KV cache's storage dtype, and an estimate of
# the KV bytes attention reads a step (context tokens x a token's cache
# bytes over the layers): the decode bandwidth floor's numerator
_M_KV_DTYPE = obs.gauge(
    "gllm_kv_cache_dtype",
    "info gauge: 1 for the active paged-KV storage dtype", ("dtype",))
_M_KV_READ = obs.counter(
    "gllm_kv_bytes_read_total",
    "estimated KV cache bytes read by attention (context tokens x "
    "per-token cache bytes incl. int8 scales; per-device estimate)")

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}

# Device memory kept free for a step's activations at the largest batch
# shape (the JAX runner keeps the same 512 MB).
ACTIVATION_HEADROOM = 512 * 1024 * 1024
# The graphs' pools stay resident beside the eager steps' activations:
# the graphs' own pool and, once an IF node is captured, the IF bodies'
# pool. Each is sized by the largest sampled body at the largest sequence
# bucket, reckoned in float32 [rows, vocab] copies (logits, the mask's
# candidates and masks, noise; the fallback's sort values, int64 indices
# and the sort's scratch, probabilities, cumulative sums):
# tools/graph_pool_cost.py read, the largest keys captured first, at most
# 7.97 copies in the graphs' pool (bench.py's full profile; 3.1 in the
# sync loop and under the absorb flags), 18.65 / 19.93 in the bodies'
# pool where blocks form (their sub-steps, the mask's sort fallback
# nested in them: absorb / full profile) and 9.5 where it holds the
# mask's sort fallback alone (the sync loop), on the H100 (PERF.md); a
# hybrid model's graphs' pool also holds about two recurrent GDN states
# per row
GRAPH_POOL_LOGIT_COPIES = 9
GRAPH_POOL_BODY_COPIES = 21
GRAPH_POOL_FALLBACK_COPIES = 10
GRAPH_POOL_STATES_PER_ROW = 2
# a captured mixed step (dense and MLA families) keeps its forward's
# transients at the token bucket in the graphs' pool for the engine's
# life: reckoned as this many of its widest activation rows (the MLP's
# fused gate and up halves, or a token's routed experts' under MoE) a
# token of the bucket. tools/graph_pool_cost.py read the mixed keys,
# captured first, at 5.4 such rows for Llama-3.2-1B (386 MiB at T 2304),
# 5.0 at T 3328 and 6.4 for DeepSeek-V2-Lite (616 MiB) on the H100
# (PERF.md)
GRAPH_POOL_MIXED_ROWS = 7
# a step with extras keeps more [rows, vocab] float32 tensors alive than
# the plain sampled body: the occurrence counts (int32) and their float
# copy, the adjusted logits' intermediates, the logprobs' log-softmax (a
# prompt-logprob slice's logits and log-softmax over PLP_ROWS rows).
# tools/graph_pool_cost.py read 5.0 such copies of growth under the
# absorb flags (the extras keys at 256 rows after the plain ones), 0
# under the full profile (PERF.md)
GRAPH_POOL_EXTRAS_COPIES = 6
# a fused spec block's on-device recent-token ring, per row (JAX's
# ``SPEC_RING``): the n-gram lookup window of its drafting
SPEC_RING = 128
# prompt logprobs are computed over slices of this many rows: the logits
# of a whole prefill chunk ([T, V] float32, 1 GB at T 2048 and V 128256)
# and their log-softmax would not fit the activation headroom
PLP_ROWS = 256
# the top-N of every logprob a step computes: the most a request may ask
# (``SamplingParams.validate``); the host keeps each row's own N
LP_TOP = 20


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


class SpecLayout(NamedTuple):
    """Where a fused spec block's packed output keeps its parts: K links
    run of the K_cap sub-steps the graph holds, S rows (n real), K1 =
    spec_k + 1 tokens a verify row, the ring's width R. In order: tokens
    [K_cap, S, K1], emitted counts [K_cap, S], drafted, accepted and the
    draft length [S] each (what goes to the host), then the carried state:
    ring [S, R], its length, the last token, the position and the token
    budget [S] each."""
    K: int
    K_cap: int
    S: int
    K1: int
    R: int
    n: int

    @property
    def host_size(self) -> int:
        return self.K_cap * self.S * (self.K1 + 1) + 3 * self.S

    @property
    def size(self) -> int:
        return self.host_size + self.S * (self.R + 5)

    def split(self, out):
        """(tokens, counts, drafted, accepted, kcur, ring, rlen, last, pos,
        alive, ostep) views of a packed output (device or host)."""
        K, S, K1, R = self.K_cap, self.S, self.K1, self.R
        sizes = [K * S * K1, K * S, S, S, S, S * R, S, S, S, S, S]
        parts, o = [], 0
        for n in sizes:
            parts.append(out[o:o + n])
            o += n
        parts[0] = parts[0].reshape(K, S, K1)
        parts[1] = parts[1].reshape(K, S)
        if parts[5].shape[0] == S * R:      # the host's part has no state
            parts[5] = parts[5].reshape(S, R)
        return parts


class StepHandle(NamedTuple):
    """A dispatched step's sampled tokens: ``tokens``, the handle's own
    copy on the device (what a chained step splices from; never a graph's
    output, which the key's next replay overwrites), ``host``, their
    copy on the way to the host (pinned on CUDA), and ``event``, recorded
    after that copy (None on the CPU). A block's (``block``: its graph
    key) are [K + 1, n]: the tokens of each sub-step, then each row's
    finish step (the sub-steps in which it was alive). A verify step's
    (``spec`` the int spec_k + 1) are [n, 2 + spec_k + 1]: the sampled
    token, the accepted drafts, then the verify tokens. A fused spec
    block's (``spec`` its ``SpecLayout``) are its packed output, of which
    the host gets the part before the carried state. ``aux``: an eager
    step's logprobs by name ("lp", "plp", "spec_lp"; each the chosen
    logprob, the top ids and the top logprobs), on their way to the host
    with the tokens."""
    tokens: torch.Tensor
    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    block: Optional[tuple] = None
    spec: object = None
    aux: Optional[dict] = None

    @property
    def last(self) -> torch.Tensor:
        """The tokens a step chained off this one takes as input: a
        block's last sub-step's, a spec block's last emitted ones."""
        if isinstance(self.spec, SpecLayout):
            return self.spec.split(self.tokens)[7][:self.spec.n]
        if self.spec is not None:
            return self.tokens[:, 0]
        return self.tokens[-2] if self.block is not None else self.tokens


class ModelRunner:
    def __init__(self, config: EngineConfig, model_cfg: ModelConfig,
                 device: torch.device, params=None):
        config.validate(model_cfg)
        self.config = config
        self.model_cfg = model_cfg
        self.model = get_model_def(model_cfg)
        self.device = torch.device(device)
        # dispatch signatures met so far (graph keys, or eager signatures
        # under enforce_eager): a first sighting is a "compile" event
        self._seen_sigs: set = set()
        # the latest dispatch's host build / dispatch split (seconds) and
        # its KV read estimate (bytes), which the engine copies into the
        # entry it puts in flight (JAX's ``runner.py:353``)
        self.last_phases: dict = {}
        self._last_kv_read = 0
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
                                    use_ssm=self.hybrid,
                                    vocab_size=model_cfg.vocab_size)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        # steps by batch: "decode" when every row has one new token, else
        # "mixed" (a prefill chunk or a mix); "extras" a pure-decode step
        # with penalties, logit_bias or logprobs (its "decode_extras" key).
        # The legacy kernels split decode and mixed the same way; the
        # unified kernel serves both.
        self.step_counts = {"mixed": 0, "decode": 0, "extras": 0}
        # the mixed steps (verify steps included) that ran eagerly, by
        # reason: a hybrid model's (A 9) or ``enforce_eager``; every other
        # one replays a graph, a step with extras too ("extras" stays 0
        # since the extras steps are captured)
        self.eager_mixed = {"extras": 0, "hybrid": 0, "enforce_eager": 0}
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
        # the weights every dispatch reads (each distinct tensor once): the
        # weight term of the HBM estimate; every expert and the whole
        # embedding table count, as in JAX, so a MoE model's estimate
        # overstates what a step reads
        self.param_bytes = _tree_bytes(self.params)
        _M_KV_DTYPE.set(1, dtype=str(self.kv_dtype).replace("torch.", ""))
        # a context token's cache bytes over the layers, the KV read
        # estimate's unit
        self._kv_rd_tok_bytes = (self.kv_bytes_per_page()
                                 / config.cache.page_size)
        # one device buffer for every step: the largest step's fixed part,
        # a block's active_until and widest stop sets, a verify step's rows
        # and drafts or a spec block's seed, the extras, then room for
        # every page's scale reset, every slot's zeroing and a re-form's
        # splice map; a pinned host buffer for each step that can be in
        # flight, and one more
        b = self.builder
        self.staging = HostStaging(self.device, capacity=(
            b.upload_size(b.max_tokens, b.max_seqs,
                          b.max_pages_per_seq + b.spec_pages)
            + (b.spec_size(b.max_seqs, SPEC_RING)
               if config.spec_decode else 0)
            + b.max_seqs * (2 + MAX_STOP_IDS)
            + b.extras_size(b.max_tokens, b.max_seqs)
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
        the graphs' pools at the largest sequence bucket (their own and,
        where blocks stop early or the mask's fast path falls back to its
        sort, the IF bodies': ``graph_pool_copies``), what the extras
        keys add there (``extras_pool_bytes``) and, but for a hybrid
        model, what its captured mixed steps keep there at the token
        bucket (``mixed_pool_bytes``)."""
        rows = self.builder.max_seqs
        headroom = ACTIVATION_HEADROOM
        if self.hybrid:
            cells = hybrid.max_gdn_cells(
                rows, min(self.config.scheduler.max_prefill_tokens,
                          self.config.max_model_len))
            headroom += hybrid.gdn_transient_bytes(self.model_cfg, cells,
                                                   rows)
        # a verify step scores spec_k + 1 rows a sequence: the eager
        # verify of host-driven speculation and the fused spec block each
        # hold that many rows of logits and their sampling transients
        spec = self.config.spec_decode is not None
        logit_rows = rows * (1 + self.config.spec_k) if spec else rows
        vocab = self.model_cfg.vocab_size
        if spec and not self.config.spec_fused:
            # the mask's transients and its sort fallback's, eagerly
            headroom += ((GRAPH_POOL_LOGIT_COPIES
                          + GRAPH_POOL_FALLBACK_COPIES)
                         * logit_rows * vocab * 4)
        if not self.config.enforce_eager:
            headroom += self.graph_pool_copies() * logit_rows * vocab * 4
            headroom += self.extras_pool_bytes()
            if self.hybrid:
                headroom += (GRAPH_POOL_STATES_PER_ROW * rows
                             * hybrid.ssm_pool_bytes(self.model_cfg, 1)
                             // self.model_cfg.num_linear_layers)
            else:
                headroom += self.mixed_pool_bytes()
        return headroom

    def graph_pool_copies(self) -> int:
        """The [rows, vocab] float32 copies the graphs' pools are
        reckoned to hold: the graphs' own pool's, and the IF bodies'
        where blocks form (a sub-step's transients, the mask's sort
        fallback nested in them) or the mask's fast path falls back to
        the sort (a vocabulary past its bound)."""
        copies = GRAPH_POOL_LOGIT_COPIES
        if self.block_len > 1:
            copies += GRAPH_POOL_BODY_COPIES
        elif self.model_cfg.vocab_size > TOPK_FAST_BOUND:
            copies += GRAPH_POOL_FALLBACK_COPIES
        return copies

    def extras_pool_bytes(self) -> int:
        """What the extras keys are reckoned to keep in the graphs' pool
        beyond the plain bodies: ``GRAPH_POOL_EXTRAS_COPIES`` [rows, V]
        float32 tensors, rows the most an extras step scores: a sequence
        bucket's, spec_k + 1 a sequence for a host-driven verify step
        (under fused speculation extras rows ride single steps), and at
        least a prompt-logprob slice's ``PLP_ROWS``."""
        b = self.builder
        spec = self.config.spec_decode and not self.config.spec_fused
        rows = max(b.max_seqs * (1 + b.spec_k if spec else 1), PLP_ROWS)
        return (GRAPH_POOL_EXTRAS_COPIES * rows * self.model_cfg.vocab_size
                * 4)

    def mixed_pool_bytes(self) -> int:
        """What the captured mixed steps are reckoned to keep in the
        graphs' pool: ``GRAPH_POOL_MIXED_ROWS`` rows of the widest
        activation at the model dtype for each token of the largest token
        bucket."""
        cfg = self.model_cfg
        width = max(cfg.hidden_size, 2 * cfg.intermediate_size,
                    2 * cfg.num_experts_per_tok * cfg.moe_intermediate_size)
        return (GRAPH_POOL_MIXED_ROWS * self.builder.max_tokens * width
                * self.dtype.itemsize)

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
        pages = graphs.pow2_range(4, b.max_pages_per_seq)
        if b.spec_pages:
            pages += (b.max_pages_per_seq + b.spec_pages,)
        return max(split_geometry(s, p, cfg.num_heads, hkv, d,
                                  self.config.cache.page_size, self.dtype,
                                  self.kv_dtype, self.device, v_dim)[2]
                   for s in graphs.pow2_range(8, b.max_seqs)
                   for p in pages)

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
        # the forward takes the signature's max_q_len, never the live
        # batch's: for the dense and MLA families it only picks the decode
        # path (1: the decode kernel, or the unified kernel's decode blocks
        # alone) or the ragged one (ops/attention.py), so one graph key
        # serves every batch of its signature
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
        hidden, residual = self._hidden(batch, max_q)
        return self.model.compute_logits(self.params, hidden, residual,
                                         batch, self.model_cfg)

    def _hidden(self, batch, max_q: int):
        return self.model.forward(self.params, self.kv, batch,
                                  self.model_cfg, cos_sin=self.cos_sin,
                                  max_q_len=max_q, impl=self.attn_impl)

    def _step_body(self, batch, max_q: int, all_greedy: bool,
                   lp: bool = False, plp: bool = False,
                   spec_sampled: Optional[bool] = None, generator=None,
                   select=None):
        """A step over adjusted logits (JAX's step body with its
        ``lp_aux`` and, with drafts, ``spec_aux``, ``runner.py:211-237,
        656-678``): forward, each row's sampled token and the requested
        logprobs (``lp``: the sampled tokens', ``plp``: the prompt's, each
        at the top ``LP_TOP``); a step with drafts (``spec_sampled`` not
        None: some drafted row samples, ``_spec_sampled``; else the
        argmax-only verify) also verifies them over the verify rows'
        logits alone (never [T, V]), adjusted with the draft prefixes'
        counts. → (tokens [S] or, with drafts, [S, 2 + K1]: the sampled
        token, the accepted drafts, then the verify tokens; the aux
        dict). The logits are adjusted where the batch stages penalty ids
        (an "adjust" key: its penalties and logit_bias pairs, neutral in
        rows without), the occurrence counts built once. Draws from
        ``generator`` (default: the runner's); ``select``: the mask fast
        path's branch (a graph's conditional node; None: read on the
        host)."""
        generator = generator if generator is not None else self.generator
        hidden, residual = self._hidden(batch, max_q)
        md = batch.sampling
        logits = self.model.compute_logits(self.params, hidden, residual,
                                           batch, self.model_cfg)
        counts = None
        if batch.penalty_ids is not None:
            counts = counts_from_tokens(PenaltyTokens(
                torch.clamp(batch.penalty_ids, min=0),
                batch.penalty_ids >= 0), logits.shape[-1])
            logits = adjust_logits(logits, counts, md)
        tokens = sample(logits, md, generator, all_greedy=all_greedy,
                        adjusted=True, select=select)
        aux = {}
        if lp:
            # the sampled tokens' logprobs over the adjusted distribution
            aux["lp"] = compute_logprobs(logits, tokens, LP_TOP)
        if plp:
            aux["plp"] = self._prompt_logprobs(hidden, residual,
                                               batch.plp_targets, LP_TOP)
        if spec_sampled is None:
            return tokens, aux
        S, K1 = batch.spec_rows.shape
        verify = self.model.compute_logits(
            self.params, hidden, residual,
            batch._replace(logits_indices=batch.spec_rows.reshape(-1)),
            self.model_cfg)
        adjusted = spec_adjust_logits(verify.view(S, K1, -1),
                                      batch.spec_drafts, md, counts)
        tok_mat, accept = spec_verify(adjusted, batch.spec_drafts, md,
                                      generator, sampled=spec_sampled,
                                      select=select)
        if lp:
            aux["spec_lp"] = tuple(
                x.reshape((S, K1) + x.shape[1:]) for x in compute_logprobs(
                    adjusted.reshape(S * K1, -1), tok_mat.reshape(-1),
                    LP_TOP))
        return torch.cat([tokens[:, None], accept[:, None], tok_mat], 1), aux

    def _prompt_logprobs(self, hidden, residual, targets, top: int):
        """Every row's logprob of its target token and its top ``top``,
        over row slices of ``PLP_ROWS`` (the rows are independent, so the
        slices change nothing but the memory a step holds)."""
        parts = []
        for a in range(0, hidden.shape[0], PLP_ROWS):
            b = a + PLP_ROWS
            full = self.model.compute_full_logits(
                self.params, hidden[a:b], residual[a:b], self.model_cfg)
            parts.append(compute_logprobs(full, targets[a:b], top))
        return tuple(torch.cat(x) for x in zip(*parts))

    @staticmethod
    def _lp_flags(sched_batch: ScheduledBatch):
        """(logprobs_k, prompt_lp) of a batch (JAX's ``_lp_flags``,
        ``runner.py:972-986``): the widest top-N it asks for (-1: no
        logprobs), a prompt chunk's prompt_logprobs included, and whether
        some row scores its prompt."""
        k, want_plp = -1, False
        for it in sched_batch.items:
            sp = it.seq.sampling_params
            if sp.logprobs is not None:
                k = max(k, sp.logprobs)
            if (sp.prompt_logprobs is not None
                    and it.computed_before < it.seq.prompt_len):
                # only prompt chunks pay the prompt logprobs' top-N
                k = max(k, sp.prompt_logprobs)
                want_plp = True
        return k, want_plp

    def _note_kv_read(self, items, steps: int = 1) -> None:
        """The KV bytes this dispatch's attention reads (JAX's
        ``_note_kv_read``): each row its whole context after this step's
        writes, a K-step block the growing context every sub-step. Host
        arithmetic on scheduler counts; kept for ``last_phases``."""
        tok_bytes = self._kv_rd_tok_bytes
        ctx = sum(it.computed_before + it.num_new_tokens for it in items)
        grow = len(items) * steps * (steps - 1) // 2
        self._last_kv_read = int((ctx * steps + grow) * tok_bytes)
        _M_KV_READ.inc(self._last_kv_read)

    def _note_dispatch(self, kind: str, sig: tuple, t: int, s: int, p: int,
                       all_greedy: bool) -> None:
        """Host dispatch bookkeeping (JAX's ``_note_dispatch``): the
        sampler-variant counter, and a "compile" event on the first
        sighting of a signature ``sig`` (a graph key, whose capture on the
        card happens now, or an eager step's signature), with its padded
        token, sequence and page counts."""
        _M_SAMPLER.inc(program="greedy" if all_greedy else "sampled")
        if sig not in self._seen_sigs:
            self._seen_sigs.add(sig)
            _M_NEW_SHAPE.inc()
            TRACE.record("compile", dispatch=kind, tokens_pad=int(t),
                         seqs_pad=int(s), pages_pad=int(p), flags=repr(sig))

    def _set_phases(self, t_enter: float, t_build: float,
                    eager: Optional[str] = None) -> None:
        """``last_phases``: build (the host batch and its key), dispatch (a
        first-sight capture, the upload, the launch and the copy out), the
        KV read estimate, and, for an eager step, why it ran op by op
        (``eager_mixed``'s reasons): the card works through such a body
        while the host enqueues it, so the engine's device wall, taken
        from the call's return as JAX's is, misses that part of it."""
        self.last_phases = {"build": t_build - t_enter,
                            "dispatch": time.monotonic() - t_build,
                            "kv_bytes": self._last_kv_read}
        if eager is not None:
            self.last_phases["eager"] = eager

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
        promised decode rows, an absorb): it replays the graph of its
        mixed key at the unified signature's one token bucket, the splice
        running before the replay, as every mixed step does."""
        if sched_batch.src_rows is None:
            assert len(prev.last) == sched_batch.num_seqs
        return self.step_async(sched_batch, prev)

    @torch.inference_mode()
    def step_async(self, sched_batch: ScheduledBatch,
                   prev: Optional[StepHandle] = None,
                   force_signature=None) -> StepHandle:
        """Dispatch one step: the host builds and stages it, enqueues the
        copy in, the forward and sampling (one graph replay) and the copy
        of the tokens out, and returns without waiting for the device. A
        new signature is captured first, which waits for the device once.
        With ``prev``, the input tokens are spliced from ``prev``'s
        (``step_async_chained``). A pure-decode step replays its
        signature's graph; so do a mixed step (prefill chunks, with or
        without decode rows) and a host-driven verify step, keyed "mixed"
        and "verify" (``graphs.key_kind``); a step whose batch carries
        extras replays its kind's "_extras" key, which adds the flags
        (adjust, lp, plp) and whose logprobs come back with the handle. A
        hybrid model's mixed step runs eagerly (its GDN layer loops over
        row groups on the host), as does every step under
        ``enforce_eager``; the mixed ones among them are counted in
        ``eager_mixed`` by reason. ``last_phases`` gets the host build
        (the batch and its key) and dispatch (a first-sight capture, the
        upload, the launch and the copy out) walls."""
        t_enter = time.monotonic()
        host_batch, max_q, sig_q = self._host_batch(sched_batch,
                                                    force_signature)
        decode = host_batch.max_seq_q == 1
        all_greedy = _all_greedy(sched_batch.items)
        drafts = host_batch.spec_rows is not None
        spec_sampled = _spec_sampled(sched_batch.items) if drafts else None
        extras = self.builder.batch_extras(sched_batch)
        lp_k, plp = self._lp_flags(sched_batch)
        # the extras flags: the staged adjustments (``BatchBuilder.build``)
        # and the logprobs
        flags = (host_batch.penalty_ids is not None, lp_k >= 0, plp)
        # a verify step is never pure decode: its drafted rows take more
        # than one token
        self.step_counts["extras" if extras and decode
                         else "decode" if decode else "mixed"] += 1
        eager = ("enforce_eager" if self.graphs is None
                 else "hybrid" if self.hybrid and not decode else None)
        k1 = int(host_batch.spec_rows.shape[1]) if drafts else 0
        t = host_batch.token_ids.size
        s, p = host_batch.attn.page_table.shape
        kind = "verify" if drafts else "decode" if decode else "mixed"
        key = (t, s, sig_q, p, all_greedy)
        if drafts:
            key += (k1, spec_sampled)
        if any(flags):
            kind += "_extras"
            key += flags
        if kind != "decode":
            key = (kind,) + key
        self._note_kv_read(sched_batch.items)
        self._note_dispatch("step", key if eager is None
                            else ("eager",) + key, t, s, p, all_greedy)
        t_build = time.monotonic()
        if eager is not None:
            if not decode:
                self.eager_mixed[eager] += 1
        else:

            def body(generator, graph=None):
                # max_q is the key's, never the live batch's
                # (``_host_batch``): it only picks the decode or ragged path
                return self._step_body(batch, max_q, all_greedy, *flags[1:],
                                       spec_sampled, generator, self._select)

            if self.graphs.cuda and key not in self.graphs:
                # captured over padding rows staged at the same views
                batch = self.staging.upload(self.builder.padding(
                    t, s, p, k1, adjust=flags[0], plp=plp))
                self._capture(key, body, sampled=not all_greedy)
        batch = self.staging.upload(host_batch)
        if prev is not None:
            self._splice(batch, sched_batch, prev)
        self._prologue(batch)
        if eager is None:
            out, aux = self.graphs.run(key, body)
        else:
            out, aux = self._step_body(batch, max_q, all_greedy, *flags[1:],
                                       spec_sampled)
        handle = self._handle(out[:sched_batch.num_seqs], aux=aux,
                              spec=k1 or None)
        self._set_phases(t_enter, t_build, eager)
        return handle

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
        max_q_len, pages, K_cap, all_greedy, ondevice_finish, E), where
        K_cap is ``block_len``: a block of fewer links replays the longest
        block's graph with every row's alive count capped at its K, and
        the sub-steps no row reaches are skipped (C 7: one graph for every
        K). The first link is built and uploaded at the last link's
        signature (pure decode: the pinned page bucket), with each row's
        ``active_until`` (the sub-steps it is alive in) and, under
        on-device finish, its stop set ([S, E]) and arming sub-step;
        ``prev`` splices its input tokens as for a chained step. The
        handle carries the [K, n] tokens and each row's finish step by
        one copy to the host. The int8 cache's scale resets of the pages
        minted for every link run once, before the replay."""
        t_enter = time.monotonic()
        K = len(chain)
        K_cap = max(K, self.block_len)
        first = chain[0]
        assert all(it.num_new_tokens == 1 for it in first.items)
        assert self.graphs is not None, "blocks form only with graphs on"
        sig = self.builder.shape_signature(chain[-1])
        host_batch, _, sig_q = self._host_batch(first, sig)
        t, s, _, p = sig
        n = first.num_seqs
        au = np.zeros(s, np.int32)
        au[:n] = np.minimum(first.active_until
                            if first.active_until is not None else K, K)
        odf = self.config.ondevice_finish
        stop_ids = stop_from = None
        if odf:
            stop_ids, stop_from = self._stop_sets(first.items, s)
        e = 0 if stop_ids is None else stop_ids.shape[1]
        host_batch = host_batch._replace(
            active_until=au, sampling=host_batch.sampling._replace(
                stop_ids=stop_ids, stop_from=stop_from))
        self.block_counts["block"] += 1
        all_greedy = _all_greedy(first.items)
        key = ("block", t, s, sig_q, p, K_cap, all_greedy, odf, e)
        self._note_kv_read(first.items, steps=K)
        self._note_dispatch("multi_step", key, t, s, p, all_greedy)
        t_build = time.monotonic()

        def body(generator, graph=None):
            return self._block_body(batch, K_cap, all_greedy, odf,
                                    generator, graph)

        if self.graphs.cuda and key not in self.graphs:
            pad = self.builder.padding(t, s, p)
            batch = self.staging.upload(pad._replace(
                active_until=np.zeros(s, np.int32),
                sampling=pad.sampling._replace(
                    stop_ids=(np.full((s, e), -1, np.int32) if e
                              else None),
                    stop_from=np.zeros(s, np.int32) if e else None)))
            self._capture(key, body, sampled=not all_greedy,
                          substeps=K_cap)
        batch = self.staging.upload(host_batch)
        if prev is not None:
            self._splice(batch, first, prev)
        self._prologue(batch)
        out = self.graphs.run(key, body)
        if K < K_cap:
            out = torch.cat([out[:K], out[K_cap:]])
        handle = self._handle(out[:, :n], block=key)
        self._set_phases(t_enter, t_build)
        return handle

    def _stop_sets(self, items, s: int, absolute: bool = False):
        """A block's stop sets under on-device finish
        (``BatchBuilder.stop_sets``), at least the narrowest width (8)
        when no row has a stop id (every set empty), so that the width in
        a block's key does not depend on whether the rows ignore EOS
        (``warmup``'s blocks carry the engine's EOS ids)."""
        stop_ids, stop_from = self.builder.stop_sets(
            items, s, self.eos_token_ids, absolute=absolute)
        if stop_ids is None:
            stop_ids = np.full((s, 8), -1, np.int32)
            stop_from = np.full(s, -(1 << 30) if absolute else 0, np.int32)
        return stop_ids, stop_from

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
        alive_n = k + 1. Sub-steps 1.. run only while some row is alive
        (alive counts are capped at the block's own length, so a shorter
        block stops there): each inside a CUDA-graph conditional (IF)
        node on that flag when ``graph`` is being captured
        (``DecodeGraphs.if_node``), the flag read on the host on the CPU
        (on the card uncaptured, the warm-up run, every sub-step runs, on
        the IF bodies' stream). Alive counts only fall, so once the flag
        is false it stays false. Buffers that outlive a sub-step are made
        before the first one and written in place."""
        page = self.config.cache.page_size
        out = torch.zeros((K + 1,) + tuple(batch.token_ids.shape),
                          dtype=torch.int32, device=batch.token_ids.device)
        alive_n = out[K]
        alive_n.copy_(batch.active_until)
        tokens = batch.token_ids
        cuda = self.device.type == "cuda"
        flags = []
        for k in range(K):
            with self._sub_step_region(k, alive_n > k, cuda, graph,
                                       flags) as run:
                if not run:
                    break
                tokens = self._sub_step(batch, tokens, alive_n, out, k,
                                        all_greedy, odf, generator, page)
        return out

    @contextlib.contextmanager
    def _sub_step_region(self, k: int, live: torch.Tensor, cuda: bool,
                         graph, flags: list):
        """Where sub-step k of a block runs (``_block_body``,
        ``_spec_body``): sub-step 0 always; a later one inside an IF node
        on ``live.any()`` under capture, on the IF bodies' stream in the
        uncaptured warm-up run, and on the CPU only when some row is live
        (yields False otherwise: the caller stops)."""
        if k == 0:
            yield True
        elif not cuda:
            yield bool(live.any())
        elif graph is not None:
            flags.append(live.any())
            with self.graphs.if_node(flags[-1]):
                yield True
        else:
            with self.graphs.on_body_stream():
                yield True

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
        # a seeded row draws from (seed, out_step): advancing its output
        # index a sub-step keeps the block equal to K single seeded steps
        sub = batch._replace(
            token_ids=tokens, positions=pos, slot_mapping=slots,
            attn=batch.attn._replace(kv_lens=kv0 + adv),
            sampling=batch.sampling._replace(
                out_step=batch.sampling.out_step + k))
        toks = sample(self._forward(sub, 1), sub.sampling, generator,
                      all_greedy=all_greedy, select=self._select)
        if odf:
            hit = stop_token_hit(toks, sub.sampling, k) & (alive_n > k)
            alive_n.masked_fill_(hit, k + 1)
        out[k].copy_(toks)
        return out[k]

    # ---- fused speculation ------------------------------------------------

    @torch.inference_mode()
    def step_spec_multi(self, chain, prev: Optional[StepHandle] = None
                        ) -> StepHandle:
        """Dispatch a fused spec block (JAX's ``step_spec_multi``,
        ``runner.py:1662-1718``): the K links of a spec chain as K
        draft+verify sub-steps in one CUDA graph replay, keyed ("spec",
        S, pages, K_cap, spec_k, all_greedy, ondevice_finish, E), K_cap
        being ``block_len``; a shorter block stops at its K. Each row
        carries a state: a right-aligned ring of its last ``SPEC_RING``
        tokens, its last token, its position, its token budget
        (``active_until``) and its draft length. The first link is built at
        the pinned page bucket widened by ``spec_pages``, and each row's
        seed state rides the upload (``_spec_seed``); rows that chain off
        ``prev`` complete it on the device before the replay: off a spec
        block they take its carried state wholesale (the actual frontier,
        where the host scheduled upper bounds), off a single step they
        append its sampled token to the ring. The handle carries the
        tokens of every sub-step, the counts each row emitted, the drafts
        proposed and accepted and the draft lengths, by one copy to the
        host, and the carried state for the next block."""
        t_enter = time.monotonic()
        K = len(chain)
        K_cap = max(K, self.block_len)
        first = chain[0]
        assert first.spec_block and first.active_until is not None
        assert self.graphs is not None, "blocks form only with graphs on"
        b = self.builder
        t, s, sig_q, _ = b.shape_signature(chain[-1])
        p = b.max_pages_per_seq + b.spec_pages
        host_batch, _, _ = self._host_batch(first, (t, s, sig_q, p))
        n = first.num_seqs
        kd = self.config.spec_k
        stop_ids = stop_from = None
        if self.config.ondevice_finish:
            stop_ids, stop_from = self._stop_sets(first.items, s,
                                                  absolute=True)
        e = 0 if stop_ids is None else stop_ids.shape[1]
        host_batch = host_batch._replace(
            spec_seed=self._spec_seed(first, s, K, prev),
            sampling=host_batch.sampling._replace(stop_ids=stop_ids,
                                                  stop_from=stop_from))
        self.block_counts["block"] += 1
        all_greedy = _all_greedy(first.items)
        key = ("spec", t, s, sig_q, p, K_cap, kd, all_greedy,
               self.config.ondevice_finish, e)
        layout = SpecLayout(K, K_cap, s, kd + 1, SPEC_RING, n)
        self._note_kv_read(first.items, steps=K)
        self._note_dispatch("spec_block", key, t, s, p, all_greedy)
        t_build = time.monotonic()

        def body(generator, graph=None):
            return self._spec_body(batch, layout, all_greedy, generator,
                                   graph)

        if self.graphs.cuda and key not in self.graphs:
            pad = b.padding(t, s, p)
            batch = self.staging.upload(pad._replace(
                spec_seed=np.zeros((s, SPEC_RING + SPEC_SEED_COLS),
                                   np.int32),
                sampling=pad.sampling._replace(
                    stop_ids=(np.full((s, e), -1, np.int32) if e
                              else None),
                    stop_from=np.zeros(s, np.int32) if e else None)))
            self._capture(key, body, sampled=not all_greedy,
                          substeps=K_cap)
        batch = self.staging.upload(host_batch)
        if prev is not None:
            self._spec_splice(batch.spec_seed, prev, s)
        self._prologue(batch)
        out = self.graphs.run(key, body)
        handle = self._handle(out, block=key, spec=layout)
        self._set_phases(t_enter, t_build)
        return handle

    def _spec_seed(self, first: ScheduledBatch, s: int, K: int,
                   prev: Optional[StepHandle]) -> np.ndarray:
        """Each row's seed state on the host (JAX's ``_spec_seed_state``,
        ``runner.py:1720-1830``): [S, SPEC_RING + SPEC_SEED_COLS]. A row
        whose link-0 token the host knows (a chain root, a join) seeds
        from its committed tokens, the ring ending with that token; a row
        chained off a single step seeds with its committed tokens and is
        marked ``SEED_SPLICE`` (the step's device token goes in); off a
        spec block, ``SEED_CARRY`` (its state is the block's). A hole, a
        sequence the host has finished, and a padding row are dead (budget
        0). A seeded row's output index is that of the token its first
        sub-step samples (carried with the state off a spec block). The
        last column is the block's sub-step limit K."""
        R = SPEC_RING
        kd = self.config.spec_k
        seed = np.zeros((s, R + SPEC_SEED_COLS), np.int32)
        ring, rlen, last, pos, alive, kcur, ostep, mode, klim = (
            seed[:, :R], *seed[:, R:].T)
        ring[:] = -1
        kcur[:] = 1
        klim[:] = K
        carry = prev is not None and isinstance(prev.spec, SpecLayout)
        joins = set(first.host_rows or ())
        for i, it in enumerate(first.items):
            seq = it.seq
            if (seq.seq_id == HOLE_SEQ_ID
                    or seq.status is not SequenceStatus.RUNNING):
                continue                    # dead: budget 0
            cb = it.computed_before
            toks = seq.token_ids
            kcur[i] = min(seq.spec_k_cur or kd, kd)
            if seq.sampling_params.seed is not None:
                ostep[i] = cb + 1 - seq.prompt_len
            pos[i] = cb
            alive[i] = first.active_until[i]
            if cb < seq.num_tokens:
                # the host knows the link-0 token: the ring ends with it
                tail = toks[max(0, cb + 1 - R):cb + 1]
                last[i] = toks[cb]
            else:
                # it is the previous entry's, on the device
                tail = toks[max(0, len(toks) - R):]
                if i not in joins:
                    mode[i] = SEED_CARRY if carry else SEED_SPLICE
            ring[i, R - len(tail):] = tail
            rlen[i] = len(tail)
        return seed

    @staticmethod
    def _spec_splice(seed: torch.Tensor, prev: StepHandle, s: int) -> None:
        """Complete the staged seed on the device, after its upload and
        before the replay: ``SEED_CARRY`` rows take ``prev``'s carried
        spec state (ring, length, last token, position, budget, draft
        length and output index), ``SEED_SPLICE`` rows append ``prev``'s
        sampled token to their ring and take it as their last token."""
        R = SPEC_RING
        mode = seed[:, R + 6]
        if isinstance(prev.spec, SpecLayout):
            (_, _, _, _, kcur, ring, rlen, last, pos, alive,
             ostep) = prev.spec.split(prev.tokens)
            assert prev.spec.S == s, (prev.spec.S, s)
            carried = torch.cat([ring, torch.stack(
                [rlen, last, pos, alive, kcur, ostep], 1)], 1)
            take = (mode == SEED_CARRY)[:, None]
            seed[:, :R + 6] = torch.where(take, carried, seed[:, :R + 6])
            return
        tok = torch.zeros(s, dtype=torch.int32, device=seed.device)
        tok[:prev.last.shape[0]] = prev.last
        splice = mode == SEED_SPLICE
        ring, rlen = ring_shift_in(seed[:, :R], seed[:, R], tok[:, None],
                                   splice.to(torch.int32))
        seed[:, :R] = ring
        seed[:, R] = rlen
        seed[:, R + 1] = torch.where(splice, tok, seed[:, R + 1])

    def _spec_body(self, batch, layout: SpecLayout, all_greedy: bool,
                   generator, graph) -> torch.Tensor:
        """K_cap draft+verify sub-steps over the staged views → the packed
        output of ``layout`` (JAX's ``step_spec``, ``runner.py:1520-1652``).
        Sub-steps 1.. run only while some row has budget left and the
        block's limit is not reached, each in an IF node under capture
        (``_sub_step_region``). State that outlives a sub-step is made
        before the first one and written in place."""
        K_cap, S, K1, R = layout.K_cap, layout.S, layout.K1, layout.R
        seed = batch.spec_seed
        dev = seed.device
        out = torch.zeros(layout.size, dtype=torch.int32, device=dev)
        (toks, counts, drafted, accepted, kcur, ring, rlen, last, pos,
         alive, ostep) = layout.split(out)
        ring.copy_(seed[:, :R])
        rlen.copy_(seed[:, R])
        last.copy_(seed[:, R + 1])
        pos.copy_(seed[:, R + 2])
        alive.copy_(seed[:, R + 3])
        kcur.copy_(seed[:, R + 4])
        ostep.copy_(seed[:, R + 5])
        klim = seed[:, R + 7]
        # the verify batch's fixed parts: S rows of K1 tokens each, every
        # row's logits
        fixed = dict(
            cu=torch.arange(S + 1, dtype=torch.int32, device=dev) * K1,
            rows=torch.arange(S * K1, dtype=torch.int32, device=dev),
            iota=torch.arange(K1, dtype=torch.int32, device=dev)[None, :])
        cuda = self.device.type == "cuda"
        flags = []
        for k in range(K_cap):
            with self._sub_step_region(k, (alive > 0) & (klim > k), cuda,
                                       graph, flags) as run:
                if not run:
                    break
                self._spec_sub_step(batch, layout, out, k, fixed,
                                    all_greedy, generator)
        return out

    def _spec_sub_step(self, batch, layout: SpecLayout, out, k: int,
                       fixed: dict, all_greedy: bool, generator) -> None:
        """Sub-step k of a spec block (``_spec_body``): propose up to
        min(draft length, budget - 1) drafts a row from its ring, run the
        committed token and the drafts as one row of K1 tokens through the
        forward (the ragged class of K1/K1u/K1m/K1um), verify, and advance
        the row by what it emitted: the accepted run and the correction
        token, cut at its budget and, under on-device finish, after the
        first armed stop id in the run (which ends the row). Rows past a
        row's allowance, and every row of a dead one, write their KV to the
        dummy page 0. The draft length adapts in the block as on the host
        (AIMD: a clean sweep of the allowance adds one, else the accepted
        run); drafts proposed and accepted are counted over live rows."""
        S, K1 = layout.S, layout.K1
        kd = K1 - 1
        page = self.config.cache.page_size
        (toks, counts, drafted, accepted, kcur, ring, rlen, last, pos,
         alive, ostep) = layout.split(out)
        iota = fixed["iota"]
        table = batch.attn.page_table
        live = alive > 0
        allow = torch.clamp(torch.minimum(kcur, alive - 1), 0, kd)
        drafts = ngram_propose(ring, rlen, n=self.config.spec_ngram, k=kd)
        drafts = torch.where(iota[:, :kd] < allow[:, None], drafts, -1)
        prop = (drafts >= 0).sum(1, dtype=torch.int32)
        tok_row = torch.cat([last[:, None], torch.clamp(drafts, min=0)], 1)
        # a dead row holds its position and writes the dummy page
        prow = pos[:, None] + torch.where(live[:, None], iota, 0)
        write = live[:, None] & (iota <= allow[:, None])
        pidx = torch.gather(table, 1, torch.clamp(
            prow // page, max=table.shape[1] - 1).long())
        slots = torch.where(write, pidx * page + prow % page, 0)
        kv_lens = torch.where(live, pos + K1, K1)
        sub = batch._replace(
            token_ids=tok_row.reshape(-1), positions=prow.reshape(-1),
            slot_mapping=slots.reshape(-1), logits_indices=fixed["rows"],
            attn=batch.attn._replace(cu_q_lens=fixed["cu"],
                                     kv_lens=kv_lens))
        logits = self._forward(sub, K1)
        # a seeded row draws from (seed, the index of its next output)
        tok_mat, accept = spec_verify(
            logits.view(S, K1, -1), drafts,
            batch.sampling._replace(out_step=ostep), generator,
            sampled=not all_greedy, select=self._select)
        emitted = torch.minimum(accept + 1, alive)        # 0 when dead
        hit_any = torch.zeros_like(live)
        md = batch.sampling
        if md.stop_ids is not None:
            # on-device finish over the whole emitted run: the first armed
            # hit ends it, and the row
            hitm = (tok_mat[:, :, None] == md.stop_ids[:, None, :]).any(-1)
            armed = (pos[:, None] + iota) >= md.stop_from[:, None]
            hm = hitm & armed & (iota < emitted[:, None])
            hit_any = hm.any(1)
            first = torch.argmax(hm.to(torch.int8), dim=1).to(torch.int32)
            emitted = torch.where(hit_any, first + 1, emitted)
        new_last = torch.gather(tok_mat, 1, torch.clamp(
            emitted - 1, min=0)[:, None].long())[:, 0]
        last.copy_(torch.where(emitted > 0, new_last, last))
        pos.add_(emitted)
        ostep.add_(emitted)
        r, rl = ring_shift_in(ring, rlen, tok_mat, emitted)
        ring.copy_(r)
        rlen.copy_(rl)
        alive.copy_(torch.where(hit_any, 0, alive - emitted))
        kcur.copy_(torch.where(
            (emitted > 0) & (allow > 0),
            torch.where(accept >= allow, torch.clamp(kcur + 1, max=kd),
                        torch.clamp(accept, min=1)), kcur))
        drafted.add_(torch.where(live, prop, 0))
        accepted.add_(torch.where(live, torch.minimum(accept, prop), 0))
        toks[k].copy_(tok_mat)
        counts[k].copy_(emitted)

    def _collect_spec(self, handle: StepHandle, host: np.ndarray) -> dict:
        """A collected spec block's host arrays, over its K links and n
        rows: tokens [K, n, K1], counts [K, n], drafted, accepted and the
        draft lengths [n]. Its executed sub-steps (those in which some row
        emitted) are counted, and on the card the kernels they launched."""
        lay = handle.spec
        toks, counts, drafted, accepted, kcur = lay.split(host)[:5]
        n, K = lay.n, lay.K
        counts = counts[:K, :n]
        k_exec = int((counts > 0).any(axis=1).sum())
        self.block_counts["substeps"] += k_exec
        self.graphs.add_substeps(handle.block, k_exec)
        return dict(tokens=toks[:K, :n], counts=counts, drafted=drafted[:n],
                    accepted=accepted[:n], kcur=kcur[:n])

    def _handle(self, tokens: torch.Tensor, block=None, spec=None,
                aux=None) -> StepHandle:
        """Start the copy of a step's tokens (a spec block's: the part
        before its carried state) and of its logprobs to the host."""
        out = (tokens[:spec.host_size] if isinstance(spec, SpecLayout)
               else tokens)
        aux = aux or None
        if self.device.type != "cuda":
            return StepHandle(tokens, out, None, block, spec, aux)

        def to_host(x):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            return host

        host = to_host(out)
        if aux is not None:
            aux = {k: tuple(to_host(x) for x in v) for k, v in aux.items()}
        event = torch.cuda.Event()
        event.record()
        return StepHandle(tokens, host, event, block, spec, aux)

    @staticmethod
    def aux(handle: StepHandle) -> dict:
        """A collected step's logprobs as numpy arrays, by name (empty
        when it computed none). Valid once ``collect`` has returned."""
        return {k: tuple(x.numpy() for x in v)
                for k, v in (handle.aux or {}).items()}

    def collect(self, handle: StepHandle) -> np.ndarray:
        """The sampled token of each batch item: waits for the copy out. A
        block's [K + 1, n] (each sub-step's tokens, then each row's finish
        step): its executed sub-steps (the latest finish step) are
        counted here, and on the card the kernels they launched."""
        if handle.event is not None:
            handle.event.synchronize()
        host = handle.host.numpy()
        if isinstance(handle.spec, SpecLayout):
            return self._collect_spec(handle, host)
        if handle.block is not None:
            k_exec = int(host[-1].max()) if host.shape[1] else 0
            self.block_counts["substeps"] += k_exec
            self.graphs.add_substeps(handle.block, k_exec)
        return host

    @property
    def num_shape_signatures(self) -> int:
        """Distinct graph keys captured so far (on the CPU: met), of every
        kind (decode, mixed, verify, block, spec block), ``warmup``'s
        included."""
        return len(self.graphs) if self.graphs is not None else 0

    @property
    def _select(self):
        """How a graph body's mask fast path branches: the graphs'
        conditional nodes on the card, the host's read on the CPU."""
        return self.graphs.select if self.graphs.cuda else None

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
        """Capture the hot signatures before serving (JAX's ``warmup``,
        ``runner.py:1849-1947``, which stands for the reference's
        CUDA-graph capture loop): every sequence bucket at the largest
        page bucket and the largest sequence bucket at every page bucket,
        each for greedy and for sampled rows, by running a decode step of
        throwaway sequences; then JAX's mixed pass
        (``runner.py:1910-1940``): for each sequence bucket, one step of a
        full prefill chunk and nseq - 1 decode rows at the largest page
        bucket, greedy and sampled (``all_greedy`` is part of the key),
        at the buckets of ``decode_buckets`` or, when only they are given,
        of ``block_buckets`` (a hybrid model's mixed steps run eagerly and
        are not warmed). The throwaway sequences' pages are all the dummy
        page 0 and their GDN slot the dummy slot 0, so no page or slot a
        sequence holds (nor a prefix-cached page) is written; the step
        counts, the launch counters, the graphs' replay counts, the
        generator and the memory manager's queues come out as they were.
        Each pass goes from the largest sequence and page buckets down, so
        that the largest transients come first into the graphs' pools and
        the later keys' fit in the blocks they leave free. Under the
        unified step
        every mixed batch pads to the one token bucket, so the mixed pass
        covers every mixed key of its sequence buckets at its page bucket.
        Where blocks form, every step and block takes the one pinned page
        bucket (``BatchBuilder.pin_pages``) and a block of any length
        replays the longest block's graph, so the decode steps run at each
        sequence bucket at that page bucket (passing ``page_buckets`` then
        raises), and the longest block (``block_len``; a fused spec block
        under ``spec_fused``) is captured for greedy and for sampled rows
        at each of ``block_buckets`` (sequence buckets, by default the
        decode ones), with the stop-set width the engine's EOS ids give
        under on-device finish: serving then meets no new decode, unified
        mixed or block key but for a stop set of another width (ROADMAP C
        7). The legacy step's mixed keys follow the token bucket; those
        the pass leaves out are captured at first sight, as JAX compiles
        them. With ``enforce_eager`` there is nothing to capture."""
        if self.graphs is None:
            return
        max_decode = min(self.config.scheduler.max_decode_seqs,
                         self.builder.max_seqs)
        if self.builder.pin_pages:
            if page_buckets is not None:
                raise ValueError(
                    "warmup: page_buckets given, but every step of this "
                    "engine runs at the one pinned page bucket "
                    f"({self.builder.max_pages_per_seq} pages)")
            combos = [(s, self.builder.max_pages_per_seq) for s in (
                decode_buckets or graphs.pow2_range(8, max_decode))]
        else:
            combos = graphs.warmup_combos(
                max_decode, self.config.max_pages_per_seq, self.num_pages,
                decode_buckets, page_buckets)
        npages = combos[0][1]
        mixed = sorted([] if self.hybrid else
                       decode_buckets or block_buckets
                       or graphs.pow2_range(8, max_decode), reverse=True)
        steps, counts = dict(self.step_counts), graphs.launch_counts()
        blocks, eager = dict(self.block_counts), dict(self.eager_mixed)
        replays = {k: v["replays"] for k, v in self.graphs.by_kind.items()}
        rng = self.generator.get_state()
        t0 = time.monotonic()
        self._warming = True
        try:
            for nseq, npg in sorted(combos, reverse=True):
                for temp in (0.0, 1.0):
                    self._warm_step(nseq, npg, temp)
            for nseq in mixed:
                for temp in (0.0, 1.0):
                    self._warm_mixed(nseq, npages, temp)
            K = self.block_len
            if K > 1:
                warm = (self._warm_spec_block if self.config.spec_fused
                        else self._warm_block)
                for nseq in sorted(block_buckets or {
                        s for s, p in combos if p == npages}, reverse=True):
                    for temp in (0.0, 1.0):
                        warm(nseq, npages, K, temp)
        finally:
            self._warming = False
            self.step_counts.update(steps)
            self.block_counts.update(blocks)
            self.eager_mixed.update(eager)
            for k, n in replays.items():
                self.graphs.by_kind[k]["replays"] = n
            graphs.set_launch_counts(counts)
            self.generator.set_state(rng)
        logger.info("warmup: %d decode combos, %d mixed buckets, %d "
                    "signatures, %.2f s", len(combos), len(mixed),
                    self.num_shape_signatures, time.monotonic() - t0)

    def _warm_step(self, nseq: int, npages: int, temp: float,
                   **extras) -> None:
        """One decode step of ``nseq`` throwaway sequences whose contexts
        fill ``npages`` pages, all the dummy page 0 (``extras``: further
        sampling options of every row, for an extras key)."""
        ctx = npages * self.config.cache.page_size - 1
        items = []
        for i in range(nseq):
            seq = Sequence(i, [1] * (ctx + 1), SamplingParams(
                temperature=temp, max_tokens=4, **extras))
            seq.page_table = [0] * npages
            seq.num_computed_tokens = ctx
            items.append(ScheduledSeq(seq, 1, ctx))
        self.step(ScheduledBatch(items))

    def _warm_mixed(self, nseq: int, npages: int, temp: float,
                    **extras) -> None:
        """One mixed step (JAX's mixed warmup pass): a throwaway prompt of
        a full prefill chunk (``max_prefill_tokens``, at most
        ``max_model_len``) and ``nseq - 1`` throwaway decode rows whose
        contexts fill ``npages`` pages, every page the dummy page 0
        (``extras``: further sampling options of every row)."""
        page = self.config.cache.page_size
        chunk = min(self.config.scheduler.max_prefill_tokens,
                    self.config.max_model_len)
        seq = Sequence(nseq, [1] * chunk, SamplingParams(
            temperature=temp, max_tokens=4, **extras))
        seq.page_table = [0] * cdiv(chunk, page)
        ctx = npages * page - 1
        self.step(ScheduledBatch([ScheduledSeq(seq, chunk, 0)] + [
            ScheduledSeq(row, 1, ctx) for row in self._warm_seqs(
                nseq - 1, npages, ctx, temp, 4, **extras)]))

    def _warm_seqs(self, nseq: int, npages: int, ctx: int, temp: float,
                   max_tokens: int, **extras) -> list:
        """``nseq`` throwaway running sequences at context ``ctx`` whose
        ``npages`` pages are all the dummy page 0; they carry the engine's
        EOS ids, so that a block under on-device finish has the stop-set
        width real traffic gives."""
        seqs = []
        for i in range(nseq):
            seq = Sequence(i, [1] * (ctx + 1), SamplingParams(
                temperature=temp, max_tokens=max_tokens,
                ignore_eos=not self.eos_token_ids, **extras))
            seq.page_table = [0] * npages
            seq.num_computed_tokens = ctx
            seq.status = SequenceStatus.RUNNING
            seqs.append(seq)
        return seqs

    def _warm_block(self, nseq: int, npages: int, K: int,
                    temp: float) -> None:
        """One block of K links over throwaway sequences (``_warm_seqs``)."""
        ctx = max(0, npages * self.config.cache.page_size - K)
        seqs = self._warm_seqs(nseq, npages, ctx, temp, K + 1)
        self.collect(self.step_multi([
            ScheduledBatch([ScheduledSeq(seq, 1, ctx + j) for seq in seqs])
            for j in range(K)]))

    def _warm_spec_block(self, nseq: int, npages: int, K: int,
                         temp: float) -> None:
        """One fused spec block of K links over throwaway sequences
        (``_warm_seqs``), each with a budget of K tokens."""
        K1 = self.config.spec_k + 1
        ctx = max(0, npages * self.config.cache.page_size - K * K1)
        seqs = self._warm_seqs(nseq, npages, ctx, temp, K + 1)
        chain = [ScheduledBatch([ScheduledSeq(seq, 1, ctx + j * K1)
                                 for seq in seqs], spec_block=True)
                 for j in range(K)]
        chain[0].active_until = [K] * nseq
        self.collect(self.step_spec_multi(chain))


def _tree_bytes(tree) -> int:
    """Bytes of the distinct tensors in a nest of dicts, lists and
    tuples (a tied table counted once)."""
    seen, total, stack = set(), 0, [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            k = (x.data_ptr(), x.nbytes)
            if k not in seen:
                seen.add(k)
                total += x.nbytes
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


def _all_greedy(items) -> bool:
    """Every row greedy: the sampler's argmax-only path."""
    return all(it.seq.sampling_params.temperature == 0.0 for it in items)


def _spec_sampled(items) -> bool:
    """Some drafted row samples (JAX's ``_spec_sampled``,
    ``runner.py:239``): else the verify keeps the argmax alone."""
    return any(it.draft_tokens and it.seq.sampling_params.temperature != 0
               for it in items)
