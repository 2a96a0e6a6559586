"""Per-step batch descriptor (counterpart of ``gllm_tpu/batching.py:24``).

Flat padded arrays with bucketed sizes: numpy on the host as the batch
builder (``runner/prepare.py``) fills them, tensors on the device once the
runner has copied them over.
"""

from __future__ import annotations

from typing import NamedTuple

from gllm_tpu_torch.ops.attention import AttentionMetadata
from gllm_tpu_torch.ops.sampling import SamplingMetadata


class StepBatch(NamedTuple):
    # Dead-row convention, shared by bucket padding, the rows a block's
    # active_until freezes and the hole rows of persistent-slot chains:
    # position 0 (a frozen row: its last), slot 0 — KV writes land in the
    # dummy page and the sampled token is discarded host-side, so a dead
    # row costs one attention row and nothing else.
    token_ids: object            # [T] int32, padded with 0
    positions: object            # [T] int32 (absolute position in sequence)
    slot_mapping: object         # [T] int32 flat KV slots (padding → dummy)
    logits_indices: object       # [S] int32 last token of each seq in the
                                 # token buffer (padded rows repeat 0)
    attn: AttentionMetadata
    sampling: SamplingMetadata
    # int8 KV cache: ids of the pages minted since the last step, whose
    # scales the runner zeroes before this step writes (a list on the host,
    # [n] int32 on the device; None when there are none)
    scale_resets: object = None
    # hybrid models: each row's SSM working slot ([S] int32; padded rows
    # → the dummy slot 0), and the slots freed since the last step, whose
    # state the runner zeroes before this step (a list on the host, [n]
    # int32 on the device; None when there are none)
    ssm_slots: object = None
    ssm_zero: object = None
    # a re-formed batch (pipelined loop; mixed under the unified step), or
    # a chain that sequences joined (persistent slots): the flat token
    # offsets whose input token is spliced from the previous entry's
    # sampled tokens (a promised row's one token; after a mixed re-form's
    # decode rows, which come first, its prefill chunks keep the host's
    # tokens), then the rows of those tokens they take (a list of 2k ints
    # on the host, [2, k] int32 on the device; None when no row is
    # spliced by map)
    splice: object = None
    # the first link of a block (runner step_multi): per row, the
    # sub-steps in which it is alive ([S] int32; padded and hole rows 0);
    # None for a single step
    active_until: object = None
    # speculative decoding (a step with drafts): per row, the flat token
    # indices of its verify rows (its committed row, then its draft rows;
    # a row without drafts points at row 0) [S, k+1], and its drafts, -1
    # padded [S, k]; None without drafts
    spec_rows: object = None
    spec_drafts: object = None
    # a fused spec block's seed state [S, ring + SPEC_SEED_COLS]
    # (runner/prepare.py); None otherwise
    spec_seed: object = None
    # the penalties' per-row token ids [S, L], -1 padded (the occurrence
    # counts are built from them on the device); None without penalties
    penalty_ids: object = None
    # prompt logprobs: the token each row scores, the next prompt token
    # (0 elsewhere) [T]; None when no row asks for them
    plp_targets: object = None
    # host ints: the real rows (sequences) of the batch, and the longest
    # real row's token count (the GDN layers' padded row length)
    num_seqs: int = 0
    max_seq_q: int = 0
