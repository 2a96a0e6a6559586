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
    # Dead-row convention of bucket padding: position 0, slot 0 — KV writes
    # land in the dummy page and the sampled token is discarded host-side.
    token_ids: object            # [T] int32, padded with 0
    positions: object            # [T] int32 (absolute position in sequence)
    slot_mapping: object         # [T] int32 flat KV slots (padding → dummy)
    logits_indices: object       # [S] int32 last token of each seq in the
                                 # token buffer (padded rows repeat 0)
    attn: AttentionMetadata
    sampling: SamplingMetadata
