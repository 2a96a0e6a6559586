"""Sampling (counterpart of ``gllm_tpu/ops/sampling.py``: ``sample:269``,
``_topk_topp_mask_sort:139``).

Greedy argmax, plus temperature / top-k / top-p / min-p sampling by
Gumbel-max over the masked logits. The noise comes from a
``torch.Generator`` the runner seeds with ``EngineConfig.seed``; JAX's
threefry bits are not reproduced, so sampled (non-greedy) tokens differ
from the JAX package's while their distribution is the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingMetadata(NamedTuple):
    temperature: torch.Tensor       # [S] f32; 0.0 → greedy
    top_p: torch.Tensor             # [S] f32 in (0, 1]
    top_k: torch.Tensor             # [S] i32; <= 0 → disabled
    min_p: torch.Tensor             # [S] f32; 0.0 → disabled


def topk_topp_mask(logits: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor,
                   min_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask logits outside the per-row top-k / top-p / min-p nucleus to
    -inf (full-vocab sort, as the JAX reference)."""
    vocab = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    # top-k threshold per row; top_k <= 0 is the "disabled" sentinel
    top_k = torch.where(top_k <= 0, torch.full_like(top_k, vocab), top_k)
    k_idx = torch.clamp(top_k - 1, 0, vocab - 1).long()
    kth = torch.gather(sorted_logits, -1, k_idx[:, None])
    keep = logits >= kth

    # top-p: keep the smallest prefix of sorted probs whose mass reaches p
    # (entry i kept iff the cumulative mass before it is < p).
    sorted_probs = torch.exp(
        sorted_logits - torch.logsumexp(logits, dim=-1, keepdim=True))
    cumsum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cumsum - sorted_probs) < top_p[:, None]
    inf = torch.tensor(float("inf"), dtype=logits.dtype,
                       device=logits.device)
    thresh = torch.where(keep_sorted, sorted_logits, inf).amin(
        dim=-1, keepdim=True)
    # top_p >= 1 means disabled and keeps the full support (float32 cumsum
    # rounding could otherwise drop the tail)
    thresh = torch.where((top_p >= 1.0)[:, None], -inf, thresh)
    keep = keep & (logits >= thresh)
    if min_p is not None:
        # min_p floor: keep tokens with prob >= min_p · max_prob; monotone
        # along the sorted axis, so it is a per-row threshold too.
        keep_mp = sorted_probs >= min_p[:, None] * sorted_probs[:, :1]
        mp_thresh = torch.where(keep_mp, sorted_logits, inf).amin(
            dim=-1, keepdim=True)
        keep = keep & (logits >= mp_thresh)
    return torch.where(keep, logits, -inf)


def sample(logits: torch.Tensor, md: SamplingMetadata,
           generator: Optional[torch.Generator] = None, *,
           all_greedy: bool = False) -> torch.Tensor:
    """logits: [S, V] → sampled token ids [S] int32.

    ``all_greedy`` (every live row has temperature 0) skips the mask and
    the noise entirely. Greedy rows of a mixed batch take the same argmax,
    so both paths agree on greedy rows."""
    logits = logits.float()
    greedy_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    if all_greedy:
        return greedy_tokens
    temp = torch.clamp(md.temperature, min=1e-6)[:, None]
    scaled = topk_topp_mask(logits / temp, md.top_k, md.top_p, md.min_p)
    # Gumbel-max == categorical sampling: -log(E) with E ~ Exp(1) is
    # Gumbel(0, 1) noise.
    expo = torch.empty_like(scaled).exponential_(generator=generator)
    sampled = torch.argmax(scaled - torch.log(expo), dim=-1).to(torch.int32)
    return torch.where(md.temperature == 0.0, greedy_tokens, sampled)
