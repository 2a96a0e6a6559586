"""Sampling (counterpart of ``gllm_tpu/ops/sampling.py``: ``sample:269``,
``_topk_topp_mask_sort:139``, ``stop_token_hit:500``, and speculative
decoding's ``spec_verify:373``, ``ngram_propose:454``,
``ring_shift_in:486``).

Greedy argmax, plus temperature / top-k / top-p / min-p sampling by
Gumbel-max over the masked logits. The noise comes from a
``torch.Generator`` the runner seeds with ``EngineConfig.seed``; JAX's
threefry bits are not reproduced, so sampled (non-greedy) tokens differ
from the JAX package's while their distribution is the same.

JAX's ``spec_adjust_logits`` (``:324``: penalties and ``logit_bias`` over
the verify rows) has no counterpart: it is the identity while this port
refuses both options (ROADMAP A 5).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingMetadata(NamedTuple):
    temperature: torch.Tensor       # [S] f32; 0.0 → greedy
    top_p: torch.Tensor             # [S] f32 in (0, 1]
    top_k: torch.Tensor             # [S] i32; <= 0 → disabled
    min_p: torch.Tensor             # [S] f32; 0.0 → disabled
    # on-device finish in a block: per-row EOS / stop-token ids [S, E]
    # (-1 padding never matches) and the sub-step from which a hit counts
    # [S] (the min_tokens gate); None when no row has a stop id
    stop_ids: Optional[torch.Tensor] = None
    stop_from: Optional[torch.Tensor] = None


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
    # Python scalars, not a tensor made here: a host-to-device copy would
    # sync the stream, which a CUDA graph capture refuses
    inf = float("inf")
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


def stop_token_hit(tokens: torch.Tensor, md: SamplingMetadata,
                   sub_step: int) -> torch.Tensor:
    """[S] bool: did row s's sampled token land in its stop set, at or
    after its arming sub-step? The on-device half of
    ``Sequence.check_finish``; all False when the batch carries no stop
    sets."""
    if md.stop_ids is None:
        return torch.zeros(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
    hit = (tokens[:, None] == md.stop_ids).any(dim=-1)
    if md.stop_from is not None:
        hit = hit & (md.stop_from <= sub_step)
    return hit


def spec_verify(logits_mat: torch.Tensor, drafts: torch.Tensor,
                md: SamplingMetadata,
                generator: Optional[torch.Generator] = None, *,
                sampled: bool = True, draws=None):
    """Verify speculative drafts against the target model's logits (JAX's
    ``spec_verify``, ``gllm_tpu/ops/sampling.py:373``).

    logits_mat [S, K+1, V]: row i scores the token after draft position i
    (row 0 follows the last committed token); drafts [S, K] int32, -1
    padded. Returns (tok_mat [S, K+1] int32, accept [S] int32): the
    engine commits ``tok_mat[s, :accept + 1]``, the accepted drafts and
    then the correction (or, when every draft was accepted, the bonus)
    token.

    Greedy rows (temperature 0) accept by argmax equality, a prefix found
    by a cumulative product: identical to greedy decoding. Sampled rows
    use rejection sampling against the one-hot prompt-lookup proposal:
    draft d_i is accepted with probability p_i(d_i) (p the row's
    temperature / top-k / top-p / min-p distribution), and the first
    rejection resamples from p_i with d_i removed, which keeps the target
    distribution exactly. ``sampled`` False (every row greedy) keeps the
    argmax alone. The draws come from ``generator`` (uniforms [S, K+1]
    and Gumbel noise [S, K+1, V] as -log of unit exponentials; JAX's
    threefry keys are not reproduced), or from ``draws`` = (uniforms,
    gumbel) when given."""
    S, K1, V = logits_mat.shape
    K = K1 - 1
    logits_f = logits_mat.float()
    greedy_mat = torch.argmax(logits_f, dim=-1).to(torch.int32)
    ok_g = greedy_mat[:, :-1] == drafts              # -1 never matches
    if not sampled:
        accept = torch.cumprod(ok_g.to(torch.int32), dim=-1).sum(dim=-1)
        return greedy_mat, accept.to(torch.int32)
    temp = torch.clamp(md.temperature, min=1e-6)[:, None, None]
    rep = lambda a: a.repeat_interleave(K1, dim=0)   # noqa: E731
    masked = topk_topp_mask(
        (logits_f / temp).reshape(S * K1, V), rep(md.top_k), rep(md.top_p),
        None if md.min_p is None else rep(md.min_p))
    p = torch.softmax(masked, dim=-1).reshape(S, K1, V)
    if draws is None:
        u = torch.rand((S, K1), generator=generator,
                       device=logits_mat.device)
        gumbel = -torch.log(torch.empty_like(p).exponential_(
            generator=generator))
    else:
        u, gumbel = draws
    d_safe = torch.clamp(drafts, min=0).long()
    p_draft = torch.gather(p[:, :K], 2, d_safe[..., None])[..., 0]
    ok_s = (u[:, :K] < p_draft) & (drafts >= 0)
    # corrections: position j < K samples the residual (its draft
    # banned), position K the bonus token from the full distribution
    iota = torch.arange(V, device=p.device)
    ban = (iota[None, None, :] == d_safe[..., None]) & (drafts >= 0)[..., None]
    p_corr = torch.cat([torch.where(ban, 0.0, p[:, :K]), p[:, K:]], dim=1)
    logp = torch.where(p_corr > 0, torch.log(torch.clamp(p_corr, min=1e-30)),
                       float("-inf"))
    corr = torch.argmax(logp + gumbel, dim=-1).to(torch.int32)
    tok_sampled = torch.cat([torch.where(ok_s, drafts, corr[:, :K]),
                             corr[:, K:]], dim=1)
    greedy_rows = (md.temperature == 0.0)[:, None]
    ok = torch.where(greedy_rows, ok_g, ok_s)
    accept = torch.cumprod(ok.to(torch.int32), dim=-1).sum(dim=-1)
    tok_mat = torch.where(greedy_rows, greedy_mat, tok_sampled)
    return tok_mat, accept.to(torch.int32)


def ngram_propose(ring: torch.Tensor, ring_len: torch.Tensor, *, n: int,
                  k: int) -> torch.Tensor:
    """On-device prompt-lookup proposal (JAX's ``ngram_propose``,
    ``gllm_tpu/ops/sampling.py:454``): for each row of a right-aligned
    recent-token ring (``ring[s, R-1]`` the newest token, ``ring_len[s]``
    valid entries, -1 before them), the continuation, up to ``k`` tokens,
    of the most recent earlier occurrence of its last ``n`` tokens, by
    one sliding-window compare with no host read. [S, k] int32, -1 where
    a row has no match or its continuation runs past the ring."""
    S, R = ring.shape
    if R <= n:
        return torch.full((S, k), -1, dtype=torch.int32, device=ring.device)
    pattern = ring[:, R - n:]
    m = R - n                       # window starts 0..m-1 (m: the pattern)
    match = torch.ones((S, m), dtype=torch.bool, device=ring.device)
    for d in range(n):
        match = match & (ring[:, d:d + m] == pattern[:, d:d + 1])
    # a window counts only inside the valid region
    starts = torch.arange(m, device=ring.device)[None, :]
    match = match & (starts >= (R - ring_len)[:, None])
    has = match.any(dim=1)
    # the most recent match: the highest start
    j = (m - 1) - torch.argmax(match.flip(1).to(torch.int8), dim=1)
    idx = j[:, None] + n + torch.arange(k, device=ring.device)[None, :]
    cont = torch.gather(ring, 1, torch.clamp(idx, max=R - 1))
    valid = (idx < R) & has[:, None] & (cont >= 0)
    return torch.where(valid, cont, -1).to(torch.int32)


def ring_shift_in(ring: torch.Tensor, ring_len: torch.Tensor,
                  toks: torch.Tensor, counts: torch.Tensor):
    """Append ``counts[s]`` tokens of ``toks[s]``, left to right, to each
    row of a right-aligned ring (JAX's ``ring_shift_in``,
    ``gllm_tpu/ops/sampling.py:486``): the row shifts left by its count,
    so ``ring[s, R-1]`` stays the newest token; a count of 0 leaves the
    row as it is. Returns (ring, ring_len)."""
    S, R = ring.shape
    ext = torch.cat([ring, toks.to(ring.dtype)], dim=1)
    idx = (torch.arange(R, device=ring.device)[None, :]
           + counts[:, None].long())
    return (torch.gather(ext, 1, idx),
            torch.clamp(ring_len + counts, max=R).to(ring_len.dtype))
