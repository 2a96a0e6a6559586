"""Sampling (counterpart of ``gllm_tpu/ops/sampling.py``: ``sample:269``,
``_topk_topp_mask_sort:139``, ``_topk_topp_mask:189``,
``PenaltyTokens:58``, ``apply_penalties:78``,
``apply_logit_bias:101``, ``adjust_logits:112``, ``_row_base_keys:304``,
``stop_token_hit:500``, ``compute_logprobs:518``, and speculative
decoding's ``spec_adjust_logits:324``, ``spec_verify:373``,
``ngram_propose:454``, ``ring_shift_in:486``).

Greedy argmax, plus temperature / top-k / top-p / min-p sampling by
Gumbel-max over the masked logits (the mask from a bounded top-k where a
certificate proves it equal to the full-vocab sort form, else from the
sort form, for the whole batch), after the logit adjustments in JAX's
order: ``logit_bias`` first, then the repetition, presence and frequency
penalties (over per-row occurrence counts built on the device from
padded id lists), before the greedy argmax too. A row with a seed (>= 0)
draws JAX's threefry noise from (seed, output index), bit for bit, so
that it does not depend on its batch: the seeded-Gumbel kernel
(``ops/cuda/threefry.py``) writes it over the rows' generator noise. The
other rows draw from a ``torch.Generator`` the runner seeds with
``EngineConfig.seed``; JAX's engine step key is not reproduced, so their
tokens differ from the JAX package's while their distribution is the
same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gllm_tpu_torch.ops.cuda.threefry import seeded_noise
from gllm_tpu_torch.ops.threefry import UNIFORM


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
    # per-row seeds [S] i32 (-1: the generator's noise) and the index of
    # the output token each row samples [S] i32: a seeded row's noise is
    # a pure function of the two
    seed: Optional[torch.Tensor] = None
    out_step: Optional[torch.Tensor] = None
    # the scaling repetition penalty (> 1 scales a seen token's positive
    # logit down and its negative one up) and OpenAI's additive presence
    # and frequency penalties [S] f32; None without penalties
    repetition_penalty: Optional[torch.Tensor] = None
    presence_penalty: Optional[torch.Tensor] = None
    frequency_penalty: Optional[torch.Tensor] = None
    # OpenAI logit_bias: per-row (token id, bias) pairs [S, B], added to
    # the logits; padding pairs carry bias 0 (a no-op add)
    bias_ids: Optional[torch.Tensor] = None
    bias_vals: Optional[torch.Tensor] = None


class PenaltyTokens(NamedTuple):
    """Each row's token ids, padded to a shared length L, from which the
    [S, V] occurrence counts are built on the device each step."""
    ids: torch.Tensor     # [S, L] int (padding clipped to id 0)
    mask: torch.Tensor    # [S, L] bool, False on padding


def counts_from_tokens(pt: PenaltyTokens, vocab: int) -> torch.Tensor:
    """[S, vocab] int32 occurrence counts of each row's token ids."""
    S = pt.ids.shape[0]
    counts = torch.zeros((S, vocab), dtype=torch.int32, device=pt.ids.device)
    return counts.scatter_add_(1, pt.ids.long(), pt.mask.to(torch.int32))


def apply_penalties(logits: torch.Tensor, token_counts,
                    md: SamplingMetadata) -> torch.Tensor:
    """The repetition penalty and the presence / frequency penalties in
    one pass; ``token_counts`` [S, V] occurrence counts or a
    :class:`PenaltyTokens` expanded on the device (None: no-op)."""
    if token_counts is None:
        return logits
    if isinstance(token_counts, PenaltyTokens):
        token_counts = counts_from_tokens(token_counts, logits.shape[-1])
    counts = token_counts.float()
    seen = counts > 0
    p = md.repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    logits = torch.where(seen, penalized, logits)
    if md.presence_penalty is not None:
        logits = logits - md.presence_penalty[:, None] * seen
    if md.frequency_penalty is not None:
        logits = logits - md.frequency_penalty[:, None] * counts
    return logits


def apply_logit_bias(logits: torch.Tensor,
                     md: SamplingMetadata) -> torch.Tensor:
    """Add each row's logit_bias pairs (padding pairs add 0)."""
    if md.bias_ids is None:
        return logits
    return logits.scatter_add(1, md.bias_ids.long(), md.bias_vals)


def adjust_logits(logits: torch.Tensor, token_counts,
                  md: SamplingMetadata) -> torch.Tensor:
    """Every adjustment before sampling, in the order that defines the
    distribution: logit_bias, then the penalties. The sample path and the
    logprob path share it, so reported logprobs are of what was sampled
    from."""
    logits = apply_logit_bias(logits.float(), md)
    return apply_penalties(logits, token_counts, md)


def topk_topp_mask_sort(logits: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor,
                   min_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask logits outside the per-row top-k / top-p / min-p nucleus to
    -inf (full-vocab sort, JAX's ``_topk_topp_mask_sort``): the fast
    path's fallback and its reference."""
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


# The bounded fast path of the mask (JAX's ``_TOPK_FAST_BOUND`` and
# ``_TOPK_FAST_MARGIN``, ``gllm_tpu/ops/sampling.py:128,136``): a top-k of
# this many candidates stands for the full-vocab sort wherever each row's
# kept set provably ends inside it (0: always sort) ...
TOPK_FAST_BOUND = 4096
# ... and a row whose top-p or min-p boundary sits within this much mass of
# its cutoff takes the sort form: the two paths sum the probabilities in
# reductions of other shapes, whose rounding could place it differently
TOPK_FAST_MARGIN = 5e-4


def host_select(flag: torch.Tensor, fast, slow) -> torch.Tensor:
    """The fast path's branch read on the host: ``fast()`` when the device
    bool ``flag`` holds, else ``slow()`` (an eager step, the CPU). Inside a
    CUDA graph the runner passes a conditional node instead
    (``DecodeGraphs.select``)."""
    return fast() if bool(flag) else slow()


def topk_topp_mask(logits: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor, min_p: Optional[torch.Tensor] = None,
                   select=None) -> torch.Tensor:
    """The nucleus mask with JAX's bounded fast path (``_topk_topp_mask``):
    the top ``TOPK_FAST_BOUND`` logits of each row are the sort's
    descending prefix, so the three thresholds (the k-th logit, the
    smallest kept top-p logit, the smallest kept min-p logit) come from
    them exactly wherever each row's kept set provably ends inside the
    bound: top-k within it (or disabled); top-p disabled, or its last
    candidate already outside the nucleus (the mass before it is
    monotone); min-p off, or its last candidate already under the floor;
    and no top-p or min-p boundary within ``TOPK_FAST_MARGIN`` of its
    cutoff. A batch with any row it cannot prove takes the sort form
    whole: ``select(flag, fast, slow)`` picks the branch on the device
    flag "every row proved" (default ``host_select``). Both branches give
    the sort form's mask."""
    vocab = logits.shape[-1]
    kb = TOPK_FAST_BOUND
    if not kb or vocab <= kb:
        return topk_topp_mask_sort(logits, top_k, top_p, min_p)
    inf = float("inf")
    top_vals = torch.topk(logits, kb, dim=-1).values          # descending
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    probs = torch.exp(top_vals - lse)          # full-softmax probabilities
    eff_k = torch.where(top_k <= 0, vocab, top_k)
    ok = (eff_k <= kb) | (eff_k >= vocab)
    k_idx = torch.clamp(eff_k - 1, 0, kb - 1).long()
    kth = torch.where((eff_k >= vocab)[:, None], -inf,
                      torch.gather(top_vals, -1, k_idx[:, None]))
    before = torch.cumsum(probs, dim=-1) - probs
    keep_p = before < top_p[:, None]
    close_p = ((before - top_p[:, None]).abs() < TOPK_FAST_MARGIN).any(-1)
    p_off = top_p >= 1.0
    ok = ok & (p_off | (~keep_p[:, -1] & ~close_p))
    thresh = torch.where(p_off[:, None], -inf, torch.where(
        keep_p, top_vals, inf).amin(dim=-1, keepdim=True))
    keep = (logits >= kth) & (logits >= thresh)
    if min_p is not None:
        floor = min_p[:, None] * probs[:, :1]
        keep_mp = probs >= floor
        close_mp = ((probs - floor).abs() < TOPK_FAST_MARGIN).any(-1)
        mp_off = min_p <= 0.0
        ok = ok & (mp_off | (~keep_mp[:, -1] & ~close_mp))
        mp_thresh = torch.where(mp_off[:, None], -inf, torch.where(
            keep_mp, top_vals, inf).amin(dim=-1, keepdim=True))
        keep = keep & (logits >= mp_thresh)
    return (select or host_select)(
        ok.all(), lambda: torch.where(keep, logits, -inf),
        lambda: topk_topp_mask_sort(logits, top_k, top_p, min_p))


def sample(logits: torch.Tensor, md: SamplingMetadata,
           generator: Optional[torch.Generator] = None, *,
           token_counts=None, all_greedy: bool = False,
           adjusted: bool = False, select=None) -> torch.Tensor:
    """logits: [S, V] → sampled token ids [S] int32, after the logit
    adjustments (``token_counts``: the penalties' counts, or None;
    ``adjusted``: the caller made them already).

    ``all_greedy`` (every live row has temperature 0) skips the mask and
    the noise entirely. Greedy rows of a mixed batch take the same argmax,
    so both paths agree on greedy rows. ``select``: how the mask's fast
    path picks its branch (``topk_topp_mask``)."""
    if not adjusted:
        logits = adjust_logits(logits, token_counts, md)
    greedy_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    if all_greedy:
        return greedy_tokens
    temp = torch.clamp(md.temperature, min=1e-6)[:, None]
    scaled = topk_topp_mask(logits / temp, md.top_k, md.top_p, md.min_p,
                            select)
    # Gumbel-max == categorical sampling: -log(E) with E ~ Exp(1) is
    # Gumbel(0, 1) noise; a seeded row's is JAX's threefry draw of
    # (seed, out_step), written over it by the kernel
    noise = -torch.log(torch.empty_like(scaled).exponential_(
        generator=generator))
    if md.seed is not None:
        seeded_noise(noise, md.seed, md.out_step)
    sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
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
                sampled: bool = True, draws=None, select=None):
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
    and Gumbel noise [S, K+1, V] as -log of unit exponentials), a seeded
    row's from JAX's threefry keys (``fold_in(base, i)`` a verify row,
    its uniform under ``fold_in(., 0)``, its noise under ``fold_in(.,
    1)``, base the key of (seed, out_step)), or from ``draws`` =
    (uniforms, gumbel) when given. ``select``: the mask's branch
    (``topk_topp_mask``)."""
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
        None if md.min_p is None else rep(md.min_p), select)
    p = torch.softmax(masked, dim=-1).reshape(S, K1, V)
    if draws is None:
        u = torch.rand((S, K1), generator=generator,
                       device=logits_mat.device)
        gumbel = -torch.log(torch.empty_like(p).exponential_(
            generator=generator))
        if md.seed is not None:
            seeded_noise(u.view(S * K1, 1), md.seed, md.out_step, K1, 0,
                         UNIFORM)
            seeded_noise(gumbel.view(S * K1, V), md.seed, md.out_step, K1,
                         1)
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


def spec_adjust_logits(logits_mat: torch.Tensor, drafts: torch.Tensor,
                       md: SamplingMetadata,
                       token_counts=None) -> torch.Tensor:
    """The logit adjustments of each verify row (JAX's
    ``spec_adjust_logits``, ``gllm_tpu/ops/sampling.py:324``): row i of a
    sequence scores the token after its committed tokens and
    ``drafts[:i]``, so the penalties see the base counts plus that draft
    prefix (the drafts' one-hots, int8 as in JAX, cumulated along the
    rows), while logit_bias repeats on every row. The identity when the
    batch carries neither."""
    if token_counts is None and md.bias_ids is None:
        return logits_mat
    S, K1, V = logits_mat.shape
    K = K1 - 1
    rep = lambda a: (None if a is None                      # noqa: E731
                     else a.repeat_interleave(K1, dim=0))
    md_rep = md._replace(
        repetition_penalty=rep(md.repetition_penalty),
        presence_penalty=rep(md.presence_penalty),
        frequency_penalty=rep(md.frequency_penalty),
        bias_ids=rep(md.bias_ids), bias_vals=rep(md.bias_vals))
    counts_flat = None
    if token_counts is not None:
        base = (counts_from_tokens(token_counts, V)
                if isinstance(token_counts, PenaltyTokens)
                else token_counts)                          # [S, V]
        dev = logits_mat.device
        dhot = torch.zeros((S, K, V), dtype=torch.int8, device=dev)
        dhot.scatter_add_(2, torch.clamp(drafts, min=0).long()[..., None],
                          (drafts >= 0).to(torch.int8)[..., None])
        # row i sees drafts[:i]: an exclusive cumulative sum, the bonus
        # row (i = K) all K drafts
        dpfx = torch.cat([torch.zeros((S, 1, V), dtype=torch.int8,
                                      device=dev),
                          torch.cumsum(dhot, dim=1, dtype=torch.int8)], 1)
        counts_flat = (base[:, None, :] + dpfx).reshape(S * K1, V)
    return adjust_logits(logits_mat.reshape(S * K1, V), counts_flat,
                         md_rep).reshape(S, K1, V)


def compute_logprobs(logits: torch.Tensor, token_ids: torch.Tensor,
                     top_n: int):
    """Log-softmax logprobs: (the chosen token's [S], the top ``top_n``
    ids [S, top_n] int32, their logprobs [S, top_n])."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(logprobs, 1, token_ids.long()[:, None])[:, 0]
    top_vals, top_ids = torch.topk(logprobs, top_n, dim=-1)
    return chosen, top_ids.to(torch.int32), top_vals


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
