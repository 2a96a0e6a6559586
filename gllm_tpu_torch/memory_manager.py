"""Paged KV-cache bookkeeping + hash-chain prefix cache (counterpart of
``gllm_tpu/memory_manager.py``).

- pages are fixed-size slabs of KV slots; a sequence's ``page_table`` lists
  its page ids in order; flat KV slot = page_id * page_size + offset.
- page id 0 is the *dummy page*: padded batch rows and padded tokens write
  there, and no sequence ever owns it.
- prefix cache: a chained per-page hash keys full pages for reuse; pages
  are ref-counted; a cached page survives refcount 0 and stays reusable
  until the allocator re-mints it; an 8-token canary guards against hash
  collisions. Freshly computed pages are registered only after a step's
  outputs land, so uncommitted tokens never poison cache keys. Each probe
  counts its prompt and hit tokens (JAX's metrics) and records a
  ``prefix`` step-trace event.
- hybrid models: working slots of the GDN state pools, one per running
  sequence (``gllm_tpu/memory_manager.py:116-180,248``), slot 0 being the
  padding dummy. A freed slot is queued to be zeroed (JAX's "zero"
  intent), which the runner does on the device before the next step, so a
  new tenant starts from a zeroed state. No snapshot slots yet (prefix
  caching raises with a hybrid model), so zeroing is the only intent.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

from gllm_tpu_torch.id_allocator import IDAllocator
from gllm_tpu_torch.obs import metrics as obs
from gllm_tpu_torch.obs.steptrace import TRACE
from gllm_tpu_torch.sequence import Sequence
from gllm_tpu_torch.utils import cdiv

# Prefix-cache metrics (``gllm_tpu/memory_manager.py:40-44``): lifetime
# token counters, whose rates give a window's hit rate; the scheduler's
# gllm_prefix_cache_hit_rate gauge mirrors the lifetime ratio
_M_PFX_QUERY = obs.counter("gllm_prefix_cache_query_tokens_total",
                           "prompt tokens probed against the prefix cache")
_M_PFX_HIT = obs.counter("gllm_prefix_cache_hit_tokens_total",
                         "prompt tokens served from cached KV pages")

# Tokens stored per cached page to verify against hash collisions.
_CANARY_TOKENS = 8


def _chain_hash(prev: bytes, token_ids: List[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(b"".join(t.to_bytes(4, "little", signed=True) for t in token_ids))
    return h.digest()


def prefix_digests(token_ids, prompt_len: int,
                   page_size: int) -> List[Tuple[bytes, list]]:
    """Chained page digests over the cacheable prompt prefix — only whole
    pages, leaving >= 1 token to compute."""
    out: List[Tuple[bytes, list]] = []
    digest = b"root"
    for i in range((prompt_len - 1) // page_size):
        s = i * page_size
        tokens = token_ids[s:s + page_size]
        digest = _chain_hash(digest, tokens)
        out.append((digest, tokens))
    return out


class MemoryManager:
    """Plain paged allocator (no prefix reuse)."""

    def __init__(self, num_pages: int, page_size: int,
                 ssm_working_slots: int = 0):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one is the dummy page)")
        self.page_size = page_size
        self.num_pages = num_pages
        # Page 0 reserved for padding writes.
        self.allocator = IDAllocator(num_pages - 1, start=1)
        self.ref_count: Dict[int, int] = {}
        # int8 KV cache: every minted page queues a scale reset, which the
        # runner applies on the device before the next step, so a recycled
        # page quantizes exactly like a fresh one (its running absmax never
        # carries over from the last tenant). Off, the list stays empty.
        self.track_scale_resets = False
        self.scale_resets: List[int] = []
        # hybrid models: slots 1..ssm_working_slots of the GDN state pools
        self.ssm_alloc = (IDAllocator(ssm_working_slots, start=1)
                          if ssm_working_slots else None)
        # freed slots to zero, drained by the runner
        self.ssm_zero: List[int] = []

    # ---- SSM slots (hybrid models) ----------------------------------------

    @property
    def use_ssm(self) -> bool:
        return self.ssm_alloc is not None

    def can_admit_seq(self) -> bool:
        return self.ssm_alloc is None or self.ssm_alloc.num_free > 0

    def prepare_seq(self, seq: Sequence) -> None:
        """At admission (waiting → running): a working slot, zeroed since
        its last tenant left."""
        if self.ssm_alloc is not None and seq.ssm_slot is None:
            seq.ssm_slot = self.ssm_alloc.allocate()

    def _free_ssm(self, seq: Sequence) -> None:
        if seq.ssm_slot is not None:
            self.ssm_zero.append(seq.ssm_slot)
            self.ssm_alloc.free(seq.ssm_slot)
            seq.ssm_slot = None

    def drain_ssm_zero(self) -> List[int]:
        out, self.ssm_zero = self.ssm_zero, []
        return out

    # ---- stats ------------------------------------------------------------

    @property
    def num_free_pages(self) -> int:
        return self.allocator.num_free

    @property
    def free_ratio(self) -> float:
        return self.allocator.num_free / self.allocator.num_total

    # ---- allocation -------------------------------------------------------

    def pages_needed(self, seq: Sequence, num_new_tokens: int) -> int:
        return cdiv(seq.num_computed_tokens + num_new_tokens,
                    self.page_size) - len(seq.page_table)

    def can_allocate(self, num_pages: int) -> bool:
        return self.num_free_pages >= num_pages

    def _mint_page(self) -> int:
        page = self.allocator.allocate()
        if self.track_scale_resets:
            self.scale_resets.append(page)
        return page

    def drain_scale_resets(self) -> List[int]:
        out, self.scale_resets = self.scale_resets, []
        return out

    def allocate_seq_pages(self, seq: Sequence, num_new_tokens: int) -> None:
        """Extend ``seq.page_table`` to cover computed+num_new_tokens tokens.
        Caller must have checked ``can_allocate(pages_needed(...))``."""
        for _ in range(self.pages_needed(seq, num_new_tokens)):
            page = self._mint_page()
            self.ref_count[page] = 1
            seq.page_table.append(page)

    def match_prefix(self, seq: Sequence) -> int:
        """Prefix-cache hook; no-op without prefix caching."""
        return 0

    def register_computed_pages(self, seq: Sequence) -> None:
        """Prefix-cache hook; no-op without prefix caching."""

    def free_seq(self, seq: Sequence) -> None:
        for page in seq.page_table:
            self._release_page(page)
        seq.page_table = []
        seq._pt_np = None      # see Sequence.preempt: shrink ⇒ drop cache
        self._free_ssm(seq)

    def _release_page(self, page: int) -> None:
        self.ref_count[page] -= 1
        if self.ref_count[page] == 0:
            del self.ref_count[page]
            self.allocator.free(page)


class PrefixMemoryManager(MemoryManager):
    """Paged allocator with page-granular hash-keyed KV reuse."""

    def __init__(self, num_pages: int, page_size: int):
        super().__init__(num_pages, page_size)
        # hash digest -> page id (only fully computed pages).
        self.hash_to_page: Dict[bytes, int] = {}
        # page id -> (hash digest, canary token ids)
        self.page_meta: Dict[int, Tuple[bytes, Tuple[int, ...]]] = {}
        # seq_id -> (num_pages_hashed, digest of the last hashed page)
        self._seq_chain: Dict[int, Tuple[int, bytes]] = {}
        self.hit_tokens = 0      # prompt tokens served from cached pages
        self.query_tokens = 0    # prompt tokens probed

    # A page in the free list may still carry cache metadata; minting it for
    # new content must drop the stale key.
    def _mint_page(self) -> int:
        page = super()._mint_page()   # keeps the int8 scale-reset queue
        meta = self.page_meta.pop(page, None)
        if meta is not None:
            digest, _ = meta
            if self.hash_to_page.get(digest) == page:
                del self.hash_to_page[digest]
        return page

    def _probe_page(self, digest: bytes, tokens):
        """Cached page id for this chained digest, or None (missing /
        canary mismatch = hash collision)."""
        page = self.hash_to_page.get(digest)
        if page is None:
            return None
        _, canary = self.page_meta[page]
        if tuple(tokens[:_CANARY_TOKENS]) != canary:
            return None
        return page

    def match_prefix(self, seq: Sequence) -> int:
        """Claim cached pages covering the longest matching prompt prefix.
        Returns the number of cached tokens (always < prompt_len so at
        least one token is computed to produce logits)."""
        assert seq.num_computed_tokens == 0 and not seq.page_table
        self.query_tokens += seq.prompt_len
        _M_PFX_QUERY.inc(seq.prompt_len)
        matched_digest = b"root"
        matched = 0
        for digest, tokens in prefix_digests(
                seq.token_ids, seq.prompt_len, self.page_size):
            page = self._probe_page(digest, tokens)
            if page is None:
                break
            if self.allocator.is_free(page):
                self.allocator.allocate_id(page)
            self.ref_count[page] = self.ref_count.get(page, 0) + 1
            seq.page_table.append(page)
            matched += 1
            matched_digest = digest
        seq.num_computed_tokens = matched * self.page_size
        if matched:
            self._seq_chain[seq.seq_id] = (matched, matched_digest)
        self.hit_tokens += seq.num_computed_tokens
        _M_PFX_HIT.inc(seq.num_computed_tokens)
        # one event per admission probe; the device's pages are the only
        # tier here ("hbm", JAX's name for it)
        TRACE.record("prefix", query_tokens=seq.prompt_len,
                     hit_tokens=seq.num_computed_tokens,
                     pages={"hbm": matched} if matched else {})
        return seq.num_computed_tokens

    def register_computed_pages(self, seq: Sequence) -> None:
        """Register hashes for fully computed pages of ``seq`` (called after
        a step's outputs landed)."""
        full_pages = seq.num_computed_tokens // self.page_size
        n_hashed, digest = self._seq_chain.get(seq.seq_id, (0, b"root"))
        for i in range(n_hashed, min(full_pages, len(seq.page_table))):
            s = i * self.page_size
            tokens = seq.token_ids[s:s + self.page_size]
            digest = _chain_hash(digest, tokens)
            page = seq.page_table[i]
            if self.hash_to_page.get(digest) is None:
                self.hash_to_page[digest] = page
                self.page_meta[page] = (digest,
                                        tuple(tokens[:_CANARY_TOKENS]))
            n_hashed = i + 1
        self._seq_chain[seq.seq_id] = (n_hashed, digest)

    def free_seq(self, seq: Sequence) -> None:
        super().free_seq(seq)
        self._seq_chain.pop(seq.seq_id, None)

    @property
    def cache_hit_rate(self) -> float:
        return (self.hit_tokens / self.query_tokens if self.query_tokens
                else 0.0)


def make_memory_manager(num_pages: int, page_size: int,
                        enable_prefix_caching: bool,
                        ssm_working_slots: int = 0) -> MemoryManager:
    if enable_prefix_caching:
        if ssm_working_slots:
            raise NotImplementedError("prefix caching with SSM slots (a "
                                      "hybrid model) is not ported")
        return PrefixMemoryManager(num_pages, page_size)
    return MemoryManager(num_pages, page_size, ssm_working_slots)
