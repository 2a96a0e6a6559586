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
  outputs land, so uncommitted tokens never poison cache keys.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

from gllm_tpu_torch.id_allocator import IDAllocator
from gllm_tpu_torch.sequence import Sequence
from gllm_tpu_torch.utils import cdiv

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

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one is the dummy page)")
        self.page_size = page_size
        self.num_pages = num_pages
        # Page 0 reserved for padding writes.
        self.allocator = IDAllocator(num_pages - 1, start=1)
        self.ref_count: Dict[int, int] = {}

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
        return self.allocator.allocate()

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

    # A page in the free list may still carry cache metadata; minting it for
    # new content must drop the stale key.
    def _mint_page(self) -> int:
        page = super()._mint_page()
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


def make_memory_manager(num_pages: int, page_size: int,
                        enable_prefix_caching: bool) -> MemoryManager:
    cls = PrefixMemoryManager if enable_prefix_caching else MemoryManager
    return cls(num_pages, page_size)
