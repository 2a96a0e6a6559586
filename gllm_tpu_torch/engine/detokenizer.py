"""Incremental detokenization (counterpart of
``gllm_tpu/engine/detokenizer.py``, a copy).

Streaming-safe decode: each sequence keeps two offsets and text is emitted
only once it does not end in a partial multi-byte character.
``prefix_offset`` marks the start of the token window decoded for context,
``read_offset`` the first token whose text has not been emitted. The
tokenizer is any object with ``decode(ids)``: special tokens are decoded
as they are (a Hugging Face tokenizer's default, which the JAX package
asks for by name).
"""

from __future__ import annotations

from typing import List, Tuple

REPLACEMENT = "�"


def detokenize_incrementally(
    tokenizer,
    token_ids: List[int],
    prefix_offset: int,
    read_offset: int,
    end: int = None,
) -> Tuple[str, int, int]:
    """Returns (new_text, new_prefix_offset, new_read_offset).

    ``end`` bounds the token window (default: all of ``token_ids``):
    callers replaying a multi-token commit one token at a time pass it
    instead of slicing the list per token."""
    if end is None:
        end = len(token_ids)
    prefix_text = tokenizer.decode(token_ids[prefix_offset:read_offset])
    full_text = tokenizer.decode(token_ids[prefix_offset:end])
    if len(full_text) > len(prefix_text) and not full_text.endswith(
            REPLACEMENT):
        return (full_text[len(prefix_text):],
                read_offset, end)
    return "", prefix_offset, read_offset
