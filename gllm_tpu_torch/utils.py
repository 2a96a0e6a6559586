"""Small integer helpers shared by the scheduler, the batch builder and
the runner (counterpart of ``gllm_tpu/utils.py:112-137``)."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_pow2(x: int, minimum: int = 1) -> int:
    """Smallest power of two >= max(x, minimum)."""
    v = max(x, minimum, 1)
    return 1 << (v - 1).bit_length()


def bucket_size(x: int, minimum: int, maximum: int) -> int:
    """Pad ``x`` to a power-of-two bucket, clamped to [minimum, maximum].

    Keeps the set of step shapes logarithmic in the range, so the batch
    tensors of a step take one of few sizes.
    """
    if x > maximum:
        raise ValueError(f"size {x} exceeds maximum bucket {maximum}")
    return min(next_pow2(x, minimum), maximum)
