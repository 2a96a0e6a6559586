"""JAX's threefry2x32 PRNG in plain PyTorch, bit for bit (counterpart of
``jax._src.prng``: ``_threefry_seed``, ``threefry_2x32``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``; and of
``jax._src.random``: ``_uniform``, ``_gumbel``).

A seeded request's noise is a pure function of its seed and its output
token index (``gllm_tpu/ops/sampling.py:_row_base_keys``), so it does not
depend on the batch it rides in. The recipe is JAX's default one, where
``jax_threefry_partitionable`` is on: the bits of element i of a draw are
``b1 ^ b2`` of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``.

Everything is int64 holding uint32 values, masked after each add and
shift (torch's uint32 support is partial). :func:`seeded_noise_` is the
plain version of the seeded-Gumbel kernel (``csrc/threefry.cu``, wrapper
``ops/cuda/threefry.py``), with the same signature.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal number: the floor of the Gumbel uniform
TINY = float(torch.finfo(torch.float32).tiny)

# what a draw writes: the raw bits (int32 by bit pattern), a uniform in
# [0, 1) or Gumbel noise (both float32)
BITS, UNIFORM, GUMBEL = 0, 1, 2


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counts (x1, x2) under key (k1, k2): 20
    rounds, a key injection after every four. Broadcasting int64 tensors
    of uint32 values in, two out."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = ((x2 << r) & MASK) | (x2 >> (32 - r))
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def key(seed: torch.Tensor):
    """``jax.random.key(seed)``'s data for seeds in [0, 2^32): (seed >> 32,
    seed & 0xFFFFFFFF) = (0, seed)."""
    seed = seed.long()
    return (seed >> 32) & MASK, seed & MASK


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: the hash of the counts (0, data)."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=k[0].device)
    return threefry2x32(k[0], k[1], torch.zeros_like(data.long()),
                        data.long() & MASK)


def random_bits(k, n: int):
    """``jax.random.bits(k, (n,), uint32)`` for each key of ``k`` (two [R]
    tensors): [R, n] uint32 values as int64."""
    dev = k[0].device
    iota = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    b1, b2 = threefry2x32(k[0][:, None], k[1][:, None], iota >> 32,
                          iota & MASK)
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0
                      ) -> torch.Tensor:
    """JAX's ``_uniform`` over [minval, 1): the top 23 bits as the
    mantissa of a float in [1, 2), less one, scaled (by 1 - minval, which
    is 1.0 in float32 for the minvals used here), shifted and floored at
    minval."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if minval:
        f = torch.clamp(f + minval, min=minval)
    return f


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's ``_gumbel`` (the default "low" mode): -log(-log(u)) of the
    uniform over [tiny, 1)."""
    return -torch.log(-torch.log(uniform_from_bits(bits, TINY)))


def row_keys(seed: torch.Tensor, step: torch.Tensor, rows: int,
             group: int = 0, stream: int = -1):
    """The key of each of ``rows`` output rows: row r draws from seed
    ``s = r // group`` (``r`` when ``group`` is 0) as
    ``fold_in(key(seed[s]), step[s])``, folded with ``r % group`` when
    ``group`` > 0 (a verify row's position, JAX's ``pos_keys``) and then
    with ``stream`` when it is >= 0 (``fold_in(k, 0)`` for the accept
    uniform, ``fold_in(k, 1)`` for the resampling noise). A negative seed
    gives the key of seed 0 (the caller leaves such rows alone)."""
    r = torch.arange(rows, dtype=torch.int64, device=seed.device)
    s = r // group if group else r
    k = key(torch.clamp(seed.long()[s], min=0))
    k = fold_in(k, step.long()[s])
    if group:
        k = fold_in(k, r % group)
    if stream >= 0:
        k = fold_in(k, torch.full_like(r, stream))
    return k


def seeded_noise_(out: torch.Tensor, seed: torch.Tensor, step: torch.Tensor,
                  group: int = 0, stream: int = -1, mode: int = GUMBEL
                  ) -> torch.Tensor:
    """Plain version of the seeded-Gumbel kernel: write the draw of every
    row of ``out`` [R, V] whose seed is >= 0 (``row_keys``) in place, and
    leave the rows of negative seeds as they are. ``seed`` and ``step``
    [R // group, or R] int32; ``mode`` BITS (``out`` int32), UNIFORM or
    GUMBEL (``out`` float32). Returns ``out``."""
    seeded_noise_.calls += 1
    R, V = out.shape
    if R == 0:
        return out
    bits = random_bits(row_keys(seed, step, R, group, stream), V)
    if mode == BITS:
        # the uint32 pattern as int32
        val = (bits - ((bits >> 31) << 32)).to(torch.int32)
    elif mode == UNIFORM:
        val = uniform_from_bits(bits)
    else:
        val = gumbel_from_bits(bits)
    idx = torch.arange(R, device=out.device)
    live = seed[idx // group if group else idx] >= 0
    out.copy_(torch.where(live[:, None], val.to(out.dtype), out))
    return out


seeded_noise_.calls = 0
