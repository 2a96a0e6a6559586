"""Seeded Gumbel noise: CUDA kernel wrapper (plain version
``ops/threefry.py::seeded_noise_``).

Replaces no Pallas kernel. The JAX package draws a seeded sampling row's
noise with ``jax.random`` (threefry2x32 keyed by the request's seed and
output index: ``gllm_tpu/ops/sampling.py``, ``sample:269``,
``_row_base_keys:304``, ``spec_verify:373``), elementwise code that XLA
fuses into the sampling program. ``csrc/threefry.cu`` is that draw as one
launch, one thread an element, bound by its integer operations (20
rounds of threefry2x32 an element, in registers); written out in PyTorch
it is over a hundred elementwise launches in every sampled step. Every
sampled step, block and spec block launches it over its rows: the seeds
and output indices are read on the device, so a CUDA graph replays it
with each step's staged values; a row of seed -1 keeps the generator's
noise.

``seeded_noise`` launches the kernel for CUDA tensors and takes the plain
version only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from gllm_tpu_torch.ops.cuda import build
from gllm_tpu_torch.ops.threefry import BITS, GUMBEL, seeded_noise_


def _check(out, seed, step, group, stream, mode) -> None:
    """Raise on anything the kernel does not take."""
    what = "seeded_noise"
    if out.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA or CPU tensors, got "
                         f"{out.device}")
    if seed.device != out.device or step.device != out.device:
        raise ValueError(f"{what}: all tensors must be on {out.device}")
    if out.dim() != 2 or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous [rows, V]")
    want = torch.int32 if mode == BITS else torch.float32
    if out.dtype != want:
        raise ValueError(f"{what}: mode {mode} writes {want}, out is "
                         f"{out.dtype}")
    if mode not in (0, 1, 2):
        raise ValueError(f"{what}: mode must be 0, 1 or 2, got {mode}")
    rows = out.shape[0]
    n = rows // group if group > 0 else rows
    if group > 0 and rows % group:
        raise ValueError(f"{what}: {rows} rows are not groups of {group}")
    for name, t in (("seed", seed), ("step", step)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int32")
        if t.numel() < n:
            raise ValueError(f"{what}: {name} has {t.numel()} entries, "
                             f"{n} needed")
    if stream < -1:
        raise ValueError(f"{what}: stream must be >= -1, got {stream}")


def seeded_noise(out, seed, step, group: int = 0, stream: int = -1,
                 mode: int = GUMBEL):
    """Same contract as :func:`gllm_tpu_torch.ops.threefry.seeded_noise_`:
    the draw of every row of ``out`` whose seed is >= 0, in place."""
    if out.device.type == "cpu":
        return seeded_noise_(out, seed, step, group, stream, mode)
    _check(out, seed, step, group, stream, mode)
    rows, V = out.shape
    rc = build.kernel("threefry")(
        seed.data_ptr(), step.data_ptr(), out.data_ptr(), rows, V, group,
        stream, mode, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "seeded_noise")
    seeded_noise.launches["seeded_gumbel"] += 1
    return out


seeded_noise.launches = {"seeded_gumbel": 0}
