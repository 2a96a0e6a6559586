"""Gated-delta-rule chunk scan: CUDA kernel wrapper and its plain PyTorch
version.

Replaces ``gllm_tpu/ops/pallas/gdn_scan.py::gdn_chunk_scan`` (K3): the
sequential inter-chunk state recurrence of ``ops/gdn.py``'s chunked gated
delta rule, over operands the in-chunk (batched PyTorch) work has already
built. ``csrc/gdn_scan.cu`` runs it on the tensor cores at float32
accuracy (3xTF32: each operand split into two TF32 halves), bound by
bytes: one 16-warp block per (sequence, head) holds every state column in
its accumulators across the chunks and reads each chunk's operands once,
loading the next phase's while it computes (see the source). The plain
version is the JAX package's ``lax.scan`` body as a Python loop over the
chunks.

``gdn_chunk_scan`` launches the kernel for CUDA tensors and takes the plain
version only for tensors on the CPU. The kernel is built for Dk and Dv in
``GDN_DIMS`` and chunks of ``GDN_CHUNKS`` rows; anything else raises (the
JAX package falls back to XLA on unaligned dims, this port does not).
"""

from __future__ import annotations

import torch

from gllm_tpu_torch.ops.cuda import build
from gllm_tpu_torch.ops.cuda.common import GDN_DIMS

GDN_CHUNKS = (16, 32, 64)


def gdn_chunk_scan_plain(qc, kc, v2, kcd, attn, gcum, init_state):
    """qc, kc, kcd [B, N, C, Dk]; v2 [B, N, C, Dv]; attn [B, N, C, C];
    gcum [B, N, C, 1]; init_state [B, Dk, Dv], all float32. Returns
    (out [B, N, C, Dv], final_state [B, Dk, Dv]) float32: for each chunk
    in order, v_new = v2 - kcd @ S, out = (q e^g) @ S + attn @ v_new,
    S = e^{g_C} S + (k e^{g_C - g})^T @ v_new."""
    gdn_chunk_scan_plain.calls += 1
    state = init_state
    outs = []
    for n in range(qc.shape[1]):
        g = gcum[:, n]                                  # [B, C, 1]
        v_new = v2[:, n] - kcd[:, n] @ state
        outs.append((qc[:, n] * torch.exp(g)) @ state + attn[:, n] @ v_new)
        g_last = g[:, -1:]                              # [B, 1, 1]
        state = (state * torch.exp(g_last)
                 + (kc[:, n] * torch.exp(g_last - g)).transpose(-1, -2)
                 @ v_new)
    return torch.stack(outs, dim=1), state


gdn_chunk_scan_plain.calls = 0


def _check(qc, kc, v2, kcd, attn, gcum, init_state):
    """Raise on anything the kernel does not take."""
    what = "gdn_chunk_scan"
    tensors = (qc, kc, v2, kcd, attn, gcum, init_state)
    if qc.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA or CPU tensors, got "
                         f"{qc.device}")
    if any(t.device != qc.device for t in tensors):
        raise ValueError(f"{what}: all tensors must be on {qc.device}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what}: every tensor must be float32")
    if qc.dim() != 4:
        raise ValueError(f"{what}: expected qc [B, N, C, Dk]")
    B, N, C, Dk = qc.shape
    Dv = v2.shape[-1]
    shapes = {"kc": (kc, (B, N, C, Dk)), "kcd": (kcd, (B, N, C, Dk)),
              "v2": (v2, (B, N, C, Dv)), "attn": (attn, (B, N, C, C)),
              "gcum": (gcum, (B, N, C, 1)),
              "init_state": (init_state, (B, Dk, Dv))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} must be {list(want)}, got "
                             f"{list(t.shape)}")
    if Dk not in GDN_DIMS or Dv not in GDN_DIMS:
        raise ValueError(f"{what}: Dk={Dk} and Dv={Dv} must be in "
                         f"{GDN_DIMS}")
    if C not in GDN_CHUNKS:
        raise ValueError(f"{what}: chunk {C} not in {GDN_CHUNKS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: tensors must be 16-byte aligned")


def gdn_chunk_scan(qc, kc, v2, kcd, attn, gcum, init_state):
    """Same contract as :func:`gdn_chunk_scan_plain`."""
    if qc.device.type == "cpu":
        return gdn_chunk_scan_plain(qc, kc, v2, kcd, attn, gcum, init_state)
    _check(qc, kc, v2, kcd, attn, gcum, init_state)
    B, N, C, Dk = qc.shape
    Dv = v2.shape[-1]
    out = torch.empty((B, N, C, Dv), dtype=torch.float32, device=qc.device)
    final = torch.empty((B, Dk, Dv), dtype=torch.float32, device=qc.device)
    if B == 0 or N == 0:
        final.copy_(init_state)
        return out, final
    rc = build.kernel("gdn_scan")(
        qc.data_ptr(), kc.data_ptr(), v2.data_ptr(), kcd.data_ptr(),
        attn.data_ptr(), gcum.data_ptr(), init_state.data_ptr(),
        out.data_ptr(), final.data_ptr(), B, N, C, Dk, Dv,
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "gdn_chunk_scan")
    gdn_chunk_scan.launches["gdn_chunk_scan"] += 1
    return out, final


gdn_chunk_scan.launches = {"gdn_chunk_scan": 0}
