"""The Mixtral / Qwen2-MoE / Qwen3-MoE family, and the routed experts the
MoE families share; counterpart of ``gllm_tpu/models/moe.py``
(``moe_layer_mask:39``, ``select_experts:52``, ``moe_mlp:66``,
``init_params:138``, ``forward:175``).

- ``grouped_experts``: the routed product over expert-sorted rows, which
  DeepSeekMoE (``models/deepseek.py``), the Qwen-style sparse block of
  the hybrid family and this family all call.
- ``select_experts`` and ``moe_mlp``: the Qwen-style block (Mixtral,
  Qwen2-MoE, Qwen3-MoE, Qwen3-Next): softmax → top-k → optional
  renormalisation, the routed product, and a shared expert gated by
  ``sigmoid(x @ shared_expert_gate)``.
- The family's model: ``dense.forward`` with the routed block as the MLP
  of each layer that ``moe_layer_mask`` marks. A mixed stack (Qwen2-MoE /
  Qwen3-MoE ``mlp_only_layers`` or ``decoder_sparse_step``) keeps both
  MLP variants stacked for every layer, as JAX's scan needs them; here
  the loop over layers takes the flag as a static Python branch (a CUDA
  graph captures the branch taken), so no ``moe_mask`` leaf is kept.

Experts are stacked [E, H, 2I] (gate|up fused, ``w_gate_up``) and
[E, I, H] (``w_down``). JAX's ``ragged_dot`` is no Pallas kernel, so the
port's counterpart stays a library call, ``torch._grouped_mm``, whose
bf16 / fp16 path on the H100 reads the groups' offsets on the device, so
a CUDA graph captures it and its replays follow each step's routing. Its
float32 path on CUDA walks the groups on the host (a copy of the offsets
each call, which a capture refuses and would freeze); float32 on CUDA
(the card's reference models) therefore runs every expert over every row
instead, with the unrouted rows weighted zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gllm_tpu_torch.models import dense
from gllm_tpu_torch.models.config import ModelConfig
from gllm_tpu_torch.models.dummy import DummyDraws
from gllm_tpu_torch.ops.layers import silu_and_mul

Params = dense.Params


def grouped_experts(x: torch.Tensor, weights: torch.Tensor,
                    ids: torch.Tensor, w_gate_up: torch.Tensor,
                    w_down: torch.Tensor) -> torch.Tensor:
    """sum_k weights[t, k] * expert_{ids[t, k]}(x[t]) for x [T, H],
    weights / ids [T, K].

    The T*K (token, expert) assignments are sorted by expert, so each
    expert's rows are contiguous, and the grouped product
    (``torch._grouped_mm`` with the groups' end offsets; JAX's
    ``jax.lax.ragged_dot``) runs each expert only on its own rows, with no
    host sync: the offsets stay on the device. Each row's result goes back
    to its (token, slot) place and the K slots of a token are summed with
    their routing weights in one batched product, with no atomics (JAX
    scatter-adds, in the model dtype as here)."""
    T, H = x.shape
    E, K = w_gate_up.shape[0], ids.shape[1]
    if x.is_cuda and x.dtype == torch.float32:
        return _every_expert(x, weights, ids, w_gate_up, w_down)
    flat = ids.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    # each expert's end offset in the sorted rows (bincount would size its
    # output from the largest id, a host sync on CUDA)
    offs = torch.searchsorted(flat[order], torch.arange(E, device=x.device),
                              right=True).to(torch.int32)
    xs = x[order // K]
    act = silu_and_mul(torch._grouped_mm(xs, w_gate_up, offs=offs))
    out = torch._grouped_mm(act, w_down, offs=offs)
    by_slot = torch.empty_like(out)
    by_slot[order] = out
    return torch.bmm(weights.to(out.dtype)[:, None, :],
                     by_slot.view(T, K, H))[:, 0]


def _every_expert(x, weights, ids, w_gate_up, w_down):
    """``grouped_experts`` as batched products of every expert over every
    row ([E, T, 2I], then [E, T, H]), each (token, slot) taking its
    expert's row and the K slots summed with their routing weights as
    there; no host sync, fixed shapes."""
    T, H = x.shape
    act = silu_and_mul(torch.matmul(x, w_gate_up))
    out = torch.bmm(act, w_down)                           # [E, T, H]
    rows = torch.arange(T, device=x.device)[:, None]
    return torch.bmm(weights.to(out.dtype)[:, None, :],
                     out[ids.long(), rows])[:, 0]


def select_experts(router_logits: torch.Tensor, top_k: int,
                   norm_topk_prob: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax → top-k → optional renormalisation. Returns (weights [T, K]
    float32, ids [T, K] int32)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, ids = probs.topk(top_k, dim=-1)
    if norm_topk_prob:
        weights = weights / weights.sum(-1, keepdim=True)
    return weights, ids.to(torch.int32)


def moe_mlp(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The Qwen-style sparse block over x [T, H]: routed experts plus,
    when the config has one, the shared expert times
    ``sigmoid(x @ shared_expert_gate)``."""
    logits = x.float() @ lp["router"].float()
    weights, ids = select_experts(logits, cfg.num_experts_per_tok,
                                  cfg.norm_topk_prob)
    out = grouped_experts(x, weights, ids, lp["w_gate_up"], lp["w_down"])
    if cfg.shared_expert_intermediate_size:
        shared = (silu_and_mul(x @ lp["shared_gate_up_proj"])
                  @ lp["shared_down_proj"])
        gate = torch.sigmoid((x @ lp["shared_expert_gate"]).float())
        out = out + shared * gate.to(shared.dtype)
    return out.to(x.dtype)


def moe_layer_mask(cfg: ModelConfig) -> Tuple[bool, ...]:
    """A flag a layer: the routed block unless the layer is listed in
    ``mlp_only_layers`` or falls off the ``decoder_sparse_step`` stride
    ((layer + 1) % step != 0), HF Qwen2/Qwen3-MoE semantics."""
    step = cfg.decoder_sparse_step
    return tuple(i not in cfg.mlp_only_layers
                 and (step <= 1 or (i + 1) % step == 0)
                 for i in range(cfg.num_layers))


def init_params(cfg: ModelConfig, seed: int, dtype: torch.dtype,
                device) -> Params:
    """The dense decoder's weights (its MLP only in a mixed stack, where
    every layer carries both variants, as JAX's) and each layer's router
    [L, H, E], experts ``w_gate_up`` [L, E, H, 2I] and ``w_down`` [L, E, I,
    H], and the shared expert where the config has one; drawn in float32
    one matrix at a time into tensors of ``dtype`` allocated up front
    (``models/dummy.py``: Qwen3-30B-A3B's experts are 1.2 GB a layer in
    bf16)."""
    draws = DummyDraws(seed, dtype, device)
    params = dense.ask_params(cfg, draws,
                              mlp=not all(moe_layer_mask(cfg)))
    L, H, E = cfg.num_layers, cfg.hidden_size, cfg.num_experts
    I = cfg.moe_intermediate_size or cfg.intermediate_size
    scale = H ** -0.5
    lp = params["layers"]
    lp["router"] = draws.normal((L, H, E), scale)
    lp["w_gate_up"] = draws.normal((L, E, H, 2 * I), scale)
    lp["w_down"] = draws.normal((L, E, I, H), I ** -0.5)
    SI = cfg.shared_expert_intermediate_size
    if SI:
        lp["shared_gate_up_proj"] = draws.normal((L, H, 2 * SI), scale)
        lp["shared_down_proj"] = draws.normal((L, SI, H), SI ** -0.5)
        lp["shared_expert_gate"] = draws.normal((L, H, 1), scale)
    draws.draw()
    return params


def forward(params: Params, kv: dense.KVCache, batch, cfg: ModelConfig,
            *, cos_sin: torch.Tensor, max_q_len: int, impl: str = "legacy"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dense.forward`` with the routed block as the MLP of every layer
    ``moe_layer_mask`` marks, the dense MLP elsewhere."""
    mask = moe_layer_mask(cfg)

    def mlp_fn(li, lp, x):
        if mask[li]:
            return moe_mlp(lp, x, cfg)
        return dense._mlp(lp, x)
    return dense.forward(params, kv, batch, cfg, cos_sin=cos_sin,
                         max_q_len=max_q_len, impl=impl, mlp_fn=mlp_fn)


compute_logits = dense.compute_logits
compute_full_logits = dense.compute_full_logits
make_rope_table = dense.make_rope_table
init_kv_cache = dense.init_kv_cache
kv_bytes_per_page = dense.kv_bytes_per_page
