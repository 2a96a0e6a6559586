"""Hybrid linear-attention decoder (Qwen3-Next / Qwen3.5); counterpart of
``gllm_tpu/models/hybrid.py`` (``HybridKV:42``, ``init_kv_cache:62``,
``init_params:87``, ``_gated_attention:163``, ``_gdn_layer:187``,
``forward:295``).

- Layers interleave Gated-DeltaNet linear attention and gated full
  attention in the order of ``cfg.layer_types`` (Qwen3-Next: three GDN
  layers, then one full, repeated). The decoder is a plain loop over the
  layers, where JAX scans over periods.
- Full attention: q and its output gate interleaved per head in one
  projection, per-head q/k RMSNorm, partial rotary (``apply_rope`` passes
  the tail through), the paged kernels K1 (mixed steps) and K2 (decode
  steps) at the model's head_dim (256 for Qwen3-Next), and
  ``sigmoid(gate)`` on the output. The stacked K/V [La, P, page, Hkv, D]
  covers the full-attention layers only.
- GDN: the layer's state lives in two float32 slot pools beside the paged
  KV, conv [Lg, slots, conv_dim, K-1] and recurrent [Lg, slots, Nv, Dk,
  Dv], indexed per sequence by ``batch.ssm_slots`` (slot 0 is the padding
  dummy) and updated in place with ``index_copy_`` (JAX returns new
  arrays). A decode step takes the closed-form recurrent step; any other
  step gathers each sequence's tokens into a padded [rows, Qmax] layout,
  runs the causal conv and the chunked rule (K3 for the inter-chunk
  scan), and scatters the real rows back. Qmax is the batch's longest real
  row (a host int from the batch builder, no sync), not the token bucket
  the JAX package pads to; padded positions are the identity on the state
  (g = 0, beta = 0) and their outputs are dropped. Rows go through in
  groups of at most ``GDN_MAX_CELLS`` padded (row, position) cells, which
  bounds the layer's transient memory (``gdn_transient_bytes``).
- MLP: the Qwen-style sparse block (``models/moe.py``) or a dense MLP.

Parameters: ``attn_layers`` (``qkv_proj`` = [q|gate interleaved per head,
k, v], ``o_proj``, ``q_norm``, ``k_norm``), ``gdn_layers`` (``in_qkvz``,
``in_ba``, ``conv_w`` [Lg, conv_dim, K], ``dt_bias`` and ``a_log`` in
float32, ``gdn_norm``, ``out_proj``), ``mlp_layers`` (norms, and
``router``, ``w_gate_up``, ``w_down``, ``shared_gate_up_proj``,
``shared_down_proj``, ``shared_expert_gate``, or ``gate_up_proj`` and
``down_proj``), ``embed``, ``final_norm``, ``lm_head``;
``models/convert.py`` maps the JAX pytree onto them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from gllm_tpu_torch.batching import StepBatch
from gllm_tpu_torch.models import dense, moe
from gllm_tpu_torch.models.config import ModelConfig
from gllm_tpu_torch.models.dummy import DummyDraws
from gllm_tpu_torch.ops.attention import paged_attention
from gllm_tpu_torch.ops.gdn import (causal_conv1d, chunk_gated_delta_rule,
                                    recurrent_gated_delta_step,
                                    rms_norm_gated)
from gllm_tpu_torch.ops.kv_cache import write_kv
from gllm_tpu_torch.ops.layers import fused_add_rms_norm, rms_norm
from gllm_tpu_torch.ops.rope import apply_rope

Params = dense.Params

# padded (row, position) cells of a GDN layer's mixed-step layout processed
# at once: 16 rows of a 2048-token chunk, or 32 of 1024
GDN_MAX_CELLS = 32768


class HybridKV(NamedTuple):
    """Paged KV of the full-attention layers + the GDN slot pools."""
    k: torch.Tensor      # [La, num_pages, page_size, Hkv, D]
    v: torch.Tensor
    conv: torch.Tensor   # [Lg, num_slots, conv_dim, K-1] float32
    rec: torch.Tensor    # [Lg, num_slots, Nv, Dk, Dv] float32


def init_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                  dtype: torch.dtype, device, num_slots: int = 2
                  ) -> HybridKV:
    shape = (cfg.num_attn_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    kv = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(2)]
    pools = [torch.zeros(s, dtype=torch.float32, device=device)
             for s in ssm_shapes(cfg, num_slots)]
    return HybridKV(*kv, *pools)


def ssm_shapes(cfg: ModelConfig, num_slots: int):
    """Shapes of the conv and recurrent slot pools."""
    Lg = cfg.num_linear_layers
    return ((Lg, num_slots, cfg.gdn_conv_dim, cfg.linear_conv_kernel_dim - 1),
            (Lg, num_slots, cfg.linear_num_value_heads,
             cfg.linear_key_head_dim, cfg.linear_value_head_dim))


def ssm_pool_bytes(cfg: ModelConfig, num_slots: int) -> int:
    """Device bytes of both slot pools (``runner.py:603`` ``_ssm_pool_bytes``)."""
    return sum(4 * math.prod(s) for s in ssm_shapes(cfg, num_slots))


def kv_bytes_per_page(cfg: ModelConfig, page_size: int,
                      kv_dtype: torch.dtype) -> int:
    """K and V of the full-attention layers only (``runner.py:593``)."""
    itemsize = torch.empty(0, dtype=kv_dtype).element_size()
    return (2 * cfg.num_attn_layers * page_size * cfg.num_kv_heads
            * cfg.head_dim * itemsize)


def gdn_transient_bytes(cfg: ModelConfig, cells: int, rows: int) -> int:
    """Device bytes a GDN layer holds at once beyond its inputs, reckoned
    from the ops of ``_gdn_layer``: per padded cell of a mixed step, the
    conv's float32 buffer, output and activation over conv_dim channels,
    about twelve [Nv, D] float32 tensors of the chunked rule (q, k, v and
    their chunked, beta-scaled and Tmat products, the output and its
    transpose) and four [Nv, 64] ones (decay, A, Tmat, local scores); per
    row of a decode step, five recurrent states (the gathered one, its
    decay, the outer-product update, the sum and the scatter's source).
    The larger of the two."""
    Nv = cfg.linear_num_value_heads
    D = max(cfg.linear_key_head_dim, cfg.linear_value_head_dim)
    per_cell = 4 * (3 * cfg.gdn_conv_dim + 12 * Nv * D + 4 * Nv * 64)
    state = 4 * Nv * cfg.linear_key_head_dim * cfg.linear_value_head_dim
    return max(cells * per_cell + rows * 2 * state, rows * 5 * state)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int, dtype: torch.dtype,
                device) -> Params:
    """Random weights with the JAX dummy init's scales, drawn from a
    ``torch.Generator`` one matrix at a time in float32 into tensors of
    ``dtype`` allocated up front (``models/dummy.py``; Qwen3-Next's experts
    are 3.2 GB a layer in bf16)."""
    H, D = cfg.hidden_size, cfg.head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    La, Lg, L = cfg.num_attn_layers, cfg.num_linear_layers, cfg.num_layers
    Nk, Nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    Dk, Dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    K = cfg.linear_conv_kernel_dim
    key_dim, value_dim = Nk * Dk, Nv * Dv
    draws = DummyDraws(seed, dtype, device)
    w = draws.normal

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    s = H ** -0.5
    params: Params = {
        "attn_layers": {
            # q|gate interleaved per head (2D a head), then k, then v
            "qkv_proj": w((La, H, (2 * Hq + 2 * Hkv) * D), s),
            "o_proj": w((La, Hq * D, H), (Hq * D) ** -0.5),
            "q_norm": full((La, D), 1.0),
            "k_norm": full((La, D), 1.0),
        },
        "gdn_layers": {
            "in_qkvz": w((Lg, H, 2 * key_dim + 2 * value_dim), s),
            "in_ba": w((Lg, H, 2 * Nv), s),
            "conv_w": w((Lg, cfg.gdn_conv_dim, K), K ** -0.5),
            "dt_bias": full((Lg, Nv), 1.0, torch.float32),
            "a_log": full((Lg, Nv), 0.0, torch.float32),
            "gdn_norm": full((Lg, Dv), 1.0),
            "out_proj": w((Lg, value_dim, H), value_dim ** -0.5),
        },
    }
    mlp: Params = {"input_norm": full((L, H), 1.0),
                   "post_attn_norm": full((L, H), 1.0)}
    if cfg.num_experts:
        E, I = cfg.num_experts, cfg.moe_intermediate_size
        mlp["router"] = w((L, H, E), s)
        mlp["w_gate_up"] = w((L, E, H, 2 * I), s)
        mlp["w_down"] = w((L, E, I, H), I ** -0.5)
        SI = cfg.shared_expert_intermediate_size
        if SI:
            mlp["shared_gate_up_proj"] = w((L, H, 2 * SI), s)
            mlp["shared_down_proj"] = w((L, SI, H), SI ** -0.5)
            mlp["shared_expert_gate"] = w((L, H, 1), s)
    else:
        I = cfg.intermediate_size
        mlp["gate_up_proj"] = w((L, H, 2 * I), s)
        mlp["down_proj"] = w((L, I, H), I ** -0.5)
    params["mlp_layers"] = mlp
    params["embed"] = w((cfg.vocab_size, H), 1.0)
    params["final_norm"] = full((H,), 1.0)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((H, cfg.vocab_size), s)
    draws.draw()
    return params


# ---------------------------------------------------------------------------
# Gated full attention
# ---------------------------------------------------------------------------

def _gated_attention(lp, x: torch.Tensor, batch: StepBatch, kv: HybridKV,
                     cfg: ModelConfig, cos_sin, *, max_q_len: int, li: int
                     ) -> torch.Tensor:
    """Layer ``li`` of the stacked K/V, addressed through the flat
    [La*P, ...] view with ``page_offset = li * P`` (as ``dense._attention``)."""
    T = x.shape[0]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    La, P, page = kv.k.shape[:3]
    k_cache = kv.k.view((La * P,) + kv.k.shape[2:])
    v_cache = kv.v.view((La * P,) + kv.v.shape[2:])
    qg, k, v = (x @ lp["qkv_proj"]).split([2 * Hq * D, Hkv * D, Hkv * D],
                                          dim=-1)
    qg = qg.view(T, Hq, 2 * D)
    q, gate = qg[..., :D], qg[..., D:]
    q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
    k = rms_norm(k.reshape(T, Hkv, D), lp["k_norm"], cfg.rms_norm_eps)
    q, k = apply_rope(q, k, batch.positions, cos_sin)
    write_kv(k_cache, v_cache, k, v.reshape(T, Hkv, D),
             batch.slot_mapping + li * (P * page))
    attn = paged_attention(q.contiguous(), k_cache, v_cache, batch.attn,
                           scale=D ** -0.5, max_q_len=max_q_len,
                           page_offset=li * P)
    attn = attn.reshape(T, Hq * D) * torch.sigmoid(
        gate.float().reshape(T, Hq * D)).to(x.dtype)
    return attn @ lp["o_proj"]


# ---------------------------------------------------------------------------
# Gated DeltaNet
# ---------------------------------------------------------------------------

def _gdn_layer(lp, x: torch.Tensor, batch: StepBatch,
               conv_state: torch.Tensor, rec_state: torch.Tensor,
               cfg: ModelConfig, *, max_q_len: int) -> torch.Tensor:
    """One Gated-DeltaNet layer over the flat ragged batch; conv_state /
    rec_state are this layer's pools ([slots, conv_dim, K-1] / [slots, Nv,
    Dk, Dv]), read and written in place through ``batch.ssm_slots``."""
    T = x.shape[0]
    Nk, Nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    Dk, Dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    r = Nv // Nk
    key_dim, value_dim = Nk * Dk, Nv * Dv
    slots = batch.ssm_slots.long()

    qkvz = (x @ lp["in_qkvz"]).view(T, Nk, 2 * Dk + 2 * r * Dv)
    ba = (x @ lp["in_ba"]).view(T, Nk, 2 * r)
    q, k = qkvz[..., :Dk], qkvz[..., Dk:2 * Dk]
    v = qkvz[..., 2 * Dk:2 * Dk + r * Dv].reshape(T, Nv, Dv)
    z = qkvz[..., 2 * Dk + r * Dv:].reshape(T, Nv, Dv)
    mixed = torch.cat([q.reshape(T, key_dim), k.reshape(T, key_dim),
                       v.reshape(T, value_dim)], dim=-1)
    beta = torch.sigmoid(ba[..., :r].reshape(T, Nv).float())
    g = -torch.exp(lp["a_log"].float()) * F.softplus(
        ba[..., r:].reshape(T, Nv).float() + lp["dt_bias"].float())
    conv_w = lp["conv_w"]

    def unpack(mx):
        # conv output → heads, the key heads repeated to Nv (GQA)
        lead = mx.shape[:-1]
        qh = mx[..., :key_dim].reshape(*lead, Nk, Dk)
        kh = mx[..., key_dim:2 * key_dim].reshape(*lead, Nk, Dk)
        vh = mx[..., 2 * key_dim:].reshape(*lead, Nv, Dv)
        if r > 1:
            qh = qh.repeat_interleave(r, dim=-2)
            kh = kh.repeat_interleave(r, dim=-2)
        return qh, kh, vh

    if max_q_len == 1:
        # pure decode: the flat rows are one per sequence (T == S)
        buf = torch.cat([conv_state[slots], mixed.float()[:, :, None]],
                        dim=-1)                          # [S, C, K]
        out_c = F.silu(torch.einsum("sck,ck->sc", buf, conv_w.float()))
        conv_state.index_copy_(0, slots, buf[..., 1:].contiguous())
        core, new_rec = recurrent_gated_delta_step(*unpack(out_c), g, beta,
                                                   rec_state[slots])
        rec_state.index_copy_(0, slots, new_rec)
    else:
        core = torch.zeros((T, Nv, Dv), dtype=torch.float32, device=x.device)
        n_rows, q_max = batch.num_seqs, batch.max_seq_q
        cu = batch.attn.cu_q_lens
        local = torch.arange(q_max, device=x.device)
        group = max(1, GDN_MAX_CELLS // q_max)
        for r0 in range(0, n_rows, group):
            r1 = min(n_rows, r0 + group)
            q_lens = cu[r0 + 1:r1 + 1] - cu[r0:r1]
            idx = (cu[r0:r1, None] + local).clamp(max=T - 1)  # [R, Qmax]
            valid = (local < q_lens[:, None])[..., None]
            out_c, new_conv = causal_conv1d(mixed[idx],
                                            conv_state[slots[r0:r1]],
                                            conv_w, q_lens)
            out, new_rec = chunk_gated_delta_rule(
                *unpack(out_c), torch.where(valid, g[idx], 0.0),
                torch.where(valid, beta[idx], 0.0),
                initial_state=rec_state[slots[r0:r1]])
            conv_state.index_copy_(0, slots[r0:r1], new_conv.contiguous())
            rec_state.index_copy_(0, slots[r0:r1], new_rec)
            # each real position gets its one row; padded cells add zeros
            core.index_add_(0, idx.reshape(-1),
                            torch.where(valid[..., None], out, 0.0)
                            .reshape(-1, Nv, Dv))
    out = rms_norm_gated(core.to(x.dtype), z, lp["gdn_norm"],
                         cfg.rms_norm_eps)
    return out.reshape(T, value_dim) @ lp["out_proj"]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mlp(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.num_experts:
        return moe.moe_mlp(lp, x, cfg)
    return dense._mlp(lp, x)


def forward(params: Params, kv: HybridKV, batch: StepBatch,
            cfg: ModelConfig, *, cos_sin: torch.Tensor, max_q_len: int,
            impl: str = "legacy") -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layers in ``cfg.layer_types`` order; returns (hidden,
    residual). The K/V and the slot pools are written in place. ``impl``
    must be "legacy" (a hybrid model takes no unified step)."""
    if impl != "legacy":
        raise NotImplementedError("the unified step with a hybrid model")
    hidden = params["embed"][batch.token_ids.long()]
    residual = torch.zeros_like(hidden)
    eps = cfg.rms_norm_eps
    mlp_layers = params["mlp_layers"]
    ai = gi = 0
    for li, ltype in enumerate(cfg.layer_types):
        mlp_lp = {name: t[li] for name, t in mlp_layers.items()}
        normed, residual = fused_add_rms_norm(hidden, residual,
                                              mlp_lp["input_norm"], eps)
        if ltype == "full_attention":
            lp = {name: t[ai] for name, t in params["attn_layers"].items()}
            mix = _gated_attention(lp, normed, batch, kv, cfg, cos_sin,
                                   max_q_len=max_q_len, li=ai)
            ai += 1
        else:
            lp = {name: t[gi] for name, t in params["gdn_layers"].items()}
            mix = _gdn_layer(lp, normed, batch, kv.conv[gi], kv.rec[gi], cfg,
                             max_q_len=max_q_len)
            gi += 1
        normed2, residual = fused_add_rms_norm(mix, residual,
                                               mlp_lp["post_attn_norm"], eps)
        hidden = _mlp(mlp_lp, normed2, cfg)
    return hidden, residual


compute_logits = dense.compute_logits
compute_full_logits = dense.compute_full_logits
# partial rotary: head_dim * partial_rotary_factor lanes rotate
make_rope_table = dense.make_rope_table


def max_gdn_cells(max_rows: int, max_q: int) -> int:
    """Padded cells of the largest group ``_gdn_layer`` forms for a batch
    of up to ``max_rows`` rows and ``max_q`` tokens a row."""
    return min(max_rows * max_q, max(GDN_MAX_CELLS, max_q))


# ---------------------------------------------------------------------------
# Checkpoint loading
# ---------------------------------------------------------------------------

def hybrid_rules(cfg: ModelConfig):
    """Qwen3-Next's checkpoint names → the JAX leaves of
    ``gllm_tpu/models/hybrid.py`` ``hybrid_rules:384`` (``models/loader.py``
    writes each into the port's layout): a layer index maps to its
    per-kind index (the i-th attention or GDN layer), layers past the
    config's depth are skipped, and the zero-centred norms take ``+ 1``
    before the cast to the leaf's dtype, in the dtype JAX's numpy sum
    takes: float32 for a bfloat16 file (ml_dtypes promotes bfloat16 plus
    a Python float to float32), the file's own dtype for any other."""
    attn_index, lin_index = {}, {}
    for i, t in enumerate(cfg.layer_types):
        if t == "full_attention":
            attn_index[i] = len(attn_index)
        else:
            lin_index[i] = len(lin_index)

    def plus1(leaf_name):
        # Qwen3-Next's RMSNorm scales by (1 + weight): fold the offset into
        # the stored weight so the standard rms_norm applies
        return lambda t: {leaf_name: (t.float() if t.dtype == torch.bfloat16
                                      else t) + 1.0}

    attn_leaves = {
        "self_attn.q_proj.weight": ("q_proj", "t"),
        "self_attn.k_proj.weight": ("k_proj", "t"),
        "self_attn.v_proj.weight": ("v_proj", "t"),
        "self_attn.o_proj.weight": ("o_proj", "t"),
        "self_attn.q_norm.weight": ("__multi__", plus1("q_norm")),
        "self_attn.k_norm.weight": ("__multi__", plus1("k_norm")),
    }
    gdn_leaves = {
        "linear_attn.in_proj_qkvz.weight": ("in_qkvz", "t"),
        "linear_attn.in_proj_ba.weight": ("in_ba", "t"),
        "linear_attn.dt_bias": ("dt_bias", None),
        "linear_attn.A_log": ("a_log", None),
        "linear_attn.norm.weight": ("gdn_norm", None),
        "linear_attn.out_proj.weight": ("out_proj", "t"),
    }
    mlp_leaves = {
        "input_layernorm.weight": ("__multi__", plus1("input_norm")),
        "post_attention_layernorm.weight": ("__multi__",
                                            plus1("post_attn_norm")),
        "mlp.gate_proj.weight": ("gate_proj", "t"),
        "mlp.up_proj.weight": ("up_proj", "t"),
        "mlp.down_proj.weight": ("down_proj", "t"),
        "mlp.gate.weight": ("router", "t"),
        "mlp.shared_expert.gate_proj.weight": ("shared_gate_proj", "t"),
        "mlp.shared_expert.up_proj.weight": ("shared_up_proj", "t"),
        "mlp.shared_expert.down_proj.weight": ("shared_down_proj", "t"),
        "mlp.shared_expert_gate.weight": ("shared_expert_gate", "t"),
    }
    expert_leaves = {
        "gate_proj.weight": ("w_gate", "t"),
        "up_proj.weight": ("w_up", "t"),
        "down_proj.weight": ("w_down", "t"),
    }

    def conv_tf(t):
        # HF Conv1d weight [C, 1, K] → [C, K]
        return {"conv_w": t.reshape(t.shape[0], t.shape[-1])}

    def rule(name: str):
        if name == "model.embed_tokens.weight":
            return (("embed",), None, None)
        if name == "model.norm.weight":
            return (("__multi__",), None, plus1("final_norm"))
        if name == "lm_head.weight":
            return (None if cfg.tie_word_embeddings
                    else (("lm_head",), None, "t"))
        if not name.startswith("model.layers."):
            return None
        idx_s, _, leaf = name[len("model.layers."):].partition(".")
        i = int(idx_s)
        if i >= cfg.num_layers:
            return None
        if leaf == "linear_attn.conv1d.weight":
            return (("gdn_layers", "__multi__"), lin_index[i], conv_tf)
        if leaf in attn_leaves:
            target, tf = attn_leaves[leaf]
            return (("attn_layers", target), attn_index[i], tf)
        if leaf in gdn_leaves:
            target, tf = gdn_leaves[leaf]
            return (("gdn_layers", target), lin_index[i], tf)
        if leaf in mlp_leaves:
            target, tf = mlp_leaves[leaf]
            return (("mlp_layers", target), i, tf)
        if leaf.startswith("mlp.experts."):
            e_s, _, el = leaf[len("mlp.experts."):].partition(".")
            if el in expert_leaves:
                target, tf = expert_leaves[el]
                return (("mlp_layers", target), (i, int(e_s)), tf)
        return None

    return rule


def load_params(model_dir: str, cfg: ModelConfig, dtype: torch.dtype,
                device):
    from gllm_tpu_torch.models.loader import load_params as _load
    return _load(model_dir, cfg, init_params, hybrid_rules(cfg), dtype,
                 device)
