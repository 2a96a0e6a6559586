"""Checkpoint directories (counterpart of ``gllm_tpu/models/loader.py``:
``resolve_model_path:29``, ``load_hf_config:62``, ``LazySafetensors:85``,
``dense_rules:162``, ``_load_params:224``, ``chatglm_rules:270``,
``moe_rules:341``, ``deepseek_rules:406``; the hybrid family's rules are
``models/hybrid.py`` ``hybrid_rules``, as in JAX).

- A model directory holds ``config.json`` (``load_hf_config``) and the
  weights: ``model.safetensors.index.json`` with its shards, else one
  ``model.safetensors``, else ``pytorch_model.bin[.index.json]`` read with
  ``torch.load(..., weights_only=True, mmap=True)``, searched in that
  order (``LazySafetensors``). Safetensors files go through the port's
  own reader (``models/safetensors_reader.py``).
- A family's rules map each checkpoint tensor's name to (JAX param path,
  layer index or (layer, expert), transform): the first match wins, and a
  tensor no rule takes (another stage's layer: a config with fewer layers
  than the checkpoint skips the rest) is not read. The paths are the JAX
  package's leaf names; the port's fused tensors take each such leaf in
  its column range (``convert.fused_parts``).
- ``load_params`` allocates every parameter of the family first, zeroed,
  in ``init_params``' order (JAX zero-fills its template too, so a leaf
  the checkpoint lacks reads 0 in both packages), then streams the
  tensors: on a CUDA card each one is read into one reused pinned host
  buffer and copied in one transfer into one device buffer (both
  allocated after every weight and sized for the largest tensor), where
  its rule's transform runs as JAX's runs before its cast (a transpose or
  split is a view; the hybrid norms' ``+ 1`` in the dtype numpy gives
  it), and the result is cast into the parameter's slice (a layer, an
  expert, a fused column range). The transposes run on the card: on the
  host they held the load to about 0.5 GB/s on the H100's machine. No
  other device tensor of weight size is made while loading, so none
  strands memory under the KV pool, and no host copy of the model is
  built.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from gllm_tpu_torch.models.config import CHATGLM_ARCHS, ModelConfig
from gllm_tpu_torch.models.convert import _FUSED, fused_parts
from gllm_tpu_torch.models.safetensors_reader import SafetensorsFile

logger = logging.getLogger(__name__)


def resolve_model_path(model: str, allow_download: bool = False,
                       cache_dir: Optional[str] = None) -> str:
    """A local directory as it is; a hub id raises unless
    ``allow_download`` (``--allow-hub-download``), and then is fetched
    under a file lock per id, so that workers starting together fetch it
    once."""
    if os.path.isdir(model):
        return model
    if not allow_download:
        raise ValueError(
            f"model path {model!r} is not a local directory; pass "
            "--allow-hub-download to fetch it from the HF hub")
    import fcntl
    import hashlib
    cache_dir = cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "gllm_tpu_torch")
    lock_dir = os.path.join(cache_dir, "locks")
    os.makedirs(lock_dir, exist_ok=True)
    lock_path = os.path.join(
        lock_dir, hashlib.sha256(model.encode()).hexdigest()[:24] + ".lock")
    with open(lock_path, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            from huggingface_hub import snapshot_download
            return snapshot_download(model, cache_dir=cache_dir)
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def load_hf_config(model_dir: str) -> dict:
    """``config.json`` of ``model_dir`` as a dict, with the terminators
    that ``generation_config.json`` declares merged into its
    ``eos_token_id`` (checkpoints often list extra EOS ids only there)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    gen_path = os.path.join(model_dir, "generation_config.json")
    if os.path.exists(gen_path):
        try:
            with open(gen_path) as f:
                gen = json.load(f)
        except (OSError, json.JSONDecodeError):
            gen = {}
        ids = []
        for v in (hf.get("eos_token_id"), gen.get("eos_token_id")):
            if v is None:
                continue
            ids.extend(v if isinstance(v, list) else [v])
        if ids:
            hf["eos_token_id"] = list(dict.fromkeys(ids))
    return hf


class LazySafetensors:
    """The checkpoint's tensors by name, each file opened at most once and
    each tensor read on demand (peak host memory one tensor, not one
    checkpoint)."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        self._bin = False
        self._open_files: Dict[str, object] = {}
        index_path = os.path.join(model_dir, "model.safetensors.index.json")
        single_path = os.path.join(model_dir, "model.safetensors")
        bin_index = os.path.join(model_dir, "pytorch_model.bin.index.json")
        bin_single = os.path.join(model_dir, "pytorch_model.bin")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self.weight_map: Dict[str, str] = json.load(f)["weight_map"]
        elif os.path.exists(single_path):
            self.weight_map = {
                n: "model.safetensors"
                for n in self._file("model.safetensors").keys()}
        elif os.path.exists(bin_index) or os.path.exists(bin_single):
            self._bin = True
            if os.path.exists(bin_index):
                with open(bin_index) as f:
                    self.weight_map = json.load(f)["weight_map"]
            else:
                self.weight_map = {
                    n: "pytorch_model.bin"
                    for n in self._file("pytorch_model.bin")}
        else:
            raise FileNotFoundError(
                f"no safetensors or .bin checkpoint in {model_dir}")

    def names(self) -> Iterator[str]:
        return iter(self.weight_map)

    def _file(self, fname: str):
        if fname not in self._open_files:
            path = os.path.join(self.model_dir, fname)
            self._open_files[fname] = (
                torch.load(path, map_location="cpu", weights_only=True,
                           mmap=True)
                if self._bin else SafetensorsFile(path))
        return self._open_files[fname]

    def nbytes(self, name: str) -> int:
        """The bytes of ``name`` in its file (a safetensors header's)."""
        f = self._file(self.weight_map[name])
        if self._bin:
            return f[name].numel() * f[name].element_size()
        return f.tensors[name].nbytes

    def get(self, name: str,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``name`` on the CPU in its file dtype; a safetensors tensor's
        bytes land in ``out`` when given (see ``SafetensorsFile``)."""
        f = self._file(self.weight_map[name])
        if self._bin:
            return f[name]
        return f.get_tensor(name, out=out)

    def close(self) -> None:
        for f in self._open_files.values():
            if isinstance(f, SafetensorsFile):
                f.close()
        self._open_files = {}


# A rule maps a checkpoint tensor to (param path, layer index or None,
# transform): the path's last key the JAX leaf (or "__multi__", whose
# transform returns {leaf: tensor}), the index an int (layer) or (layer,
# expert), the transform "t" (transpose), None (as it is) or a callable
Rule = Tuple[Tuple[str, ...], Optional[object], Optional[object]]


def _split_gate_up(t: torch.Tensor) -> dict:
    # a fused [2I, H] gate_up → gate and up [H, I]
    gate, up = t.chunk(2, dim=0)
    return {"gate_proj": gate.t(), "up_proj": up.t()}


def _layer(name: str, prefix: str, num_layers: int):
    """(layer, leaf) of a per-layer tensor name under ``prefix``, or None
    (another prefix, or a layer past the config's depth)."""
    if not name.startswith(prefix):
        return None
    idx_s, _, leaf = name[len(prefix):].partition(".")
    i = int(idx_s)
    return (i, leaf) if i < num_layers else None


def dense_rules(cfg: ModelConfig) -> Callable[[str], Optional[Rule]]:
    """The dense GQA family (Llama / Qwen2 biases / Qwen3 q_norm, k_norm /
    GLM-4's fused ``mlp.gate_up_proj`` and sandwich norms)."""
    proj_map = {
        "self_attn.q_proj.weight": ("q_proj", "t"),
        "self_attn.k_proj.weight": ("k_proj", "t"),
        "self_attn.v_proj.weight": ("v_proj", "t"),
        "self_attn.o_proj.weight": ("o_proj", "t"),
        "self_attn.q_proj.bias": ("q_bias", None),
        "self_attn.k_proj.bias": ("k_bias", None),
        "self_attn.v_proj.bias": ("v_bias", None),
        "self_attn.q_norm.weight": ("q_norm", None),
        "self_attn.k_norm.weight": ("k_norm", None),
        "mlp.gate_proj.weight": ("gate_proj", "t"),
        "mlp.up_proj.weight": ("up_proj", "t"),
        "mlp.down_proj.weight": ("down_proj", "t"),
        "input_layernorm.weight": ("input_norm", None),
        "post_attention_layernorm.weight": ("post_attn_norm", None),
        "post_self_attn_layernorm.weight": ("post_self_attn_norm", None),
        "post_mlp_layernorm.weight": ("post_mlp_norm", None),
    }

    def rule(name: str) -> Optional[Rule]:
        if name == "model.embed_tokens.weight":
            return (("embed",), None, None)
        if name == "model.norm.weight":
            return (("final_norm",), None, None)
        if name == "lm_head.weight":
            return (None if cfg.tie_word_embeddings
                    else (("lm_head",), None, "t"))
        hit = _layer(name, "model.layers.", cfg.num_layers)
        if hit is None:
            return None
        i, leaf = hit
        if leaf == "mlp.gate_up_proj.weight":
            return (("layers", "__multi__"), i, _split_gate_up)
        if leaf in proj_map:
            target, tf = proj_map[leaf]
            return (("layers", target), i, tf)
        return None

    return rule


def chatglm_rules(cfg: ModelConfig) -> Callable[[str], Optional[Rule]]:
    """ChatGLM3's layout: fused ``query_key_value`` split by the heads'
    widths, fused ``dense_h_to_4h`` into gate and up, ``transformer.*``
    names."""
    q_rows = cfg.num_heads * cfg.head_dim
    kv_rows = cfg.num_kv_heads * cfg.head_dim

    def split_qkv_w(t):
        q, k, v = t.split([q_rows, kv_rows, kv_rows], dim=0)
        return {"q_proj": q.t(), "k_proj": k.t(), "v_proj": v.t()}

    def split_qkv_b(t):
        q, k, v = t.split([q_rows, kv_rows, kv_rows], dim=0)
        return {"q_bias": q, "k_bias": k, "v_bias": v}

    leaves = {
        "input_layernorm.weight": ("input_norm", None),
        "post_attention_layernorm.weight": ("post_attn_norm", None),
        "self_attention.dense.weight": ("o_proj", "t"),
        "mlp.dense_4h_to_h.weight": ("down_proj", "t"),
    }

    def rule(name: str) -> Optional[Rule]:
        if name == "transformer.embedding.word_embeddings.weight":
            return (("embed",), None, None)
        if name == "transformer.encoder.final_layernorm.weight":
            return (("final_norm",), None, None)
        if name == "transformer.output_layer.weight":
            return (("lm_head",), None, "t")
        hit = _layer(name, "transformer.encoder.layers.", cfg.num_layers)
        if hit is None:
            return None
        i, leaf = hit
        if leaf == "self_attention.query_key_value.weight":
            return (("layers", "__multi__"), i, split_qkv_w)
        if leaf == "self_attention.query_key_value.bias":
            return (("layers", "__multi__"), i, split_qkv_b)
        if leaf == "mlp.dense_h_to_4h.weight":
            return (("layers", "__multi__"), i, _split_gate_up)
        if leaf in leaves:
            target, tf = leaves[leaf]
            return (("layers", target), i, tf)
        return None

    return rule


def moe_rules(cfg: ModelConfig) -> Callable[[str], Optional[Rule]]:
    """Mixtral's ``block_sparse_moe.*`` and Qwen's ``mlp.experts.*`` /
    ``mlp.shared_expert*``, falling back to ``dense_rules``."""
    base = dense_rules(cfg)
    expert_leaves = {
        "w1.weight": ("w_gate", "t"), "w3.weight": ("w_up", "t"),
        "w2.weight": ("w_down", "t"),
        "gate_proj.weight": ("w_gate", "t"),
        "up_proj.weight": ("w_up", "t"),
        "down_proj.weight": ("w_down", "t"),
    }
    shared_leaves = {
        "shared_expert.gate_proj.weight": ("shared_gate_proj", "t"),
        "shared_expert.up_proj.weight": ("shared_up_proj", "t"),
        "shared_expert.down_proj.weight": ("shared_down_proj", "t"),
        "shared_expert_gate.weight": ("shared_expert_gate", "t"),
    }

    def rule(name: str) -> Optional[Rule]:
        hit = _layer(name, "model.layers.", cfg.num_layers)
        if hit is None:
            return base(name)
        i, leaf = hit
        if leaf in ("mlp.gate.weight", "block_sparse_moe.gate.weight"):
            return (("layers", "router"), i, "t")
        for prefix in ("mlp.experts.", "block_sparse_moe.experts."):
            if leaf.startswith(prefix):
                e_s, _, el = leaf[len(prefix):].partition(".")
                if el in expert_leaves:
                    target, tf = expert_leaves[el]
                    return (("layers", target), (i, int(e_s)), tf)
        if leaf.startswith("mlp.shared_expert"):
            key = leaf[len("mlp."):]
            if key in shared_leaves:
                target, tf = shared_leaves[key]
                return (("layers", target), i, tf)
        return base(name)

    return rule


def deepseek_rules(cfg: ModelConfig) -> Callable[[str], Optional[Rule]]:
    """DeepSeek V2/V3: the MLA projections (``kv_b_proj`` split into the
    absorbed ``w_uk`` / ``w_uv``), the dense-then-MoE layer groups, V3's
    ``e_score_correction_bias``. The DSA indexer's tensors map to leaves
    the port has not got (``load_params`` raises on them)."""
    k_dense = cfg.first_k_dense_replace
    nope, v, lora = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    Hq = cfg.num_heads

    def split_kv_b(t):
        # [Hq * (nope + v), lora] → w_uk [Hq, nope, lora], w_uv [Hq, lora, v]
        m = t.reshape(Hq, nope + v, lora)
        return {"w_uk": m[:, :nope, :],
                "w_uv": m[:, nope:, :].permute(0, 2, 1)}

    attn_map = {
        "self_attn.q_proj.weight": ("q_proj", "t"),
        "self_attn.q_a_proj.weight": ("q_a_proj", "t"),
        "self_attn.q_a_layernorm.weight": ("q_a_norm", None),
        "self_attn.q_b_proj.weight": ("q_b_proj", "t"),
        "self_attn.kv_a_proj_with_mqa.weight": ("kv_a_proj", "t"),
        "self_attn.kv_a_layernorm.weight": ("kv_a_norm", None),
        "self_attn.o_proj.weight": ("o_proj", "t"),
        "input_layernorm.weight": ("input_norm", None),
        "post_attention_layernorm.weight": ("post_attn_norm", None),
        "mlp.gate_proj.weight": ("gate_proj", "t"),
        "mlp.up_proj.weight": ("up_proj", "t"),
        "mlp.down_proj.weight": ("down_proj", "t"),
        "mlp.shared_experts.gate_proj.weight": ("shared_gate_proj", "t"),
        "mlp.shared_experts.up_proj.weight": ("shared_up_proj", "t"),
        "mlp.shared_experts.down_proj.weight": ("shared_down_proj", "t"),
        # the DSA lightning indexer (V3.2)
        "self_attn.indexer.wq_b.weight": ("idx_wq_b", "t"),
        "self_attn.indexer.wk.weight": ("idx_wk", "t"),
        "self_attn.indexer.k_norm.weight": ("idx_k_norm_w", None),
        "self_attn.indexer.k_norm.bias": ("idx_k_norm_b", None),
        "self_attn.indexer.weights_proj.weight": ("idx_weights", "t"),
    }
    expert_leaves = {
        "gate_proj.weight": ("w_gate", "t"),
        "up_proj.weight": ("w_up", "t"),
        "down_proj.weight": ("w_down", "t"),
    }

    def rule(name: str) -> Optional[Rule]:
        if name == "model.embed_tokens.weight":
            return (("embed",), None, None)
        if name == "model.norm.weight":
            return (("final_norm",), None, None)
        if name == "lm_head.weight":
            return (None if cfg.tie_word_embeddings
                    else (("lm_head",), None, "t"))
        hit = _layer(name, "model.layers.", cfg.num_layers)
        if hit is None:
            return None
        i, leaf = hit
        group = "dense_layers" if i < k_dense else "moe_layers"
        li = i if i < k_dense else i - k_dense
        if leaf == "self_attn.kv_b_proj.weight":
            return ((group, "__multi__"), li, split_kv_b)
        if leaf in attn_map:
            target, tf = attn_map[leaf]
            return ((group, target), li, tf)
        if leaf == "mlp.gate.weight":
            return ((group, "router"), li, "t")
        if leaf == "mlp.gate.e_score_correction_bias":
            return ((group, "e_bias"), li, None)
        if leaf.startswith("mlp.experts."):
            e_s, _, el = leaf[len("mlp.experts."):].partition(".")
            if el in expert_leaves:
                target, tf = expert_leaves[el]
                return ((group, target), (li, int(e_s)), tf)
        return None

    return rule


class _Staging:
    """Where a tensor passes on its way to a CUDA card: one pinned host
    buffer that the file's bytes are read into and one device buffer they
    are copied to in one transfer, each sized once for the largest
    tensor; the rule's transform then runs on the device copy (views, and
    JAX's arithmetic in its dtypes: exact on either side) and writes into
    the parameter's slice. On the CPU a tensor is read into a buffer of
    its own and transformed there."""

    def __init__(self, device: torch.device, nbytes: int):
        self.cuda = device.type == "cuda"
        self.read = self.dev = None
        if self.cuda:
            # pinned in place at its own size (torch's pinned allocator
            # rounds a block up to a power of two and caches it for the
            # process), and unpinned by close()
            self.read = torch.empty(nbytes, dtype=torch.uint8)
            err = torch.cuda.cudart().cudaHostRegister(
                self.read.data_ptr(), nbytes, 0)
            if int(getattr(err, "value", err)) != 0:
                raise RuntimeError(f"cudaHostRegister of the {nbytes}-byte "
                                   f"staging buffer failed: {err}")
            self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device)

    def stage(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (read into ``self.read``, or a ``.bin`` file's tensor) on
        the device the parameters live on."""
        if not self.cuda:
            return t
        n = t.numel() * t.element_size()
        dev = self.dev[:n].view(t.dtype).view(t.shape)
        dev.copy_(t)
        return dev

    def close(self) -> None:
        if self.cuda and self.read is not None:
            torch.cuda.synchronize()
            torch.cuda.cudart().cudaHostUnregister(self.read.data_ptr())
            self.read = self.dev = None
            torch.cuda.empty_cache()


def _destinations(params, cfg: ModelConfig) -> Dict[tuple, tuple]:
    """(group or None, JAX leaf) → (the port's tensor, its name, first and
    end column, or None for the whole last axis)."""
    out = {}

    def add(group, name, t):
        if name in _FUSED:
            for leaf, a, b in fused_parts(name, t.shape[-1], cfg):
                out[(group, leaf)] = (t, name, a, b)
        else:
            out[(group, name)] = (t, name, None, None)
    for group, x in params.items():
        if isinstance(x, dict):
            for name, t in x.items():
                add(group, name, t)
        else:
            add(None, group, x)
    return out


def _load_one(name: str, rule: Rule, lazy: LazySafetensors,
              staging: _Staging, dests: dict, written: set,
              cfg: ModelConfig) -> int:
    """Read checkpoint tensor ``name``, transform it by its ``rule`` and
    write it into its parameters' slices; returns the bytes read. Its
    views of the staging buffers end with the call, so that ``close``
    hands the device buffer back whole (a view left alive kept it in the
    allocator's cache, where the rope table, allocated next, split it and
    stranded the rest under the KV pool: 0.56 GiB for Qwen3-30B-A3B)."""
    path, idx, tf = rule
    t = staging.stage(lazy.get(name, out=staging.read))
    group = path[0] if len(path) > 1 else None
    if callable(tf):
        items = tf(t).items()
    else:
        items = [(path[-1], t.t() if tf == "t" else t)]
    for leaf, arr in items:
        if (group, leaf) not in dests:
            if leaf.startswith("idx_"):
                raise NotImplementedError(
                    f"checkpoint tensor {name!r} belongs to the DeepSeek "
                    "sparse attention indexer, not supported by "
                    "gllm_tpu_torch yet (ROADMAP A 11)")
            raise KeyError(
                f"checkpoint tensor {name!r} maps to {leaf!r}, which the "
                f"{cfg.architecture} parameters of this config have not got")
        dst, port_name, a, b = dests[(group, leaf)]
        view = dst if idx is None else dst[idx]
        if a is not None:
            view = view[..., a:b]
        if tuple(view.shape) != tuple(arr.shape):
            raise ValueError(
                f"checkpoint tensor {name!r} gives {leaf!r} shape "
                f"{tuple(arr.shape)}, the config {tuple(view.shape)}")
        view.copy_(arr)
        written.add((group, port_name))
    return t.numel() * t.element_size()


def load_params(model_dir: str, cfg: ModelConfig, init_params: Callable,
                rules: Callable[[str], Optional[Rule]], dtype: torch.dtype,
                device) -> Tuple[dict, dict]:
    """The family's parameters (``init_params``' layout, zero where no
    tensor wrote) filled from the checkpoint in ``model_dir`` by ``rules``,
    on ``device``; and the load's numbers: seconds, bytes read, GB/s,
    tensors read, and the parameters no tensor wrote."""
    t0 = time.monotonic()
    device = torch.device(device)
    template = init_params(cfg, 0, dtype, "meta")

    def zeros(t):
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    params = {g: ({n: zeros(t) for n, t in x.items()}
                  if isinstance(x, dict) else zeros(x))
              for g, x in template.items()}
    dests = _destinations(params, cfg)
    written = set()
    lazy = LazySafetensors(model_dir)
    staging = None
    try:
        todo = [(n, r) for n, r in ((n, rules(n)) for n in lazy.names())
                if r is not None]
        staging = _Staging(device, max((lazy.nbytes(n) for n, _ in todo),
                                       default=1))
        nbytes = 0
        for name, rule in todo:
            nbytes += _load_one(name, rule, lazy, staging, dests, written,
                                cfg)
    finally:
        lazy.close()
        if staging is not None:
            staging.close()
    seconds = time.monotonic() - t0
    unwritten = [f"{g}.{n}" if g else n
                 for g, n in {(g, v[1]) for (g, _), v in dests.items()}
                 if (g, n) not in written]
    logger.info("loaded %d tensors (%.3f GB) from %s in %.2f s (%.2f GB/s); "
                "%d parameters no tensor wrote%s", len(todo), nbytes / 1e9,
                model_dir, seconds, nbytes / 1e9 / max(seconds, 1e-9),
                len(unwritten),
                f" (left zero: {sorted(unwritten)})" if unwritten else "")
    return params, dict(seconds=seconds, bytes=nbytes,
                        gbps=nbytes / 1e9 / max(seconds, 1e-9),
                        tensors=len(todo), unwritten=sorted(unwritten))


def load_dense_params(model_dir: str, cfg: ModelConfig, dtype, device):
    from gllm_tpu_torch.models import dense
    rules = (chatglm_rules(cfg) if cfg.architecture in CHATGLM_ARCHS
             else dense_rules(cfg))
    return load_params(model_dir, cfg, dense.init_params, rules, dtype,
                       device)


def load_moe_params(model_dir: str, cfg: ModelConfig, dtype, device):
    """The MoE family: its mixed stack's flags come from the config
    (``moe.moe_layer_mask``), never from the checkpoint."""
    from gllm_tpu_torch.models import moe
    return load_params(model_dir, cfg, moe.init_params, moe_rules(cfg),
                       dtype, device)


def load_deepseek_params(model_dir: str, cfg: ModelConfig, dtype, device):
    from gllm_tpu_torch.models import deepseek
    return load_params(model_dir, cfg, deepseek.init_params,
                       deepseek_rules(cfg), dtype, device)
