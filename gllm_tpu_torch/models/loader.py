"""Checkpoint directory reading (counterpart of
``gllm_tpu/models/loader.py``, ``load_hf_config:62`` only).

The port reads a model directory's ``config.json`` (and the EOS ids of
its ``generation_config.json``) to build a ``ModelConfig``; it loads no
checkpoint weights yet (``load_format="dummy"`` draws them from a seed).
"""

from __future__ import annotations

import json
import os


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
