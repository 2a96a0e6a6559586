#!/usr/bin/env python3
"""Where K1's one-token rows run: the split-KV decode blocks or the ragged
block. Times K1 (``ragged_paged_attention``) on the card at the smoke's
mixed shape (Llama-3.2-1B attention, T 2048, S 32: 24 decode rows and
chunks of 512, 300 and 1024 tokens) over a bf16, an int8 and an fp8
cache, two ways:

- ``prefix``: the batch as the runner builds it, the one-token rows first,
  so they form the decode prefix and run the decode blocks;
- ``ragged``: the same sequences with the chunks first, so no sequence is
  in the decode prefix and every row runs the ragged block.

Both orders must give the same rows (checked against the plain version).
Device time per call (torch.profiler, every launch summed; a reading
below the time the card needs to read the K/V once is taken again, as
the smoke does), in turns: prefix, ragged, ragged, prefix. Prints the
card's name and power limit, then one JSON line per cache.

    python3 tools/ragged_split_ab.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def reorder(x, order):
    """The mixed batch of ``x`` with its real sequences in ``order``: q
    rows, cu_q_lens, kv_lens and page-table rows permuted, padding kept at
    the end. Returns (q, cu, kv_lens, page_table, rows) with ``rows`` the
    new position of every old real token."""
    seqs, cu = x["seqs"], x["cu_np"]
    dev = x["q"].device
    S_pad = len(x["kv"])
    old_rows = [np.arange(cu[s], cu[s + 1]) for s in order]
    rows_new = np.concatenate(old_rows)
    q = x["q"].clone()
    q[:len(rows_new)] = x["q"][torch.from_numpy(rows_new).to(dev)]
    lens = [seqs[s][0] for s in order]
    cu_new = np.zeros(S_pad + 1, np.int32)
    cu_new[1:len(order) + 1] = np.cumsum(lens)
    cu_new[len(order) + 1:] = cu_new[len(order)]
    perm = list(order) + list(range(len(order), S_pad))
    idx = torch.tensor(perm, device=dev)
    inv = np.empty_like(rows_new)
    inv[rows_new] = np.arange(len(rows_new))
    return (q, torch.from_numpy(cu_new).to(dev), x["kvl"][idx],
            x["pt"][idx], torch.from_numpy(inv).to(dev))


def main():
    if not torch.cuda.is_available():
        print("ragged_split_ab: no CUDA device", file=sys.stderr)
        return 2
    from gllm_tpu_torch.ops.cuda import ragged_attention as rag
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    cs.decode_shape(rng, dev)  # the smoke's order of draws
    x = cs.mixed_shape(rng, dev)
    n = len(x["seqs"])
    chunks = [s for s, (ql, _) in enumerate(x["seqs"]) if ql > 1]
    singles = [s for s, (ql, _) in enumerate(x["seqs"]) if ql == 1]
    q2, cu2, kvl2, pt2, inv = reorder(x, chunks + singles)
    T_real = x["T_real"]
    scale = 64 ** -0.5
    for cache, (kc, vc, sc, _, _) in cs._caches(x).items():
        kw = dict(scale=scale, **sc)
        a = lambda: rag.ragged_paged_attention(x["q"], kc, vc, x["cu"],
                                               x["kvl"], x["pt"], **kw)
        b = lambda: rag.ragged_paged_attention(q2, kc, vc, cu2, kvl2, pt2,
                                               **kw)
        want = rag.ragged_paged_attention_plain(x["q"], kc, vc, x["cu"],
                                                x["kvl"], x["pt"], **kw)
        got_b = b()[inv][:T_real]
        rtol, atol = cs.RAGGED_TOL
        ok = (torch.allclose(a().float()[:T_real], want.float()[:T_real],
                             rtol=rtol, atol=atol)
              and torch.allclose(got_b.float(), want.float()[:T_real],
                                 rtol=rtol, atol=atol))
        floor = cs.bound(cs._kv_bytes(x["kv"], x["page"], 8, 64, cache),
                         0)[0]
        times = {"prefix": [], "ragged": []}
        for name in ("prefix", "ragged", "ragged", "prefix"):
            split = cs.timed_above_bound(a if name == "prefix" else b, 20,
                                         floor)
            times[name].append(sum(split.values()))
        print(json.dumps({"cache": cache, "sequences": n, "ok": ok,
                          "prefix_ms": times["prefix"],
                          "ragged_ms": times["ragged"], "card": smi}),
              flush=True)
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
