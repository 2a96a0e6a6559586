"""The GQA ragged block's int8 arithmetic against the smoke's tolerance.

``csrc/ragged_wgmma.cuh`` runs the ragged rows of K1q and K1u over an int8
cache on the tensor cores: the int8 K and V tiles are widened to bf16
exactly, each key column's scale multiplies its float32 score, and each
value row's scale is folded into the softmax probability before the
probability is rounded to bf16 for the P.V product (the integers stay
exact). It walks the keys in 64-key tiles with a classic online softmax
whose running sum adds the unrounded probabilities. The fold is relative
to the value scale of the key that holds the row's running max, so that
key's probability stays exactly 1 when it is rounded. These tests emulate
that order on the CPU, on a mixed batch with ``chip_smoke.py``'s
statistics (standard normal bf16 q, standard normal K/V quantized per page
and kv head on the absmax grid, D 64), against
``ragged_paged_attention_plain``: the fold stays inside the smoke's
``RAGGED_TOL`` at pages of 16 and 4, and a dropped key is still rejected
by it. Folding the bare value scale (the largest probability rounded too)
leaves ``RAGGED_TOL`` on the first rows of the fresh chunk, which see a
few keys each.
"""

import numpy as np
import pytest
import torch

from chip_smoke import RAGGED_TOL, _quantize
from gllm_tpu_torch.ops.cuda.ragged_attention import (
    LOG2E, ragged_paged_attention_plain)
from gllm_tpu_torch.utils import cdiv

KEYS = 64  # keys a tile of the block


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small products: one thread, so that parallel test workers do not
    oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def block_int8(q, k8, v8, ks, vs, cu, kv_lens, pt, scale, relative=True):
    """The ragged block's output over an int8 cache, for every row of the
    batch, in q's dtype: per 64-key tile, scores q . k (integers) times the
    key scale, masked causally; p = 2^(s - m) with the running max m; the
    row sum adds p; P V adds bf16(p * v_scale / ref) . v (integers), ref
    the value scale of the running max's key (1 when not ``relative``),
    and the output is ref * (P V) / sum."""
    T, Hq, D = q.shape
    _, page, Hkv, _ = k8.shape
    G = Hq // Hkv
    out = torch.zeros((T, Hq, D))
    for s in range(len(kv_lens)):
        q0, ql, kl = int(cu[s]), int(cu[s + 1] - cu[s]), int(kv_lens[s])
        if ql == 0:
            continue
        pages = pt[s, :cdiv(kl, page)].long()
        k = k8[pages].reshape(-1, Hkv, D)[:kl].float()
        v = v8[pages].reshape(-1, Hkv, D)[:kl].float()
        ksc = ks[pages].repeat_interleave(page, 0)[:kl].T  # [Hkv, kl]
        vsc = vs[pages].repeat_interleave(page, 0)[:kl].T
        qs = q[q0:q0 + ql].float().reshape(ql, Hkv, G, D)
        pos = kl - ql + torch.arange(ql)
        m = torch.full((Hkv, G, ql), float("-inf"))
        l = torch.zeros((Hkv, G, ql))
        o = torch.zeros((Hkv, G, ql, D))
        ref = torch.ones((Hkv, G, ql))  # the value scale of the max's key
        for j0 in range(0, kl, KEYS):
            j = torch.arange(j0, min(j0 + KEYS, kl))
            sc = torch.einsum("qhgd,khd->hgqk", qs, k[j])
            sc = sc * ksc[:, None, None, j] * (scale * LOG2E)
            sc = sc.masked_fill(j[None, :] > pos[:, None], float("-inf"))
            mx, at = sc.max(-1)
            m_new = torch.maximum(m, mx)
            at_sc = vsc[:, j][:, None, None, :].expand(sc.shape).gather(
                -1, at[..., None])[..., 0]
            ref_new = (torch.where((mx > m) & (at_sc > 0), at_sc, ref)
                       if relative else ref)
            m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
            p = torch.exp2(sc - m_safe[..., None])
            alpha = torch.exp2(m - m_safe)
            l = l * alpha + p.sum(-1)
            fold = vsc[:, None, None, j] * (1.0 / ref_new)[..., None]
            pv = (p * fold).to(q.dtype).float()
            o = (o * (alpha * (ref / ref_new))[..., None]
                 + torch.einsum("hgqk,khd->hgqd", pv, v[j]))
            m, ref = m_new, ref_new
        res = o * ref[..., None] / torch.where(l > 0, l, 1.0)[..., None]
        out[q0:q0 + ql] = res.permute(2, 0, 1, 3).reshape(ql, Hq, D)
    return out.to(q.dtype)


def mixed_int8(page):
    """A mixed batch of ragged rows at the smoke's statistics: chunks in
    mid-context and fresh, and one-token rows after them (so in the ragged
    class, not the decode prefix), G 4 at D 64."""
    Hq, Hkv, D = 8, 2, 64
    seqs = [(128, 2048), (300, 812), (256, 256), (1, 1500), (1, 700),
            (1, 37)]
    gen = torch.Generator().manual_seed(0)
    n_pages = [cdiv(kl, page) for _, kl in seqs]
    P = 1 + sum(n_pages)
    perm = torch.randperm(P - 1, generator=gen) + 1
    pt = torch.zeros((len(seqs), max(n_pages)), dtype=torch.int32)
    at = 0
    for i, n in enumerate(n_pages):
        pt[i, :n] = perm[at:at + n]
        at += n
    kc = torch.randn((P, page, Hkv, D), generator=gen).bfloat16()
    vc = torch.randn((P, page, Hkv, D), generator=gen).bfloat16()
    k8, ks, _ = _quantize(kc)
    v8, vs, _ = _quantize(vc)
    cu = torch.tensor(np.cumsum([0] + [ql for ql, _ in seqs]),
                      dtype=torch.int32)
    kv_lens = torch.tensor([kl for _, kl in seqs], dtype=torch.int32)
    q = torch.randn((int(cu[-1]), Hq, D), generator=gen).bfloat16()
    drop = torch.tensor([int(ql == 1) for ql, _ in seqs], dtype=torch.int32)
    return q, k8, v8, ks, vs, cu, kv_lens, pt, drop, D ** -0.5


@pytest.mark.parametrize("page", [16, 4])
def test_int8_value_scale_fold_stays_inside_ragged_tol(page):
    q, k8, v8, ks, vs, cu, kv_lens, pt, drop, scale = mixed_int8(page)
    got = block_int8(q, k8, v8, ks, vs, cu, kv_lens, pt, scale).float()
    kw = dict(scale=scale, k_scale=ks, v_scale=vs)
    want = ragged_paged_attention_plain(q, k8, v8, cu, kv_lens, pt,
                                        **kw).float()
    dropped = ragged_paged_attention_plain(q, k8, v8, cu, kv_lens - drop,
                                           pt, **kw).float()
    rtol, atol = RAGGED_TOL
    err = (got - want).abs()
    used = (err / (atol + rtol * want.abs())).max().item()
    print(f"page {page}: max_abs_err {err.max().item():.3g}, "
          f"{used:.3f} of RAGGED_TOL used")
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, rtol=rtol, atol=atol)
    # the tolerance still sees one key left out of each one-token row
    assert not torch.allclose(got, dropped, rtol=rtol, atol=atol)


def test_bare_value_scale_fold_leaves_ragged_tol():
    """Why the fold is relative: with the bare value scale folded into P,
    the largest probability of a row is rounded as well, and on the first
    rows of the fresh chunk (a few keys each, outputs near 0 from terms
    of |p v| up to about 3) the error passes RAGGED_TOL."""
    q, k8, v8, ks, vs, cu, kv_lens, pt, _, scale = mixed_int8(16)
    got = block_int8(q, k8, v8, ks, vs, cu, kv_lens, pt, scale,
                     relative=False).float()
    want = ragged_paged_attention_plain(q, k8, v8, cu, kv_lens, pt,
                                        scale=scale, k_scale=ks,
                                        v_scale=vs).float()
    rtol, atol = RAGGED_TOL
    used = ((got - want).abs() / (atol + rtol * want.abs())).max().item()
    print(f"bare fold: {used:.3f} of RAGGED_TOL used")
    assert used > 1.0
