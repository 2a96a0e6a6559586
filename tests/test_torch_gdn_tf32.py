"""K3's tolerances against the arithmetic of its tensor-core products.

``csrc/gdn_scan.cu`` runs the gated-delta-rule chunk scan on the tensor
cores: every float32 operand is split into hi = tf32(x) and lo = x - hi
(of which the MMA reads the TF32 bits), and a product sums lo.hi + hi.lo
+ hi.hi (3xTF32). These
tests emulate that order on the CPU in float32, with the row scalings
applied after the products as the kernel applies them, on operands built
as ``chip_smoke.py`` builds K3's (its statistics: one row of 4 heads at
Dk = Dv = 128, 16 chunks of 64, real for its first ``real`` tokens and
padded past them as the hybrid mixed step pads short rows), against
``gdn_chunk_scan_plain``.

3xTF32 stays inside the smoke's ``GDN_TOL`` and inside the float32
tolerance K3's card tests hold the kernel to (``tests/test_torch_cuda.py``,
1e-4). One TF32 pass stays inside ``GDN_TOL`` too (it uses 18-33% of it
at these statistics: the state decays within a chunk or, past a short
row's end, carries unchanged, so rounding errors do not build up over the
chunks), but leaves the card tests' tolerance: those, not the smoke's,
tell the two apart.
"""

import numpy as np
import pytest
import torch

from chip_smoke import GDN_TOL
from gllm_tpu_torch.ops.cuda.gdn_scan import gdn_chunk_scan_plain
from gllm_tpu_torch.ops.gdn import chunk_scan_operands


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 and the kernel's tf32_split do: add half of
    the dropped bits' range to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """The TF32 bits the MMA reads of a float32 operand: the low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as the kernel's mma3: hi rounded, lo = x - hi read by the MMA
    truncated; the small terms first, then hi.hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def scan_emulated(mm, qc, kc, v2, kcd, attn, gcum, state):
    """The kernel's chunk step with its products through ``mm``: v_new =
    v2 - kcd S; out = diag(e^g) (q S) + attn v_new; S = e^{g_C} S +
    k^T (diag(e^{g_C - g}) v_new)."""
    outs = []
    for n in range(qc.shape[1]):
        g = gcum[:, n]                                      # [B, C, 1]
        v_new = v2[:, n] - mm(kcd[:, n], state)
        outs.append(torch.exp(g) * mm(qc[:, n], state)
                    + mm(attn[:, n], v_new))
        g_last = g[:, -1:]
        state = (torch.exp(g_last) * state
                 + mm(kc[:, n].transpose(-1, -2),
                      torch.exp(g_last - g) * v_new))
    return torch.stack(outs, dim=1), state


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small float32 products: one thread each, so that parallel test
    workers do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the tolerance of K3's card tests (test_gdn_scan_kernel_matches_plain,
# test_gdn_scan_block_matches_plain): float32 on both sides
CARD_TOL = (1e-4, 1e-4)
_cache = {}


def operands(real):
    """K3's operands and the plain scan for one row of 1024 tokens and 4
    heads, real for the first ``real``: q, k, v and the initial state
    standard normal, decay g = -U(0, 0.5) and write strength beta =
    U(0, 1) on the real tokens and 0 past them, as
    chip_smoke.gdn_scan_kernel draws them."""
    if real not in _cache:
        rng = np.random.default_rng(7)
        T, H, D = 1024, 4, 128

        def t(a):
            return torch.from_numpy(a.astype(np.float32))
        q, k, v = (t(rng.standard_normal((1, T, H, D))) for _ in range(3))
        valid = (np.arange(T) < real)[None, :, None]
        g = t(np.where(valid, -0.5 * rng.random((1, T, H)), 0.0))
        beta = t(np.where(valid, rng.random((1, T, H)), 0.0))
        init = t(rng.standard_normal((1, H, D, D)))
        args = chunk_scan_operands(q, k, v, g, beta, init)
        assert args[0].shape == (4, 16, 64, 128)    # B, N, C, Dk
        _cache[real] = args, gdn_chunk_scan_plain(*args)
    return _cache[real]


def _within(got, want, tol):
    rtol, atol = tol
    return all(torch.allclose(a, b, rtol=rtol, atol=atol)
               for a, b in zip(got, want))


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
                      -(1 + 2 ** -11), 1 + 2 ** -12, 3.0e-30])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -9,
                         -(1 + 2 ** -10), 1.0, 3.0e-30])
    got = tf32(x)
    assert torch.equal(got[:5], want[:5])
    assert abs(got[5].item() / 3.0e-30 - 1) < 2 ** -10


# the smoke's row kinds: a one-token row, a 300-token chunk and a full one
ROWS = [1, 300, 1024]


@pytest.mark.parametrize("real", ROWS)
def test_3xtf32_scan_stays_inside_the_smoke_tolerance(real):
    args, want = operands(real)
    got = scan_emulated(mm_3xtf32, *args)
    assert _within(got, want, GDN_TOL)
    assert _within(got, want, CARD_TOL)


@pytest.mark.parametrize("real", ROWS)
def test_one_tf32_pass_leaves_the_card_tolerance(real):
    args, want = operands(real)
    got = scan_emulated(mm_1xtf32, *args)
    assert not _within(got, want, CARD_TOL)
    assert _within(got, want, GDN_TOL)   # the smoke's check alone is blind
