"""Parity of the port's flash-attention wrapper with the JAX reference.

The same numpy inputs (``np.random.default_rng``) go through ``repro``
and ``repro_torch``.  On the CPU the port's wrapper runs its plain
version; the reference runs its jnp oracle and its Pallas kernel in
interpret mode.  Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-4 for f32, 5e-2 for bf16.

The CUDA kernel itself runs only on the card, so its f32 arithmetic is
emulated here in numpy: TF32 rounding (``cvt.rna``), the 3xTF32 hi/lo
split, the kernel's key-tile loop and the key permutation that lets the
QK^T score fragment feed PV, held against the JAX reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref

from repro_torch import convert
from repro_torch.kernels import autotune as tat
from repro_torch.kernels.flash_attention import flash_attention as tker
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref


def _inputs(B, S_q, H, hd, dtype, seed, S_k=None):
    """Reference arrays and the port's tensors holding the same values."""
    rng = np.random.default_rng(seed)
    S_k = S_k or S_q
    arrays = [rng.normal(size=(B, S, H, hd)).astype(np.float32) * sc
              for S, sc in ((S_q, 0.3), (S_k, 0.3), (S_k, 1.0))]
    js = [jnp.asarray(a, dtype) for a in arrays]
    return js, [convert.to_tensor(np.asarray(j)) for j in js]


def _close(out, exp, tol):
    np.testing.assert_allclose(convert.to_numpy(out).astype(np.float32),
                               np.asarray(exp, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,S,H,hd", [(1, 128, 2, 32), (2, 128, 2, 64),
                                      (1, 128, 1, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0), (False, 32)])
def test_attention_matches_reference_and_pallas(B, S, H, hd, causal,
                                                window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, H, hd, jnp.float32,
                                         seed=S + hd)
    out = tops.attention(tq, tk, tv, causal=causal, window=window)
    assert out.shape == tq.shape and out.dtype == torch.float32
    _close(out, jref.attention(jq, jk, jv, causal=causal, window=window),
           2e-4)
    _close(out, jops.attention(jq, jk, jv, causal=causal, window=window,
                               bq=64, bk=64), 2e-4)


@pytest.mark.parametrize("S,window", [(100, 0), (97, 16), (211, 64)])
def test_attention_sequence_no_block_divides(S, window):
    """S = 100, 97 (prime) and 211 (prime): the reference snaps its
    blocks to divisors; the port's kernel masks the ragged edge."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, S, 2, 32, jnp.float32, seed=S)
    out = tops.attention(tq, tk, tv, window=window)
    _close(out, jref.attention(jq, jk, jv, window=window), 2e-4)
    _close(out, jops.attention(jq, jk, jv, window=window), 2e-4)


def test_attention_cross_lengths():
    """S_q != S_k, bidirectional: positions start at 0 on both sides."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 64, 2, 32, jnp.float32, seed=3,
                                         S_k=128)
    for causal in (True, False):
        out = tops.attention(tq, tk, tv, causal=causal)
        _close(out, jref.attention(jq, jk, jv, causal=causal), 2e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_attention_bf16(causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 128, 2, 64, jnp.bfloat16,
                                         seed=0)
    out = tops.attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    _close(out, jref.attention(jq, jk, jv, causal=causal, window=window),
           5e-2)
    _close(out, jops.attention(jq, jk, jv, causal=causal, window=window,
                               bq=64, bk=64), 5e-2)


def test_attention_plain_version_is_the_cpu_path():
    _, (tq, tk, tv) = _inputs(1, 64, 2, 32, jnp.float32, seed=5)
    assert torch.equal(tops.attention(tq, tk, tv, window=8, bq=32, bk=16),
                       tref.attention(tq, tk, tv, window=8))


def test_attention_refuses_devices_it_has_no_kernel_for():
    q = torch.empty((1, 8, 1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.attention(q, q, q)


def test_smem_formula_and_defaults_fit_every_head_dim():
    # the query tile + 2 stages of K and V tiles, rows padded by 16 bytes
    assert tker.smem_bytes(128, 64, 64) == (128 + 4 * 64) * (64 * 4 + 16)
    assert tker.smem_bytes(64, 32, 128, es=2) == (64 + 128) * (128 * 2 + 16)
    assert tker.smem_bytes(128, 64, 128) == 202_752 <= tker.SMEM_MAX
    d = tat.DEFAULTS["flash_attention"]
    for hd in tker.HEAD_DIMS:
        for es in (4, 2):
            assert tker.accepts(d["bq"], d["bk"], hd, es)
            assert tker.smem_bytes(d["bq"], d["bk"], hd, es) <= tker.SMEM_MAX
    assert d["bq"] % tker.WARP_ROWS == 0 and d["bq"] <= tker.MAX_BQ
    assert d["bk"] in tker.BK_BUILT
    # what the kernel is not built for: a bq off the 16-row warp grid, a
    # block over 8 warps, a key tile not instantiated, an odd head dim
    assert not any(tker.accepts(bq, bk, hd) for bq, bk, hd in (
        (40, 64, 64), (256, 32, 64), (128, 16, 64), (128, 128, 64),
        (64, 32, 96)))


# ------------------------------------------- the kernel's f32 arithmetic
# The k-column c of PV's tf32 A fragment holds key PERM[c] of its 8-key
# group, so that the QK^T accumulator a thread holds is its A fragment.
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def _rna(x):
    """TF32 rounding as ``cvt.rna.tf32.f32``: to 10 mantissa bits, to
    nearest, ties away from zero; the kernel's integer form."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _product(a, b, terms):
    """a @ b as the tensor cores take it: 3xTF32 (lo*hi + hi*lo, then
    hi*hi, into f32) or a single TF32 product."""
    a_hi, b_hi = _rna(a), _rna(b)
    if terms == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _rna(a - a_hi), _rna(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _emulate(q, k, v, *, causal, window, terms, bq=64, bk=32):
    """The kernel's f32 path on one head, q (S_q, hd), k, v (S_k, hd):
    its query blocks and key-tile bounds, masks (finite NEG_INF, -inf
    past S_k), the online softmax in log2 units (x = s * hd^-0.5 *
    log2(e), p = 2^(x - m)), and PV with each 8-key group's rows taken
    in PERM order."""
    S_q, hd = q.shape
    S_k = k.shape[0]
    neg = np.float32(tref.NEG_INF)
    scale_log2 = np.float32(hd ** -0.5) * np.float32(np.log2(np.e))
    out = np.zeros_like(q)
    order = np.arange(bk) // 8 * 8 + np.array(PERM)[np.arange(bk) % 8]
    for q0 in range(0, S_q, bq):
        n = min(bq, S_q - q0)
        rows = np.arange(q0, q0 + bq)[:, None]
        qb = np.zeros((bq, hd), np.float32)
        qb[:n] = q[q0:q0 + n]
        lo = max(0, q0 - window + 1) if window else 0
        hi = min(S_k, q0 + bq) if causal else S_k
        m = np.full(bq, neg, np.float32)
        l = np.zeros(bq, np.float32)
        acc = np.zeros((bq, hd), np.float32)
        for t0 in range(lo, hi, bk):
            keys = np.arange(t0, t0 + bk)[None, :]
            kt, vt = (np.zeros((bk, hd), np.float32) for _ in range(2))
            kt[:S_k - t0], vt[:S_k - t0] = k[t0:t0 + bk], v[t0:t0 + bk]
            s = _product(qb, kt.T, terms) * scale_log2
            ok = np.ones((bq, bk), bool)
            if causal:
                ok &= rows >= keys
            if window:
                ok &= rows - keys < window
            s = np.where(keys < S_k, np.where(ok, s, neg),
                         np.float32(-np.inf))
            m_new = np.maximum(m, s.max(1))
            p = np.exp2(s - m_new[:, None])
            corr = np.exp2(m - m_new)
            l = l * corr + p.sum(1)
            acc = acc * corr[:, None] + _product(p[:, order], vt[order],
                                                 terms)
            m = m_new
        out[q0:q0 + n] = (acc / np.maximum(l, np.float32(1e-30))[:, None])[:n]
    return out


def test_integer_split_is_cvt_rna_rounding():
    """The kernel's integer rounding equals round-to-nearest, ties away,
    at 11 significant bits, computed here in float64."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(
        -20, 20, 4000), [0.0, -0.0, 1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                         -(1 + 2 ** -11), 2 ** -126]]).astype(np.float32)
    mant, exp = np.frexp(x.astype(np.float64))
    scaled = mant * 2.0 ** 11
    want = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5) * 2.0 ** (exp - 11)
    np.testing.assert_array_equal(_rna(x), want.astype(np.float32))
    # hi + lo carries ~22 of x's 24 bits: the 3xTF32 operand
    hi = _rna(x)
    err = np.abs(hi + _rna(x - hi) - x.astype(np.float64))
    assert (err <= np.abs(x) * 2.0 ** -21).all()


def test_pv_key_permutation_matches_the_fragment_layouts():
    """m16n8k8 layouts (PTX ISA): the QK^T accumulator c0..c3 of lane
    (g, t) is (row, key) (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1); PV's
    A fragment a0..a3 is (row, k-column) (g, t), (g+8, t), (g, t+4),
    (g+8, t+4), and its B fragment b0, b1 is k-rows t, t+4.  The kernel
    passes a = (c0, c2, c1, c3) and reads V's rows 2t, 2t+1: under PERM
    both operands of every k-column name the same key."""
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]
        a = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
        for (row, col), (c_row, key) in zip(a, [c[0], c[2], c[1], c[3]]):
            assert (row, PERM[col]) == (c_row, key)
        assert [PERM[t], PERM[t + 4]] == [2 * t, 2 * t + 1]   # V rows read
    assert sorted(PERM) == list(range(8))


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)],
                         ids=["causal", "window", "bidirectional"])
def test_3xtf32_holds_the_reference_and_1xtf32_does_not(hd, causal,
                                                        window):
    """Unit-variance q and k (logits of std 1), S = 256 in 64-row blocks
    and 32-key tiles: the emulated kernel with 3xTF32 products stays
    within the reference's f32 tolerance (2e-4), one TF32 product per
    product exceeds it."""
    B, S, H = 1, 256, 2
    rng = np.random.default_rng(hd + S)
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jref.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window))
    limit = 2e-4 + 2e-4 * np.abs(want)
    got = {terms: np.stack([_emulate(q[0, :, h], k[0, :, h], v[0, :, h],
                                     causal=causal, window=window,
                                     terms=terms) for h in range(H)],
                           1)[None] for terms in (3, 1)}
    np.testing.assert_allclose(got[3], want, rtol=2e-4, atol=2e-4)
    assert (np.abs(got[1] - want) > limit).any()
