"""K3's fused mode on the card (marker ``cuda``; skips without a card).

``ops.selective_scan`` launches K3 in its fused mode: it reads dt, u, A,
Bc and C and forms ``a = exp(dt A)`` and ``b = u Bc`` in registers.  It is
held against K3's (a, b) mode on the a and b the model's own ops
materialize (``ops._tail``): h_last and y bit for bit (the readout keeps
the (a, b) mode's order), at Hymba-1.5B's training shape, Falcon-Mamba-7B's
width and ragged shapes, at every block size the autotuner may pick.
``SelectiveScan``'s outputs and gradients equal ``ops.ssm_backward``'s on
the same inputs; its forward allocates no (B, S, d_inner, d_state) f32
tensor; a Hymba-1.5B training step launches K3 128 times, all fused.
Run on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_mamba_scan_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.mamba_scan import ops

pytestmark = pytest.mark.cuda

# (label, B, S, di, st): Hymba-1.5B's training microbatch, Falcon-Mamba-7B
# at its width, ragged S, di and st (S past a whole chunk, di off the
# 4-float copies and off every block, st 1, 5 and 32)
SHAPES = [
    ("hymba-1.5b train", 4, 2048, 3200, 16),
    ("falcon-mamba-7b", 1, 2048, 8192, 16),
    ("ragged 2x37x50x5", 2, 37, 50, 5),
    ("ragged 3x70x33x1", 3, 70, 33, 1),
    ("ragged 1x45x97x32", 1, 45, 97, 32),
    ("ragged 2x129x200x16", 2, 129, 200, 16),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3's fused mode has no CPU build")
    return torch.device("cuda", 0)


def _inputs(dev, B, S, di, st, seed=0):
    """A Mamba layer's scan inputs: dt after a softplus, A = -exp(A_log),
    u = dt x1, Bc, C and h0; f32, contiguous."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    dt = 0.005 + 0.5 * torch.rand(B, S, di, generator=g, **f32)
    A = -torch.arange(1, st + 1, **f32) * (
        0.5 + torch.rand(di, st, generator=g, **f32))
    u = dt * torch.randn(B, S, di, generator=g, **f32)
    Bc = torch.randn(B, S, st, generator=g, **f32)
    C = torch.randn(B, S, st, generator=g, **f32)
    h0 = 0.1 * torch.randn(B, di, st, generator=g, **f32)
    return dt, A, u, Bc, C, h0


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(got, want):
    return torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("label,B,S,di,st", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_fused_mode_equals_the_ab_mode_bit_for_bit(card, label, B, S, di,
                                                    st):
    dt, A, u, Bc, C, h0 = _inputs(card, B, S, di, st)
    y, h = ops.selective_scan(dt, A, u, Bc, C, h0)
    a, b = ops._tail(dt, A, u, Bc)
    y_ab, h_ab = ops.scan(a, b, C, h0)
    torch.cuda.synchronize()
    assert y.shape == (B, S, di) and h.shape == (B, di, st)
    assert _same_bits(h, h_ab), \
        f"{label}: h_last differs, max |err| {(h - h_ab).abs().max():.3e}"
    assert _same_bits(y, y_ab), \
        f"{label}: y differs, max |err| {(y - y_ab).abs().max():.3e}"


def test_every_candidate_block_gives_the_same_bits(card):
    B, S, di, st = 2, 77, 200, 16
    args = _inputs(card, B, S, di, st, seed=1)
    want = ops.selective_scan(*args)
    cands = autotune.candidates_mamba_fused(S, di, st)
    assert autotune.DEFAULTS["mamba_scan_fused"] in cands
    for cfg in cands:
        got = ops.selective_scan(*args, **cfg)
        assert all(_same_bits(g, w) for g, w in zip(got, want)), cfg


def test_launch_counts(card):
    args = _inputs(card, 1, 40, 64, 16)
    before = (ops.LAUNCHES, ops.FUSED_LAUNCHES)
    ops.selective_scan(*args)
    ops.scan(*ops._tail(*args[:4]), *args[4:])
    assert (ops.LAUNCHES - before[0], ops.FUSED_LAUNCHES - before[1]) == \
        (2, 1)


def test_selective_scan_gradients_are_the_fused_backward(card):
    """The Function's outputs are the (a, b) mode's on the tail's a and
    b, and its gradients ``ssm_backward``'s on the same inputs and
    cotangents, bit for bit."""
    B, S, di, st = 2, 96, 128, 16
    ins = [t.requires_grad_(True) for t in _inputs(card, B, S, di, st, 2)]
    y, h = ops.SelectiveScan.apply(*ins)
    g = torch.Generator(device=card).manual_seed(3)
    dy = torch.randn(y.shape, generator=g, device=card)
    dh = torch.randn(h.shape, generator=g, device=card)
    grads = torch.autograd.grad((y, h), ins, (dy, dh))
    with torch.no_grad():
        want = ops.ssm_backward(*ins, dy, dh)
        y_ab, h_ab = ops.scan(*ops._tail(*ins[:4]), *ins[4:])
    assert _same_bits(y, y_ab) and _same_bits(h, h_ab)
    for name, got, w in zip(("ddt", "dA", "du", "dBc", "dC", "dh0"), grads,
                            want):
        assert _same_bits(got, w), name


def test_forward_allocates_no_state_sized_tensor(card):
    """At the training shape the forward's peak rises by less than one
    (B, S, di, st) f32 tensor (1.68 GB): its outputs alone."""
    B, S, di, st = 4, 2048, 3200, 16
    ins = [t.requires_grad_(True) for t in _inputs(card, B, S, di, st)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    y, h = ops.SelectiveScan.apply(*ins)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(card) - base
    assert rise < 4 * B * S * di * st, rise
    assert rise <= 4 * (B * S * di + B * di * st) + (4 << 20), rise


def test_training_step_launches_k3_fused_only(card):
    """Hymba-1.5B at full width and depth, 8 x 2048 in 2 microbatches,
    remat: K3 128 times a step (32 layers x 2 microbatches x forward and
    recompute), every one fused; the fused backward 64 times."""
    from repro_torch import configs
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tf
    cfg = configs.get("hymba-1.5b")
    n_ssm = sum(s.n_layers for s in tf.build_segments(cfg) if s.ssm)
    before = (ops.LAUNCHES, ops.FUSED_LAUNCHES, ops.SSM_BWD_LAUNCHES)
    out = train(cfg, steps=1, batch=8, seq=2048, microbatches=2,
                log_every=0, device=card)
    torch.cuda.synchronize()
    got = (ops.LAUNCHES - before[0], ops.FUSED_LAUNCHES - before[1],
           ops.SSM_BWD_LAUNCHES - before[2])
    del out
    assert n_ssm == 32
    assert got == (128, 128, 64), got
