"""The drop-free MoE layer's grouped products on the card (marker
``cuda``; skips without a card): ``ops.gmm`` (PyTorch's grouped GEMM)
against ``torch.mm`` per segment (``ref``), forward and backward, at the
DeepSeek-V2-Lite cell's shapes (16,384 tokens, top-6 of 64 experts, 8
held, d 2048, f 1408, bf16) and at small ragged ones (an empty expert,
every row on one expert), with NaN in the dead rows of its inputs, which
must reach no live row and no weight's gradient; ``moe.held_experts``
against a loop through autograd; and no host synchronisation from the
MoE layer, alone and inside a training step of the smoke configuration
(``torch.cuda.set_sync_debug_mode("error")``).  It imports no JAX.
Run on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_moe_gemm_cuda.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.moe_gemm import ops, ref
from repro_torch.models import transformer
from repro_torch.models.layers import moe
from repro_torch.train.step import make_train_state, make_train_step

pytestmark = pytest.mark.cuda

# (label, tokens, experts, top-k, held, d, f, routing)
CASES = [
    ("cell 16384 tok, 8 of 64", 16384, 64, 6, 8, 2048, 1408, "softmax"),
    ("ragged, empty expert", 300, 16, 3, 8, 96, 80, "empty"),
    ("every row on one expert", 257, 16, 1, 8, 64, 48, "one"),
]
BF16 = torch.bfloat16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped GEMM runs on the card")
    return torch.device("cuda", 0)


def _case(dev, T, E, k, held, d, f, routing, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn(T, E, generator=g, device=dev)
    if routing == "empty":
        logits[:, 3] = -1e9
    elif routing == "one":
        logits[:, 5] = 1e9
    top_p, top_i = torch.softmax(logits, -1).topk(k, -1)
    tok, w, ends, counts = moe.dropfree_plan(top_i.int(), top_p.to(BF16),
                                             held)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(BF16)
    x = rnd(T, d)
    wg, wu = rnd(held, d, f, std=d ** -0.5), rnd(held, d, f, std=d ** -0.5)
    wd = rnd(held, f, d, std=f ** -0.5)
    return tok, w, ends, counts, x, wg, wu, wd


def _near(got, want, what, tol=1e-2):
    """Largest gap over the largest value: one bf16 rounding of either
    side (2^-8) where both round their f32 sums to bf16."""
    got, want = got.detach().float(), want.detach().float()
    assert torch.isfinite(got).all(), what
    gap = float((got - want).abs().max()
                / want.abs().max().clamp_min(1e-30))
    assert gap <= tol, (what, gap)


def _poisoned(t, live):
    """`t` with NaN in its rows past `live`: dead rows the layer never
    reads."""
    t = t.clone()
    t[live:] = float("nan")
    return t


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_grouped_products_match_torch_mm_per_segment(card, case):
    label, T, E, k, held, d, f, routing = case
    tok, w, ends, counts, x, wg, wu, wd = _case(card, T, E, k, held, d, f,
                                                routing)
    if routing == "empty":
        assert int(counts[3]) == 0
    if routing == "one":
        assert int(counts[5]) == T and int(counts.sum()) == T
    live = int(ends[-1])
    xs = x.index_select(0, tok)
    for name, a, b in (("x W_gate", xs, wg), ("h W_down", xs[:, :f]
                                               .contiguous(), wd)):
        a = _poisoned(a, live).requires_grad_(True)
        b = b.clone().requires_grad_(True)
        before = ops.CALLS
        got = ops.gmm(a, b, ends)
        assert ops.CALLS == before + 1
        want = ref.gmm(a, b, ends)
        _near(got[:live], want[:live], name)
        dy = _poisoned(torch.randn_like(got), live)
        da, db = torch.autograd.grad(got, (a, b), dy)
        rda, rdb = torch.autograd.grad(want, (a, b), dy)
        _near(da[:live], rda[:live], f"{name}: rows' gradient")
        _near(db, rdb, f"{name}: weights' gradient")
        assert not db[counts == 0].any()


def test_grouped_product_takes_bf16_alone(card):
    a = torch.randn(8, 16, device=card)
    b = torch.randn(2, 16, 8, device=card)
    ends = torch.tensor([3, 8], dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="bf16"):
        ops.gmm(a, b, ends)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_held_experts_against_autograd(card, case):
    label, T, E, k, held, d, f, routing = case
    tok, w, ends, counts, x, wg, wu, wd = _case(card, T, E, k, held, d, f,
                                                routing, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (x, wg, wu, wd)]
    y = moe.held_experts(dict(zip(("w_gate", "w_up", "w_down"),
                                  leaves[1:])), leaves[0], tok, w, ends)
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, leaves, dy)
    rx, rwg, rwu, rwd = ref_leaves = [t.clone().requires_grad_(True)
                                      for t in (x, wg, wu, wd)]
    ry = torch.zeros_like(y)
    for e, lo, hi in ref.segments(ends):
        t = tok[lo:hi]
        a = torch.nn.functional.silu(rx[t] @ rwg[e])
        ry = ry.index_add(0, t, ((a * (rx[t] @ rwu[e])) @ rwd[e])
                          * w[lo:hi, None])
    _near(y, ry, "y")
    want = torch.autograd.grad(ry, ref_leaves, dy)
    for name, a, b in zip(("dx", "dW_gate", "dW_up", "dW_down"), got, want):
        _near(a, b, name)


def test_no_host_sync_from_the_moe_layer(card):
    """The drop-free layer's forward and backward at the smoke config in
    sync-debug mode "error", then a whole training step in which the MoE
    layer's forward runs in it."""
    cfg = dataclasses.replace(configs.get_smoke("deepseek-v2-lite"),
                              dtype="bfloat16")
    params = transformer.init_params(cfg, torch.Generator(device=card)
                                     .manual_seed(0), device=card)
    p = {k: v[0] if torch.is_tensor(v) else {kk: vv[0]
                                             for kk, vv in v.items()}
         for k, v in params["segments"][1]["moe"].items()}
    p = {k: (v.requires_grad_(True) if torch.is_tensor(v) else v)
         for k, v in p.items()}
    x = torch.randn(2, 64, cfg.d_model, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe.moe_forward(cfg, p, x)
        (out.float().square().mean() + aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert x.grad is not None and p["w_gate"].grad is not None

    fwd = moe._moe_drop_free

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fwd(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    moe._moe_drop_free = strict
    try:
        step = make_train_step(cfg, n_microbatches=2)
        state = make_train_state(cfg, params)
        tokens = torch.randint(0, cfg.vocab_size, (4, 65), device=card)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
                 "mask": torch.ones(4, 64, device=card)}
        state, metrics = step(state, batch)
        assert torch.isfinite(metrics["loss"])
    finally:
        moe._moe_drop_free = fwd
