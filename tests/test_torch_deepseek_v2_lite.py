"""DeepSeek-V2-Lite in the port against the benchmark's plain reference
(``bench/reference/deepseek_v2.py``, plain PyTorch in float32, the one
copy of it), on seeded random weights at the smoke size, on the CPU.

* The parameter tree is the reference's; logits, loss (with the
  per-sequence balance loss) and every gradient match it (remat on and
  off), and so do three AdamW steps through the ``Trainer`` (remat, two
  microbatches).
* YaRN: ``rope_angles`` against the published formulas written out here,
  and MLA's softmax factor.
* The expert share: the eight shares of a 64-expert layer (experts
  ``[8r, 8r + 8)``, the router's columns rotated so that they are the
  first eight), summed, with the shared experts counted once, equal the
  uncut reference layer.
* The held experts (the grouped GEMM's plain version, ``kernels/moe_gemm``)
  against a loop over the experts through autograd, with an empty
  expert, every row on one expert and rows for experts held elsewhere,
  forward and backward; the layer refuses a split over ranks, and a
  capacity-path config refuses ``moe_experts_held``.
* Prefill, then decode through the MLA cache, against the full forward.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.core import DeviceGrid
from repro_torch.models import transformer
from repro_torch.models.layers import attention, common, moe
from repro_torch.train.trainer import Trainer
from repro_torch.util import tree_map

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
from reference import deepseek_v2 as ref  # noqa: E402
from reference import train_deepseek as ref_train  # noqa: E402

CPU = torch.device("cpu")
NAME = "deepseek-v2-lite"
CFG = configs.get_smoke(NAME)
B, S = 2, 32


def as_dict(cfg):
    return dataclasses.asdict(cfg)


def _weights(cfg=CFG, seed=3):
    return ref.init_params(as_dict(cfg), seed, CPU)


def _tokens(seed=0, batch=B, seq=S, vocab=CFG.vocab_size):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (batch, seq + 1), generator=g)


def _batch(tok):
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "mask": torch.ones(tok.shape[0], tok.shape[1] - 1)}


def _ref_loss(cfg, P, batch):
    x, aux = ref.hidden(as_dict(cfg), P, batch["tokens"])
    lg = ref.logits(as_dict(cfg), P, x)
    nll = (torch.logsumexp(lg, -1)
           - lg.gather(-1, batch["labels"].long()[..., None])[..., 0])
    return lg, nll.mean() + cfg.moe_aux_alpha * aux


def _close(got, want, rel=1e-4, msg=""):
    got = torch.as_tensor(got).detach().double()
    want = torch.as_tensor(want).detach().double()
    scale = want.abs().max().clamp_min(1e-30)
    assert float((got - want).abs().max() / scale) <= rel, msg


# -------------------------------------------------------------- registry
def test_registered_as_the_ports_own():
    assert configs.get(NAME).moe_experts_held == 8
    assert NAME in configs.port_names() and NAME not in configs.names()
    full = configs.get(NAME)
    assert (full.n_layers, full.d_model, full.moe_n_routed, full.moe_top_k,
            full.q_lora_rank, full.vocab_size) == (27, 2048, 64, 6, 0, 12800)


def test_param_tree_is_the_references():
    got = transformer.init_params(CFG, torch.Generator().manual_seed(0),
                                  device="cpu")
    want = _weights()
    g = {ref.path_name(p): (tuple(t.shape), t.dtype)
         for p, t in ref.leaves(got)}
    w = {ref.path_name(p): (tuple(t.shape), t.dtype)
         for p, t in ref.leaves(want)}
    assert g == w


# -------------------------------------------------------------- model
@pytest.mark.parametrize("remat", [False, True])
def test_logits_and_loss_match_reference(remat):
    P = _weights()
    batch = _batch(_tokens())
    logits, aux = transformer.forward(CFG, P, batch, remat=remat)
    want_logits, want_loss = _ref_loss(CFG, P, batch)
    _close(logits[..., :CFG.vocab_size], want_logits)
    loss = transformer.loss_fn(CFG, P, batch, remat=remat)
    _close(loss, want_loss)
    assert float(aux) > 0


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_reference(remat):
    P = _weights()
    batch = _batch(_tokens(1))
    leaves = [t for _, t in ref.leaves(P)]
    names = [ref.path_name(p) for p, _ in ref.leaves(P)]
    for t in leaves:
        t.requires_grad_(True)
    got = torch.autograd.grad(
        transformer.loss_fn(CFG, P, batch, remat=remat), leaves)
    want = torch.autograd.grad(_ref_loss(CFG, P, batch)[1], leaves)
    for n, g, w in zip(names, got, want):
        _close(g, w, 1e-4, n)


def test_trainer_three_steps_match_reference():
    """The Trainer's first three steps (remat, 2 microbatches, AdamW,
    warm-up 2) against the reference's from the same weights and
    batches: losses, the first gradient by leaf (AdamW's m) and each
    leaf's change."""
    seed, batch, seq = 11, 4, 32
    tr = Trainer(CFG, DeviceGrid([CPU]), global_batch=batch, seq=seq,
                 n_microbatches=2, seed=seed, warmup_steps=2,
                 total_steps=10)
    P = _weights(seed=5)
    tr.state = _train_state(P)
    tr.run(1, log_every=0)
    first = {ref.path_name(p): float(t.to_local().norm()) / 0.1
             for p, t in ref.leaves(tr.state["opt"]["m"])}
    hist = tr.run(3, log_every=0)
    hyper = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
             "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 2,
             "total_steps": 10}
    batches = [ref_train.batch_at(as_dict(CFG), seed, s, batch, seq)
               for s in range(3)]
    want = ref_train.steps(as_dict(CFG), _weights(seed=5), batches, hyper,
                           rows=1)
    np.testing.assert_allclose([h["loss"] for h in hist], want["losses"],
                               rtol=1e-5)
    start = {ref.path_name(p): t for p, t in ref.leaves(_weights(seed=5))}
    for k, t in ((ref.path_name(p), t) for p, t in
                 ref.leaves(tr.state["params"])):
        assert first[k] == pytest.approx(want["first_grad"][k], rel=1e-3,
                                         abs=1e-7), k
        change = float((t.to_local() - start[k]).norm())
        assert change == pytest.approx(want["change"][k], rel=1e-3,
                                       abs=1e-7), k


def _train_state(P):
    from repro_torch.train.step import make_train_state
    return make_train_state(CFG, tree_map(lambda t: t.clone(), P))


# -------------------------------------------------------------- YaRN
def _published_yarn(dim, base, factor, orig, beta_fast, beta_slow, mscale,
                    mscale_all_dim, pos):
    """DeepseekV2YarnRotaryEmbedding's cos and sin, as published (the
    halves of its concatenated table)."""
    def find_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (
            2 * math.log(base))
    low = max(math.floor(find_dim(beta_fast)), 0)
    high = min(math.ceil(find_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2).float() / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2).float()
                                          / dim))
    ramp = torch.clamp((torch.arange(dim // 2).float() - low) / (high - low),
                       0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    freqs = torch.outer(pos.float(), inv_freq)

    def get_mscale(scale, m):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0
    ms = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
    return freqs.cos() * ms, freqs.sin() * ms


@pytest.mark.parametrize("dim, orig, mscale", [(64, 4096, 0.707),
                                               (8, 4096, 0.707),
                                               (64, 64, 1.0)])
def test_yarn_rope_angles_match_the_published_formula(dim, orig, mscale):
    pos = torch.tensor([0, 1, 7, 100, 4095, 40000])
    yarn = (40.0, orig, 32.0, 1.0, mscale, 0.707)
    cos, sin = common.rope_angles(pos, dim, 10000.0, yarn)
    want_cos, want_sin = _published_yarn(dim, 10000.0, 40.0, orig, 32.0,
                                         1.0, mscale, 0.707, pos)
    torch.testing.assert_close(cos, want_cos, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sin, want_sin, rtol=1e-6, atol=1e-6)


def test_mla_softmax_factor():
    full = configs.get(NAME)
    m = 0.1 * 0.707 * math.log(40) + 1.0
    assert attention.mla_scale(full) == pytest.approx(192 ** -0.5 * m * m)
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    assert attention.mla_scale(configs.get("deepseek-v2-236b")) == 192 ** -0.5


# -------------------------------------------------------------- share
def test_expert_shares_sum_to_the_uncut_layer():
    """64 experts, top-6, d 64: each share r holds experts [8r, 8r + 8)
    (the router's columns rotated by 8r, the experts' weights taken from
    there); the shares' outputs without the shared experts, summed, plus
    the shared experts once, equal the reference's uncut layer."""
    full = dataclasses.replace(CFG, moe_n_routed=64, moe_top_k=6,
                               moe_experts_held=0)
    whole = ref.init_params(as_dict(full), 9, CPU)["segments"][1]["moe"]
    whole = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0]
                                                  for kk, vv in v.items()})
             for k, v in whole.items()}
    h = torch.randn(2, 16, full.d_model, generator=torch.Generator()
                    .manual_seed(2))
    want = ref.moe(as_dict(full), whole, h, None)[0]
    share_cfg = dataclasses.replace(full, moe_experts_held=8)
    total = torch.zeros_like(h)
    for r in range(8):
        p = {"router": torch.roll(whole["router"], -8 * r, dims=-1),
             **{k: whole[k][8 * r:8 * r + 8]
                for k in ("w_gate", "w_up", "w_down")}}
        out, _ = moe.moe_forward(share_cfg, p, h)
        total = total + out
    total = total + ref.swiglu(whole["shared"], h, None)
    _close(total, want, 1e-5)


# -------------------------------------------------------------- GEMM
def _loop(x, tok, w, ends, wg, wu, wd, held):
    """The experts' weighted outputs by a loop over the held experts,
    through autograd: (T, d)."""
    out = torch.zeros_like(x)
    lo = 0
    for e, hi in enumerate(ends.tolist()):
        t = tok[lo:hi]
        y = (F.silu(x[t] @ wg[e]) * (x[t] @ wu[e])) @ wd[e]
        out = out.index_add(0, t, y * w[lo:hi, None])
        lo = hi
    return out


@pytest.mark.parametrize("case", ["spread", "empty_expert", "one_expert",
                                  "held_elsewhere"])
def test_grouped_gemm_plain_version_matches_a_loop(case):
    """The layer's held experts (``moe.held_experts``: the plan's rows,
    the grouped products' plain version, the combine) against a loop,
    forward and backward.  The plain grouped product fills dead rows
    with NaN, as the card's leaves them unwritten: none may reach a
    token or a gradient."""
    T, k, held, E, d, f = 24, 3, 4, 8, 16, 12
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(T, E, generator=g)
    if case == "empty_expert":
        logits[:, 2] = -1e9                   # expert 2 gets no row
    elif case == "one_expert":
        held, k = 4, 1
        logits[:, 1] = 1e9                    # every row on expert 1
    elif case == "held_elsewhere":
        held = 2                              # most rows are not held
    top_p, top_i = torch.softmax(logits, -1).topk(k, -1)
    top_p = top_p.double().requires_grad_(True)
    tok, w, ends, counts = moe.dropfree_plan(top_i.int(), top_p, held)
    if case == "empty_expert":
        assert counts[2] == 0
    if case == "one_expert":
        assert counts.tolist() == [0, T, 0, 0]
    live = int(ends[-1])
    assert not w[live:].any()
    x, wg, wu, wd = (torch.randn(*s, generator=g, dtype=torch.float64)
                     .requires_grad_(True)
                     for s in ((T, d), (held, d, f), (held, d, f),
                               (held, f, d)))
    got = moe.held_experts({"w_gate": wg, "w_up": wu, "w_down": wd}, x,
                           tok, w, ends)
    want = _loop(x, tok, w, ends, wg, wu, wd, held)
    # f64 on both sides, summed in other orders
    _close(got, want, 1e-12)
    dy = torch.randn(T, d, generator=g, dtype=torch.float64)
    leaves = (x, wg, wu, wd, top_p)          # w comes from top_p: shared
    for a, b in zip(torch.autograd.grad(got, leaves, dy, retain_graph=True),
                    torch.autograd.grad(want, leaves, dy)):
        assert torch.isfinite(a).all()
        _close(a, b, 1e-12)


class _SplitCtx:
    """A mesh's view with a model axis of two ranks (the experts' axis
    under ``ep_axis="model"``)."""
    tp = type("Group", (), {"size": 2})()
    n_batch = 1

    def tp_for(self, n):
        return self.tp

    def ep_group(self, ep_axis, n_experts):
        return self.tp if ep_axis == "model" else None


@pytest.mark.parametrize("ep_axis", [None, "model"])
def test_drop_free_layer_refuses_a_split_over_ranks(ep_axis):
    """Without its exchange the drop-free layer would index the held
    experts in a rank's shard of them: it raises instead."""
    p = _weights()["segments"][1]["moe"]
    p = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0]
                                              for kk, vv in v.items()})
         for k, v in p.items()}
    h = torch.randn(1, 8, CFG.d_model)
    with pytest.raises(NotImplementedError, match="drop-free"):
        moe.moe_forward(CFG, p, h, ctx=_SplitCtx(), ep_axis=ep_axis)


@pytest.mark.parametrize("arch, held", [("qwen2-moe-a2.7b", 8),
                                        ("deepseek-v2-236b", 16),
                                        (NAME, 65)])
def test_experts_held_only_on_the_drop_free_path(arch, held):
    with pytest.raises(ValueError, match="moe_experts_held"):
        dataclasses.replace(configs.get(arch), moe_experts_held=held)


# -------------------------------------------------------------- serving
def test_prefill_then_decode_through_the_latent_cache():
    P = _weights(seed=8)
    tok = _tokens(3, seq=S)[:, :-1]
    full, _ = transformer.forward(CFG, P, {"tokens": tok}, remat=False)
    tp = S // 2
    caches, last = transformer.prefill(CFG, P, {"tokens": tok[:, :tp]})
    _close(last[:, -1] if last.ndim == 3 else last, full[:, tp - 1], 1e-4)
    caches = transformer.grow_caches(caches, transformer.init_caches(
        CFG, B, S, device="cpu"))
    for t in range(tp, S):
        caches, logits = transformer.decode_step(
            CFG, P, caches, tok[:, t:t + 1],
            torch.full((B,), t, dtype=torch.int32))
        _close(logits[:, 0], full[:, t], 2e-3, f"step {t}")


@pytest.mark.parametrize("chunks", [(), (2048, 4096), (4096, 4096),
                                    (1024, 2048)])
def test_attention_blocks_change_no_result(chunks, monkeypatch):
    """Above the chunking threshold MLA runs ``chunked_sdpa`` with the
    configuration's block sizes, and any of them gives whole attention's
    result (the cell's configuration takes (2048, 4096))."""
    assert configs.get(NAME).attn_chunks == (2048, 4096)
    cfg = dataclasses.replace(CFG, attn_chunks=chunks)
    seq = 4096
    p = attention.init_mla(cfg, torch.Generator().manual_seed(4))
    x = torch.randn(1, seq, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    pos = torch.arange(seq)
    seen = []
    chunked = attention.chunked_sdpa

    def spy(*a, **k):
        seen.append((k.get("q_chunk", attention.Q_CHUNK),
                     k.get("kv_chunk", attention.KV_CHUNK)))
        return chunked(*a, **k)

    monkeypatch.setattr(attention, "chunked_sdpa", spy)
    got, _ = attention.mla_forward(cfg, p, x, pos)
    assert seen == [chunks or (attention.Q_CHUNK, attention.KV_CHUNK)]
    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", seq)
    want, _ = attention.mla_forward(cfg, p, x, pos)
    assert len(seen) == 1
    _close(got, want, 1e-5)
