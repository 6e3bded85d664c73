"""The plain references against the program at smoke sizes in float32
on the CPU: the same numbers, to float32 round-off."""
from __future__ import annotations


import pytest
import torch

from bench_support import (BENCH, SERVE_CELL, SMOKE_HYMBA, load, run_cell,
                           smoke_copy)

from reference import hymba, lloyd

CPU = torch.device("cpu")


def smoke_cfg(**changes):
    cfg = dict(load(BENCH / "configs" / "hymba-1.5b.json"), **SMOKE_HYMBA)
    cfg.update(changes)
    return cfg


def program_cfg(cfg):
    from lib.model import model_config
    return model_config(cfg)


def test_weights_have_the_programs_layout():
    from repro_torch.models import transformer
    from repro_torch.util import tree_paths
    cfg = smoke_cfg()
    ours = {hymba.path_name(p): (tuple(t.shape), t.dtype)
            for p, t in hymba.leaves(hymba.init_params(cfg, 3, CPU))}
    theirs = {"/".join(map(str, p)): (tuple(t.shape), t.dtype)
              for p, t in tree_paths(transformer.init_params(
                  program_cfg(cfg), device="cpu"))}
    assert ours == theirs


@pytest.mark.parametrize("window", [32, 8])
def test_forward_and_padded_prefill_match_the_program(window):
    from repro_torch.models import transformer
    from repro_torch.serve.step import make_prefill_step
    cfg = smoke_cfg(sliding_window=window)
    c = program_cfg(cfg)
    P = hymba.init_params(cfg, 5, CPU)
    tok = torch.randint(0, cfg["vocab_size"], (2, 40),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = transformer.forward(c, P, {"tokens": tok}, remat=False)
        got = hymba.logits(cfg, P, hymba.hidden(cfg, P, tok))
    scale = want.abs().max()
    assert (got - want[..., :cfg["vocab_size"]]).abs().max() <= 1e-5 * scale
    pad, bucket = 8, 48
    toks = torch.zeros(1, bucket, dtype=torch.int32)
    toks[0, pad:] = tok[0]
    slots = torch.arange(bucket, dtype=torch.int32)
    _, lg = make_prefill_step(c)(P, {"tokens": toks,
                                     "positions": slots - pad,
                                     "pad_mask": slots >= pad})
    with torch.no_grad():
        ref = hymba.logits(cfg, P, hymba.hidden(cfg, P, toks, pad=pad,
                                                bucket=bucket))
    assert (lg[0, -1, :cfg["vocab_size"]] - ref[0, -1]).abs().max() \
        <= 1e-5 * scale


def test_kmeans_reference_matches_the_analytics_engine():
    from repro_torch.analytics import kmeans as km
    from repro_torch.analytics.engine import AnalyticsEngine
    from repro_torch.core import DeviceGrid
    pts = torch.randn(3000, 3, generator=torch.Generator().manual_seed(2))
    eng = AnalyticsEngine(DeviceGrid([CPU]))
    eng.put("p", pts)
    got_c, got_cost = km.kmeans_fit(eng, "p", 40, iters=2, seed=2 ** 40 + 9,
                                    use_kernel=True)
    ref_c, ref_cost = lloyd.fit(pts, 40, 2 ** 40 + 9, 2)
    assert abs(got_cost - ref_cost) <= 1e-5 * ref_cost
    assert float((got_c.double() - ref_c).norm() / ref_c.norm()) <= 1e-5


def test_training_cell_matches_the_reference(tmp_path):
    out = run_cell(smoke_copy(tmp_path), "hymba-1.5b.train-8x2048",
                   seconds=0.5)
    assert out["correct"] and out["attempted"] >= 1
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert out["checks"][name]["value"] <= 1e-4


def test_serving_cell_matches_the_reference(tmp_path):
    """Served tokens are the reference's best to float32 round-off."""
    out = run_cell(smoke_copy(tmp_path), SERVE_CELL, seconds=0.5)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["logit_gap"]["value"] <= 1e-4
