"""Whole runs on the CPU at smoke sizes with the timed path broken
underneath: each fault a cell can have turns ``correct`` false.  The
harness's look for a card is skipped (the run is given the CPU)."""
from __future__ import annotations

import pytest

from bench_support import SERVE_CELL, run_cell, smoke_copy


@pytest.fixture
def root(tmp_path):
    return smoke_copy(tmp_path)


def test_sound_runs_are_correct(root):
    for cell in ("kmeans-fig6.mode1-local", "hymba-1.5b.train-8x2048"):
        assert run_cell(root, cell, seconds=0.5)["correct"]


# ---------------------------------------------------------------- K-Means
def test_kmeans_fit_that_skips_its_last_update(root, monkeypatch):
    from repro_torch.analytics import kmeans as km
    real = km.kmeans_fit
    monkeypatch.setattr(km, "kmeans_fit", lambda *a, **k: real(
        *a, **dict(k, iters=k["iters"] - 1)))
    assert not run_cell(root, "kmeans-fig6.mode1-local", seconds=0.5)[
        "correct"]


def test_kmeans_on_half_the_points(root, monkeypatch):
    from repro_torch.analytics.engine import AnalyticsEngine
    from repro_torch.core import ShardedTensor
    real = AnalyticsEngine.ensure_local

    def half(self, name):
        x = real(self, name)
        return ShardedTensor([b[: b.shape[0] // 2] for b in x.blocks],
                             x.placement)
    monkeypatch.setattr(AnalyticsEngine, "ensure_local", half)
    assert not run_cell(root, "kmeans-fig6.mode1-local", seconds=0.5)[
        "correct"]


def test_kmeans_answer_altered(root, monkeypatch):
    from repro_torch.analytics import kmeans as km
    real = km.kmeans_fit

    def altered(*a, **k):
        cents, cost = real(*a, **k)
        cents = cents.clone()
        cents[0, 0] += 1.0
        return cents, cost
    monkeypatch.setattr(km, "kmeans_fit", altered)
    assert not run_cell(root, "kmeans-fig6.mode1-local", seconds=0.5)[
        "correct"]


# ---------------------------------------------------------------- training
def test_training_step_that_leaves_the_state_unchanged(root, monkeypatch):
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "update", lambda p, g, opt, step, h, s=1.0: (
        p, opt, {"grad_norm": adamw.global_norm(g)}))
    out = run_cell(root, "hymba-1.5b.train-8x2048", seconds=0.5)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_on_half_the_batch(root, monkeypatch):
    from repro_torch.models import transformer
    real = transformer.loss_fn

    def half(cfg, params, batch, **kw):
        n = batch["tokens"].shape[0] // 2
        return real(cfg, params, {k: v[:n] for k, v in batch.items()}, **kw)
    monkeypatch.setattr(transformer, "loss_fn", half)
    assert not run_cell(root, "hymba-1.5b.train-8x2048", seconds=0.5)[
        "correct"]


# ---------------------------------------------------------------- serving
def test_served_token_altered_where_it_is_produced(root, monkeypatch):
    from repro_torch.serve.engine import ModelBackend
    real = ModelBackend.step

    def altered(self, state, pos, start):
        toks = real(self, state, pos, start)
        return (toks + 1) % self.cfg.vocab_size
    monkeypatch.setattr(ModelBackend, "step", altered)
    out = run_cell(root, SERVE_CELL, seconds=0.5)
    assert not out["correct"]


def test_sound_serving_run_is_correct(root):
    assert run_cell(root, SERVE_CELL, seconds=0.5)["correct"]
