"""Deterministic synthetic-token data pipeline with background prefetch.

The port of ``repro.data.pipeline``.  Batches are a pure function of
(seed, step), drawn with the reference's numpy generator call for call,
so both packages give equal batches; each goes to the trainer's device
as tensors.  A prefetch thread keeps ``depth`` batches ahead.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.tracing import span
from repro_torch.util import Device, resolve_device


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, *, batch: int, seq: int,
                 seed: int = 0, device: Device = "cuda",
                 prefetch_depth: int = 2, distribution: str = "sequence"):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = resolve_device(device)
        self.depth = prefetch_depth
        self.distribution = distribution  # 'sequence' (learnable) | 'uniform'
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._next_step = 0

    # ------------------------------------------------------------ building
    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of (seed, step): the restart-safety contract."""
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step))
        text_len = (self.seq - cfg.n_frontend_tokens
                    if cfg.frontend == "vision" else self.seq)
        if self.distribution == "sequence":
            # learnable synthetic language: arithmetic token streams with a
            # small stride alphabet (loss can fall far below ln(vocab))
            start = rng.integers(0, cfg.vocab_size, (self.batch, 1))
            stride = rng.integers(1, 4, (self.batch, 1))
            t = np.arange(text_len + 1)[None, :]
            tokens = ((start + stride * t) % cfg.vocab_size).astype(np.int32)
        else:
            tokens = rng.integers(0, cfg.vocab_size,
                                  (self.batch, text_len + 1), dtype=np.int32)
        out: Dict[str, Any] = {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "mask": np.ones((self.batch, text_len), np.float32),
        }
        if cfg.frontend == "vision":
            out["patch_embeds"] = rng.normal(
                0, 0.02, (self.batch, cfg.n_frontend_tokens, cfg.d_model)
            ).astype(np.float32)
        if cfg.is_encoder_decoder:
            out["frame_embeds"] = rng.normal(
                0, 0.02, (self.batch, self.seq, cfg.d_model)).astype(np.float32)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in out.items()}

    # ------------------------------------------------------------ prefetch
    def start(self, from_step: int = 0) -> "TokenPipeline":
        self._next_step = from_step
        self._stop.clear()

        def loop():
            step = from_step
            while not self._stop.is_set():
                try:
                    with span("data.batch", step=step):
                        b = self.batch_at(step)
                    self._q.put((step, b), timeout=0.1)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        with span("data.wait"):
            if self._thread is None:
                b = self.batch_at(self._next_step)
                self._next_step += 1
                return b
            _, b = self._q.get()
            return b

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            while not self._q.empty():   # unblock producer
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=2)
            self._thread = None
            while not self._q.empty():   # a batch put while stopping
                self._q.get_nowait()
