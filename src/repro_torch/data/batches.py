"""Batch construction + meta-tensor input specs for every model input.

The port of ``repro.data.batches``.  ``input_specs`` and ``cache_specs``
are shape-and-dtype stand-ins for every input of the train/prefill/decode
steps, as ``device="meta"`` tensors (no storage).  ``make_batch`` builds
the same dict with real (synthetic) data, drawing from the numpy
generator exactly as the reference does, so both packages build the same
batch from one seed.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.util import Device, resolve_device

DEFAULT_ENC_LEN = 4096  # encoder length for enc-dec decode cells


def batch_shapes(cfg: ModelConfig, kind: str, batch: int, seq: int) -> Dict[str, Tuple]:
    """Logical shapes for one step input, keyed by input name."""
    text_len = seq - cfg.n_frontend_tokens if cfg.frontend == "vision" else seq
    shapes: Dict[str, Tuple] = {}
    if kind in ("train", "prefill"):
        shapes["tokens"] = (batch, text_len)
        if cfg.frontend == "vision":
            shapes["patch_embeds"] = (batch, cfg.n_frontend_tokens, cfg.d_model)
        if cfg.is_encoder_decoder:
            shapes["frame_embeds"] = (batch, seq, cfg.d_model)
        if kind == "train":
            shapes["labels"] = (batch, text_len)
            shapes["mask"] = (batch, text_len)
    else:  # decode
        shapes["tokens"] = (batch, 1)
        shapes["pos"] = (batch,)
    return shapes


def _dtype_of(name: str, cfg: ModelConfig) -> torch.dtype:
    if name in ("tokens", "labels", "pos"):
        return torch.int32
    if name == "mask":
        return torch.float32
    return cfg.param_dtype  # embeddings from stub frontends


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell."""
    return {
        name: torch.empty(shp, dtype=_dtype_of(name, cfg), device="meta")
        for name, shp in batch_shapes(cfg, shape.kind, shape.global_batch,
                                      shape.seq_len).items()
    }


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                enc_len: int = DEFAULT_ENC_LEN) -> Any:
    """Meta tensors for the decode cache (as produced by init_caches)."""
    enc = enc_len if cfg.is_encoder_decoder else 0
    return transformer.init_caches(cfg, batch, max_seq, enc, device="meta")


def make_batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
               rng: np.random.Generator, *, device: Device = "cuda"
               ) -> Dict[str, torch.Tensor]:
    """Synthetic batch with real values (smoke tests / examples)."""
    device = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, shp in batch_shapes(cfg, kind, batch, seq).items():
        dt = _dtype_of(name, cfg)
        if name in ("tokens", "labels"):
            arr = torch.from_numpy(rng.integers(0, cfg.vocab_size, shp))
        elif name == "pos":
            arr = torch.zeros(shp)
        elif name == "mask":
            arr = torch.ones(shp)
        else:
            arr = torch.from_numpy(rng.normal(size=shp) * 0.02)
        out[name] = arr.to(device=device, dtype=dt)
    return out
