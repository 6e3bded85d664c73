"""Serving steps: prefill (prompt -> cache) and decode (one token, KV cache).

The port of ``repro.serve.step``: the entry points a serving engine
calls.  Both run under ``torch.inference_mode()``.  ``decode`` updates
the caches in place (the reference donates them) and returns them.

Both steps understand bucketed (left-padded) prompts: the prefill batch
may carry ``positions`` (pad-relative RoPE positions) and ``pad_mask``
(False on pad key slots), and the decode step takes an optional ``start``
vector marking the first real cache slot per row. See
``transformer.prefill``.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, *, moe_groups: int = 1,
                      moe_ep_axis=None):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return transformer.prefill(cfg, params, batch,
                                       moe_groups=moe_groups,
                                       moe_ep_axis=moe_ep_axis,
                                       positions=batch.get("positions"),
                                       pad_mask=batch.get("pad_mask"))
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, sample: bool = False,
                     moe_groups: int = 1, moe_ep_axis=None):
    def decode_step(params, caches, tokens, pos, start=None):
        with torch.inference_mode():
            caches, logits = transformer.decode_step(
                cfg, params, caches, tokens, pos, moe_groups=moe_groups,
                moe_ep_axis=moe_ep_axis, start=start)
            if sample:
                nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                return caches, logits, nxt[:, None]
            return caches, logits
    return decode_step
