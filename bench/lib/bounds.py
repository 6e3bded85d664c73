"""The yardstick's arithmetic, frozen here: the card's published peaks,
the model FLOPs a step needs, and the least time each kernel's work
could take.  Every count is of the work that the layer's own inputs
need, read once and written once, whatever a kernel does to get there,
so a redesigned kernel is measured against the same work.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
"""
from __future__ import annotations

from typing import Dict

FP32_FLOP_PER_S = 67e12          # FP32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12      # bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12        # HBM3


def bound(nbytes: float, flops: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> Dict[str, float]:
    """The least time: bytes over the memory rate or operations over the
    peak of the units that run them, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return {"bytes": nbytes, "flops": flops, "t_bytes": t_bytes,
            "t_ops": t_ops, "seconds": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def assign_bound(n: int, k: int, d: int) -> Dict[str, float]:
    """One nearest-centroid assignment of n points to k centroids in d
    dimensions, f32: points and centroids read once, the index (int32)
    and the distance (f32) written once; k * (d + 1) multiply-adds a
    point (|c|^2 - 2 p.c, 2 FLOPs each) at the FP32 peak."""
    return bound(4 * (n * d + k * d) + 8 * n, 2 * n * k * (d + 1))


def scan_bound(B: int, S: int, di: int, st: int) -> Dict[str, float]:
    """The selective scan from the layer's inputs (f32): dt and u
    (B, S, di), the readouts Bc and C (B, S, st), A (di, st) and h0
    (B, di, st) read once; y (B, S, di) and h_last (B, di, st) written
    once.  Per element of the (B, S, di, st) state: dt * A, exp, u * Bc
    and h's multiply-add (5 operations, the exp counted as 1) and the
    readout's multiply-add (2), at the FP32 peak."""
    big = B * S * di * st
    nbytes = 4 * (3 * B * S * di + 2 * B * S * st + di * st
                  + 2 * B * di * st)
    return bound(nbytes, 7 * big)


def ssm_bwd_bound(B: int, S: int, di: int, st: int) -> Dict[str, float]:
    """The backward of that scan (f32): dt, u and dy (B, S, di), Bc and C
    (B, S, st), A, h0 and dh_last read once; ddt and du (B, S, di), dBc
    and dC (B, S, st), dA and dh0 written once.  Per element of the
    state, counted once: the forward walk that rebuilds h (dt * A, exp,
    u * Bc, a multiply-add: 5), the backward walk's multiply-add and
    C * dy (3), a g h_{t-1} (1), and the multiply-adds into ddt (with
    the product a A: 3), dA (2), du (2), dBc (2) and dC (2): 20
    operations at the FP32 peak.  With one exp an element, the SFU
    (16 a clock an SM) takes less time than these FP32 operations, so
    FP32 bounds the operations."""
    big = B * S * di * st
    nbytes = 4 * (5 * B * S * di + 4 * B * S * st + 2 * di * st
                  + 3 * B * di * st)
    return bound(nbytes, 20 * big)


def hybrid_params(cfg: Dict) -> int:
    """Parameters of a hybrid (attention + Mamba + MLP) model from its
    configuration file: embedding and output head, and per layer GQA
    (q, k, v, o), Mamba (in_proj, conv, x_proj, dt_proj and its bias,
    A_log, D, out_proj) and the SwiGLU MLP; norms left out."""
    d, h, kv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    di = cfg["ssm_expand"] * d
    st, dc = cfg["ssm_d_state"], cfg["ssm_d_conv"]
    dr = -(-d // 16)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    ssm = (d * 2 * di + di * dc + di * (dr + 2 * st) + dr * di + di
           + di * st + di + di * d)
    mlp = 3 * d * cfg["d_ff"]
    heads = (1 if cfg.get("tie_embeddings") else 2) * cfg["vocab_size"] * d
    return heads + cfg["n_layers"] * (attn + ssm + mlp)


def train_flops(cfg: Dict, tokens: int) -> float:
    """Model FLOPs of training on `tokens` tokens: 6 N."""
    return 6.0 * hybrid_params(cfg) * tokens


def prefill_flops(cfg: Dict, tokens: int) -> float:
    """Model FLOPs of a forward pass over `tokens` tokens: 2 N."""
    return 2.0 * hybrid_params(cfg) * tokens
