"""The arithmetic of the mixture-of-experts cell's yardstick: the model
FLOPs of a DeepSeek-V2 training step and the least time of each
grouped-GEMM launch, from the configuration file and the rows a call
computes (the program's counter).  The peaks are ``bounds``'.

The layer's grouped products are PyTorch's grouped GEMM, whose device
kernel is CUTLASS's over a grouped problem shape: ``GROUPED_GEMM`` is in
its name in the trace.  Each of them, forward (x W_gate, x W_up,
h W_down) or backward (a rows' gradient, a weight's gradient),
multiplies the live rows' (rows, d) by (d, f), or the same sizes
transposed: 2 rows d f FLOPs, the rows' two sides and the held experts'
weights each moved once.

Model FLOPs a token: 6 N_active, N_active the parameters a token's
forward multiplies: the output head's rows (the vocabulary held), each
dense layer (MLA and its SwiGLU), and each MoE layer's MLA, shared
experts, router and k held/E of one routed expert (the rows an expert
held here computes, a token's expected share); the embedding is a
lookup and the norms are left out.  Plus causal attention, 6 L H
(qk + v) S / 2 a token (the scores and the weighted values, forward
and backward, over half the S keys on average).
"""
from __future__ import annotations

from typing import Dict

from . import bounds

GROUPED_GEMM = "GroupProblemShape"


def mla_params(cfg: Dict) -> int:
    """MLA without query compression: W_q, W_dkv, W_uk, W_uv, W_o."""
    d, h, kvr = cfg["d_model"], cfg["n_heads"], cfg["kv_lora_rank"]
    nope, rope, vh = cfg["qk_nope_dim"], cfg["qk_rope_dim"], cfg["v_head_dim"]
    return (d * h * (nope + rope) + d * (kvr + rope) + kvr * h * nope
            + kvr * h * vh + h * vh * d)


def active_params(cfg: Dict) -> float:
    """N_active (module docstring)."""
    d, f = cfg["d_model"], cfg["moe_d_ff"]
    e = cfg["moe_n_routed"]
    held = cfg.get("moe_experts_held") or e
    dense = cfg["moe_first_k_dense"]
    moe = (mla_params(cfg) + 3 * d * cfg["moe_n_shared"] * f + d * e
           + cfg["moe_top_k"] * held / e * 3 * d * f)
    return (cfg["vocab_size"] * d
            + dense * (mla_params(cfg) + 3 * d * cfg["dense_d_ff"])
            + (cfg["n_layers"] - dense) * moe)


def attention_flops(cfg: Dict, seq: int) -> float:
    """Causal attention's training FLOPs a token at sequence `seq`."""
    qk = cfg["qk_nope_dim"] + cfg["qk_rope_dim"]
    return 6.0 * cfg["n_layers"] * cfg["n_heads"] * (
        qk + cfg["v_head_dim"]) * seq / 2


def train_flops(cfg: Dict, tokens: int, seq: int) -> float:
    """Model FLOPs of training on `tokens` tokens in sequences of `seq`."""
    return tokens * (6.0 * active_params(cfg) + attention_flops(cfg, seq))


def product_bound(cfg: Dict, rows: float, elem: int = 2
                  ) -> Dict[str, float]:
    """The least time of one grouped product over `rows` live rows
    (module docstring; `elem` bytes an element) at the bf16 tensor-core
    peak."""
    d, f = cfg["d_model"], cfg["moe_d_ff"]
    w = (cfg.get("moe_experts_held") or cfg["moe_n_routed"]) * d * f
    return bounds.bound(elem * (rows * d + rows * f + w),
                        2 * rows * d * f, bounds.BF16_TC_FLOP_PER_S)
