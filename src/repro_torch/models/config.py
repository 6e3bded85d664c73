"""Model configuration for the model zoo (the port's copy of the JAX
package's ``models/config.py``; ``param_dtype`` is a ``torch.dtype``).

One ``ModelConfig`` covers every assigned architecture family:
dense GQA transformers, MLA (DeepSeek-V2), MoE (shared+routed top-k),
Mamba-1 SSM, Hymba hybrid attention+SSM, ViT/audio-stub multimodal
backbones and encoder-decoder (Seamless).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    moe_n_routed: int = 0           # number of routed experts (logical)
    moe_n_shared: int = 0           # number of always-on shared experts
    moe_top_k: int = 0
    moe_d_ff: int = 0               # per-expert FFN width (routed + shared)
    moe_first_k_dense: int = 0      # leading dense layers (DeepSeek-V2 style)
    dense_d_ff: int = 0             # FFN width of those dense layers
    moe_capacity_factor: float = 1.25
    moe_norm_topk: bool = True      # renormalise the top-k probabilities
    moe_seq_aux: bool = False       # balance loss per sequence, averaged
    moe_aux_alpha: float = 0.01     # the balance loss's weight in the loss
    # drop-free routing: every routed row is computed (rows sorted by
    # expert, a grouped GEMM over the segments); no capacity, no drop
    moe_drop_free: bool = False
    # the experts this device holds, [0, held) of moe_n_routed (one
    # device's share under expert parallelism); 0 = all.  Drop-free only.
    moe_experts_held: int = 0

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    q_lora_rank: Optional[int] = 0  # 0 or None: no query compression
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba-1) ---
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # 0 -> ceil(d_model / 16)

    # --- hybrid (Hymba) ---
    sliding_window: int = 0         # 0 -> full attention everywhere
    full_attn_layers: Tuple[int, ...] = ()  # layers that keep full attention

    # --- encoder-decoder (Seamless) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- multimodal stub frontends ---
    # 'none' | 'vision' (precomputed patch embeddings) | 'audio' (frame embeddings)
    frontend: str = "none"
    n_frontend_tokens: int = 256    # patches per image for the vlm stub

    # --- numerics ---
    dtype: str = "bfloat16"
    rope_theta: float = 10000.0
    # YaRN RoPE (DeepSeek-V2): (factor, original max positions,
    # beta_fast, beta_slow, mscale, mscale_all_dim); () = plain RoPE
    rope_yarn: Tuple[float, ...] = ()
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # (q, kv) block sizes of chunked attention (sequences above
    # attention.CHUNK_THRESHOLD), each capped at its sequence; () = the
    # defaults (Q_CHUNK, KV_CHUNK).  Larger blocks: fewer launches, more
    # memory for one block's scores.
    attn_chunks: Tuple[int, ...] = ()

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows, padded for clean vocab sharding."""
        return _round_up(self.vocab_size, 256)

    @property
    def moe_n_routed_padded(self) -> int:
        """Routed experts padded to a multiple of 16 for expert parallelism."""
        if not self.moe_n_routed:
            return 0
        return _round_up(self.moe_n_routed, 16)

    def __post_init__(self):
        if self.moe_experts_held and not self.moe_drop_free:
            raise ValueError(
                f"{self.name}: moe_experts_held needs moe_drop_free (the "
                "capacity path runs every expert)")
        if not 0 <= self.moe_experts_held <= self.moe_n_routed:
            raise ValueError(
                f"{self.name}: moe_experts_held {self.moe_experts_held} "
                f"outside [0, {self.moe_n_routed}]")

    @property
    def moe_n_experts_local(self) -> int:
        """Expert weights this device holds: ``moe_experts_held`` where
        set, else every (padded) routed expert."""
        return self.moe_experts_held or self.moe_n_routed_padded

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_dt_rank_(self) -> int:
        if self.ssm_dt_rank:
            return self.ssm_dt_rank
        return max(1, -(-self.d_model // 16))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode with a 500k-token context sub-quadratically?"""
        return self.family in ("ssm", "hybrid")

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Analytic parameter count (excludes padding), for MODEL_FLOPS."""
        d, hd = self.d_model, self.head_dim_
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d

        def attn_params() -> int:
            if self.use_mla:
                qk = self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                p = (d * self.q_lora_rank + self.q_lora_rank * qk
                     if self.q_lora_rank else d * qk)
                p += d * (self.kv_lora_rank + self.qk_rope_dim)
                p += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                p += self.n_heads * self.v_head_dim * d
                return p
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # SwiGLU: gate, up, down

        def ssm_params() -> int:
            di, st, dr = self.ssm_d_inner, self.ssm_d_state, self.ssm_dt_rank_
            p = d * 2 * di                # in_proj (x, z)
            p += di * self.ssm_d_conv     # conv1d
            p += di * (dr + 2 * st)       # x_proj
            p += dr * di + di             # dt_proj
            p += di * st + di             # A_log, D
            p += di * d                   # out_proj
            return p

        per_layer = 0
        if self.family == "ssm":
            per_layer = ssm_params()
        elif self.family == "hybrid":
            per_layer = attn_params() + ssm_params() + mlp_params(self.d_ff)
        elif self.family == "moe":
            moe = (
                self.moe_n_routed * mlp_params(self.moe_d_ff) / d * d  # routed
                + self.moe_n_shared * mlp_params(self.moe_d_ff)
                + d * self.moe_n_routed  # router
            )
            per_layer = attn_params() + int(moe)
        else:
            per_layer = attn_params() + mlp_params(self.d_ff)

        n += self.n_layers * per_layer
        if self.moe_first_k_dense:
            n += self.moe_first_k_dense * (
                attn_params() + mlp_params(self.dense_d_ff)
                - per_layer + attn_params() + 0
            )
            # first-k layers replace MoE FFN with a dense one:
            n += self.moe_first_k_dense * (mlp_params(self.dense_d_ff))
            n -= self.moe_first_k_dense * 0
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff))
            cross = self.n_layers * attn_params()
            n += enc + cross
        return int(n)

    def n_active_params(self) -> int:
        """Active parameters per token (for MoE MODEL_FLOPS = 6*N_active*D)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        routed_all = self.n_layers * self.moe_n_routed * 3 * d * self.moe_d_ff
        routed_active = self.n_layers * self.moe_top_k * 3 * d * self.moe_d_ff
        return int(full - routed_all + routed_active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered and at what size."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full quadratic attention: 500k-token decode excluded (see DESIGN.md)"
    return True, ""
