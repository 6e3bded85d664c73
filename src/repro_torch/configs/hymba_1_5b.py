"""Hymba-1.5B — hybrid parallel attention+Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16. Sliding-window attention in all layers except
{first, middle, last} which keep full attention (per the Hymba paper);
meta-tokens are not modeled (noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    sliding_window=2048,
    full_attn_layers=(0, 16, 31),
)

SMOKE_CONFIG = ModelConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=5,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm_d_state=4,
    ssm_d_conv=4,
    ssm_expand=2,
    sliding_window=32,
    full_attn_layers=(0, 2),
    dtype="float32",
)
