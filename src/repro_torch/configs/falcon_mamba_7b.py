"""Falcon-Mamba-7B — attention-free Mamba-1 SSM [arXiv:2410.05355; unverified].

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16, expand=2
(d_inner=8192), conv=4, dt_rank=256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=65024,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_dt_rank=256,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=512,
    ssm_d_state=4,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_dt_rank=8,
    tie_embeddings=True,
    dtype="float32",
)
