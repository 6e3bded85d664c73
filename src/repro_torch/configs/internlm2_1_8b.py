"""InternLM2-1.8B — dense GQA [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8, head_dim=128) d_ff=8192 vocab=92544.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
)

SMOKE_CONFIG = ModelConfig(
    name="internlm2-1.8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
)
