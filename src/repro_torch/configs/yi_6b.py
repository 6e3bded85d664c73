"""Yi-6B — llama-arch dense GQA [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4, head_dim=128) d_ff=11008 vocab=64000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
)

SMOKE_CONFIG = ModelConfig(
    name="yi-6b-smoke",
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
