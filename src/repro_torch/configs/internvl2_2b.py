"""InternVL2-2B — VLM: InternViT frontend + InternLM2 backbone [arXiv:2404.16821; hf].

Backbone: 24L d_model=2048 16H (GQA kv=8, head_dim=128) d_ff=8192
vocab=92553. The InternViT vision frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed patch embeddings (256 tokens per
image) that are prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    n_frontend_tokens=256,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-2b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    frontend="vision",
    n_frontend_tokens=8,
    dtype="float32",
)
