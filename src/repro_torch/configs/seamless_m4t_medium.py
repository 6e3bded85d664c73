"""SeamlessM4T-medium — encoder-decoder multimodal [arXiv:2308.11596; hf].

12L encoder + 12L decoder, d_model=1024 16H (kv=16, head_dim=64)
d_ff=4096 vocab=256206 (padded to 256256 for sharding). The speech
frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed audio-frame embeddings to the encoder.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,           # decoder layers
    n_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    n_layers=2,
    n_encoder_layers=2,
    is_encoder_decoder=True,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    frontend="audio",
    dtype="float32",
)
