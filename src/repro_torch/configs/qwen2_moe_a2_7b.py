"""Qwen1.5-MoE-A2.7B — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16, head_dim=128) routed-expert d_ff=1408
vocab=151936. Routed experts are padded 60 -> 64 for clean expert
parallelism over the 16-way model axis; padding experts are masked to
-inf in the router so routing is over the 60 logical experts only.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    moe_n_routed=60,
    moe_n_shared=4,
    moe_top_k=4,
    moe_d_ff=1408,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    moe_n_routed=8,
    moe_n_shared=2,
    moe_top_k=2,
    moe_d_ff=32,
    moe_capacity_factor=16.0,  # = E_pad: provably drop-free for exact tests
    dtype="float32",
)
