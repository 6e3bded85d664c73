"""DeepSeek-V2-236B — MLA + MoE 160 routed top-6 [arXiv:2405.04434; hf].

60L d_model=5120 128H, MLA kv_lora=512 q_lora=1536 (qk_nope=128,
qk_rope=64, v_head=128), routed-expert d_ff=1536, 2 shared + 160 routed
top-6, vocab=102400. First layer keeps a dense FFN (d_ff=12288) per the
published config.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,  # qk_nope + qk_rope (used for FLOP accounting only)
    d_ff=1536,
    vocab_size=102400,
    moe_n_routed=160,
    moe_n_shared=2,
    moe_top_k=6,
    moe_d_ff=1536,
    moe_first_k_dense=1,
    dense_d_ff=12288,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=24,
    d_ff=32,
    vocab_size=512,
    moe_n_routed=8,
    moe_n_shared=1,
    moe_top_k=2,
    moe_d_ff=32,
    moe_capacity_factor=16.0,  # = E_pad: provably drop-free for exact tests
    moe_first_k_dense=1,
    dense_d_ff=64,
    use_mla=True,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    dtype="float32",
)
