"""DeepSeek-V2-Lite — MLA without query compression + MoE 64 routed
top-6, YaRN RoPE [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite].

27L d_model=2048 16H, MLA kv_lora=512, no q_lora (qk_nope=128,
qk_rope=64, v_head=128); layer 0 a dense SwiGLU (d_ff=10944), layers
1-26 MoE: 64 routed experts of width 1408 plus 2 shared, softmax router,
greedy top-6, top-k probabilities not renormalised (routed scale 1), the
balance loss per sequence (alpha 0.001); YaRN factor 40 over 4096
original positions (beta_fast 32, beta_slow 1, mscale = mscale_all_dim
= 0.707); RMSNorm eps 1e-6; vocab 102400, untied.

As run here: one chip's share of an expert-parallel deployment in which
8 chips share each MoE layer, 8 experts each (``moe_experts_held`` 8:
experts 0-7, the router still scoring all 64), and the vocabulary is
split 8 ways (``vocab_size`` 12800, ids 0-12799); attention, the shared
experts and the dense layer are whole on every chip.  Routing is
drop-free: every routed row is computed.  Attention over the 4K
sequence runs in blocks of 2048 queries by 4096 keys (``attn_chunks``):
two checkpointed blocks a layer instead of the default sixteen: far
fewer launches for the host, a larger block of scores in memory.  The
JAX package has no such configuration: it is the port's alone
(``configs.port_names``).
"""
from repro_torch.models.config import ModelConfig

# factor 40 over 4096 positions, beta_fast 32, beta_slow 1, mscale and
# mscale_all_dim 0.707
_YARN = dict(rope_yarn=(40.0, 4096, 32.0, 1.0, 0.707, 0.707))
_ROUTER = dict(moe_norm_topk=False, moe_seq_aux=True, moe_aux_alpha=0.001,
               moe_drop_free=True)

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,  # qk_nope + qk_rope (used for FLOP accounting only)
    d_ff=1408,
    vocab_size=12800,
    moe_n_routed=64,
    moe_n_shared=2,
    moe_top_k=6,
    moe_d_ff=1408,
    moe_first_k_dense=1,
    dense_d_ff=10944,
    moe_experts_held=8,
    use_mla=True,
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    norm_eps=1e-6,
    attn_chunks=(2048, 4096),
    **_YARN,
    **_ROUTER,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=24,
    d_ff=32,
    vocab_size=512,
    moe_n_routed=16,
    moe_n_shared=2,
    moe_top_k=3,
    moe_d_ff=32,
    moe_first_k_dense=1,
    dense_d_ff=96,
    moe_experts_held=8,
    use_mla=True,
    q_lora_rank=0,
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    norm_eps=1e-6,
    dtype="float32",
    **_YARN,
    **_ROUTER,
)
