"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA kv_lora=512.

2 shared + 64 routed experts top-6, expert d_ff=1408; first layer dense
(d_ff=10944); vocab 102400.  [arXiv:2405.04434]  A copy of the
reference's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    experts_per_tok=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
    vocab_size=512, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, n_experts=8, experts_per_tok=2, n_shared_experts=1,
    moe_d_ff=32, first_k_dense=1,
    capacity_factor=8.0,
)
