"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336, 8e top-2.

Sliding-window attention (4096) and MoE every layer.  [arXiv:2401.04088]
A copy of the reference's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_tok=2,
    moe_d_ff=14336,
    sliding_window=4096,
    rope_theta=1e6,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=512, n_experts=4, experts_per_tok=2, moe_d_ff=128,
    sliding_window=32,
    capacity_factor=8.0,
)
